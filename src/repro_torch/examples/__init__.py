"""The reference's five ``examples/`` scripts, run on the port.

Like :mod:`repro_torch.paper`, this subpackage mirrors no module of
``src/repro/``: each module is the counterpart of one example script
and runs with ``python -m repro_torch.examples.<name>``, on the card
unless given ``--device cpu``.
"""
