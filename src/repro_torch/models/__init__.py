"""The transformer LM stack (``dense``, ``audio`` and ``vlm`` families):
:mod:`~repro_torch.models.common`, :mod:`~repro_torch.models.mlp`,
:mod:`~repro_torch.models.attention` and :mod:`~repro_torch.models.model`."""
