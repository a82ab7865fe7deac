"""Core PUD substrate.

- :mod:`repro_torch.core.calibration` — every number the paper reports.
- :mod:`repro_torch.core.bitplanes` — packed bit-plane tensors (int32).
- :mod:`repro_torch.core.commands` — DRAM command-sequence IR.
- :mod:`repro_torch.core.errormodel` — calibrated success-rate surfaces.
- :mod:`repro_torch.core.power` — Fig. 5 power model.
- :mod:`repro_torch.core.costmodel` — DRAM latency/energy + H100 profile.
"""
