"""Core PUD substrate.

- :mod:`repro_torch.core.calibration` — every number the paper reports.
- :mod:`repro_torch.core.bitplanes` — packed bit-plane tensors (int32).
- :mod:`repro_torch.core.commands` — DRAM command-sequence IR.
- :mod:`repro_torch.core.errormodel` — calibrated success-rate surfaces.
- :mod:`repro_torch.core.power` — Fig. 5 power model.
- :mod:`repro_torch.core.costmodel` — DRAM latency/energy + H100 profile.
- :mod:`repro_torch.core.rng` — threefry2x32 draws, word for word with jax.
- :mod:`repro_torch.core.decoder` — the latching row decoder (§7.1).
- :mod:`repro_torch.core.subarray` — the behavioural subarray model.
- :mod:`repro_torch.core.majx` / :mod:`repro_torch.core.rowcopy` — op-level
  MAJX, Multi-RowCopy, RowClone and Frac on a subarray.
- :mod:`repro_torch.core.chargeshare` — the §7.2 bitline Monte Carlo.
"""
