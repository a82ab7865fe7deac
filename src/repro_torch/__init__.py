"""PyTorch/CUDA port of the SiMRA-DRAM processing-using-DRAM system.

A second package beside the JAX reference (``repro``), with the same
layout and names: ``core`` (calibration, bit-planes, cost model),
``pud`` (the PUD instruction stream), ``compile`` (fusion scheduler and
megakernel lowering), ``backends`` (``oracle`` and ``cuda`` executors)
and ``kernels`` (hand-written CUDA kernels for Hopper, in ``csrc/``, each
with its plain PyTorch version).  It imports neither JAX nor the
reference package; :mod:`repro_torch.interop` carries the reference's
artefacts across as numpy arrays and JSON.

Packed bit-planes are ``torch.int32`` tensors holding the reference's
``uint32`` bit patterns (see :mod:`repro_torch.core.bitplanes`).
"""
