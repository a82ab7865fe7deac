"""PyTorch/CUDA port of the SiMRA-DRAM processing-using-DRAM system.

A second package beside the JAX reference (``repro``), with the same
layout and names: ``core`` (calibration, bit-planes, cost model, the
behavioural subarray model and its threefry draws), ``pud`` (the PUD
instruction stream), ``compile`` (fusion scheduler and megakernel
lowering), ``backends`` (``oracle``, ``sim`` and ``cuda`` executors),
``kernels`` (hand-written CUDA kernels for Hopper, in ``csrc/``, each
with its plain PyTorch version), ``analyze`` (race, liveness and
equivalence certification of compiled programs) and ``session``
(``DramSession``: typed, validated, compile-cached and certified
execution), ``serve`` (the PUD service and the LM serving engine),
``ckpt``, ``sweep`` (declarative, resumable characterization
campaigns), and the LM stack: ``configs``, ``dist`` (logical-axis
sharding rules), ``models`` (the dense, audio and vlm transformer
families) and ``launch`` (``python -m repro_torch.launch.serve``).  It imports neither JAX nor the
reference package; :mod:`repro_torch.interop` carries the reference's
artefacts across as numpy arrays and JSON.

Packed bit-planes are ``torch.int32`` tensors holding the reference's
``uint32`` bit patterns (see :mod:`repro_torch.core.bitplanes`).
"""
