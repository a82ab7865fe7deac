"""Megakernel: one CUDA launch executes a whole fused Schedule.

Lowered level tables come from :mod:`repro_torch.compile.megakernel`;
``ops.run_lowering`` launches ``csrc/megakernel.cu`` on them, and
``ref.schedule_exec_ref`` is the plain PyTorch version.
"""
