"""Megakernel: one CUDA launch executes a whole fused Schedule.

Lowered level tables come from :mod:`repro_torch.compile.megakernel`;
``plan`` derives their execution plan (the live slots, hazard slots
marked), its plain walker ``exec_plan_ref`` and the launch planner;
``ops.run_lowering`` launches ``csrc/megakernel.cu`` on the plan, and
``ref.schedule_exec_ref`` is the independent oracle that walks the
padded tables.
"""
