"""Hand-written CUDA kernels (``csrc/``) with their Python wrappers.

Each kernel package holds ``ops.py`` (the wrapper: validates, allocates,
launches on a CUDA tensor, counts launches) and ``ref.py`` (the plain
PyTorch version, used on CPU tensors and as the kernel's yardstick).
:mod:`repro_torch.kernels.launch` builds and loads the libraries.
"""
