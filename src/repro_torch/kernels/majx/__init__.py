"""Bulk MAJX: CUDA kernel ``csrc/majx.cu`` + plain PyTorch version."""
