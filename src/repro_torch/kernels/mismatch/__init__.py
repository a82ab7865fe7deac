"""Mismatch count: plain PyTorch version (the kernel is still to port)."""
