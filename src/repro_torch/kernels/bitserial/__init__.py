"""Bit-serial adder: plain PyTorch version (the kernel is still to port)."""
