"""Bit-serial adder: ``ops.bitserial_add`` / ``ops.add_u32`` launch
``csrc/bitserial.cu``; ``ref.bitserial_add_ref`` is the plain PyTorch
version."""
