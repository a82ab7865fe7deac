"""Mismatch count (the success-rate counter): ``ops.mismatch_count``
launches ``csrc/mismatch.cu``; ``ref.mismatch_count_ref`` is the plain
PyTorch version."""
