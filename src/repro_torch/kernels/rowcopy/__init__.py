"""Multi-RowCopy fan-out: CUDA kernel ``csrc/fanout.cu`` + plain version."""
