"""Bit-plane transpose of uint32 elements: ``ops.pack_uint_elements`` /
``ops.unpack_uint_elements`` launch ``csrc/bitplanes.cu``;
``ref.pack_uint_elements_ref`` / ``ref.unpack_uint_elements_ref`` are
the plain PyTorch versions."""
