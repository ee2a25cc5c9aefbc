"""Tensor ops: the row-gather and sin-hash kernels, their build, image normalization."""
