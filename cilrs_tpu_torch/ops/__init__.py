"""Tensor ops: the row-gather kernel, its build, image normalization."""
