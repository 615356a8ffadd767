"""Parallelism modes of the PyTorch port (sequence attention so far)."""
