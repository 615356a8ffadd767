"""Parallelism modes of the PyTorch port: data, sequence and tensor."""
