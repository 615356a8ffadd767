"""Parallelism modes of the PyTorch port: data, sequence, tensor and
pipeline."""
