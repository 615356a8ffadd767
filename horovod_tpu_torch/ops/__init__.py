"""Device-plane ops of the PyTorch port: gradient fusion and the
hand-written CUDA kernels (sources under ``csrc/``)."""
