"""Histogram split search: the fused CUDA kernel, its plain PyTorch
version and the impl switch (mirrors ``repro.kernels.histogram``)."""
