"""Forest traversal: the CUDA kernel, its plain PyTorch version, and the
per-forest device caches (mirrors ``repro.kernels.forest_infer``)."""
