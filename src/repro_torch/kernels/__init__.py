"""Hand-written CUDA kernels of the port, built from ``csrc/`` on first use
(see ``_build``), each beside its plain PyTorch version."""
