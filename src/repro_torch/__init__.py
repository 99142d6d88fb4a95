"""Yggdrasil Decision Forests in PyTorch, with CUDA kernels for Hopper.

The counterpart of the JAX package ``repro``: the same layout (``core``,
``obs``, ``kernels``, ``serving``, ``data``) and the same results. The
default Gradient Boosted Trees model trains on the card through the device
growth engine, whose split search is a hand-written CUDA kernel
(``kernels/histogram``), and serves through a hand-written traversal kernel
(``kernels/forest_infer``). The package imports ``torch`` and numpy, never
``jax`` or ``repro``; models trained by the JAX package arrive as plain
arrays through ``repro_torch.convert``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""
