"""Yggdrasil Decision Forests serving in PyTorch, with CUDA kernels for Hopper.

The counterpart of the JAX package ``repro``: the same layout (``core``,
``obs``, ``kernels``, ``serving``) and the same results, with the forest
traversal running as a hand-written CUDA kernel on an NVIDIA H100. The
package imports ``torch`` and numpy, never ``jax`` or ``repro``; models
trained elsewhere arrive as plain arrays through ``repro_torch.convert``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""
