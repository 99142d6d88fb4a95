"""Yggdrasil Decision Forests in PyTorch, with CUDA kernels for Hopper.

The counterpart of the JAX package ``repro``: the same layout (``core``,
``obs``, ``kernels``, ``serving``, ``data``) and the same results. Gradient
Boosted Trees, Random Forest and CART models train on the card, their
histograms or split searches in hand-written CUDA kernels
(``kernels/histogram``), and serve through hand-written traversal kernels
(``kernels/forest_infer``). The package imports ``torch`` and numpy, never
``jax`` or ``repro``; models trained by the JAX package arrive as plain
arrays through ``repro_torch.convert``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""


def __getattr__(name):
    # the learners, lazily from repro_torch.core
    if name in ("GradientBoostedTreesLearner", "RandomForestLearner",
                "CartLearner"):
        from repro_torch import core
        return getattr(core, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
