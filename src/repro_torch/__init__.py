"""Yggdrasil Decision Forests in PyTorch, with CUDA kernels for Hopper.

The counterpart of the JAX package ``repro``: the same layout (``core``,
``obs``, ``kernels``, ``serving``, ``data``) and the same results. Gradient
Boosted Trees (classification, regression and LambdaMART ranking), Random
Forest, CART and uplift-tree models train on the card, their histograms or
split searches in hand-written CUDA kernels (``kernels/histogram``), and
serve, with isolation forests (``repro_torch.tasks``), through hand-written
traversal kernels (``kernels/forest_infer``). The package imports ``torch`` and numpy, never
``jax`` or ``repro``; models trained by the JAX package arrive as plain
arrays through ``repro_torch.convert``.

Models save to and load from a directory of plain data (``Model.save``,
``Model.load``), and ``checkpoint=`` on every learner gives interruption-safe
training with bit-identical resume (``resume_training``).

Serving: ``make_forest_server`` (padded dispatches; ``warm_ladder`` and
``predict_encoded_bulk``), the fault-tolerant ``ForestServer`` and its
asyncio front end ``AsyncForestServer``; ``benchmark_inference`` times
every engine a model has on a device, the depth-bucketed "bucketed" and
"leaf_path" engines among them.

Models are inspected, edited and built as typed trees
(``core.py_tree``), analysed (``analysis``: permutation, out-of-bag and
partial-dependence sweeps through the traversal kernels), tuned, ensembled,
calibrated and feature-selected (``core.metalearners``), imported from
sklearn (``interop``) and driven from the shell (``python -m
repro_torch.cli``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""


def __getattr__(name):
    # the learners, the model surface and checkpointed training, lazily
    # from repro_torch.core
    if name in ("GradientBoostedTreesLearner", "RandomForestLearner",
                "CartLearner", "UpliftTreesLearner", "IsolationForestLearner",
                "Model", "get_learner", "list_learners", "make_learner",
                "CheckpointPolicy", "resume_training",
                "benchmark_inference"):
        from repro_torch import core
        return getattr(core, name)
    if name in ("ForestServer", "AsyncForestServer", "make_forest_server"):
        from repro_torch import serving
        return getattr(serving, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
