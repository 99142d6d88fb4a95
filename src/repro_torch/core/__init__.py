"""Model, forest and engine layer of the port (mirrors ``repro.core``).

    from repro_torch.core import RandomForestLearner, Model
    model = RandomForestLearner(label="income").train(train_ds)  # on the card
    model.save("/tmp/rf")
    model = Model.load("/tmp/rf")
"""
from repro_torch.core.api import (  # noqa: F401
    EngineFailure,
    Model,
    Task,
    YdfError,
    get_learner,
    list_learners,
    make_learner,
)

_LAZY = {
    "GradientBoostedTreesLearner": "repro_torch.core.gbt",
    "RandomForestLearner": "repro_torch.core.rf",
    "CartLearner": "repro_torch.core.cart",
    "UpliftTreesLearner": "repro_torch.tasks.uplift",
    "IsolationForestLearner": "repro_torch.tasks.isolation",
    "CheckpointPolicy": "repro_torch.train.checkpoint",
    "CompiledPredictor": "repro_torch.core.engines",
    "compile_predictor": "repro_torch.core.engines",
    "available_engines": "repro_torch.core.engines",
    "select_cpu_engine": "repro_torch.core.engines",
    "benchmark_inference": "repro_torch.core.engines",
    "resume_training": "repro_torch.train.checkpoint",
}


def __getattr__(name):
    # lazy: a learner pulls in the growers, the engines and torch only when
    # it is asked for
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
