"""Model, forest and engine layer of the port (mirrors ``repro.core``).

    from repro_torch.core import RandomForestLearner
    model = RandomForestLearner(label="income").train(train_ds)  # on the card
"""
from repro_torch.core.api import EngineFailure, Task, YdfError  # noqa: F401

_LEARNERS = {
    "GradientBoostedTreesLearner": "repro_torch.core.gbt",
    "RandomForestLearner": "repro_torch.core.rf",
    "CartLearner": "repro_torch.core.cart",
}


def __getattr__(name):
    # lazy: a learner pulls in the growers, the engines and torch only when
    # it is asked for
    if name in _LEARNERS:
        import importlib
        return getattr(importlib.import_module(_LEARNERS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
