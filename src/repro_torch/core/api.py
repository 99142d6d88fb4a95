"""Task kinds, the typed errors and the Learner abstraction of the port
(the counterpart of ``repro.core.api``'s ``Task``, ``YdfError``,
``EngineFailure``, ``Learner`` and ``register_learner``).

A LEARNER is a function examples -> Model (paper §3.1); hyper-parameters
are fixed at construction and ``train`` is deterministic given
(hyper-parameters, dataset, seed). Learners register by name, as YDF's
``REGISTER_AbstractLearner`` does.

Error messages follow the paper's §2.1/§2.2 guidance: say what failed in
task terms, show the offending values, and propose concrete fixes.
"""
from __future__ import annotations

import abc
import dataclasses
import enum
from typing import Callable


class Task(enum.Enum):
    CLASSIFICATION = "CLASSIFICATION"
    REGRESSION = "REGRESSION"
    RANKING = "RANKING"
    UPLIFT = "UPLIFT"
    ANOMALY = "ANOMALY"


class YdfError(ValueError):
    """An error with directions (paper Table 1b style)."""


class EngineFailure(YdfError):
    """A typed inference-engine failure raised at serving time.

    Raised when a compiled host or plain-PyTorch engine call fails on a
    batch, or by an injected fault from ``serving.faults``. Carries the
    engine name so ``serving.server`` can attribute the failure to a
    circuit breaker, and ``transient`` so it knows whether a retry on the
    same engine is worth attempting. The CUDA kernel's errors are not
    engine failures: a kernel that fails to build raises ``RuntimeError``
    when the predictor is compiled, and one that fails to launch raises
    its ``RuntimeError`` at dispatch; no degradation chain catches either.
    """

    def __init__(self, message: str, *, engine: str = "?",
                 transient: bool = False):
        super().__init__(message)
        self.engine = engine
        self.transient = transient


class Learner(abc.ABC):
    """examples -> Model. ``device`` is where training runs: None is cuda
    (raising ``YdfError`` without a card), ``"cpu"`` runs the kernels'
    plain versions; the trained model serves on any device."""

    def __init__(self, label: str, task: Task = Task.CLASSIFICATION, *,
                 seed: int = 1234, template: str | None = None, device=None,
                 **hparams):
        self.label = label
        self.task = task
        self.seed = seed
        self.template = template
        self.device = device
        hp = self.default_hparams()
        if template:
            # template first, explicit overrides second (§3.11)
            from repro_torch.core.hparams import apply_template
            hp = apply_template(_name_of(type(self)), hp, template)
        unknown = set(hparams) - set(dataclasses.asdict(hp))
        if unknown:
            known = sorted(dataclasses.asdict(hp))
            raise YdfError(
                f"Unknown hyper-parameter(s) {sorted(unknown)} for "
                f"{type(self).__name__}. Known hyper-parameters: {known}.")
        self.hparams = dataclasses.replace(hp, **hparams)

    @abc.abstractmethod
    def train(self, dataset, valid=None, checkpoint=None):
        """Train a Model. ``valid`` is optional (§3.3): a learner that needs
        validation and gets none extracts it from the training set."""

    @abc.abstractmethod
    def default_hparams(self):
        ...


_LEARNERS: dict[str, type] = {}


def register_learner(name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        if name in _LEARNERS and _LEARNERS[name] is not cls:
            raise ValueError(f"duplicate learner registration {name!r}")
        _LEARNERS[name] = cls
        cls._registry_name = name
        return cls
    return deco


def _name_of(cls: type) -> str:
    return getattr(cls, "_registry_name", cls.__name__)
