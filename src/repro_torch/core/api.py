"""The Learner–Model abstraction (paper §3.1) and the learner registry
(§3.5), the port of ``repro.core.api``: ``Task``, the typed errors,
``Model``, ``Learner``, ``register_learner``, ``get_learner``,
``list_learners`` and ``make_learner``.

A MODEL is a function observation -> prediction; a LEARNER is a function
examples -> Model. Hyper-parameters are fixed at construction and
``train`` is deterministic given (hyper-parameters, dataset, seed).
Learners register by name, as YDF's ``REGISTER_AbstractLearner`` does.

A saved model is a directory of plain data, written atomically (a temp
sibling, every file fsync'ed, one rename): ``header.json`` (format tag and
class), ``dataspec.json``, the model's arrays and fields (for a decision
forest ``forest.npz`` and ``model.json``, core/models.py; for a linear
model ``linear.npz`` and ``model.json``, core/baselines.py), ``summary.txt``
and, after ``evaluate``, ``evaluation.txt`` and ``evaluation.json``. The
port writes and reads no pickle; a directory the JAX package saved (it
holds ``model.pkl``) is refused, and such a model crosses through
``repro_torch.convert.model_from_arrays``.

Error messages follow the paper's §2.1/§2.2 guidance: say what failed in
task terms, show the offending values, and propose concrete fixes.
"""
from __future__ import annotations

import abc
import dataclasses
import enum
import json
import os
import shutil
import tempfile
from typing import Callable

import numpy as np


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


# --------------------------------------------------------------------- Model

class Model(abc.ABC):
    """observation -> prediction. Saveable, inspectable, engine-compilable."""

    task: Task
    label: str

    @abc.abstractmethod
    def predict(self, dataset, **kw) -> np.ndarray:
        """Classification: (N, n_classes) probabilities. Regression: (N,)."""

    def predict_class(self, dataset, **kw) -> np.ndarray:
        # check the task BEFORE predicting: a wrong-task call must fail fast,
        # not after paying for a full inference pass
        if self.task != Task.CLASSIFICATION:
            raise YdfError(
                f"predict_class requires a classification model, got task={self.task}. "
                "Use predict() for regression/ranking scores, uplift effects or "
                "anomaly scores; use evaluate() for task-appropriate metrics.")
        return np.argmax(self.predict(dataset, **kw), axis=-1)

    def evaluate(self, dataset, **kw):
        """An ``Evaluation`` of the model on a labelled dataset. ``kw``
        (``engine``, ``device``) go to ``predict``: the prediction runs on
        the card unless ``device="cpu"`` is passed."""
        from repro_torch.core.dataspec import label_values
        from repro_torch.core.evaluation import evaluate_predictions
        # task side-channels come out of the DATASET, not the prediction:
        # fetch them BEFORE inference so a mis-shaped call fails fast
        extras = _evaluation_extras(self, dataset)
        y = label_values(self, dataset)
        ev = evaluate_predictions(self.task, self.predict(dataset, **kw), y,
                                  classes=getattr(self, "classes", None),
                                  **extras)
        # kept so Model.save can write the report beside summary.txt
        self._last_evaluation = ev
        return ev

    def analyze(self, dataset=None, **kwargs):
        """Model-analysis report (DESIGN.md §8): structural variable
        importances always; permutation importances, partial dependence and
        an evaluation when a dataset is given. Decision-forest models route
        every analysis sweep through the compiled serving stack on
        ``device`` (None: the card; ``device="cpu"`` runs on the host)."""
        from repro_torch.analysis import analyze_model
        return analyze_model(self, dataset, **kwargs)

    # ---- self-description (show_model analogue)
    def summary(self, verbose: int | bool = False) -> str:
        return f"{type(self).__name__}(task={self.task.value}, label={self.label!r})"

    def variable_importances(self) -> dict[str, dict[str, float]]:
        return {}

    # ---- engines (§3.7)
    def compile(self, engine: str | None = None, device=None):
        raise YdfError(
            f"{type(self).__name__} has no inference engines. Engines exist for "
            "decision-forest models (see repro_torch.core.engines).")

    # ---- serialization: backwards-compatible via format version tag
    FORMAT_VERSION = 1

    def save(self, path: str) -> None:
        """Write the model directory (see the module docstring).

        The write is ATOMIC: everything lands in a temporary sibling
        directory, files are fsync'ed, and one rename publishes the model. A
        crash mid-save leaves the target with its previous contents or the
        complete new model, never a torn one. A non-empty directory that is
        not a model directory (no ``header.json``) is refused.
        """
        parent = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(parent, exist_ok=True)
        if os.path.isdir(path) and os.listdir(path) and \
                not os.path.exists(os.path.join(path, "header.json")):
            raise YdfError(
                f"Refusing to overwrite {path!r}: the directory exists, is "
                "not empty, and does not look like a model directory (no "
                "header.json). Solutions: (1) save to a fresh path, or (2) "
                "remove the directory first.")
        tmp = tempfile.mkdtemp(
            prefix=os.path.basename(path) + ".tmp-", dir=parent)
        try:
            self._write_model_dir(tmp)
            for name in os.listdir(tmp):
                fd = os.open(os.path.join(tmp, name), os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
            if os.path.isdir(path):
                old = tempfile.mkdtemp(
                    prefix=os.path.basename(path) + ".old-", dir=parent)
                os.rename(path, os.path.join(old, "m"))
                os.rename(tmp, path)
                shutil.rmtree(old, ignore_errors=True)
            else:
                if os.path.exists(path):
                    os.remove(path)
                os.rename(tmp, path)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _write_model_dir(self, path: str) -> None:
        meta = {"format_version": self.FORMAT_VERSION, "class": type(self).__name__}
        with open(os.path.join(path, "header.json"), "w") as f:
            json.dump(meta, f)
        self._write_state(path)
        with open(os.path.join(path, "summary.txt"), "w") as f:
            f.write(self.summary() + "\n")
        spec = getattr(self, "spec", None)
        if spec is not None:
            from repro_torch.core.dataspec import spec_to_dict
            with open(os.path.join(path, "dataspec.json"), "w") as f:
                json.dump(spec_to_dict(spec), f, indent=1)
        # the last evaluate() result rides along as a readable artefact
        # (plus its JSON form), so a saved model directory answers "how good
        # is it?" without re-running inference
        ev = getattr(self, "_last_evaluation", None)
        if ev is not None:
            with open(os.path.join(path, "evaluation.txt"), "w") as f:
                f.write(ev.report() + "\n")
            with open(os.path.join(path, "evaluation.json"), "w") as f:
                json.dump(ev.to_dict(), f, indent=1)

    def _write_state(self, path: str) -> None:
        """The model's own files: arrays and fields as plain data."""
        raise YdfError(f"{type(self).__name__} cannot be saved: it has no "
                       "plain-data form.")

    @staticmethod
    def load(path: str) -> "Model":
        """The model saved at ``path``. It holds no compiled predictor: the
        first ``predict`` compiles one (on the card unless ``device="cpu"``
        is passed)."""
        header = os.path.join(path, "header.json")
        try:
            with open(header) as f:
                meta = json.load(f)
        except FileNotFoundError:
            raise YdfError(
                f"No model found at {path!r}: missing 'header.json'. A model "
                "directory is created by Model.save and contains header.json "
                "+ forest.npz + model.json. Solutions: (1) check the path "
                "points at the model DIRECTORY (not a file inside it), or (2) "
                "re-save the model with model.save(path).") from None
        except json.JSONDecodeError as e:
            raise YdfError(
                f"Model header {header!r} is corrupt (invalid JSON: {e}). "
                "Solution: re-save the model with model.save(path); if the "
                "file was hand-edited, restore the original header.") from None
        if not isinstance(meta, dict) or "format_version" not in meta:
            raise YdfError(
                f"Model header {header!r} has no 'format_version' field "
                f"(got: {meta!r}). Solution: re-save the model with "
                "model.save(path) — headers are written automatically.")
        if meta["format_version"] > Model.FORMAT_VERSION:
            raise YdfError(
                f"Model at {path!r} was saved with format v{meta['format_version']}, "
                f"this library reads up to v{Model.FORMAT_VERSION}. Solutions: (1) "
                "upgrade the library, or (2) re-export the model in an older format.")
        if meta.get("class") == "LinearModel":
            from repro_torch.core.baselines import load_linear_model
            return load_linear_model(path)
        from repro_torch.core.models import load_forest_model
        return load_forest_model(path, meta)


def _side_column(dataset, name: str, *, task: str, role: str) -> np.ndarray:
    """Fetch a task side-channel column (ranking group / uplift treatment)
    from a VerticalDataset or a raw column mapping."""
    from repro_torch.core.dataspec import VerticalDataset
    if isinstance(dataset, VerticalDataset):
        if name in dataset.numerical or name in dataset.categorical:
            return np.asarray(dataset.column(name))
    else:
        try:
            if name in dataset:
                return np.asarray(dataset[name], dtype=object).ravel()
        except TypeError:
            pass
    raise YdfError(
        f"{task} evaluation requires the {role} column {name!r} and the "
        f"dataset does not carry it. Solution: pass a dataset with {name!r} "
        "alongside the features and label.")


def _evaluation_extras(model, dataset) -> dict:
    """Per-task evaluation side-channels, resolved BEFORE inference."""
    if model.task == Task.RANKING:
        col = _side_column(dataset, getattr(model, "ranking_group", "group"),
                           task="Ranking", role="group/query")
        groups = np.unique(col.astype(str), return_inverse=True)[1]
        return {"groups": groups.astype(np.int64)}
    if model.task == Task.UPLIFT:
        col = _side_column(dataset, getattr(model, "treatment_col", "treatment"),
                           task="Uplift", role="treatment")
        # two-arm normalization: smallest distinct value = control (0)
        vals, t = np.unique(col.astype(str), return_inverse=True)
        if len(vals) > 2:
            raise YdfError(
                f"Uplift evaluation supports two treatment arms, the "
                f"treatment column has {len(vals)} distinct values: "
                f"{list(vals[:5])}...")
        return {"treatment": t.astype(np.int64)}
    return {}


# --------------------------------------------------------------------- Learner

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

    # cross-API-compatible training configuration (paper §3.10): the
    # reference's keys exactly; ``device`` is where a run goes, not what it
    # computes, so it is not one of them
    def train_config(self) -> dict:
        cfg = {"learner": _name_of(type(self)), "label": self.label,
               "task": self.task.value, "seed": self.seed,
               "hparams": dataclasses.asdict(self.hparams)}
        if getattr(self, "template", None):
            cfg["template"] = self.template
        return cfg


# --------------------------------------------------------------------- registry

_LEARNERS: dict[str, type] = {}

# the reference's learners that the port does not train yet, and the
# ROADMAP item that brings each (none since A8)
_NOT_PORTED: dict[str, str] = {}


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


def get_learner(name: str) -> type:
    _ensure_builtin()
    if name not in _LEARNERS:
        if name in _NOT_PORTED:
            raise YdfError(
                f"Learner {name!r} is not ported yet (ROADMAP "
                f"{_NOT_PORTED[name]}). Ported learners: {sorted(_LEARNERS)}.")
        raise YdfError(
            f"Unknown learner {name!r}. Registered learners: {sorted(_LEARNERS)}. "
            "Register custom learners with @register_learner(name).")
    return _LEARNERS[name]


def list_learners() -> list[str]:
    _ensure_builtin()
    return sorted(_LEARNERS)


def make_learner(config: dict, device=None) -> Learner:
    """Build a learner from a cross-API training configuration dict, as
    either package's ``train_config`` writes it, to train on ``device``
    (None is cuda). The hparams dict already carries post-template values,
    so re-applying the template then overriding with them reproduces the
    learner exactly; the template name rides along for provenance."""
    cls = get_learner(config["learner"])
    kw = dict(config.get("hparams", {}))
    if config.get("template"):
        kw["template"] = config["template"]
    return cls(label=config["label"], task=Task(config.get("task", "CLASSIFICATION")),
               seed=config.get("seed", 1234), device=device, **kw)


_BUILTIN = False


def _ensure_builtin() -> None:
    global _BUILTIN
    if _BUILTIN:
        return
    _BUILTIN = True
    from repro_torch.core import (  # noqa: F401
        baselines, cart, gbt, metalearners, rf)
    from repro_torch import tasks  # noqa: F401  (uplift trees, isolation forest)
