"""Whole trainings on a growth engine the traffic names: ``train``'s
set-up, window, facts and check on the run with the configuration's
``hparams`` overlaid by the traffic's ``params.hparams`` (for example
``{"growth_engine": "batched"}``, the learner's default engine).

A training whose ``training_logs`` do not name the overlaid engine, with
the histogram backend that "auto" resolves to on the run's device (the
CUDA kernel, B3, on a card; numpy on the CPU) where that engine is
"batched", is a failed one: a fallback would time another path.
"""
from __future__ import annotations

import dataclasses

from bench.generators import train
from bench.harness import Run

BACKEND = {"cuda": "cuda", "cpu": "numpy"}   # what "auto" resolves to


def overlaid(run: Run) -> Run:
    """The run with its configuration's hparams overlaid by the traffic's."""
    over = run.params.get("hparams", {})
    cfg = {**run.config, "hparams": {**run.config["hparams"], **over}}
    return dataclasses.replace(run, config=cfg)


def engine_ok(run: Run, logs: dict) -> bool:
    """Whether a training's logs name the engine (and backend) asked for."""
    want = run.config["hparams"].get("growth_engine", "batched")
    if logs.get("growth_engine") != want or logs.get("engine_fallback"):
        return False
    return want != "batched" or \
        logs.get("histogram_backend") == BACKEND[run.device.type]


class _Checked:
    """A learner whose trainings record whether they ran the engine asked
    for."""

    def __init__(self, inner, run: Run, seen: list):
        self.inner, self.run, self.seen = inner, run, seen

    def train(self, data):
        model = self.inner.train(data)
        self.seen.append(engine_ok(self.run, model.training_logs))
        return model


def setup(run: Run) -> train.State:
    return train.setup(overlaid(run))


def window(run: Run, state: train.State) -> dict:
    run = overlaid(run)
    seen: list = []
    plain = train.learner
    train.learner = lambda r, **over: _Checked(plain(r, **over), r, seen)
    try:
        out = train.window(run, state)
    finally:
        train.learner = plain
    out["failed"] = seen.count(False)
    out["notes"]["engine_ok"] = seen
    return out


def facts(run: Run, state: train.State, rec: dict) -> None:
    train.facts(overlaid(run), state, rec)


def check(run: Run, state: train.State) -> dict:
    return train.check(overlaid(run), state)
