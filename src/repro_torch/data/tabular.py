"""Deterministic synthetic tabular datasets, the port's copy of part of
``repro.data.tabular`` (host numpy, the same rows from the same seeds):
``make_dataset`` draws raw columns from a random ground-truth forest plus
smooth numeric interactions and label noise; ``adult_like`` is the
Adult/Census-shaped fixture.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SyntheticSpec:
    name: str
    n: int
    n_num: int
    n_cat: int
    n_classes: int  # 0 -> regression
    missing_rate: float = 0.02
    noise: float = 0.1
    seed: int = 0


# A small "OpenML-like" suite (size range mirrors the paper's small datasets).
SUITE: list[SyntheticSpec] = [
    SyntheticSpec("synth_iris", 300, 4, 0, 3, seed=1),
    SyntheticSpec("synth_blood", 748, 4, 0, 2, seed=2),
    SyntheticSpec("synth_adult", 2000, 6, 8, 2, missing_rate=0.05, seed=3),
    SyntheticSpec("synth_credit", 1000, 7, 13, 2, seed=4),
    SyntheticSpec("synth_vowel", 990, 10, 2, 11, seed=5),
    SyntheticSpec("synth_segment", 1500, 19, 0, 7, seed=6),
    SyntheticSpec("synth_cmc", 1473, 2, 7, 3, seed=7),
    SyntheticSpec("synth_wine_reg", 900, 11, 0, 0, seed=8),
]


def make_dataset(spec: SyntheticSpec) -> dict[str, np.ndarray]:
    """Returns raw columns (object arrays with missing as None) + 'label'."""
    rng = np.random.default_rng(spec.seed * 9973 + 17)
    n, F_num, F_cat = spec.n, spec.n_num, spec.n_cat
    Xn = rng.normal(size=(n, F_num))
    cat_sizes = rng.integers(2, 12, size=F_cat)
    Xc = np.stack([rng.integers(0, s, size=n) for s in cat_sizes], axis=1) \
        if F_cat else np.zeros((n, 0), np.int64)

    # ground truth: random shallow forest over both feature kinds + smooth part
    score = np.zeros(n)
    n_rules = 8 + F_num + F_cat
    for _ in range(n_rules):
        w = rng.normal()
        if F_num and (rng.random() < 0.6 or not F_cat):
            j = rng.integers(F_num)
            t = rng.normal()
            cond = Xn[:, j] > t
            if rng.random() < 0.3 and F_num > 1:  # interaction
                j2 = rng.integers(F_num)
                cond &= Xn[:, j2] > rng.normal()
        else:
            j = rng.integers(F_cat)
            keep = rng.random(cat_sizes[j]) < 0.5
            cond = keep[Xc[:, j]]
        score += w * cond
    if F_num:
        beta = rng.normal(size=F_num) * 0.5
        score += np.tanh(Xn @ beta)
    score += rng.normal(scale=spec.noise * max(score.std(), 1e-6), size=n)

    data: dict[str, np.ndarray] = {}
    for j in range(F_num):
        col = Xn[:, j].astype(object)
        miss = rng.random(n) < spec.missing_rate
        col[miss] = None
        data[f"num_{j}"] = col
    for j in range(F_cat):
        col = np.array([f"v{v}" for v in Xc[:, j]], dtype=object)
        miss = rng.random(n) < spec.missing_rate
        col[miss] = None
        data[f"cat_{j}"] = col

    if spec.n_classes == 0:
        data["label"] = score.astype(object)
    else:
        qs = np.quantile(score, np.linspace(0, 1, spec.n_classes + 1)[1:-1])
        y = np.digitize(score, qs)
        data["label"] = np.array([f"c{c}" for c in y], dtype=object)
    return data


def train_test_split(data: dict[str, np.ndarray], test_ratio: float = 0.3,
                     seed: int = 0) -> tuple[dict, dict]:
    n = len(next(iter(data.values())))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    nt = int(n * test_ratio)
    te, tr = perm[:nt], perm[nt:]
    return ({k: v[tr] for k, v in data.items()},
            {k: v[te] for k, v in data.items()})


def adult_like(n: int = 3000, seed: int = 42) -> dict[str, np.ndarray]:
    """An Adult/Census-shaped fixture (paper §4): mixed semantics, missing
    values, a '>50K'/'<=50K'-style binary label driven by realistic rules."""
    rng = np.random.default_rng(seed)
    age = rng.integers(17, 91, n)
    edu_levels = ["HS-grad", "Some-college", "Bachelors", "Masters", "Doctorate",
                  "7th-8th", "Assoc-voc", "10th"]
    edu_rank = {e: i for i, e in enumerate(
        ["7th-8th", "10th", "HS-grad", "Assoc-voc", "Some-college", "Bachelors",
         "Masters", "Doctorate"])}
    education = rng.choice(edu_levels, n, p=[.32, .22, .17, .06, .01, .02, .13, .07])
    occupation = rng.choice(["Exec-managerial", "Prof-specialty", "Sales",
                             "Adm-clerical", "Other-service", "Machine-op-inspct",
                             "Handlers-cleaners"], n)
    workclass = rng.choice(["Private", "Self-emp-inc", "Government"], n,
                           p=[.75, .1, .15])
    hours = np.clip(rng.normal(40, 12, n), 1, 99).astype(int)
    capital_gain = np.where(rng.random(n) < 0.08,
                            rng.lognormal(8, 1.2, n).astype(int), 0)
    z = (0.045 * (age - 38) + 0.55 * np.array([edu_rank[e] for e in education])
         + 0.35 * np.isin(occupation, ["Exec-managerial", "Prof-specialty"])
         + 0.02 * (hours - 40) + 0.9 * (capital_gain > 3000)
         + 0.4 * (workclass == "Self-emp-inc") - 1.9)
    p = 1 / (1 + np.exp(-(z + rng.logistic(0, 0.6, n))))
    income = np.where(p > 0.5, ">50K", "<=50K")

    def with_missing(col, rate=0.03):
        col = col.astype(object)
        col[rng.random(n) < rate] = None
        return col

    return {
        "age": age.astype(object),
        "workclass": with_missing(workclass),
        "education": education.astype(object),
        "occupation": with_missing(occupation),
        "hours_per_week": hours.astype(object),
        "capital_gain": capital_gain.astype(object),
        "income": income.astype(object),
    }
