"""``repro_torch.core.evaluation.compare_correctness`` (ROADMAP A10, the
paper's §2.2 paired bootstrap) against the reference's: float for float on
several inputs and seeds, and the same refusal of unequal lengths."""
from __future__ import annotations

import numpy as np
import pytest

from repro.core.evaluation import compare_correctness as ref_compare
from repro_torch.core.api import YdfError
from repro_torch.core.evaluation import compare_correctness


def _inputs(kind: str, n: int, rng):
    if kind == "correctness":
        return rng.random(n) < 0.8, rng.random(n) < 0.7
    if kind == "scores":
        return rng.standard_normal(n), rng.standard_normal(n) + 0.1
    return np.ones(n, int), np.ones(n, int)          # identical


@pytest.mark.parametrize("seed", [11, 0, 123])
@pytest.mark.parametrize("kind,n,n_boot", [("correctness", 500, 500),
                                           ("scores", 37, 200),
                                           ("identical", 10, 50),
                                           ("correctness", 1, 20)])
def test_equals_the_reference(kind, n, n_boot, seed):
    a, b = _inputs(kind, n, np.random.default_rng(n + n_boot))
    got = compare_correctness(a, b, n_boot=n_boot, seed=seed)
    want = ref_compare(a, b, n_boot=n_boot, seed=seed)
    assert got == want
    assert isinstance(got["ci95"], tuple) and got["ci95"][0] <= got["ci95"][1]


def test_unequal_lengths_are_refused_as_the_reference_does():
    with pytest.raises(YdfError) as got:
        compare_correctness(np.ones(3), np.ones(4))
    from repro.core.api import YdfError as RefError
    with pytest.raises(RefError) as want:
        ref_compare(np.ones(3), np.ones(4))
    assert str(got.value) == str(want.value)
