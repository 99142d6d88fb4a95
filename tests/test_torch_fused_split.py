"""The port's split search against the JAX package's.

The same numpy inputs (codes, stats, slots) go through the reference's TPU
kernel ``fused_split_pallas`` in interpret mode and its jnp oracles
``fused_split_ref`` / ``histogram_ref``, and through the port's plain
versions and the CUDA kernel's wrapper (which runs the plain version on
CPU tensors). Tolerances:

  * columns and split_bins: identical to the Pallas kernel everywhere,
    unscoreable slots included (-1, 0); identical to the jnp oracle where a
    column was found (the oracle writes split_bin 1 on unscoreable slots);
  * gains: rtol 1e-5 — the port sums in float64, the reference in float32;
  * histograms: the count channel exact, the other stats rtol 1e-6.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.binning import BinnedFeatures
from repro.core.hist_backend import NumpyHistogramBackend
from repro.core.splitters import SplitterParams, best_splits
from repro.kernels.histogram.fused import fused_split_pallas
from repro.kernels.histogram.ref import fused_split_ref as jnp_fused_ref
from repro.kernels.histogram.ref import histogram_ref as jnp_histogram_ref
from repro_torch.kernels.histogram import fused, ops
from repro_torch.kernels.histogram.ref import fused_split_ref, histogram_ref

NEG_INF = np.float32(-1e30)


def frontier(seed, n, kf, n_slots, kind, *, empty=(), inactive=0.1,
             dup=None):
    """Codes, stats of the kind and slots in [-1, n_slots); slots listed in
    ``empty`` get no rows; column ``dup[1]`` repeats column ``dup[0]``."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (n, kf)).astype(np.uint8)
    if dup is not None:
        codes[:, dup[1]] = codes[:, dup[0]]
    g = rng.normal(size=n)
    w = rng.integers(0, 3, n).astype(np.float64)
    if kind == "gh":
        stats = np.stack([g * w, w, np.abs(g) * w, w], 1)
    elif kind == "class":
        c = rng.integers(0, 3, n)
        stats = np.stack([(c == 0) * w, (c == 1) * w, (c == 2) * w, w], 1)
    else:
        stats = np.stack([g * w, np.square(g) * w, w], 1)
    live = [s for s in range(n_slots) if s not in empty]
    slot = (rng.choice(live, n) if live else np.full(n, -1)).astype(np.int32)
    slot[rng.random(n) < inactive] = -1
    return codes, stats.astype(np.float32), slot


def pallas(codes, stats, slot, n_slots, **kw):
    import jax.numpy as jnp
    return tuple(np.asarray(a) for a in fused_split_pallas(
        jnp.asarray(codes), jnp.asarray(stats), jnp.asarray(slot), n_slots,
        interpret=True, **kw))


def port(fn, codes, stats, slot, n_slots, **kw):
    return tuple(a.numpy() for a in fn(
        torch.from_numpy(codes), torch.from_numpy(stats),
        torch.from_numpy(slot), n_slots, **kw))


CASES = [
    # (name, n, kf, n_slots, frontier kwargs, min_examples)
    ("ragged N", 777, 5, 6, {}, 5),
    ("empty slots", 600, 4, 8, {"empty": (1, 6, 7)}, 5),
    ("all inactive", 300, 3, 4, {"inactive": 1.0}, 5),
    ("duplicated column", 900, 6, 5, {"dup": (1, 4)}, 5),
    ("one slot", 513, 7, 1, {}, 2),
    ("min_examples=0", 64, 3, 3, {"empty": (2,)}, 0),
]


def report_gain_mismatch(codes, stats, slot, n_slots, cols, bins, gains, ref_gains, fn):
    """Prints what tells the causes of a gain mismatch apart: the torch
    thread count, and for each slot past the tolerance the port's histogram
    of its chosen column against exact float64 numpy sums of the same rows
    (a difference there is in the histogram; none, in the scoring)."""
    print(f"gain mismatch in {fn.__module__}.{fn.__name__}; "
          f"torch.get_num_threads() = {torch.get_num_threads()}")
    hist = histogram_ref(torch.from_numpy(codes), torch.from_numpy(stats),
                         torch.from_numpy(slot), n_slots, 256).numpy()
    bad = np.flatnonzero((cols >= 0) & ~np.isclose(gains, ref_gains, rtol=1e-5, atol=0))
    for s in bad:
        col = int(cols[s])
        rows = slot == s
        exact = np.zeros((256, stats.shape[1]))
        np.add.at(exact, codes[rows, col].astype(np.int64), stats[rows].astype(np.float64))
        print(f"slot {s}: gain {gains[s]!r} (reference {ref_gains[s]!r}), column {col}, "
              f"bin {int(bins[s])}, {int(rows.sum())} rows; histogram - exact: max "
              f"|delta| {np.abs(hist[s, col] - exact).max()!r}, per-stat totals "
              f"{hist[s, col].sum(0).tolist()} vs {exact.sum(0).tolist()}")


@pytest.mark.parametrize("kind", ["gh", "class", "moment"])
@pytest.mark.parametrize("name,n,kf,W,fkw,min_ex", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_equals_pallas_kernel(kind, name, n, kf, W, fkw, min_ex):
    codes, stats, slot = frontier(n + kf, n, kf, W, kind, **fkw)
    kw = dict(kind=kind, l2=0.0, min_examples=min_ex)
    pg, pc, pb = pallas(codes, stats, slot, W, **kw)
    for fn in (fused_split_ref, fused.fused_split):
        g, c, b = port(fn, codes, stats, slot, W, **kw)
        np.testing.assert_array_equal(c, pc, err_msg=f"{name}: columns")
        np.testing.assert_array_equal(b, pb, err_msg=f"{name}: split_bins")
        found = c >= 0
        try:
            np.testing.assert_allclose(g[found], pg[found], rtol=1e-5, atol=0)
        except AssertionError:
            report_gain_mismatch(codes, stats, slot, W, c, b, g, pg, fn)
            raise
        assert (g[~found] == NEG_INF).all() and (pg[~found] == NEG_INF).all()
    if "empty" in fkw and min_ex > 0:
        assert (c[list(fkw["empty"])] == -1).all()
    if "dup" in fkw:
        assert fkw["dup"][1] not in c, "the higher duplicate won a tie"


@pytest.mark.parametrize("kind", ["gh", "class", "moment"])
def test_plain_equals_jnp_oracle_where_a_column_was_found(kind):
    codes, stats, slot = frontier(5, 1001, 6, 7, kind, empty=(3,))
    import jax.numpy as jnp
    rg, rc, rb = (np.asarray(a) for a in jnp_fused_ref(
        jnp.asarray(codes), jnp.asarray(stats), jnp.asarray(slot), 7,
        kind=kind, l2=0.1, min_examples=5))
    g, c, b = port(fused_split_ref, codes, stats, slot, 7, kind=kind, l2=0.1,
                   min_examples=5)
    found = c >= 0
    np.testing.assert_array_equal(c, rc)
    np.testing.assert_array_equal(b[found], rb[found])
    np.testing.assert_allclose(g[found], rg[found], rtol=1e-5, atol=0)
    # the oracle's split_bin on an unscoreable slot is 1, the kernel's 0
    assert (~found).any() and (b[~found] == 0).all() and (rb[~found] == 1).all()


@pytest.mark.parametrize("S,n_nodes", [(4, 5), (3, 1), (4, 9)])
def test_histogram_equals_jnp_oracle(S, n_nodes):
    import jax.numpy as jnp
    rng = np.random.default_rng(S * 10 + n_nodes)
    n, F = 777, 5
    codes = rng.integers(0, 256, (n, F)).astype(np.uint8)
    stats = rng.normal(size=(n, S)).astype(np.float32)
    stats[:, -1] = rng.integers(0, 3, n)
    node = rng.integers(-1, n_nodes, n).astype(np.int32)
    want = np.asarray(jnp_histogram_ref(jnp.asarray(codes), jnp.asarray(stats),
                                        jnp.asarray(node), n_nodes, 256))
    got = histogram_ref(torch.from_numpy(codes), torch.from_numpy(stats),
                        torch.from_numpy(node), n_nodes, 256).numpy()
    np.testing.assert_array_equal(got[..., -1], want[..., -1])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_nan_gains_never_win_as_in_the_pallas_kernel():
    """h + l2 + 1e-12 == 0 makes every gain NaN or inf; a NaN ranks highest
    in its column and makes the column's best NaN, which the strict fold
    over columns never takes."""
    codes, stats, slot = frontier(9, 300, 3, 3, "gh")
    stats[:, 1] = 0.0
    stats[::2, 0] = 0.0
    kw = dict(kind="gh", l2=-1e-12, min_examples=1)
    pg, pc, pb = pallas(codes, stats, slot, 3, **kw)
    g, c, b = port(fused_split_ref, codes, stats, slot, 3, **kw)
    np.testing.assert_array_equal(c, pc)
    np.testing.assert_array_equal(b, pb)
    np.testing.assert_array_equal(g[c < 0], pg[c < 0])


def _random_frontier(seed, n=900, kf=4, n_slots=6, kind="gh"):
    """The sweep inputs of the reference's tests/test_grower_device.py."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (n, kf)).astype(np.uint8)
    g = rng.normal(size=n)
    w = rng.integers(0, 3, n).astype(np.float64)
    if kind == "gh":
        stats = np.stack([g * w, w, np.abs(g) * w, w], 1)
    elif kind == "class":
        c = rng.integers(0, 2, n)
        stats = np.stack([(c == 0) * w, (c == 1) * w, w], 1)
    else:
        stats = np.stack([g * w, np.square(g) * w, w], 1)
    slot = rng.integers(-1, n_slots, n).astype(np.int32)
    return codes, stats, slot


@pytest.mark.parametrize("kind", ["gh", "class", "moment"])
def test_plain_argmax_matches_f64_host_scan(kind):
    """Property sweep: across random frontiers the port's split search picks
    the (column, split_bin) of the reference's host scan over float64
    histograms, wherever that scan finds a valid split."""
    n_slots = 6
    for seed in range(8):
        codes, stats, slot = _random_frontier(100 * seed + 7, kind=kind)
        kf = codes.shape[1]
        hist64 = NumpyHistogramBackend().build(codes, stats, slot, n_slots)
        binned = BinnedFeatures(
            codes=codes, n_bins=np.full(kf, 256, np.int32),
            is_cat=np.zeros(kf, bool),
            boundaries=[np.arange(255, dtype=np.float32)] * kf,
            names=[f"f{j}" for j in range(kf)])
        sp = SplitterParams(stat_kind=kind, min_examples=5)
        want = best_splits(hist64.astype(np.float32), binned, sp,
                           np.random.default_rng(0))
        gain, feat, sbin = port(ops.fused_best_split, codes,
                                stats.astype(np.float32), slot, n_slots,
                                kind=kind, l2=0.0, min_examples=5)
        for i, s in enumerate(want):
            if not s.valid:
                assert gain[i] <= sp.min_gain or not np.isfinite(gain[i])
                continue
            assert (feat[i], sbin[i]) == (s.feature, s.split_bin), \
                f"seed {seed} slot {i}: diverged from the f64 scan"


def _tensors(n=50, kf=3, S=4):
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.integers(0, 256, (n, kf)).astype(np.uint8)),
            torch.from_numpy(rng.normal(size=(n, S)).astype(np.float32)),
            torch.from_numpy(rng.integers(-1, 2, n).astype(np.int32)))


@pytest.mark.parametrize("mutate,exc", [
    (lambda c, s, o: (c.to(torch.int32), s, o), TypeError),
    (lambda c, s, o: (c, s.double(), o), TypeError),
    (lambda c, s, o: (c, s, o.long()), TypeError),
    (lambda c, s, o: (c, s[:-1], o), ValueError),
    (lambda c, s, o: (c, s[:, :1].contiguous(), o), ValueError),
    (lambda c, s, o: (c.t(), s, o), ValueError),
    (lambda c, s, o: (c, s.to("meta"), o), ValueError),
])
def test_wrapper_checks_its_arguments(mutate, exc):
    with pytest.raises(exc):
        fused.fused_split(*mutate(*_tensors()), 2)


def test_wrapper_and_switch_refuse_bad_options():
    c, s, o = _tensors()
    with pytest.raises(ValueError, match="kind"):
        fused.fused_split(c, s, o, 2, kind="huber")
    with pytest.raises(ValueError, match="n_bins"):
        fused.fused_split(c, s, o, 2, n_bins=257)
    with pytest.raises(ValueError, match="n_slots"):
        fused.fused_split(c, s, o, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.fused_best_split(c, s, o, 2, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.fused_best_split(c, s, o, 2, impl="pallas")


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    c, s, o = _tensors()
    before = fused.LAUNCHES
    got = [ops.fused_best_split(c, s, o, 2, impl=i) for i in (None, "ref")]
    assert fused.LAUNCHES == before
    for a, b in zip(*got):
        assert torch.equal(a, b)


def test_plain_version_repeats_on_the_ragged_class_case():
    """ROADMAP C: one xdist run gave 17.742813 for slot 3 of ``ragged
    N-class`` where the reference gives 17.74347. The plain versions repeat
    their bits over many calls, and the float32 scoring of the slot's exact
    counts gives 17.74347 whichever log computes it (numpy's, a float64 log
    rounded, torch's)."""
    codes, stats, slot = frontier(777 + 5, 777, 5, 6, "class")
    kw = dict(kind="class", l2=0.0, min_examples=5)
    first = port(fused_split_ref, codes, stats, slot, 6, **kw)
    for _ in range(100):
        for fn in (fused_split_ref, fused.fused_split):
            again = port(fn, codes, stats, slot, 6, **kw)
            for a, b in zip(first, again):
                np.testing.assert_array_equal(a, b)
    gain, col, sbin = (a[3] for a in first)
    assert gain == np.float32(17.74347) and (col, sbin) == (4, 178)
    hist = histogram_ref(torch.from_numpy(codes), torch.from_numpy(stats).double(),
                         torch.from_numpy(slot), 6, 256)[3, col].numpy()
    left = hist[:sbin].sum(0).astype(np.float32)
    parent = hist.sum(0).astype(np.float32)
    right = parent - left

    def score(st, log):
        p = st[:-1] / np.maximum(st[-1], np.float32(1e-12))
        return -st[-1] * -(p * log(np.maximum(p, np.float32(1e-12)))).sum(dtype=np.float32)

    for log in (np.log, lambda x: np.log(x.astype(np.float64)).astype(np.float32),
                lambda x: torch.log(torch.from_numpy(x)).numpy()):
        assert np.float32(score(left, log) + score(right, log)
                          - score(parent, log)) == gain
