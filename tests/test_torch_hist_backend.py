"""The port's histogram backends and the histogram kernel's plain version
against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
  * numpy and simple backends: bit-identical to the reference's (the same
    numpy code) and to each other;
  * the kernel's plain version against ``PallasHistogramBackend`` in
    interpret mode: atol 1e-3, rtol 1e-4, the reference's own tolerance for
    its kernel (tests/test_grower_batched.py), whose float32 accumulation
    differs from a float64 sum;
  * the plain version against the numpy backend: rtol 1e-6 (atol 1e-9 for
    cells that cancel to ~0), the float32 rounding of a float64 sum of the
    same float32-representable values.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.hist_backend import NumpyHistogramBackend as RefNumpy
from repro.core.hist_backend import PallasHistogramBackend as RefPallas
from repro.core.hist_backend import SimpleHistogramBackend as RefSimple
from repro_torch.core import YdfError
from repro_torch.core import hist_backend
from repro_torch.core.hist_backend import (
    CudaHistogramBackend,
    NumpyHistogramBackend,
    SimpleHistogramBackend,
    resolve_backend,
)
from repro_torch.kernels.histogram import histogram as hist_kernel
from repro_torch.kernels.histogram import ops
from repro_torch.kernels.histogram.ref import histogram_f32_ref

CPU = torch.device("cpu")


def random_mixed(seed, n=400, f_num=3, f_cat=3, s=4, n_nodes=5):
    """Mixed numerical/categorical codes (every code 0..255, the top code
    included), inactive (-1) examples and a duplicated stat column (the GBT
    hessian-gain-off layout). Stats are float32-representable."""
    rng = np.random.default_rng(seed)
    codes = np.concatenate(
        [rng.integers(0, 256, (n, f_num)).astype(np.uint8),
         rng.integers(0, 9, (n, f_cat)).astype(np.uint8)], axis=1)
    codes[: min(n, 3), 0] = 255
    g = rng.normal(size=n).astype(np.float32).astype(np.float64)
    w = rng.integers(0, 3, n).astype(np.float64)
    stats = np.stack([g * w, w, np.abs(g) * w, w], 1)[:, :s]
    node_of = rng.integers(-1, n_nodes, n).astype(np.int32)
    return codes, stats, node_of


@pytest.mark.parametrize("seed", range(4))
def test_numpy_and_simple_backends_equal_reference_bitwise(seed):
    codes, stats, node_of = random_mixed(seed)
    want = RefNumpy().build(codes, stats, node_of, 5)
    np.testing.assert_array_equal(
        NumpyHistogramBackend().build(codes, stats, node_of, 5), want)
    np.testing.assert_array_equal(
        SimpleHistogramBackend().build(codes, stats, node_of, 5), want)
    np.testing.assert_array_equal(
        SimpleHistogramBackend().build(codes, stats, node_of, 5),
        RefSimple().build(codes, stats, node_of, 5))


@pytest.mark.parametrize("n,n_nodes,s", [(300, 5, 4), (1, 3, 4), (257, 1, 3),
                                         (700, 12, 2)])
def test_plain_version_matches_reference_pallas_interpret(n, n_nodes, s):
    """Node counts that are not powers of two (the reference pads, the port
    does not), inactive rows, a ragged N and the top code."""
    codes, stats, node_of = random_mixed(n + n_nodes, n=n, s=s,
                                         n_nodes=n_nodes)
    want = RefPallas(interpret=True).build(codes, stats, node_of, n_nodes)
    got = CudaHistogramBackend(CPU, plain=True).build(codes, stats, node_of,
                                                      n_nodes)
    assert got.shape == want.shape == (n_nodes, 6, 256, s)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("seed", range(3))
def test_plain_version_is_the_float32_rounding_of_the_numpy_sum(seed):
    codes, stats, node_of = random_mixed(seed, n=2000, n_nodes=7)
    want = NumpyHistogramBackend().build(codes, stats, node_of, 7)
    got = ops.histogram(torch.from_numpy(codes),
                        torch.from_numpy(stats.astype(np.float32)),
                        torch.from_numpy(node_of), 7)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)
    # the count channel is exact
    np.testing.assert_array_equal(got.numpy()[..., -1], want[..., -1])


def test_wrapper_takes_the_plain_version_on_cpu_and_never_launches():
    codes, stats, node_of = (torch.from_numpy(a) for a in random_mixed(5))
    stats = stats.float()
    before = hist_kernel.LAUNCHES
    want = histogram_f32_ref(codes, stats, node_of, 5)
    for impl in (None, "ref"):
        assert torch.equal(ops.histogram(codes, stats, node_of, 5, impl=impl),
                           want)
    assert torch.equal(hist_kernel.histogram(codes, stats, node_of, 5), want)
    assert hist_kernel.LAUNCHES == before
    # codes >= n_bins add nothing
    small = hist_kernel.histogram(codes, stats, node_of, 5, n_bins=9)
    assert small.shape == (5, 6, 9, 4)
    assert torch.equal(small, want[:, :, :9])
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.histogram(codes, stats, node_of, 5, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.histogram(codes, stats, node_of, 5, impl="pallas")
    with pytest.raises(TypeError, match="float32"):
        hist_kernel.histogram(codes, stats.double(), node_of, 5)
    with pytest.raises(ValueError, match="share N"):
        hist_kernel.histogram(codes, stats[:-1].contiguous(), node_of, 5)


def test_backend_rules():
    assert resolve_backend("auto", "cpu").name == "numpy"
    assert resolve_backend(None, "cpu").name == "numpy"
    assert resolve_backend("numpy").name == "numpy"      # needs no device
    assert resolve_backend("simple").name == "simple"
    torch_be = resolve_backend("torch", "cpu")
    assert isinstance(torch_be, CudaHistogramBackend) and torch_be.plain
    assert torch_be.name == "torch" and not torch_be.exact_subtraction
    assert resolve_backend("torch", "cpu") is torch_be   # cached
    assert resolve_backend(torch_be) is torch_be          # instances pass
    assert resolve_backend("numpy").exact_subtraction
    assert not CudaHistogramBackend(CPU).exact_subtraction
    with pytest.raises(YdfError, match="CUDA device"):
        resolve_backend("cuda", "cpu")
    for name in ("pallas", "pallas_interpret"):
        with pytest.raises(YdfError, match="'cuda'.*'torch'"):
            resolve_backend(name, "cpu")
    with pytest.raises(YdfError, match="Unknown histogram_backend"):
        resolve_backend("warp", "cpu")
    assert set(hist_backend.NAMES) == {"auto", "numpy", "simple", "cuda",
                                       "torch"}


def test_auto_without_a_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_backend("auto").name == "cuda"
        return
    with pytest.raises(YdfError, match="device='cpu'"):
        resolve_backend("auto")


def test_torch_backend_counts_builds_and_returns_exact_rows():
    be = CudaHistogramBackend(CPU, plain=True)
    codes, stats, node_of = random_mixed(9, n=50, n_nodes=3)
    out = be.build(codes, stats, node_of, 3)
    assert out.shape == (3, 6, 256, 4) and be.builds == 1
    empty = be.build(codes[:0], stats[:0], node_of[:0], 1)
    assert empty.shape == (1, 6, 256, 4) and not empty.any()
    assert be.builds == 2
