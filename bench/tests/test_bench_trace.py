"""The trace reading: idle gaps go to the innermost span the host was in,
and the port's kernels are told from PyTorch's by their whole names."""
import pytest
from repro_torch.obs.trace import Tracer

from bench import harness, readers


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_idle_gaps_by_innermost_span():
    clock = Clock()
    tr = Tracer(clock=clock)
    outer = tr._open("outer", {})
    for k in range(3):                       # inner spans at 1-2, 3-4, 5-6
        clock.t = 2 * k + 1.0
        inner = tr._open("inner", {})
        clock.t += 1.0
        tr._close(inner)
    clock.t = 10.0
    tr._close(outer)
    # device busy 0-1.5 and 3.2-5.5; the window 0-12
    ivs = [(0.0, 1.5), (3.2, 5.5)]
    gaps = harness.idle_gaps(ivs, tr, {"window_t0": 0.0, "window_t1": 12.0})
    # 1.5-3.2 (middle 2.35: outer), 5.5-12 (middle 8.75: outer ended at 10)
    assert dict(gaps) == {"outer": 1.7 + 6.5}
    gaps = harness.idle_gaps([(0.0, 1.2), (1.8, 3.0)], tr,
                             {"window_t0": 0.0, "window_t1": 3.0})
    assert dict(gaps) == {"inner": pytest.approx(0.6)}


NAMES = {
    "void (anonymous namespace)::split_kernel<4>(unsigned char const*, "
    "(anonymous namespace)::Prep, int)": 0.5,
    "(anonymous namespace)::prep_kernel(float const*, int const*, int)": 0.25,
    "(anonymous namespace)::reduce_kernel(float const*, int*, int, int)": 0.125,
    "void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::MaxNanFunctor<float> > "
    "> >(at::native::ReduceOp<float>)": 2.0,
    "void at::native::(anonymous namespace)::reduce_kernel(float*)": 4.0,
    "(anonymous namespace)::split_kernel_v2(int)": 8.0,
    "void (anonymous namespace)::forest_infer_tiled_kernel<true, false>"
    "(forest_traverse::Args)": 16.0,
}


def test_kernels_are_matched_by_their_whole_names():
    rec = {"kernels": {k: [1, v] for k, v in NAMES.items()}}
    # PyTorch's own reduce_kernel, one in a namespace of PyTorch's and a
    # kernel whose name only starts like B1's are not B1
    assert readers.kernel_s(rec, readers.B1_KERNELS) == 0.875
    assert readers.kernel_s(rec, readers.B2_KERNELS) == 16.0
    assert not readers.is_kernel(
        "void at::native::reduce_kernel<512, 1>(int)", readers.B1_KERNELS)
