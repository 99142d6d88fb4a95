"""B2's share of its roofline on a forest with axis-aligned, oblique and
categorical conditions: the least time of the traversals the window's
calls needed (``workcount_mixed.b2_call``) over B2's device time."""
from bench import workcount_mixed
from bench.readers import B2_KERNELS, kernel_s, share


def read(rec):
    return share(workcount_mixed.least_calls(rec, workcount_mixed.b2_call),
                 kernel_s(rec, B2_KERNELS))
