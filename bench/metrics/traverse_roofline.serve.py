"""B2's share of its roofline: the least time of the traversals the
window's calls needed (``workcount.b2_call``) over B2's device time."""
from bench import workcount
from bench.readers import B2_KERNELS, kernel_s, least_calls, share


def read(rec):
    return share(least_calls(rec, workcount.b2_call), kernel_s(rec, B2_KERNELS))
