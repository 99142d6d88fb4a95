"""B1's share of its roofline: the least time of the split searches the
window's trainings needed (``workcount.b1_level``) over B1's device time."""
from bench import workcount
from bench.readers import B1_KERNELS, kernel_s, share, training_work


def read(rec):
    b, o = training_work(rec)["b1"]
    return share(workcount.least_s(b, o), kernel_s(rec, B1_KERNELS))
