"""The whole window's share of the chip's peak: the least time of its
trainings' work (``workcount.training``) over the window's seconds."""
from bench import workcount
from bench.readers import share, training_work


def read(rec):
    b, o = training_work(rec)["whole"]
    return share(workcount.least_s(b, o), rec["window_s"])
