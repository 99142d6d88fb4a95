"""The whole window's share of the chip's peak: the least time of its
calls' work from raw columns to answers (``workcount.scoring_call``) over
the window's seconds."""
from bench import workcount
from bench.readers import least_calls, share


def read(rec):
    return share(least_calls(rec, workcount.scoring_call), rec["window_s"])
