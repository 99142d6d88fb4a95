"""The whole window's share of the chip's peak on mixed columns: the least
time of its calls' work from raw columns to answers
(``workcount_mixed.scoring_call``) over the window's seconds."""
from bench import workcount_mixed
from bench.readers import share


def read(rec):
    return share(workcount_mixed.least_calls(
        rec, workcount_mixed.scoring_call), rec["window_s"])
