"""Seconds from process start to the window's first timed call."""


def read(rec):
    return rec["setup_s"]
