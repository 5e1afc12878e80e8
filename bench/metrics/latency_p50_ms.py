"""Median latency, submit to the poll that returns the answer, over every
request answered within the window."""

from bench import readers


def read(obs):
    return readers.percentile_ms(obs, 50)
