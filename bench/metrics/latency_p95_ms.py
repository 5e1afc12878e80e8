"""95th percentile of the latencies of every request answered within the
window."""

from bench import readers


def read(obs):
    return readers.percentile_ms(obs, 95)
