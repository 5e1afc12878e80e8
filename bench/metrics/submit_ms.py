"""Mean time of DPService.submit (encode, digest, admission), by the
benchmark's span around each call in the traced window."""

from bench import readers


def read(obs):
    return readers.span_mean_ms(obs, "submit")
