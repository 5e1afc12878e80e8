"""Mean time of DPService.step (admission, the drain: routing, the kernel,
the walk, the decode), by the benchmark's span around each call in the
traced window. Reads ``step_ms.single`` and ``step_ms.batched``."""

from bench import readers


def read(obs):
    return readers.span_mean_ms(obs, "step")
