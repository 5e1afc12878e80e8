"""Answers polled within the window, over the window's seconds."""


def read(obs):
    return len(obs.latencies_ms) / obs.seconds if obs.latencies_ms else None
