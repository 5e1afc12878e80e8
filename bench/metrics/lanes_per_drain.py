"""Requests a drain answered, averaged over the window's drains (the
engine's counters)."""


def read(obs):
    drains = obs.engine.get("device_batches", 0)
    return obs.engine["completed"] / drains if drains else None
