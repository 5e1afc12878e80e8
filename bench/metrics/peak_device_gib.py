"""The allocator's peak over the run on the fullest card, in GiB."""


def read(obs):
    return obs.peak_bytes / 2 ** 30
