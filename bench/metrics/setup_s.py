"""Seconds from the process's start to the window's: imports, the cards,
the kernels' load (and build, in a fresh checkout), the warm-up drains."""


def read(obs):
    return obs.setup_s
