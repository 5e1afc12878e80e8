"""Share of the traced window in which a card copied to or from pageable
host memory (the drain's tables and args read back to the host), averaged
over the cards, in percent."""

from bench import readers


def read(obs):
    return readers.pageable_share(obs)
