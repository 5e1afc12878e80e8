"""Share of the traced window in which no kernel, set or copy that the host
does not pace ran on a card, averaged over the cards, in percent. Reads
``device_idle_share.single`` and ``device_idle_share.batched``."""

from bench import readers


def read(obs):
    return readers.idle_share(obs)
