"""K1 (csrc/sdp_pipeline.cu): the least time of the lanes its route solved
in the traced window, over its device time there, in percent."""

from bench import readers


def read(obs):
    return readers.roofline_share(obs, "sdp_pipeline")
