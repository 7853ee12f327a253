"""The CLI front end on compress (``front.instantiate``,
``front.escape``, ``front.frame``): the input bytes of the window's
``compress`` phases over the seconds their ``front.*`` spans take,
overlaps counted once (moves ``compress_GBps``)."""

from benchmark import spans


def read(trace):
    return spans.front_rate(trace, "compress", "bytes_in")
