"""The CLI front end on decompress (``front.unframe``,
``front.instantiate``, ``front.unescape``): the output bytes of the
window's ``decompress`` phases over the seconds their ``front.*`` spans
take, overlaps counted once (moves ``decompress_GBps``)."""

from benchmark import spans


def read(trace):
    return spans.front_rate(trace, "decompress", "bytes_out")
