"""Host<->device copies on decompress: the ``bytes`` of the
``*.upload`` and ``*.download`` spans inside the window's
``decompress`` phases over the seconds those spans take (moves
``decompress_GBps``)."""

from benchmark import spans


def read(trace):
    return spans.copy_rate(trace, "decompress")
