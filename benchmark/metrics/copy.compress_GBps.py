"""Host<->device copies on compress: the ``bytes`` of the ``*.upload``
and ``*.download`` spans inside the window's ``compress`` phases over
the seconds those spans take (moves ``compress_GBps``)."""

from benchmark import spans


def read(trace):
    return spans.copy_rate(trace, "compress")
