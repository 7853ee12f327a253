"""The TBC2 container's parse on the host (``BlockCodec._parse``: the
header, the table and every segment's frame): the container bytes of
the window's ``tbc2.parse`` spans over their seconds (moves
``decompress_GBps``)."""

from benchmark import spans


def read(trace):
    return spans.rate(trace, "tbc2.parse", "bytes_in")
