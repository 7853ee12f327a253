"""The inverse BWT's device path inside the program (``bwt.inverse``:
upload, ``unbwt_device``, download): the output bytes of the window's
``bwt.inverse`` spans over their seconds (moves ``decompress_GBps``)."""

from benchmark import spans


def read(trace):
    return spans.rate(trace, "bwt.inverse", "bytes_out")
