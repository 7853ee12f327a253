"""The BWT's device path inside the program (``bwt.forward``: upload,
suffix array, ISA and BWT, download): the input bytes of the window's
``bwt.forward`` spans over their seconds (moves ``compress_GBps``)."""

from benchmark import spans


def read(trace):
    return spans.rate(trace, "bwt.forward", "bytes_in")
