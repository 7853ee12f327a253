"""Host waits for the device a block on compress: the CUDA runtime's
synchronize calls inside the window's ``blocks.compress_block`` ranges,
over the blocks (moves ``compress_GBps``)."""

from benchmark import blockspans


def read(trace):
    return blockspans.syncs(trace, "blocks.compress_block")
