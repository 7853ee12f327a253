"""Host waits for the device a block on decompress: the CUDA runtime's
synchronize calls inside the window's ``blocks.decompress_block`` ranges,
over the blocks (moves ``decompress_GBps``)."""

from benchmark import blockspans


def read(trace):
    return blockspans.syncs(trace, "blocks.decompress_block")
