"""The block container's own milliseconds a block on decompress: the time
inside the window's ``blocks.decompress_block`` ranges that no range of the
inner compressor's phases covers, over the blocks (moves
``decompress_GBps``)."""

from benchmark import blockspans


def read(trace):
    return blockspans.own_ms(trace, "blocks.decompress_block")
