"""The block container's own milliseconds a block on compress: the time
inside the window's ``blocks.compress_block`` ranges that no range of the
inner compressor's phases covers, over the blocks (moves
``compress_GBps``)."""

from benchmark import blockspans


def read(trace):
    return blockspans.own_ms(trace, "blocks.compress_block")
