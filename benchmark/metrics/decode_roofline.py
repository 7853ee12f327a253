"""K4's share of its roofline in ``BlockCodec.decompress_device``
(moves ``decompress_GBps``).

The least time is every payload byte of the container read once and
every decoded byte written once, over the card's memory bandwidth; the
time is that in which a kernel (no copy, no fill) ran inside the
``codec.decompress`` spans.
"""

from benchmark.reference.tbc2 import payload_bytes


def read(trace):
    recs = trace.records.get("codec.decompress")
    busy = trace.kernel_seconds("codec.decompress")
    peak = trace.peak("hbm_bytes_per_s")
    if not recs or not busy or not peak:
        return None
    moved = sum(sum(payload_bytes(r["container"])) for r in recs)
    return 100.0 * moved / peak / busy
