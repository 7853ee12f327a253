"""K1, K3 and K2's share of their roofline in ``BlockCodec.compress``
(moves ``compress_GBps``).

The least time is the bytes the encode must move, over the card's
memory bandwidth: every input byte read once and every payload byte
written once, the payload counted from the container's frames, so that
it reads the same work whatever kernels do it. The time is that in
which a kernel (no copy, no fill) ran inside the ``codec.compress``
spans.
"""

from benchmark.reference.tbc2 import payload_bytes


def read(trace):
    recs = trace.records.get("codec.compress")
    busy = trace.kernel_seconds("codec.compress")
    peak = trace.peak("hbm_bytes_per_s")
    if not recs or not busy or not peak:
        return None
    moved = sum(sum(payload_bytes(r["container"])) for r in recs)
    return 100.0 * moved / peak / busy
