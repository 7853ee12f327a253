"""The BWT's device path (``bwt(device=true)``'s ``compress``: the
suffix array, ISA and BWT of ``ops/suffix.py``, with the copies): its
input bytes over the ``bwt.compress`` spans' host seconds (moves
``compress_GBps``)."""


def read(trace):
    recs = trace.records.get("bwt.compress")
    if not recs:
        return None
    return sum(r["bytes_in"] for r in recs) / sum(r["seconds"]
                                                  for r in recs) / 1e9
