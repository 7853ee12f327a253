"""The inverse BWT's device path (``bwt(device=true)``'s
``decompress``: ``unbwt_device``, with the copies): its output bytes
over the ``bwt.decompress`` spans' host seconds (moves
``decompress_GBps``)."""


def read(trace):
    recs = trace.records.get("bwt.decompress")
    if not recs:
        return None
    return sum(r["bytes_out"] for r in recs) / sum(r["seconds"]
                                                   for r in recs) / 1e9
