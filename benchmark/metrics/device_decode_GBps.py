"""The device decode of ``BlockCodec.decompress_device`` after the
parse, with its copies: decoded bytes over its ``timings["decode"]``
(moves ``decompress_GBps``)."""


def read(trace):
    recs = trace.records.get("codec.decompress")
    if not recs:
        return None
    return (sum(r["bytes_out"] for r in recs)
            / sum(r["timings"]["decode"] for r in recs) / 1e9)
