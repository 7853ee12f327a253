"""Container assembly (``BlockCodec._assemble``/``_frames``, numpy):
the codec's input bytes over its ``timings["assemble"]`` (moves
``compress_GBps``)."""


def read(trace):
    recs = trace.records.get("codec.compress")
    if not recs:
        return None
    return (sum(r["bytes_in"] for r in recs)
            / sum(r["timings"]["assemble"] for r in recs) / 1e9)
