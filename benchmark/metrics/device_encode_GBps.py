"""The device stages of ``BlockCodec.encode`` with their copies (split,
upload, ``rle_stage``, the table build, ``huff_stage``, download): the
codec's input bytes over its ``timings["encode"]`` (moves
``compress_GBps``)."""


def read(trace):
    recs = trace.records.get("codec.compress")
    if not recs:
        return None
    return (sum(r["bytes_in"] for r in recs)
            / sum(r["timings"]["encode"] for r in recs) / 1e9)
