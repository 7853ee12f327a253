"""The block container of tudocomp's ``blocks`` compressor, worked out
plainly.

``blocks(inner, b=N)`` cuts its input into blocks of ``N`` bytes (the
last one shorter) and runs each through a fresh ``inner`` compressor
alone, so that no state crosses a block. It writes:

    "TBK1" | vbyte(N) | for each block: vbyte(raw length)
    vbyte(payload length) payload

where a block's payload is the block run through the ``inner`` stages
in order, each by its own module of this package (``bwt.py`` escapes
and sentinels the block itself). An empty input has no block.
"""

from __future__ import annotations

import importlib
import inspect

from benchmark.reference import format as fmt

MAGIC = b"TBK1"


def _stages(inner: list, extra: dict) -> list:
    """Each inner stage's ``compress`` and its options: the stage's own,
    and those of ``extra`` that its ``compress`` takes by name. An option
    of ``extra`` that no stage takes raises."""
    out, taken = [], set()
    for stage in inner:
        fn = importlib.import_module("benchmark.reference."
                                     + stage["stage"]).compress
        takes = set(inspect.signature(fn).parameters) & set(extra)
        taken |= takes
        options = {k: v for k, v in stage.items() if k != "stage"}
        options.update({k: extra[k] for k in takes})
        out.append((fn, options))
    if set(extra) - taken:
        raise TypeError(f"no inner stage takes {sorted(set(extra) - taken)}")
    return out


def compress(data: bytes, device, *, b: int, inner: list,
             **extra) -> bytes:
    """The container; ``extra`` options (such as ``exact_hist``) go to
    each inner stage that takes them."""
    stages = _stages(inner, extra)
    out = bytearray(MAGIC + fmt.vbyte(b))
    for start in range(0, len(data), b):
        raw = data[start:start + b]
        payload = raw
        for fn, options in stages:
            payload = fn(payload, device, **options)
        out += fmt.vbyte(len(raw)) + fmt.vbyte(len(payload)) + payload
    return bytes(out)
