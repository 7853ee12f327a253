"""P3: the data-movement floor of the segment packers.

Counterpart of the TPU probe ``etc/probe_floor.py``, whose trivial
kernels read the segment rows (widened to i32, or u8 bit-cast to words,
at 8 and 32 segments per grid step) and wrote K2-shaped outputs. Here
``csrc/probe_floor.cu`` moves a segment's bytes and does nothing else:

- ``read``: the per-segment byte sum, ``i32[NC]``;
- ``copy``: the big-endian stream words ``i32[NC, 512]`` plus the sum,
  which is K1's and K2's write volume.

Each comes in four variants: a load form, one byte per thread
(``byte``) or 16-byte vector loads (``vec16``), times 1 or 4 segments
per block (the counterpart of the TPU's 8 or 32 per step). CUDA tensors
launch the kernel; CPU tensors take the plain version.
"""

from __future__ import annotations

import types

import torch

from tudocomp_tpu_torch import _build
from tudocomp_tpu_torch.ops.rle import be_words_from_bytes
from tudocomp_tpu_torch.ops.segpack import SEG, STREAM_WORDS

FUNCTIONS = ("read", "copy")
FORMS = ("byte", "vec16")
GROUPS = (1, 4)


def variant(function: str, form: str, group: int) -> str:
    """The name under which one variant counts its launches."""
    return f"floor_{function}_{form}_g{group}"


#: launch count of each variant, by name
COUNTERS = {variant(f, m, g): types.SimpleNamespace(launches=0)
            for f in FUNCTIONS for m in FORMS for g in GROUPS}


def _check_variant(function: str, form: str, group: int) -> None:
    if function not in FUNCTIONS or form not in FORMS or group not in GROUPS:
        raise ValueError(f"no floor variant {function!r}, {form!r}, "
                         f"group {group!r}: want one of {FUNCTIONS} x "
                         f"{FORMS} x {GROUPS}")


def floor_probe(rows: torch.Tensor, *, function: str, form: str,
                group: int):
    """``read``: the byte sum of each row of ``rows u8[NC, 2048]``, as
    ``i32[NC]``; ``copy``: ``(words i32[NC, 512], sums i32[NC])``, the
    rows as big-endian stream words and the same sums."""
    _check_variant(function, form, group)
    nc = rows.shape[0]
    _build.check(rows, torch.uint8, (nc, SEG), "rows")
    _build.check_aligned(rows, "rows", 16)
    if not _build.on_cuda(rows):
        return floor_probe_plain(rows, function=function)
    sums = torch.empty(nc, dtype=torch.int32, device=rows.device)
    words = (torch.empty(nc, STREAM_WORDS, dtype=torch.int32,
                         device=rows.device) if function == "copy" else None)
    if nc:
        _build.launch(
            "tdc_probe_floor", rows.data_ptr(),
            None if words is None else words.data_ptr(), sums.data_ptr(),
            nc, int(function == "copy"), int(form == "vec16"), group,
            device=rows.device,
        )
        COUNTERS[variant(function, form, group)].launches += 1
    return sums if words is None else (words, sums)


def floor_probe_plain(rows, *, function: str):
    """Plain torch floor: a widening sum, and the stream words."""
    sums = rows.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return (be_words_from_bytes(rows), sums) if function == "copy" else sums
