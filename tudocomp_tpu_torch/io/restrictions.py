"""Input escaping and sentinel handling.

Behavioral parity with the reference's restriction subsystem
(``io/InputRestrictions.hpp``, ``io/EscapeMap.hpp``, ``io/RestrictedBuffer``):
a compressor can declare (a) bytes that must not occur in its input and
(b) that the input must end with a unique ``\\0`` sentinel. The framework
escapes the input before compression and un-escapes after decompression.

Scheme (mirrors ``EscapeMap``): replacement bytes are drawn from a pool of
UTF-8-illegal bytes minus the restricted set; the first replacement byte is
the *escape byte* E. Every restricted byte ``b_i`` (including E itself)
becomes the pair ``[E, r_i]``; unescaping maps ``[E, r_i]`` back.
If a sentinel is required, ``\\0`` is added to the restricted set and a
single ``\\0`` is appended after escaping.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch.meta import InputRestrictions
from tudocomp_tpu_torch.stats import StatPhase

# UTF-8-illegal bytes, preferred for replacements (reference pool)
ESCAPE_BYTE_POOL = [255, 254, 192, 193, 245, 246, 247, 248, 249, 250, 251,
                    252, 253]


def build_escape_map(restrictions: InputRestrictions):
    """Returns (escape_bytes, replacement_bytes) aligned lists, or None.

    ``escape_bytes[0] == replacement_bytes[0]`` is the escape byte itself.
    """
    esc = list(restrictions.escape_bytes)
    if restrictions.null_terminate and 0 not in esc:
        esc = [0] + esc
    if not esc:
        return None
    pool = [b for b in ESCAPE_BYTE_POOL if b not in esc]
    if len(pool) < len(esc) + 1:
        # extend the pool with any unrestricted byte values
        extra = [b for b in range(256) if b not in esc and b not in pool]
        pool += extra
    if len(pool) < len(esc) + 1:
        # single-byte replacements need one unrestricted byte per
        # restricted one (plus the escape byte); silently truncating
        # would let restricted bytes through unescaped
        raise ValueError(
            f"escaping impossible: {len(esc)} restricted bytes leave "
            f"only {len(pool)} replacement bytes"
        )
    repl = pool[: len(esc) + 1]
    esc = [repl[0]] + esc
    return esc, repl


def escape(data: bytes, restrictions: InputRestrictions) -> bytes:
    """Escape restricted bytes; append sentinel if required. Vectorized.

    Where no restricted byte occurs (one ``find`` a restricted byte,
    each stopping at its first hit), the output is the input itself,
    plus the sentinel, in at most one copy. ``escaped`` counts the
    restricted bytes found."""
    with StatPhase("front.escape") as phase:
        out, escaped = _escape(data, restrictions)
        phase.log_stat("bytes_in", len(data))
        phase.log_stat("bytes_out", len(out))
        phase.log_stat("escaped", escaped)
    return out


def _escape(data: bytes, restrictions: InputRestrictions
            ) -> tuple[bytes, int]:
    em = build_escape_map(restrictions)
    if not isinstance(data, bytes):
        data = bytes(data)
    if em is None:
        return data, 0
    esc, repl = em
    if not any(bytes((e,)) in data for e in esc):
        return data + b"\x00" * restrictions.null_terminate, 0
    arr = np.frombuffer(data, dtype=np.uint8)
    lut = np.arange(256, dtype=np.uint8)
    flag = np.zeros(256, bool)
    for e, r in zip(esc, repl):
        lut[e] = r
        flag[e] = True
    is_esc = flag[arr]
    n_esc = int(is_esc.sum())
    out = np.empty(arr.size + n_esc, np.uint8)
    # position of each input byte in the output
    shift = np.cumsum(is_esc) - is_esc
    pos = np.arange(arr.size) + shift
    out[pos] = np.where(is_esc, np.uint8(repl[0]), arr)
    out[pos[is_esc] + 1] = lut[arr[is_esc]]
    out_bytes = out.tobytes()
    if restrictions.null_terminate:
        out_bytes += b"\x00"
    return out_bytes, n_esc


def unescape(data: bytes, restrictions: InputRestrictions) -> bytes:
    """Inverse of :func:`escape` (strips the sentinel first).

    Where the escape byte does not occur before the sentinel, the output
    is the input less its sentinel, in one slice. ``pairs`` counts the
    escape pairs resolved."""
    with StatPhase("front.unescape") as phase:
        out, pairs = _unescape(data, restrictions)
        phase.log_stat("bytes_in", len(data))
        phase.log_stat("bytes_out", len(out))
        phase.log_stat("pairs", pairs)
    return out


def _unescape(data: bytes, restrictions: InputRestrictions
              ) -> tuple[bytes, int]:
    end = len(data)
    if restrictions.null_terminate:
        if not data.endswith(b"\x00"):
            raise ValueError("restricted output missing sentinel")
        end -= 1
    em = build_escape_map(restrictions)
    if em is None:
        return data, 0
    esc, repl = em
    if data.find(bytes((repl[0],)), 0, end) < 0:
        return data[:end], 0
    arr = np.frombuffer(data, dtype=np.uint8, count=end).copy()
    back = np.arange(256, dtype=np.uint8)
    for e, r in zip(esc, repl):
        back[r] = e
    starts = np.flatnonzero(arr == np.uint8(repl[0]))
    # Escape pairs never overlap, and a raw E never survives escape()
    # unescaped, so every maximal run of consecutive E's is a chain of
    # (E,E) pairs possibly ending in an (E, r!=E) pair: the true pair
    # starts are exactly the even offsets within each run (vectorized
    # replacement of the per-escape resolution loop).
    run_head = np.concatenate([[True], np.diff(starts) > 1])
    head_idx = np.flatnonzero(run_head)
    run_id = np.cumsum(run_head) - 1
    offsets = starts - starts[head_idx][run_id]
    starts = starts[(offsets & 1) == 0]
    arr[starts + 1] = back[arr[starts + 1]]
    mask = np.ones(arr.size, bool)
    mask[starts] = False
    return arr[mask].tobytes(), int(starts.size)
