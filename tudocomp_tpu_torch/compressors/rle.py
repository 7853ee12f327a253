"""Run-length encoder (byte-level).

The port's copy of ``tudocomp_tpu/compressors/rle.py``, with the same
bytes: the buffered encode (numpy), the one-pass stream encode, and the
host library's whole and chunked decoders (``rle_decode`` below is the
Python specification of the former).

Format follows the reference ``compressors/RunLengthEncoder.hpp``: a run
of ``n >= 2`` equal bytes is stored as the byte twice followed by
``vbyte(n - 2 + offset)``; single bytes are stored verbatim. One
amendment of the JAX package (its ``ops/rle_jax.py``): runs are split into pieces
of at most ``RUN_CAP = 8192`` bytes, so every piece's wire contribution
fits one 32-bit packer token. The reference decoder keeps ``prev = c``
armed after a run (``RunLengthEncoder.hpp`` rle_decode), so a
continuation piece of length ``L`` is encoded as the *single* byte
followed by ``vbyte(L - 1 + offset)`` — one char, not two — which the
reference decoder expands as ``run + 1`` copies. Split output is
therefore decodable by the reference tool bit-for-bit; cost is 3 bytes
per 8 KiB of run.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.compressors.base import Compressor
from tudocomp_tpu_torch.meta import Meta
from tudocomp_tpu_torch.utils.vbyte import encode_vbyte_array, write_vbyte

RUN_CAP = 8192


def rle_encode(arr: np.ndarray, offset: int = 0) -> np.ndarray:
    if arr.size == 0:
        return arr
    # index dtype at bits_for width: a low-run input (e.g. an english
    # BWT) has ~0.7 runs/byte, and the ~10 run-scale work arrays below
    # peaked >4 GB at 100 MB as int64
    # (int32 cumsums cover the worst-case 1.5x output expansion too)
    dt = np.int32 if arr.size < (1 << 30) else np.int64
    boundary = np.empty(arr.size, bool)
    boundary[0] = True
    np.not_equal(arr[1:], arr[:-1], out=boundary[1:])
    run_starts = np.flatnonzero(boundary).astype(dt)
    run_lens = np.diff(np.append(run_starts, dt(arr.size)))
    run_chars = arr[run_starts]
    # split runs into <= RUN_CAP pieces; the first piece of a run uses the
    # doubled-char form, continuation pieces the single-char form (the
    # reference decoder's prev stays armed after a run)
    n_pieces = (-(-run_lens // RUN_CAP)).astype(dt)
    chars = np.repeat(run_chars, n_pieces)
    lens = np.full(chars.size, RUN_CAP, dt)
    ends_cum = np.cumsum(n_pieces, dtype=dt)
    lens[ends_cum - 1] = run_lens - (n_pieces - 1) * RUN_CAP
    is_first = np.zeros(chars.size, bool)
    is_first[ends_cum - n_pieces] = True
    del run_starts, run_lens, run_chars, n_pieces, ends_cum, boundary
    has_vb = ~is_first | (lens >= 2)
    v = (np.where(is_first, lens - 2, lens - 1)[has_vb] + offset).astype(
        np.uint64
    )
    run_payload = encode_vbyte_array(v)
    vlens = np.zeros(chars.size, dt)
    if has_vb.any():
        nb = np.ones(v.shape, dt)
        vv = v.copy()
        for _ in range(9):
            vv >>= np.uint64(7)
            nb += (vv > 0).astype(dt)
        vlens[has_vb] = nb
    nchars = np.where(has_vb & is_first, dt(2), dt(1))
    out_lens = nchars + vlens
    out_ends = np.cumsum(out_lens, dtype=dt)
    total = int(out_ends[-1])
    out = np.empty(total, np.uint8)
    out_starts = out_ends - out_lens
    del out_ends, out_lens
    out[out_starts] = chars
    doubled = has_vb & is_first
    out[out_starts[doubled] + 1] = chars[doubled]
    # scatter vbyte payloads after the char(s)
    if has_vb.any():
        v_starts = (out_starts + nchars)[has_vb]
        vl = vlens[has_vb]
        tot = int(vl.sum())
        ramp = np.arange(tot, dtype=dt) - np.repeat(
            np.cumsum(vl, dtype=dt) - vl, vl
        )
        out[np.repeat(v_starts, vl) + ramp] = run_payload
    return out


def rle_decode(arr: np.ndarray, offset: int = 0) -> bytes:
    out = bytearray()
    data = arr.tolist()
    i = 0
    n = len(data)
    prev = -1
    while i < n:
        c = data[i]
        out.append(c)
        i += 1
        if c == prev:
            # read vbyte run length
            run = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                run |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            run -= offset
            out.extend([c] * run)
            prev = c  # reference keeps prev armed after a run
        else:
            prev = c
    return bytes(out)


class RunLengthEncoder(Compressor):
    @classmethod
    def meta(cls):
        m = Meta("compressor", "rle", "Run Length Encoding Compressor")
        m.option_dynamic("offset", 0)
        return m

    def compress(self, data: bytes) -> bytes:
        off = self.env.option("offset").as_int()
        return rle_encode(np.frombuffer(data, np.uint8), off).tobytes()

    def decompress(self, data: bytes) -> bytes:
        off = self.env.option("offset").as_int()
        return native.rle_decode(np.frombuffer(data, np.uint8), off)


#: streaming chunk size (state is one pending run; RSS stays O(CHUNK))
STREAM_CHUNK = 1 << 22


def _emit_run(fout, c: int, length: int, offset: int) -> None:
    """Encode one complete run, mirroring rle_encode's RUN_CAP piece
    split (first piece doubled-char + vbyte(len-2+offset), continuation
    pieces single-char + vbyte(len-1+offset))."""
    first = min(length, RUN_CAP)
    if first == 1:
        fout.write(bytes([c]))
    else:
        buf = bytearray([c, c])
        write_vbyte(buf, first - 2 + offset)
        fout.write(bytes(buf))
    rem = length - first
    while rem:
        piece = min(rem, RUN_CAP)
        buf = bytearray([c])
        write_vbyte(buf, piece - 1 + offset)
        fout.write(bytes(buf))
        rem -= piece


def _rle_compress_stream(self, fin, fout) -> None:
    """One-pass streaming encode: carries only the run cut by the chunk
    edge; output byte-identical to the buffered rle_encode (runs are
    context-free in the wire format, and chunk cuts land only on run
    boundaries here)."""
    off = self.env.option("offset").as_int()
    pend_c = -1
    pend_n = 0
    while True:
        chunk = fin.read(STREAM_CHUNK)
        if not chunk:
            break
        arr = np.frombuffer(chunk, np.uint8)
        if pend_n:
            neq = arr != pend_c
            lead = int(np.argmax(neq)) if neq.any() else arr.size
            pend_n += lead
            arr = arr[lead:]
            if arr.size == 0:
                continue
            _emit_run(fout, pend_c, pend_n, off)
            pend_n = 0
        last = int(arr[-1])
        neq = np.flatnonzero(arr != last)
        tail_start = int(neq[-1] + 1) if neq.size else 0
        body = arr[:tail_start]
        if body.size:
            fout.write(rle_encode(body, off).tobytes())
        pend_c = last
        pend_n = arr.size - tail_start
    if pend_n:
        _emit_run(fout, pend_c, pend_n, off)


def _rle_decompress_stream(self, fin, fout) -> None:
    """One-pass streaming decode: carries ``prev`` plus at most one
    token split by the chunk edge (the host library's
    tdc_rle_decode_s)."""
    off = self.env.option("offset").as_int()
    prev = -1
    held = b""
    while True:
        chunk = fin.read(STREAM_CHUNK)
        final = not chunk
        data = held + chunk
        if not data:
            return
        out, consumed, prev = native.rle_decode_stream(
            np.frombuffer(data, np.uint8), off, prev, final
        )
        fout.write(out)
        held = data[consumed:]
        if final:
            if held:
                raise ValueError("malformed RLE stream")
            return


RunLengthEncoder.supports_streaming = True
RunLengthEncoder.compress_stream = _rle_compress_stream
RunLengthEncoder.decompress_stream = _rle_decompress_stream
