"""K8: the frames of a TBC2 container, the body after its header.

Frame ``c`` is ``vbyte(meta1) vbyte(pbytes) payload``, with ``meta1 =
count << 2 | rle_raw << 1 | huff_raw`` and ``pbytes = (bits + 7) >> 3``
the bytes of the segment's payload: the first ``pbytes`` bytes of its
big-endian stream words, as K2 leaves them (``ops/segpack.py``).

Two routes, chosen by where the arrays are:

- host arrays: :func:`frames_host`, numpy (the JAX package's
  ``BlockCodec._frames``), for a CPU ``BlockCodec`` and the sharded
  callers in ``parallel/``;
- tensors: :func:`frame_layout` gives every frame's fields and its
  offset (an exclusive scan of the frame sizes over the whole input),
  then :func:`pack_batches` writes the frames into one ``u8[total]``
  buffer with :func:`pack_frames`, once per batch of stream words. On
  CUDA tensors that launches ``csrc/frames.cu``; CPU tensors take its
  plain torch version.

Both give the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from tudocomp_tpu_torch import _build
from tudocomp_tpu_torch.ops.rle import bytes_from_words
from tudocomp_tpu_torch.ops.segpack import SEG, STREAM_WORDS
from tudocomp_tpu_torch.utils.vbyte import encode_vbyte_array

#: bytes of the longest vbyte of a 32-bit value
VBYTE_MAX = 5


def frames_host(counts, rleraw, hraw, words, bits) -> bytes:
    """The frames of host arrays ``counts i32[n]``, ``rleraw``/``hraw``
    ``bool[n]``, ``words u32[n, 512]`` and ``bits i32[n]``, placed with
    numpy index arrays."""
    nseg = counts.shape[0]
    meta1 = (
        (counts.astype(np.uint64) << np.uint64(2))
        | (rleraw.astype(np.uint64) << np.uint64(1))
        | hraw.astype(np.uint64)
    )
    pbytes = (bits.astype(np.int64) + 7) // 8
    meta2 = pbytes.astype(np.uint64)

    def vb_lens(v):
        nb = np.ones(v.shape, np.int64)
        vv = v.copy()
        for _ in range(9):
            vv >>= np.uint64(7)
            nb += (vv > 0).astype(np.int64)
        return nb

    m1_payload = encode_vbyte_array(meta1)
    m2_payload = encode_vbyte_array(meta2)
    l1 = vb_lens(meta1)
    l2 = vb_lens(meta2)
    seg_sizes = l1 + l2 + pbytes
    seg_starts = np.concatenate([[0], np.cumsum(seg_sizes)[:-1]])
    buf = np.zeros(int(seg_sizes.sum()), np.uint8)

    def ragged_place(dst_starts, lens, src, src_starts):
        """buf[dst_starts[i] + j] = src[src_starts[i] + j]."""
        tot = int(lens.sum())
        if tot == 0:
            return
        piece = np.repeat(np.arange(lens.size), lens)
        within = np.arange(tot) - np.repeat(np.cumsum(lens) - lens, lens)
        buf[dst_starts[piece] + within] = src[src_starts[piece] + within]

    ragged_place(seg_starts, l1, m1_payload, np.cumsum(l1) - l1)
    ragged_place(seg_starts + l1, l2, m2_payload, np.cumsum(l2) - l2)
    payload = np.ascontiguousarray(
        words, dtype=">u4"
    ).view(np.uint8).reshape(nseg, -1)
    ragged_place(
        seg_starts + l1 + l2, pbytes, payload.reshape(-1),
        np.arange(nseg, dtype=np.int64) * payload.shape[1],
    )
    return buf.tobytes()


def vbyte_sizes(v: torch.Tensor) -> torch.Tensor:
    """Bytes of ``vbyte(v)`` for each value of a non-negative 32-bit
    ``v``, as i64."""
    v = v.long()
    return 1 + sum(((v >> (7 * k)) > 0).long() for k in range(1, VBYTE_MAX))


def frame_layout(counts, rle_raw, huff_raw, bits):
    """Every frame's fields and place, from ``counts i32[n]``,
    ``rle_raw``/``huff_raw`` ``bool[n]`` and ``bits i32[n]`` on one
    device. Returns ``(meta1 i32[n], pbytes i32[n], offs i64[n], head
    i64[3])``: ``offs`` is the exclusive scan of the frame sizes, and
    ``head`` holds the frames' total bytes and the counts of
    ``rle_raw`` and ``huff_raw`` segments, for the caller to read in one
    copy. Nothing here waits for the device."""
    meta1 = (counts << 2) | (rle_raw.int() << 1) | huff_raw.int()
    pbytes = (bits + 7) >> 3
    sizes = vbyte_sizes(meta1) + vbyte_sizes(pbytes) + pbytes.long()
    ends = torch.cumsum(sizes, 0)
    head = torch.stack([ends[-1], rle_raw.sum(), huff_raw.sum()])
    return meta1, pbytes, ends - sizes, head


def pack_frames(words: torch.Tensor, meta1: torch.Tensor,
                pbytes: torch.Tensor, offs: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
    """K8: frame ``c`` of ``words i32[nc, 512]``, ``meta1 i32[nc]`` and
    ``pbytes i32[nc]`` (each at most 2048) written at byte ``offs[c]``
    (i64) of ``out u8[*]``, which is returned. Bytes of ``out`` outside
    the frames are left as they are."""
    nc = words.shape[0]
    _build.check(words, torch.int32, (nc, STREAM_WORDS), "words")
    for t, dtype, name in ((meta1, torch.int32, "meta1"),
                           (pbytes, torch.int32, "pbytes"),
                           (offs, torch.int64, "offs")):
        _build.check(t, dtype, (nc,), name)
    _build.check(out, torch.uint8, (out.shape[0],), "out")
    if not _build.on_cuda(words, meta1, pbytes, offs, out):
        return pack_frames_plain(words, meta1, pbytes, offs, out)
    _build.check_aligned(out, "out", 16)
    if nc:
        _build.launch(
            "tdc_frame_pack", words.data_ptr(), meta1.data_ptr(),
            pbytes.data_ptr(), offs.data_ptr(), out.data_ptr(), nc,
            device=words.device,
        )
        pack_frames.launches += 1
    return out


pack_frames.launches = 0


def _vbyte_bytes(v: torch.Tensor) -> torch.Tensor:
    """``i64[n, VBYTE_MAX]``: the bytes of ``vbyte(v)``, then zeros."""
    v = v.long()
    n = vbyte_sizes(v)[:, None]
    k = torch.arange(VBYTE_MAX, device=v.device)
    groups = (v[:, None] >> (7 * k)) & 0x7F
    return torch.where(k + 1 < n, groups | 0x80, groups)


def pack_frames_plain(words, meta1, pbytes, offs, out):
    """Plain torch K8: each frame's bytes gathered in a padded row, then
    scattered to their offsets."""
    nc = words.shape[0]
    if nc == 0:
        return out
    k = torch.arange(SEG + 2 * VBYTE_MAX, device=words.device).expand(nc, -1)
    l1 = vbyte_sizes(meta1)[:, None]
    hl = l1 + vbyte_sizes(pbytes)[:, None]
    last = VBYTE_MAX - 1
    head = torch.where(
        k < l1, _vbyte_bytes(meta1).gather(1, k.clamp(max=last)),
        _vbyte_bytes(pbytes).gather(1, (k - l1).clamp(0, last)))
    body = bytes_from_words(words, SEG).long().gather(
        1, (k - hl).clamp(0, SEG - 1))
    live = k < hl + pbytes.long()[:, None]
    frame = torch.where(k < hl, head, body)
    out[(offs[:, None] + k)[live]] = frame[live].to(torch.uint8)
    return out


def pack_batches(words, meta1, pbytes, offs, total: int) -> torch.Tensor:
    """The frames of every batch of stream words ``words`` (a list of
    ``i32[nc_b, 512]``, in order), laid out by :func:`frame_layout`'s
    ``meta1``, ``pbytes`` and ``offs`` over all their rows: one
    :func:`pack_frames` a batch into a new ``u8[total]``."""
    out = torch.empty(total, dtype=torch.uint8, device=meta1.device)
    lo = 0
    for w in words:
        hi = lo + w.shape[0]
        pack_frames(w, meta1[lo:hi], pbytes[lo:hi], offs[lo:hi], out)
        lo = hi
    return out
