"""K3: masked 256-bin histogram of stream bytes.

Counterpart of ``tudocomp_tpu/ops/hist_pallas.py:histogram_chunks``
(:67). It reads the big-endian stream words directly (the w4 contract
of ``ops/segpack.py``) instead of unpacked bytes. :func:`histogram_rows`
counts a strided slice of a batch's rows where they lie and adds into
the caller's int64 histogram (the codec's 1-in-8 sample, ``rle_stage``
in ``models/blockcodec.py``). CUDA tensors launch ``csrc/hist.cu``; CPU
tensors take the plain version.
"""

from __future__ import annotations

import torch

from tudocomp_tpu_torch import _build
from tudocomp_tpu_torch.ops.rle import bytes_from_words
from tudocomp_tpu_torch.ops.segpack import SEG, STREAM_WORDS


def _check_words(words, lengths) -> None:
    c = words.shape[0]
    _build.check(words, torch.int32, (c, STREAM_WORDS), "words")
    _build.check(lengths, torch.int32, (c,), "lengths")


def histogram_words(words: torch.Tensor, lengths: torch.Tensor):
    """Sum over rows of ``bincount(bytes(words[c])[:lengths[c]])`` for
    ``words i32[C, 512]`` (big-endian stream words) and ``lengths i32[C]``.
    Returns ``i32[256]`` (exact: integer atomics)."""
    _check_words(words, lengths)
    if not _build.on_cuda(words, lengths):
        return histogram_words_plain(words, lengths)
    c = words.shape[0]
    hist = torch.zeros(256, dtype=torch.int32, device=words.device)
    if c:
        _build.launch(
            "tdc_hist", words.data_ptr(), lengths.data_ptr(),
            hist.data_ptr(), c, device=words.device,
        )
        histogram_words.launches += 1
    return hist


histogram_words.launches = 0


def histogram_words_plain(words, lengths):
    """Plain torch K3: unpack, mask, bincount."""
    b = bytes_from_words(words, SEG).long()
    live = (torch.arange(SEG, device=words.device)[None, :]
            < lengths.long()[:, None])
    return torch.bincount(b[live], minlength=256).to(torch.int32)


def histogram_rows(words: torch.Tensor, lengths: torch.Tensor, rows: slice,
                   out: torch.Tensor) -> torch.Tensor:
    """K3 over the rows ``rows`` (a slice with a positive step) of
    ``words i32[C, 512]`` and ``lengths i32[C]``, read in place: the
    histogram of ``words[rows]`` masked to ``lengths[rows]`` is added
    into ``out i64[256]``, which is returned."""
    _check_words(words, lengths)
    _build.check(out, torch.int64, (256,), "out")
    picked = range(words.shape[0])[rows]
    if picked.step <= 0:
        raise ValueError(f"rows needs a positive step: {rows}")
    if not _build.on_cuda(words, lengths, out):
        return out.add_(histogram_rows_plain(words, lengths, rows))
    if len(picked):
        first = picked.start
        _build.launch(
            "tdc_hist_rows", words[first].data_ptr(),
            lengths[first:].data_ptr(), out.data_ptr(), len(picked),
            picked.step, device=words.device,
        )
        histogram_rows.launches += 1
    return out


histogram_rows.launches = 0


def histogram_rows_plain(words, lengths, rows: slice):
    """Plain torch strided K3: the ``i64[256]`` histogram of the gathered
    rows."""
    return histogram_words_plain(words[rows], lengths[rows]).long()
