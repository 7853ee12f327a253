"""The TBC2 frames on the CPU: the port's numpy twin (``ops/frames.py``)
against the JAX package's ``BlockCodec._frames``, and the tensor route
that K8 runs on the card (the frame layout, then its plain version a
batch) against the twin. Every comparison is exact."""

import numpy as np
import pytest
import torch

import tudocomp_tpu.models.blockcodec as jax_blockcodec
from tudocomp_tpu_torch import BlockCodec
from tudocomp_tpu_torch.models.blockcodec import BATCH_LANES
from tudocomp_tpu_torch.ops.frames import (
    _vbyte_bytes, frame_layout, frames_host, pack_batches, vbyte_sizes,
)
from tudocomp_tpu_torch.utils.vbyte import read_vbyte, write_vbyte
from tbc2_cases import FRAME_CASES


def _stages(data: bytes, opts: dict, batch_lanes: int):
    """The CPU codec's stage results of ``data`` on the host, and its
    payload words as tensors cut in its batches."""
    codec = BlockCodec(device="cpu", batch_lanes=batch_lanes, **opts)
    e = codec.encode(data)
    words = torch.split(torch.from_numpy(e.words.view(np.int32)),
                        batch_lanes)
    return codec, e, words


@pytest.mark.parametrize("batch_lanes", [BATCH_LANES, 5, 8])
@pytest.mark.parametrize("name", list(FRAME_CASES))
def test_frame_routes_match_the_jax_frames(name, batch_lanes):
    data, opts = FRAME_CASES[name]
    codec, e, words = _stages(data, opts, batch_lanes)
    host = (e.counts, e.rle_raw, e.huff_raw, e.words, e.bits)
    want = jax_blockcodec.BlockCodec()._frames(*host)
    assert frames_host(*host) == want
    meta1, pbytes, offs, head = frame_layout(*(
        torch.from_numpy(a) for a in (e.counts, e.rle_raw, e.huff_raw,
                                      e.bits)))
    assert head.tolist() == [len(want), int(e.rle_raw.sum()),
                             int(e.huff_raw.sum())]
    got = pack_batches(words, meta1, pbytes, offs, len(want))
    assert got.numpy().tobytes() == want
    container = codec.compress(data)
    prefix = codec._prefix(len(data), e.table)
    assert container == prefix + want


def test_frame_cases_take_one_and_two_byte_fields():
    """Over the cases, each frame field takes one vbyte byte somewhere
    and two bytes somewhere."""
    lens = set()
    for data, opts in FRAME_CASES.values():
        e = BlockCodec(device="cpu", **opts).encode(data)
        meta1, pbytes, _, _ = frame_layout(*(
            torch.from_numpy(a) for a in (e.counts, e.rle_raw, e.huff_raw,
                                          e.bits)))
        lens |= {("meta1", int(n)) for n in vbyte_sizes(meta1)}
        lens |= {("pbytes", int(n)) for n in vbyte_sizes(pbytes)}
    assert lens == {(f, n) for f in ("meta1", "pbytes") for n in (1, 2)}


@pytest.mark.parametrize("value", [0, 127, 128, 8193, 16384, 2**31 - 1])
def test_vbyte_sizes_match_read_vbyte(value):
    buf = bytearray()
    write_vbyte(buf, value)
    v = torch.tensor([value], dtype=torch.int32)
    assert read_vbyte(buf, 0) == (value, int(vbyte_sizes(v)[0]))
    got = _vbyte_bytes(v)[0].tolist()
    assert got == list(buf) + [0] * (len(got) - len(buf))
