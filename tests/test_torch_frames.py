"""The TBC2 frames on the CPU: the route that ``BlockCodec.frames``
takes on every device (the frame layout, then K8's plain version a
batch) against the JAX package's ``BlockCodec._frames``. Every
comparison is exact."""

import pytest
import torch

import tudocomp_tpu.models.blockcodec as jax_blockcodec
from tudocomp_tpu_torch import BlockCodec
from tudocomp_tpu_torch.models.blockcodec import BATCH_LANES
from tudocomp_tpu_torch.ops.frames import (
    _vbyte_bytes, frame_layout, pack_batches, vbyte_sizes,
)
from tudocomp_tpu_torch.utils.vbyte import read_vbyte, write_vbyte
from tbc2_cases import FRAME_CASES, host_columns, stage_results


@pytest.mark.parametrize("batch_lanes", [BATCH_LANES, 5, 8])
@pytest.mark.parametrize("name", list(FRAME_CASES))
def test_frame_routes_match_the_jax_frames(name, batch_lanes):
    data, opts = FRAME_CASES[name]
    codec = BlockCodec(device="cpu", batch_lanes=batch_lanes, **opts)
    _, table, batches = stage_results(codec, data)
    host = host_columns(batches)
    counts, rle_raw, huff_raw, _, bits = host
    want = jax_blockcodec.BlockCodec()._frames(*host)
    meta1, pbytes, offs, head = frame_layout(*(
        torch.from_numpy(a) for a in (counts, rle_raw, huff_raw, bits)))
    assert head.tolist() == [len(want), int(rle_raw.sum()),
                             int(huff_raw.sum())]
    words = [b[3] for b in batches]
    got = pack_batches(words, meta1, pbytes, offs, len(want))
    assert got.numpy().tobytes() == want
    prefix = codec.prefix(len(data), table)
    assert codec.frames(batches, prefix) == prefix + want
    assert codec.compress(data) == prefix + want


def test_frame_cases_take_one_and_two_byte_fields():
    """Over the cases, each frame field takes one vbyte byte somewhere
    and two bytes somewhere."""
    lens = set()
    for data, opts in FRAME_CASES.values():
        batches = stage_results(BlockCodec(device="cpu", **opts), data)[2]
        counts, rle_raw, huff_raw, _, bits = host_columns(batches)
        meta1, pbytes, _, _ = frame_layout(*(
            torch.from_numpy(a) for a in (counts, rle_raw, huff_raw, bits)))
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
