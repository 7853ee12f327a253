"""Plain torch versions of the stage probes (``tudocomp_tpu_torch.probes``)
against the JAX package and numpy.

The stage ablation of K2 (P1/P2) is checked stage by stage: the scan's
offsets against ``segpack_pallas._seg_excl_offsets`` (plain ``jnp`` under
its default implementation), the lookup against a numpy table lookup,
and stage 4 as ``huffman_pack_segments_plain``, which
``test_torch_ops.py`` holds against ``io/bitio.py:pack_tokens``. The
floor (P3) is checked against ``segpack_pallas.be_words_from_bytes`` and
a numpy sum, the placement (P4) per segment against
``ops/bitpack.py:pack_tokens_device``. CPU tensors take the plain
versions; every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tudocomp_tpu.coders.huffman import HuffmanTable
from tudocomp_tpu.ops.bitpack import pack_tokens_device
from tudocomp_tpu.ops.segpack_pallas import (
    _seg_excl_offsets, be_words_from_bytes,
)
from tudocomp_tpu_torch import device_tables
from tudocomp_tpu_torch.ops import PROBE_KERNELS
from tudocomp_tpu_torch.ops.segpack import (
    huffman_pack_segments_plain, huffman_terms,
)
from tudocomp_tpu_torch.probes import COUNTERS, ablate, floor, place

SEG = 2048
COUNTS = np.array([SEG, 0, 1, 2047, SEG, 1500, 2, 777], np.int32)


def _case():
    """Eight segments (random bytes, text, runs, a constant row) with
    counts 0, 1, 2, 777, 1500, 2047 and 2048, garbage past each count,
    and a Huffman table with codes of 3..16 bits."""
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (COUNTS.size, SEG), dtype=np.uint8)
    rows[1] = np.frombuffer(b"the <b>quick</b> fox; " * 94, np.uint8)[:SEG]
    rows[3] = np.repeat(rng.integers(0, 4, SEG, dtype=np.uint8),
                        rng.integers(1, 40, SEG))[:SEG]
    rows[4] = 200
    hist = rng.zipf(1.3, 256).clip(max=1 << 20) + 1
    table = HuffmanTable.from_counts(hist, max_len=16, min_len=3)
    return rows, table


def _stage(rows, table, stage, bytes_input):
    t = device_tables(table, "cpu")
    data = torch.from_numpy(rows)
    if not bytes_input:
        data = torch.from_numpy(rows.view(">u4").astype(np.uint32)
                                .view(np.int32))
    return ablate.huffman_pack_stage(
        data, torch.from_numpy(COUNTS), t["sym_code"], t["sym_len"],
        stage=stage, bytes_input=bytes_input)


def _live():
    return np.arange(SEG)[None, :] < COUNTS[:, None]


def _u32_sum(x) -> np.ndarray:
    """Wrapping u32 sum of each row, as the int32 bit pattern."""
    s = np.asarray(x, np.int64).sum(axis=1) & 0xFFFFFFFF
    return s.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("bytes_input", [False, True])
def test_ablate_load_and_lookup_match_numpy(bytes_input):
    rows, table = _case()
    live = _live()
    ln = np.where(live, table.sym_len[rows], 0)
    code = np.where(live, table.sym_code[rows], 0)
    s0 = _stage(rows, table, 0, bytes_input)
    s1 = _stage(rows, table, 1, bytes_input)
    assert s0.numpy().tolist() == _u32_sum(np.where(live, rows, 0)).tolist()
    assert s1.numpy().tolist() == _u32_sum(code + ln).tolist()


@pytest.mark.parametrize("bytes_input", [False, True])
def test_ablate_scan_matches_seg_excl_offsets(bytes_input):
    rows, table = _case()
    t = device_tables(table, "cpu")
    words = torch.from_numpy(rows.view(">u4").astype(np.uint32)
                             .view(np.int32))
    _, live, _, ln = huffman_terms(words, torch.from_numpy(COUNTS),
                                   t["sym_code"], t["sym_len"])
    # the TPU byte layout: 16 rows of 128 lanes per segment
    offs, _ = _seg_excl_offsets(
        jnp.asarray(ln.numpy().astype(np.int32).reshape(-1, 128)), 16)
    offs = np.asarray(offs).reshape(COUNTS.size, SEG)
    assert ((torch.cumsum(ln, 1) - ln).numpy() == offs).all()
    s2 = _stage(rows, table, 2, bytes_input)
    assert s2.numpy().tolist() == _u32_sum(np.where(live, offs, 0)).tolist()


@pytest.mark.parametrize("bytes_input", [False, True])
def test_ablate_place_and_store_are_k2(bytes_input):
    rows, table = _case()
    t = device_tables(table, "cpu")
    words = torch.from_numpy(rows.view(">u4").astype(np.uint32)
                             .view(np.int32))
    want_words, want_bits = huffman_pack_segments_plain(
        words, torch.from_numpy(COUNTS), t["sym_code"], t["sym_len"])
    got_words, got_bits = _stage(rows, table, 4, bytes_input)
    assert torch.equal(got_words, want_words)
    assert torch.equal(got_bits, want_bits)
    s3 = _stage(rows, table, 3, bytes_input)
    assert s3.numpy().tolist() == _u32_sum(
        want_words.numpy().view(np.uint32)).tolist()


@pytest.mark.parametrize("stage", range(5))
def test_ablate_byte_form_equals_word_form(stage):
    rows, table = _case()
    got = _stage(rows, table, stage, True)
    want = _stage(rows, table, stage, False)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("variant", [
    (f, m, g) for f in floor.FUNCTIONS for m in floor.FORMS
    for g in floor.GROUPS])
def test_floor_matches_be_words_and_sum(variant):
    function, form, group = variant
    rows, _ = _case()
    got = floor.floor_probe(torch.from_numpy(rows), function=function,
                            form=form, group=group)
    sums = rows.astype(np.int64).sum(axis=1)
    if function == "read":
        assert got.numpy().tolist() == sums.tolist()
        return
    words, got_sums = got
    want = np.asarray(be_words_from_bytes(jnp.asarray(rows)))
    assert (words.numpy().view(np.uint32) == want).all()
    assert got_sums.numpy().tolist() == sums.tolist()


@pytest.mark.parametrize("strategy", place.STRATEGIES)
@pytest.mark.parametrize("stride", place.STRIDES)
def test_place_matches_pack_tokens_device(strategy, stride):
    rows, _ = _case()
    words, bits = place.place_tokens(torch.from_numpy(rows),
                                     strategy=strategy, stride=stride)
    values, lens = place.fake_tokens(torch.from_numpy(rows), stride)
    for c in range(rows.shape[0]):
        want, total = pack_tokens_device(
            jnp.asarray(values[c].numpy().astype(np.uint32)),
            jnp.asarray(lens[c].numpy().astype(np.int32)))
        want = np.asarray(want)
        assert int(bits[c]) == int(total), c
        assert (words[c].numpy().view(np.uint32)
                == want[: place.OUT_WORDS]).all(), c
        assert not want[place.OUT_WORDS:].any()


def test_place_tokens_are_p4s():
    rows = np.arange(2 * SEG, dtype=np.uint8).reshape(2, SEG)
    for stride in place.STRIDES:
        values, lens = place.fake_tokens(torch.from_numpy(rows), stride)
        b = rows.astype(np.int64)
        want_lens = 8 + (b & 7)
        if stride == 2:
            want_lens[:, 1::2] = 0
        assert (lens.numpy() == want_lens).all()
        assert (values.numpy()
                == ((b << 8) | b) & ((1 << want_lens) - 1)).all()


@pytest.mark.parametrize("call", [
    lambda d, c, t: ablate.huffman_pack_stage(
        d, c, t["sym_code"], t["sym_len"], stage=5),
    lambda d, c, t: ablate.huffman_pack_stage(
        d, c, t["sym_code"], t["sym_len"], stage=-1),
    lambda d, c, t: floor.floor_probe(d, function="write", form="byte",
                                      group=1),
    lambda d, c, t: floor.floor_probe(d, function="read", form="vec8",
                                      group=1),
    lambda d, c, t: floor.floor_probe(d, function="read", form="byte",
                                      group=2),
    lambda d, c, t: place.place_tokens(d, strategy="int8", stride=1),
    lambda d, c, t: place.place_tokens(d, strategy="smem_atomic", stride=3),
], ids=["stage5", "stage-1", "function", "form", "group", "strategy",
        "stride"])
def test_probe_out_of_range_raises(call):
    rows, table = _case()
    with pytest.raises(ValueError):
        call(torch.from_numpy(rows), torch.from_numpy(COUNTS),
             device_tables(table, "cpu"))


def test_probe_counters_cover_every_variant():
    assert set(PROBE_KERNELS) == set(COUNTERS)
    assert len(PROBE_KERNELS) == (
        2 * len(ablate.STAGES)
        + len(floor.FUNCTIONS) * len(floor.FORMS) * len(floor.GROUPS)
        + len(place.STRATEGIES) * len(place.STRIDES))
