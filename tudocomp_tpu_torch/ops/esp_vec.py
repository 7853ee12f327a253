"""Vectorized ESP round (array-program specification).

Re-derives the host ``esp_rounds`` loop (``compressors/esp.py``,
reference ``esp/EspContextImpl.hpp:14-165``) as whole-layer array
passes with zero per-symbol Python, producing the *identical* grammar:

- run/segment classification: one boundary diff + run-of-runs grouping
- type-1/3 eager 1-3 splitting: a closed-form block-start predicate
  ``is_start(k, L)`` (pinned against ``_split_eager13``)
- type-2 alphabet reduction: global label passes (windows never cross
  segment ends for the positions that are read)
- landmark marking + spanner: local-max/isolated-min flags with
  per-segment border sentinels; span cuts from the closed form
  ``e_k = i_k + 1 - [i_{k+1} == i_k + 2]`` (tie-to-right), last span
  to the segment end
- the reference's 1-block adjustment (``BlockAdjust.hpp`` /
  ``_merge_one_blocks``) as a local rewrite table per non-1 block
  (1-blocks are isolated, so merges never cascade beyond a
  [1, x, 1] neighborhood — handled by the (pre1, post1) table)
- rule ids in first-encounter order via two-phase ranking: inner
  (2-block + 3-block-inner) keys and outer keys are deduped with their
  first sequence position, then ranked globally by that position —
  reproducing the host's interleaved insertion order exactly.

The port's copy of ``tudocomp_tpu/ops/esp_vec.py``: the numpy
specification of a round, and the host tail of ``ops/esp.py``'s device
rounds once the layer is at most ``tail_cutoff`` symbols. Both are
pinned grammar-identical to ``esp_rounds``.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch.compressors.esp import iter_log

_I = np.int64


def eager13_starts(k, L):
    """Block-start predicate of ``_split_eager13`` (k local, L total)."""
    k = np.asarray(k, _I)
    L = np.asarray(L, _I)
    m3 = L % 3
    base = k % 3 == 0
    special = (m3 == 1) & (L > 1)
    return np.where(special, (base & (k <= L - 4)) | (k == L - 2),
                    base) | ((L == 1) & (k == 0))


def _label_pass(buf):
    """One alphabet-reduction pass: 2*ctz(l^r) + bit (vectorized)."""
    left = buf[:-1]
    right = buf[1:]
    diff = left ^ right
    ctz = np.zeros(diff.shape, _I)
    d = diff.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        mask = (d & ((_I(1) << _I(shift)) - 1)) == 0
        ctz += np.where(mask, shift, 0)
        d = np.where(mask, d >> _I(shift), d)
    bit = (right >> ctz) & 1
    return 2 * ctz + bit


def round_block_starts(s: np.ndarray, alphabet: int) -> np.ndarray:
    """Boolean block-start flags for one ESP round over layer ``s``."""
    n = s.size
    pos = np.arange(n, dtype=_I)
    # -- runs ---------------------------------------------------------
    boundary = np.concatenate([[True], s[1:] != s[:-1]])
    run_id = np.cumsum(boundary) - 1
    run_start = pos[boundary]
    run_len = np.diff(np.append(run_start, n))
    nr = run_start.size
    run_is1 = run_len == 1
    # segments = maximal groups of consecutive length-1 runs
    segb = run_is1 & np.concatenate([[True], ~run_is1[:-1]])
    seg_id_runs = np.cumsum(segb) - 1  # valid where run_is1
    # per-position segment start/length
    seg_start_runs = run_start[segb]  # position of each segment start
    # segment length = count of its runs (each length 1)
    seg_len_runs = np.bincount(
        seg_id_runs[run_is1], minlength=seg_start_runs.size
    )
    ilog = iter_log(alphabet)

    starts = np.zeros(n, bool)
    # type-1 runs: eager13 per run
    t1 = ~run_is1
    if t1.any():
        t1_starts = run_start[t1]
        t1_lens = run_len[t1]
        tot = int(t1_lens.sum())
        ramp = np.arange(tot) - np.repeat(
            np.cumsum(t1_lens) - t1_lens, t1_lens
        )
        gpos = np.repeat(t1_starts, t1_lens) + ramp
        starts[gpos] = eager13_starts(ramp, np.repeat(t1_lens, t1_lens))
    if seg_start_runs.size == 0:
        return starts
    # -- type-3 prefixes ------------------------------------------------
    p_seg = np.minimum(ilog, seg_len_runs)
    tot = int(p_seg.sum())
    ramp = np.arange(tot) - np.repeat(np.cumsum(p_seg) - p_seg, p_seg)
    gpos = np.repeat(seg_start_runs, p_seg) + ramp
    starts[gpos] = eager13_starts(ramp, np.repeat(p_seg, p_seg))
    # -- type-2 remainders ---------------------------------------------
    rem_len = seg_len_runs - p_seg  # reduced length m' = m - p
    has_rem = rem_len > 0
    if not has_rem.any():
        return starts
    # global reduced labels: ilog passes capped per segment by p_seg;
    # p < ilog only when p == seglen (no remainder), so for every
    # segment WITH a remainder p == ilog and the global passes match
    buf = s.astype(_I)
    for _ in range(ilog):
        if buf.size <= 1:
            break
        buf = _label_pass(buf)
    # 6 -> 3 remap within reduced regions: neighbors inside the region
    red_start = seg_start_runs[has_rem]
    red_len = rem_len[has_rem]
    tot = int(red_len.sum())
    ramp = np.arange(tot) - np.repeat(np.cumsum(red_len) - red_len,
                                      red_len)
    owner = np.repeat(np.arange(red_len.size), red_len)
    # reduced VALUES live left-aligned at seg_start + k (label passes
    # shift left); the remainder BLOCKS cover seg_start + p + k
    gpos = np.repeat(red_start, red_len) + ramp
    gpos_out = gpos + ilog
    red = buf[gpos].copy()
    first = ramp == 0
    last = ramp == red_len[owner] - 1
    for v in (3, 4, 5):
        hits = red == v
        if not hits.any():
            continue
        left = np.where(first, _I(-1), np.concatenate([[_I(-1)],
                                                       red[:-1]]))
        right = np.where(last, _I(-1), np.concatenate([red[1:],
                                                       [_I(-1)]]))
        e = np.zeros(red.size, _I)
        for _ in range(2):
            e = np.where(left == e, e + 1, e)
            e = np.where(right == e, e + 1, e)
        red = np.where(hits, e, red)
    # -- landmarks over each reduced region ------------------------------
    m = red_len[owner]
    k = ramp
    left = np.where(first, _I(-1), np.concatenate([[_I(-1)], red[:-1]]))
    right = np.where(last, _I(-1), np.concatenate([red[1:], [_I(-1)]]))
    high = (red > left) & (red > right)
    lowl = np.where(first, _I(4), np.concatenate([[_I(4)], red[:-1]]))
    lowr = np.where(last, _I(4), np.concatenate([red[1:], [_I(4)]]))
    low = (red < lowl) & (red < lowr)
    lm = high.copy()
    lm_l = np.where(first, False, np.concatenate([[False], lm[:-1]]))
    lm_r = np.where(last, False, np.concatenate([lm[1:], [False]]))
    lm |= low & ~lm_l & ~lm_r
    lm &= m > 1  # m == 1 regions take the bare [1] block
    # span cuts per region: next landmark within the region
    INF = _I(1 << 60)
    # next landmark strictly after k within the region:
    key_next = np.where(lm, k, INF)
    shifted = np.concatenate([key_next[1:], [INF]])
    shifted = np.where(last, INF, shifted)
    nxt2 = _region_suffix_min(shifted, owner)
    # span end produced by each landmark (except the region's last):
    # e = i + 1 - [next == i + 2]; the last landmark's span runs to the
    # region end (no cut)
    is_last_lm = lm & (nxt2 >= (_I(1) << 40) - 1)  # band-clipped INF
    e_local = k + 1 - (nxt2 == k + 2)
    cut_after = lm & ~is_last_lm
    # block-span starts within the region: region start + (cut_after
    # shifted by e_local)
    span_start_flags = np.zeros(red.size, bool)
    span_start_flags[first] = True
    cut_idx = np.flatnonzero(cut_after)
    if cut_idx.size:
        # cut after local e -> next span starts at local e + 1 (within
        # the same region by construction)
        tgt = cut_idx - k[cut_idx] + e_local[cut_idx] + 1
        span_start_flags[tgt] = True
    # compute per-position span start index / length (regions with no
    # landmark keep only their 'first' flag -> one span of length m,
    # which is exactly the eager13-over-m fallback)
    span_id = np.cumsum(span_start_flags) - 1
    span_first = np.full(int(span_id[-1]) + 1, INF, _I)
    np.minimum.at(span_first, span_id, np.arange(red.size, dtype=_I))
    span_next = np.append(span_first[1:], red.size)
    # spans never cross regions: force span end at region end
    sk = np.arange(red.size, dtype=_I) - span_first[span_id]
    # region end of each position
    reg_end = np.repeat(np.cumsum(red_len), red_len) - 1
    span_end = np.minimum(span_next[span_id] - 1, reg_end)
    sL = span_end - span_first[span_id] + 1
    in_start = eager13_starts(sk, sL)
    starts[gpos_out[in_start]] = True
    return starts


def _region_suffix_min(key, owner):
    """Suffix min within each owner region (owner nondecreasing):
    offset each region into its own value band, take the global suffix
    min, and mask out mins that came from a later region."""
    INF = _I(1 << 60)
    if key.size == 0:
        return key
    BAND = _I(1) << 40
    kb = owner.astype(_I) * BAND + np.minimum(key, BAND - 1)
    sfx = np.minimum.accumulate(kb[::-1])[::-1]
    val = sfx - owner.astype(_I) * BAND
    return np.where((sfx // BAND) == owner, val, INF)


def merge_one_blocks_vec(lens: np.ndarray) -> np.ndarray:
    """The 1-block adjustment as a local rewrite (see module doc)."""
    n = lens.size
    if n == 0:
        return lens
    is1 = lens == 1
    pre1 = np.zeros(n, bool)
    if n >= 2 and is1[0]:
        pre1[1] = True
    post1 = np.zeros(n, bool)
    post1[:-1] = is1[1:]
    keep = ~is1
    v = lens + pre1.astype(_I)
    # per kept block: (first, second) with second == 0 when absent
    first = np.where(v == 4, 2, v)
    second = np.where(v == 4, 2, 0)
    t = np.where(second > 0, second, first) + 1
    first2 = np.where(second > 0, first, np.where(t == 4, 2, t))
    second2 = np.where(
        second > 0,
        np.where(t == 4, -1, t),  # -1: expand 2,2 -> handled below
        np.where(t == 4, 2, 0),
    )
    # post1 case with an existing second == 2 and t == 4 -> [2,2,2]?
    # v==4 means first,second = 2,2; +1 on second -> 3 (t==3) or if
    # second+1 == 4 impossible (second==2 -> t==3). So t==4 only when
    # second == 0 and first == 3. The -1 branch is unreachable.
    out_first = np.where(post1, first2, first)
    out_second = np.where(post1, second2, second)
    counts = keep.astype(_I) * (1 + (out_second > 0))
    total = int(counts[keep].sum())
    res = np.empty(total, _I)
    off = np.cumsum(counts) - counts
    kept = np.flatnonzero(keep)
    res[off[kept]] = out_first[kept]
    two = kept[out_second[kept] > 0]
    res[off[two] + 1] = out_second[two]
    return res


def esp_round_vec(s: np.ndarray, alphabet: int):
    """One full ESP round: returns (new_layer, rules (a, b) int64[R,2])
    with rule ids offset from 0 (caller adds the global base)."""
    starts_flags = round_block_starts(s, alphabet)
    bstart = np.flatnonzero(starts_flags)
    lens0 = np.diff(np.append(bstart, s.size))
    lens = merge_one_blocks_vec(lens0)
    bstart = np.cumsum(np.concatenate([[0], lens[:-1]]))
    nb = lens.size
    a = s[bstart]
    b = s[np.minimum(bstart + 1, s.size - 1)]
    c = s[np.minimum(bstart + 2, s.size - 1)]
    is3 = lens == 3
    # phase A keys: (a, b) for every block (2-blocks and 3-block inners)
    # sequence positions: 2*i for block i's inner key, 2*i+1 for the
    # 3-block outer key — matching the host's interleaved insertion
    SH = _I(1) << 40  # symbols < 2^40
    keyA = a * SH + b
    posA = 2 * np.arange(nb, dtype=_I)
    uniqA, invA = np.unique(keyA, return_inverse=True)
    firstA = np.full(uniqA.size, _I(1) << 62)
    np.minimum.at(firstA, invA, posA)
    # phase B: outer keys (innerRuleIdentity, c) for 3-blocks; the
    # identity is the phase-A group index (a bijection of the rule)
    keyB = invA[is3] * SH + c[is3]
    posB = 2 * np.flatnonzero(is3).astype(_I) + 1
    uniqB, invB = np.unique(keyB, return_inverse=True)
    firstB = np.full(uniqB.size, _I(1) << 62)
    np.minimum.at(firstB, invB, posB)
    # global first-encounter ranking over A + B groups
    firsts = np.concatenate([firstA, firstB])
    order = np.argsort(firsts, kind="stable")
    rank = np.empty(firsts.size, _I)
    rank[order] = np.arange(firsts.size, dtype=_I)
    idA = rank[: uniqA.size]
    idB = rank[uniqA.size :]
    # rules table in id order: A rules are (a, b) decoded from the key;
    # B rules are (inner_final_id + base, c) — caller offsets; here we
    # keep symbols verbatim and inner ids as FINAL round-local ids
    R = firsts.size
    rules = np.empty((R, 2), _I)
    rules[idA, 0] = uniqA // SH
    rules[idA, 1] = uniqA % SH
    # B: inner identity is a phase-A group -> its final id (+alphabet
    # offset applied by the caller consistently for all symbols >= 256)
    innerA = uniqB // SH
    rules[idB, 0] = -(idA[innerA] + 1)  # marker: round-local rule ref
    rules[idB, 1] = uniqB % SH
    # new layer: per block the final top rule id (round-local)
    top = np.where(is3, 0, idA[invA])
    full_invB = np.zeros(nb, _I)
    full_invB[is3] = idB[invB]
    top = np.where(is3, full_invB, idA[invA])
    return top, rules


def esp_rounds_vec(data: bytes):
    """Full ESP: identical grammar to ``esp_rounds`` (host loop),
    computed as whole-layer array passes. Returns (rules, root, empty)."""
    s = np.frombuffer(data, np.uint8).astype(_I)
    if s.size == 0:
        return np.zeros((0, 2), _I), 0, True
    chunks = []
    base = 256
    alphabet = 256
    while s.size > 1:
        top, rules = esp_round_vec(s, alphabet)
        a = rules[:, 0]
        rules[:, 0] = np.where(a < 0, base + (-a - 1), a)
        chunks.append(rules)
        s = base + top
        base += rules.shape[0]
        alphabet = base
    all_rules = (
        np.concatenate(chunks) if chunks else np.zeros((0, 2), _I)
    )
    return all_rules, int(s[0]), False
