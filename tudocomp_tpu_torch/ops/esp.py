"""Device ESP rounds: the ESP grammar built round by round on a torch
device.

Counterpart of ``tudocomp_tpu/ops/esp_jax.py:esp_rounds_jax``, with the
same grammar (rules, root, ``empty``), bit-identical to the host
``esp_rounds`` and to ``ops/esp_vec.py``'s numpy specification, and not
the same formulation where the TPU's costs shaped it:

- each round works at the layer's live length, with no power-of-two
  padding and no static schedule; a Python loop runs the rounds and
  syncs once a round, to read the new layer's length and the round's
  rule count (the rounds' buffers are sized from them);
- gathers and scatters stand where JAX shifts or sorts to avoid them:
  the blocks are compacted by a scatter, a round's rules land at their
  ids by one scatter, and the new layer is read off in block order;
- a round's pairs are deduplicated by one stable ``torch.sort`` of a
  packed key, ``a * 256 + b`` in round 1 (bytes) and ``(a << 31) | b``
  after it (symbols stay under 2^30). The block index rises with the
  sequence position, so the stable sort orders rows as JAX's three-key
  ``lax.sort`` of (a, b, sequence) does;
- JAX's ``lax.cummax``, its reverse cummins and its segmented suffix min
  each look up the nearest flagged position before or after a position;
  here each is a count and a gather (``_ranked``): ``torch.cummin`` and
  ``torch.cummax`` scan a 1-D CUDA tensor in one row.

Rule ids follow the host's first-encounter order: each block's pair (A
event, at ``2 * j``) and, for a 3-block, its outer pair (B event, at
``2 * j + 1``) are numbered by an exclusive cumsum of the events that
open a new group. Pairs of one round never equal an earlier round's, so
the ids are round-local plus the rules so far. Once the live layer is at
most ``tail_cutoff`` symbols, the rounds finish on the host with
``esp_vec.esp_round_vec``; ``tail_cutoff=1`` runs every round on the
device. These are library calls (sorts, scans, gathers, scatters), as
the JAX module is plain ``jnp``: no Pallas kernel stands behind it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tudocomp_tpu_torch.compressors.esp import iter_log
from tudocomp_tpu_torch.device import resolve_device
from tudocomp_tpu_torch.ops import esp_vec

_I32 = torch.int32
_I64 = torch.int64
#: the packed key of a row outside the blocks (past every packed pair)
_KEY_NONE = 1 << 62


def _ranked(flag: torch.Tensor, pos: torch.Tensor):
    """(slots, incl): ``slots[r]`` is the position of the r-th flagged
    entry for r below the flag count and n from there up to slot n;
    ``incl[i]`` counts the flags at or before i. So the last flagged
    position <= i is ``slots[incl[i] - 1]`` and the first > i is
    ``slots[incl[i]]`` (n where there is none). The unflagged positions
    are written past slot n, each to its own slot (one address written
    by many threads would serialise them)."""
    n = flag.numel()
    incl = torch.cumsum(flag, 0)
    excl = incl - flag.long()
    slots = torch.full((2 * n + 1,), n, dtype=_I64, device=flag.device)
    slots.scatter_(0, torch.where(flag, excl, n + 1 + pos - excl), pos)
    return slots, incl


def _last_at_or_before(flag, pos):
    slots, incl = _ranked(flag, pos)
    return slots[(incl - 1).clamp(min=0)]


def _shr(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """out[i] = x[i - d], ``fill`` for i < d."""
    out = torch.full_like(x, fill)
    if d < x.numel():
        out[d:] = x[:-d]
    return out


def _shl(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """out[i] = x[i + d], ``fill`` past the end."""
    out = torch.full_like(x, fill)
    if d < x.numel():
        out[:-d] = x[d:]
    return out


def _eager13_starts(k, L):
    """Block-start predicate of ``_split_eager13`` (k local, L total)."""
    base = k % 3 == 0
    special = (L % 3 == 1) & (L > 1)
    return (torch.where(special, (base & (k <= L - 4)) | (k == L - 2), base)
            | ((L == 1) & (k == 0)))


def _label_pass(buf: torch.Tensor) -> torch.Tensor:
    """One alphabet-reduction pass over the whole layer, left-aligned:
    out[i] = 2 * ctz(buf[i] ^ buf[i + 1]) + bit. The last position (and
    any with equal neighbours) is never read."""
    right = torch.cat([buf[1:], buf[-1:]])
    d = buf ^ right
    ctz = torch.zeros_like(d)
    # symbols are below 2^30, so a difference has its lowest one bit
    # below bit 31
    for shift in (16, 8, 4, 2, 1):
        low = (d & ((1 << shift) - 1)) == 0
        ctz += torch.where(low, shift, 0)
        d = torch.where(low, d >> shift, d)
    return 2 * ctz + ((right >> ctz) & 1)


def _round_block_starts(s: torch.Tensor, ilog: int,
                        pos: torch.Tensor) -> torch.Tensor:
    """Boolean block-start flags of one round over the layer ``s``
    (``esp_vec.round_block_starts``)."""
    n = s.numel()
    # -- runs: type 1 splits eagerly ------------------------------------
    boundary = torch.ones(n, dtype=torch.bool, device=s.device)
    boundary[1:] = s[1:] != s[:-1]
    slots, incl = _ranked(boundary, pos)
    run_start = slots[incl - 1]
    run_len = slots[incl] - run_start
    run_is1 = run_len == 1
    starts = (run_len > 1) & _eager13_starts(pos - run_start, run_len)
    # -- segments: maximal groups of length-1 runs ------------------------
    prev_is1 = _shr(run_is1, 1, False)
    seg_start = _last_at_or_before(run_is1 & ~prev_is1, pos)
    slots, incl = _ranked(~run_is1, pos)
    seg_end = slots[incl] - 1
    seg_len = seg_end - seg_start + 1
    k_seg = pos - seg_start
    p_seg = seg_len.clamp(max=ilog)
    # type-3 prefix
    starts |= run_is1 & (k_seg < p_seg) & _eager13_starts(k_seg, p_seg)
    # -- type-2 remainders: reduced labels, landmarks, spans --------------
    rem = run_is1 & (k_seg >= p_seg)
    buf = s
    for _ in range(ilog):
        buf = _label_pass(buf)
    # every segment with a remainder has p_seg == ilog: its reduced label
    # at p sits at p - ilog (the passes shift left)
    red = torch.where(rem, _shr(buf, ilog, 0) if ilog else buf, 1 << 40)
    first = rem & (k_seg == p_seg)
    last = rem & (pos == seg_end)
    for v in (3, 4, 5):
        left = torch.where(first, -1, _shr(red, 1, -1))
        right = torch.where(last, -1, _shl(red, 1, -1))
        e = torch.zeros_like(red)
        for _ in range(2):
            e = torch.where(left == e, e + 1, e)
            e = torch.where(right == e, e + 1, e)
        red = torch.where(rem & (red == v), e, red)
    left = torch.where(first, -1, _shr(red, 1, -1))
    right = torch.where(last, -1, _shl(red, 1, -1))
    high = rem & (red > left) & (red > right)
    lowl = torch.where(first, 4, _shr(red, 1, 4))
    lowr = torch.where(last, 4, _shl(red, 1, 4))
    low = rem & (red < lowl) & (red < lowr)
    lm_l = ~first & _shr(high, 1, False)
    lm_r = ~last & _shl(high, 1, False)
    lm = (high | (low & ~lm_l & ~lm_r)) & (seg_len - p_seg > 1)
    # the next landmark after p, if it lies in p's region (landmarks are
    # at least two apart); a landmark that has one cuts its span after
    # local e = p + 1 - [next == p + 2], so the next span starts one or
    # two positions ahead
    slots, incl = _ranked(lm, pos)
    nxt = slots[incl]
    cut = lm & (nxt <= seg_end)
    span_flag = (first | _shr(cut & (nxt == pos + 2), 1, False)
                 | _shr(cut & (nxt != pos + 2), 2, False)) & rem
    slots, incl = _ranked(span_flag, pos)
    span_first = slots[(incl - 1).clamp(min=0)]
    span_end = torch.minimum(slots[incl] - 1, seg_end)
    starts |= rem & _eager13_starts(pos - span_first,
                                    span_end - span_first + 1)
    return starts


def _merged_heads(starts: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Block heads after the 1-block merge (``esp_vec.merge_one_blocks_vec``
    as flags): every kept block absorbs a following 1-block and, for
    block 1 only, a 1-block at position 0, and rewrites to one or two
    blocks of length 2 or 3."""
    slots, incl = _ranked(starts, pos)
    blen0 = slots[incl] - pos  # at start rows
    is1 = starts & (blen0 == 1)
    kept = starts & (blen0 > 1)
    pre1 = kept & (pos == 1) & is1[0]
    post1 = kept & (((blen0 == 2) & _shl(is1, 2, False))
                    | ((blen0 == 3) & _shl(is1, 3, False)))
    v = blen0 + pre1.long()  # in {2, 3, 4} at kept rows
    fst = torch.where(v == 4, 2, v)
    snd = torch.where(v == 4, 2, 0)
    t = torch.where(snd > 0, snd, fst) + 1
    fst2 = torch.where(snd > 0, fst, torch.where(t == 4, 2, t))
    snd2 = torch.where(snd > 0, t, torch.where(t == 4, 2, 0))
    out_fst = torch.where(post1, fst2, fst)
    out_snd = torch.where(post1, snd2, snd)
    has2 = kept & (out_snd > 0)
    d2 = out_fst - pre1.long()  # second block's offset in {1, 2, 3}
    head = (kept & ~pre1) | _shl(kept & pre1, 1, False)
    for d in (1, 2, 3):
        head |= _shr(has2 & (d2 == d), d, False)
    return head


def _group_first(key: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """For every row, the first row (smallest j) with its key: one
    stable sort, group heads where the sorted key changes, and the head
    of each sorted row's group sent back to the row."""
    sk, perm = torch.sort(key, stable=True)
    head = torch.ones_like(sk, dtype=torch.bool)
    head[1:] = sk[1:] != sk[:-1]
    first = perm[_last_at_or_before(head, j)]
    return torch.empty_like(first).scatter_(0, perm, first)


def _esp_round(s: torch.Tensor, ilog: int, base: int, first_round: bool):
    """One ESP round over the layer ``s`` (int64, length >= 2): the next
    layer, this round's rules (int64[R, 2], ids from ``base``) and R.
    Syncs once, for the new length and R."""
    n = s.numel()
    dev = s.device
    pos = torch.arange(n, dtype=_I64, device=dev)
    starts = _round_block_starts(s, ilog, pos) | (pos == 0)
    head = _merged_heads(starts, pos)
    del starts
    # every merged block has length 2 or 3: at most n // 2 blocks
    width = n // 2
    slots, incl = _ranked(head, pos)
    nb = incl[-1]
    j = torch.arange(width, dtype=_I64, device=dev)
    valid = j < nb
    hpos = slots[:width]  # n past the last block
    blen = slots[1:width + 1] - hpos
    a = s[hpos.clamp(max=n - 1)]
    b = s[(hpos + 1).clamp(max=n - 1)]
    c = s[(hpos + 2).clamp(max=n - 1)]
    is3 = valid & (blen == 3)
    del slots, incl, head, pos, hpos, blen
    # phase A: every block's pair (a, b)
    if first_round:
        key = torch.where(valid, a * 256 + b, 1 << 16).to(_I32)
    else:
        key = torch.where(valid, (a << 31) | b, _KEY_NONE)
    fa = _group_first(key, j)
    new_a = valid & (fa == j)
    # phase B: each 3-block's outer pair (its A group, c)
    fb = _group_first(torch.where(is3, (fa << 31) | c, _KEY_NONE), j)
    new_b = is3 & (fb == j)
    # ids in first-encounter order over the events 2j (A) and 2j+1 (B)
    cnt = new_a.long() + new_b.long()
    excl = torch.cumsum(cnt, 0) - cnt
    id_a = excl[fa]
    id_b = excl[fb] + new_a[fb].long()
    rule_count = excl[-1] + cnt[-1]
    # the new events land at their ids, the others each in a slot of its
    # own past 2 * width
    spare = 2 * width + 2 * j
    tgt = torch.stack([torch.where(new_a, excl, spare),
                       torch.where(new_b, excl + new_a.long(), spare + 1)],
                      dim=1).reshape(-1)
    pair = torch.stack([torch.stack([a, b], dim=1),
                        torch.stack([base + id_a, c], dim=1)],
                       dim=1).reshape(-1, 2)
    rules = torch.empty((4 * width, 2), dtype=_I64, device=dev)
    rules[tgt] = pair
    top = base + torch.where(is3, id_b, id_a)
    nb_h, r_h = torch.stack([nb, rule_count]).tolist()
    if nb_h > width:
        raise RuntimeError(f"ESP round made {nb_h} blocks of {n} symbols")
    return top[:nb_h], rules[:r_h].clone(), r_h


def esp_rounds_device(data: bytes, tail_cutoff: int = 4096, device="cuda",
                      stats: dict | None = None):
    """Full ESP with its big rounds on ``device`` (CUDA unless the caller
    names the CPU): (rules int64[R, 2], root, empty), bit-identical to
    ``esp_rounds``.

    Rounds run on the device while the live layer is longer than
    ``tail_cutoff`` symbols (``tail_cutoff=1``: every round), one host
    sync each; one transfer then brings the rules and the layer to the
    host, which finishes with ``esp_vec.esp_round_vec``. ``stats``, if
    given, receives ``device_rounds`` and ``device_rules`` (the rounds
    and rules of the device), ``tail_rounds`` and ``tail_s`` (the host
    tail's rounds and seconds)."""
    dev = resolve_device(device)
    if len(data) == 0:
        return np.zeros((0, 2), np.int64), 0, True
    if len(data) >= (1 << 30) - 512:
        # symbols reach 256 + the rules <= 256 + n, and the packed keys
        # need them below 2^30
        raise ValueError("device ESP requires len(data) < 2**30 - 512")
    parts = []
    base = 256
    rounds = 0
    if len(data) <= max(tail_cutoff, 1):
        s_host = np.frombuffer(data, np.uint8).astype(np.int64)
    else:
        t = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        s = t.long()
        del t
        chunks = []
        while s.numel() > max(tail_cutoff, 1):
            # iter_log saturates at 4 for every alphabet past 256
            s, rules, r = _esp_round(s, iter_log(256 if rounds == 0 else 257),
                                     base, rounds == 0)
            chunks.append(rules.reshape(-1))
            base += r
            rounds += 1
        # the hand-off: the rules and the layer in one transfer
        host = torch.cat(chunks + [s]).cpu().numpy()
        del chunks, s
        r_total = base - 256
        parts.append(host[: 2 * r_total].reshape(-1, 2))
        s_host = host[2 * r_total:]
    device_rules = base - 256
    t0 = time.perf_counter()
    tail = 0
    while s_host.size > 1:
        top, rules_rel = esp_vec.esp_round_vec(s_host, base)
        a = rules_rel[:, 0]
        rules_rel[:, 0] = np.where(a < 0, base + (-a - 1), a)
        parts.append(rules_rel)
        s_host = base + top
        base += rules_rel.shape[0]
        tail += 1
    if stats is not None:
        stats.update(device_rounds=rounds, device_rules=device_rules,
                     tail_rounds=tail, tail_s=time.perf_counter() - t0)
    all_rules = (np.concatenate(parts) if parts
                 else np.zeros((0, 2), np.int64))
    return all_rules, int(s_host[0]), False
