"""Device lcpcomp factorization: parallel greedy rounds over the LCP by
text position.

Counterpart of ``tudocomp_tpu/ops/lcpcomp_jax.py``, with the same
per-position LCP, the same factors and the same round count, and not
the same formulation where the TPU's limits shaped it:

- ``_lcp_by_position``: the q-gram ranks reach SA order by a gather
  (``ranks[q][sa]``) and the floors and SA predecessors reach text order
  by a scatter (``x_t[sa] = x``), where JAX co-sorts; the residual below
  256 bytes is ``ops/lzss.py``'s window compare (``_lcp_window`` over
  ``_byte_words``), the counterpart of JAX's ``_word_table``,
  ``_fetch_aligned_words`` and ``_window_settle``;
- ``_all_rounds``: JAX runs its rounds in one device ``while_loop``;
  here the host reads each round's largest candidate length (one sync a
  round) and stops before the selection of the round that finds none.
  That round changes nothing in JAX either, so the factors are the same,
  and it is counted, so the round count is JAX's. A sync costs about
  one launch's latency; a lagged no-op round would cost a whole round.
  Each round's dyadic windows are slices of the previous level (no
  concatenation), and the right-attack test keeps the window of each
  position's own level (``torch.bucketize`` of the lengths). JAX's two
  min/max scans become counts: ``torch.cummin``/``torch.cummax`` of a
  1-D CUDA tensor scan it in one row (44 ms each at 16.8 M int32 on an
  H100, 94% of a round), where ``torch.cumsum`` runs a device-wide
  scan. The next covered position is the covered position whose rank
  is the count of covered positions before p (``_next_covered``), and
  the union of the selected intervals is a +1/-1 count (``_cover``).

The selection rule itself (module docstring of ``lcpcomp_jax.py``): a
candidate of effective length ``el[p] = min(LCP, next_covered(p) - p)``
emits in a round iff no overlapping candidate dominates it (longer, or
as long and to its left), tested with dyadic windowed maxima; the
covered set grows by the selected intervals. These are library calls
(scans, sorts, gathers, scatters), as the JAX module is plain ``jnp``:
no Pallas kernel stands behind it.

Every function runs on the device of its input tensor, with JAX's int32
results.
"""

from __future__ import annotations

import numpy as np
import torch

from tudocomp_tpu_torch.device import resolve_device
from tudocomp_tpu_torch.ops.lzss import _byte_words, _lcp_window
from tudocomp_tpu_torch.ops.suffix import suffix_array_isa_ranks
from tudocomp_tpu_torch.stats import StatPhase

_I32 = torch.int32
_I64 = torch.int64

#: 32-bit words of the final window compare (4 * W = 256 bytes)
_W = 64


def _lcp_by_position(text: torch.Tensor, *, max_len: int):
    """(lcp0_p, src_p), int32: for every text position p, the LCP with
    its suffix-array predecessor (capped at max_len and at both
    suffixes' lengths) and that predecessor's position (-1 for the
    first suffix) — the reference's candidate set (pos=sa[i],
    src=sa[i-1], len=lcp[i]) indexed by text position
    (``lcpcomp_jax._lcp_by_position``).

    The floor of a pair is the largest q whose q-gram class holds both
    SA neighbours; rank probes at q = L/4 .. 256 bring the residual under
    256 bytes, and one window compare settles it."""
    n = text.numel()
    dev = text.device
    pos = torch.arange(n, dtype=_I64, device=dev)
    L = 4
    while L < max_len:
        L *= 2
    sa, isa, ranks = suffix_array_isa_ranks(text, L=L)
    del isa
    sa = sa.long()
    levels = sorted(ranks)
    floor = torch.zeros(n, dtype=_I64, device=dev)
    for q in levels:
        r = ranks[q][sa]
        floor[1:] = torch.where(r[1:] == r[:-1], q, floor[1:])
    prev = torch.empty(n, dtype=_I64, device=dev)
    prev[0] = -1
    prev[1:] = sa[:-1]
    floor_t = torch.empty_like(floor)
    floor_t[sa] = floor
    src = torch.empty_like(prev)
    src[sa] = prev
    del floor, prev, sa
    has = src >= 0
    # the pair's match cannot outrun either suffix: n-1-pos on the
    # target side, n - src on the source side
    limit = torch.minimum((n - 1 - pos).clamp(max=max_len),
                          torch.where(has, n - src, 0))
    length = torch.minimum(torch.where(has, floor_t, 0), limit)
    del floor_t
    cb = src.clamp(0, n - 1)
    # floor f means lcp in [f, 2f): only levels 256..L/4 can still extend
    for q in reversed([q for q in levels if 256 <= q <= L // 4]):
        rq = ranks[q]
        a = pos + length
        b = cb + length
        ok = (has & (a <= n - q) & (b <= n - q)
              & (rq[a.clamp(0, n - 1)] == rq[b.clamp(0, n - 1)])
              & (length + q <= limit))
        length = torch.where(ok, length + q, length)
    del ranks
    # a, b <= n: the words must reach byte n + 4 * W - 1
    words = _byte_words(text, 4 * _W + 8)
    matched = _lcp_window(words, pos + length, cb + length, _W)
    add = torch.minimum(matched, limit - length).clamp(min=0)
    return torch.where(has, length + add, 0).to(_I32), src.to(_I32)


def _next_covered(covered: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The first covered position >= p for every p, n where none (JAX's
    reverse cummin of ``where(covered, pos, n)``): the count of covered
    positions before p is the rank of that position, and one scatter
    lists the covered positions by rank."""
    n = covered.numel()
    before = torch.cumsum(covered, 0, dtype=_I32)
    before -= covered.to(_I32)
    # slots [0, n): the covered positions by rank, then n; slots past n
    # take the uncovered positions, each its own (one address written
    # by many threads would serialise them)
    by_rank = torch.full((2 * n + 1,), n, dtype=_I32, device=covered.device)
    by_rank.scatter_(0, torch.where(covered, before, n + 1 + pos - before)
                     .long(), pos)
    return by_rank[before.long()]


def _cover(covered: torch.Tensor, selected: torch.Tensor, el: torch.Tensor,
           pos: torch.Tensor) -> torch.Tensor:
    """``covered`` joined with the union of [p, p + el[p]) over the
    selected p (JAX's inclusive cummax of the interval ends, compared
    with the position): +1 at each start, -1 at each end, and a
    position is in the union iff the running count is positive."""
    n = covered.numel()
    sel = selected.to(_I32)
    delta = torch.zeros(n + 1, dtype=_I32, device=covered.device)
    delta[:n] = sel
    # the positions not selected add 0 at their own slot (distinct
    # addresses: no contended atomics)
    delta.index_add_(0, torch.where(selected, pos + el, pos).long(), -sel)
    return covered | (torch.cumsum(delta[:n], 0, dtype=_I32) > 0)


def _all_rounds(covered: torch.Tensor, chosen: torch.Tensor,
                lcp0_p: torch.Tensor, threshold: int, *, max_len: int):
    """Run max-class selection rounds to convergence
    (``lcpcomp_jax._all_rounds``).

    covered  bool[n]   — union of emitted target intervals
    chosen   i32[n]    — emitted factor length at its start (0 = none)
    lcp0_p   i32[n]    — LCP with the SA-predecessor, by text position
    Returns (covered, chosen, rounds): the round that finds no candidate
    of length >= threshold ends the loop and counts, and the loop stops
    at n rounds, as JAX's does."""
    n = covered.numel()
    dev = covered.device
    pos = torch.arange(n, dtype=_I32, device=dev)
    # dyadic window levels: attacks come from distances <= max_len, and
    # the right check needs one window of size >= max_len
    n_levels = 1
    while (1 << n_levels) < max_len:
        n_levels += 1
    bounds = torch.tensor([1 << k for k in range(n_levels + 1)],
                          dtype=_I32, device=dev)
    rounds = 0
    while rounds < n:
        rounds += 1
        # el[p] = min(LCP, distance to the first covered position >= p)
        el = torch.minimum(lcp0_p, _next_covered(covered, pos) - pos)
        active = el >= threshold
        elm = torch.where(active, el, 0)
        if int(elm.max()) < threshold:
            break
        # Candidate p emits iff it beats every candidate whose target
        # overlaps p's (ties break leftmost):
        #   left:  no q with q + el[q] > p     with el[q] >= el[p]
        #   right: no q in (p, p+el[p])        with el[q] >  el[p]
        # tested with tk[i] = max elm over [i, i + 2^k) by level.
        left = torch.zeros(n, dtype=torch.bool, device=dev)
        left[1:] = elm[:-1] >= el[1:].clamp(min=2)  # d = 1 exact
        # level of each length: 0 for el <= 1, k for 2^(k-1) < el <= 2^k
        lvl = torch.bucketize(el, bounds)
        # the window [p + 1, p + 1 + 2^k) of p's own level k
        rwin = torch.zeros(n, dtype=_I32, device=dev)
        tk = elm
        for k in range(n_levels + 1):
            w = 1 << k
            if k > 0 and w // 2 < n:
                h = w // 2
                nxt = torch.empty_like(tk)
                torch.maximum(tk[: n - h], tk[h:], out=nxt[: n - h])
                nxt[n - h:] = tk[n - h:]
                tk = nxt
            # left attackers at distance d in (2^k, 2^(k+1)] need
            # el[q] >= max(el[p], d + 1) >= max(el[p], 2^k + 1)
            if 2 * w < n:
                left[2 * w:] |= tk[: n - 2 * w] >= el[2 * w:].clamp(min=w + 1)
            torch.where(lvl[:-1] == k, tk[1:], rwin[:-1], out=rwin[:-1])
        selected = active & ~left & ~(rwin > el)
        covered = _cover(covered, selected, el, pos)
        chosen = torch.where(selected, el, chosen)
    return covered, chosen, rounds


def factorize_device(text: np.ndarray, threshold: int,
                     max_len: int = 4096, device="cuda"):
    """Device lcpcomp factorization of ``text`` (numpy u8) on
    ``device`` (raises for CUDA where CUDA is absent). Returns (pos,
    src, len) int64 arrays, by position; factors may point forward,
    exactly like the host strategies (``lcpcomp_jax.factorize_device``).
    Logs ``device_rounds``."""
    n = int(text.size)
    if n < 2 or threshold < 1:
        return (np.zeros(0, np.int64),) * 3
    max_len = min(max_len, max(4, n - 1))
    dev = resolve_device(device)
    t = torch.from_numpy(np.array(text, np.uint8)).to(dev)
    lcp0_p, src_p = _lcp_by_position(t, max_len=max_len)
    covered = torch.zeros(n, dtype=torch.bool, device=dev)
    chosen = torch.zeros(n, dtype=_I32, device=dev)
    covered, chosen, rounds = _all_rounds(covered, chosen, lcp0_p,
                                          threshold, max_len=max_len)
    StatPhase.log("device_rounds", rounds)
    starts = torch.nonzero(chosen > 0).squeeze(1)
    return tuple(x.cpu().numpy().astype(np.int64)
                 for x in (starts, src_p[starts], chosen[starts]))
