"""Device LZ77 factorization: the exact longest-previous-factor matcher,
the q-gram class matcher, the greedy commit walk and the device
factor-stream resolve.

Counterpart of ``tudocomp_tpu/ops/lzss_jax.py``, with the same
per-position answers and not the same formulation. The JAX module writes
every step as sorts and scans because gathers are slow on a TPU; on a
GPU gathers and scatters are cheap, so here:

- ``rank_tables``: one stable ``torch.sort`` of a packed int64 key a
  doubling round (as ``ops/suffix.py``), tail positions keeping their
  unique negative ids (offset before packing);
- ``_match_device`` (``comp=device_fast``): per q-gram level one stable
  sort of the ranks, the nearest and second-nearest previous position
  of the same class read off the sorted order, a scatter back;
- ``_psv_smaller``/``_nsv_smaller`` (all-nearest-smaller-values): a
  sparse table of range minima over the whole array, log2(m) levels,
  and one binary-lifting descent per query, a gather a level. The JAX
  version compares every element with every chunk minimum, (m, m/128)
  elements; no tensor here is larger than m;
- the LCP level floors of ``_match_exact_device`` compare each SA slot's
  rank with its neighbour's by a gather (the q-groups are contiguous in
  SA order), where JAX runs two segmented scans a level;
- ``_lcp_window``: the common prefix of two text windows of up to 256
  bytes, compared eight bytes at a time from a table of the big-endian
  64-bit word at every byte, in blocks of positions (JAX builds an
  (n/4, 66) Hankel table of 32-bit words).

``commit_walk`` is host numpy, a copy of JAX's. These are library calls
(sorts, scans, gathers, scatters), as the JAX module is plain ``jnp``:
no Pallas kernel stands behind it.

Every function runs on the device of its input tensor; matchers return
int32 (cand, length) as JAX's do.
"""

from __future__ import annotations

import numpy as np
import torch

from tudocomp_tpu_torch.ops.suffix import _densify, suffix_array_isa_ranks

_I32 = torch.int32
_I64 = torch.int64

LEVELS = (4, 8, 16, 32, 64)

#: positions per block of ``_lcp_window`` (its gathers are (block, 32)
#: int64 tensors: 256 MiB a side at this size)
WINDOW_BLOCK = 1 << 20


def _shifted(r: torch.Tensor, k: int) -> torch.Tensor:
    """``r[i + k]``; the last ``min(k, n)`` positions get the unique
    negative ids ``-2, -3, ...`` so truncated grams never compare equal."""
    n = r.numel()
    m = min(k, n)
    out = torch.empty_like(r)
    out[: n - m] = r[m:]
    out[n - m:] = -2 - torch.arange(m, dtype=r.dtype, device=r.device)
    return out


def _dense_rank(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Dense ranks of the pairs ``(hi, lo)`` in text order: one stable
    sort of ``hi * (n + 258) + lo + n + 2`` (``hi`` in [0, max(n, 256)),
    ``lo`` in [-(n + 1), max(n, 256))), which orders the pairs as JAX's
    two-key ``lax.sort`` does."""
    n = hi.numel()
    key = hi.to(_I64) * (n + 258) + (lo.to(_I64) + n + 2)
    return _densify(key)[0]


def rank_tables(text: torch.Tensor, L: int) -> dict:
    """Exact q-gram dense ranks for q = 4, 8, ..., L by prefix doubling:
    rank_q[i] identifies ``text[i:i+q]`` exactly; positions whose gram is
    truncated by the end get unique ids. Equal to ``lzss_jax.rank_tables``
    level by level."""
    r = text.to(_I32)
    r = _dense_rank(r, _shifted(r, 1))
    r = _dense_rank(r, _shifted(r, 2))
    ranks = {4: r}
    q = 4
    while q < L:
        r = _dense_rank(r, _shifted(r, q))
        ranks[2 * q] = r
        q *= 2
    return ranks


def _byte_words(text: torch.Tensor, pad: int) -> torch.Tensor:
    """int64 ``w[i]`` = the 8 bytes ``text[i:i+8]`` big-endian, the text
    zero-padded by ``pad`` bytes (so ``w`` has n + pad - 7 entries)."""
    n = text.numel()
    t = torch.zeros(n + pad, dtype=_I64, device=text.device)
    t[:n] = text
    m = n + pad - 7
    w = t[:m] << 56
    for k in range(1, 8):
        w |= t[k : k + m] << (56 - 8 * k)
    return w


def _lead_zero_bytes(x: torch.Tensor) -> torch.Tensor:
    """Leading zero bytes of the nonzero 64-bit words ``x`` (0..7)."""
    lead = torch.zeros_like(x)
    still = torch.ones_like(x, dtype=torch.bool)
    for k in range(7):
        still &= ((x >> (56 - 8 * k)) & 0xFF) == 0
        lead += still
    return lead


def _lcp_window(words: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                W: int) -> torch.Tensor:
    """Common prefix of the zero-padded text at byte ``a`` and at byte
    ``b``, capped at ``4 * W`` bytes: JAX's ``_window_settle`` of two
    ``_fetch_aligned_words`` windows of W 32-bit words."""
    span = 4 * W // 8
    lanes = torch.arange(span, dtype=torch.uint8, device=a.device)
    step = 8 * lanes.long()
    out = torch.empty_like(a)
    for lo in range(0, a.numel(), WINDOW_BLOCK):
        hi = lo + WINDOW_BLOCK
        wa = words[a[lo:hi, None] + step]
        wb = words[b[lo:hi, None] + step]
        # the first word that differs; span where none does
        first = torch.where(wa != wb, lanes, span).amin(1)
        at = first.clamp(max=span - 1).long()[:, None]
        x = (wa.gather(1, at) ^ wb.gather(1, at)).squeeze(1)
        out[lo:hi] = torch.where(first < span,
                                 8 * at.squeeze(1) + _lead_zero_bytes(x),
                                 4 * W)
    return out


def _settle(words, pos, cand, base, limit, W: int) -> torch.Tensor:
    """``base`` plus the window compare of ``text[pos + base:]`` with
    ``text[cand + base:]``, capped at ``limit``; 0 where ``cand < 0``."""
    n = pos.numel()
    cb = cand.clamp(0, n - 1)
    matched = _lcp_window(words, pos + base, cb + base, W)
    add = torch.minimum(matched, limit - base).clamp(min=0)
    return torch.where(cand >= 0, base + add, 0)


def _match_device(text: torch.Tensor, *, max_len: int):
    """text u8[n] -> (cand i32[n], length i32[n]).

    cand[i] = nearest previous position whose q-byte prefix equals
    text[i:i+q] for the largest q in LEVELS with any previous occurrence
    (-1 if none), or the second-nearest one where it extends further;
    length[i] = exact common prefix length of text[i:] and
    text[cand[i]:], capped at max_len and at n-1-i
    (``lzss_jax._match_device``)."""
    if max_len > 256:
        raise ValueError("device_fast caps matches at 256")
    n = text.numel()
    dev = text.device
    pos = torch.arange(n, dtype=_I64, device=dev)
    ranks = rank_tables(text, LEVELS[-1])
    none = torch.full((2,), -1, dtype=_I64, device=dev)
    cand = torch.full((n,), -1, dtype=_I64, device=dev)
    cand2 = torch.full((n,), -1, dtype=_I64, device=dev)
    base = torch.zeros(n, dtype=_I64, device=dev)
    for q in LEVELS:
        # equal q-grams adjacent, positions ascending: the previous
        # occurrences are the sort predecessors
        srq, spos = torch.sort(ranks[q], stable=True)
        r_prev = torch.cat([none[:1].to(_I32), srq[:-1]])
        r_prev2 = torch.cat([none.to(_I32), srq[:-2]])[:n]
        p_prev = torch.cat([none[:1], spos[:-1]])
        p_prev2 = torch.cat([none, spos[:-2]])[:n]
        cq = torch.empty(n, dtype=_I64, device=dev)
        cq2 = torch.empty(n, dtype=_I64, device=dev)
        cq[spos] = torch.where(r_prev == srq, p_prev, -1)
        cq2[spos] = torch.where(r_prev2 == srq, p_prev2, -1)
        hit = cq >= 0
        cand = torch.where(hit, cq, cand)
        cand2 = torch.where(hit, cq2, cand2)
        base = torch.where(hit, q, base)
    limit = (n - 1 - pos).clamp(max=max_len)
    base = torch.minimum(torch.where(cand >= 0, base, 0), limit)
    words = _byte_words(text, 4 * 64 + 8)
    l1 = _settle(words, pos, cand, base, limit, 64)
    l2 = _settle(words, pos, cand2, base, limit, 64)
    take2 = l2 > l1
    return (torch.where(take2, cand2, cand).to(_I32),
            torch.where(take2, l2, l1).to(_I32))


def _min_table(A: torch.Tensor) -> list:
    """Sparse table of range minima: level k holds min(A[i : i + 2^k])
    for every i with i + 2^k <= m."""
    levels = [A]
    k = 1
    while 2 * k <= A.numel():
        prev = levels[-1]
        levels.append(torch.minimum(prev[:-k], prev[k:]))
        k *= 2
    return levels


def _psv_from_table(A: torch.Tensor, table: list):
    """Nearest smaller value on the left: (slot, value), -1 if none.
    Binary lifting: from p = j, step left over a block of 2^k while its
    minimum exceeds A[j], largest blocks first."""
    m = A.numel()
    p = torch.arange(m, dtype=_I64, device=A.device)
    for k in range(len(table) - 1, -1, -1):
        c = p - (1 << k)
        blk = table[k][c.clamp(0, table[k].numel() - 1)]
        p = torch.where((c >= 0) & (blk > A), c, p)
    slot = p - 1
    val = torch.where(slot >= 0, A[slot.clamp(min=0)], -1)
    return slot.to(_I32), val.to(_I32)


def _nsv_from_table(A: torch.Tensor, table: list):
    """Nearest smaller value on the right: (slot, value), -1 if none."""
    m = A.numel()
    p = torch.arange(1, m + 1, dtype=_I64, device=A.device)
    for k in range(len(table) - 1, -1, -1):
        ok = p + (1 << k) <= m
        blk = table[k][p.clamp(max=table[k].numel() - 1)]
        p = torch.where(ok & (blk > A), p + (1 << k), p)
    found = p < m
    slot = torch.where(found, p, -1)
    val = torch.where(found, A[p.clamp(max=m - 1)], -1)
    return slot.to(_I32), val.to(_I32)


def _psv_smaller(A: torch.Tensor):
    """All-nearest-smaller-values: for each index ``j`` of ``A`` (distinct
    values), the nearest ``j' < j`` with ``A[j'] < A[j]``, returned as
    ``(slot, value)`` = (j', A[j']), both -1 if none
    (``lzss_jax._psv_smaller``)."""
    return _psv_from_table(A, _min_table(A))


def _nsv_smaller(A: torch.Tensor):
    """The mirror of ``_psv_smaller``: the nearest ``j' > j`` with
    ``A[j'] < A[j]``."""
    return _nsv_from_table(A, _min_table(A))


def _refine_exact(words, pos, cand, l0, limit, ranks, L: int):
    """Exact lcp(text[pos:], text[cand:]) given the level floor ``l0``
    (true lcp in [l0, 2*l0)): rank probes at q = L/4 .. 256 bring the
    residual under 256, then one window compare settles it
    (``lzss_jax._refine_exact``)."""
    n = pos.numel()
    has = cand >= 0
    length = torch.minimum(torch.where(has, l0, 0), limit)
    cb = cand.clamp(0, n - 1)
    q = L // 4
    while q >= 256:
        rq = ranks[q]
        a = pos + length
        b = cb + length
        ok = (has & (a <= n - q) & (b <= n - q)
              & (rq[a.clamp(0, n - 1)] == rq[b.clamp(0, n - 1)])
              & (length + q <= limit))
        length = torch.where(ok, length + q, length)
        q //= 2
    return _settle(words, pos, cand, length, limit, max(16, min(64, L // 8)))


def _match_exact_device(text: torch.Tensor, *, max_len: int,
                        info: dict | None = None):
    """Exact longest-previous-factor matching (the classical SA+ANSV
    LZ77 formulation): for every position the longest match among all
    previous positions, capped at ``max_len``, with the candidate JAX's
    ``_match_exact_device`` picks (the reference PSV/NSV answer,
    ``LZSSLCPCompressor.hpp:60-115``):

    - the truncated suffix array and the q-gram rank levels of one
      doubling chain (``suffix_array_isa_ranks(full=False)``);
    - the nearest SA neighbour with a smaller text position on each side
      (``_psv_from_table``/``_nsv_from_table``);
    - per side the largest level q whose q-group holds both neighbours
      (the LCP floor);
    - the exact length from the floor (``_refine_exact``, or for
      L <= 512 one shared window compare where the larger floor wins).

    ``info``, if given, receives ``rounds``: the doubling rounds."""
    n = text.numel()
    dev = text.device
    pos = torch.arange(n, dtype=_I64, device=dev)
    L = 4
    while L < max_len:
        L *= 2
    sa, isa, ranks = suffix_array_isa_ranks(text, L=L, full=False,
                                            info=info)
    del isa
    table = _min_table(sa)
    psv, cu = _psv_from_table(sa, table)
    nsv, cd = _nsv_from_table(sa, table)
    del table
    sa = sa.long()
    psv, nsv = psv.long(), nsv.long()
    l_up = torch.zeros(n, dtype=_I64, device=dev)
    l_dn = torch.zeros(n, dtype=_I64, device=dev)
    for q in sorted(ranks):
        # rank levels are non-decreasing in SA order, so "same q-group
        # as the neighbour" is "same rank as the neighbour"
        r = ranks[q][sa]
        l_up = torch.where(
            (psv >= 0) & (r[psv.clamp(min=0)] == r), q, l_up)
        l_dn = torch.where(
            (nsv >= 0) & (r[nsv.clamp(min=0)] == r), q, l_dn)
    del psv, nsv

    def to_text(x):
        out = torch.empty(n, dtype=_I64, device=dev)
        out[sa] = x.long()
        return out

    cu, cd, lu, ld = to_text(cu), to_text(cd), to_text(l_up), to_text(l_dn)
    del sa, l_up, l_dn
    limit = (n - 1 - pos).clamp(max=max_len)
    W = max(16, min(64, L // 8))
    words = _byte_words(text, 4 * W + 8)
    if L > 512:
        # the rank probes differ per side: two full refines
        l1 = _refine_exact(words, pos, cu, lu, limit, ranks, L)
        l2 = _refine_exact(words, pos, cd, ld, limit, ranks, L)
        take2 = l2 > l1
        return (torch.where(take2, cd, cu).to(_I32),
                torch.where(take2, l2, l1).to(_I32))
    # the side with the strictly larger floor wins outright; on a floor
    # tie both start from the same base, and the NSV side wins only when
    # strictly longer
    hi_up = lu >= ld
    cand_hi = torch.where(hi_up, cu, cd)
    cand_lo = torch.where(hi_up, cd, cu)
    base = torch.minimum(
        torch.where(cand_hi >= 0, torch.maximum(lu, ld), 0), limit)
    l_hi = _settle(words, pos, cand_hi, base, limit, W)
    l_lo = _settle(words, pos, cand_lo, base, limit, W)
    tie_lo = (lu == ld) & (l_lo > l_hi)
    return (torch.where(tie_lo, cand_lo, cand_hi).to(_I32),
            torch.where(tie_lo, l_lo, l_hi).to(_I32))


def match_max_len(n: int, exact: bool, max_len: int | None = None) -> int:
    """The length cap ``factorize_device`` gives the matcher."""
    if max_len is None:
        max_len = 4096 if exact else 256
    return min(max_len, max(4, n - 1))


def factorize_device(text: np.ndarray, threshold: int,
                     max_len: int | None = None, exact: bool = True,
                     device="cuda"):
    """Greedy LZSS parse of ``text`` (numpy u8, sentinel-terminated)
    with the matching on ``device``. Returns (pos, src, len) int64
    arrays (``lzss_jax.factorize_device``).

    ``exact=True`` computes the true longest previous factor per position
    (capped at 4096); ``exact=False`` uses the q-gram class matcher (cap
    256)."""
    n = int(text.size)
    if n > 1 << 24:
        raise ValueError(
            "exact device matcher requires len(text) <= 2**24; "
            "use factorize_blocks_sharded or the host matcher"
        )
    if n < 4 or threshold < 1:
        return (np.zeros(0, np.int64),) * 3
    match = _match_exact_device if exact else _match_device
    t = torch.from_numpy(np.array(text, np.uint8)).to(device)
    cand, length = match(t, max_len=match_max_len(n, exact, max_len))
    return commit_walk(
        cand.cpu().numpy().astype(np.int64),
        length.cpu().numpy().astype(np.int64), threshold,
    )


def commit_walk(cand: np.ndarray, length: np.ndarray, threshold: int):
    """Host commit walk over factor starts only: jump to the next
    position with a usable match after each commit; one-step lazy
    matching (defer when the next position matches strictly longer,
    zstd-style). A copy of ``lzss_jax.commit_walk``."""
    n = int(length.size)
    length = np.where(length >= threshold, length, 0)
    starts = np.flatnonzero(length > 0)
    out_pos, out_src, out_len = [], [], []
    i = 0
    k = 0
    ns = starts.size
    while k < ns:
        s = starts[k]
        if s < i:
            k += 1
            continue
        if s + 1 < n and length[s + 1] > length[s] + 1:
            s += 1  # the deferred byte joins the preceding gap
        out_pos.append(s)
        out_src.append(cand[s])
        out_len.append(length[s])
        i = s + length[s]
        k = int(np.searchsorted(starts, i))
    return (
        np.asarray(out_pos, np.int64),
        np.asarray(out_src, np.int64),
        np.asarray(out_len, np.int64),
    )


def resolve_factors_device(literals: np.ndarray, fpos: np.ndarray,
                           fsrc: np.ndarray, flen: np.ndarray, n: int,
                           device="cuda", info: dict | None = None) -> bytes:
    """Device decode of a parsed factor stream (back-references only:
    every source starts below its factor's position, the invariant of
    the lzss_lcp wire format). ``n`` = output length
    (``lzss_jax.resolve_factors_device``).

    Per output position the dependency is a chain: position ``i`` inside
    factor ``(pos, src, len)`` takes its byte from ``src + (i - pos)``,
    strictly below ``i``, so ``ptr = ptr[ptr]`` squares every chain per
    round and all chains bottom out at literal positions in O(log depth)
    gathers. Literals land by rank: position ``i``'s byte is
    ``lit[cumsum(uncovered)[i] - 1]``. ``info`` receives ``rounds``."""
    if n == 0:
        return b""
    # a gather past the output would fault the device: the stream comes
    # from outside the program, so hold it to back-references first
    if ((fsrc < 0) | (fsrc >= fpos) | (fpos + flen > n)).any():
        raise ValueError("malformed factor stream: a factor is no "
                         "back-reference inside the output")
    dev = torch.device(device)
    lit = torch.zeros(max(n, literals.size), dtype=torch.uint8, device=dev)
    lit[: literals.size] = torch.from_numpy(
        np.ascontiguousarray(literals, np.uint8)).to(dev)
    fp = torch.from_numpy(np.ascontiguousarray(fpos, np.int64)).to(dev)
    fs = torch.from_numpy(np.ascontiguousarray(fsrc, np.int64)).to(dev)
    fl = torch.from_numpy(np.ascontiguousarray(flen, np.int64)).to(dev)
    i = torch.arange(n, dtype=_I64, device=dev)
    fidx = torch.searchsorted(fp, i, right=True) - 1
    safe = fidx.clamp(0, max(fp.numel() - 1, 0))
    if fp.numel():
        covered = (fidx >= 0) & (i < fp[safe] + fl[safe])
        ptr = torch.where(covered, i - fp[safe] + fs[safe], i)
    else:
        covered = torch.zeros(n, dtype=torch.bool, device=dev)
        ptr = i
    rank = torch.cumsum((~covered).to(_I64), 0) - 1
    rounds = 0
    while True:
        nxt = ptr[ptr]
        rounds += 1
        if torch.equal(nxt, ptr):
            break
        ptr = nxt
    if info is not None:
        info["rounds"] = rounds
    return lit[rank[ptr].clamp(0, n - 1)].cpu().numpy().tobytes()
