"""Suffix array, ISA and BWT on the device by prefix doubling.

Counterpart of ``tudocomp_tpu/ops/suffix_jax.py``, with the same results
and not the same formulation. The JAX functions write every permutation
as a co-sort because gathers and scatters are serialised on a TPU; on a
GPU both are cheap, so here:

- one doubling round is one stable ``torch.sort`` of a single int64 key,
  ``rank * (n + 1) + (rank[i + k] + 1)`` (``-1`` past the end), which
  orders the pairs as the JAX two-key sort does for any n < 2^31, then a
  scatter of the new dense ranks back to text order;
- the ISA is a scatter, the BWT a scatter of the text to
  ``isa[(j + 1) mod n]``, and the inverse BWT keeps the JAX orbit
  doubling with gathers (the LF walk itself is serial).

Every rank equals JAX's round by round, so ``suffix_array_isa_ranks``
returns the same rank levels and the same truncated order. Each round
ends with one device-to-host read of the largest rank (has every suffix
got its own rank yet?). These are library calls, as ``lax.sort`` is in
the JAX package: no Pallas kernel stands behind them there.

Each function runs on the device of its input tensor; results are int32
(u8 for the BWT), as in the JAX package.
"""

from __future__ import annotations

import torch

from tudocomp_tpu_torch.stats import StatPhase

_I32 = torch.int32
_I64 = torch.int64


def _densify(key: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Dense ranks (0, 1, ...) of ``key`` in text order, and the largest
    rank. Equal keys get equal ranks."""
    n = key.numel()
    s, order = torch.sort(key, stable=True)
    step = torch.zeros(n, dtype=_I32, device=key.device)
    step[1:] = s[1:] != s[:-1]
    dense = torch.cumsum(step, 0, dtype=_I32)
    rank = torch.empty(n, dtype=_I32, device=key.device)
    rank[order] = dense
    return rank, int(dense[-1])


def _shifted(rank: torch.Tensor, k: int) -> torch.Tensor:
    """``rank[i + k]``, ``-1`` past the end."""
    n = rank.numel()
    out = torch.full((n,), -1, dtype=_I32, device=rank.device)
    if k < n:
        out[: n - k] = rank[k:]
    return out


def _double(rank: torch.Tensor, k: int) -> tuple[torch.Tensor, int]:
    """One doubling round: dense ranks of the pairs (rank[i], rank[i+k])."""
    n = rank.numel()
    key = rank.to(_I64) * (n + 1) + (_shifted(rank, k).to(_I64) + 1)
    return _densify(key)


def _invert(perm: torch.Tensor) -> torch.Tensor:
    """Inverse of the permutation ``perm`` (a scatter)."""
    n = perm.numel()
    inv = torch.empty(n, dtype=_I32, device=perm.device)
    inv[perm.to(_I64)] = torch.arange(n, dtype=_I32, device=perm.device)
    return inv


def _check_text(text: torch.Tensor) -> int:
    if text.dtype != torch.uint8 or text.dim() != 1:
        raise ValueError(f"text: want u8[N], got {text.dtype}{list(text.shape)}")
    n = text.numel()
    if not 1 <= n < (1 << 31):
        raise ValueError(f"text length {n} outside [1, 2^31)")
    return n


def _finish(rank, top: int, k: int, n: int, info) -> tuple[torch.Tensor, int]:
    """Double from gap ``k`` until every rank is distinct (JAX's
    ``while_loop``: ``max(rank) < n - 1`` and ``k < 2n``); counts the
    rounds into ``info["rounds"]``. Each round is a ``suffix.round``
    phase with its gap ``k`` and the distinct ranks after it."""
    while top < n - 1 and k < 2 * n:
        with StatPhase("suffix.round") as phase:
            rank, top = _double(rank, k)
            phase.log_stat("k", k)
            phase.log_stat("ranks", top + 1)
        k *= 2
        if info is not None:
            info["rounds"] += 1
    return rank, top


def suffix_array_device(text: torch.Tensor, info: dict | None = None):
    """SA of ``text`` (u8[N], N >= 1) as i32[N]. ``info``, if given,
    receives ``rounds``: the doubling rounds after the byte ranks."""
    n = _check_text(text)
    if info is not None:
        info["rounds"] = 0
    rank, top = _densify(text.to(_I64))
    rank, _ = _finish(rank, top, 1, n, info)
    return _invert(rank)


def suffix_array_isa_ranks(text: torch.Tensor, *, L: int, full: bool = True,
                           info: dict | None = None):
    """``(sa, isa, {q: rank_q for q = 4, 8, ..., L})`` in one doubling
    chain, as ``suffix_jax.suffix_array_isa_ranks``: rank_q are the dense
    q-gram classes of the first log2(L) rounds (run whether or not the
    ranks are already distinct). ``full=False`` stops there and orders
    equal-L-gram groups by position (the truncated suffix array);
    ``full=True`` doubles on to the true SA, whose final ranks are the
    ISA. ``info`` receives ``rounds`` (after the byte ranks)."""
    n = _check_text(text)
    rank, top = _densify(text.to(_I64))
    ranks = {}
    rounds = 0
    k = 1
    while 2 * k <= L:
        rank, top = _double(rank, min(k, n))
        rounds += 1
        k *= 2
        if k >= 4:
            ranks[k] = rank
    if info is not None:
        info["rounds"] = rounds
    if not full:
        # (rank_L, position) order: a stable sort of the ranks
        sa = torch.sort(rank, stable=True).indices.to(_I32)
        return sa, _invert(sa), ranks
    rank, _ = _finish(rank, top, k, n, info)
    return _invert(rank), rank, ranks


def isa_device(sa: torch.Tensor) -> torch.Tensor:
    """Inverse suffix array: a scatter."""
    return _invert(sa)


def bwt_device(text: torch.Tensor, isa: torch.Tensor) -> torch.Tensor:
    """``bwt[i] = text[(sa[i] - 1) mod n]``: ``text[j]`` lands at
    ``isa[(j + 1) mod n]``, a scatter."""
    bwt = torch.empty_like(text)
    bwt[torch.roll(isa, -1).to(_I64)] = text
    return bwt


def unbwt_device(bwt: torch.Tensor, info: dict | None = None
                 ) -> torch.Tensor:
    """Inverse BWT of a 0-sentineled text's transform (u8[n] -> u8[n-1],
    sentinel stripped). LF is the inverse of the BWT's stable argsort;
    the walk's orbit ``t_k = LF^k(0)`` fills in ceil(log2 n) rounds of
    gathers, ``t[k + m] = LF^m(t[k])``, squaring ``LF^m`` between them.
    Equal to the host LF walk byte for byte. ``info``, if given,
    receives ``rounds``: the rounds of gathers."""
    n = bwt.numel()
    order = torch.sort(bwt, stable=True).indices
    lf = torch.empty(n, dtype=_I64, device=bwt.device)
    lf[order] = torch.arange(n, dtype=_I64, device=bwt.device)
    orbit = torch.zeros(n, dtype=_I64, device=bwt.device)  # t_0 = 0
    power = lf  # lf^m
    m = 1
    rounds = 0
    while m < n - 1:
        take = min(m, n - 1 - m)
        orbit[m : m + take] = power[orbit[:take]]
        m *= 2
        rounds += 1
        if m < n - 1:
            power = power[power]
    if info is not None:
        info["rounds"] = rounds
    # host walk: out[n-1-j] = bwt[t_{j-1}] for j = 1..n-1
    return bwt[orbit[: n - 1]].flip(0)
