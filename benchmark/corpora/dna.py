"""DNA shaped like Pizza&Chili's ``dna`` collection, made from a seed.

The collection is bare genome sequence: an ACGT stream, runs of ``N``
(unsequenced stretches), rarer IUPAC ambiguity codes, and the repeats a
genome holds. None of its bytes are in the repository, so this module
makes such a stream: novel stretches drawn i.i.d. from the base
frequencies alternate with copies of earlier novel stretches that carry
point mutations (so the BWT has runs to find), then ``N`` runs and rare
symbols are laid over it. ``params`` are the configuration's ``corpus``
entry. A few large tensor operations on the generator's device.
"""

from __future__ import annotations

import math

import torch

_I64 = torch.int64


def _lognormal(gen, count, median, sigma, lo, hi, device):
    x = torch.empty(count, dtype=torch.float64, device=device)
    x.log_normal_(math.log(median), sigma, generator=gen)
    return x.clamp_(lo, hi).to(_I64)


def _pick(gen, symbols: bytes, weights, count: int, device):
    """``count`` symbols (u8) drawn with ``weights``, by inversion."""
    cdf = torch.cumsum(torch.tensor(weights, dtype=torch.float64,
                                    device=device), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(count, generator=gen, dtype=torch.float64, device=device)
    at = torch.searchsorted(cdf, u, right=True).clamp_(max=len(symbols) - 1)
    return torch.tensor(list(symbols), dtype=torch.uint8, device=device)[at]


def generate(gen: torch.Generator, size: int, params) -> torch.Tensor:
    """``size`` bytes (u8, on ``gen``'s device) of DNA."""
    device = gen.device
    freq = [float(f) for f in params["base_freq"]]
    share = float(params["repeat_share"])
    r_med = float(params["repeat_len_median"])
    r_sig = float(params["repeat_len_sigma"])
    r_max = int(params["repeat_len_max"])
    # novel stretches sized so that copies make ``share`` of the bytes
    r_mean = r_med * math.exp(r_sig * r_sig / 2)
    n_med = r_med * (1 - share) / share
    pairs = int(size / (r_mean / share)) * 2 + 16
    novel = _lognormal(gen, pairs, n_med, r_sig, 1, 16 * r_max, device)
    rep = _lognormal(gen, pairs, r_med, r_sig, 1, r_max, device)
    novel_end = torch.cumsum(novel, 0)
    # a copy's source lies in the novel bytes made before it
    rep = torch.minimum(rep, novel_end)
    u = torch.rand(pairs, generator=gen, dtype=torch.float64, device=device)
    src = (u * (novel_end - rep + 1)).to(_I64)
    lens = torch.stack([novel, rep], dim=1).reshape(-1)
    from_ = torch.stack([novel_end - novel, src], dim=1).reshape(-1)
    out_end = torch.cumsum(lens, 0)
    keep = int(torch.searchsorted(out_end, size)) + 1
    lens, from_, out_end = lens[:keep], from_[:keep], out_end[:keep]
    base = _pick(gen, b"ACGT", freq, int(novel_end[(keep + 1) // 2 - 1]),
                 device)
    index = (torch.repeat_interleave(from_ - (out_end - lens), lens)[:size]
             + torch.arange(size, dtype=_I64, device=device))
    out = base[index]
    del index
    # point mutations inside the copies
    copied = torch.repeat_interleave(
        torch.arange(keep, device=device) % 2 == 1, lens)[:size]
    hit = torch.nonzero(copied & (torch.rand(
        size, generator=gen, device=device) < params["mutation_rate"]))[:, 0]
    out[hit] = _pick(gen, b"ACGT", freq, hit.numel(), device)
    # runs of N, laid by a cumulative sum of +1 at starts, -1 at ends
    n_med = float(params["n_run_len_median"])
    n_sig = float(params["n_run_len_sigma"])
    n_runs = int(size * params["n_share"]
                 / (n_med * math.exp(n_sig * n_sig / 2))) + 1
    n_lens = _lognormal(gen, n_runs, n_med, n_sig, 1, size // 64, device)
    n_at = (torch.rand(n_runs, generator=gen, dtype=torch.float64,
                       device=device) * (size - n_lens + 1)).to(_I64)
    edge = torch.zeros(size + 1, dtype=torch.int32, device=device)
    edge.index_add_(0, n_at, torch.ones_like(n_at, dtype=torch.int32))
    edge.index_add_(0, n_at + n_lens,
                    torch.full_like(n_at, -1, dtype=torch.int32))
    out[torch.cumsum(edge[:size], 0) > 0] = ord("N")
    # rare ambiguity codes
    hit = torch.nonzero(torch.rand(size, generator=gen, device=device)
                        < params["rare_rate"])[:, 0]
    rare = params["rare_symbols"].encode()
    out[hit] = _pick(gen, rare, [1.0] * len(rare), hit.numel(), device)
    return out
