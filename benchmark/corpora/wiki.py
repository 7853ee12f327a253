"""Wiki-markup text shaped like enwik8, made from a seed.

enwik8 is the first 10^8 bytes of an English Wikipedia XML dump (the
Large Text Compression Benchmark's file). None of its bytes are in the
repository, so this module makes pages of the same kind: an XML page
frame (``<page>``, ``<title>``, ``<id>``, ``<revision>``, ``<text>``)
around a body of Zipf-distributed words with links (``[[...]]``), bold
(``'''...'''``), section headings (``== ... ==``), commas, full stops,
paragraphs and a few ``[[Category:...]]`` lines at the end of a page.

Every word is four piece slots (prefix, word, suffix, separator) that
index one table of byte strings, and the bytes are one gather: a few
large tensor operations on the generator's device. ``params`` are the
configuration's ``corpus`` entry.
"""

from __future__ import annotations

import math

import torch

#: English letter frequencies (per cent), in the order of ``_LETTERS``
_LETTERS = b"etaoinshrdlcumwfgypbvkjxqz"
_LETTER_FREQ = [
    12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8, 2.8,
    2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.15, 0.15, 0.1, 0.07,
]

_MARKUP = [
    b"",                                            # empty slot
    b" ", b", ", b". ", b".\n\n",                   # separators
    b"[[", b"]]", b"'''", b"\n== ", b" ==\n",       # body markup
    b"  <page>\n    <title>",                       # page open
    b"</title>\n    <id>",                          # title close
    b"</id>\n    <revision>\n      <text xml:space=\"preserve\">",
    b"\n[[Category:",
    b"\n</text>\n    </revision>\n  </page>\n",     # page close
]
(_EMPTY, _SP, _COMMA, _STOP, _PARA, _LINK_O, _LINK_C, _BOLD, _HEAD_O,
 _HEAD_C, _PAGE_O, _TITLE_C, _ID_C, _CAT_O, _PAGE_C) = range(len(_MARKUP))

_I64 = torch.int64


def _bytes(b: bytes, device) -> torch.Tensor:
    return torch.tensor(list(b), dtype=torch.uint8, device=device)


def _cdf(weights: torch.Tensor) -> torch.Tensor:
    cdf = torch.cumsum(weights.to(torch.float64), 0)
    cdf /= cdf[-1].clone()
    return cdf


def _draw(cdf: torch.Tensor, count: int, gen) -> torch.Tensor:
    """``count`` indices drawn from the distribution whose cumulative
    sums are ``cdf`` (float64, last entry 1), by inversion."""
    u = torch.rand(count, generator=gen, dtype=torch.float64,
                   device=cdf.device)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)


def _table(gen, params, device):
    """The byte table: the vocabulary, its capitalised copy, page ids,
    then ``_MARKUP``. Returns ``(pool u8[], start i64[], length i64[],
    base)``; ``base`` maps ``"word"``, ``"cap"``, ``"id"``, ``"markup"``
    to the first piece id of each part."""
    v = int(params["vocabulary"])
    # word lengths: 1 + Poisson, shorter words at the frequent ranks
    rate = torch.full((v,), float(params["word_length_mean"]) - 1.0,
                      dtype=torch.float64, device=device)
    lens = (1 + torch.poisson(rate, generator=gen)).clamp_(1, 20).to(_I64)
    noise = torch.randn(v, generator=gen, dtype=torch.float64,
                        device=device)
    order = torch.sort(lens + float(params["word_length_noise"]) * noise,
                       stable=True).indices
    lens = lens[order]
    freq = torch.tensor(_LETTER_FREQ, dtype=torch.float64, device=device)
    letters = _bytes(_LETTERS, device)[
        _draw(_cdf(freq), int(lens.sum()), gen)]
    caps = letters.clone()
    caps[torch.cumsum(lens, 0) - lens] -= 32  # first letter upper case
    n_ids = int(params["page_ids"])
    id_lens = torch.randint(3, 8, (n_ids,), generator=gen, device=device)
    digits = (torch.randint(0, 10, (int(id_lens.sum()),), generator=gen,
                            device=device) + 48).to(torch.uint8)
    markup = _bytes(b"".join(_MARKUP), device)
    mk_lens = torch.tensor([len(m) for m in _MARKUP], dtype=_I64,
                           device=device)
    pool = torch.cat([letters, caps, digits, markup])
    length = torch.cat([lens, lens, id_lens.to(_I64), mk_lens])
    start = torch.cumsum(length, 0) - length
    base = {"word": 0, "cap": v, "id": 2 * v, "markup": 2 * v + n_ids}
    return pool, start, length, base


def _slots(gen, words: int, params, base, zipf_cdf) -> torch.Tensor:
    """Piece ids ``i64[words, 4]``: prefix, word, suffix, separator."""
    device = zipf_cdf.device

    def rand():
        return torch.rand(words, generator=gen, dtype=torch.float64,
                          device=device)

    ranks = _draw(zipf_cdf, words, gen)
    cap = rand() < params["capitalized"]
    word = torch.where(cap, base["cap"], base["word"]) + ranks
    u = rand()
    pre = torch.full((words,), _EMPTY, dtype=_I64, device=device)
    suf = pre.clone()
    p_link, p_bold = params["link"], params["bold"]
    link = u < p_link
    bold = (u >= p_link) & (u < p_link + p_bold)
    head = (u >= p_link + p_bold) & (u < p_link + p_bold + params["heading"])
    pre[link], suf[link] = _LINK_O, _LINK_C
    pre[bold], suf[bold] = _BOLD, _BOLD
    pre[head], suf[head] = _HEAD_O, _HEAD_C
    w = rand()
    sep = torch.full((words,), _SP, dtype=_I64, device=device)
    c1 = params["comma"]
    c2 = c1 + params["stop"]
    c3 = c2 + params["paragraph"]
    sep[w < c3] = _PARA
    sep[w < c2] = _STOP
    sep[w < c1] = _COMMA
    sep[head] = _EMPTY
    # pages: lognormal lengths in words, at least the frame's words
    cats = int(params["categories"])
    mean = float(params["page_words_mean"])
    sigma = float(params["page_words_sigma"])
    n_pages = words // (cats + 4) + 1
    plen = torch.empty(n_pages, dtype=torch.float64, device=device)
    plen.log_normal_(math.log(mean) - sigma * sigma / 2, sigma,
                     generator=gen)
    plen = plen.clamp_(min=cats + 4, max=words).to(_I64)
    first = torch.cumsum(plen, 0) - plen
    inside = first < words
    first, plen = first[inside], plen[inside]
    last = torch.clamp(first + plen, max=words) - 1
    title, pid = first, first + 1
    pid = pid[pid < words]
    pre[title], suf[title], sep[title] = _PAGE_O, _TITLE_C, _EMPTY
    word[title] = base["cap"] + ranks[title]
    word[pid] = base["id"] + torch.randint(
        0, int(params["page_ids"]), (pid.numel(),), generator=gen,
        device=device)
    pre[pid], suf[pid], sep[pid] = _EMPTY, _ID_C, _EMPTY
    for k in range(cats):  # the page's last words are its categories
        at = last - k
        at = at[at > first + 1]
        pre[at], suf[at], sep[at] = _CAT_O, _LINK_C, _EMPTY
        word[at] = base["cap"] + ranks[at]
    sep[last] = _PAGE_C
    mk = base["markup"]
    return torch.stack([pre + mk, word, suf + mk, sep + mk], dim=1)


def generate(gen: torch.Generator, size: int, params) -> torch.Tensor:
    """``size`` bytes (u8, on ``gen``'s device) of wiki-markup pages."""
    device = gen.device
    pool, start, length, base = _table(gen, params, device)
    v = int(params["vocabulary"])
    zipf_cdf = _cdf(1.0 / torch.arange(1, v + 1, dtype=torch.float64,
                                       device=device)
                    ** float(params["zipf_s"]))
    # a body word's expected bytes (the page frames only add to them)
    p = torch.diff(zipf_cdf, prepend=zipf_cdf.new_zeros(1))
    per_word = float(p @ length[:v].to(torch.float64)) + 1.0
    ids, lens, have = [], [], 0
    while have < size:
        words = int((size - have) / per_word) + 1024
        part = _slots(gen, words, params, base, zipf_cdf).reshape(-1)
        ids.append(part)
        lens.append(length[part])
        have += int(lens[-1].sum())
    ids, lens = torch.cat(ids), torch.cat(lens)
    ends = torch.cumsum(lens, 0)
    keep = int(torch.searchsorted(ends, size)) + 1
    ids, lens, ends = ids[:keep], lens[:keep], ends[:keep]
    # out[j] = pool[start[piece(j)] + j - out_start(piece(j))]
    shift = torch.repeat_interleave(start[ids] - (ends - lens), lens)
    src = shift[:size] + torch.arange(size, dtype=_I64, device=device)
    return pool[src]
