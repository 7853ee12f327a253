"""Static low-entropy (SLE) coder (Dinklage 2015).

Copy of ``tudocomp_tpu/coders/sle.py``: a consuming coder that ranks
k-mers (3-grams) and single literals by frequency, stores a table of the
top entries, and escape-codes everything else. Same format and bytes:

- header: compressed_int(num_kmers), then per k-mer its k=3 bytes;
  compressed_int(num_lits), then each literal byte. Entries are ordered by
  descending frequency (ties by value) — entry index IS the rank.
- literal stream: greedily at each position, if the next 3 literals match a
  table k-mer, emit 1-bit flag 1 + gamma(rank); else flag 0, then 1-bit
  flag 1 + gamma(lit-rank) if the literal is ranked, else flag 0 + 8-bit
  raw byte.
- non-literal ranges fall back to range-optimal binary.

The encoder buffers literals until a non-literal value or ``finish``
flushes them. The rank tables come from numpy up to 4096 literals and
from the port's host library (``csrc/host/sle.cpp``) above; a flush of
more than 64 pending literals runs the library's matcher, a shorter one
the scalar loop. Each pair of paths writes the same bytes.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.coders import base
from tudocomp_tpu_torch.meta import Algorithm, Meta
from tudocomp_tpu_torch.ranges import LiteralRange, Range, literal_r

K = 3
MAX_KMERS = 255
MAX_LITS = 255


def _rank_tables(chars: np.ndarray):
    """Top k-mer and literal ranking from the literal pre-pass: by
    descending count, ties by value; the host library's above 4096
    literals, numpy's below."""
    if chars.size > 4096:
        keys, lit_arr = native.sle_rank(chars, K, MAX_KMERS, MAX_LITS)
        return (
            [int(k).to_bytes(K, "big") for k in keys.tolist()],
            lit_arr.tolist(),
        )
    return _numpy_rank_tables(chars)


def _numpy_rank_tables(chars: np.ndarray):
    """``_rank_tables`` in numpy (the Counter-based spec's order)."""
    kmers: list[bytes] = []
    if chars.size >= K:
        win = np.lib.stride_tricks.sliding_window_view(chars, K)
        keys = win.astype(np.int64) @ (256 ** np.arange(K - 1, -1, -1))
        uniq, counts = np.unique(keys, return_counts=True)
        order = np.lexsort((uniq, -counts))[:MAX_KMERS]
        kmers = [
            int(uniq[i]).to_bytes(K, "big")
            for i in order
            if counts[i] > 1
        ]
    lit_counts = np.bincount(chars, minlength=256)
    present = np.flatnonzero(lit_counts)
    order = np.lexsort((present, -lit_counts[present]))[:MAX_LITS]
    lits = [int(present[i]) for i in order]
    return kmers, lits


class SLECoder(Algorithm):
    is_consuming = True

    @classmethod
    def meta(cls):
        return Meta("coder", "sle", "Static low-entropy encoding").\
            option_dynamic("kmer", K)

    class Encoder(base.Encoder):
        is_consuming = True

        def __init__(self, env, out, literals):
            super().__init__(env, out, literals)
            self.kmers, self.lits = _rank_tables(literals.chars)
            self.kmer_rank = {km: i for i, km in enumerate(self.kmers)}
            self.lit_rank = {l: i for i, l in enumerate(self.lits)}
            # host matcher tables: kmer keys sorted ascending + the
            # rank of each sorted key; literal ranks as int32[256]
            keys = np.array(
                [int.from_bytes(km, "big") for km in self.kmers],
                np.int64,
            )
            order = np.argsort(keys, kind="stable")
            self._sorted_keys = np.ascontiguousarray(keys[order])
            self._key_rank = np.ascontiguousarray(order.astype(np.int64))
            self._lit_rank32 = np.full(256, -1, np.int32)
            for l, i in self.lit_rank.items():
                self._lit_rank32[l] = i
            out.write_compressed_int(len(self.kmers))
            for km in self.kmers:
                for b in km:
                    out.write_int(b, 8)
            out.write_compressed_int(len(self.lits))
            for l in self.lits:
                out.write_int(l, 8)
            # pending buffer for k-mer matching across encode calls
            self._pending: list[int] = []

        def _flush_pending(self, final: bool) -> None:
            buf = self._pending
            limit = len(buf) if final else len(buf) - (K - 1)
            if limit <= 0:
                return
            if limit > 64:
                i = self._native_tokens(np.asarray(buf, np.uint8), limit)
                del buf[:i]
                return
            i = 0
            while i < limit:
                km = bytes(buf[i : i + K])
                rank = self.kmer_rank.get(km) if len(km) == K else None
                if rank is not None:
                    self.out.write_bit(1)
                    self.out.write_elias_gamma(rank)
                    i += K
                else:
                    self.out.write_bit(0)
                    lr = self.lit_rank.get(buf[i])
                    if lr is not None:
                        self.out.write_bit(1)
                        self.out.write_elias_gamma(lr)
                    else:
                        self.out.write_bit(0)
                        self.out.write_int(buf[i], 8)
                    i += 1
            del buf[:i]

        def _native_tokens(self, buf: np.ndarray, limit: int) -> int:
            """Emit SLE tokens for the emissions of ``buf`` that start
            below ``limit`` by the host matcher; returns the consumed
            count. Bit-identical to the scalar loop."""
            consumed, values, lens = native.sle_run_tokens(
                buf, limit, self._sorted_keys, self._key_rank, K,
                self._lit_rank32,
            )
            if lens.size:
                self.out.write_tokens(values, lens)
            return consumed

        def encode(self, v, r: Range) -> None:
            if isinstance(r, LiteralRange):
                self._pending.append(int(v) & 0xFF)
                if len(self._pending) >= 4 * K:
                    self._flush_pending(final=False)
            else:
                self._flush_pending(final=True)
                super().encode(v, r)

        def encode_array(self, values, r: Range) -> None:
            if isinstance(r, LiteralRange):
                arr = np.asarray(values, np.uint8)
                if not self._pending and arr.size > 64:
                    # straight off the array (no list roundtrip); the
                    # un-consumed tail (< K bytes) stays pending
                    consumed = self._native_tokens(arr, arr.size - (K - 1))
                    self._pending.extend(arr[consumed:].tolist())
                    return
                self._pending.extend(arr.tolist())
                self._flush_pending(final=False)
            else:
                self._flush_pending(final=True)
                super().encode_array(values, r)

        def finish(self) -> None:
            self._flush_pending(final=True)

    class Decoder(base.Decoder):
        is_consuming = True

        def __init__(self, env, inp):
            super().__init__(env, inp)
            n_kmers = inp.read_compressed_int()
            self.kmers = [
                bytes(inp.read_int(8) for _ in range(K))
                for _ in range(n_kmers)
            ]
            n_lits = inp.read_compressed_int()
            self.lits = [inp.read_int(8) for _ in range(n_lits)]
            self.buffer: list[int] = []

        def eof(self) -> bool:
            return not self.buffer and self.inp.eof()

        def decode(self, r: Range) -> int:
            if not isinstance(r, LiteralRange):
                if self.buffer:
                    raise ValueError(
                        "sle: interleaved decode with buffered k-mer tail"
                    )
                return super().decode(r)
            if self.buffer:
                return self.buffer.pop(0)
            if self.inp.read_bit():
                km = self.kmers[self.inp.read_elias_gamma()]
                self.buffer = list(km[1:])
                return km[0]
            if self.inp.read_bit():
                return self.lits[self.inp.read_elias_gamma()]
            return self.inp.read_int(8)

        def decode_array(self, r: Range, count: int) -> np.ndarray:
            return np.array(
                [self.decode(r) for _ in range(count)], np.uint64
            )

        def decode_remaining_literals(self) -> bytes:
            """Whole-stream literal decode by the host library, or symbol
            by symbol while a k-mer tail is buffered."""
            if self.buffer:
                out = bytearray()
                while not self.eof():
                    out.append(self.decode(literal_r))
                return bytes(out)
            rd = self.inp
            got = native.sle_decode(
                np.packbits(rd._bits), rd.total, rd.pos,
                b"".join(self.kmers), len(self.kmers), K,
                bytes(self.lits),
            )
            rd.pos = rd.total
            return got
