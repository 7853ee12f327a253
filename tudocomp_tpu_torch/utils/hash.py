"""Hash-table framework: hashers, size managers, probers, and an
open-addressing map.

The port's copy of ``tudocomp_tpu/utils/hash.py``. Importing it
registers the strategies with the port's registry; the port's
``compressors`` package imports it, so ``-l`` lists them whatever has
run.

Re-design of the reference's ``util/Hash.hpp:13-354``: the hash function,
table-size policy, and probe sequence are independently selectable
registered strategies, composed into :class:`HashMap`. Consumers:
the LZ78 trie family (``compressors/lz78_trie.py``) and the ESP
``ipd`` pair dictionaries (``compressors/esp.py``).

The mixers are the public-domain splitmix64 finalizer (Vigna),
Knuth's multiplicative hash, and the 64-bit mix from Thomas Wang —
the same functions the reference names vigna/knuth/mixer.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu_torch.meta import Algorithm, Meta
from tudocomp_tpu_torch.registry import REGISTRY

_M64 = (1 << 64) - 1


class VignaHasher(Algorithm):
    """splitmix64 finalizer (reference ``util/Hash.hpp:13-24``)."""

    @classmethod
    def meta(cls):
        return Meta("hash_function", "vigna", "Vigna's splitmix hasher")

    def hash(self, x: int) -> int:
        x &= _M64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
        return x ^ (x >> 31)

    def hash_arr(self, x: np.ndarray) -> np.ndarray:
        x = x.astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


class KnuthHasher(Algorithm):
    """Multiplicative hash (reference ``util/Hash.hpp:35-46``)."""

    @classmethod
    def meta(cls):
        return Meta("hash_function", "knuth", "Knuth multiplicative hash")

    def hash(self, x: int) -> int:
        return (x * 2654435769) & _M64

    def hash_arr(self, x: np.ndarray) -> np.ndarray:
        return x.astype(np.uint64) * np.uint64(2654435769)


class MixHasher(Algorithm):
    """Thomas Wang's 64-bit mix (reference ``util/Hash.hpp:48-63``)."""

    @classmethod
    def meta(cls):
        return Meta("hash_function", "mixer", "64-bit mix hasher")

    def hash(self, x: int) -> int:
        x &= _M64
        x = ((~x & _M64) + ((x << 21) & _M64)) & _M64
        x ^= x >> 24
        x = (x + ((x << 3) & _M64) + ((x << 8) & _M64)) & _M64
        x ^= x >> 14
        x = (x + ((x << 2) & _M64) + ((x << 4) & _M64)) & _M64
        x ^= x >> 28
        return (x + ((x << 31) & _M64)) & _M64

    def hash_arr(self, x: np.ndarray) -> np.ndarray:
        x = x.astype(np.uint64)
        x = (~x) + (x << np.uint64(21))
        x = x ^ (x >> np.uint64(24))
        x = x + (x << np.uint64(3)) + (x << np.uint64(8))
        x = x ^ (x >> np.uint64(14))
        x = x + (x << np.uint64(2)) + (x << np.uint64(4))
        x = x ^ (x >> np.uint64(28))
        return x + (x << np.uint64(31))


class NoopHasher(Algorithm):
    @classmethod
    def meta(cls):
        return Meta("hash_function", "noop", "Identity hash")

    def hash(self, x: int) -> int:
        return x & _M64

    def hash_arr(self, x: np.ndarray) -> np.ndarray:
        return x.astype(np.uint64)


class SizeManagerPow2(Algorithm):
    """Power-of-two sizes, mask reduction (``util/Hash.hpp:80-103``)."""

    @classmethod
    def meta(cls):
        return Meta("hash_manager", "pow", "Pow2 table sizes")

    def initial(self) -> int:
        return 1 << 4

    def grow(self, m: int) -> int:
        return m * 2

    def index(self, h: int, m: int) -> int:
        return h & (m - 1)


class SizeManagerPrime(Algorithm):
    """Prime sizes, modulo reduction (``util/Hash.hpp:158-180``)."""

    PRIMES = [
        17, 37, 79, 163, 331, 673, 1361, 2729, 5471, 10949, 21911,
        43853, 87719, 175447, 350899, 701819, 1403641, 2807303,
        5614657, 11229331, 22458671, 44917381, 89834777, 179669557,
        359339171, 718678369, 1437356741,
    ]

    @classmethod
    def meta(cls):
        return Meta("hash_manager", "prime", "Prime table sizes")

    def initial(self) -> int:
        return self.PRIMES[0]

    def grow(self, m: int) -> int:
        for p in self.PRIMES:
            if p > m:
                return p
        return m * 2 + 1

    def index(self, h: int, m: int) -> int:
        return h % m


class SizeManagerDirect(Algorithm):
    """Doubling non-pow2 sizes with modulo (``util/Hash.hpp:105-133``)."""

    @classmethod
    def meta(cls):
        return Meta("hash_manager", "direct", "Direct (x2) table sizes")

    def initial(self) -> int:
        return 19

    def grow(self, m: int) -> int:
        return m * 2 + 1

    def index(self, h: int, m: int) -> int:
        return h % m


class LinearProber(Algorithm):
    """Linear probing (reference ``util/Hash.hpp`` LinearProber)."""

    @classmethod
    def meta(cls):
        return Meta("hash_prober", "linear", "Linear probing")

    def step(self, base: int, i: int, m: int) -> int:
        return (base + i) % m


class QuadraticProber(Algorithm):
    """Quadratic probing ``base + i*i`` (reference ``util/Hash.hpp``
    QuadraticProber). Not cycle-free on every table size — HashMap
    degrades to a linear sweep after m failed probes."""

    @classmethod
    def meta(cls):
        return Meta("hash_prober", "quadratic", "Quadratic probing")

    def step(self, base: int, i: int, m: int) -> int:
        return (base + i * i) % m


class GaussProber(Algorithm):
    """Gauss-sum probing ``base + i(i+1)/2`` (reference
    ``util/Hash.hpp`` GaussProber advances by i each probe) — visits
    every slot of a pow2 table."""

    @classmethod
    def meta(cls):
        return Meta("hash_prober", "gauss", "Gauss-sum probing")

    def step(self, base: int, i: int, m: int) -> int:
        return (base + (i * (i + 1)) // 2) % m


class DoubleHashingProber(Algorithm):
    """Double hashing: stride ``1 + (h mod (m-1))`` (reference
    ``util/Hash.hpp`` _DoubleHashingProber) — never 0 mod m, so the
    sequence always moves; pow2 tables OR the HashMap's linear-sweep
    fallback guarantee termination."""

    @classmethod
    def meta(cls):
        return Meta("hash_prober", "double", "Double hashing")

    def step(self, base: int, i: int, m: int) -> int:
        stride = 1 + (base % max(m - 1, 1))
        return (base + i * stride) % m


class WordpackRollingHash:
    """Shift-and-add rolling fingerprint of a byte sequence (reference
    ``util/Hash.hpp:307-330`` WordpackRollingHash: ``(val + len)`` keyed
    word packing)."""

    def __init__(self, seed: int = 0):
        self.val = seed & _M64
        self.length = 0

    def extended(self, c: int) -> "WordpackRollingHash":
        h = WordpackRollingHash()
        h.val = ((self.val << 8) | (c & 0xFF)) & _M64
        h.length = self.length + 1
        return h

    def advance(self, c: int) -> None:
        self.val = ((self.val << 8) | (c & 0xFF)) & _M64
        self.length += 1

    def key(self) -> int:
        return (self.val + self.length) & _M64


class KarpRabinHash:
    """Karp-Rabin polynomial rolling hash over base ``B`` (reference
    vendored ``util/hash/rabinkarphash.h``): supports O(1) extension;
    used by the rolling LZ78 tries."""

    B = 1000000007

    def __init__(self, seed: int = 0):
        self.val = seed & _M64

    def extended(self, c: int) -> "KarpRabinHash":
        h = KarpRabinHash()
        h.val = (self.val * self.B + (c & 0xFF) + 1) & _M64
        return h

    def key(self) -> int:
        return self.val


class WordpackRolling(Algorithm):
    """Selectable rolling-hash family member (reference
    ``util/Hash.hpp:307-330``, registered as ``hash_roll`` in
    ``etc/registry_config.py:92-99``)."""

    @classmethod
    def meta(cls):
        return Meta("hash_roll", "wordpack", "Shift-and-add word packing")

    def make(self, seed: int = 0):
        return WordpackRollingHash(seed)


class KarpRabinRolling(Algorithm):
    """Karp-Rabin polynomial rolling hash (reference vendored
    ``util/hash/rabinkarphash.h``)."""

    @classmethod
    def meta(cls):
        return Meta("hash_roll", "karp_rabin", "Karp-Rabin fingerprints")

    def make(self, seed: int = 0):
        return KarpRabinHash(seed)


class HashMap:
    """Open-addressing u64 -> i64 map over pluggable strategies
    (reference ``util/Hash.hpp:183-354`` HashMap).

    ``EMPTY`` key slots are ``2**64 - 1`` (callers must not use that
    key). Grows at ``load_factor``.
    """

    EMPTY = np.uint64(_M64)

    def __init__(self, hasher=None, manager=None, prober=None,
                 load_factor: float = 0.5):
        from tudocomp_tpu_torch.registry import create_algo

        self.hasher = hasher or create_algo(MixHasher)
        self.manager = manager or create_algo(SizeManagerPow2)
        self.prober = prober or create_algo(LinearProber)
        self.load_factor = load_factor
        self.m = self.manager.initial()
        self.keys = np.full(self.m, self.EMPTY, np.uint64)
        self.values = np.zeros(self.m, np.int64)
        self.size = 0

    def clear(self) -> None:
        self.keys.fill(self.EMPTY)
        self.values.fill(0)
        self.size = 0

    def _slot(self, key: int) -> int:
        base = self.manager.index(self.hasher.hash(key), self.m)
        i = 0
        while i <= self.m:
            s = self.prober.step(base, i, self.m)
            k = self.keys[s]
            if k == self.EMPTY or k == key:
                return s
            i += 1
        # probe sequence cycled without finding a free slot (possible
        # for quadratic/double probing on non-pow2 sizes): the table is
        # below its load factor, so a linear sweep always terminates
        s = base
        while True:
            s = (s + 1) % self.m
            k = self.keys[s]
            if k == self.EMPTY or k == key:
                return s

    def _rehash(self) -> None:
        old_k, old_v = self.keys, self.values
        self.m = self.manager.grow(self.m)
        self.keys = np.full(self.m, self.EMPTY, np.uint64)
        self.values = np.zeros(self.m, np.int64)
        live = old_k != self.EMPTY
        for k, v in zip(old_k[live].tolist(), old_v[live].tolist()):
            s = self._slot(k)
            self.keys[s] = np.uint64(k)
            self.values[s] = v

    def get(self, key: int, default=None):
        s = self._slot(key)
        if self.keys[s] == self.EMPTY:
            return default
        return int(self.values[s])

    def insert(self, key: int, value: int) -> None:
        if self.size + 1 > self.m * self.load_factor:
            self._rehash()
        s = self._slot(key)
        if self.keys[s] == self.EMPTY:
            self.size += 1
        self.keys[s] = np.uint64(key)
        self.values[s] = value

    def __len__(self) -> int:
        return self.size


for _cls in (VignaHasher, KnuthHasher, MixHasher, NoopHasher,
             SizeManagerPow2, SizeManagerPrime, SizeManagerDirect,
             LinearProber, QuadraticProber, GaussProber,
             DoubleHashingProber, WordpackRolling, KarpRabinRolling):
    REGISTRY.register(_cls)
