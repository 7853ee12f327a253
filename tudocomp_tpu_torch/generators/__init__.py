"""Deterministic test-string generators.

Behavioral parity with the reference's ``generators/`` (FibonacciGenerator.hpp,
ThueMorseGenerator.hpp, RunRichGenerator.hpp, RandomUniformGenerator.hpp).
``random`` uses numpy's PCG64 rather than std::default_random_engine — the
reference's engine is implementation-defined, so cross-implementation equality
was never guaranteed; ours is deterministic for a given seed.
"""

from __future__ import annotations

import numpy as np


def fibonacci(n: int) -> bytes:
    """n-th Fibonacci word over {a, b}."""
    if n == 1:
        return b"b"
    if n == 2:
        return b"a"
    vold, old = b"b", b"a"
    for _ in range(2, n):
        vold, old = old, old + vold
    return old


def thue_morse(n: int) -> bytes:
    """n-th Thue-Morse word over {0, 1} (length 2^(n-1) for n >= 1)."""
    if n >= 64:
        raise ValueError("too long")
    if n == 0:
        return b"0"
    a = np.zeros(1, np.uint8)
    for _ in range(1, n):
        a = np.concatenate([a, 1 - a])
    return (a + ord("0")).tobytes()


def run_rich(n: int) -> bytes:
    """Run-rich string series (Matsubara et al.)."""
    t0 = b"0110101101001011010"
    t1 = b"0110101101001"
    t2 = b"01101011010010110101101"
    t3 = t2 + t1
    if n == 0:
        return t0
    if n == 1:
        return t1
    if n == 2:
        return t2
    for i in range(4, n):
        tmp = (t3 + t2) if i % 3 == 0 else (t3 + t0)
        t0, t1, t2, t3 = t1, t2, t3, tmp
    return t3


def random_uniform(length: int, seed: int = 0, lo=ord("0"), hi=ord("9")) -> bytes:
    """Uniform random string over byte values [lo, hi]."""
    if lo > hi:
        lo, hi = hi, lo
    if not seed:
        seed = np.random.SeedSequence().entropy
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(lo, hi + 1, size=length, dtype=np.uint8).tobytes()


GENERATORS = {
    "fib": fibonacci,
    "thue_morse": thue_morse,
    "run_rich": run_rich,
    "random": random_uniform,
}


# ---------------------------------------------------------------------------
# Registered Generator algorithms (reference Generator.hpp:13 +
# registry_config.py:248-253: fib / thue_morse / rnd / run_rich are
# first-class registered modules, shown by ``tdc --list`` and invoked
# via ``tdc -g "fib(10)"``).
# ---------------------------------------------------------------------------

from tudocomp_tpu_torch.meta import Algorithm, Meta


class Generator(Algorithm):
    """Base: produces a test string from options (reference
    ``Generator.hpp:13-31``)."""

    def generate(self) -> bytes:
        raise NotImplementedError


class FibonacciGenerator(Generator):
    @classmethod
    def meta(cls):
        m = Meta("generator", "fib",
                 "Fibonacci word (generators/FibonacciGenerator.hpp)")
        m.option_dynamic("n", None)
        return m

    def generate(self) -> bytes:
        return fibonacci(self.env.option("n").as_int())


class ThueMorseGenerator(Generator):
    @classmethod
    def meta(cls):
        m = Meta("generator", "thue_morse",
                 "Thue-Morse word (generators/ThueMorseGenerator.hpp)")
        m.option_dynamic("n", None)
        return m

    def generate(self) -> bytes:
        return thue_morse(self.env.option("n").as_int())


class RunRichGenerator(Generator):
    @classmethod
    def meta(cls):
        m = Meta("generator", "run_rich",
                 "run-rich string series, Matsubara et al. "
                 "(generators/RunRichGenerator.hpp)")
        m.option_dynamic("n", None)
        return m

    def generate(self) -> bytes:
        return run_rich(self.env.option("n").as_int())


class RandomGenerator(Generator):
    @classmethod
    def meta(cls):
        m = Meta("generator", "random",
                 "uniform random string over printable digits "
                 "(generators/RandomUniformGenerator.hpp; PCG64 seed "
                 "semantics, see module docstring)")
        m.option_dynamic("n", None)
        m.option_dynamic("seed", 0)
        return m

    def generate(self) -> bytes:
        return random_uniform(
            self.env.option("n").as_int(), self.env.option("seed").as_int()
        )


def register_generators(registry) -> None:
    for g in (FibonacciGenerator, ThueMorseGenerator, RunRichGenerator,
              RandomGenerator):
        registry.register(g)
