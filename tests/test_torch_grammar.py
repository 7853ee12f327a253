"""The port's grammar and suffix-tree families: ``repair``, ``lz78u``
and the ``lfs`` family (``lfs_comp`` with every strategy, ``lfs2``,
``lfs2bst``) with ``ds/suffix_tree.py`` (``compressors/repair.py``,
``lz78u.py``, ``lfs.py``, ``csrc/host/repair.cpp``, ``lz78u.cpp``,
``lfs.cpp``) against the JAX package on the CPU. Every comparison is
exact (bytes, or arrays).

Each Python path that the port keeps is forced in both packages (the
host wrapper patched to return None, as it does on an overflow, or a
decode LUT refused) and must give the JAX package's bytes there too.
"""

from __future__ import annotations

import numpy as np
import pytest

from tudocomp_tpu import cli as jax_cli
from tudocomp_tpu import native as jax_native
from tudocomp_tpu.coders.huffman import HuffmanTable as JaxTable
from tudocomp_tpu.ds.suffix_tree import SuffixTree as JaxTree
from tudocomp_tpu_torch import cli, native
from tudocomp_tpu_torch.coders.huffman import HuffmanTable
from tudocomp_tpu_torch.ds.suffix_tree import SuffixTree

from tests.test_torch_lz78 import CORPUS, matrix_grid, same_containers

CPU = "cpu"


@pytest.mark.parametrize(
    "algo", matrix_grid(("repair", "lz78u", "lfs_comp", "lfs2", "lfs2bst")))
def test_containers_match_jax(algo):
    same_containers(algo, CORPUS)


def _texts():
    rng = np.random.default_rng(7)
    return [
        b"\x00",
        b"banana\x00",
        b"abracadabra abracadabra\x00",
        b"a" * 300 + b"\x00",
        rng.integers(1, 4, 3000, dtype=np.uint8).tobytes() + b"\x00",
        rng.integers(1, 256, 2000, dtype=np.uint8).tobytes() + b"\x00",
    ]


def test_suffix_tree_arrays_match_jax():
    for text in _texts():
        port, jax = SuffixTree(text), JaxTree(text)
        for name in ("parent", "sdepth", "is_leaf", "suffix",
                     "leaf_of_rank", "isa"):
            assert np.array_equal(getattr(port, name), getattr(jax, name)), (
                name, len(text))
        assert (port.n, port.root, port.internal_nodes) == (
            jax.n, jax.root, jax.internal_nodes)


def _data():
    rng = np.random.default_rng(11)
    return CORPUS + [
        b"to be or not to be that is the question " * 20,
        rng.choice(np.frombuffer(b"acgt", np.uint8), 3000)
        .astype(np.uint8).tobytes(),
    ]


@pytest.mark.parametrize("algo", ["repair(coder=bit)", "repair(coder=huff)",
                                  "repair(coder=gamma, max_rules=5)"])
def test_repair_numpy_rounds_match_jax(algo, monkeypatch):
    """Where ``tdc_repair`` gives no grammar (2^31 bytes and more, a rule
    overflow) both packages run the numpy round-rescan, whose ties break
    otherwise than the host kernel's."""
    monkeypatch.setattr(native, "repair", lambda *a: None)
    monkeypatch.setattr(jax_native, "repair", lambda *a: None)
    same_containers(algo, _data())


@pytest.mark.parametrize("strat,fn", [("sim_st", "lfs_simst"),
                                      ("bst", "lfs_bst")])
def test_lfs_python_walks_match_jax(strat, fn, monkeypatch):
    """Where the host SimST or BST computation overflows (its wrapper
    returns None) both packages run the Python walk."""
    algos = [f"lfs_comp(computing_strat={strat}(min_lrf={m}))"
             for m in (2, 4)]
    want = {(a, d): cli.compress(a, d, device=CPU)
            for a in algos for d in _data()}
    monkeypatch.setattr(native, fn, lambda *a: None)
    monkeypatch.setattr(jax_native, fn, lambda *a: None)
    for algo in algos:
        same_containers(algo, _data())
        for data in _data():
            assert cli.compress(algo, data, device=CPU) == want[algo, data]


@pytest.mark.parametrize("algo", [
    "lfs_comp",
    "lfs_comp(coding_strat=lfs_encode_strat(lfs_lit_coder=ascii))",
    "lfs2",
    "lfs2(lfs2_lit_coder=ascii, lfs2_len_coder=delta)",
    "lfs2bst(lfs2_lit_coder=bit)",
])
def test_lfs_decode_loops_match_jax(algo, monkeypatch):
    """The Python decode loops that both packages keep: the ``ascii``
    literal coder's, and a Huffman table whose decode LUT is refused
    (codes past 22 bits)."""

    def refuse(self):
        raise ValueError("codeword too long for LUT decode")

    monkeypatch.setattr(HuffmanTable, "build_lut", refuse)
    monkeypatch.setattr(JaxTable, "build_lut", refuse)
    same_containers(algo, _data())


def test_lz78u_needs_a_coder_like_jax():
    for algo in ("lz78u", "lz78u(comp=streaming)"):
        with pytest.raises(Exception) as want:
            jax_cli.compress(algo, b"abc")
        with pytest.raises(Exception) as got:
            cli.compress(algo, b"abc", device=CPU)
        assert type(got.value) is type(want.value)
        assert str(got.value) == str(want.value)
