"""LZ78 trie strategy family: the ``lz78trie`` registrations.

Reference: ``lz78/LZ78Trie.hpp`` interface plus the concrete tries under
``compressors/lz78/``. The strategies differ in node layout and lookup
structure:

- ``ternary``        — ternary search trie (``lz78/TernaryTrie.hpp``)
- ``binary``         — first-child / next-sibling lists, linear scan
                       (``lz78/BinaryTrie.hpp``)
- ``binary_sorted``  — per-node sorted child arrays, binary search
                       (``lz78/BinarySortedTrie.hpp``)
- ``cedar``          — double-array (base/check) trie
                       (``lz78/CedarTrie.hpp`` / vendored cedar)
- ``hash``           — (parent<<8|char) -> id open-addressing map over
                       the hash framework (``lz78/HashTrie.hpp``)
- ``hash_plus``      — hash trie with direct sizing and a denser load
                       factor (``lz78/HashTriePlus.hpp``)
- ``ext_hash``       — the library hash table (``lz78/ExtHashTrie.hpp``)
- ``rolling``        — Karp-Rabin rolling fingerprint of the node's
                       string as the key (``lz78/RollingTrie.hpp``)
- ``rolling_plus``   — rolling fingerprints over the denser table
                       (``lz78/RollingTriePlus.hpp``)
- ``compact_sparse_hash`` — Cleary compact hashing in sparse buckets
                       (``lz78/CompactSparseHashTrie.hpp``)

The port's counterpart of ``tudocomp_tpu/compressors/lz78_trie.py``, with
the same names, docs and sub-options. Every one of these tries is an
exact (node, byte) -> id map with insertion-order ids that grows by one
node a factor, so all give the same LZ78/LZW parse and reset a bounded
dictionary at the same factor. ``lz78`` and ``lzw`` therefore parse in
the host library's one dictionary (``csrc/host/lz78.cpp``) whichever trie
the string names; these classes carry only the registrations, so ``-l``
and ``all_configurations`` list every trie as the JAX package does.
"""

from __future__ import annotations

from tudocomp_tpu_torch.meta import Algorithm, Meta
import tudocomp_tpu_torch.utils.hash  # noqa: F401 — registers the framework


class LZ78Trie(Algorithm):
    """Interface: maps (node_id, byte) -> node_id, insertion-order ids
    (reference ``lz78/LZ78Trie.hpp:41-90``)."""


class ExtHashTrie(LZ78Trie):
    """Library hash table (reference ``lz78/ExtHashTrie.hpp``)."""

    @classmethod
    def meta(cls):
        return Meta("lz78trie", "ext_hash", "Library hash table trie")


class HashTrie(LZ78Trie):
    """Open-addressing trie over the hash framework
    (reference ``lz78/HashTrie.hpp:13-60`` + ``squeeze_node.hpp``)."""

    @classmethod
    def meta(cls):
        m = Meta("lz78trie", "hash", "(parent,char)->id hash trie")
        m.option_submeta("hash_function", "hash_function", default="mixer")
        m.option_submeta("hash_prober", "hash_prober", default="linear")
        m.option_submeta("hash_manager", "hash_manager", default="pow")
        return m


class HashTriePlus(LZ78Trie):
    """Denser table, direct sizing (reference ``lz78/HashTriePlus.hpp``;
    no prober sub-option, matching ``registry_config.py:116``)."""

    @classmethod
    def meta(cls):
        m = Meta("lz78trie", "hash_plus", "Dense hash trie (x2 sizes)")
        m.option_submeta("hash_function", "hash_function", default="mixer")
        m.option_submeta("hash_manager", "hash_manager", default="direct")
        return m


class RollingTrie(LZ78Trie):
    """Karp-Rabin rolling fingerprints: a node's key is the rolling
    hash of its full string, extended per char (reference
    ``lz78/RollingTrie.hpp``)."""

    @classmethod
    def meta(cls):
        m = Meta("lz78trie", "rolling", "Karp-Rabin rolling-hash trie")
        m.option_submeta("hash_roll", "hash_roll", default="karp_rabin")
        m.option_submeta("hash_prober", "hash_prober", default="linear")
        m.option_submeta("hash_manager", "hash_manager", default="pow")
        m.option_submeta("hash_function", "hash_function", default="mixer")
        return m


class RollingTriePlus(LZ78Trie):
    """No prober sub-option (reference ``registry_config.py:118``)."""

    @classmethod
    def meta(cls):
        m = Meta("lz78trie", "rolling_plus", "Dense rolling-hash trie")
        m.option_submeta("hash_roll", "hash_roll", default="karp_rabin")
        m.option_submeta("hash_manager", "hash_manager", default="direct")
        m.option_submeta("hash_function", "hash_function", default="mixer")
        return m


class TernaryTrie(LZ78Trie):
    """Ternary search trie (reference ``lz78/TernaryTrie.hpp``)."""

    @classmethod
    def meta(cls):
        return Meta("lz78trie", "ternary", "Ternary search trie")


class BinaryTrie(LZ78Trie):
    """First-child / next-sibling node layout
    (reference ``lz78/BinaryTrie.hpp``)."""

    @classmethod
    def meta(cls):
        return Meta("lz78trie", "binary", "First-child/next-sibling trie")


class BinarySortedTrie(LZ78Trie):
    """Per-node sorted child arrays
    (reference ``lz78/BinarySortedTrie.hpp``)."""

    @classmethod
    def meta(cls):
        return Meta("lz78trie", "binary_sorted", "Sorted-children trie")


class CedarTrie(LZ78Trie):
    """Double-array (base/check) trie (reference ``lz78/CedarTrie.hpp``)."""

    @classmethod
    def meta(cls):
        return Meta("lz78trie", "cedar", "Double-array (base/check) trie")


class CompactSparseHashTrie(LZ78Trie):
    """Cleary compact sparse hash table as the trie map (reference
    ``lz78/CompactSparseHashTrie.hpp`` over
    ``util/compact_sparse_hash.hpp``)."""

    @classmethod
    def meta(cls):
        return Meta(
            "lz78trie", "compact_sparse_hash",
            "Compact sparse (quotient-bucket) hash trie",
        )


ALL_TRIES = [
    TernaryTrie,
    BinaryTrie,
    BinarySortedTrie,
    CedarTrie,
    HashTrie,
    HashTriePlus,
    RollingTrie,
    RollingTriePlus,
    ExtHashTrie,
    CompactSparseHashTrie,
]
