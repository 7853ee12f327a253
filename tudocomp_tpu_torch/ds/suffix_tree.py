"""Suffix tree built from SA + LCP (lcp-interval stack construction).

The port's copy of ``tudocomp_tpu/ds/suffix_tree.py``. Replaces the
reference's pointer-based Ukkonen trees and SDSL ``cst_sada``
(``ds/SuffixTree.hpp``, ``compressors/lz78u/SuffixTree.hpp:18-40``) with
the enhanced-suffix-array formulation: internal nodes are lcp intervals,
built in one left-to-right stack pass over the LCP array by the host
library (``csrc/host/lfs.cpp``), over ``ds/suffix.py``'s SA and LCP.

Node attributes: ``parent``, ``sdepth`` (string depth), ``is_leaf``,
``suffix`` (leaf start position). ``leaf_of_rank[r]`` maps SA rank -> leaf
node id. Root is node 0. The JAX class's path helpers (``select_leaf``,
``root_path``, ``level_anc``, ``str_depth``) serve only its Python LZ78U
walk, which the port does not keep, so they are left out.
"""

from __future__ import annotations

from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.ds.suffix import TextDS


class SuffixTree:
    def __init__(self, text: bytes):
        """``text`` must end with a unique sentinel (e.g. b"\\0")."""
        ds = TextDS(text)
        sa = ds.require_sa()
        lcp = ds.require_lcp()
        self.n = sa.size
        (self.parent, self.sdepth, self.is_leaf, self.suffix,
         self.leaf_of_rank, _m) = native.suffix_tree(sa, lcp)
        self.isa = ds.require_isa()
        self.root = 0
        self.internal_nodes = int((~self.is_leaf).sum())
