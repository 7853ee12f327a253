"""The general generator: a configuration's corpus under a traffic mix.

The mix says how many distinct files a run cycles through
(``distinct_inputs``) and, where it sets ``file_bytes``, their size;
otherwise the configuration's ``file_bytes`` holds. File ``i`` of seed
``s`` is drawn by the corpus module named by the configuration's
``corpus.kind`` (``corpora/<kind>.py``) from a torch generator seeded
with a hash of ``(s, i)``: the same seed gives the same files.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch


def file_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for file ``index`` of run seed ``seed``
    (any whole number)."""
    words = np.random.SeedSequence(
        [seed % (1 << 64), index]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def file_bytes(config: dict, traffic: dict) -> int:
    return int(traffic.get("file_bytes") or config["file_bytes"])


def make(config: dict, traffic: dict, seed: int, device) -> list[bytes]:
    """The run's distinct input files."""
    corpus = config["corpus"]
    module = importlib.import_module("benchmark.corpora." + corpus["kind"])
    size = file_bytes(config, traffic)
    out = []
    for i in range(int(traffic["distinct_inputs"])):
        gen = torch.Generator(device=device)
        gen.manual_seed(file_seed(seed, i))
        out.append(module.generate(gen, size, corpus).cpu().numpy()
                   .tobytes())
    return out
