"""The benchmark of the PyTorch and CUDA port ``tudocomp_tpu_torch``.

``python3 -m benchmark.run`` runs one cell once (``run.py``); see
``README.md``. Everything a cell needs lives in files found by name:
configurations (``configs/``), traffic mixes (``traffic/``), corpus
generators (``corpora/``), the plain reference (``reference/``) and the
per-layer metric readers (``metrics/``).
"""
