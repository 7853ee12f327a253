"""Multi-device scaling layer of the port, on ``torch.distributed``.

Counterpart of ``tudocomp_tpu/parallel/``: blocks data-parallel over the
ranks of a process group (one process per device), the table histogram
summed by one ``all_reduce``, the table built on every rank from it, and
the frames gathered in order to rank 0, the single writer
(``pipeline.py``); the mesh (``mesh.py``), multi-process set-up
(``distributed.py``) and a launcher that spawns the ranks of one job on
this host (``launch.py``).
"""

from tudocomp_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from tudocomp_tpu_torch.parallel.pipeline import (  # noqa: F401
    compress_sharded,
    sharded_huff_stage,
    sharded_rle_stage,
)
