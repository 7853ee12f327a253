"""Stage probes of the port's segment kernels, on the card: where K2's
time goes stage by stage (``ablate``, P1/P2), the floor of moving a
segment's bytes (``floor``, P3), and what placement costs under each
strategy (``place``, P4). Counterparts of the TPU probes
``etc/probe_ablate.py``, ``etc/probe_ablate_w4.py``,
``etc/probe_floor.py`` and ``etc/probe_int8.py``; ``etc/torch_probes.py``
times them. Each wrapper launches its hand-written CUDA kernel on CUDA
tensors and runs its plain torch version on CPU tensors, and each
variant counts its own launches."""

from tudocomp_tpu_torch.probes import ablate, floor, place

#: launch counters of every probe variant, by name
COUNTERS = {**ablate.COUNTERS, **floor.COUNTERS, **place.COUNTERS}

__all__ = ["COUNTERS", "ablate", "floor", "place"]
