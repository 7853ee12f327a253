"""BWT compressor.

Reference: ``compressors/BWTCompressor.hpp`` — compress = raw BWT bytes of
the 0-sentineled input (forward transform is a pure SA gather); decompress
= LF-mapping walk, emitting the text plus the sentinel (the restriction
layer strips it).

The port's counterpart of ``tudocomp_tpu/compressors/bwt.py``, with the
same options and bytes. ``bwt(device=true)`` (or ``TDC_DEVICE_BWT=1``)
takes the device path for inputs of at least ``DEVICE_MIN`` bytes: the
suffix array, ISA and BWT of ``ops/suffix.py``, and its orbit-doubling
inverse, on the Env's torch device (the CPU too, where the caller names
it; CUDA raises where it is absent). ``bwt`` (``device=false``) runs on
the host, with the host library's SA-IS and LF walk, and touches no
device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tudocomp_tpu_torch import debug, native
from tudocomp_tpu_torch.compressors.base import Compressor
from tudocomp_tpu_torch.device import download, resolve_device, upload
from tudocomp_tpu_torch.ds.bwt import bwt_forward, compute_lf
from tudocomp_tpu_torch.ds.suffix import suffix_array
from tudocomp_tpu_torch.meta import Meta
from tudocomp_tpu_torch.ops.suffix import (
    bwt_device, isa_device, suffix_array_device, unbwt_device,
)
from tudocomp_tpu_torch.stats import StatPhase


class BWTCompressor(Compressor):
    @classmethod
    def meta(cls):
        m = Meta("compressor", "bwt", "BWT Compressor")
        m.option_dynamic("device", "false")
        m.needs_sentinel_terminator()
        return m

    #: inputs at least this long take the device path when it is asked
    #: for (as in the JAX package)
    DEVICE_MIN = 1 << 15

    def _device_path(self, n: int) -> torch.device | None:
        """The torch device of the device path, or None for the host."""
        env = os.environ.get("TDC_DEVICE_BWT")
        want = (env == "1" if env is not None
                else self.env.option("device").as_bool())
        if not want or n < self.DEVICE_MIN:
            return None
        return resolve_device(self.env.torch_device)

    def compress(self, data: bytes) -> bytes:
        if not data.endswith(b"\x00"):
            raise ValueError("bwt requires a sentineled input")
        t = np.frombuffer(data, np.uint8)
        dev = self._device_path(len(data))
        if dev is None:
            return bwt_forward(t, suffix_array(t)).tobytes()
        with StatPhase("bwt.forward") as phase:
            (td,) = upload("bwt.upload", t.copy(), device=dev)
            info = {}
            with StatPhase("bwt.sa"):
                sa = suffix_array_device(td, info)
            with StatPhase("bwt.isa_bwt"):
                bw = bwt_device(td, isa_device(sa))
            (bw,) = download("bwt.download", bw)
            phase.log_stat("bytes_in", len(data))
            phase.log_stat("rounds", info["rounds"])
            return bw.numpy().tobytes()

    def decompress(self, data: bytes) -> bytes:
        dev = self._device_path(len(data))
        if dev is None:
            return native.bwt_decode(data) + b"\x00"
        arr = np.frombuffer(data, np.uint8)
        if debug.PARANOID:  # mirror the host path's LF invariant
            debug.check_lf(compute_lf(arr), arr)
        with StatPhase("bwt.inverse") as phase:
            (bw,) = upload("bwt.upload", arr.copy(), device=dev)
            info = {}
            with StatPhase("bwt.unbwt"):
                out = unbwt_device(bw, info)
            (out,) = download("bwt.download", out)
            out = out.numpy().tobytes() + b"\x00"
            phase.log_stat("bytes_out", len(out))
            phase.log_stat("rounds", info["rounds"])
        return out
