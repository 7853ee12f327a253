"""The port's spans on the card's clock: a traced TBC2 round trip.

Needs an NVIDIA GPU and skips without one. The file imports nothing of
JAX; run it on the card with
``python -m pytest --noconftest -q tests/test_torch_spans_cuda.py``.
"""

import json

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_each_download_span_contains_its_device_to_host_copies(cuda,
                                                               tmp_path):
    """Each ``tbc2.download`` range of the trace holds the D2H copies
    that the CUDA runtime calls made inside it issued, so the range's
    seconds are those of its copies on the device's clock."""
    from tudocomp_tpu_torch import cli
    from tudocomp_tpu_torch.stats import StatPhase

    rng = np.random.default_rng(16)
    data = rng.choice(np.frombuffer(b"abcdefgh  \n", np.uint8),
                      16 << 20).tobytes()
    cli.decompress(cli.compress("tbc2", data, device=cuda), device=cuda)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        container = cli.compress("tbc2", data, device=cuda)
        assert cli.decompress(container, device=cuda) == data
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]

    def interval(e):
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])

    downloads = [interval(e) for e in events
                 if e.get("cat") == "user_annotation"
                 and e["name"] == "tbc2.download"]
    log = [r for r in StatPhase.recorded() if r["name"] == "tbc2.download"]
    assert len(downloads) == len(log) == 2  # the frames' and decode's
    calls = {e["args"]["correlation"]: interval(e) for e in events
             if e.get("cat") == "cuda_runtime"
             and "correlation" in e.get("args", {})}
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "DtoH" in e["name"]]
    for (a, b), rec in zip(downloads, sorted(log,
                                             key=lambda r: r["start"])):
        issued = [interval(c) for c in copies
                  if a <= calls[c["args"]["correlation"]][0] <= b]
        assert issued
        for c0, c1 in issued:
            assert a <= c0 and c1 <= b, (a, b, c0, c1)
        assert rec["stats"]["bytes"] > 0 and rec["stats"]["pinned"] == 0


def test_assemble_builds_the_frames_on_the_card(cuda):
    """On CUDA ``tbc2.assemble`` counts ``on_device`` 1, and its one
    ``tbc2.download`` brings the frame bytes alone: the container less
    its prefix. ``tbc2.encode`` downloads nothing."""
    from tudocomp_tpu_torch import BlockCodec
    from tudocomp_tpu_torch.stats import StatPhase

    rng = np.random.default_rng(17)
    data = rng.choice(np.frombuffer(b"abcdefgh  \n", np.uint8),
                      3 << 20).tobytes()
    codec = BlockCodec(device=cuda, batch_lanes=512)
    codec.compress(data)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        container = codec.compress(data)
    log = StatPhase.recorded()
    (asm,) = [r for r in log if r["name"] == "tbc2.assemble"]
    assert asm["stats"]["on_device"] == 1
    assert asm["stats"]["bytes_out"] == len(container)
    (down,) = [r for r in log if r["name"] == "tbc2.download"]
    assert down["parent"] == asm["id"]
    prefix = codec.prefix(len(data), codec.parse(container)[0])
    assert down["stats"]["bytes"] == len(container) - len(prefix)
    assert down["stats"]["pinned"] == 0
