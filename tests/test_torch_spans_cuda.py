"""The port's spans on the card's clock: a traced TBC2 round trip.

Needs an NVIDIA GPU and skips without one. The file imports nothing of
JAX; run it on the card with
``python -m pytest --noconftest -q tests/test_torch_spans_cuda.py``.
"""

import json
import time

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
        assert rec["stats"]["bytes"] > 0 and rec["stats"]["pinned"] == 1


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
    assert down["stats"]["pinned"] == 1


@pytest.mark.parametrize("n", [0, 1, 2047, 2049, (16 << 20) + 1])
def test_copies_round_trip_read_only_views_through_pinned_blocks(cuda, n):
    """``upload`` of a read-only view and ``download`` of its tensor,
    with and without ``head``, give back the view's bytes; every copy
    that moves a byte logs ``pinned`` 1."""
    from tudocomp_tpu_torch.device import download, upload
    from tudocomp_tpu_torch.stats import StatPhase

    raw = np.random.default_rng(n).integers(0, 256, n + 5, np.uint8)
    view = np.frombuffer(raw.tobytes(), np.uint8)[5:]
    assert not view.flags.writeable and view.size == n
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        (t,) = upload("tbc2.upload", view, device=cuda)
        assert t.is_cuda
        (back,) = download("tbc2.download", t)
        (framed,) = download("tbc2.download", t, head=3)
    assert back.numpy().tobytes() == view.tobytes()
    assert framed.numpy()[3:].tobytes() == view.tobytes()
    log = [r for r in StatPhase.recorded() if r["start"] >= t0
           and r["name"] in ("tbc2.upload", "tbc2.download")]
    assert [r["stats"]["bytes"] for r in log] == [n, n, n]
    if n:
        assert [r["stats"]["pinned"] for r in log] == [1, 1, 1]


def test_a_second_round_trip_maps_no_new_pinned_block(cuda):
    """The seam's pinned blocks come back to torch's caching host
    allocator when each call ends, so a second ``BlockCodec`` round trip
    of the same size maps no new block."""
    from tudocomp_tpu_torch import BlockCodec
    from tudocomp_tpu_torch.device import download

    rng = np.random.default_rng(18)
    alphabet = np.frombuffer(b"abcdefgh  \n", np.uint8)
    first, second = (rng.choice(alphabet, (20 << 20) + 7).tobytes()
                     for _ in range(2))
    codec = BlockCodec(device=cuda)
    assert codec.decompress_device(codec.compress(first)) == first
    stats = getattr(torch.cuda, "host_memory_stats", dict)
    if "num_host_alloc" in stats():
        before = stats()["num_host_alloc"]
        assert codec.decompress_device(codec.compress(second)) == second
        assert stats()["num_host_alloc"] == before
    else:
        t = torch.zeros(1 << 20, dtype=torch.uint8, device=cuda)
        ptrs = [download("tbc2.download", t)[0].data_ptr()
                for _ in range(2)]
        assert ptrs[0] == ptrs[1]
