"""The control (the reference with the sampled-histogram guarantee
broken) has to fail the check: at a small size on the CPU, and at each
cell's own size on the card."""

import pytest

from benchmark import control, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_small(name):
    r = control.readings(name, 2**31 + 5, "cpu", {"file_bytes": 300_000})
    assert r["container_bytes_off"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size(name, cuda_device):
    for seed in (11, 12, 13):
        assert control.readings(name, seed, cuda_device)[
            "container_bytes_off"] > 0
