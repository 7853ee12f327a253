"""A whole run on the CPU at a small size, past the harness's look for
a chip: sound, it comes out correct; with the timed path broken
underneath, ``correct`` comes out false, once for each fault the cells
can have (a byte altered where it is produced, half of the input left
out, the BWT altered)."""

import pytest

from benchmark import cell as cell_mod

#: 70 segments a file, so that the table samples its histogram
SMALL = {"file_bytes": 140_000}
SEED = 2**31 + 99


def _run(name, trace=False):
    return cell_mod.run(name, SEED, 0.05, trace, device="cpu",
                        overrides=SMALL)


def _flip(b: bytes, at: int) -> bytes:
    return b[:at] + bytes([b[at] ^ 1]) + b[at + 1:]


@pytest.fixture
def cli():
    from tudocomp_tpu_torch import cli

    return cli


@pytest.mark.parametrize("name", ["tbc2-enwik.bulk", "bwt-tbc2-dna.bulk"])
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"compress_GBps", "decompress_GBps",
                                 "setup_s"}


@pytest.mark.parametrize("name", ["tbc2-enwik.bulk", "bwt-tbc2-dna.bulk"])
def test_traced_run_is_correct(name):
    r = _run(name, trace=True)
    assert r["correct"]
    assert r["checks"]["layer_bytes_off"]["value"] == 0
    assert "breakdown" in r and "window_s" in r["device"]


def test_container_byte_altered(monkeypatch, cli):
    real = cli.compress
    monkeypatch.setattr(cli, "compress",
                        lambda *a, **k: _flip(real(*a, **k), 5000))
    r = _run("tbc2-enwik.bulk")
    assert not r["correct"]
    assert r["checks"]["container_bytes_off"]["value"] > 0


def test_restored_byte_altered(monkeypatch, cli):
    real = cli.decompress
    monkeypatch.setattr(cli, "decompress",
                        lambda *a, **k: _flip(real(*a, **k), 777))
    r = _run("bwt-tbc2-dna.bulk")
    assert not r["correct"]
    assert r["checks"]["restored_bytes_off"]["value"] > 0


@pytest.mark.parametrize("name", ["tbc2-enwik.bulk", "bwt-tbc2-dna.bulk"])
def test_half_left_out(monkeypatch, cli, name):
    real = cli.compress
    monkeypatch.setattr(
        cli, "compress",
        lambda algo, data, **k: real(algo, data[: len(data) // 2], **k))
    r = _run(name)
    assert not r["correct"]
    assert r["checks"]["container_bytes_off"]["value"] > 0
    assert r["checks"]["restored_bytes_off"]["value"] > 0


def test_bwt_altered(monkeypatch):
    from tudocomp_tpu_torch.compressors import bwt

    real = bwt.BWTCompressor.compress
    monkeypatch.setattr(bwt.BWTCompressor, "compress",
                        lambda self, data: _flip(real(self, data), 1234))
    r = _run("bwt-tbc2-dna.bulk")
    assert not r["correct"]
    assert r["checks"]["container_bytes_off"]["value"] > 0
