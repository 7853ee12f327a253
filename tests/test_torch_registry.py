"""The port's ``Registry.all_configurations``, its logging layer
(``utils/log.py``, the CLI's ``--loglevel``, ``--logdir`` and
``--logverbosity`` and the ``TDC_LOG*`` variables) and the host families'
container digests that ``chip_smoke.py``'s phase 15 pins, against the
JAX package on the CPU.
"""

from __future__ import annotations

import hashlib
import itertools
import logging

import pytest

import chip_smoke
from bench import make_corpus
from tudocomp_tpu import cli as jax_cli
from tudocomp_tpu.registry import REGISTRY as JAX_REGISTRY
from tudocomp_tpu.utils import log as jax_log
from tudocomp_tpu_torch import cli
from tudocomp_tpu_torch.registry import REGISTRY
from tudocomp_tpu_torch.utils import log

CPU = "cpu"
TYPES = sorted(JAX_REGISTRY._by_type)


def test_the_port_registers_every_type_and_name():
    assert sorted(REGISTRY._by_type) == TYPES
    for t in TYPES:
        assert REGISTRY.names(t) == JAX_REGISTRY.names(t), t


@pytest.mark.parametrize("type_", [t for t in TYPES if t != "compressor"])
def test_all_configurations_match_jax(type_):
    want = list(JAX_REGISTRY.all_configurations(type_))
    assert want and list(REGISTRY.all_configurations(type_)) == want


#: ``chain``'s configurations number in the millions at the default
#: depth cap (4.7 M, most of a minute to list in each package): the
#: comparison takes their first ones
CHAIN_PREFIX = 200_000


@pytest.mark.parametrize("name", JAX_REGISTRY.names("compressor"))
def test_compressor_configurations_match_jax(name):
    """Each compressor's share of ``all_configurations("compressor")``
    (which yields every name's in turn) at the default depth cap and at
    cap 1, where ``chain`` comes whole."""
    for cap in (1, 2):
        want = JAX_REGISTRY._enum_cls("compressor", name,
                                      {"compressor": 1}, cap)
        got = REGISTRY._enum_cls("compressor", name, {"compressor": 1},
                                 cap)
        if name == "chain" and cap == 2:
            want = itertools.islice(want, CHAIN_PREFIX)
            got = itertools.islice(got, CHAIN_PREFIX)
        pairs = itertools.zip_longest(got, want)
        assert all(g == w for g, w in pairs), (name, cap)
    assert list(REGISTRY.all_configurations("compressor", 1)) == list(
        JAX_REGISTRY.all_configurations("compressor", 1))


@pytest.fixture
def clean_logging():
    """Both packages' logging state as it was before the test."""
    saved = []
    for mod in (log, jax_log):
        root = mod._ROOT
        saved.append((mod, root.level, list(root.handlers), mod._VERBOSITY,
                      mod._FILE_DIR))
    yield
    for mod, level, handlers, verbosity, file_dir in saved:
        for h in mod._ROOT.handlers:
            if h not in handlers:
                h.close()
        mod._ROOT.handlers[:] = handlers
        mod._ROOT.setLevel(level)
        mod._VERBOSITY, mod._FILE_DIR = verbosity, file_dir


def _state(mod):
    root = mod._ROOT
    return (root.level, mod._VERBOSITY,
            sorted(type(h).__name__ for h in root.handlers))


def test_log_flags_match_jax(tmp_path, clean_logging):
    """The repro of the port's former fault: both CLIs accept the flags,
    write the same container, and leave their loggers alike, each with a
    log file in its directory."""
    src = tmp_path / "in.txt"
    src.write_bytes(b"hello logging " * 50)
    for name, main, logger in (("port", cli.main, log),
                               ("jax", jax_cli.main, jax_log)):
        args = ["--loglevel", "info", "--logdir", str(tmp_path / name),
                "--logverbosity", "2", "-a", "noop", "-f", "-o",
                str(tmp_path / f"{name}.tdc"), str(src)]
        if name == "port":
            args = ["--device", CPU, *args]
        assert main(args) == 0
        logger.get_logger("test").info("from %s", name)
        for h in logger._ROOT.handlers:
            h.flush()
        files = list((tmp_path / name).iterdir())
        assert len(files) == 1 and files[0].name.startswith("tdc.")
        assert f"from {name}" in files[0].read_text()
        assert logger.vlog(2) and not logger.vlog(3)
    assert _state(log) == _state(jax_log)
    assert log._ROOT.name == "tudocomp_tpu_torch"
    assert (tmp_path / "port.tdc").read_bytes() == (
        tmp_path / "jax.tdc").read_bytes()


def test_log_variables_match_jax(tmp_path, monkeypatch, clean_logging):
    monkeypatch.setenv("TDC_LOGLEVEL", "warning")
    monkeypatch.setenv("TDC_LOGDIR", str(tmp_path / "env"))
    monkeypatch.setenv("TDC_LOGVERBOSITY", "3")
    log.configure()
    jax_log.configure()
    assert _state(log) == _state(jax_log)
    assert log._ROOT.level == logging.WARNING and log.vlog(3)
    # one file handler per directory, however often it is configured
    log.configure()
    assert _state(log) == _state(jax_log)
    assert len(list((tmp_path / "env").iterdir())) >= 1


def test_host_digests_pin_the_jax_containers():
    """``chip_smoke.py``'s phase-15 digests are the JAX package's
    containers, and the port writes the same."""
    data = make_corpus(chip_smoke.HOST_DIGEST_BYTES).tobytes()
    assert set(chip_smoke.HOST_DIGESTS) == {a for a, _ in chip_smoke.HOST_CLI}
    for algo, want in chip_smoke.HOST_DIGESTS.items():
        container = jax_cli.compress(algo, data)
        assert hashlib.sha256(container).hexdigest() == want, algo
        assert cli.compress(algo, data, device=CPU) == container, algo
