"""No module the benchmark loads is JAX's or the JAX package's (by whole
top-level name), and the command gives no result where it must not."""

import os
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import cell as cell_mod
from benchmark import spec

ENV = dict(os.environ, PYTHONPATH=spec.ROOT)
ENV.pop("JAX_PLATFORMS", None)


def test_run_loads_no_jax():
    code = (
        "import sys\n"
        "from benchmark import cell\n"
        "for w in ('tbc2-enwik.bulk', 'bwt-tbc2-dna.bulk'):\n"
        "    r = cell.run(w, 3, 0.01, False, device='cpu',\n"
        "                 overrides={'file_bytes': 20000})\n"
        "    assert r['correct']\n"
        "import benchmark.control, benchmark.run\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'tudocomp_tpu_torch' in top\n"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', 'tudocomp_tpu',"
        " 'bench'}))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=600, env=ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole(monkeypatch):
    loaded = {"tudocomp_tpu_torch.cli": 1, "jaxtyping": 1, "benchmark": 1,
              "bench": 1, "jax.numpy": 1, "tudocomp_tpux": 1}
    monkeypatch.setattr(cell_mod, "sys", types.SimpleNamespace(
        modules=loaded))
    assert cell_mod.loaded_forbidden() == ["bench", "jax"]


def test_forbidden_module_stops_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(cell_mod.ForbiddenModules):
        cell_mod.run("tbc2-enwik.bulk", 1, 0.01, False, device="cpu",
                     overrides={"file_bytes": 5000})


def _command(cwd):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "tbc2-enwik.bulk", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_result_without_cuda():
    r = _command(spec.ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_no_result_in_bare_directory(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _command(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
