"""The port's journaled sharded compression
(``parallel/pipeline.py:compress_sharded_resumable``) killed midway and
resumed, against the JAX package's journal.

A run stopped by ``TDC_CRASH_AFTER_BATCH`` (rank 0 leaves with exit 17
after appending a batch's frames and before journaling them, the worst
tear) must leave the JAX package's journal and torn container, and a
resumed run the one-shot container; the port must also resume the
journal that the JAX package's stopped run leaves. The port's ranks are
spawned ``gloo`` CPU processes (``parallel/launch.py``) running
``tests/torch_parallel_ranks.py``; the JAX run is a fresh interpreter, as
``tests/test_resume_sharded.py`` runs it.
"""

import os
import subprocess
import sys

import pytest

from tudocomp_tpu_torch.models.blockcodec import BlockCodec
from tudocomp_tpu_torch.parallel.launch import RanksFailed, run_ranks
from tudocomp_tpu_torch.parallel.pipeline import JOURNAL_MAGIC
import torch_parallel_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: wall-clock limit of one spawn of ranks
LIMIT = 180.0
#: the batch after whose frames rank 0 leaves (of 3)
CRASH_AT = 1

JAX_CRASH = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {root!r})
from tudocomp_tpu.models.blockcodec import BlockCodec
from tudocomp_tpu.parallel.mesh import make_mesh
from tudocomp_tpu.parallel.pipeline import compress_sharded_resumable
compress_sharded_resumable(BlockCodec(), make_mesh(1), {src!r}, {dst!r},
                           batch_segments={batch})
"""


@pytest.fixture(scope="module")
def journal_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("journal")
    (d / "input.bin").write_bytes(ranks.resume_data())
    return d


@pytest.fixture(scope="module")
def one_shot():
    return BlockCodec(device="cpu").compress(ranks.resume_data())


@pytest.fixture(scope="module")
def jax_torn(journal_dir):
    """The container the JAX package's run at mesh size 1 leaves when
    ``TDC_CRASH_AFTER_BATCH`` stops it, beside its journal."""
    dst = journal_dir / "jax.tbc2"
    env = dict(os.environ, TDC_CRASH_AFTER_BATCH=str(CRASH_AT))
    r = subprocess.run(
        [sys.executable, "-c", JAX_CRASH.format(
            root=ROOT, src=str(journal_dir / "input.bin"), dst=str(dst),
            batch=ranks.RESUME_BATCH)],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 17, r.stdout + r.stderr
    return dst


@pytest.fixture(scope="module")
def port_crash(journal_dir):
    """The port's run at world 2 stopped the same way: the exit codes,
    and the container it leaves beside its journal."""
    dst = journal_dir / "port.tbc2"
    with pytest.raises(RanksFailed) as e:
        run_ranks(ranks.journaled, 2, device="cpu",
                  args=(str(journal_dir / "input.bin"), str(dst), False),
                  env={"TDC_CRASH_AFTER_BATCH": str(CRASH_AT)},
                  timeout=LIMIT)
    return e.value.exitcodes, dst


def _journal(dst) -> list:
    with open(str(dst) + ".journal") as f:
        return f.read().splitlines()


def test_crash_exits_17_on_rank_0(port_crash):
    codes, _ = port_crash
    assert codes[0] == 17
    assert codes[1] != 0  # killed where it waited for rank 0


def test_crash_leaves_journal_lines_in_the_jax_format(port_crash,
                                                      one_shot):
    _, dst = port_crash
    data = ranks.resume_data()
    lines = _journal(dst)
    assert lines[0].split() == [JOURNAL_MAGIC, str(-(-len(data) // 2048)),
                                str(len(data)), str(ranks.RESUME_BATCH)]
    assert lines[1].startswith("HIST ") and len(lines[1]) == 5 + 2 * 8 * 256
    header_end = int(lines[2].split()[1])
    assert lines[2] == f"HEADER {header_end}"
    ends = [int(ln.split()[2]) for ln in lines[3:]]
    assert lines[3:] == [f"BATCH {i} {e}" for i, e in enumerate(ends)]
    assert len(ends) == CRASH_AT  # the last batch written is not journaled
    torn = dst.read_bytes()
    assert len(torn) > ends[-1] > header_end
    assert one_shot.startswith(torn)  # a prefix of the one-shot bytes


def test_crash_leaves_the_jax_journal_and_tear(port_crash, jax_torn):
    """Line for line the JAX package's journal (the batch size rounds to
    the same 32 at mesh size 1 and world 2) and the same torn bytes."""
    _, dst = port_crash
    assert _journal(dst) == _journal(jax_torn)
    assert dst.read_bytes() == jax_torn.read_bytes()


def test_resume_after_the_crash_equals_one_shot(port_crash, one_shot):
    _, dst = port_crash
    got = run_ranks(ranks.journaled, 2, device="cpu",
                    args=(str(dst.parent / "input.bin"), str(dst), True),
                    timeout=LIMIT)[0]
    assert got == one_shot
    assert not os.path.exists(str(dst) + ".journal")


def test_port_resumes_the_jax_torn_journal(jax_torn, one_shot):
    """The JAX package's journal and tear at mesh size 1, resumed by the
    port at world size 1."""
    dst = jax_torn.parent / "jax_resumed.tbc2"
    dst.write_bytes(jax_torn.read_bytes())
    (jax_torn.parent / "jax_resumed.tbc2.journal").write_text(
        "\n".join(_journal(jax_torn)) + "\n")
    got = run_ranks(ranks.journaled, 1, device="cpu",
                    args=(str(jax_torn.parent / "input.bin"), str(dst), True),
                    timeout=LIMIT)[0]
    assert got == one_shot
    assert not os.path.exists(str(dst) + ".journal")
