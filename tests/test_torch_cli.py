"""The port's front end (registry, CLI, stats, ``entry()``) against the
JAX package's, on the CPU: the same headers, the same bytes, and each
package's CLI decodes the other's output.

JAX compiles the TBC2 codec once per batch shape and RLE offset, for
long on the CPU, so every JAX ``tbc2`` encode here stays in one shape:
inputs of at most 8 segments at offset 0. The other two cases of
``tests/test_torch_blockcodec.py`` (64 segments, offset 3) are held
against the port's own container, which that file pins to the JAX one,
and the JAX CLI decodes them (on the host, which compiles nothing). The JAX package's ``bwt(device=true)`` runs its host path off
the TPU, so the port's device path (``ops/suffix.py`` on the CPU) is
held against it byte for byte. Every comparison is exact.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__
from tudocomp_tpu import cli as jax_cli
from tudocomp_tpu.io import restrictions as jax_restrictions
from tudocomp_tpu.meta import InputRestrictions as JaxRestrictions
from tudocomp_tpu.models.blockcodec import BlockCodec as JaxCodec
from tudocomp_tpu.registry import REGISTRY as JAX_REGISTRY
from tudocomp_tpu.stats import StatPhase as JaxStatPhase
from tudocomp_tpu_torch import BlockCodec
from tudocomp_tpu_torch import cli
from tudocomp_tpu_torch.entry import entry
from tudocomp_tpu_torch.io.restrictions import (
    build_escape_map, escape, unescape)
from tudocomp_tpu_torch.meta import InputRestrictions
from tudocomp_tpu_torch.registry import REGISTRY
from tudocomp_tpu_torch.stats import StatPhase

from tests.test_torch_blockcodec import CASES

CPU = "cpu"
SEG = 2048


def _algo(opts: dict) -> str:
    if not opts:
        return "tbc2"
    return "tbc2(%s)" % ", ".join(f"{k}={v}" for k, v in opts.items())


def _text(n: int, seed: int) -> bytes:
    """Text with repeats and runs, and no 0 or 255 bytes (so the bwt's
    escaping adds only the sentinel)."""
    rng = np.random.default_rng(seed)
    words = [b"tudocomp ", b"suffix ", b"array ", b"aaaaaaaa ", b"bwt "]
    out = b"".join(words[i] for i in rng.integers(0, len(words), n // 4))
    return out[:n]


@pytest.mark.parametrize("algo", [
    "tbc2", "tbc2(offset=3, min_code_len=4)", "tbc2(dec=host)",
    "bwt", "bwt(device=true)", "chain(bwt, tbc2)",
    "blocks(tbc2)", "blocks(inner=chain(bwt, tbc2), b=65536)",
    "blocks(bwt, b=4096, workers=3)",
])
def test_id_string_matches_jax(algo):
    port = REGISTRY.evaluate(algo, torch_device=CPU)
    assert port.id_string() == JAX_REGISTRY.evaluate(algo).id_string()
    assert port.torch_device == CPU


def test_default_headers():
    assert (REGISTRY.evaluate("tbc2").id_string()
            == "tbc2(offset=0, min_code_len=3, dec=auto)")
    assert REGISTRY.evaluate("bwt").id_string() == "bwt(device=false)"
    chain = cli._instantiate("bwt:tbc2", blocks=1 << 20, threads=4,
                             device=CPU)
    assert chain.env.id_string() == (
        "blocks(inner=chain(first=bwt(device=false), second=tbc2(offset=0, "
        "min_code_len=3, dec=auto)), b=1048576)")
    # the device reaches every algorithm of the tree
    assert chain.env.env_for_option("inner").env_for_option(
        "second").torch_device == CPU


#: the cases in the JAX codec's one shape here: <= 8 segments, offset 0
SMALL = [name for name, (data, opts) in CASES.items()
         if len(data) <= 8 * SEG and not opts.get("offset")]


@pytest.mark.parametrize("name", list(CASES))
def test_tbc2_cli_matches_jax(name):
    data, opts = CASES[name]
    algo = _algo(opts)
    out = cli.compress(algo, data, device=CPU)
    header = JAX_REGISTRY.evaluate(algo).id_string().encode() + b"%"
    assert out == header + BlockCodec(device=CPU, **opts).compress(data)
    assert jax_cli.decompress(out) == data
    assert cli.decompress(out, device=CPU) == data
    if name in SMALL:
        jax_out = jax_cli.compress(algo, data)
        assert out == jax_out
        assert cli.decompress(jax_out, device=CPU) == data


@pytest.mark.parametrize("dec", ["auto", "pallas", "scan", "host"])
def test_tbc2_dec_values_round_trip(dec):
    data, _ = CASES["mixed_5seg"]
    out = cli.compress(f"tbc2(dec={dec})", data, device=CPU)
    assert out.startswith(f"tbc2(offset=0, min_code_len=3, dec={dec})%"
                          .encode())
    assert cli.decompress(out, device=CPU) == data


def test_tbc2_rejects_a_dec_value_jax_lacks():
    with pytest.raises(ValueError, match="dec must be one of"):
        cli.compress("tbc2(dec=cuda)", b"abc", device=CPU)


def test_tdc_min_code_len_overrides_the_option(monkeypatch):
    """Under ``TDC_MIN_CODE_LEN`` both packages write the same container,
    that of ``min_code_len`` set to the variable (clamped to 3..8)."""
    data = _text(12000, seed=1)  # 6 segments
    monkeypatch.delenv("TDC_MIN_CODE_LEN", raising=False)
    want = {n: BlockCodec(device=CPU, min_code_len=n).compress(data)
            for n in (3, 4, 8)}
    assert want[4] != want[3]
    for env, n in (("4", 4), ("9", 8), ("1", 3)):
        monkeypatch.setenv("TDC_MIN_CODE_LEN", env)
        assert BlockCodec(device=CPU).compress(data) == want[n]
        assert BlockCodec(device=CPU, min_code_len=5).compress(data) \
            == want[n]
    monkeypatch.setenv("TDC_MIN_CODE_LEN", "4")
    assert JaxCodec().compress(data) == want[4]
    assert cli.compress("tbc2", data, device=CPU) == jax_cli.compress(
        "tbc2", data)


@pytest.mark.parametrize("algo,n", [
    ("bwt", 5000),
    ("bwt(device=true)", 40 << 10),
    ("bwt:tbc2", 12 << 10),
])
def test_bwt_cli_matches_jax(algo, n):
    data = _text(n, seed=n)
    out = cli.compress(algo, data, device=CPU)
    jax_out = jax_cli.compress(algo, data)
    assert out == jax_out
    assert cli.decompress(jax_out, device=CPU) == data
    assert jax_cli.decompress(out) == data


def test_device_bwt_then_tbc2_equals_host_bwt_then_tbc2():
    """``bwt(device=true):tbc2`` on 40 KiB: the device path's payload
    equals the host path's, and the JAX CLI decodes it."""
    data = _text(40 << 10, seed=7)
    dev = cli.compress("bwt(device=true):tbc2", data, device=CPU)
    host = cli.compress("bwt:tbc2", data, device=CPU)
    head_dev, payload_dev = dev.split(b"%", 1)
    head_host, payload_host = host.split(b"%", 1)
    assert head_dev == head_host.replace(b"device=false", b"device=true")
    assert payload_dev == payload_host
    assert cli.decompress(dev, device=CPU) == data
    assert jax_cli.decompress(dev) == data


def _escape_cases():
    dna = np.random.default_rng(1).choice(
        np.frombuffer(b"ACGTN", np.uint8), 5000).tobytes()
    noise = np.random.default_rng(2).integers(0, 256, 8192,
                                              np.uint8).tobytes()
    sentinel = ((), True)
    return {
        "none": (b"ab\x00c\xff", ((), False)),
        "none_empty": (b"", ((), False)),
        "sentinel_clean": (dna, sentinel),
        "sentinel_dirty": (b"\x00a\xffb\x00\x00\xfe" + dna, sentinel),
        "sentinel_empty": (b"", sentinel),
        "lz78u": (noise, ((0,), True)),
        "lz78u_clean": (dna, ((0,), True)),
        "set_with_255": (noise, ((255, 254, 192), False)),
        "set_with_255_clean": (dna, ((255, 254), False)),
        "runs_of_E": (b"\xff\xffa\xff\xff\xff\x00b\xff\xff", sentinel),
        "E_before_sentinel": (dna + b"\xff", sentinel),
        "E_alone": (b"\xff", sentinel),
    }


ESCAPE_CASES = _escape_cases()


@pytest.mark.parametrize("kind", ["bytes", "bytearray", "memoryview"])
@pytest.mark.parametrize("name", list(ESCAPE_CASES))
def test_escape_matches_jax_and_counts(name, kind):
    """``escape``/``unescape`` give the JAX package's bytes and the
    input back; ``front.escape`` counts the restricted bytes found and
    ``front.unescape`` the pairs it resolved (0 on the clean inputs,
    whose output is the input, plus the sentinel)."""
    data, (esc_bytes, null) = ESCAPE_CASES[name]
    restr = InputRestrictions(esc_bytes, null)
    given = {"bytes": bytes, "bytearray": bytearray,
             "memoryview": memoryview}[kind](data)
    with StatPhase("case") as root:
        out = escape(given, restr)
        back = unescape(out, restr)
    want = jax_restrictions.escape(data, JaxRestrictions(esc_bytes, null))
    assert type(out) is bytes and out == want
    assert back == data
    assert jax_restrictions.unescape(
        out, JaxRestrictions(esc_bytes, null)) == data
    em = build_escape_map(restr)
    found = 0 if em is None else sum(data.count(bytes((b,))) for b in em[0])
    if name.endswith(("clean", "empty")) or name == "none":
        assert found == 0
        assert out == data + b"\x00" * null
    if kind == "bytes" and em is None:
        assert out is data
    enc, dec = root.children
    assert enc.stats == {"bytes_in": len(data), "bytes_out": len(out),
                         "escaped": found}
    assert dec.stats == {"bytes_in": len(out), "bytes_out": len(data),
                         "pairs": found}


@pytest.mark.parametrize("esc_bytes", [(), (0,)])
def test_unescape_without_the_sentinel_fails(esc_bytes):
    for fn, restr in ((unescape, InputRestrictions(esc_bytes, True)),
                      (jax_restrictions.unescape,
                       JaxRestrictions(esc_bytes, True))):
        with pytest.raises(ValueError, match="missing sentinel"):
            fn(b"ACGT", restr)


def _main(argv):
    return cli.main([*argv, "--device", CPU])


def test_blocks_cli_matches_jax_and_resumes(tmp_path):
    src = tmp_path / "in.bin"
    data = _text(13000, seed=3)
    src.write_bytes(data)
    port_out, jax_out = tmp_path / "port.tdc", tmp_path / "jax.tdc"
    args = [str(src), "-a", "tbc2", "--blocks", "4Ki", "-f"]
    assert _main([*args, "-o", str(port_out)]) == 0
    assert jax_cli.main([*args, "-o", str(jax_out)]) == 0
    full = port_out.read_bytes()
    assert full == jax_out.read_bytes()
    assert full.startswith(
        b"blocks(inner=tbc2(offset=0, min_code_len=3, dec=auto), b=4096)%TBK1")
    for out, main in ((port_out, _main), (jax_out, jax_cli.main)):
        dec = tmp_path / (out.name + ".dec")
        assert main([str(out), "-d", "-f", "-o", str(dec)]) == 0
        assert dec.read_bytes() == data
    dec = tmp_path / "cross.dec"
    assert jax_cli.main([str(port_out), "-d", "-f", "-o", str(dec)]) == 0
    assert dec.read_bytes() == data

    port_out.write_bytes(full[: len(full) // 2])  # tear mid-frame
    assert _main([str(src), "-a", "tbc2", "--blocks", "4Ki", "--resume",
                  "-o", str(port_out)]) == 0
    assert port_out.read_bytes() == full


@pytest.mark.parametrize("threads", [2, 16])
def test_blocks_threads_write_the_frames_of_one_thread(tmp_path, threads):
    """More threads than cores, switching often: the frames still come
    out in order and equal those of one thread."""
    src = tmp_path / "in.bin"
    data = _text(72000, seed=4)  # 18 blocks
    src.write_bytes(data)
    one, many = tmp_path / "one.tdc", tmp_path / "many.tdc"
    args = [str(src), "-a", "bwt:tbc2", "--blocks", "4Ki", "-f"]
    assert _main([*args, "-o", str(one)]) == 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        assert _main([*args, "--threads", str(threads), "-o",
                      str(many)]) == 0
        dec = tmp_path / "many.dec"
        assert _main([str(many), "-d", "-f", "--threads", str(threads),
                      "-o", str(dec)]) == 0
    finally:
        sys.setswitchinterval(interval)
    assert many.read_bytes() == one.read_bytes()
    assert dec.read_bytes() == data


def test_generator_input_matches_jax(tmp_path):
    port_out, jax_out = tmp_path / "port.tdc", tmp_path / "jax.tdc"
    assert _main(["-g", "fib(10)", "-a", "bwt", "-o", str(port_out)]) == 0
    assert jax_cli.main(["-g", "fib(10)", "-a", "bwt", "-o",
                         str(jax_out)]) == 0
    assert port_out.read_bytes() == jax_out.read_bytes()
    assert cli.generate("fib(10)") == jax_cli.generate("fib(10)")
    assert cli.generate("random(100, 7)") == jax_cli.generate(
        "random(100, 7)")


def test_list_shows_the_port_registry(capsys):
    assert cli.main(["-l"]) == 0
    out = capsys.readouterr().out
    for name in ("tbc2", "bwt", "chain", "blocks", "lzss_lcp", "bit",
                 "huff", "fib", "thue_morse"):
        assert f"  {name}" in out
    # every family is ported: the listing equals the JAX CLI's line for
    # line
    assert jax_cli.main(["-l"]) == 0
    assert out.splitlines() == capsys.readouterr().out.splitlines()


def test_stats_json_has_the_jax_keys(tmp_path, capsys):
    src = tmp_path / "in.bin"
    src.write_bytes(_text(6000, seed=5))
    assert _main([str(src), "-a", "tbc2", "-f", "--stats", "roundtrip"]) == 0
    err = capsys.readouterr().err
    tree = json.loads(err[err.index("{"): err.rindex("}") + 1])
    with JaxStatPhase("jax") as jax_root:
        pass
    keys = set(jax_root.to_json())
    assert set(tree) == keys
    assert tree["title"] == "roundtrip" and tree["memPeak"] > 0
    (phase,) = tree["sub"]
    assert phase["title"] == "compress" and set(phase) == keys
    assert phase["devMemPeak"] == 0  # no CUDA here: never initialised
    with StatPhase("a") as root:
        with StatPhase("b") as b:
            b.log_stat("factors", 42)
    assert root.to_json()["sub"][0]["stats"] == [
        {"key": "factors", "value": 42}]


def test_port_cli_runs_without_jax(tmp_path):
    """The port's CLI round trip loads neither JAX nor the JAX package."""
    src = tmp_path / "in.bin"
    src.write_bytes(_text(40 << 10, seed=6))
    code = (
        "import sys\n"
        "from tudocomp_tpu_torch import cli\n"
        f"src = {str(src)!r}\n"
        "for algo in ('bwt(device=true):tbc2', 'tbc2'):\n"
        "    assert cli.main([src, '-a', algo, '-f', '-o', src + '.tdc',\n"
        "                     '--device', 'cpu']) == 0\n"
        "    assert cli.main([src + '.tdc', '-d', '-f', '-o', src + '.out',\n"
        "                     '--device', 'cpu']) == 0\n"
        "    assert open(src + '.out', 'rb').read() == open(src, 'rb').read()\n"
        "loaded = [m for m in sys.modules\n"
        "          if m.split('.')[0] in ('jax', 'jaxlib', 'tudocomp_tpu')]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_cuda_is_the_default_device(tmp_path, capsys):
    """Without ``--device cpu``, tbc2 and the device BWT need CUDA and
    fail where it is absent; the host BWT runs."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    src = tmp_path / "in.bin"
    src.write_bytes(_text(40 << 10, seed=8))
    for algo in ("tbc2", "bwt(device=true)", "bwt:tbc2"):
        assert cli.main([str(src), "-a", algo, "-f"]) == 1
        assert "CUDA is not available" in capsys.readouterr().err
    assert cli.main([str(src), "-a", "bwt", "-f"]) == 0
    assert cli.main([str(src) + ".tdc", "-d", "-f"]) == 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.compress("tbc2", b"abc")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_entry_matches_graft_entry():
    fn, args = entry(device=CPU)
    words, bits, hist = fn(*args)
    jfn, jargs = __graft_entry__.entry()
    jwords, jbits, jhist = (np.asarray(a) for a in jfn(*jargs))
    for got, want in zip(args, jargs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert words.shape == (8, 512) and words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  jwords.view(np.uint32))
    np.testing.assert_array_equal(bits.numpy(), jbits)
    np.testing.assert_array_equal(hist.numpy(), jhist)
