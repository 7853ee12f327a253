"""``tdc``-equivalent CLI driver of the torch port:
``python -m tudocomp_tpu_torch.cli``.

Reference counterpart: ``src/tudocomp_driver/tudocomp_driver.cpp`` +
``tudocomp_driver/Options.hpp``. Flags (same names where they exist):

  -a/--algorithm ALGO   algorithm string, e.g. "lzss_lcp(coder=huff)";
                        chain sugar "bwt:rle:mtf:encode(huff)" works
  -d/--decompress       decompress (reads the self-describing header)
  --raw                 omit/skip the header
  -o/--output FILE      output path (default: INPUT.tdc / INPUT.decomp)
  -f/--force            overwrite output
  -g/--generator G      generate input, e.g. "fib(10)" | "thue_morse(5)"
                        | "random(100, 42)" | "run_rich(8)"
  -l/--list             list registered algorithms
  --stats[=TITLE]       print a StatPhase JSON tree to stderr
  --usestdin/--usestdout  stream via stdio
  --loglevel/--logdir/--logverbosity  logging (utils/log.py; also the
                        TDC_LOGLEVEL/TDC_LOGDIR/TDC_LOGVERBOSITY variables)
  --device {cuda,cpu}   torch device of the device stages (default cuda;
                        raises where CUDA is absent, nothing falls back)

Compressed container: ``<algorithm-id-string>%<payload>`` exactly like
the reference (``tudocomp_driver.cpp:30,262-266``); the driver applies
declared input restrictions (escaping + null sentinel) outside the
compressor, mirroring ``tudocomp_driver.cpp:268-270``.

The port's counterpart of ``tudocomp_tpu/cli.py``: the same flags and
headers, over the port's registry (every family of the JAX package,
so ``-l`` prints the same listing), so that each package's CLI decodes
the other's output. A file compressed by an algorithm that streams
(``noop``, ``rle``, ``mtf``, ``lzss``, ``lz78``, ``lzw``) goes one pass
in constant memory, with the buffered path's bytes. The torch device is a run-time argument
(``device``, ``--device``), never part of the algorithm string.
"""

from __future__ import annotations

import argparse
import sys

from tudocomp_tpu_torch import __version__
from tudocomp_tpu_torch import compressors as _register  # noqa: F401
from tudocomp_tpu_torch.algostr import Node, parse_chain
from tudocomp_tpu_torch.io.restrictions import escape, unescape
from tudocomp_tpu_torch.registry import REGISTRY
from tudocomp_tpu_torch.stats import StatPhase

MAX_HEADER = 1024  # sanity cap while scanning for '%' (ref :293-307)


def _instantiate(algostring: str, blocks: int | None = None,
                 threads: int = 1, device="cuda"):
    """Instantiate on the torch ``device``, folding ``a:b:c`` chain sugar
    into nested chain() (reference ``tudocomp_driver_tests.cpp:211-233``).
    ``blocks`` wraps the whole chain in the constant-memory block
    container; ``threads`` compresses that many blocks concurrently."""
    with StatPhase("front.instantiate"):
        nodes = parse_chain(algostring)
        node = nodes[0]
        for nxt in nodes[1:]:
            node = Node("chain", [("first", node), ("second", nxt)])
        if blocks is not None:
            node = Node("blocks", [
                ("inner", node), ("b", str(blocks)),
                ("workers", str(max(1, threads))),
            ])
        elif threads > 1 and node.name == "blocks":
            # runtime knob on an existing block container (e.g.
            # decompress of a self-describing header, which never
            # persists `workers`)
            node = Node(node.name, [
                kv for kv in node.args if kv[0] != "workers"
            ] + [("workers", str(threads))])
        return REGISTRY.instantiate(node, torch_device=device)


def parse_size(s: str) -> int:
    """``16M``/``16Mi``/``1G``/``4096`` -> bytes (K/M/G binary)."""
    m = {"k": 10, "m": 20, "g": 30}
    t = s.strip().lower().removesuffix("i")
    if t and t[-1] in m:
        return int(float(t[:-1]) * (1 << m[t[-1]]))
    return int(t)


def compress(
    algostring: str, data: bytes, raw: bool = False,
    blocks: int | None = None, device="cuda",
) -> bytes:
    with StatPhase("compress") as phase:
        comp = _instantiate(algostring, blocks, device=device)
        restr = REGISTRY.restrictions_of(comp.env)
        out = comp.compress(escape(data, restr))
        if not raw:
            with StatPhase("front.frame") as frame:
                out = comp.env.id_string().encode() + b"%" + out
                frame.log_stat("bytes", len(out))
        phase.log_stat("bytes_in", len(data))
        phase.log_stat("bytes_out", len(out))
    return out


def decompress(
    data: bytes, raw_algo: str | None = None, device="cuda"
) -> bytes:
    with StatPhase("decompress") as phase:
        with StatPhase("front.unframe") as frame:
            algostring, payload = _unframe(data, raw_algo)
            frame.log_stat("bytes", len(payload))
        comp = _instantiate(algostring, device=device)
        restr = REGISTRY.restrictions_of(comp.env)
        out = unescape(comp.decompress(payload), restr)
        phase.log_stat("bytes_in", len(data))
        phase.log_stat("bytes_out", len(out))
    return out


def _unframe(data: bytes, raw_algo: str | None) -> tuple[str, bytes]:
    """The algorithm string and the payload of a container: ``raw_algo``
    and all of ``data`` for a headerless one."""
    if raw_algo is not None:
        return raw_algo, bytes(data)
    sep = data.find(b"%", 0, MAX_HEADER)
    if sep < 0:
        raise ValueError("no algorithm header found (use --raw -a ALGO?)")
    try:
        # headers are ASCII algorithm strings; garbage bytes that happen
        # to contain '%' must error cleanly, not crash (reference scan
        # cap + error: tudocomp_driver.cpp:293-307)
        algostring = data[:sep].decode("ascii")
    except UnicodeDecodeError:
        raise ValueError(
            "no algorithm header found (use --raw -a ALGO?)"
        ) from None
    return algostring, bytes(data[sep + 1 :])


def _stream_main(args, p) -> int | None:
    """Constant-memory file paths: ``--blocks`` compression and
    block-container decompression stream one block at a time instead of
    materializing input + output (peak RSS is O(block size)), and the
    streaming compressors (``supports_streaming``) compress and
    decompress in one pass. Returns an exit code, or None to take the
    buffered path."""
    import os

    if args.usestdin or args.generator or not args.input:
        return None

    def _stats():
        if args.stats is not None:
            print(root.to_json_str(), file=sys.stderr)

    def _report(out_path):
        _stats()
        a = os.path.getsize(args.input)
        b = os.path.getsize(out_path)
        print(
            f"{a} -> {b} bytes ({100.0 * b / max(1, a):.2f}%)",
            file=sys.stderr,
        )

    root = StatPhase(
        args.stats or "root", track_memory=args.stats is not None
    )
    if args.decompress:
        if args.blocks:
            p.error(
                "--blocks applies to compression "
                "(block containers self-describe on decode)"
            )
        with open(args.input, "rb") as f:
            head = f.read(MAX_HEADER)
        if args.raw and args.algorithm:
            algostring, off = args.algorithm, 0
        else:
            sep = head.find(b"%")
            if sep < 0:
                return None
            try:
                algostring, off = head[:sep].decode("ascii"), sep + 1
            except UnicodeDecodeError:
                # garbage header bytes: let the buffered path raise the
                # clean "no algorithm header found" error (ref behavior,
                # tudocomp_driver.cpp:293-307)
                return None
        comp = _instantiate(algostring, threads=args.threads,
                            device=args.device)
        if not hasattr(comp, "decompress_stream"):
            return None  # buffered path handles non-block containers
        out_path = args.output or (args.input + ".decomp")
        if (
            not args.usestdout and os.path.exists(out_path)
            and not args.force
        ):
            print(
                f"output {out_path} exists (use -f to overwrite)",
                file=sys.stderr,
            )
            return 1
        with open(args.input, "rb") as fin:
            fin.seek(off)
            if args.usestdout:
                with root:
                    comp.decompress_stream(fin, sys.stdout.buffer)
                _stats()
            else:
                with open(out_path, "wb") as fout, root:
                    comp.decompress_stream(fin, fout)
                _report(out_path)
        return 0

    if not args.algorithm:
        if args.blocks:
            p.error("-a ALGORITHM required for compression")
        return None
    if args.blocks:
        comp = _instantiate(args.algorithm, blocks=parse_size(args.blocks),
                            threads=args.threads, device=args.device)
    else:
        # one-pass streaming compressors: O(chunk) memory without the
        # blocks wrapper, reference as_stream() parity
        # (io/Input.hpp:199-208); the output equals the buffered
        # path's, so files take it by default. --resume and input
        # restrictions (escaping, a sentinel) need the buffered path
        comp = _instantiate(args.algorithm, device=args.device)
        if not getattr(comp, "supports_streaming", False) \
                or args.resume \
                or REGISTRY.restrictions_of(comp.env).has_restrictions:
            return None
    header = b"" if args.raw else comp.env.id_string().encode() + b"%"
    if args.usestdout:
        with open(args.input, "rb") as fin, root:
            sys.stdout.buffer.write(header)
            comp.compress_stream(fin, sys.stdout.buffer)
        _stats()
        return 0
    out_path = args.output or (args.input + ".tdc")
    exists = os.path.exists(out_path) and os.path.getsize(out_path) > 0
    if exists and not (args.force or args.resume):
        print(
            f"output {out_path} exists (use -f to overwrite)",
            file=sys.stderr,
        )
        return 1
    resume = args.resume and exists
    with open(args.input, "rb") as fin, \
            open(out_path, "r+b" if resume else "wb") as fout, root:
        if resume:
            if fout.read(len(header)) != header:
                print(
                    "--resume: existing output was written with a "
                    "different algorithm header",
                    file=sys.stderr,
                )
                return 1
            comp.compress_stream(fin, fout, resume=True)
        else:
            fout.write(header)
            comp.compress_stream(fin, fout)
    _report(out_path)
    return 0


def generate(genstring: str) -> bytes:
    """Instantiate a registered generator from its algorithm string
    (reference tudocomp_driver.cpp -g handling; generators are regular
    registry modules)."""
    return REGISTRY.instantiate(genstring, type="generator").generate()


def main(argv=None) -> int:
    """Parse args and run; any failure prints ``error: ...`` and exits 1
    like the reference driver's catch-all (tudocomp_driver.cpp:392-395)."""
    p, args = _parse_args(argv)
    try:
        return _run(p, args)
    except Exception as e:  # noqa: BLE001 — reference catches std::exception
        print(f"error: {e}", file=sys.stderr)
        return 1


def _parse_args(argv):
    p = argparse.ArgumentParser(
        prog="python -m tudocomp_tpu_torch.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("input", nargs="?", help="input file")
    p.add_argument("-a", "--algorithm")
    p.add_argument("-d", "--decompress", action="store_true")
    p.add_argument("--raw", action="store_true")
    p.add_argument("-o", "--output")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-g", "--generator")
    p.add_argument("-l", "--list", action="store_true")
    p.add_argument(
        "--version", action="version",
        version=f"tudocomp-tpu-torch {__version__}",
    )
    p.add_argument("--stats", nargs="?", const="STATS", default=None)
    p.add_argument("--usestdin", action="store_true")
    p.add_argument("--usestdout", action="store_true")
    p.add_argument("--loglevel", default=None,
                   help="logging level (debug/info/warning/error)")
    p.add_argument("--logdir", default=None,
                   help="write a per-run log file into this directory")
    p.add_argument("--logverbosity", type=int, default=None,
                   help="VLOG verbosity gate (glog-style)")
    p.add_argument("--threads", type=int, default=1,
                   help="with --blocks: compress/decompress this many "
                        "blocks concurrently (host threads)")
    p.add_argument(
        "--blocks", metavar="SIZE",
        help="compress block-wise (constant memory, restartable); "
        "SIZE like 16M, 64Mi, 1G",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="with --blocks: continue a partial output file after the "
        "last complete block frame",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="torch device of the device stages (default cuda; raises "
        "where CUDA is absent, see tudocomp_tpu_torch/device.py)",
    )
    args = p.parse_args(argv)
    return p, args


def _run(p, args) -> int:
    from tudocomp_tpu_torch.utils.log import configure as _log_configure

    _log_configure(args.loglevel, args.logdir, args.logverbosity)

    if args.list:
        print(REGISTRY.doc_listing())
        return 0

    rc = _stream_main(args, p)
    if rc is not None:
        return rc

    # -- input ---------------------------------------------------------------
    if args.generator:
        data = generate(args.generator)
    elif args.usestdin:
        data = sys.stdin.buffer.read()
    elif args.input:
        from tudocomp_tpu_torch.io.input import Input

        data = Input(args.input).as_bytes()  # mmap-backed read
    else:
        p.error("no input (file, --usestdin, or -g)")

    # --stats enables memory tracking like the reference's malloc
    # override (tracemalloc costs ~2x time, so it's opt-in via the flag)
    root = StatPhase(
        args.stats or "root", track_memory=args.stats is not None
    )
    with root:
        if args.decompress:
            out = decompress(
                data, args.algorithm if args.raw else None,
                device=args.device,
            )
            default_suffix = ".decomp"
        else:
            if not args.algorithm:
                p.error("-a ALGORITHM required for compression")
            out = compress(
                args.algorithm, data, raw=args.raw,
                blocks=parse_size(args.blocks) if args.blocks else None,
                device=args.device,
            )
            default_suffix = ".tdc"

    # -- output --------------------------------------------------------------
    if args.usestdout:
        sys.stdout.buffer.write(out)
    else:
        path = args.output
        if not path:
            if not args.input:
                p.error("-o required with --usestdin")
            path = args.input + default_suffix
        import os

        if os.path.exists(path) and not args.force:
            print(
                f"output {path} exists (use -f to overwrite)",
                file=sys.stderr,
            )
            return 1
        with open(path, "wb") as f:
            f.write(out)

    if args.stats is not None:
        print(root.to_json_str(), file=sys.stderr)
    if not args.usestdout:
        ratio = 100.0 * len(out) / max(1, len(data))
        print(
            f"{len(data)} -> {len(out)} bytes ({ratio:.2f}%)",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
