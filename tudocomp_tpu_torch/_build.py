"""Build and bind the port's native code.

Two shared libraries with a plain C interface, loaded with ``ctypes``:

- the CUDA kernels (``csrc/*.cu``), compiled by ``nvcc`` for ``sm_90a``;
- the host TBC2 parser and decoder, suffix array, BWT decode, LZ77
  (factorizer, PLCP, factor-stream decode), lcpcomp (factorizers,
  compact decode), SLE coder, ESP (round loop, SLP derivation and
  dependency sort, monotone decomposition) and the literal-stream
  kernels (MTF, chunked RLE decode, Huffman count, arithmetic coder),
  the sliding-window LZSS, LZ78 and LZW (parses, decoders, one-pass
  stream handles), Re-Pair, LZ78U, the suffix tree and LFS
  (``csrc/host/*.cpp`` with their shared ``*.hpp``), compiled by the
  host C++ compiler.

Each is built at first use, from the package's own sources, into
``csrc/build/`` (git-ignored), and is keyed by a hash of its sources and
flags so a stale library is never loaded. A failed build raises: there
is no fallback path.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(_CSRC, "build")
_SO = os.path.join(_BUILD_DIR, "libtdc_kernels.so")
_HOST_SO = os.path.join(_BUILD_DIR, "libtdc_host.so")

#: compile flags (each source is compiled with -c, then linked -shared)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)
HOST_FLAGS = ("-std=c++17", "-O3", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64

#: CUDA entry points: name -> argtypes (pointers and the stream as
#: void*, ints as int). Each returns cudaGetLastError() after its launch.
_SIGNATURES = {
    # rows, lens, words_out, rle_lens_out, nc, offset, stream
    "tdc_rle_pack": [_P, _P, _P, _P, _I, _I, _P],
    # rows, lens, sel_out, counts_out, rle_raw_out, nc, offset, stream
    "tdc_rle_select": [_P, _P, _P, _P, _P, _I, _I, _P],
    # words_in, counts, sym_code, sym_len, words_out, bits_out, nc, stream
    "tdc_huff_pack": [_P, _P, _P, _P, _P, _P, _I, _P],
    # words_in, counts, sym_code, sym_len, words_out, bits_out,
    # huff_raw_out, nc, stream
    "tdc_huff_select": [_P, _P, _P, _P, _P, _P, _P, _I, _P],
    # words, lens, hist_out, rows, stream
    "tdc_hist": [_P, _P, _P, _I, _P],
    # words (first row), lens (first row), hist_out (i64), rows, stride,
    # stream
    "tdc_hist_rows": [_P, _P, _P, _I, _I, _P],
    # flat, poff, pbytes, counts, flags, thresh, offs, symbols, fast,
    # out, nseg, flat_len, orig_len, offset, stream
    "tdc_hufdec": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _I,
                   _P],
    # values, lens, words_out, bits_out, scratch, chunks, n, cap, stream
    "tdc_pack_tokens_chunks": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # data, lengths, sym_code, sym_len, words_out, bits_out, scratch,
    # chunks, n, cap, stream
    "tdc_pack_huffman_chunks": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # data, lengths, words_out, bytes_out, scratch, chunks, n, cap,
    # offset, stream
    "tdc_rle_pack_chunks": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # the stage probes (``probes/``):
    # data, counts, sym_code, sym_len, words_out, bits_out, nc, stage,
    # bytes_input, stream
    "tdc_huff_pack_stage": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # rows, words_out, sums_out, nc, copy, vec16, group, stream
    "tdc_probe_floor": [_P, _P, _P, _I, _I, _I, _I, _P],
    # rows, words_out, bits_out, nc, strategy, stride, stream
    "tdc_probe_place": [_P, _P, _P, _I, _I, _I, _P],
    # words, meta1, pbytes, offs (i64), out, nc, stream
    "tdc_frame_pack": [_P, _P, _P, _P, _P, _I, _P],
}

#: host entry points (``csrc/host/*.cpp``): name -> argtypes; each
#: returns int64
_HOST_SIGNATURES = {
    # payload, payload_len, count, lut_sym, lut_len, k, out
    "tdc_huffman_decode": [_P, _L, _L, _P, _P, _I, _P],
    # data, n, pos, nseg, counts, flags, poff, pbytes
    "tdc_tbc2_parse": [_P, _L, _L, _L, _P, _P, _P, _P],
    # data, counts, flags, poff, pbytes, lo, hi, lut_sym, lut_len, k,
    # seg, orig_len, offset, out
    "tdc_tbc2_decode": [_P, _P, _P, _P, _P, _L, _L, _P, _P, _I, _L, _L,
                        _L, _P],
    # text, n, sa (i32 / i64)
    "tdc_suffix_array_sais32": [_P, _L, _P],
    "tdc_suffix_array_sais": [_P, _L, _P],
    # bwt, out, n
    "tdc_bwt_decode": [_P, _P, _L],
    # sa, isa, lcp, n, threshold, out_pos, out_src, out_len, cap
    # (i64 / i32 arrays)
    "tdc_lzss_lcp_factorize": [_P, _P, _P, _L, _L, _P, _P, _P, _L],
    "tdc_lzss_lcp_factorize32": [_P, _P, _P, _L, _L, _P, _P, _P, _L],
    # text, phi, n, plcp (i64 / i32)
    "tdc_plcp": [_P, _P, _L, _P],
    "tdc_plcp32": [_P, _P, _L, _P],
    # payload, nbits, start_bit, n, flen_min, w_src, w_len, w_dist,
    # lut_sym, lut_len, k, mode, code_kind, out, out_cap, fpos, fsrc,
    # flen, fcap, nfac_out
    "tdc_lzss_decode": [_P, _L, _L, _L, _L, _I, _I, _I, _P, _P, _I, _I,
                        _I, _P, _L, _P, _P, _P, _L, _P],
    # payload, nbits, pos, kind, out, cap
    "tdc_vlc_literals": [_P, _L, _L, _I, _P, _L],
    # (``csrc/host/lcpcomp.cpp``) sa, isa, lcp (mutated), n, threshold,
    # out_pos, out_src, out_len, cap (i64 / i32 arrays)
    "tdc_lcpcomp_arrays": [_P, _P, _P, _L, _L, _P, _P, _P, _L],
    "tdc_lcpcomp_arrays32": [_P, _P, _P, _L, _L, _P, _P, _P, _L],
    "tdc_lcpcomp_heap": [_P, _P, _P, _L, _L, _P, _P, _P, _L],
    "tdc_lcpcomp_heap32": [_P, _P, _P, _L, _L, _P, _P, _P, _L],
    # n, lit_bytes, lit_pos, nlit, fpos, fsrc, flen, nfac, out
    "tdc_lcpcomp_compact": [_L, _P, _P, _L, _P, _P, _P, _L, _P],
    # sa, lcp (i64), n, threshold, fpos, fsrc, flen, fcap
    "tdc_lcpcomp_bulldozer": [_P, _P, _L, _L, _P, _P, _P, _L],
    # (``csrc/host/sle.cpp``) chars, n, kk, kmer_keys_out, max_kmers,
    # lits_out, max_lits, n_lits_out
    "tdc_sle_rank": [_P, _L, _I, _P, _L, _P, _L, _P],
    # buf, n, limit, sorted_keys, key_rank, n_kmers, kk, lit_rank,
    # values, lens, cap, ntok_inout
    "tdc_sle_run_tokens": [_P, _L, _L, _P, _P, _L, _I, _P, _P, _P, _L,
                           _P],
    # payload, nbits, start_bit, kmers, n_kmers, kk, lits, n_lits, out,
    # out_cap
    "tdc_sle_decode": [_P, _L, _L, _P, _L, _I, _P, _L, _P, _L],
    # text, n, fpos, fsrc, flen, nfac, w_src, w_len, w_dist, flen_min,
    # sorted_keys, key_rank, n_kmers, kk, lit_rank, values, lens, cap
    "tdc_factor_stream_sle": [_P, _L, _P, _P, _P, _L, _I, _I, _I, _L, _P,
                              _P, _L, _I, _P, _P, _P, _L],
    # payload, nbits, start_bit, n, flen_min, w_src, w_len, w_dist,
    # kmers, n_kmers, kk, lits, n_lits, mode, out, out_cap, fpos, fsrc,
    # flen, fcap, nfac_out
    "tdc_lzss_decode_sle": [_P, _L, _L, _L, _L, _I, _I, _I, _P, _L, _I, _P,
                            _L, _I, _P, _L, _P, _P, _P, _L, _P],
    # (``csrc/host/tbc2.cpp``) in, n, out, out_cap, offset
    "tdc_rle_decode": [_P, _L, _P, _L, _L],
    # (``csrc/host/esp.cpp``) text, n, rules_out (i32 pairs), rules_cap,
    # root_out
    "tdc_esp_rounds": [_P, _L, _P, _L, _P],
    # pairs, nrules, root, out, out_cap
    "tdc_slp_derive": [_P, _L, _L, _P, _L],
    # rules, n, root, out, new_root_out
    "tdc_slp_dep_sort": [_P, _L, _L, _P, _P],
    # sis, n, dpi_out, b_out, b_cap
    "tdc_monotone_decompose": [_P, _L, _P, _P, _L],
    # (``csrc/host/literal.cpp``) in, out, n (and the carried table)
    "tdc_mtf_encode": [_P, _P, _L],
    "tdc_mtf_decode": [_P, _P, _L],
    "tdc_mtf_encode_s": [_P, _P, _L, _P],
    "tdc_mtf_decode_s": [_P, _P, _L, _P],
    # in, n, out, out_cap, offset, prev_io, final_chunk, consumed_out
    "tdc_rle_decode_s": [_P, _L, _P, _L, _L, _P, _I, _P],
    # payload, nbits, lut_len, k
    "tdc_huffman_count": [_P, _L, _P, _I],
    # data, n, cum (u64[256]), total, out_codes, cap
    "tdc_arith_encode": [_P, _L, _P, ctypes.c_uint64, _P, _L],
    # payload, nbits, start_bit, syms, cums, sigma, total, count, out
    "tdc_arith_decode": [_P, _L, _L, _P, _P, _L, ctypes.c_uint64, _L, _P],
    # (``csrc/host/lz78.cpp``)
    # payload, nbits, start_bit, code_kind, dict_max, out, out_cap
    "tdc_lz78_stream_decode": [_P, _L, _L, _I, _L, _P, _L],
    "tdc_lzw_stream_decode": [_P, _L, _L, _I, _L, _P, _L],
    # handle, in, n, final, code_kind, out, cap_bits
    "tdc_lz78s_feed": [_P, _P, _L, _I, _I, _P, _L],
    "tdc_lz78s_free": [_P],
    # handle, in, n, final
    "tdc_lz78ds_feed": [_P, _P, _L, _I],
    # handle, out, cap
    "tdc_lz78ds_take": [_P, _P, _L],
    "tdc_lz78ds_free": [_P],
    # (``csrc/host/lzss_window.cpp``) payload, nbits, start_bit, window, code_kind, out, out_cap
    "tdc_lzss_window_decode": [_P, _L, _L, _L, _I, _P, _L],
    # buf, n, start, abs_base, final, window, threshold, code_kind, out,
    # cap_bits, next_i_out
    "tdc_lzss_window_encode_s": [_P, _L, _L, _L, _I, _L, _L, _I, _P, _L,
                                 _P],
    "tdc_lzssds_feed": [_P, _P, _L, _I],
    "tdc_lzssds_take": [_P, _P, _L],
    "tdc_lzssds_free": [_P],
    # (``csrc/host/repair.cpp``) text, n, max_rules, rules_out (i32
    # pairs), rules_cap, start_out (i32), start_len_out
    "tdc_repair": [_P, _L, _L, _P, _L, _P, _P],
    # payload, nbits, start_bit, lut_sym, lut_len, k, code_kind, out,
    # out_cap
    "tdc_repair_decode": [_P, _L, _L, _P, _P, _I, _I, _P, _L],
    # (``csrc/host/lfs.cpp``) sa, lcp, n, parent, sdepth, is_leaf,
    # suffix, leaf_of_rank (i64 / i32)
    "tdc_suffix_tree": [_P, _P, _L, _P, _P, _P, _P, _P],
    "tdc_suffix_tree32": [_P, _P, _L, _P, _P, _P, _P, _P],
    # sa, lcp (i64), m, n, min_lrf, fl_nts, fl_off, sl_nts (u32),
    # sl_dead, nts_start, nts_len (i64), cap
    "tdc_lfs2_parse": [_P, _P, _L, _L, _L, _P, _P, _P, _P, _P, _P, _L],
    "tdc_lfs_parse": [_P, _P, _L, _L, _L, _P, _P, _P, _P, _P, _P, _L],
    # payload, nbits, start_bit, lut_sym, lut_len, k, w_id, dict_lens
    # (i64), n_lens, out, out_cap
    "tdc_lfs_start_decode": [_P, _L, _L, _P, _P, _I, _I, _P, _L, _P, _L],
    "tdc_lfs2_decode": [_P, _L, _L, _P, _P, _I, _I, _P, _L, _P, _L],
    # parent, sdepth, is_leaf, suffix, nn, n, min_lrf, d_start, d_len,
    # d_cap, o_pos, o_rule, o_len, o_cap, nd_out (i64 arrays)
    "tdc_lfs_simst": [_P, _P, _P, _P, _L, _L, _L, _P, _P, _L, _P, _P, _P,
                      _L, _P],
    # parent, sdepth, suffix, nn, n, min_lrf, d_start, d_len, d_cap,
    # o_pos, o_rule, o_len, o_cap, nd_out (i64 arrays)
    "tdc_lfs_bst": [_P, _P, _P, _L, _L, _L, _P, _P, _L, _P, _P, _P, _L,
                    _P],
    # (``csrc/host/lz78u.cpp``) parent, sdepth, is_leaf, leaf_of_rank,
    # isa, text, n, m, threshold, kind_out, value_out, aux_out, cap
    # (i64 / i32)
    "tdc_lz78u_parse": [_P, _P, _P, _P, _P, _P, _L, _L, _L, _P, _P, _P,
                        _L],
    "tdc_lz78u_parse32": [_P, _P, _P, _P, _P, _P, _L, _L, _L, _P, _P, _P,
                          _L],
    # payload, nbits, start_bit, lut_sym, lut_len, k, ref_kind,
    # str_kind, out, out_cap
    "tdc_lz78u_decode": [_P, _L, _L, _P, _P, _I, _I, _I, _P, _L],
}

#: host constructors of the one-pass stream handles: name -> argtypes;
#: each returns the handle (``void*``, NULL on failure)
_HOST_HANDLE_SIGNATURES = {
    # lzw, dict_limit
    "tdc_lz78s_new": [_I, _L],
    # lzw, dict_max, code_kind
    "tdc_lz78ds_new": [_I, _L, _I],
    # window, code_kind
    "tdc_lzssds_new": [_L, _I],
}

_lock = threading.Lock()
_lib = None
_host_lib = None


def _sources() -> list[str]:
    return sorted(
        glob.glob(os.path.join(_CSRC, "*.cu"))
        + glob.glob(os.path.join(_CSRC, "*.cuh"))
    )


def _host_sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "host", "*.cpp")))


def _host_headers() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "host", "*.hpp")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("no host C++ compiler: set CXX or install g++")
    return found


def _compile(name: str, compiler: str, flags, sources: list[str],
             so: str, headers: list[str] = ()) -> float:
    """Compile ``sources`` into ``so`` unless the stamped library is
    current (``headers`` are hashed into the stamp, not compiled);
    return the seconds spent compiling. Each source compiles in its own
    process, all started together, then one link. Raises
    ``RuntimeError`` with the compiler's output on failure."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in [*sources, *headers]:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    want = h.hexdigest()
    stamp = so + ".srchash"
    if os.path.exists(so) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == want:
                return 0.0
    os.makedirs(os.path.dirname(so), exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{so}.{os.getpid()}"
    objs = [f"{tag}.{i}.o" for i in range(len(sources))]
    logs = [f"{obj}.log" for obj in objs]
    procs = []
    for src, obj, log in zip(sources, objs, logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [compiler, *flags, "-c", "-o", obj, src],
                stdout=out, stderr=subprocess.STDOUT,
            ))
    rcs = [p.wait() for p in procs]
    link = None
    if not any(rcs):
        link = subprocess.run(
            [compiler, *flags, "-shared", "-o", f"{tag}.tmp", *objs],
            capture_output=True, text=True,
        )
        rcs.append(link.returncode)
    text = ""
    for log in logs:
        with open(log) as f:
            text += f.read()
    if link is not None:
        text += link.stdout + link.stderr
    with open(so + ".log", "w") as f:
        f.write(text)
    for path in objs + logs:
        if os.path.exists(path):
            os.remove(path)
    if any(rcs):
        if os.path.exists(f"{tag}.tmp"):
            os.remove(f"{tag}.tmp")
        rc = next(r for r in rcs if r)
        raise RuntimeError(f"{name} failed ({rc}):\n{text[-4000:]}")
    # the rename is atomic: a concurrent loader sees the old library or
    # the whole new one, never a partly written file
    os.replace(f"{tag}.tmp", so)
    with open(stamp, "w") as f:
        f.write(want)
    return time.perf_counter() - t0


def build() -> float:
    """Compile the CUDA kernel library if its sources changed; return the
    seconds spent compiling (0.0 when the stamped library is current)."""
    srcs = [p for p in _sources() if p.endswith(".cu")]
    return _compile("nvcc", _nvcc(), NVCC_FLAGS, srcs, _SO)


def build_host() -> float:
    """Compile the host library (``csrc/host``) if its sources changed."""
    return _compile("g++", _cxx(), HOST_FLAGS, _host_sources(), _HOST_SO,
                    _host_headers())


def _bind(so: str, signatures: dict, restype) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            _lib = _bind(_SO, _SIGNATURES, ctypes.c_int)
        return _lib


def host_lib() -> ctypes.CDLL:
    """The loaded host library (built on first use)."""
    global _host_lib
    with _lock:
        if _host_lib is None:
            build_host()
            lib = _bind(_HOST_SO, _HOST_SIGNATURES, ctypes.c_int64)
            for name, argtypes in _HOST_HANDLE_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_void_p
            _host_lib = lib
        return _host_lib


def on_cuda(*tensors) -> bool:
    """Route of a kernel wrapper: True for CUDA tensors (launch the
    kernel), False for CPU tensors (the plain version). Mixed or other
    devices raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind == "cuda"


def check(t, dtype, shape, name: str) -> None:
    """Raise unless ``t`` is contiguous with this dtype and shape."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want {dtype}{list(shape)}, got {t.dtype}{list(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_aligned(t, name: str, align: int) -> None:
    """Raise unless ``t``'s data starts on an ``align``-byte boundary,
    which the kernel's vector loads need."""
    if t.data_ptr() % align:
        raise ValueError(f"{name}: the kernel needs {align}-byte alignment")


def launch(name: str, *args, device) -> None:
    """Call C entry ``name`` on ``device``'s current stream (appended as
    the last argument) and raise if the launch reported an error."""
    import torch

    fn = getattr(lib(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
