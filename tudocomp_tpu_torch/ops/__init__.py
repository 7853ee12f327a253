"""Device ops of the port. The kernels — K1–K4 of the TBC2 path (K1 and
K2 each with a second entry that fuses the codec's escape select, K3
with one that reads a strided slice of rows in place), K5–K7 of the
chunked bit packers, K8 that writes the TBC2 frames — are each a
wrapper that launches a hand-written CUDA kernel on CUDA tensors and
runs its plain torch version on CPU tensors. The launch counts also
cover the stage probes' variants (``tudocomp_tpu_torch.probes``)."""

from tudocomp_tpu_torch.ops.bitpack_chunks import (
    pack_bytes_huffman_chunks, pack_tokens_chunks, rle_pack_chunks,
)
from tudocomp_tpu_torch.ops.frames import pack_frames
from tudocomp_tpu_torch.ops.hist import histogram_rows, histogram_words
from tudocomp_tpu_torch.ops.hufdec import decode_segments, decoder_tables
from tudocomp_tpu_torch.ops.segpack import (
    huffman_pack_segments, huffman_select_segments, rle_pack_segments,
    rle_select_segments,
)
# after the ops it uses: the probes import ops.segpack
from tudocomp_tpu_torch.probes import COUNTERS as _PROBE_COUNTERS

#: the kernel wrappers; each counts its launches in ``.launches``
KERNELS = {
    "rle_pack": rle_pack_segments,
    "rle_select": rle_select_segments,
    "huffman_pack": huffman_pack_segments,
    "huff_select": huffman_select_segments,
    "histogram": histogram_words,
    "histogram_rows": histogram_rows,
    "decode": decode_segments,
    "frame_pack": pack_frames,
    "pack_tokens_chunks": pack_tokens_chunks,
    "pack_bytes_huffman_chunks": pack_bytes_huffman_chunks,
    "rle_pack_chunks": rle_pack_chunks,
}

#: the kernels of the TBC2 codec's path, and of the chunked packers'
CODEC_KERNELS = ("rle_select", "histogram_rows", "huff_select",
                 "frame_pack", "decode")
CHUNK_KERNELS = ("pack_tokens_chunks", "pack_bytes_huffman_chunks",
                 "rle_pack_chunks")
#: the stage probes' variants (P1–P4), each with its own launch count
PROBE_KERNELS = tuple(_PROBE_COUNTERS)


def reset_launches() -> None:
    for fn in (*KERNELS.values(), *_PROBE_COUNTERS.values()):
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches
            for name, fn in {**KERNELS, **_PROBE_COUNTERS}.items()}


__all__ = [
    "CHUNK_KERNELS", "CODEC_KERNELS", "KERNELS", "PROBE_KERNELS",
    "decode_segments", "decoder_tables", "histogram_rows", "histogram_words",
    "huffman_pack_segments", "huffman_select_segments", "launch_counts",
    "pack_bytes_huffman_chunks", "pack_frames", "pack_tokens_chunks",
    "reset_launches",
    "rle_pack_chunks", "rle_pack_segments", "rle_select_segments",
]
