"""TBC2 inputs that the codec's tests share: the CPU tests against the
JAX package and the card tests against the CPU. Imports nothing of JAX.
"""

import numpy as np

SEG = 2048


def mixed(nseg: int, seed: int = 0) -> bytes:
    """Segments cycling through random bytes (huff_raw), text, runs of 2
    (rle_raw) and long runs, so both escapes and plain coding occur."""
    rng = np.random.default_rng(seed)
    text = b"<page><title>Anarchism</title> the quick brown fox. " * 40
    parts = []
    for i in range(nseg):
        kind = i % 4
        if kind == 0:
            seg = rng.integers(0, 256, SEG, dtype=np.uint8).tobytes()
        elif kind == 1:
            seg = text[i : i + SEG]
        elif kind == 2:
            seg = np.repeat(rng.integers(0, 256, SEG // 2, dtype=np.uint8),
                            2).tobytes()
        else:
            seg = np.repeat(rng.integers(97, 101, 64, dtype=np.uint8),
                            32).tobytes()
        parts.append(seg)
    return b"".join(parts)


#: name -> (input, codec options); JAX shapes: <= 8 segments, 64 segments
CASES = {
    "empty": (b"", {}),
    "one_byte": (b"x", {}),
    "mixed_5seg": (mixed(5)[:-3], {}),
    "sampled_64seg": (mixed(64, seed=1), {}),
    "min_code_len_4": (mixed(5, seed=2)[:-3], {"min_code_len": 4}),
    # offset biases every RLE run token and is written into the header
    "offset_3": (mixed(5, seed=3)[:-3], {"offset": 3}),
}

#: the cases with frames (every non-empty one), and inputs that take the
#: frames' edge cases: a length that is no multiple of a segment, equal
#: bytes (no table: the identity code, short RLE streams whose frame
#: fields take one vbyte byte), and random bytes (every segment takes
#: ``huff_raw``)
FRAME_CASES = {
    **{name: case for name, case in CASES.items() if case[0]},
    "odd_length": (mixed(9, seed=4)[:-777], {}),
    "all_equal": (b"e" * (6 * SEG + 5), {}),
    "random": (np.random.default_rng(5).integers(
        0, 256, 7 * SEG + 1000, dtype=np.uint8).tobytes(), {}),
}
