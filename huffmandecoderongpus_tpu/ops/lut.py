"""Full-height decode lookup tables.

The reference's `decodeAllBits` walks the Huffman tree bit-by-bit per offset
(reference framework/pes.c:30-46) — data-dependent control flow that does
not vectorize.  We instead precompute, for every possible
``height``-bit window (LSB-first), the first decoded symbol and its code
length — the same table the reference's `decodeBigtableSimple` builds
(mainrun.c:251-297) — turning the per-bit walk into one vectorized gather.

Tables are built host-side (native C++, microseconds for real trees) and
shipped to the device once per tree.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_LUT_HEIGHT = 22  # 2^22 entries; every shipped corpus has height <= 20


@dataclasses.dataclass(frozen=True)
class DecodeLUT:
    """(sym, len) lookup over h-bit LSB-first windows, plus tree metadata."""

    height: int  # table height h; index = window & (2^h - 1)
    sym: np.ndarray  # (2^h,) uint8 — first symbol decoded in the window
    length: np.ndarray  # (2^h,) int32 — its code length (1..h)
    min_depth: int

    @property
    def mask(self) -> int:
        return (1 << self.height) - 1


def build_decode_lut(tree: np.ndarray, height: int | None = None) -> DecodeLUT:
    from huffmandecoderongpus_tpu import native
    from huffmandecoderongpus_tpu.huffio.tree import table_height, table_min_depth

    h = table_height(tree) if height is None else height
    if h > MAX_LUT_HEIGHT:
        raise NotImplementedError(
            f"tree height {h} > {MAX_LUT_HEIGHT}: full-height LUT unsupported "
            "(chunked DFA walk not yet implemented)"
        )
    h = max(h, 1)
    lut_sym, lut_len = native.build_lut(tree, h)
    return DecodeLUT(height=h, sym=lut_sym, length=lut_len, min_depth=table_min_depth(tree))
