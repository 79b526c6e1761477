"""Canonical Huffman encoder producing reference-format `.huff` files.

This is a **new capability**: the reference framework is decoder-only — its
only file writer is the OpenCL kernel-binary cache
(reference framework/openclapproach.c:155-161).  The encoder here is the
host (numpy) path; a device (jnp/Pallas) encode op lives in
``ops/encode_ops.py``.
"""

from __future__ import annotations

import numpy as np

from huffmandecoderongpus_tpu.huffio.format import HuffFile
from huffmandecoderongpus_tpu.huffio.tree import build_tree, tree_codes


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8)


def pack_symbol_codes(
    data: np.ndarray, code: np.ndarray, length: np.ndarray
) -> tuple[np.ndarray, int]:
    """Map bytes to codewords and pack them LSB-first.

    Vectorized: one pass per code-bit position (max code length passes),
    each a numpy scatter — no per-symbol Python loop.

    Returns ``(payload_bytes, total_bits)``.
    """
    data = _as_u8(data)
    lens = length[data].astype(np.int64)
    codes = code[data].astype(np.uint32)
    offsets = np.concatenate(([0], np.cumsum(lens)[:-1]))
    total_bits = int(lens.sum())
    if total_bits > 2**31 - 1:
        raise ValueError(f"compressed stream of {total_bits} bits overflows the int32 header")
    bitarr = np.zeros(total_bits, dtype=np.uint8)
    maxlen = int(lens.max(initial=0))
    for k in range(maxlen):
        sel = lens > k
        bitarr[offsets[sel] + k] = (codes[sel] >> np.uint32(k)) & np.uint32(1)
    return np.packbits(bitarr, bitorder="little"), total_bits


def encode_bytes(data, tree: np.ndarray | None = None,
                 block_symbols: int | None = None) -> HuffFile:
    """Compress a byte sequence into an in-memory :class:`HuffFile`.

    If ``tree`` is None, a Huffman tree is built from the data's byte
    frequencies.  The result round-trips bit-exactly through any of the
    framework's decoders and serializes to the reference container format.

    ``block_symbols``: when set, a symbol-aligned block index (every
    ``block_symbols`` symbols) is attached as :attr:`HuffFile.index` so
    block-parallel decoders skip entry discovery; persist it with
    :func:`huffio.sidecar.write_index`.
    """
    data = _as_u8(data)
    if data.size == 0:
        raise ValueError("cannot encode empty input (format has no empty representation)")
    if tree is None:
        tree = build_tree(np.bincount(data, minlength=256))
    code, length, present = tree_codes(tree)
    used = np.unique(data)
    missing = used[~present[used]]
    if missing.size:
        raise ValueError(f"tree has no code for symbols {missing.tolist()}")
    try:
        # native single-pass packer (huffc_pack_codes); the numpy path below
        # is the pure-python fallback and the oracle it is tested against
        from huffmandecoderongpus_tpu import native

        payload, bits = native.pack_codes(data, code, length)
    except Exception:
        payload, bits = pack_symbol_codes(data, code, length)
    index = None
    if block_symbols is not None:
        from huffmandecoderongpus_tpu.huffio.sidecar import build_block_index

        index = (build_block_index(length[data], block_symbols), int(block_symbols))
    return HuffFile(tree=tree, bits=bits, uncompressed_size=int(data.size),
                    payload=payload, index=index)
