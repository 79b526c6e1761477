"""Device (jnp/XLA) encoder: bytes -> LSB-first Huffman bitstream on-device.

New capability relative to the reference (decoder-only; SURVEY intro).  The
host encoder (huffio/encoder.py, native bit-packer in huffc.cpp) is the
production path; this device path exists so encode can run where the data
already lives (e.g. compressing device-resident output before a transfer)
and as the `ops`-layer parity piece its docstring promises.

Pipeline (all static shapes):
  1. per-byte (code, length) lookup in 256-entry tables
  2. exclusive cumsum of lengths -> per-symbol bit offsets
  3. each codeword straddles at most two 32-bit words (code length <= 25 <
     32): build both word contributions with shifts and OR-scatter them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("n_words",))
def _pack_device(data, code_tab, len_tab, *, n_words: int):
    data = data.astype(jnp.int32)
    codes = jnp.take(code_tab, data, mode="clip").astype(jnp.uint32)
    lens = jnp.take(len_tab, data, mode="clip")
    offs = jnp.cumsum(lens) - lens  # exclusive prefix: bit offset per symbol
    total_bits = offs[-1] + lens[-1] if data.shape[0] else jnp.int32(0)

    q = (offs >> 5).astype(jnp.int32)
    r = (offs & 31).astype(jnp.uint32)
    lo = codes << r
    # uint32 >> 32 is undefined; mask the r == 0 lane instead
    hi = jnp.where(r == 0, jnp.uint32(0), codes >> (jnp.uint32(32) - r))

    # OR == ADD here: contributions to one word occupy disjoint bit ranges
    # (codewords pack adjacently), so scatter-add never carries.
    words = jnp.zeros(n_words, dtype=jnp.uint32)
    words = words.at[q].add(lo)
    words = words.at[q + 1].add(hi)
    return words, total_bits


def encode_device(data, tree: np.ndarray | None = None):
    """Encode bytes on the device.  Returns a host HuffFile (payload pulled
    back once); the tree is built host-side (tiny)."""
    from huffmandecoderongpus_tpu.huffio.format import HuffFile
    from huffmandecoderongpus_tpu.huffio.tree import build_tree, tree_codes

    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.ascontiguousarray(data, dtype=np.uint8)
    if arr.size == 0:
        raise ValueError("cannot encode empty input")
    if tree is None:
        tree = build_tree(np.bincount(arr, minlength=256))
    code, length, present = tree_codes(tree)
    used = np.unique(arr)
    missing = used[~present[used]]
    if missing.size:
        raise ValueError(f"tree has no code for symbols {missing.tolist()}")

    upper_bits = int(length[arr].astype(np.int64).sum())
    n_words = upper_bits // 32 + 2
    words, total_bits = _pack_device(
        jnp.asarray(arr), jnp.asarray(code.astype(np.int32)),
        jnp.asarray(length), n_words=n_words)
    bits = int(total_bits)
    payload = np.asarray(words).view("<u4").tobytes()[: (bits + 7) // 8]
    return HuffFile(tree=tree, bits=bits, uncompressed_size=int(arr.size),
                    payload=np.frombuffer(payload, dtype=np.uint8).copy())
