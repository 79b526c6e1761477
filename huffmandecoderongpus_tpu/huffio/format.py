"""The `.huff` container format — byte-exact reader *and* writer.

Container layout (reference reader: reference framework/huffdata.c:27-68;
byte-verified against reference files/hello.huff):

  1. magic ``b"HUFF"`` (4 bytes)
  2. three int32, **big-endian**: ``nodes``, ``bits``, ``uncompressed_size``
  3. ``nodes`` x 9-byte node records: ``sym`` (1 byte), ``izero`` (int32 BE),
     ``ione`` (int32 BE).  Leaves have ``izero == ione == -1``; node 0 is the
     root; child fields index into the same array.
  4. ``ceil(bits/8)`` payload bytes.  Bit *p* of the stream is
     ``(payload[p//8] >> (p%8)) & 1`` (LSB-first within each byte); a 0-bit
     descends ``izero``, a 1-bit descends ``ione``; the stream ends exactly at
     a symbol boundary (``bits`` is exact).

The reference appends 3 zero pad bytes after loading so 32-bit window reads
never overrun (huffdata.c:58-64); we expose that via :meth:`HuffFile.payload_padded`.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

MAGIC = b"HUFF"
_HEADER = struct.Struct(">iii")
_BE_INT = struct.Struct(">i")


@dataclasses.dataclass
class HuffFile:
    """In-memory model of one `.huff` file (reference: struct CompressedData,
    reference framework/huffdata.h:26-32)."""

    tree: np.ndarray  # (nodes, 3) int32: [sym, izero, ione]; row 0 is the root
    bits: int  # exact number of payload bits
    uncompressed_size: int  # decoded byte count
    payload: np.ndarray  # (ceil(bits/8),) uint8, LSB-first bit packing
    #: optional `.huffidx` sidecar: (block bit offsets int64 (n,), block_symbols)
    #: — not part of the serialized container (see huffio/sidecar.py)
    index: tuple | None = None

    def __post_init__(self) -> None:
        self.tree = np.ascontiguousarray(self.tree, dtype=np.int32)
        self.payload = np.ascontiguousarray(self.payload, dtype=np.uint8)
        if self.tree.ndim != 2 or self.tree.shape[1] != 3:
            raise ValueError(f"tree must be (nodes, 3), got {self.tree.shape}")
        nbytes = (self.bits + 7) // 8
        if self.payload.shape[0] != nbytes:
            raise ValueError(
                f"payload has {self.payload.shape[0]} bytes, expected {nbytes} "
                f"for {self.bits} bits"
            )

    @property
    def nodes(self) -> int:
        return int(self.tree.shape[0])

    @property
    def payload_bytes(self) -> int:
        return (self.bits + 7) // 8

    def payload_padded(self, pad: int = 3) -> np.ndarray:
        """Payload with ``pad`` zero bytes appended, so fixed-width window
        reads past the last bit are safe (reference: huffdata.c:58-64)."""
        out = np.zeros(self.payload_bytes + pad, dtype=np.uint8)
        out[: self.payload_bytes] = self.payload
        return out

    def header_bytes(self) -> int:
        """Size of the non-payload part of the serialized file."""
        return 4 + 12 + 9 * self.nodes

    def file_bytes(self) -> int:
        return self.header_bytes() + self.payload_bytes


def read_huff(path, load_index: bool = True) -> HuffFile:
    """Parse a `.huff` file (semantics of loadHuffFile, huffdata.c:27-68).

    When ``load_index`` is set and a ``<path>idx`` sidecar exists, it is
    attached as :attr:`HuffFile.index` for block-parallel decoders."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != MAGIC:
        raise ValueError(f"{path}: expected magic {MAGIC!r}, got {raw[:4]!r}")
    if len(raw) < 4 + _HEADER.size:
        raise ValueError(f"{path}: truncated header ({len(raw)} bytes)")
    nodes, bits, uncompressed_size = _HEADER.unpack_from(raw, 4)
    if nodes < 1 or bits < 0 or uncompressed_size < 0:
        raise ValueError(
            f"{path}: bad header nodes={nodes} bits={bits} size={uncompressed_size}"
        )
    off = 16
    nbytes = (bits + 7) // 8
    if len(raw) < off + 9 * nodes + nbytes:
        raise ValueError(
            f"{path}: truncated file ({len(raw)} bytes, need {off + 9 * nodes + nbytes})"
        )
    # Node records are 9 bytes each: sym u8, izero i32 BE, ione i32 BE.
    rec = np.frombuffer(raw, dtype=np.uint8, count=9 * nodes, offset=off)
    rec = rec.reshape(nodes, 9)
    tree = np.empty((nodes, 3), dtype=np.int32)
    tree[:, 0] = rec[:, 0]
    # Big-endian int32 from bytes 1..4 and 5..8.
    tree[:, 1] = rec[:, 1:5].copy().view(">i4").reshape(nodes)
    tree[:, 2] = rec[:, 5:9].copy().view(">i4").reshape(nodes)
    off += 9 * nodes
    # structural validation: a corrupt tree (cycle, dangling child) would
    # otherwise send the bit-at-a-time decoders into unbounded walks
    from huffmandecoderongpus_tpu.huffio.tree import validate_tree

    validate_tree(tree, what=str(path))
    payload = np.frombuffer(raw, dtype=np.uint8, count=nbytes, offset=off).copy()
    index = None
    if load_index:
        from huffmandecoderongpus_tpu.huffio.sidecar import find_index

        index = find_index(path, bits=bits,
                           uncompressed_size=uncompressed_size,
                           payload=payload)
    return HuffFile(tree=tree, bits=bits, uncompressed_size=uncompressed_size,
                    payload=payload, index=index)


def write_huff(path, hf: HuffFile) -> None:
    """Serialize a :class:`HuffFile` byte-exactly in the reference container
    format (inverse of huffdata.c:27-68 — the reference has no writer)."""
    path = str(path)
    n = hf.nodes
    rec = np.empty((n, 9), dtype=np.uint8)
    rec[:, 0] = (hf.tree[:, 0] & 0xFF).astype(np.uint8)
    rec[:, 1:5] = hf.tree[:, 1].astype(">i4").view(np.uint8).reshape(n, 4)
    rec[:, 5:9] = hf.tree[:, 2].astype(">i4").view(np.uint8).reshape(n, 4)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(_HEADER.pack(n, hf.bits, hf.uncompressed_size))
        f.write(rec.tobytes())
        f.write(hf.payload.tobytes())
