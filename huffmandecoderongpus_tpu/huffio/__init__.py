"""`.huff` container format, Huffman tree model, and bitstream I/O.

Replacement for the reference's "huffdata" layer
(reference framework/huffdata.h:12-37, huffdata.c:27-68) plus a
canonical Huffman *encoder*, which the reference does not have.
"""

from huffmandecoderongpus_tpu.huffio.format import HuffFile, read_huff, write_huff
from huffmandecoderongpus_tpu.huffio.tree import (
    HuffTree,
    build_tree,
    tree_codes,
    table_height,
    table_min_depth,
    tree_size,
    table_num_groups,
    telescoped,
)
from huffmandecoderongpus_tpu.huffio.bitio import (
    unpack_bits,
    pack_bits,
    payload_to_words_u32,
)
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes, pack_symbol_codes

__all__ = [
    "HuffFile",
    "read_huff",
    "write_huff",
    "HuffTree",
    "build_tree",
    "tree_codes",
    "table_height",
    "table_min_depth",
    "tree_size",
    "table_num_groups",
    "telescoped",
    "unpack_bits",
    "pack_bits",
    "payload_to_words_u32",
    "encode_bytes",
    "pack_symbol_codes",
]
