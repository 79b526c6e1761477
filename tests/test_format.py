"""Container-format tests: byte-exact read/write of `.huff`, tree metrics.

Format facts follow the reference loader (huffdata.c:27-68); the golden
headers pin the generated corpora (data.py, default seed), so a change to
the generator or the encoder shows here."""

import numpy as np
import pytest

from huffmandecoderongpus_tpu import data as corpus_data
from huffmandecoderongpus_tpu.huffio import (
    HuffFile,
    read_huff,
    write_huff,
    table_height,
    table_min_depth,
    tree_size,
    tree_codes,
    unpack_bits,
    pack_bits,
    payload_to_words_u32,
)

ALL = corpus_data.CORPUS_NAMES


def test_all_corpora_present():
    for name in ALL:
        assert corpus_data.raw_path(name).is_file()
        assert corpus_data.huff_path(name).is_file()


@pytest.mark.parametrize("name", ALL)
def test_parse_all_huff_files(name):
    hf = corpus_data.load_huff(name)
    assert hf.nodes >= 3
    assert hf.bits > 0
    assert hf.uncompressed_size > 0
    # root is internal, leaves well-formed
    assert hf.tree[0, 1] != -1
    leaves = hf.tree[:, 1] == -1
    assert (hf.tree[leaves, 2] == -1).all()
    internal = ~leaves
    assert (hf.tree[internal, 1] >= 0).all() and (hf.tree[internal, 1] < hf.nodes).all()
    assert (hf.tree[internal, 2] >= 0).all() and (hf.tree[internal, 2] < hf.nodes).all()


def test_hello_golden_header():
    hf = corpus_data.load_huff("hello")
    assert hf.nodes == 15
    assert hf.bits == 32
    assert hf.uncompressed_size == 11
    assert bytes(hf.payload) == bytes([0xAF, 0xDA, 0x61, 0x8E])


def test_known_headers():
    # the generated corpora (the reference's kjv.txt: 167 nodes, 24585561
    # bits; its E.coli header is matched exactly)
    kjv = corpus_data.load_huff("kjv.txt")
    assert (kjv.nodes, kjv.bits, kjv.uncompressed_size) == (167, 24572696, 5504597)
    ecoli = corpus_data.load_huff("E.coli")
    assert (ecoli.nodes, ecoli.bits, ecoli.uncompressed_size) == (7, 9277380, 4638690)


@pytest.mark.parametrize("name", ALL)
def test_write_read_roundtrip_byte_exact(name, tmp_path):
    src = corpus_data.huff_path(name)
    hf = read_huff(src)
    dst = tmp_path / "out.huff"
    write_huff(dst, hf)
    assert dst.read_bytes() == src.read_bytes()


def test_payload_padded():
    hf = corpus_data.load_huff("hello")
    padded = hf.payload_padded()
    assert padded.shape[0] == hf.payload_bytes + 3
    assert (padded[-3:] == 0).all()


def test_tree_metrics_ecoli():
    # E.coli: 7 nodes = 4 leaves (ACGT) -> balanced-ish depth-2..3 tree
    hf = corpus_data.load_huff("E.coli")
    assert tree_size(hf.tree) == 7
    h = table_height(hf.tree)
    assert 2 <= h <= 3
    assert 1 <= table_min_depth(hf.tree) <= h


@pytest.mark.parametrize("name", ALL)
def test_tree_codes_kraft_equality(name):
    # A full binary Huffman tree satisfies Kraft with equality.
    hf = corpus_data.load_huff(name)
    code, length, present = tree_codes(hf.tree)
    lens = length[present]
    assert abs(float(np.sum(2.0 ** (-lens.astype(np.float64)))) - 1.0) < 1e-9
    # codes are prefix-free: all (code, len) pairs distinct when truncated
    codes = code[present]
    seen = set()
    for c, l in zip(codes.tolist(), lens.tolist()):
        seen.add((c & ((1 << l) - 1), l))
    assert len(seen) == lens.size


def test_bitio_roundtrip(rng):
    bits = int(rng.integers(1, 1000))
    arr = rng.integers(0, 2, size=bits).astype(np.uint8)
    packed = pack_bits(arr)
    assert (unpack_bits(packed, bits) == arr).all()
    words = payload_to_words_u32(packed, bits)
    # bit p == bit p%32 of words[p//32]
    for p in [0, 1, bits // 2, bits - 1]:
        assert ((int(words[p // 32]) >> (p % 32)) & 1) == arr[p]


def test_hello_bits_decode_by_hand():
    """Walk the hello payload by hand through its tree."""
    hf = corpus_data.load_huff("hello")
    bits = unpack_bits(hf.payload, hf.bits)
    out = []
    node = 0
    for b in bits:
        node = int(hf.tree[node, 2 if b else 1])
        if hf.tree[node, 1] == -1:
            out.append(int(hf.tree[node, 0]))
            node = 0
    assert bytes(out) == b"Hello World"


def test_write_rejects_bad_payload_size():
    with pytest.raises(ValueError):
        HuffFile(
            tree=np.array([[0, 1, 2], [65, -1, -1], [66, -1, -1]], dtype=np.int32),
            bits=16,
            uncompressed_size=4,
            payload=np.zeros(1, dtype=np.uint8),
        )
