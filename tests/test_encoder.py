"""Encoder tests: bit-exact round-trips and size parity with the stored
`.huff` files (the reference has no encoder; this is a new capability)."""

import numpy as np
import pytest

from huffmandecoderongpus_tpu import data as corpus_data
from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu.huffio import (
    HuffFile,
    encode_bytes,
    read_huff,
    write_huff,
    tree_codes,
)
from huffmandecoderongpus_tpu.huffio.encoder import pack_symbol_codes

WITH_RAW = corpus_data.CORPUS_NAMES


def test_encode_hello_roundtrip():
    data = b"Hello World"
    hf = encode_bytes(data)
    assert bytes(native.simple_decode(hf)) == data


def test_encode_hello_same_bits_as_shipped():
    # Same frequencies => same code lengths => the reference's hello.huff
    # bit count (32, mainrun.c:659-663) and the stored fixture's bytes.
    shipped = corpus_data.load_huff("hello")
    ours = encode_bytes(b"Hello World")
    assert ours.bits == shipped.bits == 32
    assert bytes(ours.payload) == bytes(shipped.payload)


@pytest.mark.parametrize("name", WITH_RAW)
def test_encode_corpus_roundtrip_and_size(name):
    td = corpus_data.load_test_data(name)
    hf = encode_bytes(td.ucd)
    assert (native.bigtable_decode(hf) == td.ucd).all()
    # encoded size must not exceed the stored .huff size
    assert hf.file_bytes() <= corpus_data.huff_path(name).stat().st_size


@pytest.mark.parametrize("name", WITH_RAW)
def test_reencode_with_shipped_tree_reproduces_payload(name):
    """Encoding the ground truth with the *stored* tree must reproduce the
    stored payload bit-for-bit (numpy packer against the file)."""
    td = corpus_data.load_test_data(name)
    code, length, present = tree_codes(td.cd.tree)
    payload, bits = pack_symbol_codes(td.ucd, code, length)
    assert bits == td.cd.bits
    assert bytes(payload) == bytes(td.cd.payload)


def test_native_pack_matches_numpy_pack():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=100_000).astype(np.uint8)
    hf = encode_bytes(data)
    code, length, _ = tree_codes(hf.tree)
    np_payload, np_bits = pack_symbol_codes(data, code, length)
    c_payload, c_bits = native.pack_codes(data, code, length)
    assert np_bits == c_bits == hf.bits
    assert bytes(np_payload) == bytes(c_payload) == bytes(hf.payload)


def test_encode_write_read_decode(tmp_path):
    rng = np.random.default_rng(2)
    # skewed distribution for a deeper tree
    data = rng.choice(
        np.arange(64, dtype=np.uint8), size=50_000, p=np.arange(1, 65) / np.arange(1, 65).sum()
    )
    hf = encode_bytes(data)
    p = tmp_path / "x.huff"
    write_huff(p, hf)
    hf2 = read_huff(p)
    assert (native.simple_decode(hf2) == data).all()


def test_encode_single_symbol_input():
    data = np.zeros(100, dtype=np.uint8)
    hf = encode_bytes(data)
    assert hf.bits == 100  # 1 bit per symbol via padding leaf
    assert (native.simple_decode(hf) == data).all()


@pytest.mark.parametrize("n", [1, 2, 7, 255, 4096])
def test_encode_random_roundtrip_property(n, rng):
    data = rng.integers(0, 256, size=n).astype(np.uint8)
    hf = encode_bytes(data)
    assert (native.simple_decode(hf) == data).all()
    assert (native.bigtable_decode(hf) == data).all()


def test_encode_empty_rejected():
    with pytest.raises(ValueError):
        encode_bytes(b"")
