"""Native C++ host runtime: serial oracle decoders vs the corpora's ground
truth."""

import numpy as np
import pytest

from huffmandecoderongpus_tpu import data as corpus_data
from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu.huffio.tree import table_height

WITH_RAW = corpus_data.CORPUS_NAMES


@pytest.mark.parametrize("name", WITH_RAW)
def test_simple_decode_matches_ground_truth(name):
    td = corpus_data.load_test_data(name)
    out = native.simple_decode(td.cd)
    assert out.size == td.ucd.size
    assert (out == td.ucd).all()


@pytest.mark.parametrize("name", WITH_RAW)
def test_bigtable_decode_matches_ground_truth(name):
    td = corpus_data.load_test_data(name)
    out = native.bigtable_decode(td.cd)
    assert (out == td.ucd).all()


@pytest.mark.parametrize("name", ["kjv.txt", "E.coli"])
def test_pruned_corpora_cross_oracle(name):
    """Cross-check the two independent serial decoders against each other
    and the header size on the two largest corpora."""
    hf = corpus_data.load_huff(name)
    a = native.simple_decode(hf)
    b = native.bigtable_decode(hf)
    assert a.size == hf.uncompressed_size
    assert (a == b).all()


def test_build_lut_hello():
    hf = corpus_data.load_huff("hello")
    h = table_height(hf.tree)
    lut_sym, lut_len = native.build_lut(hf.tree, h)
    assert lut_sym.size == 1 << h
    assert (lut_len >= 1).all() and (lut_len <= h).all()


def test_tail_decode_full_stream():
    hf = corpus_data.load_huff("hello")
    out = native.tail_decode(
        hf.tree, 0, hf.payload_padded(), 0, hf.bits, hf.uncompressed_size
    )
    assert bytes(out) == b"Hello World"


def test_sum_bytes():
    hf = corpus_data.load_huff("hello")
    assert native.sum_bytes(hf.payload) == int(hf.payload.astype(np.int64).sum())
