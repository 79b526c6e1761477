"""Self-synchronizing discovery: must match baseline discovery exactly."""

import numpy as np
import pytest

from huffmandecoderongpus_tpu import data as corpus
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.models import get_decoder
from huffmandecoderongpus_tpu.ops.lanedfa import decode_lanedfa
from huffmandecoderongpus_tpu.ops.lanedfa_sync import decode_lanedfa_sync


@pytest.mark.parametrize("lanes", [1, 2, 128, 7, 16])
def test_sync_paper1(paper1, lanes):
    out = decode_lanedfa_sync(paper1.cd, lanes=lanes)
    np.testing.assert_array_equal(out, paper1.ucd)


def test_sync_hello(hello):
    out = decode_lanedfa_sync(hello.cd, lanes=4)
    np.testing.assert_array_equal(out, hello.ucd)


def test_sync_news_default():
    td = corpus.load_test_data("news")
    out = decode_lanedfa_sync(td.cd)
    np.testing.assert_array_equal(out, td.ucd)


def test_sync_registry(paper1):
    out = get_decoder("lane_dfa_sync")(paper1.cd)
    np.testing.assert_array_equal(out, paper1.ucd)


def test_sync_matches_baseline_random(rng):
    for n in (100, 5000, 65537):
        raw = rng.integers(0, 256, size=n, dtype=np.uint8)
        hf = encode_bytes(raw)
        a = decode_lanedfa_sync(hf, lanes=16)
        b = decode_lanedfa(hf, lanes=16)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, raw)


def test_sync_skewed_deep_tree(rng):
    # long codes increase sync distance: exercises the widening loop
    p = np.exp(-np.arange(256) / 4.0)
    raw = rng.choice(256, size=60000, p=p / p.sum()).astype(np.uint8)
    hf = encode_bytes(raw)
    out = decode_lanedfa_sync(hf, lanes=64)
    np.testing.assert_array_equal(out, raw)


def test_sync_two_symbol_alphabet(rng):
    # 1-2 bit codes: merges are instant; also stresses tiny H
    raw = rng.choice([65, 66, 67], size=20000, p=[0.6, 0.3, 0.1]).astype(np.uint8)
    hf = encode_bytes(raw)
    out = decode_lanedfa_sync(hf, lanes=32)
    np.testing.assert_array_equal(out, raw)


def test_sync_adversarial_nonmerging(rng):
    # periodic stream: chains may stay offset forever -> widening to full
    raw = np.tile(np.arange(8, dtype=np.uint8), 4000)
    hf = encode_bytes(raw)
    out = decode_lanedfa_sync(hf, lanes=16)
    np.testing.assert_array_equal(out, raw)


def test_sync_bad_header(paper1):
    hf = paper1.cd
    broken = type(hf)(tree=hf.tree, bits=hf.bits,
                      uncompressed_size=hf.uncompressed_size + 5,
                      payload=hf.payload)
    with pytest.raises(RuntimeError, match="decoded"):
        decode_lanedfa_sync(broken, lanes=8)
