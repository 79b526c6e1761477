"""Lane-parallel bit-DFA decoder: table build, entry discovery, decode."""

import numpy as np
import pytest

from huffmandecoderongpus_tpu import data as corpus
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.models import get_decoder
from huffmandecoderongpus_tpu.ops.lanedfa import (
    EMIT_BIT,
    build_lane_dfa,
    bits_matrix,
    decode_lanedfa,
)
from huffmandecoderongpus_tpu.huffio.tree import tree_codes


def test_fused_table_hello(hello):
    dfa = build_lane_dfa(hello.cd.tree)
    assert dfa.nodes == 15 and dfa.height == 4
    # walking the code of 'H' from the root must emit 'H' on its last bit
    code, length, _ = tree_codes(hello.cd.tree)
    c, n = int(code[ord("H")]), int(length[ord("H")])
    state = 0
    for k in range(n):
        e = int(dfa.entry[state * 2 + ((c >> k) & 1)])
        assert bool(e & EMIT_BIT) == (k == n - 1)
        state = e & 0x3FF
    assert (e >> 16) & 0xFF == ord("H")


def test_bits_matrix_halo():
    payload = np.array([0b10110100, 0b01011101], dtype=np.uint8)
    mat, B = bits_matrix(payload, 16, lanes=4, halo=3)
    assert B == 4 and mat.shape == (7, 4)
    flat = np.unpackbits(payload, bitorder="little")
    for g in range(4):
        for j in range(7):
            want = flat[g * 4 + j] if g * 4 + j < 16 else 0
            assert mat[j, g] == want


@pytest.mark.parametrize("lanes", [1, 2, 3, 8, 64])
def test_lanedfa_hello(hello, lanes):
    out = decode_lanedfa(hello.cd, lanes=lanes)
    np.testing.assert_array_equal(out, hello.ucd)


@pytest.mark.parametrize("lanes", [1, 16, 128, 1024])
def test_lanedfa_paper1(paper1, lanes):
    out = decode_lanedfa(paper1.cd, lanes=lanes)
    np.testing.assert_array_equal(out, paper1.ucd)


def test_lanedfa_news_default_lanes():
    td = corpus.load_test_data("news")
    out = decode_lanedfa(td.cd)
    np.testing.assert_array_equal(out, td.ucd)


def test_lanedfa_registry(paper1):
    out = get_decoder("lane_dfa")(paper1.cd)
    np.testing.assert_array_equal(out, paper1.ucd)


def test_lanedfa_random_roundtrip(rng):
    for n in (1, 5, 1000, 65537):
        raw = rng.integers(0, 256, size=n, dtype=np.uint8)
        hf = encode_bytes(raw)
        out = decode_lanedfa(hf, lanes=16)
        np.testing.assert_array_equal(out, raw)


def test_lanedfa_skewed_tree(rng):
    # deep tree: long codes stress the halo and candidate window
    p = np.exp(-np.arange(256) / 6.0)
    raw = rng.choice(256, size=30000, p=p / p.sum()).astype(np.uint8)
    hf = encode_bytes(raw)
    out = decode_lanedfa(hf, lanes=64)
    np.testing.assert_array_equal(out, raw)


def test_lanedfa_bad_header_raises(paper1):
    hf = paper1.cd
    broken = type(hf)(tree=hf.tree, bits=hf.bits,
                      uncompressed_size=hf.uncompressed_size + 3,
                      payload=hf.payload)
    with pytest.raises(RuntimeError, match="decoded"):
        decode_lanedfa(broken, lanes=8)


def test_lanedfa_with_precomputed_entries(paper1):
    # feed the composition's own output back as a sidecar would
    from huffmandecoderongpus_tpu.ops.lanedfa import (
        _candidate_scan, _compose, build_lane_dfa, bits_matrix)
    import jax.numpy as jnp

    dfa = build_lane_dfa(paper1.cd.tree)
    G, H = 32, max(dfa.height, 1)
    # round_to must match decode_lanedfa's bucketing for identical lanes
    mat, B = bits_matrix(paper1.cd.payload, paper1.cd.bits, G, H, round_to=512)
    cnt, ex = _candidate_scan(jnp.asarray(mat), jnp.asarray(dfa.entry),
                              B=B, H=H, N=paper1.cd.bits, G=G)
    entry_off, base, n, total = _compose(cnt, ex, G=G)
    assert int(total) == paper1.cd.uncompressed_size
    out = decode_lanedfa(paper1.cd, lanes=G,
                         entries=(np.asarray(entry_off), np.asarray(base)))
    np.testing.assert_array_equal(out, paper1.ucd)
