"""GPU lane-scan decoder (ops/lane_gpu.py): the kernels in the Pallas
interpreter against the XLA lane DFA and the native serial oracle, plus the
wrapper's lane plan, word staging and refusal to run without a GPU."""

import jax.numpy as jnp
import numpy as np
import pytest

from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu.huffio.bitio import unpack_bits
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.huffio.tree import table_min_depth
from huffmandecoderongpus_tpu.ops import lane_gpu as lg
from huffmandecoderongpus_tpu.ops import lanedfa as ld


def _stream(kind: str, rng) -> np.ndarray:
    if kind == "random":
        return rng.integers(0, 256, size=3000, dtype=np.uint8)
    if kind == "skewed":  # deep tree: long codes stress the halo
        p = np.exp(-np.arange(256) / 6.0)
        return rng.choice(256, size=4000, p=p / p.sum()).astype(np.uint8)
    if kind == "single_symbol":
        return np.full(2000, 7, dtype=np.uint8)
    if kind == "phase_locked":  # periodic: candidate chains never merge
        return np.tile(np.arange(8, dtype=np.uint8), 500)
    if kind == "md1":  # one dominant symbol: a 1-bit code
        return np.where(rng.random(5000) < 0.7, 0,
                        rng.integers(1, 40, 5000)).astype(np.uint8)
    if kind == "tiny":
        return np.array([3, 1, 4, 1, 5], dtype=np.uint8)
    raise ValueError(kind)


KINDS = ["random", "skewed", "single_symbol", "phase_locked", "md1", "tiny"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("lanes", [None, 5])
def test_lane_gpu_interpret_matches_oracles(kind, lanes, rng):
    raw = _stream(kind, rng)
    hf = encode_bytes(raw)
    if kind == "md1":
        assert table_min_depth(hf.tree) == 1
    out = lg.decode_lane_gpu(hf, lanes=lanes, interpret=True)
    np.testing.assert_array_equal(out, native.simple_decode(hf))
    np.testing.assert_array_equal(out, ld.decode_lanedfa(hf, lanes=16))
    np.testing.assert_array_equal(out, raw)


def test_lane_gpu_stream_ends_mid_lane(rng):
    # 5 lanes, the last one holding only a few bits of the stream
    raw = rng.integers(0, 16, size=777, dtype=np.uint8)
    hf = encode_bytes(raw)
    plan = lg.plan_lanes(hf.bits, 4, lanes=5)
    assert 0 < hf.bits - (plan.lanes - 1) * plan.lane_bits < plan.lane_bits
    np.testing.assert_array_equal(
        lg.decode_lane_gpu(hf, lanes=5, interpret=True), raw)


def test_discover_matches_candidate_scan(rng):
    raw = rng.integers(0, 64, size=2500, dtype=np.uint8)
    hf = encode_bytes(raw)
    dfa = ld.build_lane_dfa(hf.tree)
    plan = lg.plan_lanes(hf.bits, dfa.height, lanes=9)
    G, B, H = plan.lanes, plan.lane_bits, plan.halo
    cnt, ex = lg.discover(lg.stage_words(jnp.asarray(hf.payload), plan),
                          jnp.asarray(dfa.entry),
                          jnp.full(1, hf.bits, jnp.int32), plan=plan,
                          interpret=True)
    mat, B2 = ld.bits_matrix(hf.payload, hf.bits, G, H, round_to=32)
    assert B2 == B
    cnt_x, ex_x = ld._candidate_scan(jnp.asarray(mat), jnp.asarray(dfa.entry),
                                     B=B, H=H, N=hf.bits, G=G)
    np.testing.assert_array_equal(np.asarray(cnt), np.asarray(cnt_x))
    np.testing.assert_array_equal(np.asarray(ex), np.asarray(ex_x))


def test_lane_gpu_bad_header_raises(paper1):
    hf = paper1.cd
    broken = type(hf)(tree=hf.tree, bits=hf.bits,
                      uncompressed_size=hf.uncompressed_size + 3,
                      payload=hf.payload)
    with pytest.raises(RuntimeError, match="decoded"):
        lg.decode_lane_gpu(broken, lanes=64, interpret=True)


def test_lane_gpu_raises_without_gpu(hello):
    with pytest.raises(RuntimeError, match="needs a GPU"):
        lg.decode_lane_gpu(hello.cd)


@pytest.mark.parametrize("bits,height,lanes", [
    (32, 4, None), (266_638, 14, None), (24_572_696, 19, None),
    (600_000_000, 19, None), (1000, 19, 7), (5, 3, 64), (10_000, 40, 1000)])
def test_plan_lanes(bits, height, lanes):
    p = lg.plan_lanes(bits, height, lanes)
    assert p.lane_bits % lg.WORD_BITS == 0
    assert p.lane_bits >= height  # a chain cannot skip a lane
    assert (p.lanes - 1) * p.lane_bits < bits <= p.lanes * p.lane_bits
    assert p.words * lg.WORD_BITS >= p.lane_bits + p.halo
    assert p.lanes <= (lg.MAX_LANES if lanes is None else lanes)
    if lanes is None:
        # one lane per MIN_LANE_BITS bits (rounded to whole words), capped
        want = min(lg.MAX_LANES, -(-bits // lg.MIN_LANE_BITS))
        assert abs(p.lanes - want) <= max(1, want // 100)


def test_stage_words_layout(rng):
    raw = rng.integers(0, 256, size=1234, dtype=np.uint8)
    hf = encode_bytes(raw)
    plan = lg.plan_lanes(hf.bits, 8, lanes=3)
    w = np.asarray(lg.stage_words(jnp.asarray(hf.payload), plan))
    assert w.dtype == np.int32 and w.size == plan.stream_words
    # every lane's last word read is in bounds
    assert (plan.lanes - 1) * plan.lane_bits // 32 + plan.words <= w.size
    bits = unpack_bits(hf.payload, hf.bits)
    u = w.view(np.uint32)
    got = (u[np.arange(hf.bits) // 32] >> (np.arange(hf.bits) % 32)) & 1
    np.testing.assert_array_equal(got, bits)
    assert not u[-(plan.words - 1):].any()  # zero tail past the stream
