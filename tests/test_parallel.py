"""Block-parallel sharded decode on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from huffmandecoderongpus_tpu import data as corpus
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.models import get_decoder
from huffmandecoderongpus_tpu.parallel import decode_sharded, make_mesh


def test_mesh_has_8_cpu_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8  # conftest forces 8 virtual CPU devices
    assert mesh.axis_names == ("blocks",)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_sharded_decode_hello(hello, n_dev):
    out = decode_sharded(hello.cd, mesh=make_mesh(n_dev))
    np.testing.assert_array_equal(out, hello.ucd)


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_sharded_decode_paper1(paper1, n_dev):
    out = decode_sharded(paper1.cd, mesh=make_mesh(n_dev))
    np.testing.assert_array_equal(out, paper1.ucd)


def test_sharded_decode_news():
    td = corpus.load_test_data("news")
    out = decode_sharded(td.cd, mesh=make_mesh(8))
    np.testing.assert_array_equal(out, td.ucd)


def test_sharded_registry_entry(paper1):
    out = get_decoder("spec_sharded")(paper1.cd)
    np.testing.assert_array_equal(out, paper1.ucd)


def test_sharded_random_roundtrips(rng):
    # Block boundaries land mid-codeword at many alignments.
    for n in (1, 2, 37, 256, 1000, 4096, 65537):
        raw = rng.integers(0, 256, size=n, dtype=np.uint8) if n > 2 else np.zeros(n, np.uint8)
        hf = encode_bytes(raw)
        out = decode_sharded(hf, mesh=make_mesh(8))
        np.testing.assert_array_equal(out, raw)


def test_sharded_skewed_distribution(rng):
    # Long codes (deep tree) stress the entry-candidate window H.
    p = np.exp(-np.arange(256) / 8.0)
    raw = rng.choice(256, size=50000, p=p / p.sum()).astype(np.uint8)
    hf = encode_bytes(raw)
    out = decode_sharded(hf, mesh=make_mesh(8))
    np.testing.assert_array_equal(out, raw)


def test_sharded_bad_size_header_raises(paper1):
    hf = paper1.cd
    broken = type(hf)(tree=hf.tree, bits=hf.bits,
                      uncompressed_size=hf.uncompressed_size + 7,
                      payload=hf.payload)
    with pytest.raises(RuntimeError, match="decoded"):
        decode_sharded(broken, mesh=make_mesh(4))


def test_sharded_output_sharding_is_blockwise(paper1):
    # The padded spans come back sharded over the blocks axis in order.
    from huffmandecoderongpus_tpu.huffio.bitio import payload_to_words_u32
    from huffmandecoderongpus_tpu.ops.lut import build_decode_lut
    from huffmandecoderongpus_tpu.parallel.block_decode import decode_sharded_arrays
    import jax.numpy as jnp

    mesh = make_mesh(4)
    lut = build_decode_lut(paper1.cd.tree)
    words = payload_to_words_u32(paper1.cd.payload, paper1.cd.bits, extra_words=2)
    (spans, counts, totals, entries), S = decode_sharded_arrays(
        jnp.asarray(words), jnp.asarray(lut.sym), jnp.asarray(lut.length),
        bits=paper1.cd.bits, size=paper1.cd.uncompressed_size,
        height=lut.height, mesh=mesh)
    assert spans.shape == (4, S)
    assert int(np.asarray(totals)[0]) == paper1.cd.uncompressed_size
    # entries are increasing block entry bits
    e = np.asarray(entries)
    assert e[0] == 0 and np.all(np.diff(e) > 0)


# ---------------------------------------------------------------------------
# lane-sharded (the GPU lane-scan kernels over the mesh, interpreted here)


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_lane_sharded_paper1(paper1, n_dev):
    from huffmandecoderongpus_tpu.parallel import decode_lane_sharded

    out = decode_lane_sharded(paper1.cd, mesh=make_mesh(n_dev), interpret=True)
    np.testing.assert_array_equal(out, paper1.ucd)


def test_lane_sharded_hello(hello):
    from huffmandecoderongpus_tpu.parallel import decode_lane_sharded

    out = decode_lane_sharded(hello.cd, mesh=make_mesh(2), interpret=True)
    np.testing.assert_array_equal(out, hello.ucd)


def test_lane_sharded_registry(paper1):
    # the registry entry runs the kernels only on a GPU mesh
    d = get_decoder("lane_sharded")
    assert d.backend == "gpu-sharded"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        d(paper1.cd)


def test_lane_sharded_random(rng):
    from huffmandecoderongpus_tpu.parallel import decode_lane_sharded

    for n in (1000, 65537, 200001):
        raw = rng.integers(0, 256, size=n, dtype=np.uint8)
        hf = encode_bytes(raw)
        out = decode_lane_sharded(hf, mesh=make_mesh(8), interpret=True)
        np.testing.assert_array_equal(out, raw)


@pytest.mark.parametrize("n_dev,lanes", [(4, 4), (4, 13), (3, 64)])
def test_lane_sharded_matches_single_card(rng, n_dev, lanes):
    # uneven lane counts (padded to whole shards), shards that hold no
    # stream at all, and a deep tree whose codes straddle shard borders
    from huffmandecoderongpus_tpu.ops.lane_gpu import decode_lane_gpu
    from huffmandecoderongpus_tpu.parallel import decode_lane_sharded

    p = np.exp(-np.arange(256) / 6.0)
    raw = rng.choice(256, size=6000, p=p / p.sum()).astype(np.uint8)
    hf = encode_bytes(raw)
    out = decode_lane_sharded(hf, mesh=make_mesh(n_dev), lanes=lanes,
                              interpret=True)
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(
        out, decode_lane_gpu(hf, lanes=lanes, interpret=True))


def test_lane_sharded_bad_header(paper1):
    from huffmandecoderongpus_tpu.parallel import decode_lane_sharded

    hf = paper1.cd
    broken = type(hf)(tree=hf.tree, bits=hf.bits,
                      uncompressed_size=hf.uncompressed_size + 2,
                      payload=hf.payload)
    with pytest.raises(RuntimeError, match="decoded"):
        decode_lane_sharded(broken, mesh=make_mesh(4), interpret=True)
