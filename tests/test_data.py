"""The corpus generator (data.py): deterministic per seed, the reference's
names and raw sizes, its node counts where BASELINE.md gives them, and its
compressed/raw ratios within 3%."""

import numpy as np
import pytest

from huffmandecoderongpus_tpu import data
from huffmandecoderongpus_tpu.huffio.tree import table_height

# BASELINE.md corpus table: raw bytes, compressed/raw, tree nodes (or None)
REFERENCE = {
    "hello": (11, 14.09, 15),
    "paper1": (53_161, 0.659, 189),
    "news": (377_109, 0.658, None),
    "book2": (610_856, 0.606, None),
    "E.coli": (4_638_690, 0.250, 7),
    "bible.txt": (4_047_392, 0.548, None),
    "kjv.txt": (5_504_597, 0.559, 167),
    "world192.txt": (2_473_400, 0.631, None),
}


def test_names_match_reference():
    assert set(data.CORPUS_NAMES) == set(REFERENCE)
    assert set(data.MAINRUN_NAMES) <= set(data.CORPUS_NAMES)


@pytest.mark.parametrize("name", data.CORPUS_NAMES)
def test_corpus_matches_reference_shape(name):
    size, ratio, nodes = REFERENCE[name]
    td = data.load_test_data(name)
    assert td.ucd.size == td.cd.uncompressed_size == size
    got = td.cd.file_bytes() / size
    assert abs(got / ratio - 1) <= 0.03, (name, got, ratio)
    if nodes is not None:
        assert td.cd.nodes == nodes


def test_kjv_tree_height():
    assert table_height(data.load_huff("kjv.txt").tree) == 19  # BASELINE.md


@pytest.mark.parametrize("name", ["paper1", "E.coli"])
def test_generator_deterministic_per_seed(name):
    a = data.generate_corpus(name, seed=3)
    b = data.generate_corpus(name, seed=3)
    c = data.generate_corpus(name, seed=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # a seed reorders the stream; the symbol counts are the corpus's own
    np.testing.assert_array_equal(np.bincount(a, minlength=256),
                                  np.bincount(c, minlength=256))


def test_stored_files_are_the_generator_output():
    td = data.load_test_data("news")
    np.testing.assert_array_equal(td.ucd, data.generate_corpus("news"))


def test_resized_stream_keeps_the_distribution():
    big = data.generate_corpus("kjv.txt", size=1 << 20)
    base = data.generate_corpus("kjv.txt")
    assert big.size == 1 << 20
    assert set(np.unique(big)) == set(np.unique(base))
    with pytest.raises(ValueError):
        data.generate_corpus("hello", size=100)


def test_seeded_corpora_live_in_the_checkout():
    p = data.raw_path("hello", seed=7)
    assert p.is_file() and data.CACHE_DIR in p.parents
    assert p.read_bytes() == b"Hello World"
    with pytest.raises(KeyError):
        data.raw_path("missing")
