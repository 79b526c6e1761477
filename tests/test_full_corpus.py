"""Golden-file matrix over the full 8-file corpus (RUN_SLOW=1).

The reference's de-facto test is every decoder x every corpus against the
uncompressed bytes (mainrun.c:541-588 via decodeUtil.c:47-52); the quick
per-commit variant covers the small corpora (test_models.py), and this gated
matrix covers all 8 including the multi-MB ones.  The GPU path's all-corpora
sweep runs on the card in chip_smoke.py.
"""

import numpy as np
import pytest

from huffmandecoderongpus_tpu import data as corpus
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.models import get_decoder

ALL = corpus.CORPUS_NAMES
BIG_DECODERS = ["simple", "bigtable_simple", "jumptable", "lin",
                "lane_dfa_sync", "spec_sharded"]


@pytest.mark.slow
@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("dec", BIG_DECODERS)
def test_decoder_corpus_golden(name, dec):
    td = corpus.load_test_data(name)
    out = get_decoder(dec)(td.cd)
    np.testing.assert_array_equal(np.asarray(out, dtype=np.uint8), td.ucd)


@pytest.mark.slow
@pytest.mark.parametrize("name", ALL)
def test_reencode_roundtrip_not_larger(name):
    # our encoder on the corpus bytes: decodes back bit-exact and the
    # container is never larger than the stored .huff
    td = corpus.load_test_data(name)
    hf = encode_bytes(td.ucd)
    out = get_decoder("simple")(hf)
    np.testing.assert_array_equal(out, td.ucd)
    shipped_bytes = corpus.huff_path(name).stat().st_size
    assert hf.file_bytes() <= shipped_bytes
