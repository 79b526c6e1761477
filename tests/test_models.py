"""Decoder zoo: every registered decoder decodes every small corpus bit-exactly
— the cross-implementation strategy the reference relies on (mainrun.c:541-588:
14 decoders x 5 corpora against golden bytes)."""

import numpy as np
import pytest

from huffmandecoderongpus_tpu import data as corpus_data
from huffmandecoderongpus_tpu.models import all_decoders, get_decoder
from huffmandecoderongpus_tpu.models.dfa import build_jump_dfa, build_lin_dfa

SMALL = ["hello", "paper1"]
DECODERS = sorted(all_decoders())
# decoders that compile only for the card: tested in interpret mode
# (test_lane_gpu.py) and on the card (chip_smoke.py)
GPU_ONLY = sorted(n for n, d in all_decoders().items()
                  if d.backend.startswith("gpu"))
MATRIX = [(d, n) for d in DECODERS if d not in GPU_ONLY for n in SMALL]


def test_zoo_covers_reference_inventory():
    names = set(DECODERS)
    required = {
        "justreaddata",
        "simple",
        "simple_rp",
        "bigtable_v1",
        "bigtable_simple",
        "bigtable_multisym",
        "jumptable",
        "lin",
        "onethread_device",
        "pes_numpy",
        "spec_xla",
        "spec_xla_cpu",
    }
    assert required <= names, f"missing: {required - names}"


@pytest.mark.parametrize("decoder,name", MATRIX)
def test_every_decoder_every_small_corpus(decoder, name):
    d = get_decoder(decoder)
    td = corpus_data.load_test_data(name)
    out = d(td.cd)
    if d.checks_output:
        assert out.size == td.ucd.size
        assert (out == td.ucd).all()


@pytest.mark.parametrize("decoder", GPU_ONLY)
def test_gpu_decoder_raises_without_gpu(decoder, hello):
    # no silent fallback to the interpreter when JAX has no GPU
    with pytest.raises(RuntimeError, match="needs a GPU"):
        get_decoder(decoder)(hello.cd)


@pytest.mark.parametrize("jumpbits", [1, 2, 3, 5, 8, 11, 14])
def test_jumptable_jumpbits_sweep(jumpbits, paper1):
    """The reference sweeps jumpbits 1..14 (mainrun.c:451-454)."""
    out = get_decoder("jumptable")(paper1.cd, param=jumpbits)
    assert (out == paper1.ucd).all()


@pytest.mark.parametrize("jumpbits", [1, 3, 8, 14])
def test_lin_jumpbits_sweep(jumpbits, paper1):
    out = get_decoder("lin")(paper1.cd, param=jumpbits)
    assert (out == paper1.ucd).all()


def test_jump_dfa_state_dedup(paper1):
    """States are deduped by tree node (jumptableapproach.c:46-52 dedups by
    prefix): no node appears twice."""
    _, _, _, state_nodes = build_jump_dfa(paper1.cd.tree, 8)
    assert len(set(state_nodes.tolist())) == state_nodes.size


def test_lin_dfa_telescopes_shallow_states():
    """E.coli's tree has height 2, so with jumpbits=8 every state table must
    telescope to width <= 2."""
    hf = corpus_data.load_huff("E.coli")
    _, _, _, _, width, _ = build_lin_dfa(hf.tree, 8)
    assert (width <= 2).all()


@pytest.mark.parametrize("name", ["news", "book2"])
def test_host_decoders_medium_corpora(name):
    td = corpus_data.load_test_data(name)
    for dec in ["bigtable_multisym", "jumptable", "lin"]:
        out = get_decoder(dec)(td.cd)
        assert (out == td.ucd).all(), dec
