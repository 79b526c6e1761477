"""Parallel Huffman codec for the GPU.

A from-scratch JAX / Pallas / shard_map framework with the capabilities of
the reference GPU framework (BeauJoh/HuffmanDecoderOnGPUs): the speculative
"decode from every bit offset" parallel algorithm, a zoo of serial/table
decoders, a benchmark harness (verify + min-of-25), and — new here — a
matching canonical `.huff` encoder (the reference ships no encoder;
see reference framework/huffdata.c:27-68, reader only).

Layering (bottom-up):
  huffio    — .huff container read/write, Huffman tree build + metrics, bit I/O
  native    — C++ host runtime (serial oracles, encoder bitpack) via ctypes
  ops       — device compute: LUTs, bit windows, the 6-stage speculative
              pipeline (XLA), the lane DFA (XLA) and its GPU kernels
              (Pallas, Triton route)
  models    — the decoder zoo (registry of named decoders)
  parallel  — mesh / shard_map block-parallel decode, multi-host init
  harness   — evaluate (verify + min-of-25), benchmark suites, CLI
"""

__version__ = "0.1.0"

from huffmandecoderongpus_tpu.huffio.format import HuffFile, read_huff, write_huff  # noqa: F401
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes  # noqa: F401


def get_decoder(name: str):
    """Look up a decoder from the zoo (lazy import of the registry)."""
    from huffmandecoderongpus_tpu.models import get_decoder as _g

    return _g(name)
