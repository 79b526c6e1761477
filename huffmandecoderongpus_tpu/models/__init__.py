"""The decoder zoo: a named registry of every decoder the framework ships.

Counterpart of the reference's fn-pointer registry
(reference framework/decodeUtil.h:14-19, registration at
mainrun.c:480-501).  Every decoder shares one signature:
``fn(hf: HuffFile, param) -> np.ndarray`` (decoded bytes on the host — device
decoders include H2D/D2H transfer inside the timed call, matching how the
reference times whole `*Approach` functions including cudaMemcpy).

Mapping to the reference's 14 registered decoders:

  justreaddata            -> justreaddata  (native bandwidth floor)
  simpleDecode/Byte       -> simple
  simpleDecodeRP          -> simple_rp
  decodeBigtableV1        -> bigtable_v1   (packed u16 entries)
  decodeBigtableMultiSym  -> bigtable_multisym
  decodeBigtableSimple    -> bigtable_simple
  jumptableApproach       -> jumptable     (param = jumpbits)
  linApproach             -> lin           (param = jumpbits)
  onethread (CUDA <<<1,1>>>) -> onethread_device (one serial while_loop)
  pes (CPU, serial)       -> pes_numpy     (vectorized host execution)
  fastgpu (CUDA)          -> spec_xla      (single-chip XLA speculative pipeline)
  fastgpuOpt1 (CUDA opt)  -> lane_gpu (the GPU decode path: lane-scan
                             kernels) / lane_dfa / lane_dfa_sync (XLA)
  opencl                  -> spec_xla_cpu  (same program, CPU backend)
  pacc (OpenACC)          -> covered by the backend-portable jnp pipeline

Beyond the reference (multi-device): spec_sharded (mesh/shard_map blocks)
and lane_sharded (the lane-scan kernels over the mesh).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

_REGISTRY: dict[str, "Decoder"] = {}


@dataclasses.dataclass(frozen=True)
class Decoder:
    """A named decoder (reference: struct decoder, decodeUtil.h:14-19)."""

    name: str
    fn: Callable[..., np.ndarray]  # (hf, param) -> decoded bytes
    backend: str  # host-native | numpy | xla | xla-cpu | xla-sharded | gpu | gpu-sharded | device
    param: Any = None  # reference's void* paramdata channel (e.g. jumpbits)
    checks_output: bool = True  # justreaddata doesn't produce bytes
    #: Per-decoder cap on the harness timing-loop budget, seconds (None =
    #: the harness default).  Lets suites keep a known-slow cross-check
    #: decoder (spec_xla, the reference-shaped pipeline) as a one-run contrast
    #: row instead of burning the full default budget per corpus.
    suite_budget_s: float | None = None

    def __call__(self, hf, param=None) -> np.ndarray:
        return self.fn(hf, self.param if param is None else param)


def register(name: str, backend: str, param: Any = None, checks_output: bool = True,
             suite_budget_s: float | None = None):
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"decoder {name!r} already registered")
        _REGISTRY[name] = Decoder(name, fn, backend, param, checks_output,
                                  suite_budget_s)
        return fn

    return deco


def get_decoder(name: str) -> Decoder:
    _ensure_loaded()
    return _REGISTRY[name]


def all_decoders() -> dict[str, "Decoder"]:
    _ensure_loaded()
    return dict(_REGISTRY)


def _ensure_loaded() -> None:
    # importing the submodules runs their @register decorators
    from huffmandecoderongpus_tpu.models import (  # noqa: F401
        serial,
        dfa,
        speculative,
        onethread,
        lanedfa,
    )
