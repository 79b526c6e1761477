"""Registry entries for the lane-parallel bit-DFA device decoders."""

from __future__ import annotations

import numpy as np

from huffmandecoderongpus_tpu.models import register
from huffmandecoderongpus_tpu.ops.lanedfa import decode_lanedfa, decode_lanedfa_indexed


@register("lane_dfa", backend="xla")
def lane_dfa(hf, param=None) -> np.ndarray:
    """Bit-serial DFA over G parallel lanes in plain XLA (device
    counterpart of jumptableapproach.c/linapproach.c; see ops/lanedfa.py).
    Uses the `.huffidx` sidecar when the HuffFile carries one (skipping
    entry discovery); ``param`` optionally sets the lane count for the
    discovery path."""
    index = getattr(hf, "index", None)
    if index is not None:
        offsets, k = index
        return decode_lanedfa_indexed(hf, offsets, k)
    return decode_lanedfa(hf, lanes=param)


@register("lane_dfa_sync", backend="xla")
def lane_dfa_sync(hf, param=None) -> np.ndarray:
    """Lane DFA with self-synchronizing entry discovery — (1+eps)x the main
    scan instead of the height-fold candidate cost (ops/lanedfa_sync.py)."""
    from huffmandecoderongpus_tpu.ops.lanedfa_sync import decode_lanedfa_sync

    return decode_lanedfa_sync(hf, lanes=param)


@register("lane_gpu", backend="gpu")
def lane_gpu(hf, param=None) -> np.ndarray:
    """Lane-scan kernels for the GPU (ops/lane_gpu.py): one thread per
    lane, packed-word input, dense output written in place.  ``param``
    optionally sets the lane count.  Raises when JAX has no GPU."""
    from huffmandecoderongpus_tpu.ops.lane_gpu import decode_lane_gpu

    return decode_lane_gpu(hf, lanes=param)
