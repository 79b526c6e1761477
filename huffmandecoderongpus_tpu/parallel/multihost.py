"""Multi-process (multi-host) block-parallel decode.

Extends parallel/block_decode.py across process boundaries: the same
shard_map program runs on a global mesh spanning all processes
(jax.distributed), with

  * inputs (compressed words + LUT) replicated to every process via
    `make_array_from_callback` — the "code-table broadcast" of the
    BASELINE.json north star,
  * per-block output spans sharded over the global "blocks" axis, gathered
    in block order to every process with `process_allgather` — the
    "ordered gather" leg.

The reference has no multi-process story at all (SURVEY §2.3); this module
adds one, exercised on one machine by
tests/multihost_runner.py (2 CPU processes).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.experimental import multihost_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from huffmandecoderongpus_tpu.huffio.bitio import payload_to_words_u32
from huffmandecoderongpus_tpu.ops.lut import DecodeLUT, build_decode_lut
from huffmandecoderongpus_tpu.parallel.block_decode import decode_sharded_arrays
from huffmandecoderongpus_tpu.parallel.mesh import BLOCK_AXIS


def _replicate(mesh: Mesh, arr: np.ndarray):
    """Host numpy array -> globally replicated jax.Array on the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])


def global_mesh(axis: str = BLOCK_AXIS) -> Mesh:
    """1-D mesh over ALL processes' devices (jax.devices() is global)."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def decode_sharded_multihost(hf, mesh: Mesh | None = None,
                             lut: DecodeLUT | None = None,
                             check_size: bool = True) -> np.ndarray:
    """Decode across every process of a jax.distributed job.

    Every process receives the full decoded output (process_allgather), so
    the result is identical everywhere — callers that only want their local
    spans can use decode_sharded_arrays directly.
    """
    if mesh is None:
        mesh = global_mesh()
    if lut is None:
        lut = build_decode_lut(hf.tree)
    words = payload_to_words_u32(hf.payload, hf.bits, extra_words=2)

    (spans, counts, totals, _entries), _S = decode_sharded_arrays(
        _replicate(mesh, words),
        _replicate(mesh, np.ascontiguousarray(lut.sym)),
        _replicate(mesh, np.ascontiguousarray(lut.length)),
        bits=hf.bits, size=hf.uncompressed_size, height=lut.height, mesh=mesh)

    spans = multihost_utils.process_allgather(spans, tiled=True)
    counts = multihost_utils.process_allgather(counts, tiled=True)
    total = int(np.asarray(multihost_utils.process_allgather(totals, tiled=True))[0])
    if check_size and total != hf.uncompressed_size:
        raise RuntimeError(
            f"decoded {total} symbols, header says {hf.uncompressed_size}")
    out = np.empty(total, dtype=np.uint8)
    off = 0
    for d in range(counts.shape[0]):
        n = int(counts[d])
        out[off:off + n] = spans[d, :n]
        off += n
    return out
