"""Scaling-efficiency sweep: decode throughput vs mesh size.

This sweep times the block-parallel sharded decode on growing 1-D meshes and
reports efficiency = speedup(n) / n.  On several GPUs the same code
measures true scaling; on a virtual CPU mesh it validates the machinery and
the collective layout (the numbers then reflect host cores).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class ScalePoint:
    devices: int
    min_seconds: float
    gb_per_s: float
    speedup: float
    efficiency: float


def scaling_sweep(hf, ucd: np.ndarray | None = None, sizes=None,
                  repeats: int = 5, path: str = "lane") -> list[ScalePoint]:
    """Time the sharded decode across mesh sizes; verify vs ``ucd``.

    ``path="lane"`` (default) drives decode_lane_sharded — the multi-chip
    performance path; ``path="block"`` keeps the reference-shaped
    speculative pipeline."""
    import jax

    from huffmandecoderongpus_tpu.parallel import (
        decode_sharded, lane_sharded_runner, make_mesh)

    n_dev = len(jax.devices())
    if sizes is None:
        sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= n_dev]
    points = []
    base = None
    for n in sizes:
        mesh = make_mesh(n)
        if path == "lane":
            # stage inputs once; time only the sharded device program
            # (scans + stitching collective), not host prep/compaction
            run, materialize = lane_sharded_runner(hf, mesh=mesh)
            out, total = materialize(run())  # compile + warm + verify
            if total != hf.uncompressed_size:
                raise RuntimeError(f"wrong size at {n} devices: {total}")
            if ucd is not None and not np.array_equal(out, ucd):
                raise RuntimeError(f"sharded decode wrong at {n} devices")
            def timed_once():
                jax.block_until_ready(run())
        else:
            def timed_once(mesh=mesh):
                decode_sharded(hf, mesh=mesh, check_size=False)
            out = decode_sharded(hf, mesh=mesh)  # compile + warm + verify
            if ucd is not None and not np.array_equal(out, ucd):
                raise RuntimeError(f"sharded decode wrong at {n} devices")
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            timed_once()
            ts.append(time.perf_counter() - t0)
        sec = min(ts)
        if base is None:
            base = sec
        speedup = base / sec
        points.append(ScalePoint(
            devices=n, min_seconds=sec,
            gb_per_s=hf.uncompressed_size / sec / 1e9,
            speedup=speedup, efficiency=speedup / (n / sizes[0])))
    return points


def format_sweep(points: list[ScalePoint]) -> str:
    lines = ["devices   min_s      GB/s   speedup   efficiency"]
    for p in points:
        lines.append(f"{p.devices:7d} {p.min_seconds:8.4f} {p.gb_per_s:9.4f} "
                     f"{p.speedup:9.2f} {p.efficiency:11.2%}")
    return "\n".join(lines)
