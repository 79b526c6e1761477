"""Multi-device lane decode: the GPU lane-scan kernels sharded over the mesh.

The single-card path (ops/lane_gpu.py) splits the stream into G lanes with
per-lane exit maps.  Across D devices it becomes a two-level composition of
the same maps:

  1. Each device holds G/D contiguous lanes' words plus the halo words of
     the next shard, so the scans need no neighbour exchange.
  2. Each shard runs the discovery kernel and folds its lanes' exit maps
     into one shard map: for each of the H entry offsets of its first
     lane, the exit offset into the next shard and the symbols emitted.
  3. One `all_gather` moves the D x H x 2 shard maps (a few hundred ints);
     every device composes them identically to find its true entry offset
     and global output base — the same stitching pattern as
     parallel/block_decode.py, now layered on lanes.
  4. Each shard composes its own lanes from that entry and runs the decode
     kernel, writing its symbols at their global positions of a zeroed
     full-size buffer; one `psum` assembles the output (every byte has
     exactly one writer).

Compare the reference's multi-device story: none (SURVEY §2.3) — its
device-side parallelism stops at one GPU grid.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from huffmandecoderongpus_tpu.ops import lane_gpu as lg
from huffmandecoderongpus_tpu.ops.lanedfa import _compose, _span_map, build_lane_dfa
from huffmandecoderongpus_tpu.parallel.mesh import BLOCK_AXIS, make_mesh


def _shard_body(words_loc, tab, lim, *, plan_l, D, axis, size, interpret):
    """Per-device program over its local lanes (see the module docstring)."""
    d = jax.lax.axis_index(axis).astype(jnp.int32)
    words = words_loc[0]
    cnt, ex = lg.discover(words, tab, lim, plan=plan_l, interpret=interpret)

    shard_ex, shard_cnt = _span_map(cnt, ex, G=plan_l.lanes)
    all_ex = jax.lax.all_gather(shard_ex, axis)  # (D, H)
    all_cnt = jax.lax.all_gather(shard_cnt, axis)

    def comp(k, carry):
        e, base, my_e, my_base = carry
        mine = k == d
        my_e = jnp.where(mine, e, my_e)
        my_base = jnp.where(mine, base, my_base)
        return all_ex[k, e], base + all_cnt[k, e], my_e, my_base

    z = jnp.int32(0)
    _, total, my_e, my_base = jax.lax.fori_loop(0, D, comp, (z, z, z, z))

    entry_off, base, _, _ = _compose(cnt, ex, my_e, my_base, G=plan_l.lanes)
    out = lg.decode_lanes(words, tab, entry_off, base, lim,
                          jnp.zeros(size + 1, jnp.uint8), plan=plan_l,
                          interpret=interpret)
    return jax.lax.psum(out, axis), total[None]


@functools.lru_cache(maxsize=32)
def _compiled(mesh: Mesh, axis: str, plan: lg.LanePlan, size: int,
              interpret: bool):
    D = int(mesh.devices.size)
    Wl = plan.lanes // D * (plan.lane_bits // lg.WORD_BITS)
    plan_l = dataclasses.replace(plan, lanes=plan.lanes // D)
    body = functools.partial(_shard_body, plan_l=plan_l, D=D, axis=axis,
                             size=size, interpret=interpret)
    # check_vma off: Pallas kernels (and their interpreter) do not carry
    # the varying-axes types that shard_map's checker needs
    mapped = shard_map(body, mesh=mesh,
                       in_specs=(P(axis, None), P(), P(axis)),
                       out_specs=(P(), P(axis)), check_vma=False)

    def program(payload, tab, lim):
        # each shard's words plus the next shard's first words as its halo
        words = lg.stage_words(payload, plan)
        main = words[: D * Wl].reshape(D, Wl)
        halo = words[(jnp.arange(1, D + 1)[:, None] * Wl
                      + jnp.arange(plan.words)[None, :])]
        shards = jax.lax.with_sharding_constraint(
            jnp.concatenate([main, halo], axis=1),
            NamedSharding(mesh, P(axis, None)))
        out, total = mapped(shards, tab, lim)
        return out[:size], total[0]

    return jax.jit(program)


def lane_sharded_runner(hf, mesh: Mesh | None = None,
                        lanes: int | None = None, *, interpret: bool = False):
    """Stage inputs once and return ``(run, materialize)``.

    ``run()`` executes only the compiled sharded program (per-shard kernels
    + the stitching collectives) and returns its outputs; ``materialize``
    brings them to the host as ``(bytes, total)``.  This is the
    benchmarking surface: scaling sweeps time ``run``.  ``interpret`` runs
    the kernels in the Pallas interpreter (tests only)."""
    lg.require_gpu(interpret)
    if mesh is None:
        mesh = make_mesh()
    D = int(mesh.devices.size)
    dfa = build_lane_dfa(hf.tree)
    plan = lg.plan_lanes(hf.bits, dfa.height, lanes)
    # whole shards: lanes past the stream end decode nothing
    plan = dataclasses.replace(plan, lanes=-(-plan.lanes // D) * D)
    fn = _compiled(mesh, BLOCK_AXIS, plan, int(hf.uncompressed_size),
                   interpret)
    shard_bits = plan.lanes // D * plan.lane_bits
    lim = hf.bits - shard_bits * np.arange(D, dtype=np.int64)
    payload = jnp.asarray(hf.payload)
    tab = jnp.asarray(dfa.entry)
    lim = jax.device_put(lim.astype(np.int32), NamedSharding(mesh, P(BLOCK_AXIS)))

    def run():
        return fn(payload, tab, lim)

    def materialize(out):
        dense, total = out
        return np.asarray(dense), int(total)

    return run, materialize


def decode_lane_sharded(hf, mesh: Mesh | None = None,
                        lanes: int | None = None, check_size: bool = True,
                        *, interpret: bool = False) -> np.ndarray:
    """Lane decode with lanes sharded over a device mesh (see
    ``lane_sharded_runner`` for the staged benchmarking surface)."""
    run, materialize = lane_sharded_runner(hf, mesh=mesh, lanes=lanes,
                                           interpret=interpret)
    out, total = materialize(run())
    if check_size and total != hf.uncompressed_size:
        raise RuntimeError(
            f"decoded {total} symbols, header says {hf.uncompressed_size}")
    return out
