"""Per-stage profiling of the device pipelines.

Role parity with the reference's device-event profiling: the OpenCL build
accumulates per-kernel times (initbitsindex_time ... findmax_time,
openclapproach.c:273-283,414-424,704-714,826-836,908-918,972-983) and phase
accounting for build/buffer/memcpy time (openclapproach.c:21,240-243).
Here: each pipeline stage is jitted separately and timed on the host clock
around ``jax.block_until_ready``, plus a `jax.profiler` trace helper for
full XLA timelines.
"""

from __future__ import annotations

import contextlib
import time

import jax
import numpy as np


def _time_stage(fn, *args, reps: int = 5) -> tuple[float, object]:
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts), out


def profile_speculative(hf, reps: int = 5) -> dict[str, float]:
    """Stage breakdown of the speculative pipeline (decodeAllBits /
    makebigtable / index-query stages of ops/speculative.py)."""
    import jax.numpy as jnp

    from huffmandecoderongpus_tpu.ops.lut import build_decode_lut
    from huffmandecoderongpus_tpu.ops.speculative import (
        extract_windows,
        make_plan,
    )
    from huffmandecoderongpus_tpu.huffio.bitio import payload_to_words_u32

    lut = build_decode_lut(hf.tree)
    plan = make_plan(hf.bits, hf.uncompressed_size, lut.height)
    words = jnp.asarray(payload_to_words_u32(hf.payload, hf.bits, extra_words=1))
    lut_sym, lut_len = jnp.asarray(lut.sym), jnp.asarray(lut.length)
    bits, size, height, levels = plan.bits, plan.size, plan.height, plan.levels

    @jax.jit
    def stage1(words, lut_sym, lut_len):
        b = jnp.arange(bits, dtype=jnp.int32)
        win = extract_windows(words, b, height).astype(jnp.int32)
        ln = jnp.take(lut_len, win, mode="clip")
        sym = jnp.take(lut_sym, win, mode="clip")
        return jnp.where(b + ln <= bits, ln, -1), sym

    @jax.jit
    def doubling(step0):
        b = jnp.arange(bits, dtype=jnp.int32)
        steps = [step0]
        for _ in range(max(levels - 1, 0)):
            s = steps[-1]
            t = b + s
            tc = jnp.clip(t, 0, bits - 1)
            w = jnp.take(s, tc, mode="clip")
            ok = (s != -1) & (t < bits) & (w != -1) & (t + w <= bits)
            steps.append(jnp.where(ok, s + w, -1))
        return tuple(steps)

    @jax.jit
    def query(steps, sym):
        i = jnp.arange(size, dtype=jnp.int32)
        pos = jnp.zeros(size, dtype=jnp.int32)
        for k in range(levels - 1, -1, -1):
            delta = jnp.take(steps[k], pos, mode="clip")
            take = ((i >> k) & 1) == 1
            pos = jnp.where(take, pos + jnp.maximum(delta, 0), pos)
        return jnp.take(sym, pos, mode="clip")

    report = {}
    report["decodeAllBits"], (step0, sym) = _time_stage(
        stage1, words, lut_sym, lut_len, reps=reps)
    report["makebigtable"], steps = _time_stage(doubling, step0, reps=reps)
    report["index_query"], _ = _time_stage(query, steps, sym, reps=reps)
    report["total"] = sum(report.values())
    return report


def profile_lanedfa(hf, lanes: int | None = None, reps: int = 5) -> dict[str, float]:
    """Stage breakdown of the lane-DFA decoder (discovery / compose / main
    scan / host compaction)."""
    import jax.numpy as jnp

    from huffmandecoderongpus_tpu.ops import lanedfa as ld

    dfa = ld.build_lane_dfa(hf.tree)
    H = max(dfa.height, 1)
    G = ld.pick_lanes(hf.bits) if lanes is None else int(lanes)
    G = max(1, min(G, hf.bits // H if hf.bits >= H else 1))

    report = {}
    t0 = time.perf_counter()
    mat, B = ld.bits_matrix(hf.payload, hf.bits, G, H)
    report["host_bit_matrix"] = time.perf_counter() - t0
    bits_t = jnp.asarray(mat)
    tab = jnp.asarray(dfa.entry)

    report["candidate_scan"], (cnt, ex) = _time_stage(
        lambda b, t: ld._candidate_scan(b, t, B=B, H=H, N=hf.bits, G=G),
        bits_t, tab, reps=reps)
    report["compose"], (entry_off, base, n, total) = _time_stage(
        lambda c, e: ld._compose(c, e, G=G), cnt, ex, reps=reps)
    report["main_scan"], (sym, valid) = _time_stage(
        lambda b, t, o: ld._lane_scan(b, t, o, B=B, H=H, N=hf.bits, G=G),
        bits_t, tab, entry_off, reps=reps)
    t0 = time.perf_counter()
    sym_t = np.asarray(sym).T
    valid_t = np.asarray(valid).T
    _ = sym_t[valid_t]
    report["host_compaction"] = time.perf_counter() - t0
    report["total"] = sum(report.values())
    return report


def profile_lane_gpu(hf, lanes: int | None = None,
                     reps: int = 5) -> dict[str, float]:
    """Stage breakdown of the GPU lane-scan decoder (host-to-device / word
    staging / discovery kernel / composition / decode kernel /
    device-to-host)."""
    import jax.numpy as jnp

    from huffmandecoderongpus_tpu.ops import lane_gpu as lg
    from huffmandecoderongpus_tpu.ops import lanedfa as ld

    lg.require_gpu(False)
    dfa = ld.build_lane_dfa(hf.tree)
    plan = lg.plan_lanes(hf.bits, dfa.height, lanes)

    report = {}
    t0 = time.perf_counter()
    payload = jax.block_until_ready(jnp.asarray(hf.payload))
    report["h2d"] = time.perf_counter() - t0
    report["stage_words"], words = _time_stage(
        jax.jit(lambda p: lg.stage_words(p, plan)), payload, reps=reps)
    tab = jnp.asarray(dfa.entry)
    lim = jnp.full(1, hf.bits, jnp.int32)
    report["discover_kernel"], (cnt, ex) = _time_stage(
        lambda w, t: lg.discover(w, t, lim, plan=plan), words, tab, reps=reps)
    report["compose"], (entry_off, base, _, _) = _time_stage(
        lambda c, e: ld._compose(c, e, G=plan.lanes), cnt, ex, reps=reps)
    report["decode_kernel"], out = _time_stage(
        jax.jit(lambda w, t, o, b: lg.decode_lanes(
            w, t, o, b, lim, jnp.zeros(hf.uncompressed_size + 1, jnp.uint8),
            plan=plan)),
        words, tab, entry_off, base, reps=reps)
    t0 = time.perf_counter()
    np.asarray(out)
    report["d2h"] = time.perf_counter() - t0
    report["total"] = sum(report.values())
    return report


@contextlib.contextmanager
def trace(log_dir: str):
    """`jax.profiler` trace context for full XLA timelines (view with
    tensorboard or xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def format_report(report: dict[str, float]) -> str:
    width = max(len(k) for k in report)
    lines = [f"{k:>{width}}  {v * 1e3:10.3f} ms" for k, v in report.items()]
    return "\n".join(lines)
