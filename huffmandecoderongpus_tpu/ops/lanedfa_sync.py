"""Self-synchronizing entry discovery for the lane DFA: (1+eps)x, exact.

The baseline discovery (ops/lanedfa.py::_candidate_scan) walks all H = tree
height candidate chains across every lane — an H-fold overhead on the whole
stream.  Huffman chains self-synchronize: two chains that reach a common
codeword boundary are identical from there on.  This module exploits that
WITHOUT giving up exactness:

  1. The main scan runs once per lane from bit offset 0 (the "0-chain"),
     recording its padded emissions — these double as the decode output for
     every lane whose true entry offset turns out to be 0 (the common case)
     and as the merge target for the rest.
  2. Every other candidate chain walks only until its emission lands on a
     row where the 0-chain also emitted: both chains then sit on the same
     boundary, so the candidate's remaining symbols equal the 0-chain's.
     (The merge-row codewords themselves may differ — same end, different
     start — so the splice keeps candidate rows *through* the merge row.)
     Candidates that exit their lane before merging carry full information
     themselves.  The walk length W doubles until every candidate has
     merged or exited — adversarial streams degrade gracefully toward the
     baseline cost, never to wrongness.
  3. The single lane containing the stream end gets the full baseline scan
     (one column — negligible), since its chains end without exiting.
  4. Composition picks each lane's true candidate; lanes with nonzero true
     offsets get their rows up to the merge row re-decoded by one short
     scan and spliced over the 0-chain's emissions.

Everything here is short-scan work; the expensive full-lane scan is the one
the caller already runs (XLA or Pallas), so both backends share this.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from huffmandecoderongpus_tpu.ops.lanedfa import (
    EMIT_BIT,
    STATE_MASK,
    SCAN_UNROLL,
    _candidate_scan,
)


@functools.partial(jax.jit, static_argnames=("B", "H", "N", "G", "W"))
def _short_candidate_scan(bits_t, entry_tab, valid0, *, B, H, N, G, W):
    """Walk all H candidates for W rows, stopping at merge or exit.

    Returns per (o, g):
      merged   bool — emitted on a row where the 0-chain emitted
      exited   bool — reached a boundary >= B before merging
      mrow     i32  — merge emission row (valid iff merged)
      cnt      i32  — emissions through resolution (merge row included)
      exit_off i32  — exit offset (valid iff exited)
    """
    offs = jnp.arange(H, dtype=jnp.int32)[:, None]
    lane_base = jnp.arange(G, dtype=jnp.int32)[None, :] * B

    def step(carry, inp):
        node, cnt, mrow, ex, merged, exited = carry
        bit, v0, j = inp
        e = jnp.take(entry_tab, node * 2 + bit[None, :].astype(jnp.int32),
                     mode="clip")
        live = (j >= offs) & ~merged & ~exited & (lane_base + j < N)
        emit = live & ((e & EMIT_BIT) != 0)
        nxt = jnp.where(live, e & STATE_MASK, node)
        merge_now = emit & v0[None, :]
        exit_now = emit & ~merge_now & (j + 1 >= B)
        cnt = cnt + emit.astype(jnp.int32)
        mrow = jnp.where(merge_now, j, mrow)
        ex = jnp.where(exit_now, j + 1 - B, ex)
        return (nxt, cnt, mrow, ex, merged | merge_now, exited | exit_now), None

    z = jnp.zeros((H, G), dtype=jnp.int32)
    f = jnp.zeros((H, G), dtype=bool)
    js = jnp.arange(W, dtype=jnp.int32)
    (node, cnt, mrow, ex, merged, exited), _ = jax.lax.scan(
        step, (z, z, z, z, f, f), (bits_t[:W], valid0[:W], js),
        unroll=SCAN_UNROLL)
    return merged, exited, mrow, cnt, ex


def _compose_sync(cnt_total, exit_off, *, G):
    """Composition over lanes — delegates to the blocked lanedfa._compose."""
    from huffmandecoderongpus_tpu.ops.lanedfa import _compose

    return _compose(cnt_total, exit_off, G=G)


@functools.partial(jax.jit, static_argnames=("B", "H", "N", "G", "W"))
def _fix_scan(bits_t, entry_tab, start_off, *, B, H, N, G, W):
    """Re-decode the first W rows of every lane from its true entry offset
    (single carrier).  Returns (sym (W, G) u8, valid (W, G) bool)."""
    j0 = start_off.astype(jnp.int32)
    lane_base = jnp.arange(G, dtype=jnp.int32) * B

    def step(carry, inp):
        node, done = carry
        bit, j = inp
        e = jnp.take(entry_tab, node * 2 + bit.astype(jnp.int32), mode="clip")
        active = (j >= j0) & ~done & (lane_base + j < N)
        emit = active & ((e & EMIT_BIT) != 0)
        nxt = jnp.where(active, e & STATE_MASK, node)
        done = done | (emit & (j + 1 >= B))  # lane's last codeword finished
        return (nxt, done), ((e >> 16).astype(jnp.uint8), emit)

    js = jnp.arange(W, dtype=jnp.int32)
    _, (sym, valid) = jax.lax.scan(
        step, (jnp.zeros(G, dtype=jnp.int32), jnp.zeros(G, dtype=bool)),
        (bits_t[:W], js), unroll=SCAN_UNROLL)
    return sym, valid


def discover_and_splice(bits_t, entry_tab, sym0, valid0, *, B, H, N, G,
                        W0: int = 128):
    """Entry discovery against an offset-0 main scan, plus output splicing.

    ``sym0``/``valid0`` are the main scan's padded emissions with all start
    offsets 0.  Returns (sym, valid, base (G,), n (G,), total) with the
    emissions corrected to the true chain.
    """
    steps = B + H
    v0i = valid0.astype(jnp.int32)
    cum0 = jnp.cumsum(v0i, axis=0)  # 0-chain emissions at rows <= j
    cnt0 = cum0[-1]
    rows = jnp.arange(steps, dtype=jnp.int32)[:, None]
    last_row = jnp.max(jnp.where(valid0, rows, -1), axis=0)
    exit0 = jnp.maximum(last_row + 1 - B, 0)

    lane_base = np.arange(G, dtype=np.int64) * B
    dead = jnp.asarray((lane_base[None, :] + np.arange(H)[:, None]) >= N)
    tail_lane = min(max((N - 1) // B, 0), G - 1)  # lane containing stream end

    W = min(max(W0, H + 1), steps)
    while True:
        merged, exited, mrow, cnt, ex = _short_candidate_scan(
            bits_t, entry_tab, valid0, B=B, H=H, N=N, G=G, W=W)
        resolved = merged | exited | dead
        unresolved = ~resolved
        # the tail lane's chains end at the stream without exiting; it gets
        # the full baseline scan below
        if G:
            unresolved = unresolved.at[:, tail_lane].set(False)
        if not bool(jnp.any(unresolved)) or W >= steps:
            break
        W = min(W * 2, steps)

    # candidate totals: merged ones continue as the 0-chain strictly after
    # the merge row (their own merge-row emission is already in cnt)
    cum_thru = jnp.take_along_axis(cum0, jnp.clip(mrow, 0, steps - 1), axis=0)
    cnt_total = jnp.where(merged, cnt + (cnt0[None, :] - cum_thru), cnt)
    exit_total = jnp.where(merged, exit0[None, :], ex)

    # exact full scan for the tail lane's candidate column
    if G:
        tcnt, tex = _candidate_scan(
            bits_t[:, tail_lane:tail_lane + 1], entry_tab,
            B=B, H=H, N=N - tail_lane * B, G=1)
        cnt_total = cnt_total.at[:, tail_lane].set(tcnt[:, 0])
        exit_total = exit_total.at[:, tail_lane].set(tex[:, 0])
        merged = merged.at[:, tail_lane].set(False)
        # the tail lane replays entirely in the fix scan (cut = steps)

    entry_off, base, n, total = _compose_sync(cnt_total, exit_total, G=G)

    # splice boundaries: offset-0 entries keep the 0-chain rows everywhere;
    # merged candidates replay rows <= merge row; unmerged ones replay all
    g = jnp.arange(G, dtype=jnp.int32)
    sel_merged = merged[entry_off, g]
    sel_mrow = mrow[entry_off, g]
    cut = jnp.where(entry_off == 0, 0,
                    jnp.where(sel_merged, sel_mrow + 1, steps))
    Wfix = int(jnp.max(cut)) if G else 0
    if Wfix > 0:
        Wfix = min(max(Wfix, 1), steps)
        fsym, fvalid = _fix_scan(bits_t, entry_tab, entry_off,
                                 B=B, H=H, N=N, G=G, W=Wfix)
        use_fix = rows[:Wfix] < cut[None, :]
        sym = sym0.at[:Wfix].set(jnp.where(use_fix, fsym, sym0[:Wfix]))
        valid = valid0.at[:Wfix].set(jnp.where(use_fix, fvalid, valid0[:Wfix]))
    else:
        sym, valid = sym0, valid0
    return sym, valid, base, n, total


def decode_lanedfa_sync(hf, lanes: int | None = None,
                        check_size: bool = True) -> np.ndarray:
    """Lane-DFA decode with self-synchronizing discovery (host wrapper)."""
    from huffmandecoderongpus_tpu.ops.lanedfa import (
        _lane_scan,
        build_lane_dfa,
        bits_matrix,
        pick_lanes,
    )

    dfa = build_lane_dfa(hf.tree)
    G = pick_lanes(hf.bits) if lanes is None else int(lanes)
    H = max(dfa.height, 1)
    G = max(1, min(G, hf.bits // H if hf.bits >= H else 1))
    mat, B = bits_matrix(hf.payload, hf.bits, G, H, round_to=512)
    bits_t = jnp.asarray(mat)
    tab = jnp.asarray(dfa.entry)

    zero = jnp.zeros(G, dtype=jnp.int32)
    sym0, valid0 = _lane_scan(bits_t, tab, zero, B=B, H=H, N=hf.bits, G=G)
    sym, valid, base, n, total = discover_and_splice(
        bits_t, tab, sym0, valid0, B=B, H=H, N=hf.bits, G=G)
    if check_size and int(total) != hf.uncompressed_size:
        raise RuntimeError(
            f"decoded {int(total)} symbols, header says {hf.uncompressed_size}")
    out = np.asarray(sym).T[np.asarray(valid).T]
    if check_size and out.size != hf.uncompressed_size:
        raise RuntimeError(
            f"emitted {out.size} symbols, header says {hf.uncompressed_size}")
    return out
