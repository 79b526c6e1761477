"""Lane-parallel bit-serial DFA decode in plain XLA.

The stream is cut into lanes that decode in parallel, one bit per step:

  * The stream is cut into G equal **lanes** of B bits; a (B+H, G) bit
    matrix (H = tree height rows of halo from the next lane) puts step j of
    every lane in one row — static slicing, no gather.
  * Each lane walks the Huffman tree **one bit per step** via a single fused
    transition table: entry = next-state | emit-flag | symbol with the
    root-reset folded in, so a step is one small-table lookup + shifts.  The
    table has 2*(internal nodes) entries (<= ~1k for byte alphabets).
  * Decoded symbols land **padded by step** (B+H, G): the write position is
    static (no scatter); per-lane compaction to dense bytes happens after.
  * Lanes start mid-codeword.  A chain can enter lane g only at one of its
    first H bit offsets, so each lane runs H candidate chains to its exit
    (cnt symbols, exit offset into the next lane's candidate window) and a
    cheap sequential composition — the same exit-map stitching as the
    sharded decoder (parallel/block_decode.py) — fixes each lane's true
    (entry offset, output base).  Files carrying a block-index sidecar
    (huffio/sidecar.py) skip discovery entirely.

The GPU decode path (ops/lane_gpu.py) runs the same discovery and decode as
kernels and reuses this module's table and composition; this XLA version is
its plain reference.

Role in the zoo: device counterpart of the serial DFA decoders
(jumptableapproach.c / linapproach.c semantics) and the performance
successor of the speculative pipeline's device build (fastgpuOpt1.cu role).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from huffmandecoderongpus_tpu.huffio.bitio import unpack_bits

EMIT_BIT = 1 << 10
STATE_MASK = (1 << 10) - 1


# ---------------------------------------------------------------------------
# Fused transition table


@dataclasses.dataclass(frozen=True)
class LaneDFA:
    """Fused bit-transition table over tree-node states.

    ``entry[node*2 + bit]`` packs, as one int32:
      bits 0..9   next state (the root-reset on leaves already applied)
      bit  10     emit flag (a codeword just completed)
      bits 16..23 emitted symbol
    """

    entry: np.ndarray  # (2 * nodes,) int32
    nodes: int
    height: int
    min_depth: int


def build_lane_dfa(tree: np.ndarray) -> LaneDFA:
    """Build the fused table from the reference node-array tree layout
    (huffdata.h:12-16: [sym, izero, ione], row 0 root, leaf <=> izero==-1).

    Only internal nodes are ever DFA states (a leaf transition folds into
    emit + root-reset), so states are renumbered to the internal nodes,
    halving the table."""
    from huffmandecoderongpus_tpu.huffio.tree import table_height, table_min_depth

    tree64 = np.ascontiguousarray(tree, dtype=np.int64)
    n = tree64.shape[0]
    internal = tree64[:, 1] != -1
    n_states = max(int(internal.sum()), 1)
    if n_states > STATE_MASK:
        raise ValueError(f"{n_states} states exceed the {STATE_MASK}-state encoding")
    state_of = np.cumsum(internal) - 1  # original node -> packed state id
    if internal.any() and state_of[0] != 0:
        raise ValueError("root must be node 0 (huffdata.h layout)")
    entry = np.zeros(2 * n_states, dtype=np.int32)
    for bit in (0, 1):
        child = tree64[internal, 1 + bit]
        child_safe = np.clip(child, 0, n - 1)
        leaf = tree64[child_safe, 1] == -1
        sym = tree64[child_safe, 0] & 0xFF
        val = np.where(leaf, (sym << 16) | EMIT_BIT, state_of[child_safe])
        entry[bit::2] = val.astype(np.int32)
    t32 = np.ascontiguousarray(tree, dtype=np.int32)
    return LaneDFA(entry=entry, nodes=n, height=table_height(t32),
                   min_depth=table_min_depth(t32))


# ---------------------------------------------------------------------------
# Bit-matrix layout


def bits_matrix(payload: np.ndarray, bits: int, lanes: int, halo: int,
                round_to: int = 1):
    """(B + halo, G) uint8 bit matrix: element [j, g] is stream bit
    ``g*B + j`` (so rows >= B replicate the head of the next lane); the tail
    past the stream end is zero.  Returns (matrix, B).

    ``round_to`` buckets the per-lane width B upward so nearby stream sizes
    share one compiled program (the scans mask by the true bit count) —
    without it the graphtest truncation sweeps recompile at every size."""
    arr = unpack_bits(payload, bits)
    B = -(-bits // lanes)
    if round_to > 1:
        B = -(-B // round_to) * round_to
    flat = np.zeros(lanes * B + halo, dtype=np.uint8)
    flat[:bits] = arr
    # column g is the view flat[g*B : g*B + B + halo] (overlapping windows)
    mat = np.lib.stride_tricks.as_strided(
        flat, shape=(B + halo, lanes), strides=(flat.itemsize, B * flat.itemsize))
    return np.ascontiguousarray(mat), B


def pick_lanes(bits: int, target_block_bits: int = 4096, max_lanes: int = 1 << 15) -> int:
    """Lane count: a power of two, blocks >= target_block_bits."""
    g = max(1, bits // max(target_block_bits, 1))
    g = 1 << max(g.bit_length() - 1, 0)  # floor to power of two
    return int(min(max(g, 1), max_lanes))


# ---------------------------------------------------------------------------
# Device scans


#: scan unrolling for the long per-bit loops (amortizes per-step overhead)
SCAN_UNROLL = 8


@functools.partial(jax.jit, static_argnames=("B", "H", "N", "G"))
def _lane_scan(bits_t, entry_tab, start_off, *, B, H, N, G):
    """Walk each lane from its true entry offset; emissions padded by step.

    A lane decodes every codeword that *starts* inside it; the last one may
    complete inside the halo rows (j >= B), after which the lane goes idle.
    Returns (sym (B+H, G) u8, valid (B+H, G) bool).
    """
    j0 = start_off.astype(jnp.int32)
    lane_base = jnp.arange(G, dtype=jnp.int32) * B

    def step(carry, inp):
        node, done = carry
        bit, j = inp
        e = jnp.take(entry_tab, node * 2 + bit.astype(jnp.int32), mode="clip")
        active = (j >= j0) & ~done & (lane_base + j < N)
        emit = active & ((e & EMIT_BIT) != 0)
        nxt = jnp.where(active, e & STATE_MASK, node)
        # boundary j+1 >= B => the lane's last codeword just finished
        done = done | (emit & (j + 1 >= B))
        return (nxt, done), ((e >> 16).astype(jnp.uint8), emit)

    js = jnp.arange(B + H, dtype=jnp.int32)
    node0 = jnp.zeros(G, dtype=jnp.int32)
    done0 = jnp.zeros(G, dtype=bool)
    _, (sym, valid) = jax.lax.scan(step, (node0, done0), (bits_t, js),
                                   unroll=SCAN_UNROLL)
    return sym, valid


@functools.partial(jax.jit, static_argnames=("B", "H", "N", "G"))
def _candidate_scan(bits_t, entry_tab, *, B, H, N, G):
    """All H candidate chains per lane, to their exits.

    Chain (g, o) starts at the root at row o and decodes until its first
    boundary at row >= B (i.e. it has consumed every codeword starting in
    lane g).  Returns (cnt (H, G) i32, exit_off (H, G) i32 in [0, H)): the
    symbols it emitted and the offset of its first boundary in lane g+1.
    """
    offs = jnp.arange(H, dtype=jnp.int32)[:, None]
    lane_base = jnp.arange(G, dtype=jnp.int32)[None, :] * B

    def step(carry, inp):
        node, cnt, ex, done = carry
        bit, j = inp
        e = jnp.take(entry_tab, node * 2 + bit[None, :].astype(jnp.int32),
                     mode="clip")
        active = (j >= offs) & ~done & (lane_base + j < N)
        emit = active & ((e & EMIT_BIT) != 0)
        nxt = jnp.where(active, e & STATE_MASK, node)
        cnt = cnt + emit.astype(jnp.int32)
        exiting = emit & (j + 1 >= B)
        ex = jnp.where(exiting, j + 1 - B, ex)
        return (nxt, cnt, ex, done | exiting), None

    js = jnp.arange(B + H, dtype=jnp.int32)
    z = jnp.zeros((H, G), dtype=jnp.int32)
    (node, cnt, ex, done), _ = jax.lax.scan(
        step, (z, z, z, jnp.zeros((H, G), dtype=bool)), (bits_t, js),
        unroll=SCAN_UNROLL)
    return cnt, ex


def _group_maps(cnt, exit_off, G):
    """Pass 1 of the composition: lanes fold into sqrt(G)-sized groups in
    parallel, each group's composite exit map evaluated at ALL H entries.
    Returns (exg, cng, gstate, gcount): the per-lane maps as
    (H, ngroups, R) and each group's (exit, count) per entry as
    (H, ngroups)."""
    H = cnt.shape[0]
    R = 1
    while R * R < G:
        R <<= 1
    ngroups = -(-G // R)
    pad = ngroups * R - G
    ex = exit_off
    cn = cnt
    if pad:
        # identity maps for padding lanes: entry h -> exit h, 0 symbols
        id_ex = jnp.tile(jnp.arange(H, dtype=ex.dtype)[:, None], (1, pad))
        ex = jnp.concatenate([ex, id_ex], axis=1)
        cn = jnp.concatenate([cn, jnp.zeros((H, pad), cn.dtype)], axis=1)
    exg = ex.reshape(H, ngroups, R)
    cng = cn.reshape(H, ngroups, R)

    def in_group(r, carry):
        state, csum = carry
        csum = csum + _sel0(cng[:, :, r], state)
        state = _sel0(exg[:, :, r], state)
        return state, csum

    state0 = jnp.tile(jnp.arange(H, dtype=jnp.int32)[:, None], (1, ngroups))
    gstate, gcount = jax.lax.fori_loop(
        0, R, in_group,
        (state0, jnp.zeros((H, ngroups), jnp.int32)))
    return exg, cng, gstate, gcount


def _sel0(tab2d, idx2d):
    """``take_along_axis(tab2d, idx2d, axis=0)`` as H selects: faster than
    the gather on the H100 inside these loops (PERF.md, Kernel
    decisions)."""
    out = jnp.broadcast_to(tab2d[0], idx2d.shape)
    for hh in range(1, tab2d.shape[0]):
        out = jnp.where(idx2d == hh, tab2d[hh], out)
    return out


@functools.partial(jax.jit, static_argnames=("G",))
def _compose(cnt, exit_off, entry0=0, base0=0, *, G):
    """Chain the per-lane exit maps: lane 0 enters at offset ``entry0``
    with output base ``base0``; lane g+1 enters where lane g's true chain
    exits.  Returns (entry_off (G,), base (G,), n (G,), total), where
    ``total`` is ``base0`` plus the symbols of all G lanes.

    Blocked two-level composition: a naive scan is G sequential steps.
    Exit maps compose associatively, so lanes fold into sqrt(G)-sized
    groups in parallel (:func:`_group_maps`), one short scan chains the
    groups, and a second parallel pass recovers per-lane entries —
    ~3*sqrt(G) sequential steps total.
    """
    exg, cng, gstate, gcount = _group_maps(cnt, exit_off, G)
    ngroups = gstate.shape[1]
    R = exg.shape[2]

    # pass 2: short sequential chain over the groups
    def g_step(carry, g):
        off, base = carry
        return (gstate[off, g], base + gcount[off, g]), (off, base)

    (_, total), (g_off, g_base) = jax.lax.scan(
        g_step, (jnp.asarray(entry0, jnp.int32), jnp.asarray(base0, jnp.int32)),
        jnp.arange(ngroups, dtype=jnp.int32))

    # pass 3: per-lane entries within every group, in parallel over groups
    def lane_step(carry, r):
        off, base = carry  # (ngroups,)
        n = _sel0(cng[:, :, r], off[None, :])[0]
        nxt = _sel0(exg[:, :, r], off[None, :])[0]
        return (nxt, base + n), (off, base, n)

    _, (offs, bases, ns) = jax.lax.scan(
        lane_step, (g_off, g_base), jnp.arange(R, dtype=jnp.int32))
    entry_off = offs.T.reshape(-1)[:G]
    base = bases.T.reshape(-1)[:G]
    n = ns.T.reshape(-1)[:G]
    return entry_off, base, n, total


def _span_map(cnt, exit_off, *, G):
    """The composite exit map of all G lanes: for each entry offset h of
    lane 0, (exit offset past lane G-1, symbols emitted), each (H,)."""
    _, _, gstate, gcount = _group_maps(cnt, exit_off, G)
    H = cnt.shape[0]

    def fold(g, carry):
        off, n = carry
        return gstate[off, g], n + gcount[off, g]

    return jax.lax.fori_loop(
        0, gstate.shape[1], fold,
        (jnp.arange(H, dtype=jnp.int32), jnp.zeros(H, jnp.int32)))


@functools.partial(jax.jit, static_argnames=("B", "G"))
def _lane_scan_indexed(bits_t, entry_tab, lane_len, *, B, G):
    """Scan for symbol-aligned lanes (sidecar path): lane g starts on a
    codeword boundary at row 0 and ends exactly at row lane_len[g]."""
    def step(carry, inp):
        node = carry
        bit, j = inp
        e = jnp.take(entry_tab, node * 2 + bit.astype(jnp.int32), mode="clip")
        active = j < lane_len
        emit = active & ((e & EMIT_BIT) != 0)
        nxt = jnp.where(active, e & STATE_MASK, node)
        return nxt, ((e >> 16).astype(jnp.uint8), emit)

    js = jnp.arange(B, dtype=jnp.int32)
    node0 = jnp.zeros(G, dtype=jnp.int32)
    _, (sym, valid) = jax.lax.scan(step, node0, (bits_t, js),
                                   unroll=SCAN_UNROLL)
    return sym, valid


def decode_lanedfa_indexed(hf, offsets: np.ndarray, block_symbols: int,
                           check_size: bool = True) -> np.ndarray:
    """Decode with a `.huffidx` sidecar: one lane per indexed block, no
    entry discovery, exact per-lane symbol counts."""
    dfa = build_lane_dfa(hf.tree)
    offsets = np.asarray(offsets, dtype=np.int64)
    G = offsets.shape[0]
    ends = np.append(offsets[1:], hf.bits)
    lens = ends - offsets
    if np.any(lens < 0) or (G and offsets[0] != 0):
        raise ValueError("corrupt block index: offsets not increasing from 0")
    B = int(lens.max(initial=1))

    flat = np.zeros(hf.bits + B, dtype=np.uint8)
    flat[: hf.bits] = unpack_bits(hf.payload, hf.bits)
    idx = offsets[None, :].astype(np.int64) + np.arange(B)[:, None]
    mat = flat[idx]

    sym, valid = _lane_scan_indexed(
        jnp.asarray(mat), jnp.asarray(dfa.entry),
        jnp.asarray(lens, dtype=jnp.int32), B=B, G=G)
    sym_t = np.asarray(sym).T
    valid_t = np.asarray(valid).T
    out = sym_t[valid_t]
    if check_size and out.size != hf.uncompressed_size:
        raise RuntimeError(
            f"decoded {out.size} symbols, header says {hf.uncompressed_size}")
    return out


# ---------------------------------------------------------------------------
# Host wrapper


def decode_lanedfa(hf, lanes: int | None = None, entries=None,
                   check_size: bool = True) -> np.ndarray:
    """Decode a HuffFile with the lane-parallel bit DFA.

    ``entries``: optional (entry_off (G,), base (G,)) from a sidecar index;
    when absent, entry discovery runs on device (candidate chains +
    composition).
    """
    dfa = build_lane_dfa(hf.tree)
    G = pick_lanes(hf.bits) if lanes is None else int(lanes)
    H = max(dfa.height, 1)
    # entry offsets live in [0, H): a lane must be at least H bits wide or a
    # chain could skip it entirely and the composition would break
    G = max(1, min(G, hf.bits // H if hf.bits >= H else 1))
    mat, B = bits_matrix(hf.payload, hf.bits, G, H, round_to=512)
    bits_t = jnp.asarray(mat)
    tab = jnp.asarray(dfa.entry)

    if entries is None:
        cnt, ex = _candidate_scan(bits_t, tab, B=B, H=H, N=hf.bits, G=G)
        entry_off, base, n, total = _compose(cnt, ex, G=G)
        total = int(total)
    else:
        entry_off, base = (jnp.asarray(e, dtype=jnp.int32) for e in entries)
        n = None
        total = hf.uncompressed_size

    sym, valid = _lane_scan(bits_t, tab, entry_off, B=B, H=H, N=hf.bits, G=G)
    if check_size and total != hf.uncompressed_size:
        raise RuntimeError(
            f"decoded {total} symbols, header says {hf.uncompressed_size}")

    sym_t = np.asarray(sym).T  # (G, B+H)
    valid_t = np.asarray(valid).T
    out = sym_t[valid_t]
    if check_size and out.size != hf.uncompressed_size:
        raise RuntimeError(
            f"emitted {out.size} symbols, header says {hf.uncompressed_size}")
    return out
