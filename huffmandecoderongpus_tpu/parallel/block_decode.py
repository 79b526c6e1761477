"""Block-parallel sharded decode: the multi-chip speculative pipeline.

The reference parallelizes over bits *within one device*
(reference framework/fastgpu.cu:33-34 grid-stride); it has no
inter-device story (SURVEY §2.3).  This module adds one, designed for a
device mesh rather than translated from CUDA:

  * The bitstream is split into D equal **blocks** of S bits, one per mesh
    device (`shard_map` over the 1-D "blocks" axis).
  * Stage 1 (decodeAllBits) and the pointer-doubling run **locally per
    block**, with spans clipped at the block edge — the O(bits·log) work
    never crosses devices.
  * The only cross-device data: each block's **entry-candidate exit map**.
    A codeword is at most `height` bits, so a decode chain can enter block d
    only at one of its first `height` bit positions.  Each block publishes,
    for those candidates, (exit position, symbols consumed) — a (D, H) pair
    of tiny arrays moved by one `all_gather` — and every device
    redundantly composes the D maps in a `fori_loop` to learn its true entry
    bit and global output base.  This replaces the reference's per-level
    host↔device flag round-trip (fastgpu.cu:245-261) *and* its global
    pointer-doubling traffic with one collective of O(D·height) ints.
  * Index assignment (calcbitsindex, pes.c:73-85) then runs block-locally,
    seeded at the block's true entry, and symbols scatter into a padded
    per-block output span (calcresult, pes.c:87-96).  Spans are gathered
    already ordered by the output sharding; the host trims the padding
    (variable per-block symbol counts) and concatenates.

The compressed words are replicated to all devices (compressed input is the
small side of a codec; kjv's payload is 3 MB).  A halo-sharded variant can
replace this when streams outgrow HBM.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from huffmandecoderongpus_tpu.huffio.bitio import payload_to_words_u32
from huffmandecoderongpus_tpu.ops.lut import DecodeLUT, build_decode_lut
from huffmandecoderongpus_tpu.ops.speculative import extract_windows
from huffmandecoderongpus_tpu.parallel.mesh import BLOCK_AXIS, make_mesh


def _block_levels(S: int) -> int:
    """Doubling levels so 2^L >= S: a block chain has at most S codewords."""
    return max((S - 1).bit_length(), 1)


def _shard_body(words, lut_sym, lut_len, *, S, N, D, H, L, height, axis):
    """Per-block program (runs under shard_map; all shapes static)."""
    d = jax.lax.axis_index(axis).astype(jnp.int32)
    start = d * S
    end = start + S
    bl = jnp.arange(S, dtype=jnp.int32)  # block-local bit positions
    b = start + bl  # absolute bit positions

    # Stage 1: decodeAllBits as windows + LUT gather (pes.c:30-46 semantics).
    win = extract_windows(words, b, height).astype(jnp.int32)
    ln = jnp.take(lut_len, win, mode="clip")
    sym = jnp.take(lut_sym, win, mode="clip")

    # Wrong-walk offsets whose codeword overruns the stream jump straight to
    # the terminal N; bits at/past N are terminal where they stand.  Neither
    # is ever on the true chain.
    valid0 = (b < N) & (b + ln <= N)
    hop = jnp.where(valid0, b + ln, jnp.where(b < N, N, b))
    cnt = jnp.where(valid0, 1, 0).astype(jnp.int32)

    # Block-local step levels for index assignment: s_k[b] spans 2^k
    # codewords iff the whole span stays inside the block and the stream
    # (the -1 convention of makebigtable, pes.c:48-71, with `bits` tightened
    # to the block edge).
    lim = jnp.minimum(end, N)
    s = jnp.where(valid0 & (b + ln < lim), ln, -1)
    steps = [s]

    # Saturating (hop, cnt) doubling: after L levels every local bit knows
    # where its chain first leaves the block and how many symbols it emits
    # on the way — the block's exit map.
    for _ in range(L):
        inside = hop < lim
        t = jnp.clip(hop - start, 0, S - 1)
        hop_t = jnp.take(hop, t)
        cnt_t = jnp.take(cnt, t)
        hop = jnp.where(inside, hop_t, hop)
        cnt = jnp.where(inside, cnt + cnt_t, cnt)
        s_prev = steps[-1]
        tt = jnp.clip(bl + s_prev, 0, S - 1)
        s_t = jnp.take(s_prev, tt)
        ok = (s_prev != -1) & (s_t != -1) & (b + s_prev + s_t < lim)
        steps.append(jnp.where(ok, s_prev + s_t, -1))

    # Publish the entry-candidate slice of the exit map; one tiny all_gather.
    exits = jax.lax.all_gather(hop[:H], axis)  # (D, H)
    counts = jax.lax.all_gather(cnt[:H], axis)  # (D, H)

    # Compose the D maps (identical scan on every device — no broadcast
    # needed afterwards): entry bit e_k and output base B_k per block.
    def comp(k, carry):
        e, base, my_e, my_base, my_n = carry
        blk_start = k * S
        done = e >= N
        j = jnp.clip(e - blk_start, 0, H - 1)
        ex = jnp.where(done, e, exits[k, j])
        cn = jnp.where(done, 0, counts[k, j])
        is_mine = k == d
        my_e = jnp.where(is_mine, e, my_e)
        my_base = jnp.where(is_mine, base, my_base)
        my_n = jnp.where(is_mine, cn, my_n)
        return ex, base + cn, my_e, my_base, my_n

    # the carry becomes device-varying inside the loop (via `d`); mark the
    # replicated zero seeds as varying so the vma checker accepts the scan
    z = jax.lax.pcast(jnp.int32(0), (axis,), to='varying')
    _final_e, total, my_e, my_base, my_n = jax.lax.fori_loop(
        0, D, comp, (z, z, z, z, z))

    # Stages 4+5 fused, gather-only (see ops/speculative.py): local output
    # index i starts at the block's true entry offset and jumps forward by
    # the level-k span for every set bit k of i — binary decomposition as
    # pure gathers, no scatters.  Entries past my_n yield garbage that the
    # host trims away.
    j0 = jnp.clip(my_e - start, 0, S - 1)
    il = jnp.arange(S, dtype=jnp.int32)
    pos = jnp.full(S, j0, dtype=jnp.int32)
    for k in range(len(steps) - 1, -1, -1):
        delta = jnp.take(steps[k], pos, mode="clip")
        take = ((il >> k) & 1) == 1
        pos = jnp.where(take, pos + jnp.maximum(delta, 0), pos)
    span = jnp.take(sym, pos, mode="clip")

    return span[None], my_n[None], total[None], my_e[None]


@functools.lru_cache(maxsize=64)
def _compiled(mesh: Mesh, axis: str, S: int, N: int, D: int, H: int, L: int,
              height: int):
    body = functools.partial(
        _shard_body, S=S, N=N, D=D, H=H, L=L, height=height, axis=axis)
    mapped = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P()),  # words + LUTs replicated
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
        check_vma=True,
    )
    return jax.jit(mapped)


def decode_sharded_arrays(words, lut_sym, lut_len, *, bits, size, height,
                          mesh, axis=BLOCK_AXIS):
    """Device part of the sharded decode. Returns (spans (D,S), counts (D,),
    total (D,), entries (D,)) — spans padded, ordered by block."""
    D = mesh.devices.size
    S = -(-bits // D)
    S = max(S, height)  # entry candidates must fit inside a block
    S = (S + 31) & ~31  # word-aligned blocks
    L = _block_levels(S)
    fn = _compiled(mesh, axis, S, int(bits), D, int(height), L, int(height))
    return fn(words, lut_sym, lut_len), S


def decode_sharded(hf, mesh: Mesh | None = None, lut: DecodeLUT | None = None,
                   check_size: bool = True) -> np.ndarray:
    """Decode a HuffFile block-parallel over a device mesh.

    Host wrapper: ships replicated words + LUT, runs the sharded program,
    trims the padded per-block spans and concatenates in block order.
    """
    if mesh is None:
        mesh = make_mesh()
    if lut is None:
        lut = build_decode_lut(hf.tree)
    words = payload_to_words_u32(hf.payload, hf.bits, extra_words=2)
    (spans, counts, totals, _entries), _S = decode_sharded_arrays(
        jnp.asarray(words), jnp.asarray(lut.sym), jnp.asarray(lut.length),
        bits=hf.bits, size=hf.uncompressed_size, height=lut.height, mesh=mesh)
    spans = np.asarray(spans)
    counts = np.asarray(counts)
    total = int(np.asarray(totals)[0])
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
