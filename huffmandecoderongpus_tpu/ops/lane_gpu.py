"""Lane-scan Huffman decode for the GPU: one thread per lane.

The stream is cut into G lanes of B bits (B a whole number of 32-bit
words).  Two Pallas kernels on the Triton route do the bit-serial work, with
every DFA state held in registers for the whole walk:

1. **Discovery** — one thread per candidate chain.  Lane g can be entered at
   any of its first H bit offsets (H = tree height), so each lane runs H
   chains, each from the root at its offset to its first codeword boundary
   at or past the lane's end: the symbols it emitted and its exit offset
   into lane g+1 (the semantics of ``ops.lanedfa._candidate_scan``).
2. The plain XLA composition ``ops.lanedfa._compose`` chains the exit maps
   into each lane's true entry offset and output base.
3. **Decode** — one thread per lane walks from its true entry offset and
   writes each symbol straight to ``base[g] + k`` of the dense output.

Both kernels read the stream as packed little-endian 32-bit words (a lane
loads each word once and steps through its 32 bits) and look each step up
in the fused transition table of ``ops.lanedfa.build_lane_dfa`` (<= 2k
int32 entries, served from L1).  The payload bytes go to the device as they
are; the words are formed there.

``interpret=True`` runs the kernels in the Pallas interpreter; it exists
for the CPU tests only.  Without it the decoder needs a GPU and raises
anywhere else.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from huffmandecoderongpus_tpu.ops.lanedfa import (
    EMIT_BIT,
    STATE_MASK,
    _compose,
    build_lane_dfa,
)

WORD_BITS = 32

#: Lane geometry, from a sweep of 4k-128k lanes on the H100 (PERF.md,
#: Kernel decisions): the composition's sequential depth grows with
#: sqrt(lanes) and dominates beyond a few thousand lanes, so a stream gets
#: one lane per MIN_LANE_BITS bits, at most MAX_LANES of them.
MIN_LANE_BITS = 6144
MAX_LANES = 1 << 14

#: Threads per program (4 warps).
BLOCK = 128


@dataclasses.dataclass(frozen=True)
class LanePlan:
    """Geometry of one decode: ``lanes`` lanes of ``lane_bits`` bits (whole
    words, at least ``halo`` = tree height bits); every lane reads
    ``words`` words, its own plus the halo from the next lane."""

    lanes: int
    lane_bits: int
    halo: int
    words: int

    @property
    def stream_words(self) -> int:
        """Length of the staged word array: every lane's reads in bounds."""
        return self.lanes * (self.lane_bits // WORD_BITS) + self.words


def plan_lanes(bits: int, height: int, lanes: int | None = None) -> LanePlan:
    """Cut ``bits`` into about ``lanes`` word-aligned lanes (default: one
    per :data:`MIN_LANE_BITS`, at most :data:`MAX_LANES`).  A lane holds at
    least ``height`` bits, so a chain entering it at offset < height cannot
    skip it."""
    H = max(int(height), 1)
    if lanes is None:
        lanes = min(MAX_LANES, -(-bits // MIN_LANE_BITS))
    G = max(int(lanes), 1)
    B = WORD_BITS * max(-(-bits // (WORD_BITS * G)), -(-H // WORD_BITS), 1)
    G = max(1, -(-bits // B))
    return LanePlan(lanes=G, lane_bits=B, halo=H, words=-(-(B + H) // WORD_BITS))


def stage_words(payload, plan: LanePlan):
    """The (device) payload bytes as zero-padded little-endian int32 words:
    bit p of the stream is bit p % 32 of word p // 32."""
    pad = plan.stream_words * 4 - payload.shape[0]
    padded = jnp.pad(payload, (0, pad)).reshape(-1, 4).astype(jnp.int32)
    return padded[:, 0] | padded[:, 1] << 8 | padded[:, 2] << 16 | padded[:, 3] << 24


def _walk_word(tab_ref, word, w, node, step):
    """Step a chain through the 32 bits of ``word`` (word ``w`` of its
    lane); ``step(j, e, node) -> node`` applies one table entry."""
    for k in range(WORD_BITS):
        bit = (word >> k) & 1
        e = plgpu.load(tab_ref.at[node * 2 + bit])
        node = step(w * WORD_BITS + k, e, node)
    return node


def _discover_kernel(words_ref, tab_ref, lim_ref, cnt_ref, ex_ref, *, plan):
    G, B, H = plan.lanes, plan.lane_bits, plan.halo
    N = lim_ref[0]  # stream bits from this program's first lane on
    c = pl.program_id(0) * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
    live = c < G * H
    g = c // H  # neighbouring threads walk one lane: shared word loads
    o = c % H
    lane_base = g * B
    word0 = g * (B // WORD_BITS)

    def body(w, carry):
        node, cnt, ex, done = carry
        word = plgpu.load(words_ref.at[word0 + w], mask=live, other=0)

        def step(j, e, node):
            nonlocal cnt, ex, done
            active = (j >= o) & (done == 0) & (lane_base + j < N)
            emit = active & ((e & EMIT_BIT) != 0)
            exiting = emit & (j + 1 >= B)
            cnt = cnt + emit.astype(jnp.int32)
            ex = jnp.where(exiting, j + 1 - B, ex)
            done = done | exiting.astype(jnp.int32)
            return jnp.where(active, e & STATE_MASK, node)

        node = _walk_word(tab_ref, word, w, node, step)
        return node, cnt, ex, done

    z = jnp.zeros(BLOCK, dtype=jnp.int32)
    _, cnt, ex, _ = jax.lax.fori_loop(0, plan.words, body, (z, z, z, z))
    # (H, G) layout for the composition; dead threads write the sink slot
    dst = jnp.where(live, o * G + g, G * H)
    plgpu.store(cnt_ref.at[dst], cnt, mask=live)
    plgpu.store(ex_ref.at[dst], ex, mask=live)


def _decode_kernel(words_ref, tab_ref, entry_ref, base_ref, lim_ref, _init_ref,
                   out_ref, *, plan):
    G, B = plan.lanes, plan.lane_bits
    N = lim_ref[0]
    size = out_ref.shape[0] - 1  # the last slot is a sink
    g = pl.program_id(0) * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
    live = g < G
    j0 = plgpu.load(entry_ref.at[g], mask=live, other=0)
    pos0 = plgpu.load(base_ref.at[g], mask=live, other=0)
    lane_base = g * B
    word0 = g * (B // WORD_BITS)

    def body(w, carry):
        node, pos, done = carry
        word = plgpu.load(words_ref.at[word0 + w], mask=live, other=0)

        def step(j, e, node):
            nonlocal pos, done
            active = live & (j >= j0) & (done == 0) & (lane_base + j < N)
            emit = active & ((e & EMIT_BIT) != 0)
            ok = emit & (pos < size)
            # masked-off threads aim at the sink slot ``size``: a masked
            # store skips them on the card, and the interpreter's masked
            # scatter then cannot clobber a neighbour's byte
            plgpu.store(out_ref.at[jnp.where(ok, pos, size)],
                        (e >> 16).astype(jnp.uint8),
                        mask=ok)
            pos = pos + emit.astype(jnp.int32)
            done = done | (emit & (j + 1 >= B)).astype(jnp.int32)
            return jnp.where(active, e & STATE_MASK, node)

        node = _walk_word(tab_ref, word, w, node, step)
        return node, pos, done

    z = jnp.zeros(BLOCK, dtype=jnp.int32)
    jax.lax.fori_loop(0, plan.words, body, (z, pos0, z))


def _params():
    return plgpu.CompilerParams(num_warps=BLOCK // 32, num_stages=1)


@functools.partial(jax.jit, static_argnames=("plan", "interpret"))
def discover(words, tab, lim, *, plan: LanePlan, interpret: bool = False):
    """Candidate chains of every lane: ``(cnt (H, G), exit_off (H, G))``.

    ``lim`` (1,) int32: stream bits from lane 0's first bit on."""
    G, H = plan.lanes, plan.halo
    out = jax.ShapeDtypeStruct((G * H + 1,), jnp.int32)
    cnt, ex = pl.pallas_call(
        functools.partial(_discover_kernel, plan=plan),
        out_shape=(out, out),
        grid=(pl.cdiv(G * H, BLOCK),),
        backend="triton",
        compiler_params=_params(),
        interpret=interpret,
        name="lane_gpu_discover",
    )(words, tab, lim)
    return cnt[:-1].reshape(H, G), ex[:-1].reshape(H, G)


@functools.partial(jax.jit, static_argnames=("plan", "interpret"))
def decode_lanes(words, tab, entry_off, base, lim, out, *, plan: LanePlan,
                 interpret: bool = False):
    """Decode every lane from its true entry; symbol k of lane g lands at
    ``out[base[g] + k]``.  ``out`` (size + 1,) u8 is updated in place (its
    last slot is a sink) and returned; bytes no lane writes keep their
    value."""
    return pl.pallas_call(
        functools.partial(_decode_kernel, plan=plan),
        out_shape=jax.ShapeDtypeStruct(out.shape, jnp.uint8),
        grid=(pl.cdiv(plan.lanes, BLOCK),),
        backend="triton",
        compiler_params=_params(),
        input_output_aliases={5: 0},
        interpret=interpret,
        name="lane_gpu_decode",
    )(words, tab, entry_off, base, lim, out)


@functools.partial(jax.jit, static_argnames=("plan", "size", "interpret"))
def decode_program(payload, tab, lim, *, plan: LanePlan, size: int,
                   interpret: bool = False):
    """The single-card device program: word staging, discovery,
    composition, decode.  Returns the dense (size,) bytes and the composed
    symbol total."""
    words = stage_words(payload, plan)
    cnt, ex = discover(words, tab, lim, plan=plan, interpret=interpret)
    entry_off, base, _, total = _compose(cnt, ex, G=plan.lanes)
    out = decode_lanes(words, tab, entry_off, base, lim,
                       jnp.zeros(size + 1, jnp.uint8), plan=plan,
                       interpret=interpret)
    return out[:size], total


def require_gpu(interpret: bool) -> None:
    """Refuse to run the kernels anywhere but a GPU (no silent
    interpretation)."""
    backend = jax.default_backend()
    if not interpret and backend != "gpu":
        raise RuntimeError(
            f"lane_gpu needs a GPU; JAX's default backend is {backend!r}")


def decode_lane_gpu(hf, lanes: int | None = None, *,
                    interpret: bool = False) -> np.ndarray:
    """Decode a HuffFile on the GPU with the lane-scan kernels.

    ``lanes`` overrides the planned lane count; ``interpret`` runs the
    kernels in the Pallas interpreter (tests only)."""
    require_gpu(interpret)
    dfa = build_lane_dfa(hf.tree)
    plan = plan_lanes(hf.bits, dfa.height, lanes)
    out, total = decode_program(
        jnp.asarray(hf.payload), jnp.asarray(dfa.entry),
        jnp.full(1, hf.bits, jnp.int32), plan=plan,
        size=int(hf.uncompressed_size), interpret=interpret)
    total = int(total)
    if total != hf.uncompressed_size:
        raise RuntimeError(
            f"decoded {total} symbols, header says {hf.uncompressed_size}")
    return np.asarray(out)
