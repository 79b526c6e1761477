"""The speculative "decode from every bit offset" parallel pipeline.

This is the heart of the framework — the algorithm the reference implements
four times (pes.c:106-209, fastgpu.cu:140-332, fastgpuOpt1.cu:174-373,
openclapproach.c:236-1047).  Six stages:

  1. decodeAllBits   — for every bit offset b, the first symbol decoded from
                       b and its code length (pes.c:30-46).  Here: one LUT
                       gather over precomputed bit windows instead of a
                       data-dependent tree walk.
  2. makebigtable    — pointer doubling over code-length steps (pes.c:48-71).
  3. (loop control)  — the reference reads a 4-byte convergence flag back to
                       the host per doubling step (fastgpu.cu:245-261, the
                       scalability bottleneck).  Here the level
                       count is a *static* function of the header's
                       uncompressed size — ceil(log2(nsym)) levels — so the
                       whole pipeline compiles to one XLA program with no
                       host round-trips.
  4. calcbitsindex   — top-down binary-decomposition labeling of every true
                       symbol boundary with its output index (pes.c:73-85).
  5. calcresult      — scatter symbols to their output positions (pes.c:87-96).
  6. findmax         — decoded size = max labeled index + 1 (pes.c:98-104).

Output-equivalence note: the reference keeps "truncated walk" entries (a walk
that hits end-of-stream mid-codeword records an internal node's sym) and
culls them during doubling with `bit + s > bits` guards.  We cull at level 0
(`b + len > bits` => -1) instead; entries differ only at offsets that are
never on a true symbol-boundary chain, so decoded bytes are identical.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from huffmandecoderongpus_tpu.huffio.bitio import payload_to_words_u32, unpack_bits
from huffmandecoderongpus_tpu.ops.lut import DecodeLUT, build_decode_lut


@dataclasses.dataclass(frozen=True)
class SpecPlan:
    """Static shape/trip-count parameters for one compiled decode program."""

    bits: int  # exact payload bit count
    size: int  # uncompressed byte count (from the header)
    height: int  # LUT height
    levels: int  # doubling levels = bits needed to binary-decompose size-1

    @property
    def n_words(self) -> int:
        return (self.bits + 31) // 32 + 1


def make_plan(bits: int, size: int, height: int) -> SpecPlan:
    levels = (size - 1).bit_length() if size > 1 else 0
    return SpecPlan(bits=bits, size=size, height=height, levels=levels)


def extract_windows(words: jnp.ndarray, b: jnp.ndarray, height: int) -> jnp.ndarray:
    """height-bit LSB-first windows starting at bit offsets ``b``.

    ``words`` is the payload as little-endian uint32 with >= 1 zero pad word,
    so ``words[b//32 + 1]`` is always in bounds.
    """
    q = (b >> 5).astype(jnp.int32)
    r = (b & 31).astype(jnp.uint32)
    lo = jnp.take(words, q, mode="clip") >> r
    hi_word = jnp.take(words, q + 1, mode="clip")
    # uint32 << 32 is undefined; mask the r == 0 lane instead.
    hi = jnp.where(r == 0, jnp.uint32(0), hi_word << (jnp.uint32(32) - r))
    return (lo | hi) & jnp.uint32((1 << height) - 1)


@functools.partial(jax.jit, static_argnames=("bits", "size", "height", "levels"))
def speculative_decode_xla(
    words: jnp.ndarray,
    lut_sym: jnp.ndarray,
    lut_len: jnp.ndarray,
    *,
    bits: int,
    size: int,
    height: int,
    levels: int,
):
    """Single-device XLA pipeline. Returns (decoded uint8[size], found_size).

    Stages 4-6 are *redesigned* as gathers: instead of the
    reference's scatter-based index labeling (calcbitsindex propagates output
    indices onto chain bits, pes.c:73-85, then calcresult scatters symbols,
    pes.c:87-96), each **output byte queries its own bit position**: output
    index i starts at bit 0 and, for every set bit k of i, jumps forward by
    the level-k doubling span — the same binary decomposition walked in the
    opposite direction, as pure gathers over ``size`` elements rather than
    scatters over ``bits`` elements (4-8x fewer elements, and gathers need
    no write ordering).

    ``found_size`` reproduces the reference's findmax role (pes.c:98-104) as
    a stream-consistency check: it equals ``size`` iff the chain of ``size``
    codewords ends exactly at ``bits``.
    """
    b = jnp.arange(bits, dtype=jnp.int32)

    # Stage 1: decodeAllBits as window extraction + one LUT gather.
    win = extract_windows(words, b, height)
    ln = jnp.take(lut_len, win.astype(jnp.int32), mode="clip")
    sym = jnp.take(lut_sym, win.astype(jnp.int32), mode="clip")
    step0 = jnp.where(b + ln <= bits, ln, -1)

    # Stage 2: pointer doubling, `levels` static iterations — no host sync.
    #
    # Memory discipline (role of fastgpuOpt1.cu:244-255, which shrinks the
    # per-level buffers; our stage 4-5 is gather-only, so the bigger lever
    # is dropping whole levels): only every 2nd level is *kept* — odd
    # levels are recomputed at query time by composing two jumps of the
    # level below (same validity rules as the doubling itself) — and kept
    # levels whose spans provably fit are stored as int16.  kjv: 24 levels
    # x 98 MB = 2.3 GB naive -> ~0.9 GB kept.
    def double(s):
        t = b + s
        tc = jnp.clip(t, 0, bits - 1)
        w = jnp.take(s, tc, mode="clip")
        ok = (s != -1) & (t < bits) & (w != -1) & (t + w <= bits)
        return jnp.where(ok, s + w, -1)

    def keep(s, k):
        # level-k spans cover 2^k codewords of <= height bits each
        if (1 << k) * height <= np.iinfo(np.int16).max:
            return s.astype(jnp.int16)
        return s

    kept = {0: keep(step0, 0)}
    s = step0
    for k in range(1, max(levels, 1)):
        s = double(s)
        if k % 2 == 0:
            kept[k] = keep(s, k)

    def delta_at(k, pos):
        """Level-k span at ``pos`` — stored, or composed from level k-1."""
        if k in kept:
            return jnp.take(kept[k], pos, mode="clip").astype(jnp.int32)
        base = kept[k - 1]
        d1 = jnp.take(base, pos, mode="clip").astype(jnp.int32)
        t = pos + d1
        d2 = jnp.take(base, jnp.clip(t, 0, bits - 1),
                      mode="clip").astype(jnp.int32)
        ok = (d1 != -1) & (t < bits) & (d2 != -1) & (t + d2 <= bits)
        return jnp.where(ok, d1 + d2, -1)

    # Stages 4+5 fused, gather-only: output index i -> its codeword's bit
    # position via top-down binary decomposition over the doubling levels.
    i = jnp.arange(size, dtype=jnp.int32)
    pos = jnp.zeros(size, dtype=jnp.int32)
    bad = jnp.zeros((), dtype=jnp.bool_)
    for k in range(levels - 1, -1, -1):
        delta = delta_at(k, pos)
        take = ((i >> k) & 1) == 1
        # a -1 span consumed by any chain means a corrupt stream; the
        # clamp below would silently freeze that position, so fold the
        # condition into found_size (advisor finding: last_end == bits
        # alone can coincidentally pass on corrupt data)
        bad = bad | jnp.any(take & (delta == -1))
        pos = jnp.where(take, pos + jnp.maximum(delta, 0), pos)
    result = jnp.take(sym, pos, mode="clip")

    # Stage 6 (findmax role): the chain must end exactly at `bits` AND
    # never have consumed an invalid doubling span.
    last_end = pos[-1] + jnp.take(ln, pos[-1], mode="clip") if size > 0 else jnp.int32(0)
    found_size = jnp.where((last_end == bits) & ~bad, size, -1)
    return result, found_size


def decode_device_arrays(hf, lut: DecodeLUT | None = None):
    """Prepare (plan, device inputs) for a HuffFile."""
    if lut is None:
        lut = build_decode_lut(hf.tree)
    plan = make_plan(hf.bits, hf.uncompressed_size, lut.height)
    words = payload_to_words_u32(hf.payload, hf.bits, extra_words=1)
    return plan, (
        jnp.asarray(words),
        jnp.asarray(lut.sym),
        jnp.asarray(lut.length),
    )


def decode_xla(hf, lut: DecodeLUT | None = None, check_size: bool = True) -> np.ndarray:
    """Convenience host wrapper: HuffFile -> decoded bytes via the XLA path."""
    plan, (words, lut_sym, lut_len) = decode_device_arrays(hf, lut)
    result, found = speculative_decode_xla(
        words,
        lut_sym,
        lut_len,
        bits=plan.bits,
        size=plan.size,
        height=plan.height,
        levels=plan.levels,
    )
    if check_size and int(found) != plan.size:
        raise RuntimeError(f"decoded {int(found)} symbols, header says {plan.size}")
    return np.asarray(result)


# ---------------------------------------------------------------------------
# numpy reference semantics (the role pes.c plays in the reference: the
# parallel algorithm executed on the host, used as a cross-check oracle).


def speculative_decode_numpy(hf) -> np.ndarray:
    """Vectorized numpy execution of the same pipeline (oracle/debugging)."""
    lut = build_decode_lut(hf.tree)
    bits, size = hf.bits, hf.uncompressed_size
    bitarr = unpack_bits(hf.payload, bits)
    words = payload_to_words_u32(hf.payload, bits, extra_words=1)

    b = np.arange(bits, dtype=np.int64)
    q, r = b >> 5, (b & 31).astype(np.uint32)
    lo = words[q] >> r
    hi = np.where(r == 0, 0, (words[q + 1] << (np.uint32(32) - r)) & 0xFFFFFFFF).astype(
        np.uint32
    )
    win = (lo | hi) & np.uint32(lut.mask)
    ln = lut.length[win].astype(np.int64)
    sym = lut.sym[win]
    step0 = np.where(b + ln <= bits, ln, -1)

    levels = (size - 1).bit_length() if size > 1 else 0
    steps = [step0]
    for _ in range(max(levels - 1, 0)):
        s = steps[-1]
        t = b + s
        tc = np.clip(t, 0, bits - 1)
        w = s[tc]
        ok = (s != -1) & (t < bits) & (w != -1) & (t + w <= bits)
        steps.append(np.where(ok, s + w, -1))

    idx = np.full(bits, -1, dtype=np.int64)
    idx[0] = 0
    for k in range(levels - 1, -1, -1):
        s = steps[k]
        ok = (idx != -1) & (s != -1) & (b + s < bits)
        idx[(b + s)[ok]] = idx[ok] + (1 << k)

    result = np.zeros(size, dtype=np.uint8)
    ok = idx != -1
    result[idx[ok]] = sym[ok]
    found = int(idx.max()) + 1
    if found != size:
        raise RuntimeError(f"decoded {found} symbols, header says {size}")
    return result
