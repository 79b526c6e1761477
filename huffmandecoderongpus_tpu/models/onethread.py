"""Single-scalar-core device decode — the sanity baseline.

The reference runs its whole serial decoder in one CUDA thread
(``<<<1,1>>>``, onethread.cu:13-52) to measure single-core GPU speed.  Here:
a `lax.while_loop` running the serial LUT walk, one iteration per symbol.
Deliberately slow; suites use it only on small inputs."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from huffmandecoderongpus_tpu.models import register
from huffmandecoderongpus_tpu.ops.lut import build_decode_lut
from huffmandecoderongpus_tpu.ops.speculative import extract_windows
from huffmandecoderongpus_tpu.huffio.bitio import payload_to_words_u32


@functools.partial(jax.jit, static_argnames=("bits", "size", "height"))
def _onethread_decode(words, lut_sym, lut_len, *, bits, size, height):
    def cond(carry):
        pos, n, _ = carry
        return pos < bits

    def body(carry):
        pos, n, out = carry
        win = extract_windows(words, jnp.array([pos], dtype=jnp.int32), height)[0]
        sym = lut_sym[win.astype(jnp.int32)]
        ln = lut_len[win.astype(jnp.int32)]
        return pos + ln, n + 1, out.at[n].set(sym)

    out = jnp.zeros(size, dtype=jnp.uint8)
    pos, n, out = jax.lax.while_loop(cond, body, (jnp.int32(0), jnp.int32(0), out))
    return out, n


@register("onethread_device", backend="device")
def onethread_device(hf, param=None) -> np.ndarray:
    lut = build_decode_lut(hf.tree)
    words = jnp.asarray(payload_to_words_u32(hf.payload, hf.bits, extra_words=1))
    out, n = _onethread_decode(
        words,
        jnp.asarray(lut.sym),
        jnp.asarray(lut.length),
        bits=hf.bits,
        size=hf.uncompressed_size,
        height=lut.height,
    )
    if int(n) != hf.uncompressed_size:
        raise RuntimeError(f"decoded {int(n)} symbols, header says {hf.uncompressed_size}")
    return np.asarray(out)
