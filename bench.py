"""Headline benchmark: kjv.txt decode throughput on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Protocol follows the reference harness (min of 25 timed runs after a
bit-exact verification, reference framework/decodeUtil.c:30-70).  The timed
region is the device program of the GPU decode path (ops/lane_gpu.py): the
compressed payload and the table resident on the device, the dense decoded
bytes left there; every run ends in ``block_until_ready`` and is timed on
the host clock.  The corpus is the generated kjv.txt (data.py).  Any
failure is fatal: there is no fallback decoder.

``vs_baseline``: the reference publishes no absolute numbers (BASELINE.md);
we report the speedup of the device program over this machine's native
serial `simple` decoder.
"""

from __future__ import annotations

import json
import sys
import time

REPEATS = 25


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from huffmandecoderongpus_tpu import data
    from huffmandecoderongpus_tpu.harness import compare_uncompressed, evaluate
    from huffmandecoderongpus_tpu.models import get_decoder
    from huffmandecoderongpus_tpu.ops import lane_gpu as lg
    from huffmandecoderongpus_tpu.ops.lanedfa import build_lane_dfa
    from huffmandecoderongpus_tpu.utils import enable_compile_cache

    enable_compile_cache()
    lg.require_gpu(False)
    td = data.load_test_data("kjv.txt")
    hf = td.cd
    if compare_uncompressed(get_decoder("lane_gpu")(hf), td.ucd) != 0:
        raise SystemExit("lane_gpu: kjv.txt decode is not bit-exact")

    dfa = build_lane_dfa(hf.tree)
    plan = lg.plan_lanes(hf.bits, dfa.height)
    args = (jnp.asarray(hf.payload), jnp.asarray(dfa.entry),
            jnp.full(1, hf.bits, jnp.int32))

    def run():
        return jax.block_until_ready(lg.decode_program(
            *args, plan=plan, size=hf.uncompressed_size))

    out, total = run()  # compile + warm
    if int(total) != hf.uncompressed_size or compare_uncompressed(
            np.asarray(out), td.ucd) != 0:
        raise SystemExit("lane_gpu device program: not bit-exact")
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    device_s = min(times)

    serial = evaluate(get_decoder("simple"), td, repeats=REPEATS)
    print(json.dumps({
        "metric": "kjv.txt on-device decode throughput (lane_gpu)",
        "value": round(hf.uncompressed_size / device_s / 1e9, 4),
        "unit": "GB/s",
        "vs_baseline": round(serial.min_seconds / device_s, 4),
    }))
    dev = jax.devices()[0]
    print(f"# lane_gpu min={device_s * 1e3:.3f} ms   serial_simple "
          f"min={serial.min_ms:.3f} ms   platform={dev.platform} "
          f"kind={dev.device_kind} count={len(jax.devices())}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
