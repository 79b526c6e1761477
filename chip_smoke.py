"""Smoke test of the decode path on one GPU (or, with ``--chips 4``, four).

    python3 chip_smoke.py              # one card: phases 1-6
    python3 chip_smoke.py --chips 4    # the 4-card path only

Every phase is fatal: a failed check raises and the script exits non-zero
without printing its result line.  Phases on one card:

1. JAX's first device is a GPU; print its name and power limit.
2. Generate the kjv.txt-shaped corpus, write its ``.huff``, decode and
   verify it through the CLI in this process (a second JAX process could
   not get the card's memory), and check the output against the generated
   bytes and the native serial decoder.
3. Every device decoder, bit-exact: the GPU path (``lane_gpu``) and
   ``lane_dfa`` on all 8 corpora; ``spec_xla`` on kjv.txt; the sharded
   decoders on a one-card mesh; ``lane_dfa_sync`` and ``onethread_device``
   (one loop iteration per symbol) on paper1 and news.
4. A 128 MiB kjv-shaped stream (~600 Mbit, larger than the 50 MB L2)
   through the GPU path, checked against the native serial decoder.
5. The GPU kernels against ``lane_dfa`` on the phase-2 and phase-4
   streams: exact equality (decoding is integer only).
6. Median decode times, end to end (host bytes in, decoded bytes back) and
   device program only, with the card's name and power limit, and each
   path's per-stage minima.

With ``--chips 4``: ``spec_sharded`` and ``lane_sharded`` over a 4-card mesh
on the phase-2 and phase-4 streams, each compared with the generated bytes
and with the single-card GPU decode.

The last line of standard output is one JSON object: ok, and the device as
JAX reports it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from huffmandecoderongpus_tpu import data, native
from huffmandecoderongpus_tpu.harness import cli
from huffmandecoderongpus_tpu.harness.profiling import (
    profile_lane_gpu,
    profile_lanedfa,
)
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.models import get_decoder
from huffmandecoderongpus_tpu.ops import lane_gpu as lg
from huffmandecoderongpus_tpu.ops import lanedfa as ld
from huffmandecoderongpus_tpu.utils import enable_compile_cache

BIG_BYTES = 128 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def check_equal(what: str, got, want) -> None:
    got = np.asarray(got, dtype=np.uint8)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{what}: output differs from the expected bytes")
    log(f"  {what}: bit-exact ({want.size} bytes)")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def median_s(fn, reps: int) -> float:
    fn()  # warm: compiled before timing
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def lane_gpu_device(hf):
    """The GPU path's device program on device-resident inputs."""
    dfa = ld.build_lane_dfa(hf.tree)
    plan = lg.plan_lanes(hf.bits, dfa.height)
    args = (jnp.asarray(hf.payload), jnp.asarray(dfa.entry),
            jnp.full(1, hf.bits, jnp.int32))
    return lambda: jax.block_until_ready(lg.decode_program(
        *args, plan=plan, size=hf.uncompressed_size))


def lane_dfa_device(hf):
    """``lane_dfa``'s device program (discovery, composition, main scan;
    padded output left on the device) on device-resident inputs."""
    dfa = ld.build_lane_dfa(hf.tree)
    H, N = max(dfa.height, 1), hf.bits
    G = max(1, min(ld.pick_lanes(N), N // H))
    mat, B = ld.bits_matrix(hf.payload, N, G, H, round_to=512)
    bits_t, tab = jnp.asarray(mat), jnp.asarray(dfa.entry)

    @jax.jit
    def program(bits_t, tab):
        cnt, ex = ld._candidate_scan(bits_t, tab, B=B, H=H, N=N, G=G)
        entry_off, _, _, total = ld._compose(cnt, ex, G=G)
        return total, ld._lane_scan(bits_t, tab, entry_off, B=B, H=H, N=N, G=G)

    return lambda: jax.block_until_ready(program(bits_t, tab))


def big_stream():
    raw = data.generate_corpus("kjv.txt", size=BIG_BYTES)
    return raw, encode_bytes(raw)


def one_card() -> None:
    name = "kjv.txt"
    # phase 2: the CLI, in this process
    log("phase 2: generated kjv.txt through the CLI")
    raw_p, huff_p = data.raw_path(name), data.huff_path(name)
    kjv = np.fromfile(raw_p, dtype=np.uint8)
    if kjv.size != 5_504_597:
        raise AssertionError(f"kjv.txt has {kjv.size} bytes")
    out_p = data.CACHE_DIR / "chip_smoke" / "kjv.txt.decoded"
    out_p.parent.mkdir(parents=True, exist_ok=True)
    cli.main(["decode", str(huff_p), str(out_p), "--decoder", "lane_gpu"])
    hf = data.load_huff(name)
    check_equal("cli decode vs generated bytes",
                np.fromfile(out_p, dtype=np.uint8), kjv)
    check_equal("cli decode vs native simple",
                np.fromfile(out_p, dtype=np.uint8), native.simple_decode(hf))
    try:
        cli.main(["verify", str(huff_p), str(raw_p), "--decoder", "lane_gpu"])
    except SystemExit as e:
        if e.code != 0:
            raise
    log("  cli verify: OK")

    # phase 3: every device decoder
    log("phase 3: every device decoder")
    for cname in data.CORPUS_NAMES:
        td = data.load_test_data(cname)
        for dec in ("lane_gpu", "lane_dfa"):
            check_equal(f"{dec} {cname}", get_decoder(dec)(td.cd), td.ucd)
    td = data.load_test_data(name)
    check_equal(f"spec_xla {name}", get_decoder("spec_xla")(td.cd), td.ucd)
    for dec in ("spec_sharded", "lane_sharded"):
        check_equal(f"{dec} {name} (1-card mesh)",
                    get_decoder(dec)(td.cd, 1), td.ucd)
    for cname in ("paper1", "news"):
        td = data.load_test_data(cname)
        for dec in ("lane_dfa_sync", "onethread_device"):
            check_equal(f"{dec} {cname}", get_decoder(dec)(td.cd), td.ucd)

    # phase 4: a stream larger than the L2
    log(f"phase 4: {BIG_BYTES} B kjv-shaped stream")
    big_raw, big = big_stream()
    log(f"  {big.bits} bits")
    big_out = get_decoder("lane_gpu")(big)
    check_equal("lane_gpu 128 MiB vs native simple", big_out,
                native.simple_decode(big))
    check_equal("lane_gpu 128 MiB vs generated bytes", big_out, big_raw)

    # phase 5: the kernels against the plain XLA version
    log("phase 5: lane_gpu kernels vs lane_dfa")
    streams = (("kjv.txt", hf, kjv), ("128 MiB", big, big_raw))
    for sname, h, _ in streams:
        check_equal(f"lane_gpu == lane_dfa on {sname}",
                    get_decoder("lane_gpu")(h),
                    np.asarray(get_decoder("lane_dfa")(h)))

    # phase 6: times
    log(f"phase 6: median decode times on {card()}")
    for sname, h, _ in streams:
        small = h is hf
        for dec, device_fn in (("lane_gpu", lane_gpu_device),
                               ("lane_dfa", lane_dfa_device)):
            e2e = median_s(lambda: get_decoder(dec)(h),
                           10 if small or dec == "lane_gpu" else 3)
            dev = median_s(device_fn(h), 10)
            log(f"  time {dec} {sname}: end-to-end {e2e * 1e3:.3f} ms, "
                f"device {dev * 1e3:.3f} ms "
                f"({h.uncompressed_size / e2e / 1e9:.3f} GB/s end-to-end)")
        # per-stage minima: each kernel beside the XLA scan it replaces
        for dec, prof in (("lane_gpu", profile_lane_gpu),
                          ("lane_dfa", profile_lanedfa)):
            stages = ", ".join(f"{k} {v * 1e3:.3f} ms"
                               for k, v in prof(h).items())
            log(f"  stages {dec} {sname}: {stages}")


def four_cards() -> None:
    hf = data.load_huff("kjv.txt")
    kjv = data.load_ground_truth("kjv.txt")
    big_raw, big = big_stream()
    log("4-card path: spec_sharded and lane_sharded over make_mesh(4)")
    for sname, h, raw in (("kjv.txt", hf, kjv), ("128 MiB", big, big_raw)):
        single = get_decoder("lane_gpu")(h)
        check_equal(f"lane_gpu {sname} (1 card)", single, raw)
        for dec in ("spec_sharded", "lane_sharded"):
            out = get_decoder(dec)(h, 4)
            check_equal(f"{dec} {sname} vs generated bytes", out, raw)
            check_equal(f"{dec} {sname} vs 1-card lane_gpu", out, single)
            t = median_s(lambda: get_decoder(dec)(h, 4), 3)
            log(f"  time {dec} {sname} on 4 cards: end-to-end "
                f"{t * 1e3:.3f} ms")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1,
                   help="1: the one-card phases; 4: only the 4-card path")
    ns = p.parse_args()

    # phase 1: the device
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX's first device is "
                 f"{devices[0].platform!r})")
    if len(devices) < ns.chips:
        sys.exit(f"chip_smoke: need {ns.chips} GPUs, JAX sees {len(devices)}")
    enable_compile_cache()
    log(f"phase 1: {card()} | {devices[0].device_kind} x {len(devices)}")

    if ns.chips == 4:
        four_cards()
    else:
        one_card()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
