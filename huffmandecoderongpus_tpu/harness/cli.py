"""Command-line driver: the reference's test suites plus encode/decode.

Suite-name parity with mainrun.c's dispatch (mainrun.c:512-636):
``default hello peskjv peshello bigtable quickgraph1-3 graph1-4 kjvprof opt
bts`` (+ ``testall``, defined at mainrun.c:443-461 but unreachable there).
Decoder-slot mapping: the reference's per-backend slots (opencl/fastgpu/
fastgpuOpt1 = "the device builds") become our device decoders: ``spec_xla``
(the speculative pipeline) and ``lane_gpu`` (the GPU decode path).  ``pes``
(host execution of the same algorithm) maps to ``pes_numpy``.

The corpora are generated from ``--seed`` (data.py).

New commands (the reference is decoder-only): ``encode``, ``decode``,
``info``, ``corpora``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from huffmandecoderongpus_tpu import data as corpus
from huffmandecoderongpus_tpu.harness.evaluate import REPEATS, evalandshow
from huffmandecoderongpus_tpu.harness.timing import report_resolution
from huffmandecoderongpus_tpu.harness.truncate import graphtest
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.huffio.format import read_huff, write_huff
from huffmandecoderongpus_tpu.huffio.tree import HuffTree
from huffmandecoderongpus_tpu.models import all_decoders, get_decoder

SUITES = [
    "default", "hello", "peskjv", "peshello", "bigtable",
    "quickgraph1", "quickgraph2", "quickgraph3",
    "graph1", "graph2", "graph3", "graph4",
    "kjvprof", "opt", "bts", "testall",
    "kjv",  # ACC-driver corpus suite (mainrunacc.c:406-409)
]
COMMANDS = ["encode", "decode", "verify", "info", "corpora", "decoders",
            "prof", "scaling", "bits"]


def _device_decoders() -> list:
    """The device decoders filling the reference's opencl/fastgpu/
    fastgpuOpt1 suite slots: the speculative pipeline plus the GPU decode
    path (``lane_gpu``); where JAX has no GPU, its XLA reference
    ``lane_dfa`` takes that slot under its own name.  ``lane_dfa_sync`` (a
    slow XLA discovery diagnostic) stays out of the recurring suites; it
    remains in the registry (``decode --decoder lane_dfa_sync``) and the
    per-commit tests."""
    import jax

    lane = "lane_gpu" if jax.default_backend() == "gpu" else "lane_dfa"
    return [get_decoder(n) for n in ("spec_xla", lane)]


def _show_info(td) -> None:
    print(td.info())


def run_suite(name: str, repeats: int = REPEATS,
              seed: int = corpus.DEFAULT_SEED) -> None:
    def load(cname):
        return corpus.load_test_data(cname, seed)

    if name == "default":
        # Tree diagnostics for the hello fixture (mainrun.c:512-525).
        hello = load("hello")
        t = HuffTree(hello.cd.tree)
        print(t.format_codes())
        print(t.format_table())
        print(f" tablenodes : {t.size}")
        for b in (1, 2, 3, 4):
            print(f"tablegroups  {b} : {t.num_groups(b)} ")
        print(t.num_groups(4))
        return

    if name == "hello":
        hello = load("hello")
        evalandshow(get_decoder("simple"), hello, repeats=repeats)
        for d in _device_decoders():
            evalandshow(d, hello, repeats=repeats)
        evalandshow(get_decoder("pes_numpy"), hello, repeats=repeats)
        return

    if name == "kjv":
        # ACC driver's corpus suite: the backend-portable pipeline on kjv
        # (mainrunacc.c:406-409, pacc slot)
        td = load("kjv.txt")
        for d in _device_decoders():
            evalandshow(d, td, repeats=repeats)
        return

    if name in ("peskjv", "peshello"):
        td = load("kjv.txt" if name == "peskjv" else "hello")
        evalandshow(get_decoder("pes_numpy"), td, repeats=repeats)
        return

    if name == "bigtable":
        # The headline benchmark (mainrun.c:541-588): every backend of the
        # speculative pipeline + the serial baselines, on the 5 main corpora.
        tds = [load(n) for n in ("paper1", "hello", "news", "kjv.txt", "book2")]
        for td in tds:
            _show_info(td)
        rows = _device_decoders() + [
            get_decoder("pes_numpy"),
            get_decoder("simple"),
            get_decoder("bigtable_multisym"),
            get_decoder("bigtable_simple"),
        ]
        for d in rows:
            for td in tds:
                evalandshow(d, td, repeats=repeats)
        return

    if name.startswith("quickgraph") or name.startswith("graph"):
        quick = name.startswith("quickgraph")
        td = load("paper1" if quick else "kjv.txt")
        incs = 10000 if quick else 500000
        which = name[len("quickgraph" if quick else "graph"):]
        if which == "1":
            graphtest(get_decoder("simple"), td, incs, repeats=repeats)
        elif which == "2":
            for d in _device_decoders():
                graphtest(d, td, incs, repeats=repeats)
        elif which == "3":
            graphtest(get_decoder("bigtable_multisym"), td, incs, repeats=repeats)
        elif which == "4" and not quick:
            graphtest(get_decoder("pes_numpy"), td, incs, repeats=repeats)
        else:
            raise SystemExit(f"unknown graph suite: {name}")
        return

    if name == "kjvprof":
        td = load("kjv.txt")
        for d in _device_decoders():
            evalandshow(d, td, repeats=repeats)
        return

    if name == "opt":
        # Baseline vs optimized device build (mainrun.c:617-623: fastgpu
        # vs fastgpuOpt1).  Our pair: the faithful speculative pipeline
        # (baseline) vs the lane decoder (optimized).
        td = load("kjv.txt")
        base, best = (evalandshow(d, td, repeats=repeats)
                      for d in _device_decoders())
        print(f"opt: {best.decoder} is {base.min_seconds / best.min_seconds:.1f}x "
              f"the baseline spec_xla ({base.min_ms:.1f} ms -> "
              f"{best.min_ms:.1f} ms)")
        return

    if name == "bts":
        for n in ("paper1", "hello", "news", "kjv.txt", "book2"):
            evalandshow(get_decoder("bigtable_simple"), load(n), repeats=repeats)
        return

    if name == "testall":
        # mainrun.c:443-461: floors + serial baselines + jumpbits sweeps.
        for cname in ("paper1", "hello", "news", "kjv.txt", "book2"):
            td = load(cname)
            evalandshow(get_decoder("justreaddata"), td, withcheck=False, repeats=repeats)
            evalandshow(get_decoder("simple"), td, repeats=repeats)
            evalandshow(get_decoder("bigtable_v1"), td, repeats=repeats)
            evalandshow(get_decoder("bigtable_multisym"), td, repeats=repeats)
            for k in range(1, 15):
                evalandshow(get_decoder("jumptable"), td, param=k, repeats=repeats)
            for k in range(1, 15):
                evalandshow(get_decoder("lin"), td, param=k, repeats=repeats)
        return

    raise SystemExit(f"unknown test: {name} (suites: {' '.join(SUITES)})")


def main(argv=None) -> None:
    from huffmandecoderongpus_tpu.utils import enable_compile_cache

    p = argparse.ArgumentParser(
        prog="huffmandecoderongpus_tpu",
        description="Parallel Huffman codec for the GPU: benchmark suites and codec commands",
    )
    p.add_argument("test", nargs="?", default="default",
                   help=f"suite ({' '.join(SUITES)}) or command ({' '.join(COMMANDS)})")
    p.add_argument("args", nargs="*", help="command arguments")
    p.add_argument("--repeats", type=int, default=REPEATS,
                   help="timed runs per decoder (reference REPEATS=25)")
    p.add_argument("--decoder", default="simple", help="decoder name for `decode`")
    p.add_argument("--index", type=int, metavar="K", default=None,
                   help="encode: also write a .huffidx sidecar every K symbols")
    p.add_argument("--device", action="store_true",
                   help="encode: pack the bitstream on the device "
                        "(ops/encode_ops.py)")
    p.add_argument("--seed", type=int, default=corpus.DEFAULT_SEED,
                   help="seed of the generated corpora")
    ns = p.parse_args(argv)
    enable_compile_cache()

    if ns.test == "encode":
        if len(ns.args) < 1:
            raise SystemExit("usage: encode <input> [output.huff] [--index K]")
        src = ns.args[0]
        dst = ns.args[1] if len(ns.args) > 1 else src + ".huff"
        raw = np.fromfile(src, dtype=np.uint8)
        if ns.device:
            # device encoder (byte-identical payloads)
            import dataclasses

            from huffmandecoderongpus_tpu.ops.encode_ops import encode_device

            hf = encode_device(raw)
            if ns.index:
                hf2 = encode_bytes(raw, tree=hf.tree, block_symbols=ns.index)
                hf = dataclasses.replace(hf, index=hf2.index)
        else:
            hf = encode_bytes(raw, block_symbols=ns.index)
        write_huff(dst, hf)
        if hf.index is not None:
            from huffmandecoderongpus_tpu.huffio.sidecar import index_path, write_index

            write_index(index_path(dst), hf.index[0], hf.index[1],
                        bits=hf.bits,
                        uncompressed_size=hf.uncompressed_size,
                        payload=hf.payload)
        ratio = hf.file_bytes() / max(raw.size, 1)
        print(f"{src}: {raw.size} -> {hf.file_bytes()} bytes "
              f"({ratio:.3f}), {hf.nodes} nodes, {hf.bits} bits"
              + (f", index every {hf.index[1]} symbols" if hf.index else ""))
        return

    if ns.test == "decode":
        if len(ns.args) < 1:
            raise SystemExit("usage: decode <input.huff> [output]")
        src = ns.args[0]
        hf = read_huff(src)
        out = get_decoder(ns.decoder)(hf)
        dst = ns.args[1] if len(ns.args) > 1 else None
        if dst:
            np.asarray(out, dtype=np.uint8).tofile(dst)
            print(f"{src}: {hf.payload_bytes} -> {out.size} bytes -> {dst}")
        else:
            sys.stdout.buffer.write(bytes(np.asarray(out, dtype=np.uint8)))
        return

    if ns.test == "verify":
        # byte-compare a .huff decode against a raw file (the evaluate()
        # check as a standalone command)
        from huffmandecoderongpus_tpu.harness import compare_uncompressed

        if len(ns.args) < 2:
            raise SystemExit("usage: verify <input.huff> <raw-file>")
        hf = read_huff(ns.args[0])
        want = np.fromfile(ns.args[1], dtype=np.uint8)
        got = get_decoder(ns.decoder)(hf)
        diffs = compare_uncompressed(got, want)
        print("OK" if diffs == 0 else f"FAILED: {diffs} differences")
        raise SystemExit(0 if diffs == 0 else 1)

    if ns.test == "info":
        for name in (ns.args or corpus.CORPUS_NAMES):
            hf = (read_huff(name) if name.endswith(".huff")
                  else corpus.load_huff(name, ns.seed))
            t = HuffTree(hf.tree)
            print(f"{name}: nodes {hf.nodes}, bits {hf.bits}, "
                  f"uncompressedsize {hf.uncompressed_size}, height {t.height}, "
                  f"mindepth {t.min_depth}")
        return

    if ns.test == "bits":
        # dump leading stream bits LSB-first (showDataBits, huffdata.c:280-288)
        from huffmandecoderongpus_tpu.huffio.bitio import unpack_bits

        name = ns.args[0] if ns.args else "hello"
        count = int(ns.args[1]) if len(ns.args) > 1 else 64
        hf = (read_huff(name) if name.endswith(".huff")
              else corpus.load_huff(name, ns.seed))
        arr = unpack_bits(hf.payload, min(hf.bits, count))
        print("".join(str(int(b)) for b in arr))
        return

    if ns.test == "corpora":
        # generate (once per seed) and list the corpora with their files
        for name in corpus.CORPUS_NAMES:
            print(f"{name}  {corpus.raw_path(name, ns.seed)}  "
                  f"{corpus.huff_path(name, ns.seed)}")
        return

    if ns.test == "decoders":
        for name, d in sorted(all_decoders().items()):
            print(f"{name:>20}  backend={d.backend}")
        return

    if ns.test == "scaling":
        # mesh-size sweep on the block-parallel decoder (BASELINE north star)
        from huffmandecoderongpus_tpu.harness.scaling import format_sweep, scaling_sweep

        name = ns.args[0] if ns.args else "paper1"
        path = ns.args[1] if len(ns.args) > 1 else "lane"
        td = corpus.load_test_data(name, ns.seed)
        print(f"scaling sweep on {name} ({path} path):")
        print(format_sweep(scaling_sweep(td.cd, td.ucd, repeats=ns.repeats,
                                         path=path)))
        return

    if ns.test == "prof":
        # per-stage device timing breakdown (openclapproach.c event-profiling
        # role); usage: prof [corpus] [gpu|lanedfa|speculative]
        from huffmandecoderongpus_tpu.harness.profiling import (
            format_report, profile_lane_gpu, profile_lanedfa,
            profile_speculative)

        name = ns.args[0] if ns.args else "paper1"
        which = ns.args[1] if len(ns.args) > 1 else "gpu"
        td = corpus.load_test_data(name, ns.seed)
        if which.startswith("spec"):
            fn = profile_speculative
        elif which == "gpu":
            fn = profile_lane_gpu
        else:
            fn = profile_lanedfa
        print(f"{which} stage breakdown on {name}:")
        print(format_report(fn(td.cd)))
        return

    print(f"running test: {ns.test}", file=sys.stderr)
    print(report_resolution(), file=sys.stderr)
    run_suite(ns.test, repeats=ns.repeats, seed=ns.seed)


if __name__ == "__main__":
    main()
