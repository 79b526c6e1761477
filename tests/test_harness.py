"""Harness layer: evaluate semantics, truncation sweeps, CLI commands."""

import numpy as np
import pytest

from huffmandecoderongpus_tpu import data as corpus
from huffmandecoderongpus_tpu.harness import (
    DecodeMismatch,
    compare_uncompressed,
    evaluate,
    graph_rows,
    set_target_sizes,
    truncate_test_data,
)
from huffmandecoderongpus_tpu.harness.cli import main, run_suite
from huffmandecoderongpus_tpu.models import get_decoder
from huffmandecoderongpus_tpu.native import simple_decode


def test_evaluate_min_of_n(hello):
    r = evaluate(get_decoder("simple"), hello, repeats=5)
    assert len(r.times) == 6  # verify run + 5 timed runs
    assert r.min_seconds == min(r.times) > 0
    assert r.decoder == "simple"
    assert r.uncompressed_bytes == hello.cd.uncompressed_size
    assert r.gb_per_s > 0


def test_evaluate_catches_bad_decoder(hello):
    class Bad:
        name = "bad"
        checks_output = True

        def __call__(self, hf, param=None):
            out = simple_decode(hf).copy()
            out[0] ^= 0xFF
            return out

    with pytest.raises(DecodeMismatch):
        evaluate(Bad(), hello, repeats=0)


def test_evaluate_skips_check_for_nonoutput_decoders(hello):
    # justreaddata returns no bytes; evaluate must not compare (mainrun.c:447).
    r = evaluate(get_decoder("justreaddata"), hello, repeats=2)
    assert r.min_seconds > 0


def test_compare_reports_diff_count(capsys):
    a = np.array([1, 2, 3, 4], dtype=np.uint8)
    b = np.array([1, 9, 3, 9], dtype=np.uint8)
    assert compare_uncompressed(a, b) == 2
    assert compare_uncompressed(a, a) == 0
    assert compare_uncompressed(a, a[:3]) == 1  # size mismatch counts


def test_set_target_sizes_cuts_at_symbol_boundary(paper1):
    for target in (100, 1000, 33333, paper1.cd.bits + 999):
        t = set_target_sizes(paper1.cd, target)
        assert t.bits <= min(target, paper1.cd.bits)
        # truncated stream decodes exactly to the ground-truth prefix
        got = simple_decode(t)
        assert got.size == t.uncompressed_size
        np.testing.assert_array_equal(got, paper1.ucd[: t.uncompressed_size])


def test_set_target_sizes_full_stream_is_identity(hello):
    t = set_target_sizes(hello.cd, hello.cd.bits)
    assert t.bits == hello.cd.bits
    assert t.uncompressed_size == hello.cd.uncompressed_size


def test_graph_rows_sweep(hello):
    rows = list(graph_rows(get_decoder("simple"), hello, incs=8, repeats=1))
    assert len(rows) == 3  # targets 8, 16, 24 of a 32-bit stream
    sizes = [s for s, _ in rows]
    assert sizes == [8, 16, 24]
    for _, r in rows:
        assert r.min_seconds > 0


def test_truncate_test_data_ground_truth(paper1):
    rtd = truncate_test_data(paper1, 5000)
    assert rtd.cd.uncompressed_size == rtd.ucd.size
    evaluate(get_decoder("bigtable_simple"), rtd, repeats=1)  # raises on mismatch


def test_run_suite_default(capsys):
    run_suite("default")
    out = capsys.readouterr().out
    assert "tablenodes : 15" in out
    assert "tablegroups  4 : 1" in out


def test_run_suite_unknown():
    with pytest.raises(SystemExit):
        run_suite("nosuchsuite")


def test_cli_encode_decode_roundtrip(tmp_path, capsys):
    src = tmp_path / "input.bin"
    raw = np.frombuffer(b"the quick brown fox jumps over the lazy dog" * 50, dtype=np.uint8)
    raw.tofile(src)
    huff = tmp_path / "x.huff"
    out = tmp_path / "out.bin"
    main(["encode", str(src), str(huff)])
    main(["decode", str(huff), str(out), "--decoder", "bigtable_simple"])
    np.testing.assert_array_equal(np.fromfile(out, dtype=np.uint8), raw)
    assert huff.stat().st_size < raw.size  # actually compresses


def test_cli_info_and_decoders(capsys):
    main(["info", "hello"])
    out = capsys.readouterr().out
    assert "nodes 15" in out and "bits 32" in out
    main(["decoders"])
    out = capsys.readouterr().out
    assert "spec_xla" in out and "simple" in out


def test_cli_hello_suite(capsys):
    main(["hello", "--repeats", "1"])
    out = capsys.readouterr().out
    assert "simple" in out and "spec_xla" in out and "pes_numpy" in out


def test_scaling_sweep(paper1):
    from huffmandecoderongpus_tpu.harness.scaling import format_sweep, scaling_sweep

    # the lane path runs the GPU kernels; the block path runs anywhere
    pts = scaling_sweep(paper1.cd, paper1.ucd, sizes=[1, 2], repeats=1,
                        path="block")
    assert [p.devices for p in pts] == [1, 2]
    assert pts[0].efficiency == 1.0
    assert "efficiency" in format_sweep(pts)


def test_package_root_exports(hello):
    import huffmandecoderongpus_tpu as ht

    hf = ht.encode_bytes(hello.ucd)
    out = ht.get_decoder("simple")(hf)
    np.testing.assert_array_equal(out, hello.ucd)


def test_cli_verify_command(tmp_path):
    import huffmandecoderongpus_tpu as ht

    raw = np.frombuffer(b"verify me please " * 100, dtype=np.uint8)
    rawf = tmp_path / "raw.bin"
    raw.tofile(rawf)
    hf = ht.encode_bytes(raw)
    huff = tmp_path / "v.huff"
    ht.write_huff(huff, hf)
    with pytest.raises(SystemExit) as ei:
        main(["verify", str(huff), str(rawf)])
    assert ei.value.code == 0
    # corrupt payload -> nonzero exit
    bad = bytearray(huff.read_bytes())
    bad[-3] ^= 0xFF
    huff.write_bytes(bytes(bad))
    with pytest.raises(SystemExit) as ei:
        main(["verify", str(huff), str(rawf)])
    assert ei.value.code == 1


def test_cli_bits_command(capsys):
    main(["bits", "hello", "32"])
    out = capsys.readouterr().out.strip()
    # the generated hello stream (af da 61 8e, test_format.py) LSB-first
    want = "".join(f"{b:08b}"[::-1] for b in (0xAF, 0xDA, 0x61, 0x8E))
    assert out == want
