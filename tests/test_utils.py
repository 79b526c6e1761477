"""utils/ (compile cache, debug dumps) and profiling subsystem."""

import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from huffmandecoderongpus_tpu.harness.cli import main
from huffmandecoderongpus_tpu.harness.profiling import (
    format_report,
    profile_lane_gpu,
    profile_lanedfa,
    profile_speculative,
)
from huffmandecoderongpus_tpu.data import CACHE_DIR, CORPUS_NAMES
from huffmandecoderongpus_tpu.utils.compile_cache import cache_dir
from huffmandecoderongpus_tpu.utils.debug import dump, set_debug


_CACHE_PROBE = """
import jax
import numpy as np
from huffmandecoderongpus_tpu.utils import enable_compile_cache
path = enable_compile_cache()
jax.jit(lambda x: x * {k})(np.arange(4.0)).block_until_ready()
print(path)
"""


def _compile_in_subprocess(env_dir) -> tuple[pathlib.Path, set]:
    """Compile one fresh program in a child process (the cache directory is
    process-global state); returns the reported directory and its files."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    code = _CACHE_PROBE.format(k=int(np.random.default_rng().integers(1 << 30)))
    res = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=300,
                         cwd=pathlib.Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    path = pathlib.Path(res.stdout.strip().splitlines()[-1])
    return path, set(path.iterdir())


def test_compile_cache_enable():
    # without JAX_COMPILATION_CACHE_DIR: <checkout>/.cache/jax
    before = set(cache_dir().iterdir()) if cache_dir().exists() else set()
    path, after = _compile_in_subprocess(None)
    assert path == CACHE_DIR / "jax"
    assert after - before  # the compile landed a new entry there


def test_compile_cache_env_dir(tmp_path):
    # with JAX_COMPILATION_CACHE_DIR set, that directory and no other
    path, files = _compile_in_subprocess(tmp_path / "xla")
    assert path == tmp_path / "xla"
    assert files


def test_debug_dump_gated(capsys):
    buf = io.StringIO()
    set_debug(False)
    dump("x", np.arange(10), out=buf)
    assert buf.getvalue() == ""
    set_debug(True)
    try:
        dump("bitsteps", np.arange(100), limit=5, out=buf)
        s = buf.getvalue()
        assert "bitsteps" in s and "(100 total)" in s
    finally:
        set_debug(None)


def test_profile_speculative_stages(hello):
    r = profile_speculative(hello.cd, reps=1)
    assert set(r) == {"decodeAllBits", "makebigtable", "index_query", "total"}
    assert all(v >= 0 for v in r.values())
    assert "ms" in format_report(r)


def test_profile_lanedfa_stages(paper1):
    r = profile_lanedfa(paper1.cd, lanes=32, reps=1)
    for k in ("candidate_scan", "compose", "main_scan", "host_compaction", "total"):
        assert k in r


def test_cli_prof_command(capsys):
    main(["prof", "hello", "lanedfa"])
    out = capsys.readouterr().out
    assert "stage breakdown" in out and "main_scan" in out


def test_profile_lane_gpu_needs_gpu(hello):
    with pytest.raises(RuntimeError, match="needs a GPU"):
        profile_lane_gpu(hello.cd)


def test_cli_corpora_command(capsys):
    main(["corpora"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == list(CORPUS_NAMES)
    for line in out:
        _, raw, huff = line.split()
        assert pathlib.Path(raw).is_file() and huff.endswith(".huff")
