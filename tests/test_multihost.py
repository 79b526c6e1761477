"""2-process jax.distributed decode on one machine (multi-host simulation).

The reference is single-process (SURVEY §2.3); this exercises the multi-process leg
of the design — jax.distributed init, replicated table broadcast,
global-mesh shard_map, ordered cross-process gather — without real hosts.
"""

import os
import pathlib
import socket
import subprocess
import sys

import pytest

_RUNNER = pathlib.Path(__file__).with_name("multihost_runner.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_decode_paper1():
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, str(_RUNNER), coordinator, "2", str(pid), "paper1"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)
    digests = set()
    for pid, out in enumerate(outs):
        lines = [l for l in out.splitlines() if l.startswith(("OK:", "MISMATCH:"))]
        assert lines, f"no status from worker {pid}: {out}"
        status, _, digest = lines[-1].partition(f":{pid}:")
        assert status == "OK", out
        digests.add(digest)
    assert len(digests) == 1  # every process got the same bytes
