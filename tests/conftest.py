"""Test env: force CPU with 8 virtual devices so sharding tests run anywhere.

Must run before the first `import jax` anywhere in the test process.
"""

import os

# The tests check program semantics on the CPU: 8 virtual devices stand in
# for a mesh of cards, and the GPU kernels run in the Pallas interpreter.
# The card itself is exercised by chip_smoke.py.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from huffmandecoderongpus_tpu import data as corpus_data  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-minute big-corpus tests (run with RUN_SLOW=1)"
    )


def pytest_collection_modifyitems(config, items):
    if os.environ.get("RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow; set RUN_SLOW=1 to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def hello():
    return corpus_data.load_test_data("hello")


@pytest.fixture(scope="session")
def paper1():
    return corpus_data.load_test_data("paper1")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
