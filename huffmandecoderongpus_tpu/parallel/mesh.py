"""Device mesh construction and multi-host initialization.

The reference is single-process single-device (SURVEY §2.3): its only
parallel axis is "every compressed bit is a GPU thread".  This framework
adds the inter-device axis the reference lacks: data parallelism over
independent bitstream blocks on a flat 1-D ``jax.sharding.Mesh``.  The
cards of one host are joined all to all (NVLink), so the mesh follows the
algorithm alone; hosts join through ``jax.distributed.initialize``.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

#: Name of the block-data-parallel mesh axis used throughout the framework.
BLOCK_AXIS = "blocks"


def make_mesh(n_devices: int | None = None, axis: str = BLOCK_AXIS,
              devices=None) -> Mesh:
    """1-D mesh over ``n_devices`` (default: all addressable devices)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"asked for {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize multi-host JAX (one process per host or per card).

    Thin wrapper over ``jax.distributed.initialize`` that honours the
    standard env vars when arguments are omitted; a no-op when running
    single-process (num_processes == 1 or nothing configured).
    """
    num = num_processes if num_processes is not None else int(
        os.environ.get("HUFF_NUM_PROCESSES", "1"))
    if num <= 1 and coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
