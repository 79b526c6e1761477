"""Multi-device / multi-host layer: mesh construction, block-parallel decode.

This subsystem has no counterpart in the reference (single-process,
single-device — SURVEY §2.3): data parallelism over bitstream blocks and
lanes on a `jax.sharding.Mesh` of cards.
"""

from huffmandecoderongpus_tpu.parallel.mesh import (  # noqa: F401
    BLOCK_AXIS,
    distributed_init,
    make_mesh,
)
from huffmandecoderongpus_tpu.parallel.block_decode import (  # noqa: F401
    decode_sharded,
    decode_sharded_arrays,
)
from huffmandecoderongpus_tpu.parallel.lane_sharded import (  # noqa: F401
    decode_lane_sharded,
    lane_sharded_runner,
)
