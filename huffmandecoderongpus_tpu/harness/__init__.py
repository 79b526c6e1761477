"""Benchmark harness: verify + min-of-25 evaluation, scaling sweeps, CLI.

Counterpart of the reference's decodeUtil/timing/mainrun layers
(reference framework/decodeUtil.c, timing.c, mainrun.c).
"""

from huffmandecoderongpus_tpu.harness.evaluate import (  # noqa: F401
    REPEATS,
    DecodeMismatch,
    EvalResult,
    compare_uncompressed,
    evalandshow,
    evaluate,
)
from huffmandecoderongpus_tpu.harness.timing import Timer, gb_per_s, report_resolution  # noqa: F401
from huffmandecoderongpus_tpu.harness.truncate import (  # noqa: F401
    graph_rows,
    graphtest,
    set_target_sizes,
    truncate_test_data,
)
