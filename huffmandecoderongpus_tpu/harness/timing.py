"""Monotonic wall-clock timers and throughput helpers.

Counterpart of the reference's timing layer
(reference framework/time.h:10-24, timing.c:25-65): the reference uses
CLOCK_MONOTONIC_RAW nanosecond timers; here `time.perf_counter_ns` (the same
clock class on Linux).  Device decoders synchronise internally (the host
wrapper materialises the result with `np.asarray`, which blocks until ready),
so wall-clock timing brackets the full H2D + compute + D2H span — matching
how the reference times whole `*Approach` calls including cudaMemcpy.
"""

from __future__ import annotations

import time


class Timer:
    """start/stop nanosecond timer (timing.h:20-30 semantics)."""

    __slots__ = ("_t0", "_t1")

    def __init__(self) -> None:
        self._t0 = 0
        self._t1 = 0

    def start(self) -> None:
        self._t0 = time.perf_counter_ns()

    def stop(self) -> None:
        self._t1 = time.perf_counter_ns()

    @property
    def ns(self) -> int:
        return self._t1 - self._t0

    @property
    def ms(self) -> float:
        return self.ns / 1e6

    @property
    def seconds(self) -> float:
        return self.ns / 1e9


def report_resolution() -> str:
    """Clock resolution report (reportresolution, timing.c:46-50)."""
    info = time.get_clock_info("perf_counter")
    return f"timer resolution: {info.resolution:.3e} s (monotonic={info.monotonic})"


def gb_per_s(nbytes: int, seconds: float) -> float:
    """Decode throughput in GB/s (decimal GB, the unit BASELINE.md uses)."""
    if seconds <= 0:
        return float("inf")
    return nbytes / seconds / 1e9
