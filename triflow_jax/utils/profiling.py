"""Tracing / profiling helpers.

The reference only keeps per-step wall/CPU timers
(upstream triflow/core/simulation.py:218-225); here the same Timer is
kept (core/simulation.py) and extended with device-level tracing through
``jax.profiler`` plus a device-vs-host time split for one step.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir):
    """Capture a jax.profiler trace (open with TensorBoard / xprof).

    >>> with trace("/tmp/tb"):          # doctest: +SKIP
    ...     simulation.run()
    """
    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def step_breakdown(simulation, n=5):
    """Run n output steps and split wall time into device-compute vs
    host/dispatch time.

    Returns dict(total_s, device_s, host_s, per_step_s)."""
    total = 0.0
    device = 0.0
    for _ in range(n):
        start = time.perf_counter()
        t, fields = next(simulation)
        # block on the new state: everything after this point was host time
        for key in fields.keys():
            arr = fields[key]
            if hasattr(arr, "block_until_ready"):
                arr.block_until_ready()
        dev_done = time.perf_counter()
        total += dev_done - start
        device += simulation._last_running
    return {
        "total_s": total,
        "device_s": device,
        "host_s": max(total - device, 0.0),
        "per_step_s": total / n,
    }
