"""Profiling / tracing harness.

The reference's only timing story is ``@time`` in README examples
(reference README.md:198-201, docs/compare.Rmd); here profiling is a
first-class utility:

- :func:`trace` — context manager around ``jax.profiler`` writing a
  TensorBoard-loadable trace (open with xprof / tensorboard-plugin-profile).
- :func:`timed` — wall-time measurement on asynchronous backends: each
  timed call ends in ``jax.block_until_ready`` on its result, so the time
  covers the device work and not just its dispatch.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Tuple

import jax


@contextlib.contextmanager
def trace(logdir: str = "/tmp/bulklmm_trace"):
    """Capture a device trace: ``with trace("/tmp/t"): run_scan()``."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def timed(fn: Callable, *args, repeats: int = 3, warmup: int = 1, **kwargs) -> Tuple[float, object]:
    """(best_seconds, last_result) of ``fn(*args, **kwargs)``.

    Compile latency lands in the ``warmup`` calls; each timed call waits
    for its result's arrays (``jax.block_until_ready``).
    """
    result = None
    for _ in range(warmup):
        result = jax.block_until_ready(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        result = jax.block_until_ready(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return best, result
