"""Tracing / profiling utilities.

The reference has no profiling at all (SURVEY.md §5.1 — the only timing
artifact is the 5 s poll constant). Here: lightweight stage timers that
wait for the device work they time (jax.block_until_ready), and a
jax.profiler trace context for traces of the hot paths.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict

import jax

log = logging.getLogger(__name__)


def sync(x) -> None:
    """Wait until the device work producing x has finished."""
    jax.block_until_ready(x)


def timeit(fn, *args, reps: int = 10, **kw):
    """Mean seconds per call of fn(*args, **kw) over `reps` calls queued
    back to back and waited for once, after one untimed call (which
    compiles). Returns (seconds, output of the untimed call)."""
    out = fn(*args, **kw)
    sync(out)
    t0 = time.perf_counter()
    outs = [fn(*args, **kw) for _ in range(reps)]
    sync(outs[-1])
    return (time.perf_counter() - t0) / reps, out


class StageTimer:
    """Accumulates wall-clock per named stage.

    with timer.stage("flow", sync_on=result): ...
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        out = _StageHandle()
        try:
            yield out
        finally:
            if out.value is not None:
                sync(out.value)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            n = self.counts[name]
            t = self.totals[name]
            lines.append(f"{name:24s} {t:8.3f}s total  {t / max(n, 1) * 1000:8.1f} ms/call  x{n}")
        return "\n".join(lines)

    def log_report(self) -> None:
        log.info("stage timings:\n%s", self.report())


class _StageHandle:
    """Assign `.value` inside the stage to sync on it at stage exit."""

    value = None


@contextlib.contextmanager
def device_trace(log_dir: str = "videoquery_trace"):
    """jax.profiler trace (view in TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
        log.info("device trace written to %s", log_dir)
