"""Profiling and tracing hooks, counterpart of `ldt_tpu/tools/profiling.py`:
a device trace (`torch.profiler` in place of `jax.profiler`), named spans,
and the step-time meter.

    with profiling.trace("/tmp/ldt_trace") as prof:
        with profiling.annotate("stage2_step"):
            trainer.update(batch)
    prof.key_averages()   # per-kernel CPU and device times

`trace` writes a Chrome trace (`trace.json`, viewable in Perfetto or
chrome://tracing) under `log_dir` and yields the profiler.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the host and, where there is a card, the device inside;
    write `log_dir/trace.json` on exit and yield the profiler (its
    `key_averages()` and `events()` hold the spans and kernels)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span of the trace (a `record_function` range)."""
    return record_function(name)


class StepTimer:
    """Rolling step-time and throughput meter (the reference's "Sample
    rate" and "NFE/s" prints): the mean of the last `window` intervals
    between `tick`s."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now
        return self.step_time

    @property
    def step_time(self) -> Optional[float]:
        if not self.times:
            return None
        return sum(self.times) / len(self.times)

    def rate(self, items_per_step: int) -> Optional[float]:
        st = self.step_time
        return items_per_step / st if st else None
