"""Profiling and tracing hooks, counterpart of `ldt_tpu/tools/profiling.py`:
named spans around the program's layers, and a device trace
(`torch.profiler` in place of `jax.profiler`).

    profiling.start()
    trainer.update(batch)          # its spans: train.step, train.batch, ...
    spans = profiling.stop()       # [Span(name, id, parent, step, ...)]

    with profiling.trace("/tmp/ldt_trace") as prof:
        trainer.update(batch)
    prof.key_averages()   # per-kernel CPU and device times, and the spans

`span(name)` is the one span API. Off (the default) it returns a shared
do-nothing context: a check of one module-level flag, nothing allocated,
neither the clock nor the profiler called. Between `start()` and `stop()`
each span keeps its name, its id (entry order), its parent's id, the step
or call it belongs to and its start and end on `time.time_ns()`, the clock
torch's kineto events carry, so a span can be laid over a profiler's
device timeline. A span entered while recording was off, or still open when
it stops, is not kept. Spans are entered by one thread.

`trace` writes a Chrome trace (`trace.json`, viewable in Perfetto or
chrome://tracing) under `log_dir`, with the spans recorded inside it as
`record_function` ranges, and yields the profiler.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, NamedTuple, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


class Span(NamedTuple):
    """A recorded span: `id` its entry order in the recording, `parent` the
    enclosing span's id (-1 at the top), `step` the step or call it belongs
    to (given where the step is known, else the parent's, else the count of
    earlier top-level spans of its name), times in ns on `time.time_ns()`."""
    name: str
    id: int
    parent: int
    step: int
    start_ns: int
    end_ns: int


class _Recording:
    """The spans of one `start()` ... `stop()`."""

    def __init__(self, annotate: bool):
        self.annotate = annotate
        self.spans: List[Span] = []
        self.open: list = []   # the open _Span objects, outermost first
        self.entered = 0
        self.tops: dict = {}   # name -> top-level spans of it so far


# the recording in progress, None while spans are off
_recording: Optional[_Recording] = None
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "step", "rec", "id", "parent", "start", "note")

    def __init__(self, rec: _Recording, name: str, step: Optional[int]):
        self.rec, self.name, self.step, self.note = rec, name, step, None

    def __enter__(self):
        rec = self.rec
        top = rec.open[-1] if rec.open else None
        self.id, self.parent = rec.entered, -1 if top is None else top.id
        rec.entered += 1
        if self.step is None:
            if top is not None:
                self.step = top.step
            else:
                self.step = rec.tops.get(self.name, 0)
                rec.tops[self.name] = self.step + 1
        rec.open.append(self)
        if rec.annotate:
            self.note = record_function(self.name)
            self.note.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.note is not None:
            self.note.__exit__(*exc)
        rec = self.rec
        if self in rec.open:
            rec.open.remove(self)
        if rec is _recording:
            rec.spans.append(Span(self.name, self.id, self.parent, self.step,
                                  self.start, end))
        return False


def span(name: str, step: Optional[int] = None):
    """A context that records the span `name` (of step or call `step`)
    while recording is on; otherwise a shared no-op."""
    if _recording is None:
        return _OFF
    return _Span(_recording, name, step)


def start(annotate: bool = False) -> None:
    """Record spans from now on (a fresh list); with `annotate` each span
    is also a `record_function` range of a running profiler."""
    global _recording
    _recording = _Recording(annotate)


def stop() -> List[Span]:
    """Stop recording; the spans completed since `start()`, in entry order
    (none if recording was off)."""
    global _recording
    rec, _recording = _recording, None
    return [] if rec is None else sorted(rec.spans, key=lambda s: s.id)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the host and, where there is a card, the device inside, with
    the spans recorded as `record_function` ranges; write
    `log_dir/trace.json` on exit and yield the profiler (its
    `key_averages()` and `events()` hold the spans and kernels)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        start(annotate=True)
        try:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            stop()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
