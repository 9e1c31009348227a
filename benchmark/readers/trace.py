"""The profiled stretch of a `--trace 1` run and what the readers take from
it. The stretch starts and ends with a synchronize; torch.profiler records
the device's activity alone (CUDA: kernels, copies, sets, and the runtime
calls the host made), since recording every host op would slow the host
by a third and show the device idler than it is. `window_s` is the host
clock between the two synchronizes, `busy_s` the union of the device
intervals. An idle gap is labelled with the runtime call the host had
made last before its middle.

On the CPU (the tests) the profiler records the host ops, there is no
device activity: busy is 0 and the readers that need the device return
nothing.
"""

from __future__ import annotations

import bisect
import time

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Stretch:
    def __init__(self, device: str):
        self.device = device
        self.prof = None
        self.window_s = 0.0

    def _sync(self):
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        self.prof = profile(activities=[
            ProfilerActivity.CPU if self.device == "cpu"
            else ProfilerActivity.CUDA])
        self.prof.start()
        self._t0 = time.perf_counter()

    def end(self) -> None:
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()

    def summary(self) -> dict:
        return summarize(self.prof.profiler.kineto_results.events(),
                         self.window_s)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _call(e, name: str):
    """An event method that some torch versions lack (None there)."""
    fn = getattr(e, name, None)
    return fn() if fn is not None else None


def _ns(e):
    """(start, duration) in ns."""
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.duration_ns()
    return int(e.start_us() * 1000), int(e.duration_us() * 1000)


def _on_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _is_kernel(e) -> bool:
    act = _call(e, "activity_type")
    if act is not None:
        return act == "kernel"
    return not e.name().startswith(("Memcpy", "Memset"))


def summarize(events, window_s: float) -> dict:
    """{window_s, busy_s, kernels: [(name, start_s, dur_s, is_kernel)],
    launches, breakdown} of a stretch's kineto events."""
    dev, host = [], []
    for e in events:
        act = _call(e, "activity_type")
        if _on_device(e):
            if act is None or act in DEVICE_ACTIVITIES:
                dev.append(e)
        else:
            host.append(e)
    lo = min([_ns(e)[0] for e in dev + host], default=0)
    intervals = []
    kernels = []
    for e in dev:
        s, d = _ns(e)
        intervals.append((s, s + d))
        kernels.append((e.name(), (s - lo) * 1e-9, d * 1e-9,
                        _is_kernel(e)))
    busy = _union(intervals)
    busy_ns = sum(e - s for s, e in busy)
    by_name: dict = {}
    for name, _, d, _ in kernels:
        by_name[name] = by_name.get(name, 0.0) + d
    # an idle gap between two device intervals is labelled by the host
    # call that started last before its middle
    host.sort(key=lambda e: _ns(e)[0])
    starts = [_ns(e)[0] for e in host]
    gaps: dict = {}
    edges = [x for iv in busy for x in iv][1:-1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        i = bisect.bisect_right(starts, (g0 + g1) / 2) - 1
        label = host[i].name() if i >= 0 else "(no host op)"
        gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": window_s, "busy_s": busy_ns * 1e-9,
            "kernels": kernels,
            "launches": sum(1 for k in kernels if k[3]),
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": [[n, s] for n, s in top_gaps]}}


def kernel_seconds(summary: dict, patterns, exclude=()) -> float:
    """Device seconds of the kernels whose lower-cased name holds one of
    `patterns` and none of `exclude`."""
    total = 0.0
    for name, _, d, is_kernel in summary["kernels"]:
        low = name.lower()
        if is_kernel and any(p in low for p in patterns) \
                and not any(x in low for x in exclude):
            total += d
    return total

