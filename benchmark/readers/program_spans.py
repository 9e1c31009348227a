"""The program's own spans over a profiled stretch.

`Stretch` is `trace.Stretch` that also records `ldt_torch`'s spans
(`ldt_torch.tools.profiling.start` / `stop`, on `time.time_ns()`, the
clock of the kineto events) while the profiler runs. `summarize` is
`trace.summarize` with these keys added; every key it had keeps its value
except `breakdown.idle_gaps`, whose labels become `<span> / <runtime
call>`: the innermost span the host was inside at the gap's middle
(`(no span)` where it was in none), then the runtime call as before.

- `spans`: [name, id, parent id, step, start_s, end_s] of each recorded
  span, times from the origin of `kernels`;
- `kernel_spans`: beside each entry of `kernels`, the id of the innermost
  span open when the runtime call that launched it started (the host
  event with the device event's correlation id), or None;
- `span_timeline`: [start_s, id or None] segments: from each start until
  the next, the innermost span the host was inside.

The readers `span_ms` and `span_idle` read these keys; a summary without
them (`trace.summarize`'s) gives them nothing to read.
"""

from __future__ import annotations

import bisect

from benchmark.readers import trace


class Stretch(trace.Stretch):
    def __init__(self, device: str):
        super().__init__(device)
        self.spans = []
        self._summary = None

    def begin(self) -> None:
        from ldt_torch.tools import profiling

        super().begin()
        profiling.start()

    def end(self) -> None:
        from ldt_torch.tools import profiling

        super().end()
        self.spans = profiling.stop()

    def summary(self) -> dict:
        if self._summary is None:
            self._summary = summarize(
                self.prof.profiler.kineto_results.events(), self.window_s,
                self.spans)
        return self._summary


def _split(events):
    """(device events, host events) as `trace.summarize` takes them."""
    dev, host = [], []
    for e in events:
        act = trace._call(e, "activity_type")
        if trace._on_device(e):
            if act is None or act in trace.DEVICE_ACTIVITIES:
                dev.append(e)
        else:
            host.append(e)
    return dev, host


def timeline(spans) -> tuple:
    """([t_ns], [id or None]): from each t until the next, the innermost of
    the (nested) `spans` open there."""
    edges = []
    for s in spans:
        # at one instant: ends before starts, a parent's start before its
        # child's, a child's end before its parent's
        edges.append((s.start_ns, 1, s.id, s))
        edges.append((s.end_ns, 0, -s.id, s))
    edges.sort(key=lambda e: e[:3])
    times, ids, open_ = [], [], []
    for t, starting, _, s in edges:
        if starting:
            open_.append(s.id)
        elif s.id in open_:
            open_.remove(s.id)
        top = open_[-1] if open_ else None
        if times and times[-1] == t:
            ids[-1] = top
        else:
            times.append(t)
            ids.append(top)
    return times, ids


def innermost(times, ids, t):
    """The innermost span id open at `t` (None outside every span)."""
    if t is None:
        return None
    i = bisect.bisect_right(times, t) - 1
    return ids[i] if i >= 0 else None


def summarize(events, window_s: float, spans) -> dict:
    """`trace.summarize(events, window_s)` with the recorded `spans`
    (`ldt_torch.tools.profiling.Span`) laid over it."""
    events = list(events)
    out = trace.summarize(events, window_s)
    dev, host = _split(events)
    lo = min([trace._ns(e)[0] for e in dev + host], default=0)
    times, ids = timeline(spans)
    names = {s.id: s.name for s in spans}
    launched = {}
    for e in host:
        corr = trace._call(e, "correlation_id")
        if corr:
            launched.setdefault(corr, trace._ns(e)[0])
    out["spans"] = [[s.name, s.id, s.parent, s.step, (s.start_ns - lo) * 1e-9,
                     (s.end_ns - lo) * 1e-9] for s in spans]
    out["kernel_spans"] = [
        innermost(times, ids, launched.get(trace._call(e, "correlation_id")))
        for e in dev]
    out["span_timeline"] = [[(t - lo) * 1e-9, i] for t, i in zip(times, ids)]
    # the idle gaps again (as `trace.summarize` finds them), each labelled
    # with the span the host was inside at its middle, then the call
    busy = trace._union([(s, s + d) for s, d in map(trace._ns, dev)])
    host.sort(key=lambda e: trace._ns(e)[0])
    starts = [trace._ns(e)[0] for e in host]
    gaps: dict = {}
    edges = [x for iv in busy for x in iv][1:-1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        i = bisect.bisect_right(starts, mid) - 1
        call = host[i].name() if i >= 0 else "(no host op)"
        where = names.get(innermost(times, ids, mid), "(no span)")
        label = f"{where} / {call}"
        gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-9
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    out["breakdown"] = dict(out["breakdown"],
                            idle_gaps=[[n, s] for n, s in top])
    return out


def per_count(summary: dict, per: str) -> int:
    """The complete `per` spans (steps or calls) of the stretch."""
    return sum(1 for s in summary.get("spans", ()) if s[0] == per)


def recorded(summary: dict, names) -> bool:
    """Whether a span of one of `names` was recorded in the stretch."""
    return any(s[0] in names for s in summary.get("spans", ()))


def credited(summary: dict, names, children: bool = False) -> set:
    """The ids of the spans whose time a metric of `names` takes: the spans
    of those names, and with `children` every span inside one of them."""
    parent = {s[1]: s[2] for s in summary["spans"]}
    name = {s[1]: s[0] for s in summary["spans"]}
    out = set()
    for i in parent:
        j = i
        while j in parent:
            if name[j] in names:
                out.add(i)
                break
            if not children:
                break
            j = parent[j]
    return out


def device_seconds(summary: dict, ids: set) -> float:
    """Device seconds of the events launched inside the spans `ids`."""
    return sum(k[2] for k, i in zip(summary["kernels"],
                                    summary["kernel_spans"]) if i in ids)


def idle_seconds(summary: dict, ids: set) -> float:
    """Seconds the device idled, between its first and last busy instant,
    while the host was inside one of the spans `ids` (innermost)."""
    busy = trace._union([(s, s + d) for _, s, d, _ in summary["kernels"]])
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    seg = summary["span_timeline"]
    segs = [(t0, t1, i) for (t0, i), t1 in
            zip(seg, [t for t, _ in seg[1:]] + [float("inf")])]
    total, g, k = 0.0, 0, 0
    while g < len(gaps) and k < len(segs):
        (g0, g1), (t0, t1, i) = gaps[g], segs[k]
        if i in ids:
            total += max(0.0, min(g1, t1) - max(g0, t0))
        if g1 < t1:
            g += 1
        else:
            k += 1
    return total
