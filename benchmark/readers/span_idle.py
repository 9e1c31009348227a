"""Milliseconds a `per` span (a step or call) the device idled while the
host was inside the metric's `spans` (`program_spans`): innermost, or with
`"children": true` anywhere inside a listed span, the spans within it
included. Nothing to read without the program's spans or a device, or
where no span of `spans` was recorded: a span off the path reads nothing,
not 0."""

from benchmark.readers.program_spans import credited, idle_seconds, \
    per_count, recorded


def read(metric: dict, summary: dict, work: dict):
    if "spans" not in summary or summary["busy_s"] <= 0:
        return None
    per = per_count(summary, metric["per"])
    if not per or not recorded(summary, metric["spans"]):
        return None
    ids = credited(summary, metric["spans"], metric.get("children", False))
    return idle_seconds(summary, ids) * 1e3 / per
