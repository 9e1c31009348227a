"""Device milliseconds a `per` span (a step or call) in the events
launched inside the metric's `spans`: each device event is credited to
the innermost recorded span open when its launch started
(`program_spans`), so a span's own events are its self time; with
`"children": true` a listed span also takes the events of the spans
inside it. Nothing to read without the program's spans or a device, or
where no span of `spans` was recorded: a span off the path reads nothing,
not 0."""

from benchmark.readers.program_spans import credited, device_seconds, \
    per_count, recorded


def read(metric: dict, summary: dict, work: dict):
    if "spans" not in summary or summary["busy_s"] <= 0:
        return None
    per = per_count(summary, metric["per"])
    if not per or not recorded(summary, metric["spans"]):
        return None
    ids = credited(summary, metric["spans"], metric.get("children", False))
    return device_seconds(summary, ids) * 1e3 / per
