"""Device milliseconds a step in the kernels whose names hold one of the
metric's `kernels` patterns and none of its `exclude` patterns."""

from benchmark.readers.trace import kernel_seconds


def read(metric: dict, summary: dict, work: dict):
    seconds = kernel_seconds(summary, metric["kernels"],
                             metric.get("exclude", ()))
    if seconds <= 0 or not work.get("steps"):
        return None
    return seconds * 1e3 / work["steps"]
