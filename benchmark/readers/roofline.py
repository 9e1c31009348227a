"""A kernel function's share of its roofline, in percent: the least time
the chip needs for the stretch's calls of the function (the metric's
`count` module) over the device time of the kernels whose names hold one
of the metric's `kernels` patterns and none of its `exclude` patterns."""

from benchmark.counts import count_of
from benchmark.readers.trace import kernel_seconds


def read(metric: dict, summary: dict, work: dict):
    least = count_of(metric, work)
    seconds = kernel_seconds(summary, metric["kernels"],
                             metric.get("exclude", ()))
    if not least or seconds <= 0:
        return None
    return 100.0 * least / seconds
