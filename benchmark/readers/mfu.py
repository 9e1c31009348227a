"""The whole step's share of the chip's peak, in percent: the model FLOPs
of the profiled stretch (the metric's `count` module) over its window and
over the peak of the precision the cell computes in (`work["dtype"]`)."""

from benchmark.counts.base import PEAK_FLOPS
from benchmark.counts import count_of


def read(metric: dict, summary: dict, work: dict):
    flops = count_of(metric, work)
    if summary["busy_s"] <= 0 or not flops:
        return None
    return 100.0 * flops / summary["window_s"] / PEAK_FLOPS[work["dtype"]]
