"""A per-layer metric's count (`base` holds the arithmetic)."""

import importlib


def count_of(metric: dict, work: dict) -> float:
    """The stretch's count by the metric's `count` module
    (`benchmark/counts/<count>.py`)."""
    module = importlib.import_module(f"benchmark.counts.{metric['count']}")
    return module.count(work)
