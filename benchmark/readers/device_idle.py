"""The device's idle share of the profiled stretch: 1 - busy / window
(`trace.summarize`)."""


def read(metric: dict, summary: dict, work: dict):
    if summary["busy_s"] <= 0:
        return None
    return 1.0 - summary["busy_s"] / summary["window_s"]
