"""Kernel launches in the profiled stretch per denoising step (a count)."""


def read(metric: dict, summary: dict, work: dict):
    if not summary["launches"] or not work.get("steps"):
        return None
    return summary["launches"] / work["steps"]
