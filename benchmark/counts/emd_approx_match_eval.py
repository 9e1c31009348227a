"""The least seconds of K6/K7's function over the stretch's
`compute_all_metrics` calls: the approximate matching of each of the
3 N M pairs (sample x ref, sample x sample, ref x ref) a call."""

from benchmark.counts.base import emd_approx_match


def count(work: dict) -> float:
    n, pts = work["clouds"], work["points"]
    return work["calls"] * emd_approx_match(3 * n * n, pts, pts)
