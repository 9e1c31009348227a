"""The model FLOPs of the stretch's stage-2 steps: each the frozen
set-VAE's posterior pass over the batch's clouds, then three Score
forwards' worth (the loss's forward and its backward)."""

from benchmark.counts.base import encode, score_forward


def count(work: dict) -> float:
    c, b = work["config"], work["batch"]
    step = 3 * score_forward(c["score"], b) \
        + encode(c["compressor"], b, work["points"])
    return work["steps"] * step
