"""The model FLOPs of the stretch's denoising steps: a Score forward a
step at the batch; with a label the whole Score, without one the
modulations are hoisted out of the loop and not counted."""

from benchmark.counts.base import score_forward


def count(work: dict) -> float:
    label = work["label"]
    return work["steps"] * score_forward(work["config"]["score"],
                                         work["batch"], label=label,
                                         mods=label)
