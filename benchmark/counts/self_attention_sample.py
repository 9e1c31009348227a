"""The least seconds of K1's function over the stretch's denoising steps:
one packed self-attention a Score block a step, at the batch, in the
precision the cell computes in."""

from benchmark.counts.base import self_attention


def count(work: dict) -> float:
    c = work["config"]["score"]
    return work["steps"] * c["num_blocks"] * self_attention(
        work["batch"], c["z_scale"], c["hidden_size"], work["dtype"])
