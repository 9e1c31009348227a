"""The least seconds of K3's function over the stretch's stage-2 steps:
one packed self-attention backward a Score block a step, at the batch, in
the precision the cell computes in."""

from benchmark.counts.base import self_attention_bwd


def count(work: dict) -> float:
    c = work["config"]["score"]
    return work["steps"] * c["num_blocks"] * self_attention_bwd(
        work["batch"], c["z_scale"], c["hidden_size"], work["dtype"])
