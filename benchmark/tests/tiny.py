"""The cells cut to a size the CPU runs in seconds: the same runners, the
program's plain twins in place of the CUDA kernels."""

TINY = {"score": {"z_dim": 8, "z_scale": 8, "hidden_size": 64,
                  "num_heads": 4, "num_blocks": 2, "t_dim": 64},
        "compressor": {"outsize": 64, "max_outputs": 64, "z_dim": 4,
                       "z_scales": 8, "p_dim": 32, "n_layers": 2,
                       "hidden_dim": 32, "num_heads": 2},
        # beta_end / N stays below 1
        "sde": {"sample_N": 32, "train_N": 32},
        "data": {"batch_size": 4, "tr_max_sample_points": 128,
                 "te_max_sample_points": 128}}

PARAMS = {"train_stage2": {"batches": 2, "steps_per_epoch": 2,
                           "traced_steps": 2},
          "sample": {"batch": 4, "warmup_steps": 4, "traced_steps": 4,
                       "traced_from": 2, "check_rows": 2},
          "evaluate": {"clouds": 6, "batch_size": 4, "check_pairs": 16,
                       "check_block": 8, "sample_sets": 2}}

SEED = 2 ** 31 + 7


def shrink(c: dict) -> dict:
    """A loaded cell (`harness.cell`) cut to the tiny size, in place."""
    for key, over in TINY.items():
        c["config"][key] = {**c["config"][key], **over}
    c["traffic"]["params"].update(PARAMS[c["traffic"]["runner"]])
    return c


def run(name: str, trace: bool = False) -> dict:
    """One CPU run of cell `name` at the tiny size."""
    from benchmark import harness

    kind = harness.cell(name)["traffic"]["runner"]
    return harness.run(name, SEED, 0.5, trace, device="cpu",
                       config_over=TINY, params_over=PARAMS[kind])
