"""The cells cut to a size the CPU runs in seconds: the same runners, the
program's plain twins in place of the CUDA kernels.

`TINY` cuts the configuration's sections; each runner's module holds its
traffic parameters at the tiny size (`runners/<runner>.py::TINY`), and
may cut sections of its own there under the key "config"."""

TINY = {"score": {"z_dim": 8, "z_scale": 8, "hidden_size": 64,
                  "num_heads": 4, "num_blocks": 2, "t_dim": 64},
        "compressor": {"outsize": 64, "max_outputs": 64, "z_dim": 4,
                       "z_scales": 8, "p_dim": 32, "n_layers": 2,
                       "hidden_dim": 32, "num_heads": 2},
        # beta_end / N stays below 1
        "sde": {"sample_N": 32, "train_N": 32},
        "data": {"batch_size": 4, "tr_max_sample_points": 128,
                 "te_max_sample_points": 128}}

SEED = 2 ** 31 + 7


def cut(kind: str) -> tuple:
    """(config sections, traffic parameters) of runner `kind` at the tiny
    size."""
    from benchmark import harness

    params = dict(harness.runner_module(kind).TINY)
    config = dict(TINY)
    for key, over in params.pop("config", {}).items():
        config[key] = {**config.get(key, {}), **over}
    return config, params


def shrink(c: dict) -> dict:
    """A loaded cell (`harness.cell`) cut to the tiny size, in place."""
    config, params = cut(c["traffic"]["runner"])
    for key, over in config.items():
        c["config"][key] = {**c["config"][key], **over}
    c["traffic"]["params"].update(params)
    return c


def run(name: str, trace: bool = False, **kw) -> dict:
    """One CPU run of cell `name` at the tiny size (`kw` to
    `harness.run`)."""
    from benchmark import harness

    config, params = cut(harness.cell(name)["traffic"]["runner"])
    return harness.run(name, SEED, 0.5, trace, device="cpu",
                       config_over=config, params_over=params, **kw)
