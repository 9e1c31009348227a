"""What the runners share: the program's config from a configuration file,
the reference's networks from the seed, the relative gaps the checks
compare."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import weights


DTYPES = {"float32": "float32", "f32": "float32", "bfloat16": "bfloat16",
          "bf16": "bfloat16"}


def compute_dtype(config: dict) -> str:
    """The precision the configuration computes in (`common.train_dtype`,
    float32 where it names none, as the program reads it), by the counts'
    name."""
    return DTYPES[config["common"].get("train_dtype", "float32")]


def namespace(config: dict, *sections: str):
    """The program's config (`ldt_torch.configs.latent_trainer_cfg`) with
    the configuration file's sections."""
    from ldt_torch.configs import latent_trainer_cfg

    return latent_trainer_cfg(**{s: config[s] for s in sections})


def ref_nets(config: dict, seed: int, device):
    """The reference Score and Compressor with the seed's weights."""
    return (weights.score(config, seed, device),
            weights.compressor(config, seed, device))


def state(net: torch.nn.Module) -> dict:
    return {k: v.detach() for k, v in net.state_dict().items()}


def rel_rows(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest per-row |got - want| / |want| (L2 over each row)."""
    got, want = got.double().flatten(1), want.double().flatten(1)
    return float(((got - want).norm(dim=1)
                  / want.norm(dim=1).clamp(min=1e-30)).max())


def norm_gap(got: dict, want: dict, keys=None) -> float:
    """Worst leaf of |got[k] - want[k]| / max(want[k], median of want):
    got and want hold one norm per leaf."""
    keys = list(want) if keys is None else list(keys)
    med = float(np.median([want[k] for k in want]))
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in keys)


def leaf_norms(tensors: dict) -> dict:
    keys = list(tensors)
    norms = torch.stack(torch._foreach_norm(
        [tensors[k].double() for k in keys])).cpu().tolist()
    return dict(zip(keys, norms))


def pick_rows(seed: int, stream: int, batch: int, count: int) -> list:
    """`count` distinct rows of a batch, drawn from the seed."""
    rng = np.random.default_rng([seed, stream])
    return sorted(rng.choice(batch, size=min(count, batch),
                             replace=False).tolist())
