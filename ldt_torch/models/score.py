"""Latent DiT denoiser ("Score" net), counterpart of `ldt_tpu/models/score.py`.

The unconditional, non-UNet network that generation runs: project the
[B, z_scale, z_dim] latent to `hidden_size`, run `num_blocks` AdaLN
set-transformer blocks conditioned on the time embedding, and map back to
`z_dim` with an AdaLN head. The label, point/image condition and UNet
variants are later work and raise here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ldt_torch import resolve_device
from ldt_torch.nn.layers import (
    Dense,
    FinalLayer,
    ResidualBlock,
    TimeEmbedding,
    init_weights_,
)


class Score(nn.Module):
    """Latent DiT. `cfg` is the `score:` config section (`configs.score_cfg`).

    Weights are drawn from `generator` with the JAX package's initializers;
    load trained ones with `ldt_torch.weights.load_score`.
    """

    def __init__(self, cfg, *, dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for flag, what in ((cfg.unet, "the UNet variant"),
                           (cfg.condition, "the conditional Score"),
                           (cfg.num_categorys > 1, "label conditioning"),
                           (not cfg.AdaLN, "the AdaLN=False block"),
                           (cfg.dropout, "dropout (score.dropout > 0)")):
            if flag:
                raise NotImplementedError(f"{what} is not ported yet")
        dev = resolve_device(device)
        kw = dict(dtype=dtype, device=dev)
        self.cfg = cfg
        self.ln_in = Dense(cfg.z_dim, cfg.hidden_size, **kw)
        self.transformer = nn.ModuleList(
            ResidualBlock(cfg.hidden_size, dim_c=cfg.t_dim,
                          num_heads=cfg.num_heads, norm=cfg.norm,
                          act=cfg.act, **kw)
            for _ in range(cfg.num_blocks))
        self.time_embedding = TimeEmbedding(cfg.t_dim // 4, cfg.t_dim, **kw)
        self.ln_out = FinalLayer(cfg.hidden_size, cfg.z_dim, dim_c=cfg.t_dim,
                                 norm=cfg.norm, **kw)
        init_weights_(self, generator)

    def precompute_mods(self, t: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every AdaLN modulation for a vector of times `t` [S]:
        {'blocks': [S, num_blocks, 6*hidden], 'final': [S, 2*hidden]}.

        The conditioning depends on t alone, so a fixed sampling schedule's
        time embeddings and AdaLN heads are computed once, outside the
        reverse-diffusion loop.
        """
        c = self.time_embedding(t)
        blocks = torch.stack([blk.compute_mods(c) for blk in self.transformer],
                             dim=1)
        return {"blocks": blocks, "final": self.ln_out.compute_mods(c)}

    def denoise_with_mods(self, x: torch.Tensor,
                          mods: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One denoise step with one step's modulations:
        mods = {'blocks': [num_blocks, 6*hidden], 'final': [2*hidden]}."""
        h = self.ln_in(x)
        for i, layer in enumerate(self.transformer):
            h = layer(h, mods=mods["blocks"][i])
        return self.ln_out(h, mods=mods["final"])

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x [B, z_scale, z_dim], t [B] -> the predicted noise, x's shape."""
        c = self.time_embedding(t)
        h = self.ln_in(x)
        for layer in self.transformer:
            h = layer(h, c=c)
        return self.ln_out(h, c)
