"""Latent DiT denoiser ("Score" net), counterpart of `ldt_tpu/models/score.py`.

The non-UNet network that generation runs: project the [B, z_scale, z_dim]
latent to `hidden_size`, run `num_blocks` set-transformer blocks conditioned
on c = the time embedding (+ the label embedding, with `num_categorys` > 1
and a label), AdaLN blocks or with `AdaLN: False` blocks that add a
projection of c to their normed input, and map back to `z_dim` with an
AdaLN head. `ref_merge=True` builds the blocks with the reference's head
merge (`nn.layers.ref_merge`), for weights converted from the reference
(`ldt_torch.tools.port`). The point/image condition and UNet variants are
later work and raise here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ldt_torch import resolve_device
from ldt_torch.nn.layers import (
    Dense,
    FinalLayer,
    LabelEmbedding,
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
                 generator: Optional[torch.Generator] = None,
                 ref_merge: bool = False):
        super().__init__()
        for flag, what in ((cfg.unet, "the UNet variant"),
                           (cfg.condition, "the conditional Score"),
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
                          act=cfg.act, AdaLN=cfg.AdaLN, ref_merge=ref_merge,
                          **kw)
            for _ in range(cfg.num_blocks))
        self.time_embedding = TimeEmbedding(cfg.t_dim // 4, cfg.t_dim, **kw)
        self.ln_out = FinalLayer(cfg.hidden_size, cfg.z_dim, dim_c=cfg.t_dim,
                                 norm=cfg.norm, **kw)
        if cfg.num_categorys > 1:
            self.label_embedding = LabelEmbedding(
                cfg.num_categorys, cfg.t_dim, cfg.t_dim, **kw)
        init_weights_(self, generator)

    def precompute_mods(self, t: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every AdaLN modulation for a vector of times `t` [S]:
        {'blocks': [S, num_blocks, 6*hidden], 'final': [S, 2*hidden]}.

        The conditioning depends on t alone (no label), so a fixed sampling
        schedule's time embeddings and AdaLN heads are computed once,
        outside the reverse-diffusion loop. AdaLN blocks only.
        """
        if not self.cfg.AdaLN:
            raise ValueError("precompute_mods needs AdaLN blocks: an "
                             "AdaLN=False Score runs whole each step")
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

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                label: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, z_scale, z_dim], t [B], label [B] category indices (or
        None) -> the predicted noise, x's shape."""
        c = self.time_embedding(t)
        if label is not None:
            if not hasattr(self, "label_embedding"):
                raise ValueError("a label needs score.num_categorys > 1")
            c = c + self.label_embedding(label)
        h = self.ln_in(x)
        for layer in self.transformer:
            h = layer(h, c=c)
        return self.ln_out(h, c)
