"""Set-VAE decode half, counterpart of `ldt_tpu/models/compressor.py`.

`Compressor.sample` turns [B, z_scales, n_layers * z_dim] latents into
[B, num_points, 3] clouds: a learned 2048-seed set cross-attends, block by
block, to each layer's projected latents. The encoder, `compute_posterior`,
the random seed subset and the mixture-of-Gaussians seeds are later work and
raise here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ldt_torch import resolve_device
from ldt_torch.nn.layers import Dense, ResidualBlock, init_weights_


class InitialSet(nn.Module):
    """Learned `[max_outputs, dim_seed]` seed set."""

    def __init__(self, dim_seed: int, max_outputs: Optional[int], *,
                 device=None):
        super().__init__()
        if max_outputs is None:
            raise NotImplementedError(
                "the mixture-of-Gaussians seed set is not ported yet")
        self.max_outputs = max_outputs
        self.prior = nn.Parameter(torch.empty(max_outputs, dim_seed,
                                              dtype=torch.float32,
                                              device=device))

    def forward(self, batch: int, num_points: int) -> torch.Tensor:
        if num_points >= self.max_outputs:
            return self.prior[None].expand(batch, *self.prior.shape)
        raise NotImplementedError(
            "a random subset of the seed set (num_points < max_outputs) is "
            "not ported yet")


class DecoderBlock(nn.Module):
    """Attentive bottleneck layer, generation half: the decoded set
    cross-attends to the projected latents, `att1(o, ln(eps))`."""

    def __init__(self, dim_in: int, dim_z: int, num_heads: int,
                 norm: Optional[str], mlp_ratio: float = 4.0,
                 act: Optional[str] = None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.att1 = ResidualBlock(dim_in, None, num_heads=num_heads, norm=norm,
                                  mlp_ratio=mlp_ratio, act=act, **kw)
        self.ln = Dense(dim_z, dim_in, **kw)

    def forward(self, o: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return self.att1(o, self.ln(eps))


class Compressor(nn.Module):
    """Decode half of the set-VAE. `cfg` is the `model:` config section
    (`configs.compressor_cfg`)."""

    def __init__(self, cfg, *, dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.class_condition:
            raise NotImplementedError(
                "the class-conditional Compressor is not ported yet")
        dev = resolve_device(device)
        kw = dict(dtype=dtype, device=dev)
        self.cfg = cfg
        self.decoder = nn.ModuleList(
            DecoderBlock(cfg.hidden_dim, cfg.z_dim, cfg.num_heads,
                         norm=cfg.norm, mlp_ratio=cfg.mlp_ratio,
                         act=cfg.decoder_act, **kw)
            for _ in range(cfg.n_layers))
        self.output_dense = Dense(cfg.hidden_dim, 3, **kw)
        self.init_set = InitialSet(cfg.hidden_dim, cfg.max_outputs, device=dev)
        init_weights_(self, generator)
        with torch.no_grad():
            self.init_set.prior.uniform_(0.0, 1.0, generator=generator)

    def sample(self, shape, given_eps: torch.Tensor) -> torch.Tensor:
        """Top-down generation. shape: (B, num_points); given_eps:
        [B, z_scales, n_layers * z_dim].

        The blocks run in reverse: decode step idx uses
        `decoder[n_layers - 1 - idx]` with eps channels
        [idx * z_dim, (idx + 1) * z_dim).
        """
        cfg = self.cfg
        b, num_points = shape[0], shape[1]
        o = self.init_set(b, num_points)
        eps_list = torch.split(given_eps, cfg.z_dim, dim=-1)
        if len(eps_list) != cfg.n_layers or given_eps.shape[-1] % cfg.z_dim:
            raise ValueError(f"given_eps last dim {given_eps.shape[-1]} is not "
                             f"n_layers * z_dim = {cfg.n_layers * cfg.z_dim}")
        for idx in range(cfg.n_layers):
            o = self.decoder[cfg.n_layers - 1 - idx](o, eps_list[idx])
        return self.postprocess(self.output_dense(o))

    @staticmethod
    def postprocess(x: torch.Tensor) -> torch.Tensor:
        """Dataset-specific output squashing (identity for xyz clouds)."""
        if x.shape[-1] == 2:
            return (torch.tanh(x) + 1) / 2.0
        if x.shape[-1] == 4:
            x = x.clone()
            x[..., -1] = (torch.tanh(x[..., -1]) + 1) / 2.0
        return x
