"""Hierarchical attention set-VAE ("Compressor"), counterpart of
`ldt_tpu/models/compressor.py`.

Encode (`forward`, the JAX module's `__call__`): a [B, N, 3] cloud is
grouped by FPS + kNN into `z_scales` tokens (`LocalGrouper`), normalized per
token (`ActNorm`), and run through `n_layers` encoder stages whose taps give,
top-down, a hierarchy of Gaussian posteriors; their reparameterized samples
are the latents `all_eps` [B, z_scales, n_layers * z_dim], decode-order layer
i at channels [i * z_dim, (i + 1) * z_dim). Decode (`sample`): a learned
2048-seed set cross-attends, block by block, to each layer's projected
latents.

`train=True` (stage-1 training) runs the encoder's BatchNorms on the
batch's statistics and `forward` returns their updated running statistics,
as the JAX module's `train=True, mutable=["batch_stats"]`; otherwise they
take their running statistics (the frozen Compressor of stage-2 training,
sampling).

Options: `class_condition` (a label embedding added to the position
embedding, and decoder blocks conditioned on it through AdaLN; `sample`
passes no label, so there the decoder runs its unconditioned branch, as the
reference's does), `pre_group` (a first grouping to 256 groups of 32
neighbours), `pos_embedding: mlp`, the Encoder's `AdaLN` flag, the seed
set's random subset (`num_points < max_outputs`) and its mixture of
Gaussians (`max_outputs: None`), whose draws come from a generator or are
pinned (`seed_draw`), and `ref_merge` (the reference's head merge).

Under a registered sequence-parallel mesh (`parallel.sp.set_sp_mesh`) the
decode splits its point axis over the `model` ranks: the seed set is drawn
whole and sliced (`sp_shard`), each rank decodes its N/m points (K2 on its
queries against the whole latent key set), and the set is all-gathered
(`sp_gather`) for the posterior's keys and the output.

`dtype` is the compute dtype and `param_dtype` (default: `dtype`) the
weights' (f32 weights and bf16 compute: the JAX package's mixed-precision
training); ActNorm, the grouper's affine, the seed set and the norms keep
f32 parameters, as in the JAX module. Nonzero `encoder_dropout_p` and
`decoder_dropout_p` build, and eval and sampling are deterministic; a
train-mode forward with either raises, as the JAX package's does (its
trainers pass the Compressor no 'dropout' rng).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ldt_torch import resolve_device
from ldt_torch.nn.layers import (
    ActNorm,
    BatchNorm,
    Dense,
    FinalLayer,
    LabelEmbedding,
    MLP,
    ResidualBlock,
    get_activation,
    init_weights_,
    take_batch_norm_updates,
)
from ldt_torch.ops.geometry import cluster, index_points
from ldt_torch.parallel.sp import sp_gather, sp_shard

LOG_SQRT_2PI = 0.9189385332  # the reference's truncated constant


def log_p_var_normal(samples: torch.Tensor, mu: torch.Tensor,
                     logvar: torch.Tensor) -> torch.Tensor:
    """Gaussian log-density."""
    return (-0.5 * torch.square(samples - mu) / torch.exp(logvar)
            - 0.5 * logvar - LOG_SQRT_2PI)


def log_p_normal(samples: torch.Tensor) -> torch.Tensor:
    """Standard-normal log-density."""
    return -0.5 * torch.square(samples) - LOG_SQRT_2PI


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   noise: torch.Tensor) -> torch.Tensor:
    """mu + exp(logvar / 2) * noise, noise ~ N(0, 1) of mu's shape."""
    return mu + torch.exp(logvar / 2.0) * noise


class MiniPointnet(nn.Module):
    """[B, N, 3] -> [B, output_dim]: Dense/BN/ReLU x2, max over the points,
    Dense."""

    def __init__(self, in_dim: int, output_dim: int, *, dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.conv1 = Dense(in_dim, 128, **kw)
        self.bn1 = BatchNorm(128, **kw)
        self.conv2 = Dense(128, 256, **kw)
        self.bn2 = BatchNorm(256, **kw)
        self.fc = Dense(256, output_dim, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x), train))
        h = F.relu(self.bn2(self.conv2(h), train))
        return self.fc(h.amax(dim=1))


class ConvBNReLURes1D(nn.Module):
    """Residual Dense/BN block: act(net2(act(bn(net1(x)))) + x)."""

    def __init__(self, channel: int, res_expansion: float = 1.0,
                 activation: str = "relu", *, dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        mid = int(channel * res_expansion)
        self.act = get_activation(activation)
        self.net1_dense = Dense(channel, mid, **kw)
        self.net1_bn = BatchNorm(mid, **kw)
        self.net2_dense = Dense(mid, channel, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.act(self.net1_bn(self.net1_dense(x), train))
        return self.act(self.net2_dense(h) + x)


class PreExtraction(nn.Module):
    """Per-group features, max-pooled over the group:
    [B, S, K, D_in] -> [B, S, out_channels]."""

    def __init__(self, in_channels: int, out_channels: int, blocks: int = 1,
                 res_expansion: float = 1.0, activation: str = "relu", *,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.act = get_activation(activation)
        self.transfer_dense = Dense(in_channels, out_channels, **kw)
        self.transfer_bn = BatchNorm(out_channels, **kw)
        self.ops = nn.ModuleList(
            ConvBNReLURes1D(out_channels, res_expansion, activation, **kw)
            for _ in range(blocks))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, s, k, d = x.shape
        h = self.act(self.transfer_bn(self.transfer_dense(
            x.reshape(b * s, k, d)), train))
        for op in self.ops:
            h = op(h, train)
        return h.amax(dim=1).reshape(b, s, -1)


class LocalGrouper(nn.Module):
    """FPS centers + kNN groups + normalized grouped features.

    forward(xyz [B, N, 3], feature [B, N, D], groups S, k) ->
        (new_xyz [B, S, 3], features [B, S, D]).
    Each group's features carry its points' xyz (the JAX module's
    `use_xyz=True`, the only setting its callers use). `normalize`
    "anchor" (the shipped `cluster_norm`) subtracts each group's center
    point and feature, "center" the group mean; then one unbiased std over
    each cloud's flattened residuals, and the affine alpha/beta.
    """

    def __init__(self, in_channels: int,
                 normalize: Optional[str] = "anchor", *, dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        mode = normalize.lower() if normalize else None
        self.normalize = mode if mode in ("center", "anchor") else None
        if self.normalize is not None:
            kw = dict(dtype=torch.float32, device=device)
            self.affine_alpha = nn.Parameter(
                torch.ones(1, 1, 1, in_channels + 3, **kw))
            self.affine_beta = nn.Parameter(
                torch.zeros(1, 1, 1, in_channels + 3, **kw))
        self.extraction = PreExtraction(2 * in_channels + 3, in_channels,
                                        dtype=dtype, param_dtype=param_dtype,
                                        device=device)

    def forward(self, xyz: torch.Tensor, feature: torch.Tensor, groups: int,
                k: int, train: bool = False):
        b = xyz.shape[0]
        new_xyz, fps_idx, idx = cluster(xyz, groups, k)
        new_feature = index_points(feature, fps_idx)        # [B, S, D]
        grouped = torch.cat([index_points(feature, idx),
                             index_points(xyz, idx)], dim=-1)  # [B,S,k,D+3]
        if self.normalize is not None:
            if self.normalize == "center":
                mean = grouped.mean(dim=2, keepdim=True)
            else:
                mean = torch.cat([new_feature, new_xyz],
                                 dim=-1)[:, :, None, :]
            resid = grouped - mean
            std = resid.reshape(b, -1).std(dim=-1)[:, None, None, None]
            grouped = (self.affine_alpha * (resid / (std + 1e-5))
                       + self.affine_beta)
        anchor = new_feature[:, :, None, :].expand(-1, -1, k, -1)
        x = torch.cat([grouped, anchor], dim=-1)
        return new_xyz, self.extraction(x, train)


class InitialSet(nn.Module):
    """The decoder's seed set. With `max_outputs`: a learned
    `[max_outputs, dim_seed]` table, broadcast to the batch, or for
    `num_points < max_outputs` a random subset of its rows per cloud. With
    `max_outputs` None: a mixture of `n_mixtures` Gaussians, each draw
    eps * sig + mu weighted by softmax(logits) and summed over the
    mixtures, then Dense, SiLU, Dense.

    `draw` pins the randomness: the rows [B, num_points] of each cloud's
    subset, or the mixture's eps [B, num_points, n_mixtures, dim_seed];
    else a permutation per cloud or N(0, 1) from `generator`."""

    def __init__(self, dim_seed: int, max_outputs: Optional[int],
                 n_mixtures: int = 4, *, device=None):
        super().__init__()
        self.max_outputs = max_outputs
        kw = dict(dtype=torch.float32, device=device)
        if max_outputs is not None:
            self.prior = nn.Parameter(torch.empty(max_outputs, dim_seed,
                                                  **kw))
            return
        self.logits = nn.Parameter(torch.ones(n_mixtures, **kw))
        self.mu = nn.Parameter(torch.empty(n_mixtures, dim_seed, **kw))
        self.sig = nn.Parameter(torch.empty(n_mixtures, dim_seed, **kw))
        self.dense_0 = Dense(dim_seed, dim_seed, **kw)
        self.dense_1 = Dense(dim_seed, dim_seed, **kw)

    @torch.no_grad()
    def init_(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX initializers: the table U(0, 1); the mixture's mu
        N(0, 1), sig |N(0, 1)| / sqrt(n_mixtures), logits 1."""
        if self.max_outputs is not None:
            self.prior.uniform_(0.0, 1.0, generator=generator)
            return
        self.mu.normal_(0.0, 1.0, generator=generator)
        self.sig.normal_(0.0, 1.0, generator=generator)
        self.sig.abs_().div_(self.sig.shape[0] ** 0.5)
        self.logits.fill_(1.0)

    def draw(self, batch: int, num_points: int,
             generator: Optional[torch.Generator] = None
             ) -> Optional[torch.Tensor]:
        """The randomness of one forward from `generator`: the rows
        [batch, num_points] of each cloud's subset, the mixture's eps, or
        None (the whole table: nothing to draw)."""
        if self.max_outputs is not None:
            if num_points >= self.max_outputs:
                return None
            return torch.stack([torch.randperm(
                self.max_outputs, generator=generator,
                device=self.prior.device)[:num_points]
                for _ in range(batch)])
        shape = (batch, num_points) + tuple(self.mu.shape)
        return torch.randn(shape, device=self.mu.device, generator=generator)

    def forward(self, batch: int, num_points: int,
                draw: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if draw is None:
            draw = self.draw(batch, num_points, generator)
        if self.max_outputs is not None:
            prior = self.prior
            if num_points >= self.max_outputs:
                return prior[None].expand(batch, *prior.shape)
            return prior[draw.to(prior.device, torch.long)]
        mu, sig = self.mu, self.sig
        x = (draw.to(mu.device, mu.dtype) * sig + mu) * torch.softmax(
            self.logits, dim=0)[:, None]
        return self.dense_1(F.silu(self.dense_0(x.sum(2))))


class Encoder(nn.Module):
    """`num_layers` blocks conditioned on `pos` (AdaLN, or with `AdaLN`
    False the additive position embedding), then a FinalLayer tap. Keys and
    values are the raw pre-norm x (the reference's `layer(x, x, c)`), so
    the attention is K2 at N = M = z_scales."""

    def __init__(self, dim_in: int, p_dim: int, num_heads: int,
                 norm: Optional[str], mlp_ratio: float = 4.0,
                 num_layers: int = 1, *, AdaLN: bool = True,
                 ref_merge: bool = False, dropout_p: float = 0.0,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        for i in range(num_layers):
            self.add_module(f"att{i}", ResidualBlock(
                dim_in, dim_c=p_dim, num_heads=num_heads, norm=norm,
                mlp_ratio=mlp_ratio, AdaLN=AdaLN, ref_merge=ref_merge,
                dropout_att=dropout_p, dropout_mlp=dropout_p, **kw))
        self.num_layers = num_layers
        self.conv_out = FinalLayer(dim_in, dim_in, dim_c=p_dim, norm=norm,
                                   **kw)

    def forward(self, x: torch.Tensor, pos: torch.Tensor):
        for i in range(self.num_layers):
            x = getattr(self, f"att{i}")(x, x, pos)
        return x, self.conv_out(x, pos)


class DecoderBlock(nn.Module):
    """Attentive bottleneck layer. `compute_posterior(x, o, c)`: the encoder
    tap's tokens attend to the decoded set `o` (or, with `o` None, to their
    raw selves) -> (mu, logvar); `forward(o, eps, c)`: the decoded set
    cross-attends to the projected latents, `att1(o, ln(eps), c)`. With
    `c_dim` (a class-conditional Compressor) both blocks are AdaLN blocks
    conditioned on the label embedding `c`, and run their unconditioned
    branch when `c` is None."""

    def __init__(self, dim_in: int, dim_z: int, num_heads: int,
                 norm: Optional[str], mlp_ratio: float = 4.0,
                 min_sigma: float = -30.0, act: Optional[str] = None, *,
                 c_dim: Optional[int] = None, ref_merge: bool = False,
                 dropout_p: float = 0.0, dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        block = dict(num_heads=num_heads, norm=norm, mlp_ratio=mlp_ratio,
                     act=act, ref_merge=ref_merge, dropout_att=dropout_p,
                     dropout_mlp=dropout_p, **kw)
        self.dim_z = dim_z
        self.min_sigma = min_sigma
        self.att = ResidualBlock(dim_in, c_dim, **block)
        self.prior_dense = Dense(dim_in, 2 * dim_z, **kw)
        self.att1 = ResidualBlock(dim_in, c_dim, **block)
        self.ln = Dense(dim_z, dim_in, **kw)

    def compute_posterior(self, x: torch.Tensor,
                          o: Optional[torch.Tensor] = None,
                          c: Optional[torch.Tensor] = None):
        x = self.att(x, o if o is not None else x, c)
        posterior = self.prior_dense(F.silu(x))
        mu = posterior[..., :self.dim_z]
        logvar = torch.clamp(posterior[..., self.dim_z:], self.min_sigma,
                             10.0)
        return mu, logvar

    def forward(self, o: torch.Tensor, eps: torch.Tensor,
                c: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.att1(o, self.ln(eps), c)


class Compressor(nn.Module):
    """The set-VAE. `cfg` is the `model:` config section
    (`configs.compressor_cfg`). Weights are drawn from `generator` with the
    JAX package's initializers; call `init_actnorm` with a batch for the
    data-dependent ActNorm, or load converted weights
    (`ldt_torch.weights.load_compressor`). `ref_merge=True` builds every
    block with the reference's head merge, for weights converted from the
    reference (`ldt_torch.tools.port`)."""

    def __init__(self, cfg, *, dtype=torch.float32, param_dtype=None,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 ref_merge: bool = False):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=dev)
        self.cfg = cfg
        self.input_dense = Dense(cfg.input_dim, cfg.hidden_dim, **kw)
        if cfg.ActNorm is not None and cfg.ActNorm is not False:
            # `ActNorm: True` selects per-token statistics (PARITY #5)
            self.conv_in = ActNorm(
                cfg.hidden_dim, cfg.z_scales,
                feature_type="set" if cfg.ActNorm == "set" else "token",
                device=dev)
        self.group = LocalGrouper(cfg.hidden_dim, normalize=cfg.cluster_norm,
                                  **kw)
        if cfg.pre_group:
            self.pre_grouper = LocalGrouper(
                cfg.hidden_dim, normalize=cfg.cluster_norm, **kw)
        if cfg.pos_embedding == "mlp":
            self.pos_embedding = MLP(3, cfg.p_dim, cfg.p_dim, **kw)
        else:
            self.pos_embedding = MiniPointnet(3, cfg.p_dim, **kw)
        label_dim = cfg.p_dim if cfg.class_condition else None
        if cfg.class_condition:
            self.label_embedding = LabelEmbedding(cfg.num_categorys,
                                                  cfg.p_dim, cfg.p_dim, **kw)
        self.encoder = nn.ModuleList(
            Encoder(cfg.hidden_dim, cfg.p_dim, cfg.num_heads, norm=cfg.norm,
                    mlp_ratio=cfg.mlp_ratio, num_layers=cfg.encoder_layers,
                    AdaLN=cfg.AdaLN, ref_merge=ref_merge,
                    dropout_p=cfg.encoder_dropout_p, **kw)
            for _ in range(cfg.n_layers))
        self.decoder = nn.ModuleList(
            DecoderBlock(cfg.hidden_dim, cfg.z_dim, cfg.num_heads,
                         norm=cfg.norm, mlp_ratio=cfg.mlp_ratio,
                         min_sigma=cfg.min_sigma, act=cfg.decoder_act,
                         c_dim=label_dim, ref_merge=ref_merge,
                         dropout_p=cfg.decoder_dropout_p, **kw)
            for _ in range(cfg.n_layers))
        self.output_dense = Dense(cfg.hidden_dim, 3, **kw)
        self.init_set = InitialSet(cfg.hidden_dim, cfg.max_outputs, device=dev)
        init_weights_(self, generator)
        self.init_set.init_(generator)

    @staticmethod
    def norm_pts(pts: torch.Tensor) -> torch.Tensor:
        """Per-cloud standardization (unbiased std)."""
        mean = pts.mean(dim=1, keepdim=True)
        return (pts - mean) / pts.std(dim=1, keepdim=True)

    def _grouped(self, pts: torch.Tensor, train: bool = False):
        """(centers [B, S, 3], token features [B, S, hidden]) before
        ActNorm: with `pre_group`, a first grouping to 256 groups of 32
        neighbours, then `z_scales` groups of 2 N / z_scales."""
        cfg = self.cfg
        if cfg.norm_input:
            pts = self.norm_pts(pts)
        x = self.input_dense(pts)
        if cfg.pre_group:
            pts, x = self.pre_grouper(pts, x, 256, 32, train)
        n = pts.shape[1]
        return self.group(pts, x, cfg.z_scales, n // cfg.z_scales * 2, train)

    def take_batch_stats(self) -> dict:
        """The running statistics that the train-mode BatchNorms of the
        last forward left ({state_dict key: tensor}); clears them."""
        return take_batch_norm_updates(self)

    def _refuse_train_dropout(self) -> None:
        """A train-mode forward with a nonzero dropout rate raises: the JAX
        package's blocks then ask for a 'dropout' rng that its trainers
        never pass (its train-mode init and steps raise)."""
        cfg = self.cfg
        if cfg.encoder_dropout_p or cfg.decoder_dropout_p:
            raise ValueError(
                f"encoder_dropout_p={cfg.encoder_dropout_p}, "
                f"decoder_dropout_p={cfg.decoder_dropout_p}: the JAX package "
                "cannot train a Compressor with dropout (its train-mode "
                "forward needs a 'dropout' rng that no trainer passes); "
                "only eval and sampling run")

    @torch.no_grad()
    def init_actnorm(self, pts: torch.Tensor, train: bool = False) -> None:
        """Data-dependent ActNorm init from the clouds `pts` [B, N, 3], as
        the JAX module initializes it at `Module.init(..., train=train)`:
        after the grouping's BatchNorms in train mode (the batch's
        statistics; stage-1's init) or not (their running statistics;
        stage-2's). Like flax's init it updates no running statistic. The
        label of a class-conditional Compressor enters after ActNorm (in the
        position embedding), so its statistics need none."""
        if train:
            self._refuse_train_dropout()
        if hasattr(self, "conv_in"):
            self.conv_in.data_init(self._grouped(pts, train)[1])
        self.take_batch_stats()

    def bottom_up(self, pts: torch.Tensor, train: bool = False,
                  label: Optional[torch.Tensor] = None) -> dict:
        """Encode [B, N, 3] -> {'outputs': the n_layers taps [B, S, hidden],
        'max': max of the last stage's tokens}; `label` is a label
        embedding [B, p_dim], added to the position embedding."""
        center, x = self._grouped(pts, train)
        if self.cfg.pos_embedding == "mlp":
            pos = self.pos_embedding(center)
        else:
            pos = self.pos_embedding(center, train)
        if label is not None:
            pos = pos + label
        if hasattr(self, "conv_in"):
            x = self.conv_in(x)
        outputs = []
        for layer in self.encoder:
            x, o = layer(x, pos)
            outputs.append(o)
        return {"outputs": outputs, "max": x.max()}

    def top_down(self, encoder_out: Sequence[torch.Tensor],
                 noise: Optional[Sequence[torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 label: Optional[torch.Tensor] = None,
                 seed_draw: Optional[torch.Tensor] = None) -> dict:
        """Top-down posterior sampling and decoding of `outsize` points,
        conditioned on the label embedding `label` [B, p_dim] if given.
        `noise[idx]` [B, S, z_dim] pins the reparameterization draw of decode
        step idx and `seed_draw` the seed set's (`InitialSet`); else they
        come from `generator`."""
        cfg = self.cfg
        b = encoder_out[0].shape[0]
        seed = self.init_set(b, cfg.outsize, seed_draw, generator)
        o = sp_shard(seed)
        posteriors, all_eps, kls, all_logqz = [(seed, None, None)], [], [], []
        for idx in range(cfg.n_layers):
            layer = self.decoder[cfg.n_layers - 1 - idx]
            mu, logvar = layer.compute_posterior(
                encoder_out[-idx - 1],
                sp_gather(o, cfg.outsize) if idx != 0 else None, label)
            e = noise[idx] if noise is not None else torch.randn(
                mu.shape, dtype=mu.dtype, device=mu.device,
                generator=generator)
            eps = reparameterize(mu, logvar,
                                 e.to(device=mu.device, dtype=mu.dtype))
            logqz = log_p_var_normal(eps, mu, logvar)
            kls.append(logqz - log_p_normal(eps))
            o = layer(o, eps, label)
            all_eps.append(eps)
            posteriors.append((eps, mu, logvar))
            all_logqz.append(logqz)
        return {"set": sp_gather(self.output_dense(o), cfg.outsize),
                "posteriors": posteriors, "kls": kls,
                "all_logqz": all_logqz, "all_eps": all_eps}

    def forward(self, x: torch.Tensor,
                noise: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False, label: Optional[torch.Tensor] = None,
                seed_draw: Optional[torch.Tensor] = None) -> dict:
        """Bidirectional inference on x [B, N, 3], conditioned on the
        category indices `label` [B] when the Compressor is
        class-conditional; 'all_eps' is [B, z_scales, n_layers * z_dim] in
        the JAX package's layout. With `train`, 'batch_stats' holds the
        BatchNorms' updated running statistics ({state_dict key: tensor});
        the buffers do not change. With a nonzero dropout rate `train`
        raises (`_refuse_train_dropout`)."""
        if train:
            self._refuse_train_dropout()
        l_emb = (self.label_embedding(label) if label is not None
                 and self.cfg.class_condition else None)
        bup = self.bottom_up(x, train, l_emb)
        tdn = self.top_down(bup["outputs"], noise, generator, l_emb,
                            seed_draw)
        out = {"set": self.postprocess(tdn["set"]),
               "posteriors": tdn["posteriors"], "kls": tdn["kls"],
               "all_eps": torch.cat(tdn["all_eps"], dim=-1),
               "all_logqz": tdn["all_logqz"], "max": bup["max"]}
        if train:
            # as flax's mutable collection: every statistic, those of the
            # norms that always read theirs (a block's batch norm) as they
            # are
            out["batch_stats"] = {**dict(self.named_buffers()),
                                  **self.take_batch_stats()}
        return out

    def sample(self, shape, given_eps: torch.Tensor,
               seed_draw: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Top-down generation. shape: (B, num_points); given_eps:
        [B, z_scales, n_layers * z_dim]; the seed set's draw as `top_down`.
        No label: a class-conditional decoder runs its unconditioned
        branch, as the JAX package's and the reference's `sample` do.

        The blocks run in reverse: decode step idx uses
        `decoder[n_layers - 1 - idx]` with eps channels
        [idx * z_dim, (idx + 1) * z_dim).
        """
        cfg = self.cfg
        b, num_points = shape[0], shape[1]
        o = sp_shard(self.init_set(b, num_points, seed_draw, generator))
        eps_list = torch.split(given_eps, cfg.z_dim, dim=-1)
        if len(eps_list) != cfg.n_layers or given_eps.shape[-1] % cfg.z_dim:
            raise ValueError(f"given_eps last dim {given_eps.shape[-1]} is not "
                             f"n_layers * z_dim = {cfg.n_layers * cfg.z_dim}")
        for idx in range(cfg.n_layers):
            o = self.decoder[cfg.n_layers - 1 - idx](o, eps_list[idx])
        return self.postprocess(sp_gather(self.output_dense(o), num_points))

    @staticmethod
    def postprocess(x: torch.Tensor) -> torch.Tensor:
        """Dataset-specific output squashing (identity for xyz clouds)."""
        if x.shape[-1] == 2:
            return (torch.tanh(x) + 1) / 2.0
        if x.shape[-1] == 4:
            x = x.clone()
            x[..., -1] = (torch.tanh(x[..., -1]) + 1) / 2.0
        return x
