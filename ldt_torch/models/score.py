"""Latent DiT denoiser ("Score" net) and its multimodal ConditionNet,
counterpart of `ldt_tpu/models/score.py`.

The Score projects the [B, z_scale, z_dim] latent to `hidden_size`, runs
`num_blocks` set-transformer blocks conditioned on c = the time embedding
(+ the label embedding, with `num_categorys` > 1 and a label, or + the
image embedding of a condition), AdaLN blocks or with `AdaLN: False` blocks
that add a projection of c to their normed input, and maps back to `z_dim`
with an AdaLN head. `ref_merge=True` builds the blocks with the
reference's head merge (`nn.layers.ref_merge`), for weights converted from
the reference (`ldt_torch.tools.port`).

`condition: True` (ViPC completion) adds a `ConditionNet`: a partial cloud
becomes `z_scale` condition tokens, to which the even blocks cross-attend
(kernel K2 at 32 x 32, dh 64 at the flagship width), and a view image a
global embedding added to c. `unet: True` runs `num_blocks // 2` up blocks,
a mid block and as many down blocks, each down block on the concatenation
of its input and the matching up block's output (width 2 hidden -> hidden);
with a condition every block cross-attends to its tokens.

`dtype` is the compute dtype and `param_dtype` (default: `dtype`) the
weights' (f32 weights and bf16 compute: the JAX package's mixed-precision
training); the norms' parameters and BatchNorm statistics stay f32. Every
block drops out at `score.dropout` after its attention and in its MLP, in a
train-mode forward given `DropoutMasks` (flax's `nn.Dropout`); a forward
without them is deterministic.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ldt_torch import resolve_device
from ldt_torch.models.compressor import LocalGrouper
from ldt_torch.nn.layers import (
    BatchNorm,
    Conv2d,
    Dense,
    DropoutMasks,
    FinalLayer,
    LabelEmbedding,
    ResidualBlock,
    TimeEmbedding,
    init_weights_,
    take_batch_norm_updates,
)


class BasicBlock(nn.Module):
    """ResNet-18 basic block on channels-last [B, H, W, C] (torchvision's
    semantics): conv3x3(stride) -> BN -> ReLU -> conv3x3 -> BN, plus the
    input (through a 1 x 1 conv at the stride and a BN where the stride or
    the width changes), then ReLU. The BatchNorms are flax's (momentum 0.9,
    the biased batch variance), `train` their batch statistics."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, *,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.conv1 = Conv2d(in_channels, features, 3, stride, 1, **kw)
        self.bn1 = BatchNorm(features, **kw)
        self.conv2 = Conv2d(features, features, 3, 1, 1, **kw)
        self.bn2 = BatchNorm(features, **kw)
        if stride != 1 or in_channels != features:
            self.downsample_conv = Conv2d(in_channels, features, 1, stride,
                                          0, **kw)
            self.downsample_bn = BatchNorm(features, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x), train))
        h = self.bn2(self.conv2(h), train)
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(h + residual)


class ResNet18Trunk(nn.Module):
    """The first six children of torchvision's resnet18 (conv1, bn1, relu,
    maxpool, layer1, layer2) on channels-last images [B, H, W, 3] ->
    [B, H/8, W/8, 128]; the max pool pads with -inf. `runs` counts its
    forwards (a sampler encodes its condition once per run)."""

    def __init__(self, *, dtype=torch.float32, param_dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.runs = 0
        self.conv1 = Conv2d(3, 64, 7, 2, 3, **kw)
        self.bn1 = BatchNorm(64, **kw)
        self.layer1_0 = BasicBlock(64, 64, **kw)
        self.layer1_1 = BasicBlock(64, 64, **kw)
        self.layer2_0 = BasicBlock(64, 128, 2, **kw)
        self.layer2_1 = BasicBlock(128, 128, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        self.runs += 1
        h = F.relu(self.bn1(self.conv1(x), train))
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for layer in (self.layer1_0, self.layer1_1, self.layer2_0,
                      self.layer2_1):
            h = layer(h, train)
        return h


class ConditionNet(nn.Module):
    """The partial-cloud and view-image encoder. forward({'img': [B, H, W,
    3], 'pts': [B, N, 3]}, train) -> (tokens [B, patch_size, hidden] or
    None, image embedding [B, p_dim] or 0.0); either key may be absent or
    None.

    Image: the ResNet-18 trunk, the max over its spatial grid, `ln`. Points:
    `pc_conv_in` to 128 channels, the Compressor's `LocalGrouper` (FPS to
    `patch_size` centers, normalized by the group mean) and `pc_conv_out`.
    Its neighbour count is the reference's `x.shape[1] // patch_size * 2`
    read on a channels-first tensor: 128 // patch_size * 2 (k = 8 at the
    shipped patch 32), whatever the point count (PARITY #11)."""

    def __init__(self, hidden_size: int, p_dim: int, patch_size: int = 16,
                 *, dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.patch_size = patch_size
        self.resnet = ResNet18Trunk(**kw)
        self.ln = Dense(128, p_dim, **kw)
        self.pc_conv_in = Dense(3, 128, **kw)
        self.group = LocalGrouper(128, normalize="center", **kw)
        self.pc_conv_out = Dense(128, hidden_size, **kw)

    def forward(self, condition: dict, train: bool = False):
        tokens, img_emb = None, 0.0
        if condition.get("img") is not None:
            h = self.resnet(condition["img"], train)
            img_emb = self.ln(h.amax(dim=(1, 2)))
        if condition.get("pts") is not None:
            pts = condition["pts"].to(self.pc_conv_in.weight.dtype)
            x = self.pc_conv_in(pts)
            _, x = self.group(pts, x, self.patch_size,
                              128 // self.patch_size * 2, train)
            tokens = self.pc_conv_out(x)
        return tokens, img_emb


class Score(nn.Module):
    """Latent DiT. `cfg` is the `score:` config section (`configs.score_cfg`).

    Weights are drawn from `generator` with the JAX package's initializers;
    load trained ones with `ldt_torch.weights.load_score`. A conditional
    Score holds BatchNorm running statistics (its ConditionNet's trunk and
    grouper) as buffers; `forward(..., train=True)` normalizes them with
    the batch's and leaves the updated statistics for `take_batch_stats`.
    """

    def __init__(self, cfg, *, dtype=torch.float32, param_dtype=None,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 ref_merge: bool = False):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=dev)
        self.cfg = cfg
        block = dict(dim_c=cfg.t_dim, num_heads=cfg.num_heads, norm=cfg.norm,
                     act=cfg.act, AdaLN=cfg.AdaLN, ref_merge=ref_merge,
                     dropout_att=cfg.dropout, dropout_mlp=cfg.dropout, **kw)
        h = cfg.hidden_size
        self.ln_in = Dense(cfg.z_dim, h, **kw)
        if cfg.unet:
            half = cfg.num_blocks // 2
            self.transformer_up = nn.ModuleList(
                ResidualBlock(h, **block) for _ in range(half))
            self.transformer_mid = ResidualBlock(h, **block)
            # a down block's queries are 2 hidden wide, the condition
            # tokens hidden
            self.transformer_down = nn.ModuleList(
                ResidualBlock(2 * h, dim_out=h,
                              dim_kv=h if cfg.condition else None, **block)
                for _ in range(half))
        else:
            self.transformer = nn.ModuleList(
                ResidualBlock(h, **block) for _ in range(cfg.num_blocks))
        self.time_embedding = TimeEmbedding(cfg.t_dim // 4, cfg.t_dim, **kw)
        self.ln_out = FinalLayer(h, cfg.z_dim, dim_c=cfg.t_dim,
                                 norm=cfg.norm, **kw)
        if cfg.num_categorys > 1:
            self.label_embedding = LabelEmbedding(
                cfg.num_categorys, cfg.t_dim, cfg.t_dim, **kw)
        if cfg.condition:
            self.c_net = ConditionNet(h, cfg.t_dim, patch_size=cfg.z_scale,
                                      **kw)
        init_weights_(self, generator)

    def precompute_mods(self, t: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every AdaLN modulation for a vector of times `t` [S]:
        {'blocks': [S, num_blocks, 6*hidden], 'final': [S, 2*hidden]}.

        The conditioning depends on t alone (no label, no image), so a
        fixed sampling schedule's time embeddings and AdaLN heads are
        computed once, outside the reverse-diffusion loop. AdaLN blocks of
        the plain (non-UNet) Score only.
        """
        if not self.cfg.AdaLN or self.cfg.unet:
            raise ValueError("precompute_mods needs the AdaLN, non-UNet "
                             "Score: the others run whole each step")
        c = self.time_embedding(t)
        blocks = torch.stack([blk.compute_mods(c) for blk in self.transformer],
                             dim=1)
        return {"blocks": blocks, "final": self.ln_out.compute_mods(c)}

    def embed_times(self, t: torch.Tensor) -> torch.Tensor:
        """The time embedding alone for a vector of times `t` [S] ->
        [S, t_dim]: a schedule's, computable once where c also holds a
        per-sample image embedding."""
        return self.time_embedding(t)

    def denoise_with_mods(self, x: torch.Tensor,
                          mods: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One denoise step with one step's modulations:
        mods = {'blocks': [num_blocks, 6*hidden], 'final': [2*hidden]}."""
        h = self.ln_in(x)
        for i, layer in enumerate(self.transformer):
            h = layer(h, mods=mods["blocks"][i])
        return self.ln_out(h, mods=mods["final"])

    def encode_condition(self, condition: dict, train: bool = False):
        """Encode a {'img', 'pts'} condition once: (tokens or None, image
        embedding or 0.0), which `forward` takes in its place (a sampler
        encodes once per run, not once per step)."""
        if not hasattr(self, "c_net"):
            raise ValueError("a condition needs score.condition: True")
        return self.c_net(condition, train)

    def take_batch_stats(self) -> dict:
        """Every running statistic ({state_dict key: tensor}) after a
        train-mode forward: those it updated at their new values (cleared
        here), the rest as they are; flax's `mutable=["batch_stats"]`."""
        return {**dict(self.named_buffers()),
                **take_batch_norm_updates(self)}

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                label: Optional[torch.Tensor] = None, condition=None,
                train: bool = False,
                dropout: Optional[DropoutMasks] = None) -> torch.Tensor:
        """x [B, z_scale, z_dim], t [B], label [B] category indices (or
        None), `condition` a {'img', 'pts'} dict or the pair
        `encode_condition` gives (or None) -> the predicted noise, x's
        shape. `train` runs the ConditionNet's BatchNorms on the batch's
        statistics and the blocks' dropout on the masks `dropout`; a
        train-mode forward with a nonzero `score.dropout` and no masks
        raises, as the JAX package's apply without a 'dropout' rng."""
        masks = None
        if train and self.cfg.dropout:
            if dropout is None:
                raise ValueError(
                    f"score.dropout={self.cfg.dropout}: a train-mode "
                    "forward needs its dropout masks (the JAX package "
                    "raises without a 'dropout' rng)")
            masks = dropout
        c = self.time_embedding(t)
        if label is not None:
            if not hasattr(self, "label_embedding"):
                raise ValueError("a label needs score.num_categorys > 1")
            c = c + self.label_embedding(label)
        tokens = None
        if condition is not None:
            if isinstance(condition, dict):
                condition = self.encode_condition(condition, train)
            tokens, img_emb = condition
            if label is None:  # the JAX package adds one or the other
                c = c + img_emb
        h = self.ln_in(x)
        if self.cfg.unet:
            skips = [h]
            for layer in self.transformer_up:
                h = layer(h, tokens, c, masks=masks)
                skips.append(h)
            h = self.transformer_mid(h, tokens, c, masks=masks)
            for layer in self.transformer_down:
                h = layer(torch.cat([h, skips.pop()], dim=-1), tokens, c,
                          masks=masks)
        else:
            for idx, layer in enumerate(self.transformer):
                h = layer(h, tokens if idx % 2 == 0 else None, c,
                          masks=masks)
        return self.ln_out(h, c)
