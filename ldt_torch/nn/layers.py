"""Set-transformer blocks, channels-last [B, N, C], counterpart of
`ldt_tpu/nn/layers.py`.

Numerics follow the flax modules: a `Dense` casts its input to the dtype of
its weight (flax `Dense(dtype=...)`), `LayerNorm` computes in f32 with
epsilon 1e-6 and returns the module dtype, GELU is the tanh approximation
(`jax.nn.gelu`'s default), and residual sums follow PyTorch's type promotion,
which is JAX's for these dtypes (bf16 + f32 -> f32).

Dropout is not ported: `Score` and `Compressor` refuse a nonzero rate, which
the JAX package applies in training (every shipped config sets it to 0).
With grad mode on, self-attention
differentiates through `ops.attention.PackedSelfAttention` (K1 forward, K3
backward) and cross-attention through `ops.attention.CrossAttention` (K2
forward, K4 backward). `BatchNorm` normalizes with its running statistics,
or in train mode with the batch's (flax's semantics).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ldt_torch.ops import attention as attn_ops


class Dense(nn.Linear):
    """`nn.Linear` whose input is cast to the weight's dtype.

    Its default initialization, U(+-1/sqrt(fan_in)) for weight and bias, is
    the one `ldt_tpu`'s `Dense` copies from torch.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(epsilon=1e-6)`: statistics and affine in f32, the
    result in `dtype`; scale and bias only when `affine`."""

    def __init__(self, features: int, affine: bool, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.features = features
        self.dtype = dtype
        if affine:
            self.weight = nn.Parameter(
                torch.ones(features, dtype=torch.float32, device=device))
            self.bias = nn.Parameter(
                torch.zeros(features, dtype=torch.float32, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (self.features,), self.weight, self.bias,
                         eps=1e-6)
        return y.to(self.dtype)


def init_weights_(module: nn.Module,
                  generator: Optional[torch.Generator] = None) -> nn.Module:
    """Draw the Dense and LayerNorm parameters of `module` as the JAX
    package initializes them: Dense weight and bias U(+-1/sqrt(fan_in)),
    LayerNorm scale 1 and bias 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Dense):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, LayerNorm) and m.weight is not None:
                m.weight.fill_(1.0)
                m.bias.zero_()
    return module


class ActNorm(nn.Module):
    """Activation normalization `(x - shift) * exp(-log_scale)` over the
    feature (last) axis (`ldt_tpu/nn/layers.py::ActNorm`).

    `feature_type` "set" keeps one [1, 1, F] shift and log-scale; anything
    else (the shipped `ActNorm: True`, PARITY #5) keeps per-token [1, S, F]
    ones. `data_init(x)` sets them from a batch's statistics, as the JAX
    module's initializers do at `Module.init`: the mean, and log(std + eps)
    with the unbiased std, in f32, over the batch (and the tokens for
    "set").
    """

    def __init__(self, num_features: int, z_scale: int = 1,
                 eps: float = 1e-6, feature_type: str = "set", *,
                 device=None):
        super().__init__()
        self.feature_type = feature_type
        self.eps = eps
        shape = ((1, 1, num_features) if feature_type == "set"
                 else (1, z_scale, num_features))
        kw = dict(dtype=torch.float32, device=device)
        self.shift = nn.Parameter(torch.zeros(shape, **kw))
        self.log_scale = nn.Parameter(torch.zeros(shape, **kw))

    @torch.no_grad()
    def data_init(self, x: torch.Tensor) -> None:
        dims = (0, 1) if self.feature_type == "set" else (0,)
        x = x.float()
        self.shift.copy_(x.mean(dim=dims, keepdim=True))
        self.log_scale.copy_(torch.log(x.std(dim=dims, keepdim=True)
                                       + self.eps))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.shift) * torch.exp(-self.log_scale)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9)` over the last axis:
    (x - mean) * (rsqrt(var + eps) * scale) + bias in f32 (eps 1e-5), the
    result in `dtype`.

    `forward(x)` takes the running statistics (flax `batch_stats` mean and
    var; `use_running_average=True`). `forward(x, train=True)` takes the
    batch's, as flax 0.12's `_compute_stats`: in f32 over every axis but the
    last, var = max(E[x^2] - E[x]^2, 0), the biased variance, with the
    gradient through both. It leaves the updated running statistics
    0.9 * running + 0.1 * batch (detached) in `self.update` for the caller
    to collect (`Compressor.forward(train=True)` returns them, as flax's
    `mutable=["batch_stats"]`); the buffers themselves do not change. Not
    `F.batch_norm(training=True)`: its running variance is the unbiased one
    and its momentum weighs the batch, not the running value.
    """

    momentum = 0.9

    def __init__(self, features: int, eps: float = 1e-5, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, **kw))
        self.bias = nn.Parameter(torch.zeros(features, **kw))
        self.register_buffer("running_mean", torch.zeros(features, **kw))
        self.register_buffer("running_var", torch.ones(features, **kw))
        self.update = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        if train:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dim=dims)
            var = torch.clamp(torch.square(x).mean(dim=dims)
                              - torch.square(mean), min=0.0)
            m = self.momentum
            self.update = {
                "running_mean": (m * self.running_mean
                                 + (1 - m) * mean).detach(),
                "running_var": (m * self.running_var
                                + (1 - m) * var).detach()}
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * mul + self.bias).to(self.dtype)


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor],
                                                    torch.Tensor]:
    """Activation registry (`ldt_tpu/nn/layers.py::get_activation`)."""
    if name is None:
        return lambda x: x
    table = {
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "selu": F.selu,
        "silu": F.silu,
        "swish": F.silu,
        "hardswish": F.hardswish,
        "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
        "leakyrelu0.2": lambda x: F.leaky_relu(x, 0.2),
        "relu": F.relu,
    }
    name = name.lower()
    if name not in table:
        raise NotImplementedError(f"activation not supported: {name}")
    return table[name]


def make_norm(norm: Optional[str], features: int, affine: bool = False, *,
              dtype=torch.float32, device=None) -> nn.Module:
    """Norm registry over the channel (last) axis; None is the identity."""
    if norm is None:
        return nn.Identity()
    norm = norm.lower()
    if norm == "layer_norm":
        return LayerNorm(features, affine, dtype=dtype, device=device)
    if norm in ("group_norm", "batch_norm"):
        raise NotImplementedError(f"{norm} is not ported yet")
    raise TypeError(f"norm not supported: {norm}")


def sinusoidal_embedding(ts: torch.Tensor, dim: int,
                         max_period: float = 10000.0) -> torch.Tensor:
    """[B] times -> [B, dim] = [sin | cos], in f32."""
    if dim % 2:
        raise ValueError(f"embedding width {dim} must be even")
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=ts.device)
        * (-math.log(max_period) / (half - 1)))
    args = ts.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """AdaLN modulation."""
    return x * (1 + scale) + shift


class TimeEmbedding(nn.Module):
    """Sinusoidal time embedding + 2-layer SiLU MLP."""

    def __init__(self, dim_embed: int, dim_out: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dim_embed = dim_embed
        self.dtype = dtype
        self.dense_0 = Dense(dim_embed, dim_out, dtype=dtype, device=device)
        self.dense_1 = Dense(dim_out, dim_out, dtype=dtype, device=device)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        h = sinusoidal_embedding(t, self.dim_embed).to(self.dtype)
        return self.dense_1(F.silu(self.dense_0(h)))


class MLP(nn.Module):
    """One hidden layer: dense_1(gelu(dense_0(x))), GELU the tanh form."""

    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.act = get_activation("gelu")
        self.dense_0 = Dense(dim_in, dim_hidden, dtype=dtype, device=device)
        self.dense_1 = Dense(dim_hidden, dim_out, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_1(self.act(self.dense_0(x)))


class Attention(nn.Module):
    """Multi-head attention with Q from x and K, V from y.

    The q, k and v projections are one packed [3D, D] weight `qkv` (the
    flax `fc_q` and `fc_kv` kernels stacked). Self-attention (`y is None`)
    runs the packed GEMM and hands its [B, N, 3D] output to kernel K1; cross-
    attention projects q from x and k, v from y with row slices of the same
    weight and runs kernel K2. With grad mode on they go through the
    autograd.Functions whose backwards are K3 and K4.
    """

    def __init__(self, dim: int, num_heads: int, *, ref_merge: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        if ref_merge:
            raise NotImplementedError(
                "ref_merge (the reference's token-scrambling head merge) is "
                "not ported yet")
        if dim % num_heads:
            raise ValueError(f"width {dim} not divisible by {num_heads} heads")
        self.dim = dim
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.fc_o = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        d = self.dim
        if y is None:
            qkv = self.qkv(x)
            if torch.is_grad_enabled():
                att = attn_ops.PackedSelfAttention.apply(qkv, self.num_heads)
            else:
                att = attn_ops.packed_self_attention(qkv, self.num_heads)
        else:
            w, b = self.qkv.weight, self.qkv.bias
            q = F.linear(x.to(w.dtype), w[:d], b[:d])
            y = y.to(w.dtype)
            k = F.linear(y, w[d:2 * d], b[d:2 * d])
            v = F.linear(y, w[2 * d:], b[2 * d:])
            if torch.is_grad_enabled():
                att = attn_ops.CrossAttention.apply(q, k, v, self.num_heads)
            else:
                att = attn_ops.cross_attention(q, k, v, self.num_heads)
        return self.fc_o(att)


class ResidualBlock(nn.Module):
    """Set-transformer block (`ldt_tpu/nn/layers.py::ResidualBlock`).

    forward(x [B,N,C], y [B,M,C] or None, c [B,Dc] or None, *, mods):
      * AdaLN (`c` or precomputed `mods` [6C]):
            q = modulate(norm1(x)); x = x + gate_msa * Attn(q, y or q)
            x = x + gate_mlp * MLP(modulate(norm2(x)))
      * unconditional: q = act(norm1(x)); x = x + Attn(q, y or q)
            x = x + MLP(act(norm2(x)))
    With y None the block self-attends over the modulated normed x, through
    the packed path (kernel K1); with y given it cross-attends (kernel K2).
    Norms carry scale and bias only when unconditioned (`dim_c` None).
    """

    def __init__(self, dim: int, dim_c: Optional[int] = None,
                 num_heads: int = 4, norm: Optional[str] = "layer_norm",
                 mlp_ratio: float = 4.0, act: Optional[str] = None, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        affine = dim_c is None
        kw = dict(dtype=dtype, device=device)
        self.norm1 = make_norm(norm, dim, affine, **kw)
        self.norm2 = make_norm(norm, dim, affine, **kw)
        self.act = get_activation(act)
        self.attn = Attention(dim, num_heads, **kw)
        self.mlp = MLP(dim, int(mlp_ratio * dim), dim, **kw)
        if dim_c is not None:
            self.adaLN = Dense(dim_c, 6 * dim, **kw)

    def compute_mods(self, c: torch.Tensor) -> torch.Tensor:
        """The AdaLN head alone: [..., Dc] -> [..., 6C] (hoisted out of the
        sampler loop by `Score.precompute_mods`)."""
        return self.adaLN(F.silu(c))

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                c: Optional[torch.Tensor] = None, *,
                mods: Optional[torch.Tensor] = None) -> torch.Tensor:
        if c is not None or mods is not None:
            if mods is None:
                if c.dim() == 2:
                    c = c[:, None, :]
                mods = self.compute_mods(c)
            while mods.dim() < 3:
                mods = mods[None]
            (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
             gate_mlp) = mods.chunk(6, dim=-1)
            q = modulate(self.norm1(x), shift_msa, scale_msa)
            x = x + gate_msa * self.attn(q, y)
            x = x + gate_mlp * self.mlp(
                modulate(self.norm2(x), shift_mlp, scale_mlp))
        else:
            q = self.act(self.norm1(x))
            x = x + self.attn(q, y)
            x = x + self.mlp(self.act(self.norm2(x)))
        return x


class FinalLayer(nn.Module):
    """AdaLN output head (`ldt_tpu/nn/layers.py::FinalLayer` with dim_c)."""

    def __init__(self, dim_in: int, dim_out: int, dim_c: int,
                 norm: Optional[str] = "layer_norm", *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm = make_norm(norm, dim_in, **kw)
        self.adaLN = Dense(dim_c, 2 * dim_in, **kw)
        self.ln = Dense(dim_in, dim_out, **kw)

    def compute_mods(self, c: torch.Tensor) -> torch.Tensor:
        return self.adaLN(F.silu(c))

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None, *,
                mods: Optional[torch.Tensor] = None) -> torch.Tensor:
        """AdaLN from the conditioning `c` [B, Dc] or precomputed `mods`."""
        if mods is None:
            mods = self.compute_mods(c[:, None, :] if c.dim() == 2 else c)
        while mods.dim() < 3:
            mods = mods[None]
        shift, scale = mods.chunk(2, dim=-1)
        return self.ln(modulate(self.norm(x), shift, scale))
