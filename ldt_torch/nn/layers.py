"""Set-transformer blocks, channels-last [B, N, C], counterpart of
`ldt_tpu/nn/layers.py`.

Numerics follow the flax modules. Each module takes a compute `dtype` and
a `param_dtype` for its weights (default: `dtype`), as flax's `dtype` and
`param_dtype`: f32 weights with bf16 compute are the JAX package's mixed
precision (`common.train_dtype: bfloat16`), bf16 weights with bf16 compute
its bf16 serving. A `Dense` casts its input, weight and bias to the compute
dtype (flax's `promote_dtype`); `LayerNorm`, `GroupNorm` and `BatchNorm`
keep f32 parameters and statistics and return the compute dtype; GELU is
the tanh approximation (`jax.nn.gelu`'s default), and residual sums follow
PyTorch's type promotion, which is JAX's for these dtypes (bf16 + f32 ->
f32). A bf16 `Dense` with bf16 weights (serving) rounds once after its
bias, flax twice (the dot, then the sum): a bf16 ulp apart at most; with
f32 weights (mixed precision) it rounds as flax.

Dropout sits where flax's `nn.Dropout` does: after the MLP's hidden
activation and after the attention's `fc_o`, at the rates `dropout_mlp` and
`dropout_att`. It computes flax's formula, where(keep, x / keep_prob, 0),
with the keep masks from a `DropoutMasks` (drawn from a `torch.Generator`,
or pinned in call order); without one a forward is deterministic and
dropout the identity.
With grad mode on, self-attention
differentiates through `ops.attention.PackedSelfAttention` (K1 forward, K3
backward) and cross-attention through `ops.attention.CrossAttention` (K2
forward, K4 backward). `BatchNorm` normalizes with its running statistics,
or in train mode with the batch's (flax's semantics).

`Attention(ref_merge=True)` reproduces the reference's head merge, a reshape
of the [B, H, N, dh] output to [B, N, D] without the transpose (a fixed
scramble of tokens into channels), which the reference's released weights
were trained under. The JAX package computes it outside its Pallas core;
here the kernels still run (K1/K2 forward, K3/K4 backward) and the scramble
is a permutation of their standard-merge output, which autograd carries
back.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ldt_torch.ops import attention as attn_ops


def _as(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    """`t` in `dtype` (itself where it is already: no copy)."""
    return t if t is None or t.dtype == dtype else t.to(dtype)


class Dense(nn.Linear):
    """`nn.Linear` that computes in `dtype`: its input, weight and bias are
    cast to it; the weight and bias are stored in `param_dtype` (default:
    `dtype`). Stored in another dtype than it computes in (mixed
    precision), it rounds as flax's `Dense`: the product, then the sum with
    the bias; stored in its compute dtype (bf16 serving) it adds the bias
    inside the GEMM, one rounding, which keeps the generation's launches.

    Its default initialization, U(+-1/sqrt(fan_in)) for weight and bias, is
    the one `ldt_tpu`'s `Dense` copies from torch.
    """

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, dtype=torch.float32, param_dtype=None,
                 device=None):
        super().__init__(in_features, out_features, bias, device=device,
                         dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def cast_params(self):
        """(weight, bias) in the compute dtype."""
        return (_as(self.weight, self.compute_dtype),
                _as(self.bias, self.compute_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _as(x, self.compute_dtype)
        w, b = self.cast_params()
        if b is None or self.weight.dtype == self.compute_dtype:
            return F.linear(x, w, b)
        return F.linear(x, w) + b


class DropoutMasks:
    """The keep masks of one training forward's dropouts: drawn from
    `generator` (keep = U[0, 1) < keep_prob, on the input's device), or
    pinned, taken from `masks` in call order (another framework's draws).
    With `record` every mask is kept in `drawn`, in call order."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 masks=None, record: bool = False):
        self.generator = generator
        self.pinned = None if masks is None else iter(masks)
        self.record = record
        self.drawn = []

    def keep(self, shape, keep_prob: float, device) -> torch.Tensor:
        if self.pinned is not None:
            mask = next(self.pinned, None)
            if mask is None:
                raise ValueError("the pinned dropout masks ran out")
            mask = torch.as_tensor(mask).to(device=device, dtype=torch.bool)
            if tuple(mask.shape) != tuple(shape):
                raise ValueError(f"pinned dropout mask {tuple(mask.shape)} "
                                 f"for an input {tuple(shape)}")
        else:
            mask = torch.rand(shape, generator=self.generator,
                              device=device) < keep_prob
        if self.record:
            self.drawn.append(mask)
        return mask


def dropout(x: torch.Tensor, rate: float,
            masks: Optional[DropoutMasks]) -> torch.Tensor:
    """flax `nn.Dropout(rate)`: the identity at rate 0 or without `masks`
    (deterministic), zeros at rate 1, else where(keep, x / keep_prob, 0),
    the division correctly rounded in x's dtype (`true_divide`)."""
    if not rate or masks is None:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = masks.keep(x.shape, keep_prob, x.device)
    return torch.where(keep, attn_ops.true_divide(x, keep_prob),
                       x.new_zeros(()))


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(epsilon=1e-6)`: statistics and affine in f32, the
    result in `dtype`; scale and bias only when `affine`."""

    def __init__(self, features: int, affine: bool, *, dtype=torch.float32,
                 param_dtype=None, device=None):
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
    """Draw the Dense, Conv2d, Embedding and LayerNorm parameters of
    `module` as the JAX package initializes them: Dense weight and bias
    U(+-1/sqrt(fan_in)), a convolution's kernel flax's lecun_normal (a
    normal truncated at 2 sigma, of variance 1 / fan_in), an embedding
    table N(0, 1), LayerNorm scale 1 and bias 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv2d):
                fan_in = m.weight[0].numel()
                # 0.8796...: the std of a unit normal truncated at +-2
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                m.weight.mul_(std)
            elif isinstance(m, Dense):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=generator)
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
                 dtype=torch.float32, param_dtype=None, device=None):
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


def take_batch_norm_updates(module: nn.Module) -> dict:
    """The running statistics that the train-mode BatchNorms of `module`'s
    last forward left ({state_dict key: tensor}); clears them."""
    out = {}
    for name, m in module.named_modules():
        if isinstance(m, BatchNorm) and m.update is not None:
            out.update({f"{name}.{k}": t for k, t in m.update.items()})
            m.update = None
    return out


def ieee_cudnn():
    """A scope in which cuDNN runs f32 convolutions at IEEE precision (no
    TF32: `torch.backends.cudnn.allow_tf32` is True by default), its other
    flags as they are; the global setting is restored on exit."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   benchmark_limit=None, deterministic=c.deterministic,
                   allow_tf32=False)


class _Conv2dIEEE(torch.autograd.Function):
    """F.conv2d (no bias) whose forward and backward both run inside
    `ieee_cudnn`: the backward runs later, outside any scope of the
    caller's."""

    @staticmethod
    def forward(ctx, x, w, stride: int, padding: int):
        ctx.save_for_backward(x, w)
        ctx.geometry = (stride, padding)
        with ieee_cudnn():
            return F.conv2d(x, w, None, stride, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding = ctx.geometry
        with ieee_cudnn():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [stride] * 2, [padding] * 2, [1, 1], False,
                [0, 0], 1, [ctx.needs_input_grad[0],
                            ctx.needs_input_grad[1], False])
        return gx, gw, None, None


class Conv2d(nn.Module):
    """flax `nn.Conv(features, (k, k), strides=stride, padding=padding,
    use_bias=False)` on channels-last [B, H, W, C_in] -> [B, H', W',
    C_out]. The weight is OIHW [C_out, C_in, k, k] (flax's HWIO kernel
    transposed), stored in `param_dtype` (default: `dtype`); the input and
    the weight are cast to `dtype`. cuDNN runs an f32 convolution at IEEE
    f32 (`ieee_cudnn`), forward and backward. A 1 x 1 kernel at stride 2
    with flax's 'SAME' padding pads nothing, so `padding` is always
    symmetric."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, padding: int = 0, *, dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel, kernel,
            dtype=param_dtype or dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = _as(x, cd).permute(0, 3, 1, 2)  # a channels-last view
        y = _Conv2dIEEE.apply(x, _as(self.weight, cd), self.stride,
                              self.padding)
        return y.permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm(num_groups, epsilon=1e-6)` on [B, ..., C]: each
    batch element's statistics over every middle axis (the tokens) and the
    channels of each group, in f32 with var = max(E[x^2] - E[x]^2, 0), then
    scale and bias; the result in `dtype`. Not `torch.nn.GroupNorm`, whose
    layout is channels-first."""

    def __init__(self, features: int, num_groups: int, eps: float = 1e-6, *,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        if features % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {features} "
                             "channels")
        kw = dict(dtype=torch.float32, device=device)
        self.features = features
        self.num_groups = num_groups
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, **kw))
        self.bias = nn.Parameter(torch.zeros(features, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        b, g = x.shape[0], self.num_groups
        size = self.features // g
        grouped = x.reshape(b, -1, g, size)
        mean = grouped.mean(dim=(1, 3))
        var = torch.clamp(torch.square(grouped).mean(dim=(1, 3))
                          - torch.square(mean), min=0.0)
        shape = (b,) + (1,) * (x.dim() - 2) + (self.features,)
        mean = mean.repeat_interleave(size, dim=-1).reshape(shape)
        var = var.repeat_interleave(size, dim=-1).reshape(shape)
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
              dtype=torch.float32, param_dtype=None,
              device=None) -> nn.Module:
    """Norm registry over the channel (last) axis; None is the identity.
    The norms return `dtype`; their parameters are f32 whatever
    `param_dtype` (flax's norms under mixed precision hold theirs in f32).

    `affine` reaches the layer norm alone: as in the JAX package, the group
    norm (min(features // 4, 16) groups) and the batch norm always carry a
    scale and a bias, and the batch norm always normalizes with its running
    statistics (flax `use_running_average=True`), in training too."""
    if norm is None:
        return nn.Identity()
    norm = norm.lower()
    kw = dict(dtype=dtype, device=device)
    if norm == "layer_norm":
        return LayerNorm(features, affine, **kw)
    if norm == "group_norm":
        return GroupNorm(features, min(features // 4, 16), **kw)
    if norm == "batch_norm":
        return BatchNorm(features, **kw)
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
                 param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.dim_embed = dim_embed
        self.dtype = dtype
        self.dense_0 = Dense(dim_embed, dim_out, **kw)
        self.dense_1 = Dense(dim_out, dim_out, **kw)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        h = sinusoidal_embedding(t, self.dim_embed).to(self.dtype)
        return self.dense_1(F.silu(self.dense_0(h)))


class LabelEmbedding(nn.Module):
    """Category embedding (a N(0, 1) table in `param_dtype`, its rows taken
    in `dtype`, as flax's `Embed`) + 2-layer SiLU MLP."""

    def __init__(self, num_categories: int, dim_embed: int, dim_out: int, *,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.dtype = dtype
        self.embed = nn.Embedding(num_categories, dim_embed,
                                  dtype=param_dtype or dtype, device=device)
        self.dense_0 = Dense(dim_embed, dim_out, **kw)
        self.dense_1 = Dense(dim_out, dim_out, **kw)

    def forward(self, label: torch.Tensor) -> torch.Tensor:
        h = _as(self.embed(label.to(self.embed.weight.device, torch.long)),
                self.dtype)
        return self.dense_1(F.silu(self.dense_0(h)))


class MLP(nn.Module):
    """One hidden layer: dense_1(dropout(gelu(dense_0(x)))), GELU the tanh
    form, dropout at `dropout_p` (`dropout`)."""

    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int, *,
                 dropout_p: float = 0.0, dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.act = get_activation("gelu")
        self.dropout_p = dropout_p
        self.dense_0 = Dense(dim_in, dim_hidden, **kw)
        self.dense_1 = Dense(dim_hidden, dim_out, **kw)

    def forward(self, x: torch.Tensor,
                masks: Optional[DropoutMasks] = None) -> torch.Tensor:
        h = dropout(self.act(self.dense_0(x)), self.dropout_p, masks)
        return self.dense_1(h)


def ref_merge(att: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The reference's head merge of a standard-merge output [B, N, D]
    (token n, head h at channels [h dh, (h + 1) dh)): the [B, H, N, dh]
    tensor reshaped to [B, N, D] without the transpose."""
    b, n, d = att.shape
    return (att.reshape(b, n, num_heads, d // num_heads).transpose(1, 2)
            .reshape(b, n, d))


class Attention(nn.Module):
    """Multi-head attention with Q from x and K, V from y.

    The q, k and v projections are one packed [3 D_out, D_in] weight `qkv`
    (the flax `fc_q` and `fc_kv` kernels stacked). Self-attention (`y is
    None`) runs the packed GEMM and hands its [B, N, 3 D_out] output to
    kernel K1; cross-attention projects q from x and k, v from y with row
    slices of the same weight and runs kernel K2. With grad mode on they go
    through the autograd.Functions whose backwards are K3 and K4.
    `ref_merge` merges the heads as the reference does (`ref_merge`).
    Dropout at `dropout_p` follows `fc_o` (`dropout`).

    Keys and values of another width than the queries' (`dim_kv` !=
    `dim`: a UNet down block, D_in = 2 hidden, cross-attending to condition
    tokens of width hidden) take two weights instead, `q` [D_out, D_in] and
    `kv` [2 D_out, dim_kv] (`fc_q` and `fc_kv` as they are); such a block
    only cross-attends.
    """

    def __init__(self, dim: int, num_heads: int, *,
                 dim_out: Optional[int] = None, dim_kv: Optional[int] = None,
                 ref_merge: bool = False, dropout_p: float = 0.0,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        dim_out = dim if dim_out is None else dim_out
        if dim_out % num_heads:
            raise ValueError(f"width {dim_out} not divisible by {num_heads} "
                             "heads")
        self.dim = dim_out
        self.num_heads = num_heads
        self.ref_merge = ref_merge
        self.dropout_p = dropout_p
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        if dim_kv is None or dim_kv == dim:
            self.qkv = Dense(dim, 3 * dim_out, **kw)
        else:
            self.q = Dense(dim, dim_out, **kw)
            self.kv = Dense(dim_kv, 2 * dim_out, **kw)
        self.fc_o = Dense(dim_out, dim_out, **kw)

    def _cross(self, x: torch.Tensor, y: torch.Tensor):
        """(q, k, v) of a cross-attention."""
        d = self.dim
        y = _as(y, self.dtype)
        if hasattr(self, "q"):
            q = self.q(x)
            w, b = self.kv.cast_params()
            return q, F.linear(y, w[:d], b[:d]), F.linear(y, w[d:], b[d:])
        w, b = self.qkv.cast_params()
        return (F.linear(_as(x, self.dtype), w[:d], b[:d]),
                F.linear(y, w[d:2 * d], b[d:2 * d]),
                F.linear(y, w[2 * d:], b[2 * d:]))

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                masks: Optional[DropoutMasks] = None) -> torch.Tensor:
        if y is None:
            if not hasattr(self, "qkv"):
                raise ValueError("an attention whose keys and values have "
                                 "their own width cross-attends only: give "
                                 "it y")
            qkv = self.qkv(x)
            if torch.is_grad_enabled():
                att = attn_ops.PackedSelfAttention.apply(qkv, self.num_heads)
            else:
                att = attn_ops.packed_self_attention(qkv, self.num_heads)
        else:
            q, k, v = self._cross(x, y)
            if torch.is_grad_enabled():
                att = attn_ops.CrossAttention.apply(q, k, v, self.num_heads)
            else:
                att = attn_ops.cross_attention(q, k, v, self.num_heads)
        if self.ref_merge:
            att = ref_merge(att, self.num_heads)
        return dropout(self.fc_o(att), self.dropout_p, masks)


class ResidualBlock(nn.Module):
    """Set-transformer block (`ldt_tpu/nn/layers.py::ResidualBlock`).

    forward(x [B,N,C_in], y [B,M,C_in] or None, c [B,Dc] or None, *, mods):
      * AdaLN (`c` or precomputed `mods`):
            q = modulate(norm1(x))
            x = shortcut(x) + gate_msa * Attn(q, y or q)
            x = x + gate_mlp * MLP(modulate(norm2(x)))
        mods are [6 C] from one head `adaLN`, or with C_out != C_in
        [2 C_in | 4 C_out] from `adaLN1` (shift and scale of the attention's
        input) and `adaLN2`;
      * `AdaLN=False` with `c`: x = act(norm1(x)) + pos_embedding(silu(c));
            x = shortcut(x) + Attn(x, y or x); x = x + MLP(act(norm2(x)))
        (the residual starts from the normed, shifted x, as the reference's);
      * unconditional: q = act(norm1(x)); x = shortcut(x) + Attn(q, y or q)
            x = x + MLP(act(norm2(x)))
    then x / sqrt(2) with `rescale`. `shortcut` is a Dense C_in -> C_out
    where the widths differ, else the identity; norm2 and the MLP run at
    C_out. With y None the block self-attends through the packed path
    (kernel K1); with y given it cross-attends (kernel K2); `dim_kv` is y's
    width where it is not C_in (`Attention`). Layer norms carry scale and
    bias only when unconditioned (`dim_c` None). Dropout at `dropout_att`
    after the attention's `fc_o` and at `dropout_mlp` in the MLP, with the
    masks of `forward(..., masks=)`.
    """

    def __init__(self, dim: int, dim_c: Optional[int] = None,
                 num_heads: int = 4, norm: Optional[str] = "layer_norm",
                 mlp_ratio: float = 4.0, act: Optional[str] = None, *,
                 dim_out: Optional[int] = None,
                 dim_kv: Optional[int] = None, AdaLN: bool = True,
                 rescale: bool = False, ref_merge: bool = False,
                 dropout_att: float = 0.0, dropout_mlp: float = 0.0,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        dim_out = dim if dim_out is None else dim_out
        affine = dim_c is None
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.dim_in, self.dim_out = dim, dim_out
        self.AdaLN = AdaLN
        self.rescale = rescale
        self.norm1 = make_norm(norm, dim, affine, **kw)
        self.norm2 = make_norm(norm, dim_out, affine, **kw)
        self.act = get_activation(act)
        self.attn = Attention(dim, num_heads, dim_out=dim_out,
                              dim_kv=dim_kv, ref_merge=ref_merge,
                              dropout_p=dropout_att, **kw)
        self.mlp = MLP(dim_out, int(mlp_ratio * dim_out), dim_out,
                       dropout_p=dropout_mlp, **kw)
        if dim_out != dim:
            self.shortcut = Dense(dim, dim_out, **kw)
        if dim_c is None:
            return
        if not AdaLN:
            self.pos_embedding = Dense(dim_c, dim, **kw)
        elif dim_out == dim:
            self.adaLN = Dense(dim_c, 6 * dim, **kw)
        else:
            self.adaLN1 = Dense(dim_c, 2 * dim, **kw)
            self.adaLN2 = Dense(dim_c, 4 * dim_out, **kw)

    def compute_mods(self, c: torch.Tensor) -> torch.Tensor:
        """The AdaLN heads alone: [..., Dc] -> [..., 6C] or
        [..., 2 C_in + 4 C_out] (hoisted out of the sampler loop by
        `Score.precompute_mods`)."""
        c = F.silu(c)
        if self.dim_out == self.dim_in:
            return self.adaLN(c)
        return torch.cat([self.adaLN1(c), self.adaLN2(c)], dim=-1)

    def _shortcut(self, x: torch.Tensor) -> torch.Tensor:
        return self.shortcut(x) if self.dim_out != self.dim_in else x

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                c: Optional[torch.Tensor] = None, *,
                mods: Optional[torch.Tensor] = None,
                masks: Optional[DropoutMasks] = None) -> torch.Tensor:
        if c is not None and c.dim() == 2:
            c = c[:, None, :]
        if (c is not None or mods is not None) and self.AdaLN:
            if mods is None:
                mods = self.compute_mods(c)
            while mods.dim() < 3:
                mods = mods[None]
            head = 2 * self.dim_in
            shift_msa, scale_msa = mods[..., :head].chunk(2, dim=-1)
            gate_msa, shift_mlp, scale_mlp, gate_mlp = mods[..., head:].chunk(
                4, dim=-1)
            q = modulate(self.norm1(x), shift_msa, scale_msa)
            x = self._shortcut(x) + gate_msa * self.attn(q, y, masks)
            x = x + gate_mlp * self.mlp(
                modulate(self.norm2(x), shift_mlp, scale_mlp), masks)
        elif c is not None:
            x = self.act(self.norm1(x)) + self.pos_embedding(F.silu(c))
            x = self._shortcut(x) + self.attn(x, y, masks)
            x = x + self.mlp(self.act(self.norm2(x)), masks)
        else:
            q = self.act(self.norm1(x))
            x = self._shortcut(x) + self.attn(q, y, masks)
            x = x + self.mlp(self.act(self.norm2(x)), masks)
        if self.rescale:
            x = x / math.sqrt(2.0)
        return x


class FinalLayer(nn.Module):
    """Output head (`ldt_tpu/nn/layers.py::FinalLayer`): with `dim_c`,
    ln(modulate(norm(x))) by an AdaLN shift and scale; without,
    ln(norm(x)) with an affine norm."""

    def __init__(self, dim_in: int, dim_out: int, dim_c: Optional[int] = None,
                 norm: Optional[str] = "layer_norm", *, dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.norm = make_norm(norm, dim_in, dim_c is None, **kw)
        if dim_c is not None:
            self.adaLN = Dense(dim_c, 2 * dim_in, **kw)
        self.ln = Dense(dim_in, dim_out, **kw)

    def compute_mods(self, c: torch.Tensor) -> torch.Tensor:
        return self.adaLN(F.silu(c))

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None, *,
                mods: Optional[torch.Tensor] = None) -> torch.Tensor:
        """AdaLN from the conditioning `c` [B, Dc] or precomputed `mods`;
        neither: the plain head."""
        if mods is None and c is None:
            return self.ln(self.norm(x))
        if mods is None:
            mods = self.compute_mods(c[:, None, :] if c.dim() == 2 else c)
        while mods.dim() < 3:
            mods = mods[None]
        shift, scale = mods.chunk(2, dim=-1)
        return self.ln(modulate(self.norm(x), shift, scale))
