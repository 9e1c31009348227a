"""Plain PyTorch reference of the LDT networks: the latent DiT ("Score")
and the set-VAE ("Compressor"), written from the published LDT
architecture (github.com/Negai-98/LDT) and frozen here.

It imports nothing of the program under test. Every product goes through
`mm`, which computes in the precision the caller asks for: "f32" (IEEE,
TF32 off), "tf32" (TF32 on) or "bf16" (inputs and weights rounded to bf16,
the product taken in f32): the lower precisions are the controls that the
comparison has to reject. Parameter names are
those of the program's state_dict, so one dict of weights made by the
benchmark loads into both.

Layout: clouds and token sets are channels-last [B, N, C]. Attention is
softmax(q k^T / sqrt(dh)) v per head, heads on contiguous channel blocks;
a packed q|k|v projection is one [3C, C] weight.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
BN_EPS = 1e-5


class Precision:
    """The precision of every `mm` inside `use(name)`."""

    name = "f32"

    @classmethod
    @contextmanager
    def use(cls, name: str):
        if name not in ("f32", "tf32", "bf16"):
            raise ValueError(f"precision {name!r}")
        old = cls.name
        old_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        cls.name = name
        torch.backends.cuda.matmul.allow_tf32 = name == "tf32"
        torch.backends.cudnn.allow_tf32 = name == "tf32"
        try:
            yield
        finally:
            cls.name = old
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old_tf32


def rounded(t: torch.Tensor) -> torch.Tensor:
    """`t` (f32) as the current precision stores an operand."""
    if Precision.name == "bf16":
        return t.to(torch.bfloat16).float()
    return t


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in f32 from operands rounded to the current precision."""
    return torch.matmul(rounded(a.float()), rounded(b.float()))


class Linear(nn.Module):
    """y = x W^T + b, W [out, in]."""

    def __init__(self, fan_in: int, fan_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fan_out, fan_in))
        self.bias = nn.Parameter(torch.empty(fan_out))

    def forward(self, x):
        return mm(x, self.weight.t()) + self.bias

    def rows(self, x, lo: int, hi: int):
        """The output features [lo, hi) alone."""
        return mm(x, self.weight[lo:hi].t()) + self.bias[lo:hi]


class Norm(nn.Module):
    """Layer norm over the last axis (eps 1e-6), with scale and bias only
    when `affine`."""

    def __init__(self, width: int, affine: bool):
        super().__init__()
        self.width = width
        if affine:
            self.weight = nn.Parameter(torch.ones(width))
            self.bias = nn.Parameter(torch.zeros(width))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        y = (x - mean) / torch.sqrt(var + LN_EPS)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y


class BatchNormEval(nn.Module):
    """Batch norm with its running statistics (eps 1e-5)."""

    def __init__(self, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.register_buffer("running_mean", torch.zeros(width))
        self.register_buffer("running_var", torch.ones(width))

    def forward(self, x):
        return ((x - self.running_mean) / torch.sqrt(self.running_var + BN_EPS)
                * self.weight + self.bias)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def silu(x):
    return x * torch.sigmoid(x)


def attention(q, k, v, heads: int):
    """softmax(q k^T / sqrt(dh)) v per head: q [B, N, C], k, v [B, M, C]."""
    b, n, c = q.shape
    m = k.shape[1]
    dh = c // heads
    qh = q.reshape(b, n, heads, dh).transpose(1, 2)
    kh = k.reshape(b, m, heads, dh).transpose(1, 2)
    vh = v.reshape(b, m, heads, dh).transpose(1, 2)
    w = torch.softmax(mm(qh, kh.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
    return mm(w, vh).transpose(1, 2).reshape(b, n, c)


class Attn(nn.Module):
    """Multi-head attention with a packed q|k|v weight `qkv` [3C, C] and an
    output projection `fc_o`. y None: self-attention on x."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.width, self.heads = width, heads
        self.qkv = Linear(width, 3 * width)
        self.fc_o = Linear(width, width)

    def forward(self, x, y=None):
        c = self.width
        y = x if y is None else y
        q = self.qkv.rows(x, 0, c)
        k = self.qkv.rows(y, c, 2 * c)
        v = self.qkv.rows(y, 2 * c, 3 * c)
        return self.fc_o(attention(q, k, v, self.heads))


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.dense_0 = Linear(width, hidden)
        self.dense_1 = Linear(hidden, width)

    def forward(self, x):
        return self.dense_1(gelu_tanh(self.dense_0(x)))


class Block(nn.Module):
    """Set-transformer block. With a conditioning width `dim_c` it is an
    AdaLN block, its modulations adaLN(silu(c)) = shift/scale/gate of the
    attention, then of the MLP, its norms without scale and bias; called
    without c it runs q = norm1(x) unmodulated and ungated (the decoder's
    unconditioned branch). Without `dim_c` the norms carry scale and bias.
    The attention's keys and values come from y (raw) when given."""

    def __init__(self, width: int, heads: int, dim_c=None,
                 mlp_ratio: float = 4.0):
        super().__init__()
        affine = dim_c is None
        self.norm1 = Norm(width, affine)
        self.norm2 = Norm(width, affine)
        self.attn = Attn(width, heads)
        self.mlp = Mlp(width, int(mlp_ratio * width))
        if dim_c is not None:
            self.adaLN = Linear(dim_c, 6 * width)

    def forward(self, x, y=None, c=None):
        if c is None:
            q = self.norm1(x)
            x = x + self.attn(q, y)
            return x + self.mlp(self.norm2(x))
        mods = self.adaLN(silu(c))[:, None, :]
        (shift_a, scale_a, gate_a, shift_m, scale_m,
         gate_m) = mods.chunk(6, dim=-1)
        q = self.norm1(x) * (1 + scale_a) + shift_a
        x = x + gate_a * self.attn(q, y)
        return x + gate_m * self.mlp(self.norm2(x) * (1 + scale_m) + shift_m)


class Head(nn.Module):
    """Output head: ln(norm(x) * (1 + scale) + shift), the shift and scale
    adaLN(silu(c))."""

    def __init__(self, width: int, out: int, dim_c: int):
        super().__init__()
        self.norm = Norm(width, False)
        self.adaLN = Linear(dim_c, 2 * width)
        self.ln = Linear(width, out)

    def forward(self, x, c):
        shift, scale = self.adaLN(silu(c))[:, None, :].chunk(2, dim=-1)
        return self.ln(self.norm(x) * (1 + scale) + shift)


def sinusoid(t, dim: int):
    """[B] -> [B, dim] = [sin | cos] of t * exp(-ln(1e4) i / (dim/2 - 1))."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


class Embed2(nn.Module):
    """Two dense layers with a SiLU between."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.dense_0 = Linear(dim_in, dim_out)
        self.dense_1 = Linear(dim_out, dim_out)

    def forward(self, h):
        return self.dense_1(silu(self.dense_0(h)))


class TimeEmbed(Embed2):
    def __init__(self, dim_embed: int, dim_out: int):
        super().__init__(dim_embed, dim_out)
        self.dim_embed = dim_embed

    def forward(self, t):
        return super().forward(sinusoid(t, self.dim_embed))


class LabelEmbed(Embed2):
    def __init__(self, categories: int, dim_embed: int, dim_out: int):
        super().__init__(dim_embed, dim_out)
        self.embed = nn.Embedding(categories, dim_embed)

    def forward(self, label):
        return super().forward(self.embed.weight[label.long()])


class Score(nn.Module):
    """The latent DiT: eps_hat(x [B, S, z_dim], t [B], label [B] or None).
    c = time embedding (+ label embedding); ln_in, `num_blocks` AdaLN
    self-attention blocks on c, the AdaLN head back to z_dim."""

    def __init__(self, cfg: dict):
        super().__init__()
        h, dc = cfg["hidden_size"], cfg["t_dim"]
        self.ln_in = Linear(cfg["z_dim"], h)
        self.transformer = nn.ModuleList(
            Block(h, cfg["num_heads"], dc) for _ in range(cfg["num_blocks"]))
        self.time_embedding = TimeEmbed(dc // 4, dc)
        self.ln_out = Head(h, cfg["z_dim"], dc)
        if cfg["num_categorys"] > 1:
            self.label_embedding = LabelEmbed(cfg["num_categorys"], dc, dc)

    def forward(self, x, t, label=None):
        c = self.time_embedding(t)
        if label is not None:
            c = c + self.label_embedding(label)
        h = self.ln_in(x)
        for block in self.transformer:
            h = block(h, None, c)
        return self.ln_out(h, c)


# --- the Compressor -------------------------------------------------------

def gather_points(points, idx):
    """points [B, N, C] at idx [B, ...] -> [B, ..., C]."""
    b = points.shape[0]
    flat = idx.reshape(b, -1)
    out = torch.gather(points, 1,
                       flat[..., None].expand(-1, -1, points.shape[-1]))
    return out.reshape(*idx.shape, points.shape[-1])


def sq_dist(a, b):
    """[B, N, 3], [B, M, 3] -> [B, N, M]: sum over c of (a_c - b_c)^2, the
    coordinates as the current precision stores them."""
    a, b = rounded(a.float()), rounded(b.float())
    out = 0.0
    for ch in range(a.shape[-1]):
        diff = a[:, :, None, ch] - b[:, None, :, ch]
        out = out + diff * diff
    return out


def fps(xyz, count: int):
    """Furthest point sampling from index 0 (first index on ties)."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    idx = torch.zeros((b, count), dtype=torch.long, device=xyz.device)
    far = torch.full((b, n), float("inf"), device=xyz.device)
    last = idx[:, 0]
    for i in range(1, count):
        d = sq_dist(xyz, xyz[rows, last][:, None, :])[..., 0]
        far = torch.minimum(far, d)
        last = torch.argmax(far, dim=-1)
        idx[:, i] = last
    return idx


class ResBN(nn.Module):
    """relu(net2_dense(relu(net1_bn(net1_dense(x)))) + x)."""

    def __init__(self, width: int):
        super().__init__()
        self.net1_dense = Linear(width, width)
        self.net1_bn = BatchNormEval(width)
        self.net2_dense = Linear(width, width)

    def forward(self, x):
        h = F.relu(self.net1_bn(self.net1_dense(x)))
        return F.relu(self.net2_dense(h) + x)


class Extraction(nn.Module):
    def __init__(self, dim_in: int, width: int):
        super().__init__()
        self.transfer_dense = Linear(dim_in, width)
        self.transfer_bn = BatchNormEval(width)
        self.ops = nn.ModuleList([ResBN(width)])

    def forward(self, x):
        b, s, k, d = x.shape
        h = F.relu(self.transfer_bn(self.transfer_dense(x.reshape(b * s, k,
                                                                   d))))
        for op in self.ops:
            h = op(h)
        return h.amax(dim=1).reshape(b, s, -1)


class Grouper(nn.Module):
    """FPS centers, their k nearest points, features relative to the
    center ("anchor"), scaled by one std per cloud, the affine, the
    center's feature appended; a shared MLP max-pooled over each group."""

    def __init__(self, width: int):
        super().__init__()
        self.affine_alpha = nn.Parameter(torch.ones(1, 1, 1, width + 3))
        self.affine_beta = nn.Parameter(torch.zeros(1, 1, 1, width + 3))
        self.extraction = Extraction(2 * width + 3, width)

    def forward(self, xyz, feature, groups: int, k: int):
        b = xyz.shape[0]
        center_idx = fps(xyz, groups)
        centers = gather_points(xyz, center_idx)
        knn = torch.topk(sq_dist(centers, xyz), k, dim=-1, largest=False)[1]
        center_feat = gather_points(feature, center_idx)
        grouped = torch.cat([gather_points(feature, knn),
                             gather_points(xyz, knn)], dim=-1)
        resid = grouped - torch.cat([center_feat, centers], -1)[:, :, None]
        std = resid.reshape(b, -1).std(dim=-1)[:, None, None, None]
        grouped = self.affine_alpha * (resid / (std + 1e-5)) + self.affine_beta
        anchor = center_feat[:, :, None, :].expand(-1, -1, k, -1)
        return centers, self.extraction(torch.cat([grouped, anchor], -1))


class PointNet(nn.Module):
    """Per-center MLP (BN, ReLU), max over the centers, a dense layer:
    one position vector per cloud."""

    def __init__(self, width: int):
        super().__init__()
        self.conv1 = Linear(3, 128)
        self.bn1 = BatchNormEval(128)
        self.conv2 = Linear(128, 256)
        self.bn2 = BatchNormEval(256)
        self.fc = Linear(256, width)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        return self.fc(h.amax(dim=1))


class ActNormToken(nn.Module):
    def __init__(self, tokens: int, width: int):
        super().__init__()
        self.shift = nn.Parameter(torch.zeros(1, tokens, width))
        self.log_scale = nn.Parameter(torch.zeros(1, tokens, width))

    def forward(self, x):
        return (x - self.shift) * torch.exp(-self.log_scale)


class EncoderStage(nn.Module):
    """Two AdaLN blocks on the position vector, keys and values the raw
    tokens; a tap through an AdaLN head."""

    def __init__(self, width: int, heads: int, p_dim: int, layers: int):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"att{i}", Block(width, heads, p_dim))
        self.conv_out = Head(width, width, p_dim)

    def forward(self, x, pos):
        for i in range(self.layers):
            x = getattr(self, f"att{i}")(x, x, pos)
        return x, self.conv_out(x, pos)


class DecoderStage(nn.Module):
    """Posterior: the encoder tap attends to the decoded set (its raw self
    at the top) -> mu, logvar (clamped); decode: the set attends to the
    projected latents."""

    def __init__(self, width: int, z_dim: int, heads: int, c_dim,
                 min_sigma: float):
        super().__init__()
        self.z_dim, self.min_sigma = z_dim, min_sigma
        self.att = Block(width, heads, c_dim)
        self.prior_dense = Linear(width, 2 * z_dim)
        self.att1 = Block(width, heads, c_dim)
        self.ln = Linear(z_dim, width)

    def posterior(self, x, o, c):
        x = self.att(x, x if o is None else o, c)
        post = self.prior_dense(silu(x))
        return (post[..., :self.z_dim],
                post[..., self.z_dim:].clamp(self.min_sigma, 10.0))

    def forward(self, o, eps, c=None):
        return self.att1(o, self.ln(eps), c)


class InitSet(nn.Module):
    def __init__(self, count: int, width: int):
        super().__init__()
        self.prior = nn.Parameter(torch.empty(count, width))


class Compressor(nn.Module):
    """The set-VAE at the published configuration (ActNorm per token,
    anchor grouping, MiniPointnet positions, AdaLN encoder, a learned
    seed set of `max_outputs` = `outsize` points)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        w, heads = cfg["hidden_dim"], cfg["num_heads"]
        self.input_dense = Linear(cfg["input_dim"], w)
        self.conv_in = ActNormToken(cfg["z_scales"], w)
        self.group = Grouper(w)
        self.pos_embedding = PointNet(cfg["p_dim"])
        c_dim = cfg["p_dim"] if cfg["class_condition"] else None
        if cfg["class_condition"]:
            self.label_embedding = LabelEmbed(cfg["num_categorys"],
                                              cfg["p_dim"], cfg["p_dim"])
        self.encoder = nn.ModuleList(
            EncoderStage(w, heads, cfg["p_dim"], cfg["encoder_layers"])
            for _ in range(cfg["n_layers"]))
        self.decoder = nn.ModuleList(
            DecoderStage(w, cfg["z_dim"], heads, c_dim, cfg["min_sigma"])
            for _ in range(cfg["n_layers"]))
        self.output_dense = Linear(w, 3)
        self.init_set = InitSet(cfg["max_outputs"], w)

    def encode(self, pts, noise, label=None):
        """Latents [B, z_scales, n_layers * z_dim] of clouds [B, N, 3]:
        the reparameterized posterior samples, top-down, with the draws
        `noise[i]` [B, z_scales, z_dim] of decode step i."""
        cfg = self.cfg
        x = self.input_dense(pts)
        n = pts.shape[1]
        centers, x = self.group(pts, x, cfg["z_scales"],
                                n // cfg["z_scales"] * 2)
        pos = self.pos_embedding(centers)
        c = None
        if label is not None and cfg["class_condition"]:
            c = self.label_embedding(label)
            pos = pos + c
        x = self.conv_in(x)
        taps = []
        for stage in self.encoder:
            x, tap = stage(x, pos)
            taps.append(tap)
        o = self.init_set.prior[None].expand(pts.shape[0], -1, -1)
        eps_all = []
        for i in range(cfg["n_layers"]):
            stage = self.decoder[cfg["n_layers"] - 1 - i]
            mu, logvar = stage.posterior(taps[-i - 1], o if i else None, c)
            eps = mu + torch.exp(logvar / 2.0) * noise[i]
            o = stage(o, eps, c)
            eps_all.append(eps)
        return torch.cat(eps_all, dim=-1)

    def decode(self, latents):
        """Clouds [B, max_outputs, 3] of latents [B, z_scales, 6 z_dim]
        (no label: the unconditioned branch of every block)."""
        cfg = self.cfg
        o = self.init_set.prior[None].expand(latents.shape[0], -1, -1)
        parts = torch.split(latents, cfg["z_dim"], dim=-1)
        for i in range(cfg["n_layers"]):
            o = self.decoder[cfg["n_layers"] - 1 - i](o, parts[i])
        return self.output_dense(o)
