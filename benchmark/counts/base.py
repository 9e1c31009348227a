"""The yardstick's arithmetic: model FLOPs from shapes, each kernel
function's least bytes and operations, and the H100's published peaks.
The modules beside this one apply it to a per-layer metric's stretch:
each has `count(work)`, the stretch's model FLOPs (an `mfu` metric) or the
least seconds of its calls of one function (a roofline), from the facts
its runner reports (`work`) and the cell's configuration
(`work["config"]`). A metric file names its module under `"count"`.

Peaks (NVIDIA's H100 SXM data sheet, dense): bf16 989, TF32 495, f32 67
(outside the tensor cores) TFLOP/s, int8 1979 TOP/s, HBM 3.35 TB/s; the
special-function units 16 exponentials per SM per clock at 132 SMs and
1.98 GHz (4.18e12/s).

Model FLOPs count 2 per multiply-add of every dense layer and attention
product the published architecture computes, from the configuration's
widths; elementwise work, norms and softmax are not counted.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12,
              "int8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12
SFU_EXP_PER_S = 16 * 132 * 1.98e9
DTYPE_BYTES = {"bfloat16": 2, "float32": 4, "int8": 1}


def dense(rows: int, fan_in: int, fan_out: int) -> float:
    return 2.0 * rows * fan_in * fan_out


def attention_core(batch: int, queries: int, keys: int, width: int) -> float:
    """q k^T and the weights times v, all heads."""
    return 4.0 * batch * queries * keys * width


def block(batch: int, tokens: int, width: int, keys: int | None = None,
          key_rows: int | None = None, mlp_ratio: float = 4.0) -> float:
    """One set-transformer block without its AdaLN head: q, k, v, the
    attention, the output projection and the MLP. Cross-attention takes
    `keys` keys projected from `key_rows` rows per sample."""
    keys = tokens if keys is None else keys
    key_rows = tokens if key_rows is None else key_rows
    hidden = int(mlp_ratio * width)
    return (dense(batch * tokens, width, width)
            + dense(batch * key_rows, width, 2 * width)
            + attention_core(batch, tokens, keys, width)
            + dense(batch * tokens, width, width)
            + dense(batch * tokens, width, hidden)
            + dense(batch * tokens, hidden, width))


def score_blocks(cfg: dict, batch: int) -> float:
    """The Score's blocks at B samples, modulations excluded: the work of
    one hoisted sampler step before its input and output projections."""
    return cfg["num_blocks"] * block(batch, cfg["z_scale"], cfg["hidden_size"])


def score_conditioning(cfg: dict, batch: int, label: bool) -> float:
    """Time (and label) embeddings and every AdaLN head, per sample."""
    dc, h = cfg["t_dim"], cfg["hidden_size"]
    emb = dense(batch, dc // 4, dc) + dense(batch, dc, dc)
    if label:
        emb += dense(batch, dc, dc) * 2
    return emb + cfg["num_blocks"] * dense(batch, dc, 6 * h) \
        + dense(batch, dc, 2 * h)


def score_io(cfg: dict, batch: int) -> float:
    rows = batch * cfg["z_scale"]
    return dense(rows, cfg["z_dim"], cfg["hidden_size"]) \
        + dense(rows, cfg["hidden_size"], cfg["z_dim"])


def score_forward(cfg: dict, batch: int, label: bool = False,
                  mods: bool = True) -> float:
    """A whole Score forward (`mods` False: the modulations hoisted out)."""
    out = score_blocks(cfg, batch) + score_io(cfg, batch)
    return out + (score_conditioning(cfg, batch, label) if mods else 0.0)


def encode(cfg: dict, batch: int, points: int) -> float:
    """The set-VAE's posterior pass over `points`-point clouds: the input
    projection, the grouping's shared MLP over z_scales groups of
    2 points / z_scales neighbours, the position net, the encoder stages
    and their taps, then top-down per layer the posterior block (the taps
    attending to the decoded set, or to themselves at the top), its dense
    head and the decode block (the latent projection, then the set
    attending to the z_scales latent tokens)."""
    w, s, p = cfg["hidden_dim"], cfg["z_scales"], cfg["p_dim"]
    k = points // s * 2
    n_out = cfg["outsize"]
    out = dense(batch * points, cfg["input_dim"], w)
    out += dense(batch * s * k, 2 * w + 3, w) + 2 * dense(batch * s * k, w, w)
    out += dense(batch * s, 3, 128) + dense(batch * s, 128, 256) \
        + dense(batch, 256, p)
    cond = dense(batch, p, 6 * w)
    per_stage = cfg["encoder_layers"] * (block(batch, s, w) + cond) \
        + dense(batch, p, 2 * w) + dense(batch * s, w, w)
    out += cfg["n_layers"] * per_stage
    for i in range(cfg["n_layers"]):
        keys = s if i == 0 else n_out
        out += block(batch, s, w, keys=keys, key_rows=keys)
        out += dense(batch * s, w, 2 * cfg["z_dim"])
        out += dense(batch * s, cfg["z_dim"], w) \
            + block(batch, n_out, w, keys=s, key_rows=s)
    return out


def least_seconds(nbytes: float, ops: dict) -> float:
    """The larger of the bytes at the memory rate and the operations
    {peak name: count} at their peaks."""
    t_ops = 0.0
    for kind, n in ops.items():
        t_ops += n / (SFU_EXP_PER_S if kind == "exp" else PEAK_FLOPS[kind])
    return max(nbytes / PEAK_BYTES_PER_S, t_ops)


def self_attention(batch: int, tokens: int, width: int, dtype: str) -> float:
    """K1's function on a packed [B, T, 3C] q|k|v -> [B, T, C]."""
    e = DTYPE_BYTES[dtype]
    nbytes = batch * tokens * 4 * width * e
    return least_seconds(nbytes, {dtype: attention_core(batch, tokens,
                                                        tokens, width)})


def self_attention_bwd(batch: int, tokens: int, width: int,
                       dtype: str) -> float:
    """K3's function: q|k|v [B, T, 3C] and the output's gradient [B, T, C]
    -> the q|k|v gradient [B, T, 3C]; the scores recomputed, then the four
    gradient products (10 T^2 C a sample)."""
    e = DTYPE_BYTES[dtype]
    nbytes = batch * tokens * 7 * width * e
    flops = 2.5 * attention_core(batch, tokens, tokens, width)
    return least_seconds(nbytes, {dtype: flops})


def emd_approx_match(pairs: int, n: int, m: int) -> float:
    """K6/K7's function: the 9-level approximate matching's cost of each
    pair of clouds: 9 N M exponentials on the special-function units; the
    two clouds read once, one cost written."""
    nbytes = pairs * ((n + m) * 3 * 4 + 4)
    return least_seconds(nbytes, {"exp": 9.0 * pairs * n * m})

