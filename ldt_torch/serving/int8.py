"""W8A8 int8 serving of the latent DiT sampler, counterpart of
`ldt_tpu/serving/int8.py` (same names, same numerics).

A quantized twin of `Score.denoise_with_mods`, the precomputed-modulation
step the reverse-diffusion loop calls:

  * weights: per-output-channel symmetric int8, quantized ONCE per
    generation, outside the loop, from the f32 weights (`quantize_weight`,
    `quantize_score_params`). They are stored in torch's [out, in] layout,
    which `torch._int_mm` takes as its transposed second operand, so no call
    transposes or copies a weight;
  * activations: dynamic per-token symmetric int8 (amax over the feature
    axis), or a static per-(step, block, site) scale (`act_scales`, from
    `calibrate_act_scales`), passed in as a tensor and indexed per step;
  * int8 x int8 -> int32 products (`torch._int_mm`; exact integers on both
    devices), dequantized as (acc * s_x) * s_w;
  * LayerNorm, modulations, residuals, GELU (the tanh form, whatever the
    config's activation) and the small in/out projections stay bf16; the
    attention core is kernel K1, or K8 (int8 operands) with `attn_int8`.

The conditional (completion) twin of the whole conditional Score,
`denoise_cond_int8`, serves the same way (`quantize_cond_score_params`):
its even blocks keep `fc_q` in int8 and cross-attend through kernel K2 in
bf16 to the condition's k and v, projected once per sampling run in bf16
(`precompute_cond_kv`); its odd blocks take the packed int8 qkv and K1 (or
K8); c = t_emb + the image embedding is per sample, so each step computes
the blocks' AdaLN modulations with one stacked bf16 GEMM. It has no
`bf16_tail` and no static scales, as the JAX package's has not.

The JAX package reads its knobs from environment variables; here each is
an argument whose default is the JAX package's environment default:
`bf16_tail` (LDT_INT8_BF16_TAIL, 0), `attn_int8` (LDT_ATTN_INT8, off),
`static_act` (LDT_INT8_STATIC, off), `serve_int8` (LDT_SERVE_INT8, off),
`strict` (LDT_SERVE_INT8_STRICT, off) and `static_file`
(LDT_INT8_STATIC_FILE, unset).

The act-scale tables (npz) and the golden-gate stamps (JSON) are written in
the JAX package's formats, so a file written by either package loads in the
other.
"""

from __future__ import annotations

import hashlib
import math
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ldt_torch.diffusion.sampling import sample_discrete
from ldt_torch.nn.layers import modulate
from ldt_torch.ops import attention as attn_ops
from ldt_torch.ops.attention import true_divide

# Batch elements per K8 scale group (`pallas_attention.py::_ELEMS`).
ATTN_ELEMS = 4


def quantize_weight(w: torch.Tensor):
    """[N, K] float ([out, in]) -> (int8 [N, K], f32 scale [N]),
    per output channel: amax over the input axis."""
    w = w.float()
    amax = w.abs().amax(dim=1)
    scale = true_divide(torch.clamp(amax, min=1e-12), 127.0)
    w_i8 = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return w_i8.to(torch.int8).contiguous(), scale


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ w[N, K]^T in the promoted dtype of the two (jnp's `@`)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return torch.matmul(a.to(dt), w.to(dt).t())


def _int8_gemm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ w [N, K]^T int8 -> int32 [M, N], exact. On the card
    `torch._int_mm` (cuBLASLt) takes M > 16 and K, N multiples of 8."""
    m, k = a.shape
    n = w.shape[0]
    if a.device.type == "cuda" and (m <= 16 or k % 8 or n % 8):
        raise ValueError(f"int8 GEMM [{m}, {k}] x [{k}, {n}]: on CUDA "
                         "torch._int_mm needs M > 16 and K, N multiples "
                         "of 8")
    return torch._int_mm(a, w.t())


def int8_matmul(x: torch.Tensor, w_i8: torch.Tensor,
                w_scale: Optional[torch.Tensor],
                out_dtype=torch.bfloat16,
                x_scale: Optional[torch.Tensor] = None,
                record: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """x [..., K] @ the int8 weight w_i8 [N, K] with activation quant.

    `w_scale=None`: w_i8 is a bf16 PASSTHROUGH weight (a `bf16_tail`
    block), a plain matmul. `x_scale`: the static scale of this site and
    step, a tensor (else dynamic per-token scales max|x_row| / 127).
    `record`: a list that collects this call's activation amax as a 0-d f32
    tensor on x's device (a passthrough site appends 0 to keep the sites
    aligned); no host sync.
    """
    if w_scale is None:
        if record is not None:
            record.append(torch.zeros((), dtype=torch.float32,
                                      device=x.device))
        return _mm(x, w_i8).to(out_dtype)
    if record is not None:
        record.append(x.abs().amax().float())
    if x_scale is None:
        amax = x.abs().amax(dim=-1, keepdim=True).float()
        s_x = true_divide(torch.clamp(amax, min=1e-12), 127.0)
    elif not torch.is_tensor(x_scale):
        raise TypeError("int8_matmul: x_scale must be a tensor (a static "
                        "scale captured as a Python number goes stale)")
    else:
        s_x = x_scale.float()
    x_i8 = torch.clamp(torch.round(x.float() / s_x), -127, 127).to(
        torch.int8)
    acc = _int8_gemm(x_i8.reshape(-1, x.shape[-1]), w_i8)
    acc = acc.reshape(*x.shape[:-1], w_i8.shape[0])
    return ((acc.float() * s_x) * w_scale).to(out_dtype)


_BLOCK_WEIGHTS = (("qkv", "attn.qkv"), ("o", "attn.fc_o"),
                  ("up", "mlp.dense_0"), ("dn", "mlp.dense_1"))


def quantize_score_params(params, num_blocks: int, bf16_tail: int = 0, *,
                          device=None) -> Dict[str, Any]:
    """Quantize the per-block GEMM weights of an unconditional Score.

    `params`: an f32 `ldt_torch.models.Score` or its f32 state_dict (e.g.
    `ldt_torch.weights.score_state_dict`); bf16 weights would give other
    codes than the JAX package, which quantizes its f32 params. Returns
    {'blocks': [per block: int8 weight [N, K] + f32 scale [N] for qkv
    (packed q | k | v), o, up, dn; bf16 biases], 'ln_in_w', 'ln_in_b',
    'ln_out_w', 'ln_out_b' (bf16)} on `device` (default: the params').

    `bf16_tail`: the LAST k blocks keep bf16 weights with scale None
    (passthrough), the mixed scheme for few-step sampling.
    """
    sd = params.state_dict() if isinstance(params, torch.nn.Module) else \
        params
    if sd["ln_in.weight"].dtype != torch.float32:
        raise ValueError("quantize_score_params: quantize from the f32 "
                         f"weights, not {sd['ln_in.weight'].dtype}")

    def get(key):
        return sd[key] if device is None else sd[key].to(device)

    def bf16(key):
        return get(key).to(torch.bfloat16)

    blocks = []
    for i in range(num_blocks):
        keep_bf16 = i >= num_blocks - bf16_tail
        blk = {}
        for short, name in _BLOCK_WEIGHTS:
            key = f"transformer.{i}.{name}"
            w = get(f"{key}.weight")
            blk[f"{short}_w"], blk[f"{short}_s"] = (
                (w.to(torch.bfloat16), None) if keep_bf16
                else quantize_weight(w))
            blk[f"{short}_b"] = bf16(f"{key}.bias")
        blocks.append(blk)
    return {"blocks": blocks,
            "ln_in_w": bf16("ln_in.weight"), "ln_in_b": bf16("ln_in.bias"),
            "ln_out_w": bf16("ln_out.ln.weight"),
            "ln_out_b": bf16("ln_out.ln.bias")}


def _ln(x: torch.Tensor) -> torch.Tensor:
    """Non-affine LayerNorm, epsilon 1e-6, in f32, returned in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu` (the tanh form) as it computes: op by op in x's dtype,
    its constants sqrt(2 / pi) and 0.044715 rounded to it. In bf16
    `F.gelu(approximate="tanh")`, which rounds once, differs from it in
    about half of the values."""
    c, k = x.new_tensor(math.sqrt(2 / math.pi)), x.new_tensor(0.044715)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu` as it computes: x * (1 / (1 + exp(-x))), op by op in
    x's dtype. In bf16 `F.silu`, which rounds once, differs from it in
    about a third of the values."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def self_attention(qkv: torch.Tensor, num_heads: int,
                   attn_int8: bool = False) -> torch.Tensor:
    """The attention core of an int8 block, dispatched as
    `pallas_attention.py::_fwd_call_packed`: K8 when `attn_int8` and the
    batch is a multiple of ATTN_ELEMS, else K1."""
    if attn_int8 and qkv.shape[0] % ATTN_ELEMS == 0:
        return attn_ops.packed_self_attention_int8(qkv, num_heads,
                                                   ATTN_ELEMS)
    return attn_ops.packed_self_attention(qkv, num_heads)


def _self_attention_fn(blk: Dict[str, Any], num_heads: int,
                       attn_int8: bool, x_scale=None, record=None):
    """The attention of a self-attending int8 block: the packed int8 qkv
    GEMM, then K1 (or K8)."""

    def attend(q_in):
        qkv = int8_matmul(q_in, blk["qkv_w"], blk["qkv_s"], x_scale=x_scale,
                          record=record) + blk["qkv_b"]
        return self_attention(qkv, num_heads, attn_int8)
    return attend


def _block_int8(h: torch.Tensor, m: torch.Tensor, blk: Dict[str, Any],
                attention, scales=None, record=None) -> torch.Tensor:
    """One DiT block of the int8 twins (shared by the unconditional and the
    conditional one): modulate -> `attention(q_in)` (the only part that
    differs between a self- and a cross-attending block) -> int8 fc_o ->
    gated residual -> modulate -> int8 MLP (tanh GELU) -> gated residual.
    `scales`: this block's [4] static scales (sites qkv, o, up, dn; qkv's
    is `attention`'s own); `record` collects the amaxes in that order."""

    def sc(i):
        return None if scales is None else scales[i]

    (shift_msa, scale_msa, gate_msa,
     shift_mlp, scale_mlp, gate_mlp) = m.chunk(6, dim=-1)
    q_in = modulate(_ln(h), shift_msa, scale_msa)
    att = attention(q_in)
    att = int8_matmul(att, blk["o_w"], blk["o_s"], x_scale=sc(1),
                      record=record) + blk["o_b"]
    h = h + gate_msa * att
    m_in = modulate(_ln(h), shift_mlp, scale_mlp)
    up = _gelu(int8_matmul(m_in, blk["up_w"], blk["up_s"], x_scale=sc(2),
                           record=record) + blk["up_b"])
    dn = int8_matmul(up, blk["dn_w"], blk["dn_s"], x_scale=sc(3),
                     record=record) + blk["dn_b"]
    return h + gate_mlp * dn


def _final_int8(h: torch.Tensor, mf: torch.Tensor,
                q: Dict[str, Any]) -> torch.Tensor:
    shift, scale = mf.chunk(2, dim=-1)
    return _mm(modulate(_ln(h), shift, scale), q["ln_out_w"]) + q["ln_out_b"]


def _lead(m: torch.Tensor) -> torch.Tensor:
    while m.dim() < 3:
        m = m[None]
    return m


def denoise_with_mods_int8(x: torch.Tensor, mods: Dict[str, torch.Tensor],
                           q: Dict[str, Any], num_heads: int, *,
                           attn_int8: bool = False,
                           act_scales: Optional[torch.Tensor] = None,
                           record: Optional[List[torch.Tensor]] = None
                           ) -> torch.Tensor:
    """int8 twin of `Score.denoise_with_mods` for ONE denoise step.

    x [B, z_scale, z_dim]; mods = {'blocks': [num_blocks, 6*hidden],
    'final': [2*hidden]} (one step of `Score.precompute_mods`); q from
    `quantize_score_params`. `act_scales`: this step's [num_blocks, 4]
    static scales (None: dynamic); `record`: a list collecting the
    per-site amaxes (calibration).
    """
    h = _mm(x.to(torch.bfloat16), q["ln_in_w"]) + q["ln_in_b"]
    for i, blk in enumerate(q["blocks"]):
        scales = None if act_scales is None else act_scales[i]
        attend = _self_attention_fn(blk, num_heads, attn_int8,
                                    None if scales is None else scales[0],
                                    record)
        h = _block_int8(h, _lead(mods["blocks"][i]), blk, attend, scales,
                        record)
    return _final_int8(h, _lead(mods["final"]), q)


def quantize_cond_score_params(params, num_blocks: int, *,
                               device=None) -> Dict[str, Any]:
    """Quantize a conditional (non-UNet, AdaLN) Score for int8 serving.

    `params`: an f32 conditional `ldt_torch.models.Score` or its f32
    state_dict. As `quantize_score_params` (no `bf16_tail`), except:
      * even blocks cross-attend to the condition tokens: `q_w` / `q_s`
        (fc_q, the rows [0, D) of the packed qkv weight) in int8, `kv_w`
        [2D, D] (fc_kv) and its bias in bf16, applied once per sampling run
        by `precompute_cond_kv`; odd blocks self-attend through the packed
        int8 qkv;
      * the blocks' AdaLN weights stacked into one bf16 GEMM, 'ada_w'
        [num_blocks * 6 hidden, t_dim] and 'ada_b'; the head's AdaLN
        'fin_w', 'fin_b' in bf16.
    """
    sd = params.state_dict() if isinstance(params, torch.nn.Module) else \
        params
    if sd["ln_in.weight"].dtype != torch.float32:
        raise ValueError("quantize_cond_score_params: quantize from the f32 "
                         f"weights, not {sd['ln_in.weight'].dtype}")

    def get(key):
        return sd[key] if device is None else sd[key].to(device)

    def bf16(key):
        return get(key).to(torch.bfloat16)

    blocks, ada_w, ada_b = [], [], []
    for i in range(num_blocks):
        key = f"transformer.{i}"
        w, b = get(f"{key}.attn.qkv.weight"), get(f"{key}.attn.qkv.bias")
        d = w.shape[0] // 3
        if i % 2 == 0:
            blk = dict(zip(("q_w", "q_s"), quantize_weight(w[:d])))
            blk.update(q_b=b[:d].to(torch.bfloat16),
                       kv_w=w[d:].to(torch.bfloat16).contiguous(),
                       kv_b=b[d:].to(torch.bfloat16))
        else:
            blk = dict(zip(("qkv_w", "qkv_s"), quantize_weight(w)))
            blk["qkv_b"] = b.to(torch.bfloat16)
        for short, name in _BLOCK_WEIGHTS[1:]:
            blk[f"{short}_w"], blk[f"{short}_s"] = quantize_weight(
                get(f"{key}.{name}.weight"))
            blk[f"{short}_b"] = bf16(f"{key}.{name}.bias")
        blocks.append(blk)
        ada_w.append(bf16(f"{key}.adaLN.weight"))
        ada_b.append(bf16(f"{key}.adaLN.bias"))
    return {"blocks": blocks, "ada_w": torch.cat(ada_w),
            "ada_b": torch.cat(ada_b),
            "fin_w": bf16("ln_out.adaLN.weight"),
            "fin_b": bf16("ln_out.adaLN.bias"),
            "ln_in_w": bf16("ln_in.weight"), "ln_in_b": bf16("ln_in.bias"),
            "ln_out_w": bf16("ln_out.ln.weight"),
            "ln_out_b": bf16("ln_out.ln.bias")}


def precompute_cond_kv(q: Dict[str, Any], y: torch.Tensor) -> list:
    """The cross blocks' keys and values of the condition tokens y [B, M,
    hidden] (fixed for a sampling run), once per run: a list over the
    blocks of (k, v), each [B, M, hidden] bf16 and contiguous (K2 takes
    contiguous tensors: the one bf16 GEMM's [B, M, 2 hidden] output split
    into two copies, the same values the JAX package slices each step), or
    None for a self-attending block."""
    y = y.to(torch.bfloat16)
    out = []
    for blk in q["blocks"]:
        if "kv_w" not in blk:
            out.append(None)
            continue
        kv = _mm(y, blk["kv_w"]) + blk["kv_b"]
        k, v = kv.chunk(2, dim=-1)
        out.append((k.contiguous(), v.contiguous()))
    return out


def _cross_attention_fn(blk: Dict[str, Any], kv, num_heads: int):
    """The attention of a cross-attending int8 block: the int8 fc_q GEMM,
    then K2 over the cached (k, v)."""

    def attend(q_in):
        qq = int8_matmul(q_in, blk["q_w"], blk["q_s"]) + blk["q_b"]
        return attn_ops.cross_attention(qq, kv[0], kv[1], num_heads)
    return attend


def denoise_cond_int8(x: torch.Tensor, t_emb: torch.Tensor, img_emb,
                      kv_cache: list, q: Dict[str, Any], num_heads: int, *,
                      attn_int8: bool = False) -> torch.Tensor:
    """int8 twin of the conditional (non-UNet) `Score.forward` for ONE
    denoise step.

    x [B, z_scale, z_dim]; t_emb [t_dim] (this step's row of
    `Score.embed_times` over the schedule); img_emb [B, t_dim] (or 0.0);
    kv_cache from `precompute_cond_kv`; q from `quantize_cond_score_params`.
    c = t_emb + img_emb in bf16, its SiLU through the stacked AdaLN GEMM;
    even blocks cross-attend to the cached k and v (K2), odd blocks
    self-attend through the packed int8 qkv (K1, or K8 with `attn_int8`).
    """
    c = (t_emb[None] + img_emb).to(torch.bfloat16)
    sc = _silu(c)
    nb = len(q["blocks"])
    mods = (_mm(sc, q["ada_w"]) + q["ada_b"]).reshape(sc.shape[0], nb, -1)
    h = _mm(x.to(torch.bfloat16), q["ln_in_w"]) + q["ln_in_b"]
    for i, blk in enumerate(q["blocks"]):
        attend = (_self_attention_fn(blk, num_heads, attn_int8)
                  if kv_cache[i] is None
                  else _cross_attention_fn(blk, kv_cache[i], num_heads))
        h = _block_int8(h, mods[:, i, None], blk, attend)
    fm = (_mm(sc, q["fin_w"]) + q["fin_b"])[:, None]
    return _final_int8(h, fm, q)


@torch.inference_mode()
def calibrate_act_scales(sde, mods: Dict[str, torch.Tensor],
                         qparams: Dict[str, Any], num_heads: int,
                         num_samples: int, shape, N: int,
                         time_eps: float = 1e-6, *, attn_int8: bool = False,
                         device="cuda",
                         generator: Optional[torch.Generator] = None,
                         x0: Optional[torch.Tensor] = None,
                         noise: Optional[torch.Tensor] = None):
    """Per-(step, block, site) STATIC activation scales: one N-step
    ancestral reverse run of the DYNAMIC int8 sampler (`sample_discrete`
    itself, so the trajectory is the one serving sees) that records each
    quantized GEMM input's amax. `mods` covers the N-step schedule; `x0`
    and `noise` pin the draws as in `sample_discrete`.

    Returns (scales [N, num_blocks, 4] = max(amax, 1e-12) / 127,
    x_mean [num_samples, *shape]); sites per block qkv / o / up / dn.
    """
    nb = len(qparams["blocks"])
    amaxes = []

    def score_fn(t, x, step):
        rec: List[torch.Tensor] = []
        p = denoise_with_mods_int8(
            x, {"blocks": mods["blocks"][step], "final": mods["final"][step]},
            qparams, num_heads, attn_int8=attn_int8, record=rec)
        amaxes.append(torch.stack(rec).reshape(nb, 4))
        return -p.float() / sde.std(t)[:, None, None], p

    x_mean = sample_discrete(sde, score_fn, num_samples, shape, N, time_eps,
                             device=device, generator=generator, x0=x0,
                             noise=noise)
    scales = true_divide(torch.clamp(torch.stack(amaxes), min=1e-12),
                         127.0)
    return scales, x_mean


# --------------------------------------------------------------------------
# Act-scale tables: an npz next to the checkpoint, {scales, meta (JSON)},
# bound to the checkpoint's content and to the bf16_tail scheme.

def act_scales_path(ckpt_path: str) -> str:
    return ckpt_path + ".int8_act_scales.npz"


def save_act_scales(ckpt_path: str, scales, *, bf16_tail: int = 0,
                    **meta_extra) -> str:
    """Write the calibration table next to the checkpoint, bound to its
    content (fingerprint) and to the `bf16_tail` scheme of calibration."""
    meta = {"checkpoint": _ckpt_fingerprint(ckpt_path),
            "bf16_tail": int(bf16_tail)}
    meta.update(meta_extra)
    if torch.is_tensor(scales):
        scales = scales.detach().cpu().numpy()
    out = act_scales_path(ckpt_path)
    np.savez(out, scales=np.asarray(scales, np.float32),
             meta=json.dumps(meta))
    return out


def load_act_scales(ckpt_path: Optional[str], sample_N: int,
                    num_blocks: int, cfg=None, *, bf16_tail: int = 0,
                    static_file: Optional[str] = None) -> torch.Tensor:
    """Static activation scales for a checkpoint, f32 [sample_N,
    num_blocks, 4] on the CPU.

    Static scales are an explicit choice, so every problem RAISES (a silent
    fallback to dynamic scales would mislabel the run): no checkpoint or
    file, an unreadable file, a shape other than (sample_N, num_blocks, 4),
    a checkpoint fingerprint that is missing or differs, a `bf16_tail`
    other than the calibration's, and (with `cfg`) a predictor other than
    ancestral or a corrector. `static_file` names the table explicitly and
    skips the fingerprint binding.
    """

    def refuse(why):
        raise RuntimeError(
            f"[int8-static] {why} — calibrate this checkpoint and scheme "
            "(calibrate_act_scales + save_act_scales), or serve with "
            "dynamic scales")

    if static_file:
        path = static_file
    elif ckpt_path is None:
        refuse("no restored checkpoint to locate calibration scales")
    else:
        path = act_scales_path(ckpt_path)
    if not os.path.exists(path):
        refuse(f"no calibration file {path}")
    try:
        data = np.load(path)
        scales = data["scales"]
        meta = json.loads(str(data["meta"])) if "meta" in data else {}
    except Exception as e:
        refuse(f"unreadable calibration file {path} ({e})")
    if scales.shape != (sample_N, num_blocks, 4):
        refuse(f"calibration shape {scales.shape} does not match the "
               f"running sampler ({sample_N}, {num_blocks}, 4)")
    if not static_file and meta.get("checkpoint") != _ckpt_fingerprint(
            ckpt_path):
        refuse(f"calibration in {path} is not bound to this checkpoint's "
               "content (missing or mismatched fingerprint)")
    if int(meta.get("bf16_tail", 0)) != int(bf16_tail):
        refuse(f"scales calibrated under bf16_tail="
               f"{meta.get('bf16_tail', 0)} but serving with "
               f"bf16_tail={bf16_tail}")
    if cfg is not None:
        pred = str(cfg.sde.predictor)
        cal_pred = str(meta.get("predictor", "ancestral"))
        if pred != cal_pred or pred != "ancestral":
            refuse(f"scales calibrated for predictor={cal_pred} but "
                   f"serving predictor={pred} (static int8 is "
                   "ancestral-only)")
        if getattr(cfg.sde, "corrector", None):
            refuse("static int8 scales are calibrated without a "
                   f"corrector; config has corrector={cfg.sde.corrector}")
    return torch.from_numpy(np.asarray(scales, np.float32))


# --------------------------------------------------------------------------
# Golden-gate stamps: a JSON list of verdicts per (checkpoint content,
# sampler config) next to the checkpoint. Serving int8 checks for a matching
# PASSED entry and warns, or raises when `strict`.

def _ckpt_fingerprint(ckpt_path: str) -> Dict[str, Any]:
    """Size + sha256 of the first and last 4 MB of a checkpoint (every byte
    of a file up to 8 MB)."""
    h = hashlib.sha256()
    size = os.path.getsize(ckpt_path)
    chunk = 4 * 1024 * 1024
    with open(ckpt_path, "rb") as f:
        h.update(f.read(chunk))
        if size > chunk:
            tail = min(chunk, size - chunk)
            f.seek(size - tail)
            h.update(f.read(tail))
    return {"file": os.path.basename(ckpt_path), "size": size,
            "sha256_edges": h.hexdigest()}


def _sampler_signature(cfg, completion: bool, *, attn_int8: bool = False,
                       bf16_tail: int = 0,
                       static_act: bool = False) -> Dict[str, Any]:
    """The certified sampler config; the quantization-scheme knobs are part
    of it (the conditional sampler has no static-scale path, so
    `static_act` does not fork its certification)."""
    return {"completion": bool(completion),
            "sample_N": int(cfg.sde.sample_N),
            "predictor": str(cfg.sde.predictor),
            "sample_mode": str(cfg.sde.sample_mode),
            "sde_type": str(cfg.sde.sde_type),
            "attn_int8": bool(attn_int8),
            "bf16_tail": int(bf16_tail),
            "static_act": bool(static_act) and not completion}


def int8_serving_active(cfg, sample_mode: str, label=None, condition=None,
                        *, serve_int8: bool = False) -> bool:
    """True iff the UNCONDITIONAL sampler takes the W8A8 path: asked for,
    layer_norm, no label or condition, non-UNet AdaLN, a discrete
    schedule, and not PNDM."""
    return (serve_int8
            and cfg.score.norm == "layer_norm"
            and label is None and condition is None
            and not cfg.score.unet and cfg.score.AdaLN
            and sample_mode != "continuous"
            and cfg.sde.predictor != "pndm")


def int8_cond_serving_active(cfg, sample_mode: str, cond_present, *,
                             serve_int8: bool = False) -> bool:
    """True iff the CONDITIONAL (completion) sampler takes the W8A8 path:
    asked for, layer_norm, non-UNet AdaLN, a discrete schedule, not PNDM,
    and a condition present (`cond_present`: the encoded condition's tokens
    are not None, or at the gate check the condition is given)."""
    return (serve_int8
            and cfg.score.norm == "layer_norm"
            and not cfg.score.unet and cfg.score.AdaLN
            and sample_mode != "continuous"
            and cfg.sde.predictor != "pndm"
            and bool(cond_present))


def gate_stamp_path(ckpt_path: str) -> str:
    return ckpt_path + ".int8_gate.json"


def _load_stamp_entries(path: str):
    """Stamp entries on disk, or None when the file is unreadable."""
    try:
        with open(path) as f:
            stamp = json.load(f)
    except (OSError, ValueError):
        return None
    if isinstance(stamp, dict) and isinstance(stamp.get("entries"), list):
        return [e for e in stamp["entries"] if isinstance(e, dict)]
    if isinstance(stamp, dict):
        return [stamp]  # the single-entry format
    return None


def write_gate_stamp(ckpt_path: str, cfg, completion: bool, passed: bool,
                     results: Dict[str, Any], threshold: float, *,
                     attn_int8: bool = False, bf16_tail: int = 0,
                     static_act: bool = False) -> str:
    """Record a gate verdict: entries of the same sampler config are
    replaced, entries of other checkpoint content dropped; written
    atomically (tmp + rename)."""
    fp = _ckpt_fingerprint(ckpt_path)
    sig = _sampler_signature(cfg, completion, attn_int8=attn_int8,
                             bf16_tail=bf16_tail, static_act=static_act)
    entry = {"checkpoint": fp, "sampler": sig, "passed": bool(passed),
             "threshold": float(threshold), "results": results,
             "written": time.strftime("%Y-%m-%d %H:%M:%S")}
    path = gate_stamp_path(ckpt_path)
    entries = [e for e in _load_stamp_entries(path) or []
               if e.get("sampler") != sig and e.get("checkpoint") == fp]
    entries.append(entry)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"entries": entries}, f, indent=1)
    os.replace(tmp, path)
    return path


def verify_gate_stamp(ckpt_path: Optional[str], cfg, completion: bool, *,
                      strict: bool = False, attn_int8: bool = False,
                      bf16_tail: int = 0,
                      static_act: bool = False) -> Optional[str]:
    """Check the stamp of a checkpoint about to be served int8. Returns the
    problem (also printed), or None when a matching PASSED entry exists;
    with `strict` a problem raises."""
    problem = None
    stamp = None if ckpt_path is None else gate_stamp_path(ckpt_path)
    if ckpt_path is None:
        problem = ("int8 serving on a checkpoint of unknown origin — no "
                   "golden-gate stamp can be checked")
    elif not os.path.exists(stamp):
        problem = (f"no int8 golden-gate stamp next to {ckpt_path} — gate "
                   "this checkpoint first")
    else:
        entries = _load_stamp_entries(stamp)
        want_sig = _sampler_signature(cfg, completion, attn_int8=attn_int8,
                                      bf16_tail=bf16_tail,
                                      static_act=static_act)
        if entries is None:
            problem = (f"int8 gate stamp {stamp} is unreadable "
                       "(corrupt/truncated) — gate again")
        else:
            fp = _ckpt_fingerprint(ckpt_path)
            fresh = [e for e in entries if e.get("checkpoint") == fp]
            match = [e for e in fresh if e.get("sampler") == want_sig]
            if not fresh:
                problem = (f"checkpoint content changed since the gate ran "
                           f"({ckpt_path}) — gate again")
            elif not match:
                problem = ("int8 gate stamp certifies a different sampler "
                           f"config: stamped "
                           f"{[e.get('sampler') for e in fresh]} vs running "
                           f"{want_sig} — gate each config")
            elif not match[0].get("passed"):
                problem = (f"int8 golden gate FAILED for {ckpt_path} "
                           f"(stamp {stamp})")
    if problem is None:
        return None
    if strict:
        raise RuntimeError(f"[int8-gate] {problem} (strict)")
    print(f"[int8-gate] WARNING: {problem}; serving int8 anyway "
          "(strict=True to refuse)", flush=True)
    return problem
