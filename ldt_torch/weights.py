"""flax parameter trees (nested dicts of arrays) -> torch state_dicts.

Layout rules, flax -> torch:
  * `Dense` kernel [in, out] -> `weight` [out, in]; bias as is
  * `attn/fc_q` + `attn/fc_kv` -> `attn.qkv` ([Wq | Wkv] stacked, so one
    GEMM gives the packed [q | k | v] that kernel K1 reads)
  * `LayerNorm_0`/`LayerNorm_1` scale, bias -> `norm1`/`norm2` weight, bias
  * `Dense_0`/`Dense_1` (TimeEmbedding, MLP) -> `dense_0`/`dense_1`
  * `transformer_<i>` / `decoder_<i>` -> `transformer.<i>` / `decoder.<i>`

A leaf of a ported module that no rule maps raises. The Compressor's
encoder and posterior leaves, which this port does not run yet, are returned
as a list of paths instead.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _take(tree: dict, key: str, path: str) -> dict:
    if key not in tree:
        raise ValueError(f"flax tree has no {path}/{key}")
    return dict(tree.pop(key))


def _done(tree: dict, path: str) -> None:
    if tree:
        raise ValueError(f"unmapped flax leaves under {path}: "
                         f"{sorted(tree)}")


def _dense(sd: dict, key: str, p: dict, path: str) -> None:
    p = dict(p)
    sd[f"{key}.weight"] = _tensor(p.pop("kernel")).T.contiguous()
    sd[f"{key}.bias"] = _tensor(p.pop("bias"))
    _done(p, path)


def _layer_norm(sd: dict, key: str, p: dict, path: str) -> None:
    p = dict(p)
    sd[f"{key}.weight"] = _tensor(p.pop("scale"))
    sd[f"{key}.bias"] = _tensor(p.pop("bias"))
    _done(p, path)


def _two_dense(sd: dict, key: str, p: dict, path: str) -> None:
    p = dict(p)
    for i in (0, 1):
        _dense(sd, f"{key}.dense_{i}", _take(p, f"Dense_{i}", path),
               f"{path}/Dense_{i}")
    _done(p, path)


def _residual_block(sd: dict, key: str, p: dict, path: str) -> None:
    p = dict(p)
    attn = _take(p, "attn", path)
    fq, fkv = _take(attn, "fc_q", path), _take(attn, "fc_kv", path)
    sd[f"{key}.attn.qkv.weight"] = torch.cat(
        [_tensor(fq.pop("kernel")).T, _tensor(fkv.pop("kernel")).T]
    ).contiguous()
    sd[f"{key}.attn.qkv.bias"] = torch.cat(
        [_tensor(fq.pop("bias")), _tensor(fkv.pop("bias"))])
    _done(fq, f"{path}/attn/fc_q")
    _done(fkv, f"{path}/attn/fc_kv")
    _dense(sd, f"{key}.attn.fc_o", _take(attn, "fc_o", path),
           f"{path}/attn/fc_o")
    _done(attn, f"{path}/attn")
    _two_dense(sd, f"{key}.mlp", _take(p, "mlp", path), f"{path}/mlp")
    for flax_name, name in (("LayerNorm_0", "norm1"), ("LayerNorm_1", "norm2")):
        if flax_name in p:
            _layer_norm(sd, f"{key}.{name}", p.pop(flax_name),
                        f"{path}/{flax_name}")
    if "adaLN" in p:
        _dense(sd, f"{key}.adaLN", p.pop("adaLN"), f"{path}/adaLN")
    _done(p, path)


def score_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """`ldt_tpu` Score params -> `ldt_torch.models.Score` state_dict (f32)."""
    p = dict(params)
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, "ln_in", _take(p, "ln_in", ""), "ln_in")
    _two_dense(sd, "time_embedding", _take(p, "time_embedding", ""),
               "time_embedding")
    i = 0
    while f"transformer_{i}" in p:
        _residual_block(sd, f"transformer.{i}", p.pop(f"transformer_{i}"),
                        f"transformer_{i}")
        i += 1
    head = _take(p, "ln_out", "")
    _dense(sd, "ln_out.adaLN", _take(head, "adaLN", "ln_out"), "ln_out/adaLN")
    _dense(sd, "ln_out.ln", _take(head, "ln", "ln_out"), "ln_out/ln")
    _done(head, "ln_out")
    _done(p, "")
    return sd


def _paths(tree, prefix: str) -> List[str]:
    if not isinstance(tree, dict):
        return [prefix]
    out = []
    for k in sorted(tree):
        out += _paths(tree[k], f"{prefix}/{k}" if prefix else k)
    return out


def compressor_decode_state_dict(params: dict
                                 ) -> Tuple[Dict[str, torch.Tensor],
                                            List[str]]:
    """`ldt_tpu` Compressor params -> (state_dict of the decode half,
    the flax leaf paths it leaves for a later slice: the encoder, the
    grouper, the posterior heads)."""
    p = dict(params)
    sd: Dict[str, torch.Tensor] = {}
    left: List[str] = []
    i = 0
    while f"decoder_{i}" in p:
        path = f"decoder_{i}"
        blk = dict(p.pop(path))
        _residual_block(sd, f"decoder.{i}.att1", _take(blk, "att1", path),
                        f"{path}/att1")
        _dense(sd, f"decoder.{i}.ln", _take(blk, "ln", path), f"{path}/ln")
        left += _paths(blk, path)  # att, prior_dense: compute_posterior
        i += 1
    _dense(sd, "output_dense", _take(p, "output_dense", ""), "output_dense")
    init_set = _take(p, "init_set", "")
    sd["init_set.prior"] = _tensor(init_set.pop("prior"))
    _done(init_set, "init_set")
    left += _paths(p, "")
    return sd, left


def load_score(score: torch.nn.Module, params: dict) -> torch.nn.Module:
    """Load flax Score params into `score` (cast to its dtype and device)."""
    score.load_state_dict(score_state_dict(params))
    return score


def load_compressor_decoder(compressor: torch.nn.Module,
                            params: dict) -> List[str]:
    """Load the decode half of flax Compressor params into `compressor`;
    returns the flax leaf paths left for a later slice."""
    sd, left = compressor_decode_state_dict(params)
    compressor.load_state_dict(sd)
    return left
