"""flax parameter trees (nested dicts of arrays) <-> torch state_dicts.

Layout rules, flax -> torch:
  * `Dense` kernel [in, out] -> `weight` [out, in]; bias as is
  * `attn/fc_q` + `attn/fc_kv` -> `attn.qkv` ([Wq | Wkv] stacked, so one
    GEMM gives the packed [q | k | v] that kernel K1 reads)
  * `LayerNorm_0`/`LayerNorm_1` scale, bias -> `norm1`/`norm2` weight, bias
  * `Dense_0`/`Dense_1` (TimeEmbedding, MLP) -> `dense_0`/`dense_1`
  * `transformer_<i>` / `decoder_<i>` / `encoder_<i>` -> `transformer.<i>` /
    `decoder.<i>` / `encoder.<i>`; `op<i>` -> `ops.<i>`
  * flax `BatchNorm` params scale, bias and `batch_stats` mean, var ->
    weight, bias, running_mean, running_var

A leaf that no rule maps raises. `compressor_decode_state_dict` converts the
decode half alone (what `generate` needs) and returns the paths it leaves.
The converters take any tree of the params' structure: a JAX gradient or an
Adam moment maps as the params do. `score_params` and
`compressor_variables` map back, torch -> flax, by the same rules (an entry
that no rule maps raises there too), keeping each tensor's dtype.
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


def _batch_norm(sd: dict, key: str, p: dict, stats: dict, path: str) -> None:
    p, stats = dict(p), dict(stats)
    sd[f"{key}.weight"] = _tensor(p.pop("scale"))
    sd[f"{key}.bias"] = _tensor(p.pop("bias"))
    sd[f"{key}.running_mean"] = _tensor(stats.pop("mean"))
    sd[f"{key}.running_var"] = _tensor(stats.pop("var"))
    _done(p, path)
    _done(stats, f"batch_stats/{path}")


def _dense_bn(sd: dict, key: str, p: dict, stats: dict, path: str,
              names) -> Tuple[dict, dict]:
    """The Dense and BatchNorm children `names` of one module; returns its
    params and batch_stats left over."""
    p, stats = dict(p), dict(stats)
    for name in names:
        if "bn" in name:
            _batch_norm(sd, f"{key}.{name}", _take(p, name, path),
                        _take(stats, name, f"batch_stats/{path}"),
                        f"{path}/{name}")
        else:
            _dense(sd, f"{key}.{name}", _take(p, name, path),
                   f"{path}/{name}")
    return p, stats


def compressor_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """`ldt_tpu` Compressor variables {'params', 'batch_stats'} -> the whole
    `ldt_torch.models.Compressor` state_dict (f32); every leaf is mapped."""
    p = dict(variables["params"])
    stats = dict(variables.get("batch_stats", {}))
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, "input_dense", _take(p, "input_dense", ""), "input_dense")
    if "conv_in" in p:
        act = dict(p.pop("conv_in"))
        for name in ("shift", "log_scale"):
            sd[f"conv_in.{name}"] = _tensor(act.pop(name))
        _done(act, "conv_in")
    group = _take(p, "group", "")
    for name in ("affine_alpha", "affine_beta"):
        if name in group:
            sd[f"group.{name}"] = _tensor(group.pop(name))
    group_stats = _take(stats, "group", "batch_stats")
    ext, ext_stats = _dense_bn(
        sd, "group.extraction", _take(group, "extraction", "group"),
        _take(group_stats, "extraction", "batch_stats/group"),
        "group/extraction", ("transfer_dense", "transfer_bn"))
    i = 0
    while f"op{i}" in ext:
        path = f"group/extraction/op{i}"
        rest, rest_stats = _dense_bn(
            sd, f"group.extraction.ops.{i}", ext.pop(f"op{i}"),
            _take(ext_stats, f"op{i}", "batch_stats/group/extraction"),
            path, ("net1_dense", "net1_bn", "net2_dense"))
        _done(rest, path)
        _done(rest_stats, f"batch_stats/{path}")
        i += 1
    _done(ext, "group/extraction")
    _done(ext_stats, "batch_stats/group/extraction")
    _done(group, "group")
    _done(group_stats, "batch_stats/group")
    pos, pos_stats = _dense_bn(
        sd, "pos_embedding", _take(p, "pos_embedding", ""),
        _take(stats, "pos_embedding", "batch_stats"), "pos_embedding",
        ("conv1", "bn1", "conv2", "bn2", "fc"))
    _done(pos, "pos_embedding")
    _done(pos_stats, "batch_stats/pos_embedding")
    i = 0
    while f"encoder_{i}" in p:
        path = f"encoder_{i}"
        enc = dict(p.pop(path))
        j = 0
        while f"att{j}" in enc:
            _residual_block(sd, f"encoder.{i}.att{j}", enc.pop(f"att{j}"),
                            f"{path}/att{j}")
            j += 1
        head = _take(enc, "conv_out", path)
        for name in ("adaLN", "ln"):
            _dense(sd, f"encoder.{i}.conv_out.{name}",
                   _take(head, name, f"{path}/conv_out"),
                   f"{path}/conv_out/{name}")
        _done(head, f"{path}/conv_out")
        _done(enc, path)
        i += 1
    i = 0
    while f"decoder_{i}" in p:
        path = f"decoder_{i}"
        blk = dict(p.pop(path))
        _residual_block(sd, f"decoder.{i}.att", _take(blk, "att", path),
                        f"{path}/att")
        _dense(sd, f"decoder.{i}.prior_dense",
               _take(blk, "prior_dense", path), f"{path}/prior_dense")
        p[path] = blk
        i += 1
    decode, left = compressor_decode_state_dict(p)
    if left:
        raise ValueError(f"unmapped flax leaves: {left}")
    _done(stats, "batch_stats")
    return {**sd, **decode}


def load_compressor(compressor: torch.nn.Module,
                    variables: dict) -> torch.nn.Module:
    """Load flax Compressor variables {'params', 'batch_stats'} into
    `compressor` (cast to its dtype and device)."""
    compressor.load_state_dict(compressor_state_dict(variables))
    return compressor


def load_score(score: torch.nn.Module, params: dict) -> torch.nn.Module:
    """Load flax Score params into `score` (cast to its dtype and device)."""
    score.load_state_dict(score_state_dict(params))
    return score


def load_compressor_decoder(compressor: torch.nn.Module,
                            params: dict) -> List[str]:
    """Load the decode half of flax Compressor params into `compressor`
    (its encode half keeps its weights); returns the flax leaf paths of the
    encode half, which `load_compressor` maps."""
    sd, left = compressor_decode_state_dict(params)
    missing, unexpected = compressor.load_state_dict(sd, strict=False)
    decode = [k for k in missing if is_decode_key(k)]
    if unexpected or decode:
        raise ValueError(f"decode-half state_dict mismatch: missing {decode}, "
                         f"unexpected {unexpected}")
    return left


def is_decode_key(key: str) -> bool:
    """Whether a Compressor state_dict key belongs to the decode half."""
    parts = key.split(".")
    return (parts[0] in ("output_dense", "init_set")
            or (parts[0] == "decoder" and parts[2] in ("att1", "ln")))


class _Entries:
    """A state_dict's entries, taken one by one by the inverse converters;
    `done` raises for any left."""

    def __init__(self, sd: Dict[str, torch.Tensor]):
        self.sd = dict(sd)

    def __contains__(self, key: str) -> bool:
        return key in self.sd

    def take(self, key: str) -> torch.Tensor:
        if key not in self.sd:
            raise ValueError(f"state_dict has no {key}")
        return self.sd.pop(key)

    def done(self) -> None:
        if self.sd:
            raise ValueError(f"unmapped state_dict entries: "
                             f"{sorted(self.sd)}")


def _dense_inv(e: _Entries, key: str) -> dict:
    return {"kernel": e.take(f"{key}.weight").T.contiguous(),
            "bias": e.take(f"{key}.bias")}


def _norm_inv(e: _Entries, key: str) -> dict:
    return {"scale": e.take(f"{key}.weight"), "bias": e.take(f"{key}.bias")}


def _two_dense_inv(e: _Entries, key: str) -> dict:
    return {f"Dense_{i}": _dense_inv(e, f"{key}.dense_{i}") for i in (0, 1)}


def _residual_block_inv(e: _Entries, key: str) -> dict:
    w = e.take(f"{key}.attn.qkv.weight")
    b = e.take(f"{key}.attn.qkv.bias")
    d = w.shape[0] // 3  # [Wq | Wkv]: fc_q has dim_out rows, fc_kv 2 dim_out
    out = {"attn": {
        "fc_q": {"kernel": w[:d].T.contiguous(), "bias": b[:d].clone()},
        "fc_kv": {"kernel": w[d:].T.contiguous(), "bias": b[d:].clone()},
        "fc_o": _dense_inv(e, f"{key}.attn.fc_o")},
        "mlp": _two_dense_inv(e, f"{key}.mlp")}
    for name, flax_name in (("norm1", "LayerNorm_0"),
                            ("norm2", "LayerNorm_1")):
        if f"{key}.{name}.weight" in e:
            out[flax_name] = _norm_inv(e, f"{key}.{name}")
    if f"{key}.adaLN.weight" in e:
        out["adaLN"] = _dense_inv(e, f"{key}.adaLN")
    return out


def score_params(sd: Dict[str, torch.Tensor]) -> dict:
    """`ldt_torch.models.Score` state_dict (or a tree of its structure: an
    Adam moment) -> `ldt_tpu` Score params."""
    e = _Entries(sd)
    p = {"ln_in": _dense_inv(e, "ln_in"),
         "time_embedding": _two_dense_inv(e, "time_embedding")}
    i = 0
    while f"transformer.{i}.attn.qkv.weight" in e:
        p[f"transformer_{i}"] = _residual_block_inv(e, f"transformer.{i}")
        i += 1
    p["ln_out"] = {"adaLN": _dense_inv(e, "ln_out.adaLN"),
                   "ln": _dense_inv(e, "ln_out.ln")}
    e.done()
    return p


def _dense_bn_inv(e: _Entries, key: str, names, stats: dict) -> dict:
    """The Dense and BatchNorm children `names` of one module: its params;
    the BatchNorms' running statistics, where `e` holds them, go to
    `stats`."""
    params = {}
    for name in names:
        if "bn" not in name:
            params[name] = _dense_inv(e, f"{key}.{name}")
            continue
        params[name] = _norm_inv(e, f"{key}.{name}")
        if f"{key}.{name}.running_mean" in e:
            stats[name] = {"mean": e.take(f"{key}.{name}.running_mean"),
                           "var": e.take(f"{key}.{name}.running_var")}
    return params


def compressor_variables(sd: Dict[str, torch.Tensor]) -> dict:
    """`ldt_torch.models.Compressor` state_dict -> `ldt_tpu` Compressor
    variables {'params', 'batch_stats'}; a tree of the parameters alone (an
    Adam moment) gives empty 'batch_stats'."""
    e = _Entries(sd)
    p = {"input_dense": _dense_inv(e, "input_dense")}
    if "conv_in.shift" in e:
        p["conv_in"] = {n: e.take(f"conv_in.{n}")
                        for n in ("shift", "log_scale")}
    group = {n: e.take(f"group.{n}") for n in ("affine_alpha", "affine_beta")
             if f"group.{n}" in e}
    ext_stats: dict = {}
    ext = _dense_bn_inv(e, "group.extraction",
                        ("transfer_dense", "transfer_bn"), ext_stats)
    i = 0
    while f"group.extraction.ops.{i}.net1_dense.weight" in e:
        op_stats: dict = {}
        ext[f"op{i}"] = _dense_bn_inv(
            e, f"group.extraction.ops.{i}",
            ("net1_dense", "net1_bn", "net2_dense"), op_stats)
        if op_stats:
            ext_stats[f"op{i}"] = op_stats
        i += 1
    group["extraction"] = ext
    p["group"] = group
    stats: dict = {}
    if ext_stats:
        stats["group"] = {"extraction": ext_stats}
    pos_stats: dict = {}
    p["pos_embedding"] = _dense_bn_inv(
        e, "pos_embedding", ("conv1", "bn1", "conv2", "bn2", "fc"),
        pos_stats)
    if pos_stats:
        stats["pos_embedding"] = pos_stats
    i = 0
    while f"encoder.{i}.att0.attn.qkv.weight" in e:
        enc, j = {}, 0
        while f"encoder.{i}.att{j}.attn.qkv.weight" in e:
            enc[f"att{j}"] = _residual_block_inv(e, f"encoder.{i}.att{j}")
            j += 1
        enc["conv_out"] = {n: _dense_inv(e, f"encoder.{i}.conv_out.{n}")
                           for n in ("adaLN", "ln")}
        p[f"encoder_{i}"] = enc
        i += 1
    i = 0
    while f"decoder.{i}.att.attn.qkv.weight" in e:
        key = f"decoder.{i}"
        p[f"decoder_{i}"] = {
            "att": _residual_block_inv(e, f"{key}.att"),
            "prior_dense": _dense_inv(e, f"{key}.prior_dense"),
            "att1": _residual_block_inv(e, f"{key}.att1"),
            "ln": _dense_inv(e, f"{key}.ln")}
        i += 1
    p["output_dense"] = _dense_inv(e, "output_dense")
    p["init_set"] = {"prior": e.take("init_set.prior")}
    e.done()
    return {"params": p, "batch_stats": stats}
