"""flax parameter trees (nested dicts of arrays) <-> torch state_dicts.

Layout rules, flax -> torch:
  * `Dense` kernel [in, out] -> `weight` [out, in]; bias as is
  * `attn/fc_q` + `attn/fc_kv` -> `attn.qkv` ([Wq | Wkv] stacked, so one
    GEMM gives the packed [q | k | v] that kernel K1 reads)
  * a block's norms `<Kind>_0`/`<Kind>_1` (LayerNorm, GroupNorm, BatchNorm)
    -> `norm1`/`norm2`, a head's `<Kind>_0` -> `norm`: scale, bias ->
    weight, bias
  * flax `BatchNorm` params scale, bias and `batch_stats` mean, var ->
    weight, bias, running_mean, running_var
  * `Dense_0`/`Dense_1` (TimeEmbedding, LabelEmbedding, MLP, the seed
    mixture) -> `dense_0`/`dense_1`; `Embed_0` embedding -> `embed.weight`
  * `transformer_<i>` / `decoder_<i>` / `encoder_<i>` -> `transformer.<i>` /
    `decoder.<i>` / `encoder.<i>`; `op<i>` -> `ops.<i>`; the UNet's
    `transformer_up_<i>` / `transformer_down_<i>` -> `transformer_up.<i>` /
    `transformer_down.<i>`
  * a block whose `fc_kv` reads another width than `fc_q` (a conditional
    UNet's down block) -> `attn.q` and `attn.kv`, unstacked
  * the conditional Score's `c_net`: flax `Conv` kernels [kh, kw, in, out]
    (HWIO) -> `weight` [out, in, kh, kw] (OIHW); a BasicBlock's `Conv_0`,
    `BatchNorm_0`, `Conv_1`, `BatchNorm_1` -> conv1, bn1, conv2, bn2
    (`downsample_conv` / `downsample_bn` as they are); its grouper as the
    Compressor's

A leaf that no rule maps raises. `compressor_decode_state_dict` converts the
decode half alone (what `generate` needs) and returns the paths it leaves.
The converters take any tree of the params' structure: a JAX gradient or an
Adam moment maps as the params do. `score_params` / `score_variables` and
`compressor_variables` map back, torch -> flax, by the same rules (an entry
that no rule maps raises there too), keeping each tensor's dtype. A
state_dict cannot tell a group norm's weight and bias from a layer norm's:
the inverse converters take the config's `norm` (a batch norm is told by
its running statistics).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_NORM_KINDS = ("LayerNorm", "GroupNorm", "BatchNorm")
_FLAX_NORM = {"layer_norm": "LayerNorm", "group_norm": "GroupNorm",
              "batch_norm": "BatchNorm"}
# the Dense children of a block that only some configurations have
_BLOCK_DENSE = ("adaLN", "adaLN1", "adaLN2", "shortcut", "pos_embedding")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: dict, key: str, p: dict, path: str) -> None:
    """A flax Conv without bias: kernel HWIO -> weight OIHW."""
    p = dict(p)
    sd[f"{key}.weight"] = _tensor(p.pop("kernel")).permute(3, 2, 0, 1
                                                           ).contiguous()
    _done(p, path)


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


def _norm(sd: dict, key: str, p: dict, stats: dict, path: str,
          index: int) -> None:
    """The norm `<Kind>_<index>` of the module `p` (popped), if it has one;
    a BatchNorm's statistics from `stats` (popped)."""
    for kind in _NORM_KINDS:
        name = f"{kind}_{index}"
        if name not in p:
            continue
        _layer_norm(sd, key, p.pop(name), f"{path}/{name}")
        if kind == "BatchNorm":
            st = _take(stats, name, f"batch_stats/{path}")
            sd[f"{key}.running_mean"] = _tensor(st.pop("mean"))
            sd[f"{key}.running_var"] = _tensor(st.pop("var"))
            _done(st, f"batch_stats/{path}/{name}")


def _two_dense(sd: dict, key: str, p: dict, path: str) -> None:
    p = dict(p)
    for i in (0, 1):
        _dense(sd, f"{key}.dense_{i}", _take(p, f"Dense_{i}", path),
               f"{path}/Dense_{i}")
    _done(p, path)


def _label_embedding(sd: dict, key: str, p: dict, path: str) -> None:
    p = dict(p)
    embed = _take(p, "Embed_0", path)
    sd[f"{key}.embed.weight"] = _tensor(embed.pop("embedding"))
    _done(embed, f"{path}/Embed_0")
    _two_dense(sd, key, p, path)


def _residual_block(sd: dict, key: str, p: dict, path: str,
                    stats: Optional[dict] = None) -> None:
    """One ResidualBlock; `stats` is its `batch_stats` subtree (BatchNorm
    norms)."""
    p, stats = dict(p), dict(stats or {})
    attn = _take(p, "attn", path)
    fq, fkv = _take(attn, "fc_q", path), _take(attn, "fc_kv", path)
    if np.shape(fq["kernel"])[0] != np.shape(fkv["kernel"])[0]:
        # keys and values of their own width: two weights
        _dense(sd, f"{key}.attn.q", fq, f"{path}/attn/fc_q")
        _dense(sd, f"{key}.attn.kv", fkv, f"{path}/attn/fc_kv")
        fq, fkv = {}, {}
    else:
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
    for i, name in enumerate(("norm1", "norm2")):
        _norm(sd, f"{key}.{name}", p, stats, path, i)
    for name in _BLOCK_DENSE:
        if name in p:
            _dense(sd, f"{key}.{name}", p.pop(name), f"{path}/{name}")
    _done(p, path)
    _done(stats, f"batch_stats/{path}")


def _final_layer(sd: dict, key: str, p: dict, path: str,
                 stats: Optional[dict] = None) -> None:
    p, stats = dict(p), dict(stats or {})
    if "adaLN" in p:
        _dense(sd, f"{key}.adaLN", p.pop("adaLN"), f"{path}/adaLN")
    _dense(sd, f"{key}.ln", _take(p, "ln", path), f"{path}/ln")
    _norm(sd, f"{key}.norm", p, stats, path, 0)
    _done(p, path)
    _done(stats, f"batch_stats/{path}")


def score_state_dict(params: dict, batch_stats: Optional[dict] = None
                     ) -> Dict[str, torch.Tensor]:
    """`ldt_tpu` Score params (and, with batch-norm norms, its
    `batch_stats`) -> `ldt_torch.models.Score` state_dict (f32)."""
    p, stats = dict(params), dict(batch_stats or {})
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, "ln_in", _take(p, "ln_in", ""), "ln_in")
    _two_dense(sd, "time_embedding", _take(p, "time_embedding", ""),
               "time_embedding")
    if "label_embedding" in p:
        _label_embedding(sd, "label_embedding", p.pop("label_embedding"),
                         "label_embedding")
    for name in ("transformer", "transformer_up", "transformer_down"):
        i = 0
        while f"{name}_{i}" in p:
            path = f"{name}_{i}"
            _residual_block(sd, f"{name}.{i}", p.pop(path), path,
                            stats.pop(path, None))
            i += 1
    if "transformer_mid" in p:
        _residual_block(sd, "transformer_mid", p.pop("transformer_mid"),
                        "transformer_mid", stats.pop("transformer_mid", None))
    _final_layer(sd, "ln_out", _take(p, "ln_out", ""), "ln_out",
                 stats.pop("ln_out", None))
    if "c_net" in p:
        _condition_net(sd, p.pop("c_net"), stats.pop("c_net", {}))
    _done(p, "")
    _done(stats, "batch_stats")
    return sd


_BASIC_BLOCK = (("Conv_0", "conv1"), ("BatchNorm_0", "bn1"),
                ("Conv_1", "conv2"), ("BatchNorm_1", "bn2"),
                ("downsample_conv", "downsample_conv"),
                ("downsample_bn", "downsample_bn"))
_TRUNK_LAYERS = ("layer1_0", "layer1_1", "layer2_0", "layer2_1")


def _conv_bn(sd: dict, key: str, p: dict, stats: dict, path: str,
             names) -> None:
    """The Conv and BatchNorm children of one trunk module, (flax name,
    torch name) pairs `names` (a missing one skipped); every leaf of `p`
    and `stats` must be taken."""
    p, stats = dict(p), dict(stats)
    for flax_name, name in names:
        if flax_name not in p:
            continue
        if "Conv" in flax_name or "conv" in flax_name:
            _conv(sd, f"{key}.{name}", p.pop(flax_name),
                  f"{path}/{flax_name}")
        else:
            _batch_norm(sd, f"{key}.{name}", p.pop(flax_name),
                        _take(stats, flax_name, f"batch_stats/{path}"),
                        f"{path}/{flax_name}")
    _done(p, path)
    _done(stats, f"batch_stats/{path}")


def _condition_net(sd: dict, p: dict, stats: dict) -> None:
    """The conditional Score's `c_net` (params `p`, batch_stats `stats`):
    the ResNet-18 trunk, `ln`, `pc_conv_in`, the grouper, `pc_conv_out`."""
    p, stats = dict(p), dict(stats)
    resnet = _take(p, "resnet", "c_net")
    resnet_stats = _take(stats, "resnet", "batch_stats/c_net")
    for layer in _TRUNK_LAYERS:
        _conv_bn(sd, f"c_net.resnet.{layer}", _take(resnet, layer,
                                                    "c_net/resnet"),
                 _take(resnet_stats, layer, "batch_stats/c_net/resnet"),
                 f"c_net/resnet/{layer}", _BASIC_BLOCK)
    _conv_bn(sd, "c_net.resnet", resnet, resnet_stats, "c_net/resnet",
             (("conv1", "conv1"), ("bn1", "bn1")))
    for name in ("ln", "pc_conv_in", "pc_conv_out"):
        _dense(sd, f"c_net.{name}", _take(p, name, "c_net"),
               f"c_net/{name}")
    _grouper(sd, "group", p, stats, "c_net.group")
    _done(p, "c_net")
    _done(stats, "batch_stats/c_net")


def _paths(tree, prefix: str) -> List[str]:
    if not isinstance(tree, dict):
        return [prefix]
    out = []
    for k in sorted(tree):
        out += _paths(tree[k], f"{prefix}/{k}" if prefix else k)
    return out


def _init_set(sd: dict, p: dict) -> None:
    init_set = _take(p, "init_set", "")
    for name in ("prior", "logits", "mu", "sig"):
        if name in init_set:
            sd[f"init_set.{name}"] = _tensor(init_set.pop(name))
    if "Dense_0" in init_set:  # the mixture of Gaussians' projection
        _two_dense(sd, "init_set", {k: init_set.pop(k)
                                    for k in ("Dense_0", "Dense_1")},
                   "init_set")
    _done(init_set, "init_set")


def compressor_decode_state_dict(params: dict,
                                 batch_stats: Optional[dict] = None
                                 ) -> Tuple[Dict[str, torch.Tensor],
                                            List[str]]:
    """`ldt_tpu` Compressor params (and the decode blocks' `batch_stats`,
    with batch-norm norms) -> (state_dict of the decode half, the flax leaf
    paths it leaves to `compressor_state_dict`: the encoder, the grouper,
    the posterior heads)."""
    p = dict(params)
    stats = dict(batch_stats or {})
    sd: Dict[str, torch.Tensor] = {}
    left: List[str] = []
    i = 0
    while f"decoder_{i}" in p:
        path = f"decoder_{i}"
        blk = dict(p.pop(path))
        blk_stats = dict(stats.pop(path, {}))
        _residual_block(sd, f"decoder.{i}.att1", _take(blk, "att1", path),
                        f"{path}/att1", blk_stats.pop("att1", None))
        _dense(sd, f"decoder.{i}.ln", _take(blk, "ln", path), f"{path}/ln")
        left += _paths(blk, path)  # att, prior_dense: compute_posterior
        left += _paths(blk_stats, f"batch_stats/{path}")
        i += 1
    _dense(sd, "output_dense", _take(p, "output_dense", ""), "output_dense")
    _init_set(sd, p)
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


def _grouper(sd: dict, key: str, p: dict, stats: dict,
             out: Optional[str] = None) -> None:
    """A LocalGrouper (`group`, `pre_grouper`) and its extraction stack,
    popped from `p` and `stats` under `key`, to the state_dict prefix `out`
    (default `key`)."""
    out = key if out is None else out
    group = _take(p, key, "")
    for name in ("affine_alpha", "affine_beta"):
        if name in group:
            sd[f"{out}.{name}"] = _tensor(group.pop(name))
    group_stats = _take(stats, key, "batch_stats")
    ext, ext_stats = _dense_bn(
        sd, f"{out}.extraction", _take(group, "extraction", key),
        _take(group_stats, "extraction", f"batch_stats/{key}"),
        f"{key}/extraction", ("transfer_dense", "transfer_bn"))
    i = 0
    while f"op{i}" in ext:
        path = f"{key}/extraction/op{i}"
        rest, rest_stats = _dense_bn(
            sd, f"{out}.extraction.ops.{i}", ext.pop(f"op{i}"),
            _take(ext_stats, f"op{i}", f"batch_stats/{key}/extraction"),
            path, ("net1_dense", "net1_bn", "net2_dense"))
        _done(rest, path)
        _done(rest_stats, f"batch_stats/{path}")
        i += 1
    _done(ext, f"{key}/extraction")
    _done(ext_stats, f"batch_stats/{key}/extraction")
    _done(group, key)
    _done(group_stats, f"batch_stats/{key}")


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
    for key in ("group", "pre_grouper"):
        if key in p:
            _grouper(sd, key, p, stats)
    pos = _take(p, "pos_embedding", "")
    if "Dense_0" in pos:  # pos_embedding: mlp
        _two_dense(sd, "pos_embedding", pos, "pos_embedding")
    else:
        pos, pos_stats = _dense_bn(
            sd, "pos_embedding", pos,
            _take(stats, "pos_embedding", "batch_stats"), "pos_embedding",
            ("conv1", "bn1", "conv2", "bn2", "fc"))
        _done(pos, "pos_embedding")
        _done(pos_stats, "batch_stats/pos_embedding")
    if "label_embedding" in p:
        _label_embedding(sd, "label_embedding", p.pop("label_embedding"),
                         "label_embedding")
    i = 0
    while f"encoder_{i}" in p:
        path = f"encoder_{i}"
        enc = dict(p.pop(path))
        enc_stats = dict(stats.pop(path, {}))
        j = 0
        while f"att{j}" in enc:
            _residual_block(sd, f"encoder.{i}.att{j}", enc.pop(f"att{j}"),
                            f"{path}/att{j}", enc_stats.pop(f"att{j}", None))
            j += 1
        _final_layer(sd, f"encoder.{i}.conv_out", _take(enc, "conv_out", path),
                     f"{path}/conv_out", enc_stats.pop("conv_out", None))
        _done(enc, path)
        _done(enc_stats, f"batch_stats/{path}")
        i += 1
    i = 0
    decoder_stats = {}
    while f"decoder_{i}" in p:
        path = f"decoder_{i}"
        blk = dict(p.pop(path))
        blk_stats = dict(stats.pop(path, {}))
        _residual_block(sd, f"decoder.{i}.att", _take(blk, "att", path),
                        f"{path}/att", blk_stats.pop("att", None))
        _dense(sd, f"decoder.{i}.prior_dense",
               _take(blk, "prior_dense", path), f"{path}/prior_dense")
        p[path] = blk
        decoder_stats[path] = blk_stats
        i += 1
    decode, left = compressor_decode_state_dict(p, decoder_stats)
    if left:
        raise ValueError(f"unmapped flax leaves: {left}")
    _done(stats, "batch_stats")
    return {**sd, **decode}


def load_compressor(compressor: torch.nn.Module,
                    variables: dict) -> torch.nn.Module:
    """Load flax Compressor variables {'params', 'batch_stats'} into
    `compressor` (cast to its parameters' dtype and device: f32 into a net
    that computes in bf16 over f32 parameters stays f32)."""
    compressor.load_state_dict(compressor_state_dict(variables))
    return compressor


def load_score(score: torch.nn.Module, params: dict) -> torch.nn.Module:
    """Load flax Score params into `score` (cast to its parameters' dtype
    and device: f32 into a net that computes in bf16 over f32 parameters
    stays f32)."""
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


def _norm_inv_into(e: _Entries, key: str, out: dict, stats: dict,
                   norm: str, index: int) -> None:
    """The norm `key` (if the state_dict has one) as flax's
    `<Kind>_<index>` in `out`, a BatchNorm's statistics in `stats`."""
    if f"{key}.weight" not in e:
        return
    if f"{key}.running_mean" in e:
        name = f"BatchNorm_{index}"
        stats[name] = {"mean": e.take(f"{key}.running_mean"),
                       "var": e.take(f"{key}.running_var")}
    else:
        name = f"{_FLAX_NORM[norm]}_{index}"
    out[name] = _norm_inv(e, key)


def _two_dense_inv(e: _Entries, key: str) -> dict:
    return {f"Dense_{i}": _dense_inv(e, f"{key}.dense_{i}") for i in (0, 1)}


def _label_embedding_inv(e: _Entries, key: str) -> dict:
    return {"Embed_0": {"embedding": e.take(f"{key}.embed.weight")},
            **_two_dense_inv(e, key)}


def _residual_block_inv(e: _Entries, key: str, stats: dict,
                        norm: str) -> dict:
    """One block's params; its BatchNorms' statistics go to `stats`."""
    if f"{key}.attn.q.weight" in e:  # keys and values of their own width
        attn = {"fc_q": _dense_inv(e, f"{key}.attn.q"),
                "fc_kv": _dense_inv(e, f"{key}.attn.kv")}
    else:
        w = e.take(f"{key}.attn.qkv.weight")
        b = e.take(f"{key}.attn.qkv.bias")
        d = w.shape[0] // 3  # [Wq | Wkv]: fc_q dim_out rows, fc_kv 2 dim_out
        attn = {"fc_q": {"kernel": w[:d].T.contiguous(),
                         "bias": b[:d].clone()},
                "fc_kv": {"kernel": w[d:].T.contiguous(),
                          "bias": b[d:].clone()}}
    attn["fc_o"] = _dense_inv(e, f"{key}.attn.fc_o")
    out = {"attn": attn, "mlp": _two_dense_inv(e, f"{key}.mlp")}
    for i, name in enumerate(("norm1", "norm2")):
        _norm_inv_into(e, f"{key}.{name}", out, stats, norm, i)
    for name in _BLOCK_DENSE:
        if f"{key}.{name}.weight" in e:
            out[name] = _dense_inv(e, f"{key}.{name}")
    return out


def _final_layer_inv(e: _Entries, key: str, stats: dict, norm: str) -> dict:
    out = {"ln": _dense_inv(e, f"{key}.ln")}
    if f"{key}.adaLN.weight" in e:
        out["adaLN"] = _dense_inv(e, f"{key}.adaLN")
    _norm_inv_into(e, f"{key}.norm", out, stats, norm, 0)
    return out


def _put(stats: dict, path: str, sub: dict) -> None:
    """`sub` as `stats[path]` when it holds anything."""
    if sub:
        stats[path] = sub


def score_variables(sd: Dict[str, torch.Tensor],
                    norm: str = "layer_norm") -> dict:
    """`ldt_torch.models.Score` state_dict (or a tree of its structure: an
    Adam moment) -> `ldt_tpu` Score variables {'params', 'batch_stats'};
    `norm` is the config's (`score.norm`)."""
    e = _Entries(sd)
    stats: dict = {}
    p = {"ln_in": _dense_inv(e, "ln_in"),
         "time_embedding": _two_dense_inv(e, "time_embedding")}
    if "label_embedding.embed.weight" in e:
        p["label_embedding"] = _label_embedding_inv(e, "label_embedding")
    for name in ("transformer", "transformer_up", "transformer_down"):
        i = 0
        while f"{name}.{i}.attn.fc_o.weight" in e:
            blk_stats: dict = {}
            p[f"{name}_{i}"] = _residual_block_inv(e, f"{name}.{i}",
                                                   blk_stats, norm)
            _put(stats, f"{name}_{i}", blk_stats)
            i += 1
    if "transformer_mid.attn.fc_o.weight" in e:
        blk_stats = {}
        p["transformer_mid"] = _residual_block_inv(e, "transformer_mid",
                                                   blk_stats, norm)
        _put(stats, "transformer_mid", blk_stats)
    head_stats: dict = {}
    p["ln_out"] = _final_layer_inv(e, "ln_out", head_stats, norm)
    _put(stats, "ln_out", head_stats)
    if "c_net.ln.weight" in e:
        c_stats: dict = {}
        p["c_net"] = _condition_net_inv(e, c_stats)
        _put(stats, "c_net", c_stats)
    e.done()
    return {"params": p, "batch_stats": stats}


def _conv_bn_inv(e: _Entries, key: str, names, stats: dict) -> dict:
    """The Conv and BatchNorm children of one trunk module ((flax name,
    torch name) pairs `names`, those the state_dict holds); the running
    statistics, where `e` holds them, go to `stats`."""
    params = {}
    for flax_name, name in names:
        if f"{key}.{name}.weight" not in e:
            continue
        if "Conv" in flax_name or "conv" in flax_name:
            params[flax_name] = {"kernel": e.take(
                f"{key}.{name}.weight").permute(2, 3, 1, 0).contiguous()}
            continue
        params[flax_name] = _norm_inv(e, f"{key}.{name}")
        if f"{key}.{name}.running_mean" in e:
            stats[flax_name] = {"mean": e.take(f"{key}.{name}.running_mean"),
                                "var": e.take(f"{key}.{name}.running_var")}
    return params


def _condition_net_inv(e: _Entries, stats: dict) -> dict:
    """The conditional Score's `c_net` params; its running statistics go to
    `stats`."""
    resnet_stats: dict = {}
    resnet = _conv_bn_inv(e, "c_net.resnet", (("conv1", "conv1"),
                                              ("bn1", "bn1")), resnet_stats)
    for layer in _TRUNK_LAYERS:
        layer_stats: dict = {}
        resnet[layer] = _conv_bn_inv(e, f"c_net.resnet.{layer}",
                                     _BASIC_BLOCK, layer_stats)
        _put(resnet_stats, layer, layer_stats)
    out = {"resnet": resnet}
    _put(stats, "resnet", resnet_stats)
    for name in ("ln", "pc_conv_in", "pc_conv_out"):
        out[name] = _dense_inv(e, f"c_net.{name}")
    _grouper_inv(e, "c_net.group", out, stats, "group")
    return out


def score_params(sd: Dict[str, torch.Tensor],
                 norm: str = "layer_norm") -> dict:
    """`ldt_torch.models.Score` state_dict (or a tree of its structure) ->
    `ldt_tpu` Score params; a Score with running statistics (batch-norm
    norms) needs `score_variables`."""
    v = score_variables(sd, norm)
    if v["batch_stats"]:
        raise ValueError("the state_dict holds running statistics: convert "
                         "it with score_variables")
    return v["params"]


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


def _grouper_inv(e: _Entries, key: str, p: dict, stats: dict,
                 name: Optional[str] = None) -> None:
    """The grouper under the state_dict prefix `key` as `p[name]` (default
    `key`), its statistics as `stats[name]`."""
    name = key if name is None else name
    group = {n: e.take(f"{key}.{n}") for n in ("affine_alpha", "affine_beta")
             if f"{key}.{n}" in e}
    ext_stats: dict = {}
    ext = _dense_bn_inv(e, f"{key}.extraction",
                        ("transfer_dense", "transfer_bn"), ext_stats)
    i = 0
    while f"{key}.extraction.ops.{i}.net1_dense.weight" in e:
        op_stats: dict = {}
        ext[f"op{i}"] = _dense_bn_inv(
            e, f"{key}.extraction.ops.{i}",
            ("net1_dense", "net1_bn", "net2_dense"), op_stats)
        _put(ext_stats, f"op{i}", op_stats)
        i += 1
    group["extraction"] = ext
    p[name] = group
    if ext_stats:
        stats[name] = {"extraction": ext_stats}


def compressor_variables(sd: Dict[str, torch.Tensor],
                         norm: str = "layer_norm") -> dict:
    """`ldt_torch.models.Compressor` state_dict -> `ldt_tpu` Compressor
    variables {'params', 'batch_stats'}; a tree of the parameters alone (an
    Adam moment) gives empty 'batch_stats'. `norm` is the config's
    (`model.norm`)."""
    e = _Entries(sd)
    stats: dict = {}
    p = {"input_dense": _dense_inv(e, "input_dense")}
    if "conv_in.shift" in e:
        p["conv_in"] = {n: e.take(f"conv_in.{n}")
                        for n in ("shift", "log_scale")}
    for key in ("group", "pre_grouper"):
        if f"{key}.extraction.transfer_dense.weight" in e:
            _grouper_inv(e, key, p, stats)
    if "pos_embedding.dense_0.weight" in e:
        p["pos_embedding"] = _two_dense_inv(e, "pos_embedding")
    else:
        pos_stats: dict = {}
        p["pos_embedding"] = _dense_bn_inv(
            e, "pos_embedding", ("conv1", "bn1", "conv2", "bn2", "fc"),
            pos_stats)
        _put(stats, "pos_embedding", pos_stats)
    if "label_embedding.embed.weight" in e:
        p["label_embedding"] = _label_embedding_inv(e, "label_embedding")
    i = 0
    while f"encoder.{i}.att0.attn.qkv.weight" in e:
        enc, enc_stats, j = {}, {}, 0
        while f"encoder.{i}.att{j}.attn.qkv.weight" in e:
            blk_stats: dict = {}
            enc[f"att{j}"] = _residual_block_inv(
                e, f"encoder.{i}.att{j}", blk_stats, norm)
            _put(enc_stats, f"att{j}", blk_stats)
            j += 1
        head_stats: dict = {}
        enc["conv_out"] = _final_layer_inv(e, f"encoder.{i}.conv_out",
                                           head_stats, norm)
        _put(enc_stats, "conv_out", head_stats)
        p[f"encoder_{i}"] = enc
        _put(stats, f"encoder_{i}", enc_stats)
        i += 1
    i = 0
    while f"decoder.{i}.att.attn.qkv.weight" in e:
        key = f"decoder.{i}"
        att_stats: dict = {}
        att1_stats: dict = {}
        p[f"decoder_{i}"] = {
            "att": _residual_block_inv(e, f"{key}.att", att_stats, norm),
            "prior_dense": _dense_inv(e, f"{key}.prior_dense"),
            "att1": _residual_block_inv(e, f"{key}.att1", att1_stats, norm),
            "ln": _dense_inv(e, f"{key}.ln")}
        dec_stats: dict = {}
        _put(dec_stats, "att", att_stats)
        _put(dec_stats, "att1", att1_stats)
        _put(stats, f"decoder_{i}", dec_stats)
        i += 1
    p["output_dense"] = _dense_inv(e, "output_dense")
    init_set = {n: e.take(f"init_set.{n}")
                for n in ("prior", "logits", "mu", "sig")
                if f"init_set.{n}" in e}
    if "init_set.dense_0.weight" in e:
        init_set.update(_two_dense_inv(e, "init_set"))
    p["init_set"] = init_set
    e.done()
    return {"params": p, "batch_stats": stats}
