"""Reference checkpoints -> the port's state_dicts and `checkpt_{epoch}.pt`,
counterpart of `ldt_tpu/tools/port.py` (its rule tables, copied).

The reference (Negai-98/LDT) saves `torch.save` dicts with `state_dict`
(Compressor checkpoints) or `score_state_dict` + `compressor_state_dict`
(stage-2 dual checkpoints). Each reference key is matched against the rule
tables (module path regex -> the JAX package's module path and a leaf
transform) into the parameter tree the JAX package's converter gives, which
`ldt_torch.weights` then maps to the port's state_dict, by the same rules
as a JAX checkpoint:

  * `port_compressor(sd)` / `port_score(sd)` -> the port's state_dicts;
  * `port_ema(sd, optim_state)` -> the EMA shadow state_dict, where the
    reference's EMA(Adam) keeps one;
  * `port_checkpoint(path, out)` / `python -m ldt_torch.tools.port`: a
    whole file into the port's `checkpt_{epoch}.pt` (no optimizer
    moments; stage 1 -> {"state": params, batch_stats}, read by stage 2's
    `load_pretrain`; stage 2 -> {"score": params, ema_params,
    "compressor": state_dict}, resumed with `--strict False`).

Leaf transforms: Conv1d(k=1) [out, in, 1] and Linear [out, in] become the
port's Dense weight [out, in] (through the JAX kernel [in, out]); BatchNorm
weight/bias and running statistics become the port's BatchNorm parameters
and buffers; LayerNorm weight/bias as they are; Embedding weight ->
`embed.weight`; the buffers `initialized` and `num_batches_tracked` are
dropped. The conditional Score (ConditionNet, its ResNet trunk) and the UNet
Score have no module in the port yet (ROADMAP Queue 1 #9): their keys raise
NotImplementedError.

The reference merges attention heads with `(w @ v).reshape(B, N, C)` on a
[B, H, N, dh] tensor, a token/channel scramble that no weight layout
absorbs: build the nets that run ported weights with `ref_merge=True`
(`Score(cfg, ref_merge=True)`, `Compressor(cfg, ref_merge=True)`).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from ldt_torch.training.checkpoint import save_checkpoint
from ldt_torch.weights import compressor_state_dict, score_state_dict

# ----------------------------------------------------------- leaf transforms


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v)


def _conv1(name: str, v):
    if name == "weight":
        return "kernel", _np(v)[:, :, 0].T
    return name, _np(v)


def _linear(name: str, v):
    if name == "weight":
        return "kernel", _np(v).T
    return name, _np(v)


def _layernorm(name: str, v):
    return ("scale" if name == "weight" else name), _np(v)


def _embed(name: str, v):
    return ("embedding" if name == "weight" else name), _np(v)


def _direct(name: str, v):
    return name, _np(v)


_KINDS = {"conv1": _conv1, "linear": _linear, "layernorm": _layernorm,
          "embed": _embed, "direct": _direct}

# BatchNorm splits across collections:
_BN_PARAMS = {"weight": "scale", "bias": "bias"}
_BN_STATS = {"running_mean": "mean", "running_var": "var"}

_DROP_LEAVES = {"num_batches_tracked", "initialized"}

# ------------------------------------------------------------- module rules

# A reference ResidualBlock.
_BLOCK_INNER = [
    (r"^(fc_q|fc_kv|fc_o)$", r"attn/\1", "conv1"),
    (r"^adaLN\.1$", "adaLN", "linear"),
    (r"^adaLN1\.1$", "adaLN1", "linear"),
    (r"^adaLN2\.1$", "adaLN2", "linear"),
    (r"^pos_embedding\.1$", "pos_embedding", "linear"),
    (r"^norm1\.norm$", "LayerNorm_0", "layernorm"),
    (r"^norm2\.norm$", "LayerNorm_1", "layernorm"),
    (r"^mlp\.fc\.0\.0$", "mlp/Dense_0", "conv1"),
    (r"^mlp\.out$", "mlp/Dense_1", "conv1"),
    (r"^shortcut$", "shortcut", "conv1"),
]

# FinalLayer
_FINAL_INNER = [
    (r"^adaLN\.1$", "adaLN", "linear"),
    (r"^ln$", "ln", "conv1"),
]

# TimeEmbedding / LabelEmbedding
_TIME_INNER = [
    (r"^mlp\.0$", "Dense_0", "linear"),
    (r"^mlp\.2$", "Dense_1", "linear"),
]
_LABEL_INNER = [
    (r"^label_emb$", "Embed_0", "embed"),
    (r"^mlp\.0$", "Dense_0", "linear"),
    (r"^mlp\.2$", "Dense_1", "linear"),
]

# LocalGrouper and its PreExtraction / ConvBNReLURes1D stack
_GROUPER_INNER = [
    (r"^(affine_alpha|affine_beta)$", r"\1", "direct"),
    (r"^extraction\.transfer\.net\.0$", "extraction/transfer_dense", "conv1"),
    (r"^extraction\.transfer\.net\.1$", "extraction/transfer_bn", "bn"),
    (r"^extraction\.operation\.(\d+)\.net1\.0$",
     r"extraction/op\1/net1_dense", "conv1"),
    (r"^extraction\.operation\.(\d+)\.net1\.1$",
     r"extraction/op\1/net1_bn", "bn"),
    (r"^extraction\.operation\.(\d+)\.net2\.0$",
     r"extraction/op\1/net2_dense", "conv1"),
    (r"^extraction\.operation\.(\d+)\.net2\.1$",
     r"extraction/op\1/net2_bn", "bn"),
]

# MiniPointnet
_MINIPOINTNET_INNER = [
    (r"^conv1$", "conv1", "conv1"),
    (r"^conv2$", "conv2", "conv1"),
    (r"^bn1$", "bn1", "bn"),
    (r"^bn2$", "bn2", "bn"),
    (r"^fc$", "fc", "linear"),
]


def _prefix(rules, pat, repl):
    """Scope `rules` under a reference prefix regex and a prefix template;
    backreferences of an inner template are renumbered past the prefix's
    capture groups."""
    shift = re.compile(pat).groups
    out = []
    for r, t, k in rules:
        t_shifted = re.sub(r"\\(\d+)",
                           lambda m: "\\" + str(int(m.group(1)) + shift), t)
        out.append((pat + r"\." + r.lstrip("^"), repl + "/" + t_shifted, k))
    return out


COMPRESSOR_RULES = (
    [
        (r"^input$", "input_dense", "conv1"),
        (r"^output$", "output_dense", "conv1"),
        (r"^conv_in$", "conv_in", "direct"),  # ActNorm shift/log_scale
        (r"^decoder\.(\d+)\.prior\.1$", r"decoder_\1/prior_dense", "conv1"),
        (r"^decoder\.(\d+)\.ln$", r"decoder_\1/ln", "conv1"),
        (r"^init_set\.(\w+)$", r"init_set/\1", "direct"),
    ]
    + _prefix(_BLOCK_INNER, r"^encoder\.(\d+)\.atts\.(\d+)",
              r"encoder_\1/att\2")
    + _prefix(_FINAL_INNER, r"^encoder\.(\d+)\.conv_out",
              r"encoder_\1/conv_out")
    + _prefix(_BLOCK_INNER, r"^decoder\.(\d+)\.(att1?)", r"decoder_\1/\2")
    + _prefix(_GROUPER_INNER, r"^group", "group")
    + _prefix(_GROUPER_INNER, r"^pre_grouper", "pre_grouper")
    + _prefix(_MINIPOINTNET_INNER, r"^pos_embedding", "pos_embedding")
    + _prefix(_LABEL_INNER, r"^LabelEmbedding", "label_embedding")
)

SCORE_RULES = (
    [
        (r"^ln_in$", "ln_in", "conv1"),
    ]
    + _prefix(_BLOCK_INNER, r"^Transformer\.(\d+)", r"transformer_\1")
    + _prefix(_FINAL_INNER, r"^ln_out", "ln_out")
    + _prefix(_TIME_INNER, r"^TimeEmbedding", "time_embedding")
    + _prefix(_LABEL_INNER, r"^LabelEmbedding", "label_embedding")
)

# reference modules with no counterpart in the port yet
_NOT_PORTED = [
    (r"^c_net\.", "the conditional Score's ConditionNet (with its ResNet "
     "trunk)"),
    (r"^Transformer_(Up|Mid|Down)\b", "the UNet Score"),
]

# ------------------------------------------------------------------- engine


def _insert(tree: Dict[str, Any], path: str, leaf_name: str, value) -> None:
    node = tree
    for part in path.split("/"):
        node = node.setdefault(part, {})
    node[leaf_name] = value


def _refuse_unported(keys) -> None:
    for pat, what in _NOT_PORTED:
        hit = [k for k in keys if re.match(pat, k)]
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP Queue 1 #9): no module "
                f"receives {hit[0]}" + (f" (+{len(hit) - 1} more keys)"
                                        if len(hit) > 1 else ""))


def _port(sd: Dict[str, Any], rules) -> Dict[str, Any]:
    """A reference state_dict -> {'params', 'batch_stats'} in the JAX
    package's layout (numpy leaves); an unmatched key raises."""
    _refuse_unported(sd)
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    unmatched = []
    for key, value in sd.items():
        module, _, leaf = key.rpartition(".")
        if not module:
            module, leaf = key, ""
        if leaf in _DROP_LEAVES:
            continue
        for pat, repl, kind in rules:
            m = re.match(pat + "$", module)
            if m is not None:
                module_key, leaf_key = module, leaf
            else:
                # direct params (`group.affine_alpha`) carry no leaf
                # suffix: the whole key is the module path
                m = re.match(pat + "$", key)
                if m is None:
                    continue
                module_key, leaf_key = key, None
            target = m.expand(repl)
            if leaf_key is None:
                path, _, name = target.rpartition("/")
                _insert(params, path, name, _np(value))
            elif kind == "bn":
                if leaf_key in _BN_PARAMS:
                    _insert(params, target, _BN_PARAMS[leaf_key], _np(value))
                elif leaf_key in _BN_STATS:
                    _insert(batch_stats, target, _BN_STATS[leaf_key],
                            _np(value))
                else:
                    raise ValueError(f"unknown BatchNorm leaf: {key}")
            else:
                name, v = _KINDS[kind](leaf_key, value)
                _insert(params, target, name, v)
            break
        else:
            unmatched.append(key)
    if unmatched:
        raise ValueError(
            "unmapped reference keys (extend the rule table): "
            + ", ".join(unmatched[:10])
            + (f" ... (+{len(unmatched) - 10})" if len(unmatched) > 10
               else ""))
    return {"params": params, "batch_stats": batch_stats}


def port_compressor(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference Compressor state_dict -> the port's Compressor
    state_dict."""
    return compressor_state_dict(_port(state_dict, COMPRESSOR_RULES))


def port_score(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference Score state_dict -> the port's Score state_dict."""
    v = _port(state_dict, SCORE_RULES)
    return score_state_dict(v["params"], v["batch_stats"])


def port_ema(state_dict: Dict[str, Any], optim_state: Dict[str, Any],
             rules=None) -> Optional[Dict[str, torch.Tensor]]:
    """The EMA shadow parameters of a reference EMA(Adam) state, as the
    port's Score state_dict (`rules` SCORE_RULES, or COMPRESSOR_RULES for a
    Compressor's, whose running statistics are then the state_dict's).

    The reference keeps the shadows in the optimizer state under 'ema',
    indexed by parameter order: the i-th entry of optim_state['state'] is
    the i-th parameter (buffers excluded) of the state_dict. None if no
    shadows are stored."""
    rules = SCORE_RULES if rules is None else rules
    opt = optim_state.get("state", {})
    if not opt or "ema" not in next(iter(opt.values()), {}):
        return None
    param_keys = [k for k in state_dict
                  if k.rsplit(".", 1)[-1] not in _DROP_LEAVES
                  and "running_mean" not in k and "running_var" not in k]
    ema_sd = {}
    for i, key in enumerate(param_keys):
        entry = opt.get(i)
        if entry is None or "ema" not in entry:
            return None
        ema_sd[key] = entry["ema"]
    if rules is SCORE_RULES:
        return score_state_dict(_port(ema_sd, rules)["params"])
    stats = {k: v for k, v in state_dict.items()
             if "running_mean" in k or "running_var" in k}
    return compressor_state_dict(_port({**ema_sd, **stats}, rules))


def _parameters(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in sd.items() if "running_" not in k}


def port_checkpoint(path: str, out: Optional[str] = None,
                    with_ema: bool = True) -> Dict[str, Any]:
    """Convert a reference `.pth` checkpoint into the port's state tree,
    and write it to `out` (`checkpt_{epoch}.pt`, `training.checkpoint`) if
    given.

    A single-net checkpoint ('state_dict', a Compressor) becomes
    {'state': {'params', 'batch_stats'}}, which stage 2's `load_pretrain`
    reads. A dual one ('score_state_dict' + 'compressor_state_dict')
    becomes {'score': {'params', 'ema_params'}, 'compressor': state_dict}:
    the EMA from the reference's optimizer state, else the params (the
    trainers sample with the EMA); resume it with `--strict False` (no
    optimizer moments are ported)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "score_state_dict" in ckpt:
        score = port_score(ckpt["score_state_dict"])
        ema = None
        if with_ema and "score_optim_state_dict" in ckpt:
            ema = port_ema(ckpt["score_state_dict"],
                           ckpt["score_optim_state_dict"])
        tree = {"score": {"params": score,
                          "ema_params": ema if ema is not None
                          else {k: v.clone() for k, v in score.items()}},
                "compressor": port_compressor(
                    ckpt["compressor_state_dict"])}
    elif "state_dict" in ckpt:
        sd = port_compressor(ckpt["state_dict"])
        tree = {"state": {"params": _parameters(sd),
                          "batch_stats": {k: v for k, v in sd.items()
                                          if "running_" in k}}}
    else:
        raise ValueError(f"unrecognized reference checkpoint keys: "
                         f"{sorted(ckpt.keys())}")
    if out is not None:
        save_checkpoint(out, tree, cfg=None,
                        epoch=int(ckpt.get("epoch", 0)),
                        itr=int(ckpt.get("itr", 0)),
                        time=float(ckpt.get("time", 0.0)))
    return tree


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Convert a reference (Negai-98/LDT) torch checkpoint "
                    "into the port's checkpt_{epoch}.pt")
    p.add_argument("checkpoint", help="path to the reference .pth file")
    p.add_argument("--out", required=True, help="output .pt path")
    p.add_argument("--no-ema", action="store_true",
                   help="skip porting the EMA shadow parameters")
    args = p.parse_args(argv)
    tree = port_checkpoint(args.checkpoint, args.out,
                           with_ema=not args.no_ema)
    print(f"ported: {sorted(tree)} -> {args.out}")
    print("NOTE: build the nets that run these weights with "
          "ref_merge=True (Score(cfg, ref_merge=True), Compressor(cfg, "
          "ref_merge=True)) for the reference's outputs; resume with "
          "--strict False (no optimizer moments are ported).")


if __name__ == "__main__":
    main()
