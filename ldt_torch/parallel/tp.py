"""Tensor-parallel sharding rules, the 2-D mesh and the process group,
counterpart of `ldt_tpu/parallel/tp.py`.

The JAX package places its parameters with `NamedSharding`s and lets GSPMD
insert the collectives; here every rank holds its own shard as the
module's parameter, and the modules call the collectives themselves
(`nn.layers.Attention` and `MLP` under a registered mesh, `parallel.comm`).

Megatron pairing on each ResidualBlock (`tp.py:98-124` of the JAX
package): the attention's q, k, v projections and the MLP's up-projection
are column-parallel (a rank keeps its 1/m of the output features, bias
too); `fc_o` and the MLP's down-projection row-parallel (a rank keeps its
1/m of the input features; the bias is replicated and added after the
all_reduce over `model`). Everything else is replicated. The packed `qkv`
weight [3 D, D_in] is not cut into thirds: rank r keeps rows
[q_r; k_r; v_r], the q, k and v features of its own D/m slice (its own
heads when m divides the heads), so its local GEMM gives the [B, N, 3 D/m]
packed layout K1 reads (the JAX package splits `fc_kv` into k and v for the
same reason, `pallas_attention.py:697-706`); a separate `kv` weight keeps
[k_r; v_r].

`initialize_distributed()` joins the process group of a multi-process run
(`torchrun`'s environment or explicit arguments); `make_mesh` builds the
`data x model` DeviceMesh with `model` innermost.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from ldt_torch.parallel import comm


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: Optional[str] = None,
                           timeout_s: float = 600.0) -> bool:
    """Join the default process group when a multi-process run is described
    (arguments, else `torchrun`'s MASTER_ADDR, MASTER_PORT, WORLD_SIZE and
    RANK); returns whether it initialized. A no-op (False) when nothing
    describes one, or when the group exists already.

    The backend is named, never tried: `backend`, else `nccl` when the run
    is on CUDA and there are at least as many cards as local ranks (each
    rank its own card: `cuda:LOCAL_RANK` becomes the current device), else
    `gloo`. `device` ("cuda" or "cpu", default: "cuda" when a card is
    present) is what the run computes on."""
    if dist.is_initialized():
        return False
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None or rank is None:
        return False
    if init_method is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            return False
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if backend is None:
        own_card = (device == "cuda"
                    and torch.cuda.device_count() >= local_world)
        backend = "nccl" if own_card else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_mesh(model_parallel: int = 1, data_axis: str = "data",
              model_axis: str = "model"):
    """`data x model` DeviceMesh over every rank of the process group,
    `model` innermost (ranks 0..m-1 form the first model group); m = 1 is
    the 1-D data mesh with a model axis of 1. Raises ValueError when
    `model_parallel` does not divide the world, RuntimeError without a
    process group."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed() first")
    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide "
                         f"{n} ranks")
    return init_device_mesh(_mesh_device(), (n // model_parallel,
                                             model_parallel),
                            mesh_dim_names=(data_axis, model_axis))


def _mesh_device() -> str:
    """The DeviceMesh's device type: the backend's (nccl: cuda, gloo: cpu;
    a gloo group reduces CUDA tensors too)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def axis_size(mesh, axis: str) -> int:
    """The size of `axis` in `mesh` (1 when the mesh has no such axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_group(mesh, axis: str):
    """The process group of this rank along `axis` (None without one)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def axis_rank(mesh, axis: str) -> int:
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def has_model_axis(mesh) -> bool:
    return axis_size(mesh, "model") > 1


# The mesh attention shards over: the trainers register theirs at
# construction (`training.base.BaseTrainer`), and `shard_params` marks the
# modules it shards with it.
_TP_MESH = None


def set_tp_mesh(mesh) -> None:
    """Register (or clear, with None) the mesh attention shards over."""
    global _TP_MESH
    _TP_MESH = mesh


def attention_tp_mesh():
    """The registered mesh when it has a real model axis, else None."""
    return _TP_MESH if has_model_axis(_TP_MESH) else None


def tp_attention_supported(num_heads: int, dim: int, mesh) -> bool:
    """The JAX package's rule for its per-shard packed self-attention
    (`pallas_attention.py:726-733`): whole heads per model rank and a local
    width D/m that is a multiple of 128. Elsewhere the attention takes the
    gathered route (`nn.layers.Attention`)."""
    m = axis_size(mesh, "model")
    return m > 1 and num_heads % m == 0 and (dim // m) % 128 == 0


@dataclass(frozen=True)
class Shard:
    """A parameter's tensor-parallel layout: split along `dim` (of the torch
    tensor) into `parts` equal blocks, each block cut over `model` (rank r
    keeps the r-th 1/m of every block, in block order). parts 3 is the
    packed qkv, 2 a packed kv, 1 a plain column or row split."""
    dim: int
    parts: int = 1


@dataclass
class TPSlot:
    """What a sharded module needs at run time: the model group, this
    rank's place in it, and whether its self-attention runs per shard."""
    group: object
    rank: int
    size: int
    per_shard: bool = False


def _attention_specs(attn, m: int) -> Dict[str, Shard]:
    if attn.dim % m:
        return {}
    if hasattr(attn, "qkv"):
        specs = {"qkv.weight": Shard(0, 3), "qkv.bias": Shard(0, 3)}
    else:
        specs = {"q.weight": Shard(0), "q.bias": Shard(0),
                 "kv.weight": Shard(0, 2), "kv.bias": Shard(0, 2)}
    specs["fc_o.weight"] = Shard(1)
    return specs


def _mlp_specs(mlp, m: int) -> Dict[str, Shard]:
    if mlp.dense_0.out_features % m:
        return {}
    return {"dense_0.weight": Shard(0), "dense_0.bias": Shard(0),
            "dense_1.weight": Shard(1)}


def _sharded_modules(module: nn.Module, m: int):
    """(name, module, its specs) of every Attention and every
    ResidualBlock's MLP that the rules shard (the JAX rules' `fc_q`,
    `fc_kv`, `fc_o` and `mlp/Dense_0|1`)."""
    from ldt_torch.nn.layers import MLP, Attention, ResidualBlock

    mlps = {id(b.mlp) for b in module.modules()
            if isinstance(b, ResidualBlock)}
    for name, mod in module.named_modules():
        if isinstance(mod, Attention):
            specs = _attention_specs(mod, m)
        elif isinstance(mod, MLP) and id(mod) in mlps:
            specs = _mlp_specs(mod, m)
        else:
            continue
        if specs:
            yield name, mod, specs


def param_specs(module: nn.Module, mesh) -> Dict[str, Optional[Shard]]:
    """{parameter name: its Shard, or None (replicated)} over `module`'s
    `named_parameters()` (all None without a model axis)."""
    out = {k: None for k, _ in module.named_parameters()}
    m = axis_size(mesh, "model")
    if m == 1:
        return out
    for name, _, specs in _sharded_modules(module, m):
        for k, spec in specs.items():
            out[f"{name}.{k}" if name else k] = spec
    return out


def shard_tensor(t: torch.Tensor, spec: Optional[Shard], rank: int,
                 size: int) -> torch.Tensor:
    """This rank's shard of a full tensor (a copy; `t` itself when
    replicated)."""
    if spec is None or size == 1:
        return t
    blocks = t.chunk(spec.parts, dim=spec.dim)
    return torch.cat([b.chunk(size, dim=spec.dim)[rank] for b in blocks],
                     dim=spec.dim).contiguous()


def unshard_tensor(t: torch.Tensor, spec: Optional[Shard],
                   group) -> torch.Tensor:
    """The full tensor from every rank's shard (an all_gather over the
    model `group`); `t` itself when replicated."""
    size = comm.world_size(group)
    if spec is None or size == 1:
        return t
    parts = comm.all_gather(t, group, dim=spec.dim).chunk(size, dim=spec.dim)
    blocks = [p.chunk(spec.parts, dim=spec.dim) for p in parts]
    return torch.cat([blocks[r][i] for i in range(spec.parts)
                      for r in range(size)], dim=spec.dim)


@torch.no_grad()
def shard_params(module: nn.Module, mesh=None) -> Dict[str, Optional[Shard]]:
    """Shard `module` in place for `mesh` (default: the registered one,
    `attention_tp_mesh`): each parameter the rules shard is replaced by
    this rank's shard (a new Parameter), and the sharded Attention and MLP
    modules get their `tp` slot (the model group; the attention's
    `per_shard` where `tp_attention_supported`). Returns the specs
    (`param_specs`). A no-op without a model axis."""
    if mesh is None:
        mesh = attention_tp_mesh()
    specs = param_specs(module, mesh)
    if not has_model_axis(mesh):
        return specs
    m = axis_size(mesh, "model")
    group, r = axis_group(mesh, "model"), axis_rank(mesh, "model")
    from ldt_torch.nn.layers import Attention

    for name, mod, mod_specs in list(_sharded_modules(module, m)):
        for k, spec in mod_specs.items():
            owner_name, pname = k.rsplit(".", 1)
            owner = mod.get_submodule(owner_name)
            full = getattr(owner, pname)
            setattr(owner, pname, nn.Parameter(
                shard_tensor(full.data, spec, r, m),
                requires_grad=full.requires_grad))
        per_shard = (isinstance(mod, Attention) and hasattr(mod, "qkv")
                     and not mod.ref_merge
                     and tp_attention_supported(mod.num_heads, mod.dim,
                                                mesh))
        mod.tp = TPSlot(group, r, m, per_shard)
    return specs


def _shard_dict(tree, specs, r: int, m: int):
    if tree is None:
        return None
    return {k: shard_tensor(v, specs.get(k), r, m) for k, v in tree.items()}


@torch.no_grad()
def shard_train_state(state, module: nn.Module, mesh):
    """Shard a TrainState built over `module`'s full parameters, with the
    module itself (`shard_params`): the EMA and both Adam moments take the
    parameters' layout, the rest (step, count, batch statistics) stays
    replicated; `state.params` becomes the module's new parameters.
    Returns (state, specs)."""
    specs = param_specs(module, mesh)
    if not has_model_axis(mesh):
        return state, specs
    m, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
    state.ema_params = _shard_dict(state.ema_params, specs, r, m)
    state.opt_state.mu = _shard_dict(state.opt_state.mu, specs, r, m)
    state.opt_state.nu = _shard_dict(state.opt_state.nu, specs, r, m)
    shard_params(module, mesh)
    state.params = dict(module.named_parameters())
    return state, specs


def shard_tree(tree: dict, specs, mesh) -> dict:
    """A full tree of `TrainState.to_tree()`'s layout cut to this rank's
    shards (a restore under a mesh)."""
    m, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
    if m == 1:
        return tree
    out = dict(tree)
    for k in ("params", "ema_params"):
        out[k] = _shard_dict(tree.get(k), specs, r, m)
    opt = dict(tree["opt_state"])
    for k in ("mu", "nu"):
        opt[k] = _shard_dict(opt.get(k), specs, r, m)
    out["opt_state"] = opt
    return out


def gather_tree(tree: dict, specs, mesh) -> dict:
    """The full tree of a sharded `TrainState.to_tree()` (every rank takes
    part in the all_gathers; a checkpoint's rank 0 writes it)."""
    if not has_model_axis(mesh):
        return tree
    group = axis_group(mesh, "model")

    def full(d):
        if d is None:
            return None
        return {k: unshard_tensor(v, specs.get(k), group)
                for k, v in d.items()}

    out = dict(tree)
    out["params"] = full(tree["params"])
    out["ema_params"] = full(tree.get("ema_params"))
    opt = dict(tree["opt_state"])
    opt["mu"], opt["nu"] = full(opt["mu"]), full(opt["nu"])
    out["opt_state"] = opt
    return out


def gather_params(module: nn.Module, specs, mesh) -> Dict[str, torch.Tensor]:
    """The full state_dict of a sharded module (buffers as they are)."""
    sd = dict(module.state_dict())
    if not has_model_axis(mesh):
        return sd
    group = axis_group(mesh, "model")
    return {k: unshard_tensor(v, specs.get(k), group) for k, v in sd.items()}

