"""A multi-process dry run of the port's parallelism, counterpart of
`__graft_entry__.py::dryrun_multichip` and of `scripts/dcn_dryrun.py`'s
launcher.

    python -m ldt_torch.entries.dryrun_multichip --launch --ranks 4 \
        --model-parallel 2 [--device cuda|cpu] [--job dryrun]

spawns the ranks (a `file://` rendezvous under `--workdir`, default a new
temporary directory; the backend as `initialize_distributed` names it:
`nccl` where each rank has a card of its own, else `gloo`), and each rank
runs the job and prints one OK line. The ranks run on the card unless
`--device cpu` asks for the CPU; with no card that raises. Without
`--launch` the process is one rank of a run that `torchrun` started (its
environment describes the group).

Jobs:
  * `dryrun` (the default): over the `data x model` mesh, a tiny DP+TP
    stage-2 step through the trainer, a sequence-parallel decode, the
    tensor-parallel attention at the flagship width (D=1024, 16 heads, 32
    tokens) against the whole-width kernel, an int8 sampler scan on each
    data rank's rows, and a sharded eval tile.
  * `parallel_test`: the rank workers of `tests/test_torch_port_parallel.py`
    (inputs from `<workdir>/inputs.pt`, results to `<workdir>/results.pt`
    by rank 0).
`chip_smoke.py`'s phase 28 launches its own job function through `launch`.
The workers live here, so the spawned ranks import the port alone.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from ldt_torch import resolve_device
from ldt_torch.parallel import comm
from ldt_torch.parallel.mesh import (
    data_mesh,
    device_put_host,
    replicate,
    shard_batch,
    shard_leading_axis,
)
from ldt_torch.parallel.tp import (
    axis_group,
    axis_rank,
    axis_size,
    gather_params,
    initialize_distributed,
    make_mesh,
    shard_params,
)

# ---------------------------------------------------------------------------
# launching
# ---------------------------------------------------------------------------


def launch(job="dryrun", ranks: int = 4, model_parallel: int = 2,
           device: str = "cuda", workdir: str | None = None,
           timeout_s: float = 600.0) -> str:
    """Run `job` (a name of JOBS, or a function of the job's context that
    the spawned ranks can import) on `ranks` spawned processes (one
    rendezvous file under `workdir`; a collective that waits longer than
    `timeout_s` fails); raises when any rank fails. Returns the
    workdir."""
    import torch.multiprocessing as mp

    resolve_device(device)
    workdir = workdir or tempfile.mkdtemp(prefix="ldt_dryrun_")
    os.makedirs(workdir, exist_ok=True)
    init = os.path.join(workdir, "rendezvous")
    if os.path.exists(init):
        os.remove(init)
    mp.start_processes(_rank_main, nprocs=ranks, join=True,
                       start_method="spawn",
                       args=(ranks, init, job, model_parallel, device,
                             workdir, timeout_s))
    return workdir


def _rank_main(rank: int, world: int, init: str, job,
               model_parallel: int, device: str, workdir: str,
               timeout_s: float) -> None:
    torch.set_num_threads(1)  # the ranks share the host's cores
    initialize_distributed(init_method=f"file://{init}", world_size=world,
                           rank=rank, device=device, timeout_s=timeout_s)
    try:
        run_job(job, model_parallel, device, workdir)
    finally:
        dist.destroy_process_group()


def run_job(job, model_parallel: int, device: str, workdir: str):
    """Run `job` (a name of JOBS or a function) on this rank of the
    initialized process group."""
    ctx = SimpleNamespace(rank=dist.get_rank(), world=dist.get_world_size(),
                          mp=model_parallel, device=resolve_device(device),
                          backend=dist.get_backend(), workdir=workdir)
    if ctx.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = (JOBS[job] if isinstance(job, str) else job)(ctx)
    dist.barrier()
    return out


def mesh_for(model_parallel: int):
    """The trainers' mesh for `model_parallel` (`training.base.build_mesh`),
    registered for the eval, the decode and the attention."""
    from ldt_torch.training.base import register_mesh

    mesh = make_mesh(model_parallel) if model_parallel > 1 else data_mesh()
    register_mesh(mesh)
    return mesh


def mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# ---------------------------------------------------------------------------
# launch records
# ---------------------------------------------------------------------------

# (module, name) of each kernel wrapper on the parallel path
KERNELS = {
    "K1": ("ldt_torch.ops.attention", "packed_self_attention"),
    "K3": ("ldt_torch.ops.attention", "packed_self_attention_bwd"),
    "K2": ("ldt_torch.ops.attention", "cross_attention"),
    "K4": ("ldt_torch.ops.attention", "cross_attention_bwd"),
    "K5": ("ldt_torch.ops.chamfer", "pairwise_cd_means"),
    "K6/K7": ("ldt_torch.ops.emd", "approx_match_cost"),
}


def _wrappers():
    import importlib

    return {kid: getattr(importlib.import_module(mod), name)
            for kid, (mod, name) in KERNELS.items()}


def reset_launches() -> None:
    """Zero each wrapper's launch count and the records by shape."""
    from ldt_torch.ops import _build

    for fn in _wrappers().values():
        fn.launches = 0
    _build.SHAPES.clear()
    _build.PLAIN_SHAPES.clear()


def launch_record(device) -> dict:
    """{kernel id: {shape and heads: count}} since `reset_launches`, from
    the wrappers' own records (`ops._build`): on a card their launches by
    shape, which must add up to each wrapper's `.launches`; on the CPU the
    calls that took the plain twin."""
    from ldt_torch.ops import _build

    out = {}
    for kid, fn in _wrappers().items():
        name = KERNELS[kid][1]
        if torch.device(device).type == "cuda":
            shapes = dict(_build.SHAPES.get(name, {}))
            if sum(shapes.values()) != fn.launches:
                raise RuntimeError(f"{kid}: {fn.launches} launches, by shape "
                                   f"{shapes}")
            out[kid] = shapes
        else:
            out[kid] = dict(_build.PLAIN_SHAPES.get(name, {}))
    return out


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------


def _seeded(shape, seed: int, device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(device)


def small_stage2_cfg(model_parallel: int, batch: int, hidden: int = 256,
                     heads: int = 4):
    """A stage-2 config whose Score takes the per-shard attention at
    model_parallel 2 (hidden / 2 a multiple of 128, heads even)."""
    from ldt_torch.configs import latent_trainer_cfg

    return latent_trainer_cfg(
        score=dict(hidden_size=hidden, num_heads=heads, num_blocks=2,
                   t_dim=64, z_dim=8, z_scale=8),
        compressor=dict(outsize=64, max_outputs=64, z_dim=4, z_scales=8,
                        hidden_dim=32, p_dim=32, n_layers=2,
                        encoder_layers=1, num_heads=2, neighbors=8),
        sde=dict(train_N=64, sample_N=64),
        opt=dict(warmup_iters=1, ema_decay=0.9),
        common=dict(model_parallel=model_parallel, seed=0),
        data=dict(batch_size=batch))


def job_dryrun(ctx) -> None:
    from ldt_torch.eval.metrics import compute_CD_metrics
    from ldt_torch.generate import sample_latents
    from ldt_torch.nn.layers import Attention
    from ldt_torch.training.latent_sde_trainer import Trainer

    dev = ctx.device
    mesh = mesh_for(ctx.mp)
    d = axis_size(mesh, "data")
    batch = max(2 * d, 4)
    n_pts = 64
    # 1. a DP+TP stage-2 step through the trainer
    cfg = small_stage2_cfg(ctx.mp, batch)
    tr = Trainer(cfg, device=dev, mesh=mesh)
    pts = {"tr_points": _seeded((batch, n_pts, 3), 0, dev)}
    tr.maybe_init(pts)
    loss = float(tr.update(pts))
    assert np.isfinite(loss), "dryrun training step produced a non-finite loss"
    # 2. the sequence-parallel decode
    ccfg = cfg.compressor
    eps = _seeded((batch, ccfg.z_scales, ccfg.n_layers * ccfg.z_dim), 2, dev)
    with torch.no_grad():
        clouds = tr.compressor.sample((batch, n_pts), eps)
    assert clouds.shape == (batch, n_pts, 3) and bool(
        torch.isfinite(clouds).all()), "dryrun SP decode failed"
    # 3. the tensor-parallel attention at the flagship width
    tp_err = None
    if ctx.mp > 1:
        gen = torch.Generator().manual_seed(3)
        attn = Attention(1024, 16, device="cpu")
        with torch.no_grad():
            for p in attn.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.03)
        attn = attn.to(dev)
        x = _seeded((2, 32, 1024), 4, dev)
        with torch.no_grad():
            want = attn(x)
            shard_params(attn, mesh)
            assert attn.tp.per_shard, "the flagship attention is per shard"
            got = attn(x)
        tp_err = float((got - want).abs().max())
        assert tp_err < 1e-4, f"TP attention mismatch: {tp_err}"
    # 4. an int8 sampler scan on this data rank's rows
    n_scan = cfg.sde.sample_N
    full = gather_params(tr.score, tr.score_specs, mesh) \
        if tr.score_specs is not None else None
    gen = torch.Generator(dev).manual_seed(4 + axis_rank(mesh, "data"))
    rows = 4  # a data rank's clouds (the int8 GEMM on a card needs M > 16)
    with tr.ema_weights() as score:
        int8_eps = sample_latents(score, tr.sde, rows, n_scan, device=dev,
                                  int8=True, int8_weights=full,
                                  generator=gen)
    int8_eps = comm.all_gather(int8_eps, axis_group(mesh, "data"), 0)
    assert int8_eps.shape == (rows * d, 8, 8) and bool(
        torch.isfinite(int8_eps).all()), "int8 serving scan failed"
    # 5. a sharded eval tile
    tile = compute_CD_metrics(clouds.cpu().numpy(), pts["tr_points"].cpu()
                              .numpy(), batch_size=batch, verbose=False,
                              device=dev)
    assert all(np.isfinite(v) for v in tile.values()), tile
    line = (f"dryrun_multichip rank {ctx.rank}/{ctx.world}: mesh "
            f"{mesh_shape(mesh)} loss={loss:.4f} sp_decode="
            f"{tuple(clouds.shape)} tp_attn_err@D1024H16={tp_err} "
            f"int8_scan={tuple(int8_eps.shape)}x{n_scan}steps eval_tile="
            f"{sorted(tile)} OK\n")
    sys.stdout.write(line)  # one write: the ranks' lines do not interleave
    sys.stdout.flush()


def _attention_case(case: dict, mesh, dev) -> dict:
    """A tensor-parallel Attention's output and, under grad, the full
    gradients of sum(out^2) (parameters and input) after the sums."""
    from ldt_torch.nn.layers import Attention

    attn = Attention(case["dim"], case["heads"], device="cpu")
    attn.load_state_dict(case["sd"])
    attn = attn.to(dev)
    specs = shard_params(attn, mesh)
    x = case["x"].to(dev).requires_grad_(True)
    y = case.get("y")
    out = attn(x, None if y is None else y.to(dev))
    (out ** 2).sum().backward()
    params = dict(attn.named_parameters())
    comm.sync_grads(params, [k for k, v in specs.items() if v], mesh)
    grads = {k: p.grad for k, p in params.items()}
    model = axis_group(mesh, "model")
    from ldt_torch.parallel.tp import unshard_tensor
    full = {k: unshard_tensor(g, specs[k], model).cpu()
            for k, g in grads.items()}
    x_grad = comm.all_reduce(x.grad.clone()) / comm.world_size()
    return {"out": out.detach().cpu(), "grads": full,
            "x_grad": x_grad.cpu(), "per_shard": attn.tp.per_shard}


def _mesh_checks(ctx) -> dict:
    """make_mesh's shapes and refusal, and shard_batch's rows."""
    out = {"shapes": {m: mesh_shape(make_mesh(m)) for m in (1, 2, 4)}}
    try:
        make_mesh(3)
        out["mesh3"] = "built"
    except ValueError as e:
        out["mesh3"] = f"ValueError: {e}"
    mesh = make_mesh(2)
    batch = {"a": torch.arange(8.0)[:, None], "b": torch.arange(3.0),
             "c": [np.arange(4)], "d": 5}
    got = shard_batch(mesh, batch)
    out["rows"] = {"a": got["a"][:, 0].tolist(), "b": got["b"].tolist(),
                   "c": got["c"][0].tolist(), "d": got["d"]}
    out["data_rank"] = axis_rank(mesh, "data")
    out["leading"] = shard_leading_axis(mesh, torch.arange(6.0)).tolist()
    try:
        shard_leading_axis(mesh, torch.arange(3.0))
        out["leading3"] = "split"
    except ValueError:
        out["leading3"] = "ValueError"
    mine = {"w": torch.full((3,), float(ctx.rank)),
            "p": torch.nn.Parameter(torch.full((2,), float(ctx.rank)))}
    replicate(mesh, mine)
    out["replicated"] = [mine["w"].tolist(), mine["p"].tolist()]
    put = device_put_host(mesh, {"a": np.ones(2, np.float32),
                                 "t": torch.zeros(1)}, device="cpu")
    out["put"] = [type(put["a"]).__name__, put["a"].tolist()]
    return out


def job_parallel_test(ctx) -> None:
    """The rank workers of the parallel CPU tests (see the module
    docstring): each case present in the inputs runs."""
    from ldt_torch.configs import dict2namespace
    from ldt_torch.eval.metrics import compute_all_metrics
    from ldt_torch.models import Compressor
    from ldt_torch.training import checkpoint
    from ldt_torch.training.compressor_trainer import Trainer as Stage1
    from ldt_torch.training.latent_sde_trainer import Trainer as Stage2

    dev = ctx.device
    inputs = torch.load(os.path.join(ctx.workdir, "inputs.pt"),
                        weights_only=False)  # written by the caller
    res = {}
    if "mesh" in inputs:
        res["mesh_checks"] = _mesh_checks(ctx)
    mesh = mesh_for(ctx.mp)
    reset_launches()
    for name in ("attn", "attn_cross", "attn_odd"):
        if name in inputs:
            res[name] = _attention_case(inputs[name], mesh, dev)
    if "decode" in inputs:  # the sequence-parallel decode
        case = inputs["decode"]
        comp = Compressor(dict2namespace(case["cfg"]), device=dev)
        comp.load_state_dict(case["sd"])
        with torch.no_grad():
            res["decode"] = comp.sample(
                (case["eps"].shape[0], case["n"]),
                case["eps"].to(dev)).cpu()
    if "stage1" in inputs:  # one DP stage-1 step (SP decode)
        case = inputs["stage1"]
        t1 = Stage1(dict2namespace(case["cfg"]), device=dev, mesh=mesh)
        batch = {"tr_points": case["pts"].to(dev)}
        t1.maybe_init(batch, weights=case["sd"])
        out = t1.update(batch, noise=[e.to(dev) for e in case["noise"]])
        st = t1.state
        res["stage1"] = {"out": [float(v) for v in out],
                         "params": _cpu(st.params),
                         "batch_stats": _cpu(st.batch_stats),
                         "mu": _cpu(st.opt_state.mu),
                         "grad_norm": float(t1.tx.grad_norm)}
    if "stage2" in inputs:  # DP+TP stage-2 steps, pinned, drawn; save
        case = inputs["stage2"]
        cfg = dict2namespace(case["cfg"])
        cfg.log = dict2namespace({"save_path": ctx.workdir})
        t2 = Stage2(cfg, device=dev, mesh=mesh)
        batch = {"tr_points": case["pts"].to(dev)}
        t2.maybe_init(batch, score_weights=case["score_sd"],
                      compressor_weights=case["comp_sd"])
        loss = t2.update(
            batch, t_idx=case["t_idx"].to(dev), eta=case["eta"].to(dev),
            enc_noise=[e.to(dev) for e in case["enc_noise"]])
        res["stage2"] = {
            "loss": float(loss),
            "grad_norm": float(t2.tx.grad_norm),
            "tree": _cpu(t2.state_tree(full=True)["score"]),
            "sharded": t2.sharded_names(),
            "local_qkv": tuple(t2.state.params[
                "transformer.0.attn.qkv.weight"].shape)}
        drawn = t2.update(batch)
        res["stage2_drawn"] = {"loss": float(drawn), "tree": _cpu(
            t2.state_tree(full=True)["score"])}
        t2.save()
        checkpoint.wait_pending_saves()
        res["ckpt"] = {"epoch": t2.epoch}
    if "eval" in inputs:  # a sharded eval tile
        case = inputs["eval"]
        res["eval"] = compute_all_metrics(
            case["smp"], case["ref"], case["batch_size"],
            verbose=False, device=dev)
    res["launches"] = launch_record(dev)
    launches = [None] * ctx.world
    dist.all_gather_object(launches, res["launches"])
    res["launches_by_rank"] = launches
    res["mesh"] = mesh_shape(mesh)
    if ctx.rank == 0:
        torch.save(res, os.path.join(ctx.workdir, "results.pt"))


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()  # not a view of a live tensor
    return tree


JOBS = {"dryrun": job_dryrun, "parallel_test": job_parallel_test}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launch", action="store_true",
                    help="spawn --ranks processes (else: one rank of a "
                    "torchrun job)")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--model-parallel", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--job", default="dryrun", choices=sorted(JOBS))
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    if args.launch:
        workdir = launch(args.job, args.ranks, args.model_parallel,
                         args.device, args.workdir)
        print(json.dumps({"job": args.job, "ranks": args.ranks,
                          "workdir": workdir}))
        return
    resolve_device(args.device)
    if not initialize_distributed(device=args.device):
        raise SystemExit("no process group: run under torchrun, or pass "
                         "--launch")
    try:
        run_job(args.job, args.model_parallel, args.device,
                args.workdir or tempfile.mkdtemp(prefix="ldt_dryrun_"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
