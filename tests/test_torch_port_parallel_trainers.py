"""The stage-2 trainer under a 4-rank {data: 2, model: 2} mesh against
`ldt_tpu` on its mesh and against the port's single process, on the CPU
(the stage-1 step: tests/test_torch_port_parallel_stage1.py).

One gloo job (the workers in `ldt_torch.entries.dryrun_multichip`) runs:
  * one DP+TP stage-2 step (the Score's attention per shard: hidden 256,
    4 heads, K1 on 2 heads x 128 a rank; its state tensor-parallel; the
    clip's norm global) with pinned draws, against JAX's step on its
    mesh (the state placed by its `shard_train_state`, the latents on
    `data`), to 1e-5;
  * one drawn stage-2 step: every draw made at the global shape, so it
    equals the port's single-process step with the same seed;
  * a save under TP: rank 0 writes the gathered state, which a
    single-process trainer restores equal.
The gradient-free coordinates (every attention's key bias) are held to
Adam's bound (lr a step), as in the single-process tests. A run in a world-1 process group equals one
with no group.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

import ldt_tpu.models.compressor as jcm
import ldt_tpu.training.state as jstate
import test_torch_port_stage1 as s1
from ldt_tpu.diffusion import make_diffusion as jax_make_diffusion
from ldt_tpu.models import Score as JaxScore
from ldt_tpu.parallel.tp import make_mesh as jax_make_mesh
from ldt_tpu.parallel.tp import set_tp_mesh as jax_set_tp_mesh
from ldt_tpu.parallel.tp import shard_train_state as jax_shard_train_state
from ldt_tpu.training.latent_sde_trainer import (
    score_objective as jax_score_objective,
)
from ldt_torch.configs import latent_trainer_cfg
from ldt_torch.training import checkpoint
from ldt_torch.training.latent_sde_trainer import Trainer
from ldt_torch.weights import compressor_state_dict, score_state_dict
from test_torch_port_common import ROOT, SDE, SMALL_COMPRESSOR, cfgs

B = 4
SCORE = dict(num_steps=10, z_dim=8, z_scale=8, hidden_size=256, num_heads=4,
             num_blocks=2, num_categorys=1, t_dim=16, dropout=0.0,
             norm="layer_norm", learn_sigma=False, act="swish", unet=False,
             AdaLN=True, condition=False)
HID = SCORE["hidden_size"]
LR2 = 1e-4
TOL2 = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _plain(ns):
    """A config namespace as nested dicts."""
    if hasattr(ns, "__dict__"):
        return {k: _plain(v) for k, v in vars(ns).items()}
    return ns


def _stage2_cfg():
    return latent_trainer_cfg(score=SCORE, compressor=SMALL_COMPRESSOR,
                              sde=SDE, opt=dict(warmup_iters=1,
                                                ema_decay=0.9, lr=LR2))


def _stage2_inputs():
    jcfg, _ = cfgs(SCORE)
    params = _np(JaxScore(jcfg).init(jax.random.key(0),
                                     jnp.zeros((2, 8, 8)),
                                     jnp.ones((2,)))["params"])
    ccfg, _ = cfgs(SMALL_COMPRESSOR)
    comp = _np(jax.jit(jcm.Compressor(ccfg).init)(
        {"params": jax.random.key(1), "sample": jax.random.key(2)},
        jnp.asarray(_rand((2, 64, 3), 3))))
    c = SMALL_COMPRESSOR
    return dict(params=params, comp=comp, pts=_rand((B, 64, 3), 20),
                noise=[_rand((B, c["z_scales"], c["z_dim"]), 30 + j)
                       for j in range(c["n_layers"])],
                idx=np.array([7, 70, 700, 999]),
                eta=_rand((B, 8, 8), 40))


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(2, devices=jax.devices()[:4])


def run_job(work, inputs) -> dict:
    """Run the 4-rank worker job on `inputs`; rank 0's results."""
    torch.save(inputs, work / "inputs.pt")
    run = subprocess.run(
        [sys.executable, "-m", "ldt_torch.entries.dryrun_multichip",
         "--launch", "--ranks", "4", "--model-parallel", "2", "--device",
         "cpu", "--job", "parallel_test", "--workdir", str(work)],
        cwd=ROOT, capture_output=True, text=True, timeout=400)
    assert run.returncode == 0, run.stderr[-4000:]
    res = torch.load(work / "results.pt", weights_only=False)
    res["workdir"] = work
    return res


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    two = _stage2_inputs()
    t = torch.from_numpy
    return run_job(tmp_path_factory.mktemp("parallel_trainers"), {
        "stage2": {"cfg": _plain(_stage2_cfg()),
                   "score_sd": score_state_dict(two["params"]),
                   "comp_sd": compressor_state_dict(two["comp"]),
                   "pts": t(two["pts"]), "t_idx": t(two["idx"]),
                   "eta": t(two["eta"]),
                   "enc_noise": [t(e) for e in two["noise"]]}})


def _held(got: dict, want: dict, tol: dict, null, bound: float,
          init=None) -> None:
    """Every entry close to `want`; the gradient-free coordinates (`null`
    splits them out) within `bound` of `init` on both sides instead."""
    got = {k: v.detach() for k, v in got.items()}
    want = {k: v.detach() for k, v in want.items()}
    g_null, w_null = null(got), null(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)
    if init is not None:
        i_null = null(dict(init))
        for k in i_null:
            for side in (g_null, w_null):
                assert (side[k] - i_null[k]).abs().max() <= bound, k


def _key_bias_split(tree: dict) -> dict:
    """The Score's gradient-free coordinates (every attention's key bias,
    rows [D, 2D) of qkv.bias) taken out of `tree`."""
    null = {}
    for k in [k for k in tree if k.endswith("attn.qkv.bias")]:
        t = tree.pop(k)
        null[k] = t[HID:2 * HID]
        tree[k] = torch.cat([t[:HID], t[2 * HID:]])
    return null


def _jax_stage2(jmesh):
    two = _stage2_inputs()
    ccfg, _ = cfgs(SMALL_COMPRESSOR)
    draws = iter(two["noise"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcm, "reparameterize",
                   lambda rng, mu, logvar: mu + jnp.exp(logvar / 2)
                   * jnp.asarray(next(draws)))
        eps = jcm.Compressor(ccfg, fused_attention=True).apply(
            two["comp"], jnp.asarray(two["pts"]),
            rngs={"sample": jax.random.key(0)})["all_eps"]
    jsde = jax_make_diffusion(cfgs(SDE)[0])
    t = jnp.linspace(1.0, SDE["sample_time_eps"],
                     SDE["train_N"])[jnp.asarray(two["idx"])]
    var, e2int = jsde.var(t)[:, None, None], jsde.e2int_f(t)[:, None, None]
    weight = jnp.ones((B, 1, 1))
    model = JaxScore(cfgs(SCORE)[0], fused_attention=True)
    jtx = jstate.make_optimizer(0.9, 0.999, 0.0, 1.0)
    lr = jstate.make_lr_fn(LR2, 1, 6000)(0, 1, 0)
    jax_set_tp_mesh(jmesh)
    try:
        with jmesh:
            js = jax_shard_train_state(jstate.TrainState.create(
                jax.tree_util.tree_map(jnp.asarray, two["params"]), jtx,
                ema=True), jmesh)
            rows = NamedSharding(jmesh, P("data"))
            eps_s = jax.device_put(eps, rows)
            eta_s = jax.device_put(jnp.asarray(two["eta"]), rows)

            def step(js, eps, eta):
                def loss(p):
                    return jax_score_objective(model, p, eps, t, var, e2int,
                                               weight, eta, None, None, True,
                                               jax.random.key(9), "l2")

                value, grads = jax.value_and_grad(loss)(js.params)
                return (jstate.apply_update(js, grads, jtx, lr,
                                            ema_decay=0.9), value,
                        optax.global_norm(grads))

            js, value, norm = jax.jit(step)(js, eps_s, eta_s)
            js = jax.device_get(js)
    finally:
        jax_set_tp_mesh(None)
    return float(value), js, lr, float(norm)


def _adam(opt_state):
    return s1._adam(opt_state)


def test_stage2_dp_tp_step_matches_jax_on_its_mesh(job, jmesh):
    got = job["stage2"]
    want_loss, js, lr, want_norm = _jax_stage2(jmesh)
    np.testing.assert_allclose(got["loss"], want_loss, **TOL2)
    # the global gradient norm before the clip: the gradients averaged
    # over the ranks, the shards' squares summed over `model`
    np.testing.assert_allclose(got["grad_norm"], want_norm, **TOL2)
    init = score_state_dict(_stage2_inputs()["params"])
    tree = got["tree"]
    adam = _adam(js.opt_state)
    for name, want in (("params", js.params), ("ema_params", js.ema_params),
                       ("mu", adam.mu), ("nu", adam.nu)):
        g = tree["opt_state"][name] if name in ("mu", "nu") else tree[name]
        tol = dict(rtol=1e-5, atol=1e-9) if name == "nu" else TOL2
        bound = lr * (1 + 1e-5) if name in ("params", "ema_params") else 1.0
        _held(g, score_state_dict(_np(want)), tol, _key_bias_split, bound,
              init if name in ("params", "ema_params") else None)
    # the Score was sharded: the packed qkv of a rank holds 3 x 128 rows
    assert got["local_qkv"] == (3 * HID // 2, HID)
    assert len(got["sharded"]) == 2 * 6


def test_stage2_tp_attention_ran_per_shard(job):
    """Each rank ran K1 on its 2 of the 4 heads, 128 wide, and K3 in the
    backward, at its 2 of the 4 clouds."""
    for launches in job["launches_by_rank"]:
        assert launches["K1"].get(f"2x8x{3 * HID // 2}/h2", 0) >= 4
        assert launches["K3"].get(f"2x8x{3 * HID // 2}/h2", 0) >= 4


def _world1_trainer(cfg=None):
    two = _stage2_inputs()
    tr = Trainer(cfg or _stage2_cfg(), device="cpu")
    tr.maybe_init({"tr_points": two["pts"]},
                  score_weights=score_state_dict(two["params"]),
                  compressor_weights=compressor_state_dict(two["comp"]))
    return tr, two


def _world1_steps(cfg=None):
    tr, two = _world1_trainer(cfg)
    batch = {"tr_points": two["pts"]}
    pinned = tr.update(batch, t_idx=torch.from_numpy(two["idx"]),
                       eta=torch.from_numpy(two["eta"]),
                       enc_noise=[torch.from_numpy(e)
                                  for e in two["noise"]])
    drawn = tr.update(batch)
    return tr, float(pinned), float(drawn)


def test_drawn_stage2_step_equals_the_single_process_one(job):
    """Every draw of the DP+TP step (the encode's noise, t, eta) was made
    at the global shape from the same generator: the step is the
    single-process one."""
    tr, pinned, drawn = _world1_steps()
    np.testing.assert_allclose(job["stage2"]["loss"], pinned, **TOL2)
    np.testing.assert_allclose(job["stage2_drawn"]["loss"], drawn, **TOL2)
    want = tr.state.to_tree()
    got = job["stage2_drawn"]["tree"]
    for name in ("params", "ema_params"):
        _held(got[name], want[name], TOL2, _key_bias_split,
              2 * LR2 * (1 + 1e-5), score_state_dict(
                  _stage2_inputs()["params"]))


def test_tp_checkpoint_restores_into_a_single_process_trainer(job):
    """Rank 0 wrote the gathered state in the single-process format: a
    world-1 trainer restores it tensor for tensor (the Adam moments as
    saved, rounded to bf16)."""
    cfg = _stage2_cfg()
    cfg.log = type(cfg.score)(save_path=str(job["workdir"]))
    tr, _ = _world1_trainer(cfg)
    checkpoint.wait_pending_saves()
    tr.resume()
    assert tr.epoch == job["ckpt"]["epoch"] + 1
    want = job["stage2_drawn"]["tree"]
    got = tr.state.to_tree()
    for name in ("params", "ema_params"):
        for k, w in want[name].items():
            assert torch.equal(got[name][k].detach(), w), k
    for name in ("mu", "nu"):
        for k, w in want["opt_state"][name].items():
            assert torch.equal(got["opt_state"][name][k],
                               w.to(torch.bfloat16).float()), k


def test_a_world1_group_equals_no_group(tmp_path):
    """In a process group of one, the trainer builds no mesh: its steps
    equal those with no group, bit for bit."""
    _, pinned, drawn = _world1_steps()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        tr, g_pinned, g_drawn = _world1_steps()
        assert tr.mesh is None
    finally:
        dist.destroy_process_group()
    assert (g_pinned, g_drawn) == (pinned, drawn)
