"""One DP stage-1 step under a 4-rank {data: 2, model: 2} mesh against
`ldt_tpu` on its mesh, on the CPU: the Compressor replicated, each data
rank on its rows (the reparameterization noise pinned at the global
batch), the BatchNorms on the global batch's statistics, the decode
sequence-parallel over `model` (K2 on half the points a rank), the
gradients summed; held against JAX's `compressor_objective` +
`apply_update` jitted on its mesh (the batch on `data`, its SP mesh
registered), to the stage-1 tests' STEP_TOL. The gradient-free
coordinates (the biases before a train-mode BatchNorm, every attention's
key bias) are held to Adam's bound (lr), as in the single-process tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import ldt_tpu.training.state as jstate
import test_torch_port_stage1 as s1
from ldt_tpu.parallel.sp import set_sp_mesh as jax_set_sp_mesh
from ldt_tpu.parallel.tp import make_mesh as jax_make_mesh
from ldt_torch.configs import compressor_trainer_cfg
from ldt_torch.weights import compressor_state_dict
from test_torch_port_parallel_trainers import _held, _np, _plain, run_job


def _stage1_inputs():
    return dict(variables=s1._init_variables(True),
                pts=s1._rand((s1.B, s1.N, 3), 40), noise=s1._noise(50))


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(2, devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    one = _stage1_inputs()
    t = torch.from_numpy
    return run_job(tmp_path_factory.mktemp("parallel_stage1"), {
        "stage1": {"cfg": _plain(compressor_trainer_cfg(
            model=s1.C, opt=dict(warmup_iters=2, kl_weight=s1.KL_WEIGHT))),
            "sd": compressor_state_dict(one["variables"]),
            "pts": t(one["pts"]), "noise": [t(e) for e in one["noise"]]}})


def _jax_stage1(jmesh):
    one = _stage1_inputs()
    v0 = one["variables"]
    jtx = jstate.make_optimizer(0.9, 0.999, 0.0, 1.0)
    js = jstate.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, v0["params"]), jtx,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v0["batch_stats"]),
        ema=False)
    model = s1._jax_model()
    with pytest.MonkeyPatch.context() as mp:
        s1._pin_jax_noise(mp, one["noise"])
        jax_set_sp_mesh(jmesh)
        try:
            with jmesh:
                pts = jax.device_put(jnp.asarray(one["pts"]),
                                     NamedSharding(jmesh, P("data")))

                def loss_fn(p):
                    return s1.jax_objective(model, p, js.batch_stats, pts,
                                            None, jax.random.key(0),
                                            s1.KL_WEIGHT)

                (loss, aux), grads = jax.jit(jax.value_and_grad(
                    loss_fn, has_aux=True))(js.params)
        finally:
            jax_set_sp_mesh(None)
    lr = jstate.make_lr_fn(1e-3, 2, 8000)(0, 1, 0)
    js = jstate.apply_update(js, grads, jtx, lr, ema_decay=0.0,
                             new_batch_stats=aux[3])
    return (loss,) + tuple(aux[:3]), js, lr, float(optax.global_norm(grads))


def test_stage1_dp_step_matches_jax_on_its_mesh(job, jmesh):
    want_out, js, lr, want_norm = _jax_stage1(jmesh)
    got = job["stage1"]
    for g, w in zip(got["out"], want_out):
        np.testing.assert_allclose(g, float(w), **s1.STEP_TOL)
    # the global gradient norm before the clip (the gradients averaged over
    # the ranks)
    np.testing.assert_allclose(got["grad_norm"], want_norm, **s1.STEP_TOL)
    stats = _np(js.batch_stats)
    v0 = _stage1_inputs()["variables"]
    init = s1._params_of(v0["params"], _np(v0["batch_stats"]))
    _held(got["params"], s1._params_of(js.params, stats), s1.STEP_TOL,
          s1._split_null, lr * (1 + 1e-5), init)
    want_bs = {k: v for k, v in compressor_state_dict(
        {"params": _np(js.params), "batch_stats": stats}).items()
        if "running_" in k}
    for k, w in want_bs.items():
        np.testing.assert_allclose(got["batch_stats"][k].numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    adam = s1._adam(js.opt_state)
    _held(got["mu"], s1._params_of(adam.mu, stats), s1.STEP_TOL,
          s1._split_null, 0.0)


def test_stage1_decode_ran_sequence_parallel(job):
    """Each rank decoded half of the set: K2 on [B/2, N/2] queries in the
    decode blocks (K4 in their backward)."""
    half = f"{s1.B // 2}x{s1.N // 2}x{s1.D}/h{s1.C['num_heads']}"
    for launches in job["launches_by_rank"]:
        assert launches["K2"].get(half, 0) == s1.C["n_layers"]
        assert launches["K4"].get(half, 0) == s1.C["n_layers"]
