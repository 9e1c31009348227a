"""Stage-1 training: ldt_torch against ldt_tpu on the CPU. Train-mode
BatchNorm against flax (output, gradient, running statistics, no update at
init), ActNorm's init after train-mode BatchNorms against JAX's
`Compressor.init(..., train=True)`, the Compressor's train-mode forward and
its batch statistics against `mutable=["batch_stats"]`, and two whole
`Trainer.update` steps against the JAX trainer's pieces (real chamfer + auction
EMD, K2 and K4 through the Pallas kernels in interpret mode, pinned
reparameterization noise)."""

import functools
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ldt_tpu.models.compressor as jcm
import ldt_tpu.training.state as jstate
from ldt_tpu.training.compressor_trainer import (
    compressor_objective as jax_objective,
)
from ldt_torch.configs import compressor_trainer_cfg
from ldt_torch.models import Compressor
from ldt_torch.nn.layers import BatchNorm
from ldt_torch.training.compressor_trainer import Trainer
from ldt_torch.weights import compressor_state_dict, load_compressor
from test_torch_port_common import F32_TOL, SMALL_COMPRESSOR, cfgs

B, N = 4, 64
C = SMALL_COMPRESSOR
KL_WEIGHT = 1e-3
# Two train steps: the f32 sums of the two frameworks run in other orders
# (the BatchNorm statistics over 16,384 grouped points, the losses' means),
# and the decoded set's distances differ in form (expanded in JAX, direct
# here), so a gradient can move by ~1e-6 of its scale; Adam normalizes the
# first step's update to ~lr per element.
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
# Parameters with no gradient in exact arithmetic: a bias right before a
# train-mode BatchNorm (the batch mean removes it), and the grouping's
# feature bias and affine beta (its anchor subtraction and then the
# BatchNorm remove them); and in every attention the key bias, rows
# [D, 2D) of `qkv.bias` (a query's scores all move by q.b_k, which the
# softmax removes). Both frameworks' gradients there are f32 rounding noise
# (~1e-9, read), which Adam turns into steps of up to lr: they are held to
# that bound, not to each other, and after the first step the port takes
# JAX's values there (else the next forward's BatchNorm means, which the
# biases shift, would differ by up to 0.1 lr).
NULL_GRAD = {"input_dense.bias", "group.affine_beta",
             "group.extraction.transfer_dense.bias",
             "group.extraction.ops.0.net1_dense.bias",
             "pos_embedding.conv1.bias", "pos_embedding.conv2.bias"}
D = C["hidden_dim"]


@torch.no_grad()
def _take_null(st, js, stats) -> None:
    """Set the port state's gradient-free coordinates (params and both Adam
    moments) to the JAX state's."""
    adam = _adam(js.opt_state)
    for tree, jtree in ((st.params, js.params), (st.opt_state.mu, adam.mu),
                        (st.opt_state.nu, adam.nu)):
        src, dst = _split_null(_params_of(jtree, stats)), _split_null(
            {k: t.data if k.endswith("attn.qkv.bias") else t
             for k, t in tree.items()})
        for k, t in dst.items():
            t.copy_(src[k])


def _split_null(tree: dict) -> dict:
    """The entries with no exact gradient taken out of `tree` (a dict of
    tensors by parameter name, changed in place): {name: tensor}."""
    null = {k: tree.pop(k) for k in NULL_GRAD}
    for k in [k for k in tree if k.endswith("attn.qkv.bias")]:
        t = tree.pop(k)
        null[k] = t[D:2 * D]
        tree[k] = torch.cat([t[:D], t[2 * D:]])
    return null


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _jax_model():
    return jcm.Compressor(cfgs(C)[0], fused_attention=True)


@functools.lru_cache(maxsize=None)
def _init_variables(train: bool):
    """JAX's init on the first batch, as the stage-1 (train=True) and
    stage-2 (train=False) trainers call it."""
    return _np(jax.jit(jcm.Compressor(cfgs(C)[0]).init,
                       static_argnames=("train",))(
        {"params": jax.random.key(1), "sample": jax.random.key(2)},
        jnp.asarray(_rand((B, N, 3), 0)), train=train))


def _bn_case(shape, seed):
    rng = np.random.default_rng(seed)
    f = shape[-1]
    params = {"scale": rng.uniform(0.5, 1.5, f).astype(np.float32),
              "bias": rng.standard_normal(f).astype(np.float32)}
    stats = {"mean": rng.standard_normal(f).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, f).astype(np.float32)}
    x = _rand(shape, seed + 1, scale=2.0, shift=0.5)
    tm = BatchNorm(f, device="cpu")
    tm.load_state_dict({"weight": _t(params["scale"]),
                        "bias": _t(params["bias"]),
                        "running_mean": _t(stats["mean"]),
                        "running_var": _t(stats["var"])})
    return params, stats, x, tm


@pytest.mark.parametrize("shape", [(3, 5, 6), (2, 4, 7, 6)])
def test_batch_norm_train_mode_matches_flax(shape):
    """The output, its gradient (through the batch statistics) and the
    running update 0.9 running + 0.1 batch with the biased variance."""
    params, stats, x, tm = _bn_case(shape, 3)
    w = _rand(shape, 5)
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.9)

    def jloss(p, xx):
        y, mutated = jm.apply({"params": p, "batch_stats": stats}, xx,
                              mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mutated["batch_stats"])

    (_, (want, want_stats)), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    got = tm(tx, train=True)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tm.weight.grad.numpy(),
                               np.asarray(gp["scale"]), rtol=1e-4, atol=1e-5)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(tm.update[name].numpy(),
                                   np.asarray(want_stats[key]), **F32_TOL)
        assert torch.equal(getattr(tm, name), _t(stats[key]))  # unchanged
    # the biased variance, not torch's unbiased running variance
    xf = x.reshape(-1, shape[-1])
    assert np.allclose(tm.update["running_var"].numpy(),
                       0.9 * stats["var"] + 0.1 * xf.var(0), rtol=1e-5)


def test_batch_norm_running_mode_is_unchanged_by_train():
    params, stats, x, tm = _bn_case((3, 5, 6), 7)
    with torch.no_grad():
        before = tm(_t(x))
        tm(_t(x), train=True)
        assert torch.equal(tm(_t(x)), before)


def test_flax_init_updates_no_running_statistic_and_neither_does_the_port():
    stats = _init_variables(True)["batch_stats"]
    for leaf_path, a in jax.tree_util.tree_leaves_with_path(stats):
        want = 1.0 if leaf_path[-1].key == "var" else 0.0
        assert np.all(a == want), leaf_path
    _, tcfg = cfgs(C)
    model = Compressor(tcfg, device="cpu")
    model.init_actnorm(_t(_rand((B, N, 3), 0)), train=True)
    for name, buf in model.named_buffers():
        want = 1.0 if name.endswith("running_var") else 0.0
        assert torch.all(buf == want), name
    assert model.take_batch_stats() == {}


@pytest.mark.parametrize("train", [True, False])
def test_init_actnorm_matches_the_jax_init(train):
    """With every other weight the JAX init's, `init_actnorm(pts, train)`
    on the init batch gives JAX's data-dependent ActNorm of
    `Compressor.init(..., train=train)`; the two modes differ."""
    _, tcfg = cfgs(C)
    v = _init_variables(train)
    model = load_compressor(Compressor(tcfg, device="cpu"), v)
    with torch.no_grad():
        model.conv_in.shift.zero_()
        model.conv_in.log_scale.zero_()
    model.init_actnorm(_t(_rand((B, N, 3), 0)), train=train)
    # log(std + 1e-6) over 4 clouds: an f32 rounding upstream moves
    # log_scale by up to ~1e-5 relative where the clouds nearly agree
    for name in ("shift", "log_scale"):
        np.testing.assert_allclose(
            getattr(model.conv_in, name).detach().numpy(),
            v["params"]["conv_in"][name], rtol=1e-4, atol=1e-5)
    other = _init_variables(not train)["params"]["conv_in"]["log_scale"]
    assert not np.allclose(v["params"]["conv_in"]["log_scale"], other,
                           atol=1e-2)


@functools.lru_cache(maxsize=None)
def _variables():
    """Stage-1 init variables with the running statistics moved off their
    initial values (so the momentum update is exercised)."""
    rng = np.random.default_rng(3)
    v = _init_variables(True)

    def stats(path, a):
        if path[-1].key == "var":
            return (a * rng.uniform(0.5, 2.0, a.shape)).astype(np.float32)
        return (a + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)

    return {"params": v["params"], "batch_stats":
            jax.tree_util.tree_map_with_path(stats, v["batch_stats"])}


def _noise(seed):
    return [_rand((B, C["z_scales"], C["z_dim"]), seed + i)
            for i in range(C["n_layers"])]


def _pin_jax_noise(monkeypatch, noise):
    draws = iter(noise)
    monkeypatch.setattr(jcm, "reparameterize",
                        lambda rng, mu, logvar: mu + jnp.exp(logvar / 2.0)
                        * jnp.asarray(next(draws)))


def test_train_mode_forward_and_batch_stats_match(monkeypatch):
    pts, noise = _rand((B, N, 3), 21), _noise(30)
    _pin_jax_noise(monkeypatch, noise)
    want, mutated = _jax_model().apply(
        _variables(), jnp.asarray(pts), train=True,
        rngs={"sample": jax.random.key(0)}, mutable=["batch_stats"])
    _, tcfg = cfgs(C)
    model = load_compressor(Compressor(tcfg, device="cpu"), _variables())
    before = {k: b.clone() for k, b in model.named_buffers()}
    got = model(_t(pts), noise=[_t(e) for e in noise], train=True)
    for key in ("set", "all_eps", "max"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), **F32_TOL)
    for g, w in zip(got["kls"], want["kls"]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   **F32_TOL)
    want_stats = compressor_state_dict(
        {"params": _variables()["params"],
         "batch_stats": _np(mutated["batch_stats"])})
    assert set(got["batch_stats"]) == set(before)
    for k, t in got["batch_stats"].items():
        np.testing.assert_allclose(t.numpy(), want_stats[k].numpy(),
                                   **F32_TOL, err_msg=k)
        assert not torch.equal(t, before[k]), k
        assert torch.equal(dict(model.named_buffers())[k], before[k]), k
    # the running statistics differ from the batch's: the mode matters
    with torch.no_grad():
        running = model(_t(pts), noise=[_t(e) for e in noise])
    assert "batch_stats" not in running
    assert not torch.allclose(running["set"], got["set"], atol=1e-3)


def _cfg():
    return compressor_trainer_cfg(model=C, opt=dict(warmup_iters=2,
                                                    kl_weight=KL_WEIGHT))


def _adam(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]


def _params_of(tree, stats):
    """A tree of the params' structure (params, a moment) -> the port's
    parameter names (the converter needs the batch stats' structure)."""
    sd = compressor_state_dict({"params": _np(tree), "batch_stats": stats})
    return {k: v for k, v in sd.items() if "running_" not in k}


def _assert_close_dict(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


def test_trainer_updates_match_jax(monkeypatch):
    """Two `Trainer.update` steps (train-mode forward with pinned noise,
    l1 chamfer + auction EMD, K4 backward, clip, Adam in warm-up, the
    BatchNorms' running statistics) against `compressor_objective` under
    `jax.value_and_grad` and `apply_update` of the JAX package."""
    pts = [_rand((B, N, 3), 40 + i) for i in range(2)]
    noise = [_noise(50 + 10 * i) for i in range(2)]
    v0 = _init_variables(True)
    cfg = _cfg()
    trainer = Trainer(cfg, device="cpu")
    trainer.maybe_init({"tr_points": pts[0]},
                       weights=compressor_state_dict(v0))
    jtx = jstate.make_optimizer(0.9, 0.999, 0.0, 1.0)
    js = jstate.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, v0["params"]), jtx,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v0["batch_stats"]),
        ema=False)
    model = _jax_model()
    stats0 = _np(v0["batch_stats"])
    lrs = []
    for i in range(2):
        _pin_jax_noise(monkeypatch, noise[i])

        def loss_fn(p):
            return jax_objective(model, p, js.batch_stats, jnp.asarray(pts[i]),
                                 None, jax.random.key(0), KL_WEIGHT)

        (want, (kl, rec, max_f, new_bs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(js.params)
        jgrads = _params_of(grads, stats0)
        assert all(g.abs().max() < 1e-7
                   for g in _split_null(jgrads).values())
        assert all(g.abs().max() > 1e-6 for g in jgrads.values())
        lr = jstate.make_lr_fn(1e-3, 2, cfg.common.epochs)(i, 1, 0)
        lrs.append(lr)
        js = jstate.apply_update(js, grads, jtx, lr, ema_decay=0.0,
                                 new_batch_stats=new_bs)
        assert trainer.current_lr() == lr
        got = trainer.update({"tr_points": pts[i]},
                             noise=[_t(e) for e in noise[i]])
        for g, w in zip(got, (want, kl, rec, max_f)):
            np.testing.assert_allclose(g.item(), float(w), **STEP_TOL)
        if i == 0:
            _take_null(trainer.state, js, stats0)
    st = trainer.state
    assert trainer.itr == st.step == int(js.step) == 2
    assert st.ema_params is None and js.ema_params is None
    stats = _np(js.batch_stats)
    got, want = dict(st.params), _params_of(js.params, stats)
    init = _split_null(_params_of(v0["params"], stats0))
    for null in (_split_null(got), _split_null(want)):
        for k, p in null.items():
            assert (p - init[k]).abs().max() <= sum(lrs) * (1 + 1e-5), k
    _assert_close_dict(got, want, **STEP_TOL)
    _assert_close_dict(st.batch_stats, {
        k: v for k, v in compressor_state_dict(
            {"params": _np(js.params), "batch_stats": stats}).items()
        if "running_" in k}, **F32_TOL)
    adam = _adam(js.opt_state)
    assert st.opt_state.count == int(adam.count) == 2
    _assert_close_dict(st.opt_state.mu, _params_of(adam.mu, stats),
                       **STEP_TOL)
    # nu ~ g^2: relative to its scale
    _assert_close_dict(st.opt_state.nu, _params_of(adam.nu, stats),
                       rtol=2e-4, atol=1e-12)


def test_trainer_random_init_and_its_state():
    """ActNorm from the whole first batch after train-mode BatchNorms; the
    state holds the model's parameters and running statistics themselves,
    and no EMA; an update moves both."""
    pts = _rand((B, N, 3), 60)
    trainer = Trainer(_cfg(), device="cpu")
    trainer.maybe_init({"tr_points": pts})
    model = trainer.model
    shift = model.conv_in.shift.detach().clone()
    model.init_actnorm(_t(pts), train=True)
    assert torch.equal(model.conv_in.shift, shift)
    assert trainer.state.ema_params is None
    for k, b in model.named_buffers():
        assert trainer.state.batch_stats[k] is b
    for k, p in model.named_parameters():
        assert trainer.state.params[k] is p
    stats = {k: b.clone() for k, b in model.named_buffers()}
    loss, kl, rec, max_f = trainer.update({"tr_points": pts})
    assert all(torch.isfinite(t) for t in (loss, kl, rec, max_f))
    assert all(not torch.equal(b, stats[k])
               for k, b in model.named_buffers())
    assert trainer.sample(2, N).shape == (2, N, 3)
    eps = torch.zeros(2, C["z_scales"], C["n_layers"] * C["z_dim"])
    assert torch.equal(trainer.sample(2, N, eps), trainer.sample(2, N, eps))
    out = trainer.encode(pts)
    assert out["set"].shape == (B, N, 3) and "batch_stats" not in out


@pytest.mark.parametrize("method", ["valsample", "save", "resume"])
def test_unported_trainer_methods_say_why(method, tmp_path):
    """Of the evaluation, the renderer of `valsample(vis=True)` is a later
    slice; `save` before `maybe_init` says that it needs the model, and
    `resume` with neither a training.csv nor a checkpoint under the save
    path raises."""
    trainer = Trainer(_cfg(), device="cpu")

    def resume():
        empty = Trainer(_cfg(), device="cpu")
        empty.cfg.log = SimpleNamespace(save_path=str(tmp_path))
        empty.maybe_init({"tr_points": _rand((B, N, 3), 0)})
        empty.resume()

    calls = {
        "valsample": (lambda: trainer.valsample([], N, vis=True),
                      NotImplementedError, "not ported yet"),
        "save": (trainer.save, RuntimeError, "maybe_init"),
        "resume": (resume, FileNotFoundError, "no checkpoints")}
    call, error, match = calls[method]
    with pytest.raises(error, match=match):
        call()
