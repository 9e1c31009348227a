"""The trainers' composition over 200 steps, ldt_torch against ldt_tpu on
the CPU: Adam, clipping, the EMA, the warm-up-to-cosine handoff and the
counters together, which the per-piece tests hold one at a time. Each
stage trains 25 epochs of 8 steps on twin weights (the port's init carried
to JAX through `ldt_torch.weights`), the same pinned batches and pinned
draws, driven as the entries drive them (`update` per batch, `epoch_end`
per epoch):

  * the reparameterization at the posterior mean on both sides (zero noise
    on the port's; JAX's `reparameterize` returns mu);
  * stage 1's reconstruction a shared 2 x MSE (chamfer and the auction EMD
    have argmins that flip under f32 noise; they have their own files);
  * stage 2's (t index, eta) from precomputed per-step tables.

The warm-up ends in epoch 2 (12 iterations) and the cosine engages at the
epoch-3 boundary. Asserted: the learning rates step for step, the first
loss, the per-epoch loss means within an envelope that grows with the
epoch, the parameters (and stage 2's EMA) after epochs 1 and 3 and at the
end within global relative envelopes, the EMA lagging the parameters.
The nets are small (one Score block, one Compressor layer). Adam turns f32
reduction-order noise into diverging walks of the weights whose gradients
sit at noise level, so the envelopes grow with the steps (the readings
beside each limit, from this file's runs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.models.compressor as jcm
import ldt_tpu.training.compressor_trainer as jct
import ldt_tpu.training.latent_sde_trainer as jlt
import ldt_tpu.training.state as jstate
import ldt_torch.training.compressor_trainer as tct
from ldt_tpu.models import Compressor as JaxCompressor
from ldt_tpu.models import Score as JaxScore
from ldt_tpu.tools.io import dict2namespace as jax_ns
from ldt_torch import weights
from ldt_torch.configs import dict2namespace
from ldt_torch.models import Compressor, Score
from ldt_torch.training.latent_sde_trainer import Trainer as Stage2
from test_torch_port_common import SMALL_COMPRESSOR, SMALL_SCORE

B, N = 2, SMALL_COMPRESSOR["outsize"]
EPOCHS, PER_EPOCH = 25, 8
TOTAL = EPOCHS * PER_EPOCH
WARMUP = 12
LR = 1e-3
TRAIN_N = 32
SCORE = dict(SMALL_SCORE, num_blocks=1, z_dim=4)
Z = (SCORE["z_scale"], SCORE["z_dim"])
C = dict(SMALL_COMPRESSOR, n_layers=1)
FIRST_LOSS_REL = 1e-5  # read 3.3e-7 (stage 1), 1.4e-7 (stage 2)
# Per-epoch loss means, relative: a + b * (epoch - 1). Stage 1's encoder
# groups each point with its 8 nearest (FPS, then kNN): a neighbour near a
# tie flips under f32 noise, and the two runs then walk apart for a while
# (read: 6.7e-4 in epoch 3, 1.6e-2 and 2.3e-2 in epochs 8 and 9, 2.9e-3 at
# the end). Stage 2 has no such argmin (read at most 6.0e-7).
EPOCH_REL = {"stage1": (2e-3, 6e-3), "stage2": (1e-6, 1e-7)}
# The global relative distance of the parameter trees (and of stage 2's
# EMA) after epochs 1 and 3 and at the end. Read: stage 1 1.3e-5, 1.0e-3,
# 2.3e-2; stage 2 5.8e-7, 2.9e-6, 1.3e-5 (EMA 1.2e-7, 3.2e-7, 9.6e-6).
SNAP_REL = {"stage1": {1: 1e-4, 3: 5e-3, EPOCHS: 0.1},
            "stage2": {1: 5e-6, 3: 2e-5, EPOCHS: 1e-4}}
SNAP_EPOCHS = (1, 3, EPOCHS)

@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(save_path) -> dict:
    return dict(
        data=dict(cates=["airplane"], num_categorys=1,
                  tr_max_sample_points=N, te_max_sample_points=N,
                  batch_size=B, test_batch_size=B, boundary=True,
                  num_workers=0),
        opt=dict(adj_lr="warm_up", warmup_iters=WARMUP, lr=LR, beta1=0.9,
                 beta2=0.999, ema_decay=0.99, weight_decay=0.0,
                 grad_norm_clip_value=1.0, kl_weight=1e-2, loss_type="l2",
                 discrete=True),
        log=dict(save_path=str(save_path), save_epoch_freq=10 ** 9,
                 log_epoch_freq=10 ** 9, eval_epoch_freq=10 ** 9,
                 traincolumns=["epoch", "itr", "loss", "time"],
                 trainformat=[None, None, "{:.4f}", "{:.0f}"],
                 evalcolumns=["epoch", "mmd-CD"], evalformat=[None, "{:.8f}"]),
        common=dict(epochs=EPOCHS, num_points=N, seed=0),
        model=dict(C), compressor=dict(C), score=dict(SCORE),
        sde=dict(beta_start=0.1, beta_end=20.0, sde_type="vpsde",
                 sigma2_0=0.0, iw_sample_p_mode="drop_all_iw",
                 iw_sample_q_mode="drop_all_iw", time_eps=0.01,
                 ode_tol=1e-5, sample_time_eps=1e-6, sample_mode="discrete",
                 predictor="ancestral", corrector=None, train_N=TRAIN_N,
                 sample_N=TRAIN_N, snr=0.01, corrector_steps=1,
                 denoise=True, probability_flow=False, alpha=1.0))


def _batches(seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(PER_EPOCH):
        p = rng.randn(B, N, 3).astype(np.float32)
        out.append({"tr_points": p / np.abs(p).max()})
    return out


def _zeros_noise():
    return [torch.zeros(B, C["z_scales"], C["z_dim"])
            for _ in range(C["n_layers"])]


def _flat(tree) -> np.ndarray:
    if isinstance(tree, dict) and tree and all(
            isinstance(v, torch.Tensor) for v in tree.values()):
        tree = {k: v.detach().numpy() for k, v in tree.items()}
    return np.concatenate([np.asarray(a, np.float64).ravel() for a in
                           jax.tree_util.tree_leaves(tree)])


def _distance(got, want) -> float:
    g, w = _flat(got), _flat(want)
    assert g.shape == w.shape
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _run(trainer, batches, step, snaps):
    """The entries' loop: `update` per batch, `epoch_end` per epoch; (the
    losses, the learning rates) and `snaps[epoch] = snaps['fn']()` after
    the snapshot epochs."""
    losses, lrs = [], []
    for epoch in range(1, EPOCHS + 1):
        for i, data in enumerate(batches):
            lrs.append(trainer.current_lr())
            losses.append(float(step(trainer, data,
                                     (epoch - 1) * PER_EPOCH + i)))
        trainer.epoch_end()
        if epoch in SNAP_EPOCHS:
            snaps[epoch] = snaps["fn"]()
    return np.asarray(losses), np.asarray(lrs)


def _assert_tracks(got, want, stage):
    """The first loss (the same weights and draws) and the per-epoch loss
    means (as the training CSV logs them) within EPOCH_REL."""
    assert abs(got[0] - want[0]) <= FIRST_LOSS_REL * abs(want[0])
    gm = got.reshape(EPOCHS, PER_EPOCH).mean(1)
    wm = want.reshape(EPOCHS, PER_EPOCH).mean(1)
    rel = np.abs(gm - wm) / np.abs(wm)
    a, b = EPOCH_REL[stage]
    assert (rel <= a + b * np.arange(EPOCHS)).all(), rel


def _assert_lrs(got, want):
    """The same learning rates: the warm-up over iterations 0-11, the base
    rate to the end of epoch 2, the cosine from the epoch-3 boundary."""
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got[:WARMUP],
                               LR * np.arange(1, WARMUP + 1) / WARMUP)
    assert (got[WARMUP:2 * PER_EPOCH] == LR).all()
    assert got[2 * PER_EPOCH] == pytest.approx(
        LR * 0.5 * (1 + np.cos(np.pi * 3 / EPOCHS)))


def test_stage1_trajectory(tmp_path, monkeypatch):
    """200 stage-1 steps: the Compressor's train-mode forward (BatchNorm
    statistics updated), the KL + 2 x MSE loss, clip, Adam, the LR."""
    d = _cfg(tmp_path)
    batches = _batches(11)
    mse = lambda a, b: 2.0 * ((a - b) ** 2).mean()  # noqa: E731
    monkeypatch.setattr(jcm, "reparameterize", lambda rng, mu, logvar: mu)
    real_j = jct.compressor_objective
    monkeypatch.setattr(
        jct, "compressor_objective",
        lambda *a, **k: real_j(*a, **dict(k, rec_fn=lambda r, p: 2.0 *
                                          jnp.mean((r - p) ** 2))))
    real_t = tct.compressor_objective
    monkeypatch.setattr(tct, "compressor_objective",
                        lambda *a, **k: real_t(*a, **dict(k, rec_fn=mse)))

    ttr = tct.Trainer(dict2namespace(d), device="cpu")
    ttr.maybe_init(batches[0])
    sd = {k: v.detach().clone() for k, v in ttr.model.state_dict().items()}
    init = weights.compressor_variables(sd)
    jcfg = jax_ns(d)
    jtr = jct.Trainer(jcfg, JaxCompressor(jcfg.model))
    jtr.state = jstate.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, init["params"]), jtr.tx,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           init["batch_stats"]),
        ema=False)

    jsnaps = {"fn": lambda: jax.device_get(jtr.state.params)}
    want, want_lr = _run(jtr, batches, lambda tr, data, i: tr.update(data)[0],
                         jsnaps)
    tsnaps = {"fn": lambda: weights.compressor_variables(
        {k: v.detach().clone() for k, v in ttr.model.state_dict().items()}
    )["params"]}
    got, got_lr = _run(ttr, batches, lambda tr, data, i: tr.update(
        data, noise=_zeros_noise())[0], tsnaps)

    _assert_lrs(got_lr, want_lr)
    assert ttr.itr == jtr.itr == TOTAL and ttr.epoch == jtr.epoch
    for epoch in SNAP_EPOCHS:
        dist = _distance(tsnaps[epoch], jsnaps[epoch])
        assert dist <= SNAP_REL["stage1"][epoch], (epoch, dist)
    assert _distance(init["params"], jsnaps[EPOCHS]) > 1e-2  # it trained
    _assert_tracks(got, want, "stage1")


def test_stage2_trajectory(tmp_path, monkeypatch):
    """200 stage-2 steps: the frozen Compressor's encode (posterior mean),
    the pinned (t, eta), the Score's loss, clip, Adam, the EMA, the LR."""
    d = _cfg(tmp_path)
    batches = _batches(23)
    tab = np.random.RandomState(91)
    idx_tab = tab.randint(0, TRAIN_N, size=(TOTAL, B))
    eta_tab = tab.randn(TOTAL, B, *Z).astype(np.float32)
    monkeypatch.setattr(jcm, "reparameterize", lambda rng, mu, logvar: mu)
    idx_j, eta_j = jnp.asarray(idx_tab), jnp.asarray(eta_tab)

    def pinned(rng, step, eps_shape, discrete, timesteps, train_N, sde,
               time_eps, iw_mode, subvp_like):
        t = timesteps[idx_j[step]]
        return (t, sde.var(t)[:, None, None], sde.e2int_f(t)[:, None, None],
                jnp.ones((eps_shape[0], 1, 1)), eta_j[step], rng)

    monkeypatch.setattr(jlt, "draw_train_randoms", pinned)

    gen = torch.Generator().manual_seed(5)
    comp = Compressor(dict2namespace(C), device="cpu", generator=gen)
    comp.init_actnorm(torch.from_numpy(batches[0]["tr_points"]))
    score = Score(dict2namespace(SCORE), device="cpu", generator=gen)
    params = weights.score_params(dict(score.state_dict()))
    comp_vars = weights.compressor_variables(dict(comp.state_dict()))
    ttr = Stage2(dict2namespace(d), device="cpu")
    ttr.maybe_init(batches[0], score_weights=weights.score_state_dict(params),
                   compressor_weights=weights.compressor_state_dict(
                       comp_vars))
    jcfg = jax_ns(d)
    jtr = jlt.Trainer(jcfg, JaxScore(jcfg.score),
                      JaxCompressor(jcfg.compressor))
    jtr.comp_vars = jax.tree_util.tree_map(jnp.asarray, comp_vars)
    jtr.state = jstate.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params), jtr.tx, ema=True)

    jsnaps = {"fn": lambda: jax.device_get((jtr.state.params,
                                            jtr.state.ema_params))}
    want, want_lr = _run(jtr, batches, lambda tr, data, i: tr.update(data),
                         jsnaps)

    def port_tree(tree):
        return weights.score_params({k: v.detach().clone()
                                     for k, v in tree.items()})

    tsnaps = {"fn": lambda: (port_tree(ttr.state.params),
                             port_tree(ttr.state.ema_params))}
    got, got_lr = _run(ttr, batches, lambda tr, data, i: tr.update(
        data, t_idx=torch.from_numpy(idx_tab[i]),
        eta=torch.from_numpy(eta_tab[i]), enc_noise=_zeros_noise()), tsnaps)

    _assert_lrs(got_lr, want_lr)
    assert ttr.itr == jtr.itr == TOTAL and ttr.epoch == jtr.epoch
    assert ttr.state.step == int(jtr.state.step) == TOTAL
    for epoch in SNAP_EPOCHS:
        for i, what in enumerate(("params", "EMA")):
            dist = _distance(tsnaps[epoch][i], jsnaps[epoch][i])
            assert dist <= SNAP_REL["stage2"][epoch], (epoch, what, dist)
    # the EMA lags the parameters, and both moved off the init
    assert _distance(jsnaps[EPOCHS][1], jsnaps[EPOCHS][0]) > 1e-3
    assert _distance(params, jsnaps[EPOCHS][1]) > 1e-3
    _assert_tracks(got, want, "stage2")
