"""Stage 3, the Hybrid finetune: ldt_torch.training.hybrid_trainer against
ldt_tpu.training.hybrid_trainer on the CPU.

`hybrid_comp_loss` and every Compressor gradient against JAX's under a
jitted `jax.value_and_grad`, in both t-modes, with JAX's own keys (fold_in(base, step), then
split(3)) and the reparameterization noise pinned; the KL term leaves no
Score gradient; two `Trainer.update` steps against the JAX package's
`Trainer` (both nets, the EMA, both Adam states and the BatchNorm
statistics); `valrecon` with one and two categories; the checkpoints both
ways (`.pt`, the JAX `.msgpack`, resume and finetune); `load_pretrain` from
a stage-2 JAX file and its two refusals; the config's defaults."""

import copy
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.models.compressor as jcm
import ldt_tpu.training.checkpoint as jckpt
import ldt_tpu.training.hybrid_trainer as jht
import ldt_tpu.training.latent_sde_trainer as jlt
import ldt_tpu.training.state as jstate
from ldt_tpu.configs import compressor_cfg as jax_compressor_cfg
from ldt_tpu.configs import score_cfg as jax_score_cfg
from ldt_tpu.configs import sde_cfg as jax_sde_cfg
from ldt_tpu.diffusion import make_diffusion as jax_make_diffusion
from ldt_tpu.models import Compressor as JaxCompressor
from ldt_tpu.models import Score as JaxScore
from ldt_tpu.tools.io import dict2namespace as jax_ns
from ldt_torch.configs import dict2namespace, hybrid_trainer_cfg
from ldt_torch.tools.io import load_yaml
from ldt_torch.training import hybrid_trainer as tht
from ldt_torch.training.checkpoint import load_checkpoint, save_checkpoint
from ldt_torch.training.hybrid_trainer import Trainer, hybrid_comp_loss
from ldt_torch.training.jax_checkpoint import save_jax_checkpoint
from ldt_torch.training.latent_sde_trainer import Trainer as Stage2
from ldt_torch.models import Compressor, Score
from ldt_torch.weights import (
    compressor_state_dict,
    compressor_variables,
    score_params,
    score_state_dict,
)
from test_torch_port_checkpoint import SDE_LOG, _adam, run_cfg
from test_torch_port_common import (
    F32_TOL,
    ROOT,
    SMALL_COMPRESSOR,
    SMALL_SCORE,
)
from test_torch_port_metrics import CD_TOL, EMD_TOL
from test_torch_port_stage1 import STEP_TOL

B, N = 4, 64
C = SMALL_COMPRESSOR
# one block: the JAX trainer's two step programs compile in ~17 s, not ~26
SCORE = dict(SMALL_SCORE, num_blocks=1)
Z = (SCORE["z_scale"], SCORE["z_dim"])
HYB_LOG = dict(SDE_LOG, traincolumns=["epoch", "itr", "loss_score", "kl",
                                      "rec", "time"],
               trainformat=[None, None, "{:.4f}", "{:.4f}", "{:.4f}",
                            "{:.0f}"])
# Adam's second moments ~ g^2: relative to their scale (the stage-1 file's)
NU_TOL = dict(rtol=2e-4, atol=1e-12)
# The clouds of an encode-decode (the eval-trainer file's)
CLOUD_TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _cfg_dict(save_path, discrete=False) -> dict:
    """Both packages' hybrid config: the small nets, continuous t (the
    shipped configs') or discrete, the Compressor's betas apart from the
    Score's, the alpha warm-up engaged in epoch 1."""
    d = run_cfg(save_path, score=SCORE, log=HYB_LOG)
    d["opt"].update(pretrain_path=None, compressor_beta1=0.8,
                    compressor_beta2=0.99, compressor_warmup=2, alpha=0.1,
                    discrete=discrete, warmup_iters=1, lr=1e-4)
    return d


def _noise(seed):
    return [_rand((B, C["z_scales"], C["z_dim"]), seed + i)
            for i in range(C["n_layers"])]


def _pin_noise(mp, noise):
    """JAX's reparameterization draws from `noise`, over and over (a
    jitted step bakes the draws in when it traces)."""
    draws = itertools.cycle(noise)
    mp.setattr(jcm, "reparameterize", lambda rng, mu, logvar: mu + jnp.exp(
        logvar / 2.0) * jnp.asarray(next(draws)))


def _kl_keys(base, step):
    return jax.random.split(jax.random.fold_in(base, step), 3)


def _comp_sd(variables):
    return compressor_state_dict(_np(variables))


def _comp_params(tree, stats):
    sd = compressor_state_dict({"params": _np(tree), "batch_stats": stats})
    return {k: v for k, v in sd.items() if "running_" not in k}


def _assert_dict(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   want[k].detach().numpy(), err_msg=k,
                                   **tol)


def _port_tree(js, jc) -> dict:
    """The port's checkpoint tree of a JAX hybrid trainer's two train
    states, by the weight converters."""
    stats = _np(jc.batch_stats)
    sd = compressor_state_dict({"params": _np(jc.params),
                                "batch_stats": stats})

    def ts(state, to_port, bs):
        adam = _adam(state.opt_state)
        return {"step": int(state.step), "params": to_port(state.params),
                "ema_params": None if state.ema_params is None
                else to_port(state.ema_params),
                "opt_state": {"count": int(adam.count),
                              "mu": to_port(adam.mu),
                              "nu": to_port(adam.nu)},
                "batch_stats": bs}

    return {"score": ts(js, lambda t: score_state_dict(_np(t)), None),
            "compressor_state": ts(jc, lambda t: _comp_params(t, stats),
                                   {k: v for k, v in sd.items()
                                    if "running_" in k})}


def _tree_close(got, want, path="", bf16_moments=False):
    """Two state trees: counters equal, tensors within F32_TOL (moments
    against their bf16 rounding when `bf16_moments`)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _tree_close(got[k], want[k], f"{path}/{k}", bf16_moments)
    elif isinstance(want, torch.Tensor):
        want = want.detach().float()
        if bf16_moments and ("/mu/" in path or "/nu/" in path):
            want = want.to(torch.bfloat16).float()
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   want.numpy(), err_msg=path, **F32_TOL)
    else:
        assert got == want, path


def _port_trainer(d, jtr, first, **over) -> Trainer:
    """A port trainer of config dict `d` on the JAX trainer's weights."""
    d = copy.deepcopy(d)
    for key, value in over.items():
        d["log" if key == "save_path" else "opt"][key] = value
    tr = Trainer(dict2namespace(d), device="cpu")
    tr.maybe_init(first, score_weights=score_state_dict(
        _np(jtr.state.params)), compressor_weights=_comp_sd(jtr.comp_vars))
    return tr


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer (continuous t) after its init and after each of two
    `update`s, with every draw of both steps: the pinned reparameterization
    noise, the KL term's rho and eta from its fold_in keys, and the score
    step's index and eta pinned through `draw_train_randoms`."""
    tmp = tmp_path_factory.mktemp("hybrid")
    d = _cfg_dict(str(tmp / "jax"))
    os.makedirs(d["log"]["save_path"])
    jcfg = jax_ns(copy.deepcopy(d))
    jtr = jht.Trainer(jcfg, JaxScore(jcfg.score),
                      JaxCompressor(jcfg.compressor))
    pts = [_rand((B, N, 3), 40 + i) for i in range(2)]
    first = {"tr_points": pts[0]}
    # both nets from the port's init (the Compressor's ActNorm on the
    # first two clouds, as the JAX trainer's), which spares the JAX inits'
    # compiles; the decoder's output layer scaled down, as the eval tests
    # do, so the random clouds are ~1 across and the auction EMD has work
    gen = torch.Generator().manual_seed(1)
    comp = Compressor(dict2namespace(C), device="cpu", generator=gen)
    comp.init_actnorm(_t(pts[0][:2]))
    sd = dict(comp.state_dict())
    for k in ("output_dense.weight", "output_dense.bias"):
        sd[k] = sd[k] * 0.1
    jtr.comp_vars = jax.tree_util.tree_map(jnp.asarray,
                                           compressor_variables(sd))
    score = Score(dict2namespace(SCORE), device="cpu", generator=gen)
    jtr.state = jstate.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray,
                               score_params(dict(score.state_dict()))),
        jtr.tx, ema=True)
    jtr.maybe_init(first)
    init = {"score": _np(jtr.state.params), "comp": _np(jtr.comp_vars)}
    noise = _noise(50)
    t_idx = np.array([[7, 70, 700, 999], [0, 333, 666, 998]])
    eta = np.stack([_rand((B,) + Z, 60 + i) for i in range(2)])

    def pinned(rng, step, eps_shape, discrete, timesteps, train_N, sde,
               time_eps, iw_mode, subvp_like):
        assert discrete  # the hybrid score step always draws discrete t
        t = timesteps[jnp.asarray(t_idx)[step]]
        return (t, sde.var(t)[:, None, None], sde.e2int_f(t)[:, None, None],
                jnp.ones((B, 1, 1)), jnp.asarray(eta)[step], rng)

    kl, outs, states = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        _pin_noise(mp, noise)
        mp.setattr(jlt, "draw_train_randoms", pinned)
        for i in range(2):
            _, k_t, k_eta = _kl_keys(jtr._hyb_base, i)
            kl.append((np.asarray(jax.random.uniform(k_t, (B,))),
                       np.asarray(jax.random.normal(k_eta, (B,) + Z))))
            lr = jtr.current_lr()
            outs.append([float(v) for v in jtr.update({"tr_points": pts[i]})]
                        + [lr])
            states.append((jax.tree_util.tree_map(np.asarray, jtr.state),
                           jax.tree_util.tree_map(np.asarray,
                                                  jtr.comp_state)))
    return dict(d=d, jtr=jtr, first=first, pts=pts, init=init, noise=noise,
                t_idx=t_idx, eta=eta, kl=kl, outs=outs, states=states,
                tmp=tmp)


def _noise_level(states, to_port, b1):
    """{name: mask} of the coordinates whose gradient in either JAX step
    is below 1e-3 of its tensor's largest or 1e-6 of the net's largest:
    step 1's from mu_1 = (1 - b1) g_1, step 2's from mu_2 - b1 mu_1 =
    (1 - b1) g_2. There Adam's step lr m / (sqrt(v) + 1e-8) follows f32
    noise (a bias before a train-mode BatchNorm, an attention's key bias,
    the branches behind an AdaLN gate that starts at 0), so either
    framework may move the coordinate by up to lr a step."""
    mu1, mu2 = (to_port(_adam(st.opt_state).mu) for st in states)
    g1 = mu1
    g2 = {k: mu2[k] - b1 * mu1[k] for k in mu1}
    floor = [1e-6 * max(float(v.abs().max()) for v in g.values())
             for g in (g1, g2)]
    return {k: (g1[k].abs() < max(1e-3 * float(g1[k].abs().max()),
                                  floor[0]))
            | (g2[k].abs() < max(1e-3 * float(g2[k].abs().max()),
                                 floor[1]))
            for k in mu1}


def _assert_stepped(got, want, noise, bound):
    """Tensors within STEP_TOL, the noise-level coordinates within
    `bound` of each other."""
    assert set(got) == set(want)
    for k in want:
        g, w, m = got[k].detach(), want[k], noise[k]
        assert not m.any() or (g[m] - w[m]).abs().max() <= bound, k
        np.testing.assert_allclose(g[~m].numpy(), w[~m].numpy(), err_msg=k,
                                   **STEP_TOL)


def test_two_updates_match_ldt_tpu(jax_run):
    """Two steps from the same weights with JAX's draws: the losses, the
    Score's params, EMA and moments, the Compressor's params, moments and
    BatchNorm statistics; coordinates whose gradient is at f32 noise
    (`_noise_level`) held to Adam's bound of 2 lr a step."""
    r = jax_run
    tr = Trainer(dict2namespace(copy.deepcopy(r["d"])), device="cpu")
    tr.maybe_init(r["first"], score_weights=score_state_dict(
        r["init"]["score"]), compressor_weights=_comp_sd(r["init"]["comp"]))
    assert (tr.discrete, tr.kl_discrete) == (True, False)
    assert (tr.comp_tx.b1, tr.comp_tx.b2, tr.tx.b1) == (0.8, 0.99, 0.9)
    for i in range(2):
        loss_score, kl, rec, lr = r["outs"][i]
        assert tr.current_lr() == lr
        rho, kl_eta = r["kl"][i]
        got = tr.update({"tr_points": r["pts"][i]},
                        noise=[_t(e) for e in r["noise"]], kl_rho=_t(rho),
                        kl_eta=_t(kl_eta), t_idx=torch.tensor(r["t_idx"][i]),
                        eta=_t(r["eta"][i]))
        for g, w in zip(got, (loss_score, kl, rec)):
            np.testing.assert_allclose(g.item(), w, **STEP_TOL)
    bound = 2 * sum(o[3] for o in r["outs"]) * (1 + 1e-5)
    js, jc = r["states"][1]
    st, cs = tr.state, tr.comp_state
    assert tr.itr == st.step == cs.step == 2
    assert cs.ema_params is None and jc.ema_params is None

    def score_sd(t):
        return score_state_dict(_np(t))

    noise = _noise_level([s[0] for s in r["states"]], score_sd, 0.9)
    _assert_stepped(st.params, score_sd(js.params), noise, bound)
    _assert_stepped(st.ema_params, score_sd(js.ema_params), noise, bound)
    jadam = _adam(js.opt_state)
    _assert_dict(st.opt_state.mu, score_sd(jadam.mu), **STEP_TOL)
    _assert_dict(st.opt_state.nu, score_sd(jadam.nu), **NU_TOL)

    stats = _np(jc.batch_stats)

    def comp_sd(t):
        return _comp_params(t, stats)

    noise = _noise_level([s[1] for s in r["states"]], comp_sd, 0.8)
    _assert_stepped(dict(cs.params), comp_sd(jc.params), noise, bound)
    sd = compressor_state_dict({"params": _np(jc.params),
                                "batch_stats": stats})
    _assert_dict(cs.batch_stats, {k: v for k, v in sd.items()
                                  if "running_" in k}, **F32_TOL)
    cadam = _adam(jc.opt_state)
    assert cs.opt_state.count == int(cadam.count) == 2
    _assert_dict(cs.opt_state.mu, comp_sd(cadam.mu), **STEP_TOL)
    _assert_dict(cs.opt_state.nu, comp_sd(cadam.nu), **NU_TOL)
    # the Compressor's module holds the trained state (valsample decodes
    # with it)
    assert all(cs.params[k] is p
               for k, p in tr.compressor.named_parameters())


@pytest.fixture(scope="module")
def jax_comp_loss(jax_run):
    """JAX's `hybrid_comp_loss` under `jax.value_and_grad` in the
    Compressor's params, jitted once for both t-modes: the draws, the
    clouds and the reparameterization noise are its arguments (a draw
    pinned while tracing would be baked in), a stub reconstruction loss,
    alpha 0.1."""
    r = jax_run
    jcfg = r["jtr"].cfg
    comp_vars, score_params = r["init"]["comp"], r["init"]["score"]
    draws = {}

    def loss(c_params, t, var, e2int, weight, eta, ce_const, pts, noise):
        draws["it"] = iter(noise)
        return jht.hybrid_comp_loss(
            JaxCompressor(jcfg.compressor), JaxScore(jcfg.score), c_params,
            comp_vars["batch_stats"], score_params, pts, None,
            jax.random.key(0), t, var, e2int, weight, ce_const, eta, 0.1,
            rec_fn=lambda s, p: jnp.mean(jnp.square(s - p)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcm, "reparameterize", lambda rng, mu, logvar: mu + jnp.exp(
            logvar / 2.0) * next(draws["it"]))
        fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
        yield fn


@pytest.mark.parametrize("discrete", [False, True],
                         ids=["continuous", "discrete"])
def test_hybrid_comp_loss_and_gradients_match_jax(jax_run, jax_comp_loss,
                                                  discrete):
    """One `hybrid_comp_loss` with JAX's draws (its keys fold_in(base,
    step) then split(3): t from the second, as `iw_quantities` in
    `iw_sample_q_mode` or as a discrete index weighted g2 / (2 var), eta
    from the third), a stub reconstruction loss, full alpha: the loss, kl,
    rec, eps, the BatchNorm statistics and every Compressor gradient
    against JAX's (`jax_comp_loss`); the Score's parameters unchanged
    and without a gradient."""
    r = jax_run
    d = _cfg_dict(str(r["tmp"] / "loss"), discrete=discrete)
    jcfg = jax_ns(copy.deepcopy(d))
    jsde = jax_make_diffusion(jcfg.sde)
    _, k_t, k_eta = _kl_keys(jax.random.key(7), 3)
    if discrete:
        idx = jax.random.randint(k_t, (B,), 0, jcfg.sde.train_N)
        t = jnp.linspace(1.0, jcfg.sde.sample_time_eps, jcfg.sde.train_N)[idx]
        var = jsde.var(t)[:, None, None]
        e2int = jsde.e2int_f(t)[:, None, None]
        weight = jsde.g2(t)[:, None, None] / (2 * var)
        pins = dict(t_idx=torch.tensor(np.asarray(idx)))
    else:
        t, var, e2int, weight, _, _ = jsde.iw_quantities(
            k_t, B, jcfg.sde.time_eps, jcfg.sde.iw_sample_q_mode, False)
        var, e2int, weight = var[..., None], e2int[..., None], \
            weight[..., None]
        pins = dict(rho=_t(jax.random.uniform(k_t, (B,))))
    eta = jax.random.normal(k_eta, (B,) + Z)
    ce_const = 0.5 * (1.0 + jnp.log(2.0 * jnp.pi * jsde.var(
        jnp.asarray(jcfg.sde.time_eps))))
    pts, noise = _rand((B, N, 3), 70), _noise(80)
    comp_vars = r["init"]["comp"]
    (want, (jkl, jrec, jeps, jbs)), jgrads = jax_comp_loss(
        comp_vars["params"], t, var, e2int, weight, eta, ce_const,
        jnp.asarray(pts), tuple(jnp.asarray(e) for e in noise))

    tr = Trainer(dict2namespace(d), device="cpu")
    tr.maybe_init({"tr_points": pts}, score_weights=score_state_dict(
        r["init"]["score"]), compressor_weights=_comp_sd(comp_vars))
    before = {k: p.detach().clone() for k, p in tr.score.named_parameters()}
    draws = tr.kl_draws(B, eta=_t(eta), **{
        "t_idx" if discrete else "rho": next(iter(pins.values()))})
    for g, w in zip(draws, (t, var, e2int, weight, eta)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(tr.ce_const.item(), float(ce_const),
                               **F32_TOL)
    loss, (kl, rec, eps, new_bs) = hybrid_comp_loss(
        tr.compressor, tr.score, _t(pts), None, *draws[:4], tr.ce_const,
        draws[4], 0.1, noise=[_t(e) for e in noise],
        rec_fn=lambda s, p: torch.mean(torch.square(s - p)))
    loss.backward()
    for g, w in ((loss, want), (kl, jkl), (rec, jrec)):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(eps.detach().numpy(), np.asarray(jeps),
                               **F32_TOL)
    stats = _np(jbs)
    sd = compressor_state_dict({"params": comp_vars["params"],
                                "batch_stats": stats})
    _assert_dict(new_bs, {k: v for k, v in sd.items() if "running_" in k},
                 **F32_TOL)
    jg = _comp_params(jgrads, stats)
    gmax = max(float(g.abs().max()) for g in jg.values())
    got = {k: p.grad for k, p in tr.compressor.named_parameters()}
    # each gradient within 1e-4 of itself or 1e-4 of the net's largest:
    # the grouping's anchor normalization divides small offsets by their
    # std, and its BatchNorms' batch statistics cancel, so the gradients
    # below them (the grouping, ActNorm, input_dense) differ by up to ~1e-3
    # of their own largest (read 9e-4), ~2e-5 of the net's
    _assert_dict(got, jg, rtol=1e-4, atol=1e-4 * gmax)
    for k, p in tr.score.named_parameters():
        assert p.grad is None and p.requires_grad, k
        assert torch.equal(p, before[k]), k


def test_the_kl_term_leaves_no_score_gradient(jax_run, monkeypatch):
    """A sentinel: after the KL term's backward every Score `.grad` is
    None; with the Score left live (no `frozen`) the same backward fills
    them, so the check can fail."""
    r = jax_run
    tr = _port_trainer(r["d"], r["jtr"], r["first"])
    pts = _t(r["pts"][0])

    def backward():
        draws = tr.kl_draws(B)
        loss, _ = hybrid_comp_loss(
            tr.compressor, tr.score, pts, None, *draws[:4], tr.ce_const,
            draws[4], tr.alpha, generator=tr.generator,
            rec_fn=lambda s, p: torch.mean(torch.square(s - p)))
        loss.backward()

    backward()
    assert all(p.grad is None for p in tr.score.parameters())
    assert all(p.grad is not None for p in tr.compressor.parameters())
    monkeypatch.setattr(tht, "frozen", lambda m: torch.enable_grad())
    backward()
    assert all(p.grad is not None for p in tr.score.parameters())


def _loader(seed, batches=2):
    rng = np.random.default_rng(seed)
    return [{"te_points": rng.standard_normal((B, N, 3)).astype(np.float32),
             "shift": rng.uniform(-1, 1, (B, 1, 3)).astype(np.float32),
             "scale": rng.uniform(0.5, 2, (B, 1, 1)).astype(np.float32),
             "cate_idx": np.array([0, 1, 1, 0][b:] + [0, 1, 1, 0][:b],
                                  np.int32)} for b in range(batches)]


@pytest.mark.parametrize("categories", [1, 2])
def test_valrecon_matches_jax(jax_run, monkeypatch, categories):
    """Encode-decode with the Compressor (pinned noise: JAX's jitted
    reconstruction takes it as an argument), denormalize, save
    `rec_ep<epoch>.npy`, score at batch 256; with two categories only the
    clouds of `val_cate`, in chunks of test_batch_size, with their labels."""
    r = jax_run
    jtr = r["jtr"]
    tr = _port_trainer(r["d"], jtr, r["first"],
                       save_path=str(r["tmp"] / f"valrecon{categories}"))
    os.makedirs(tr.cfg.log.save_path, exist_ok=True)
    if categories > 1:
        for cfg in (jtr.cfg, tr.cfg):
            monkeypatch.setattr(cfg.data, "num_categorys", 2)
            monkeypatch.setattr(cfg.data, "test_batch_size", 3)
    loader = _loader(3)
    kept = 4 if categories > 1 else 2 * B
    chunks = [3, 1] if categories > 1 else [B, B]
    noise = [[_rand((n, C["z_scales"], C["z_dim"]), 10 * b + i)
              for i in range(C["n_layers"])] for b, n in enumerate(chunks)]
    draws = {}
    monkeypatch.setattr(jcm, "reparameterize",
                        lambda rng, mu, logvar: mu + jnp.exp(logvar / 2.0)
                        * next(draws["it"]))

    @jax.jit
    def encode(variables, pts, label, eps):
        draws["it"] = iter(eps)
        return jtr.compressor.apply(variables, pts, label=label,
                                    rngs={"sample": jax.random.key(0)})["set"]

    jb, tb, labels = iter(noise), iter(noise), []
    monkeypatch.setattr(jtr, "_recon_step", lambda v, pts, label, rng: encode(
        v, pts, label, tuple(next(jb))))

    def reconstruct(pts, label=None):
        labels.append(label)
        return Trainer.reconstruct(tr, pts, label,
                                   [_t(e) for e in next(tb)])

    monkeypatch.setattr(tr, "reconstruct", reconstruct)
    calls = {}
    real_t, real_j = tr.eval_metrics, jht.compute_all_metrics
    monkeypatch.setattr(tr, "eval_metrics", lambda rec, ref, bs: (
        calls.__setitem__("port", (rec, ref, bs)), real_t(rec, ref, bs))[1])
    monkeypatch.setattr(jht, "compute_all_metrics", lambda rec, ref,
                        batch_size: (calls.__setitem__(
                            "jax", (np.asarray(rec), np.asarray(ref),
                                    batch_size)),
                                     real_j(rec, ref, batch_size))[1])
    want = jtr.valrecon(loader, val_cate=1)
    got = tr.valrecon(loader, val_cate=1)
    (rec, ref, bs), (jrec, jref, jbs) = calls["port"], calls["jax"]
    assert bs == jbs == 256 and rec.shape == (kept, N, 3)
    np.testing.assert_allclose(ref, jref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rec, jrec, **CLOUD_TOL)
    np.testing.assert_array_equal(
        np.load(os.path.join(tr.cfg.log.save_path, "rec_ep1.npy")), rec)
    if categories > 1:
        assert [lb.tolist() for lb in labels] == [[1, 1, 1], [1]]
    else:
        assert labels == [None, None]
    assert set(got) == set(want)
    for key, tol in (("mmd-CD", CD_TOL), ("mmd_smp-CD", CD_TOL),
                     ("mmd-EMD", EMD_TOL), ("mmd_smp-EMD", EMD_TOL)):
        np.testing.assert_allclose(got[f"val/gen/{key}"],
                                   want[f"val/gen/{key}"], **tol)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def test_save_resume_finetune_both_formats(jax_run, tmp_path):
    """The port's `.pt` (bf16 moments, on a thread) and a JAX `.msgpack`
    written from the port (each train state's own optimizer chain) resume
    into a fresh trainer: every tensor, the counters; `finetune` restarts
    the counters and keeps the restored states. The JAX trainer restores
    the port's `.msgpack` strictly, and the port restores the JAX
    trainer's own save."""
    r = jax_run
    d = copy.deepcopy(r["d"])
    d["log"]["save_path"] = str(tmp_path)
    src = _port_trainer(d, r["jtr"], r["first"])
    src.update({"tr_points": r["pts"][0]})
    src.epoch, src.time = 3, 12.5
    src.save()
    live = _clone(src.state_tree())
    msgpack = str(tmp_path / "checkpt_3.msgpack")
    save_jax_checkpoint(msgpack, src.state_tree(),
                        {"score": src.tx, "compressor_state": src.comp_tx},
                        src.cfg, epoch=3, itr=src.itr, time=12.5)
    for path, bf16 in ((None, True), (msgpack, False)):
        dst = _port_trainer(d, r["jtr"], r["first"])
        dst.resume(pretrain=path, strict=True)
        _tree_close(dst.state_tree(), live, bf16_moments=bf16)
        assert (dst.epoch, dst.itr, dst._itr_epoch_start, dst.time) == (
            4, 1, 1, 12.5)
    dst = _port_trainer(d, r["jtr"], r["first"])
    dst.resume(epoch=3, finetune=True)
    assert (dst.epoch, dst.itr) == (1, 0)
    _tree_close(dst.state_tree(), live, bf16_moments=True)

    jtr = r["jtr"]
    keep = (jtr.state, jtr.comp_state, jtr.epoch, jtr.itr)
    try:
        jtr.resume(pretrain=msgpack, strict=True)
        _tree_close(_port_tree(jtr.state, jtr.comp_state), live)
        assert (jtr.epoch, jtr.itr) == (4, 1)
    finally:
        jtr.state, jtr.comp_state, jtr.epoch, jtr.itr = keep

    js, jc = r["states"][1]
    path = str(tmp_path / "jax" / "checkpt_2.msgpack")
    os.makedirs(os.path.dirname(path))
    jckpt.save_checkpoint(path, {"score": js, "compressor_state": jc},
                          cfg=jtr.cfg, epoch=2, itr=2, time=1.0,
                          moments_bf16=True)
    dst = _port_trainer(d, r["jtr"], r["first"])
    dst.resume(pretrain=path, strict=True)
    _tree_close(dst.state_tree(), _port_tree(js, jc), bf16_moments=True)
    assert (dst.epoch, dst.itr) == (3, 2)


def test_load_pretrain_from_a_stage2_jax_file_and_its_refusals(jax_run,
                                                              tmp_path):
    """A stage-2 dual `.msgpack` gives the Score's whole train state and
    the Compressor's weights with a fresh train state; an empty
    `pretrain_path` and a stage-1 file are refused."""
    r = jax_run
    d = copy.deepcopy(r["d"])
    d["log"]["save_path"] = str(tmp_path)
    s2 = Stage2(dict2namespace(copy.deepcopy(d)), device="cpu")
    s2.maybe_init(r["first"], score_weights=score_state_dict(
        _np(r["jtr"].state.params)), compressor_weights=_comp_sd(
        r["jtr"].comp_vars))
    s2.update({"tr_points": r["pts"][1]})
    with torch.no_grad():
        for p in s2.compressor.parameters():
            p.add_(0.01)
    path = str(tmp_path / "stage2.msgpack")
    save_jax_checkpoint(path, s2.state_tree(), s2.tx, s2.cfg, epoch=5,
                        itr=1)
    tr = _port_trainer(d, r["jtr"], r["first"], pretrain_path=path)
    tr.update({"tr_points": r["pts"][0]})  # a step to be overwritten
    tr.load_pretrain()
    _tree_close(tr.state.to_tree(), s2.state.to_tree())
    _tree_close(dict(tr.compressor.state_dict()),
                dict(s2.compressor.state_dict()))
    cs = tr.comp_state
    assert cs.step == cs.opt_state.count == 0
    assert all(not m.any() for m in cs.opt_state.mu.values())
    assert all(cs.params[k] is p
               for k, p in tr.compressor.named_parameters())
    assert (tr.epoch, tr.itr) == (1, 1)

    with pytest.raises(ValueError, match="pretrain_path"):
        _port_trainer(d, r["jtr"], r["first"]).load_pretrain()
    stage1 = str(tmp_path / "stage1.pt")
    save_checkpoint(stage1, {"state": tr.comp_state.to_tree()})
    with pytest.raises(ValueError, match="DUAL"):
        _port_trainer(d, r["jtr"], r["first"],
                      pretrain_path=stage1).load_pretrain()


def test_hybrid_config_defaults_match_ldt_tpu():
    """`hybrid_trainer_cfg()`: the nets' and the SDE's sections are the JAX
    package's defaults, the opt, data and common values those of the
    shipped experiments/Hybrid_Trainer/airplane/config.yaml, which the JAX
    entry reads."""
    cfg = hybrid_trainer_cfg()
    for name, want in (("score", jax_score_cfg()),
                       ("compressor", jax_compressor_cfg()),
                       ("sde", jax_sde_cfg())):
        assert vars(getattr(cfg, name)) == vars(want), name
    shipped = load_yaml(str(ROOT / "experiments" / "Hybrid_Trainer"
                            / "airplane" / "config.yaml"))
    assert vars(cfg.opt) == shipped["opt"]
    for name in ("data", "common"):
        got = vars(getattr(cfg, name))
        assert {k: shipped[name][k] for k in got} == got, name
    over = hybrid_trainer_cfg(opt=dict(alpha=1.0))
    assert over.opt.alpha == 1.0 and over.opt.compressor_beta1 == 0.9
