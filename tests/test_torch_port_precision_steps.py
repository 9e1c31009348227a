"""Mixed precision (`common.train_dtype: bfloat16`: f32 parameters, bf16
compute) against ldt_tpu on the CPU: one step of the stage-2, stage-1,
completion stage-1 and hybrid trainers in bf16 against the JAX package's
bf16 step, every draw pinned (the conditional step is in
test_torch_port_precision_conditional.py). Held: the loss, every f32
gradient and the parameters after Adam, each within a stated tolerance;
the gradients as far from the port's f32 step's as bf16 rounding takes
JAX's (a quiet f32 compute would sit on the f32 step; a wrong variant
shows the check failing); bf16 reaching the attention kernels' twins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.models.compressor as jcm
import ldt_tpu.training.hybrid_trainer as jht
import ldt_tpu.training.latent_sde_trainer as jlt
import ldt_tpu.training.state as jstate
from ldt_tpu.diffusion import make_diffusion as jax_make_diffusion
from ldt_tpu.models import Compressor as JaxCompressor
from ldt_tpu.models import Score as JaxScore
from ldt_tpu.tools.io import dict2namespace as jax_ns
from ldt_tpu.training.compressor_trainer import (
    compressor_objective as jax_compressor_objective,
)
from ldt_torch.nn.layers import Dense
from ldt_torch.ops import attention as attn_ops
from ldt_torch.tools.io import dict2namespace
from ldt_torch.training import compressor_trainer as tct
from ldt_torch.training import completion_compressor_trainer as tcct
from ldt_torch.training import hybrid_trainer as tht
from ldt_torch.training import latent_sde_trainer as tlt
from ldt_torch.weights import (
    compressor_state_dict,
    compressor_variables,
    score_params,
    score_state_dict,
)
from test_torch_port_checkpoint import run_cfg
from test_torch_port_precision import (  # noqa: F401  (fixtures)
    B,
    BF16,
    C,
    LR,
    N,
    SCORE,
    Z,
    _bf16,
    _jx,
    _np,
    _rand,
    _t,
    nets,
    one_thread,
)

# One bf16 step: the two frameworks round the same operations to bf16 but
# not always at the same places (GELU's inner ops; the attention twins
# take f32 scores, XLA's CPU attention rounds them to bf16), so the loss
# moves by ~1e-3 of itself and the gradients by a few hundredths of their
# norm. The first Adam step is the sign of the gradient: parameters within
# 2 lr of JAX's. The check that the port computes in bf16, not quietly in
# f32, is made on the gradients: a loss is one number whose bf16 error is
# one draw (read: a stage-2 loss 1e-5 from the f32 loss and 5e-4 from
# JAX's bf16 one while its prediction sat nearer JAX's bf16 one), and the
# two frameworks' bf16 errors are about independent, so the port's bf16
# gradients, JAX's and the f32 step's sit about equally far apart (read:
# 0.88-1.03 of JAX's bf16-to-f32 distance). A bf16 step must lie at least
# F32_GAP of JAX's bf16 distance from the f32 step; the quiet-f32 variant
# reads 0.22.
LOSS_REL = 5e-3
GRAD_REL = 0.08
F32_GAP = 0.5

def _noise(seed):
    return [_bf16(_rand((B, C["z_scales"], C["z_dim"]), seed + i))
            for i in range(C["n_layers"])]



def _captured_grads(mp, module):
    seen = []
    real = module.apply_update

    def apply_update(state, grads, *a, **kw):
        seen.append({k: g.clone() for k, g in grads.items()})
        return real(state, grads, *a, **kw)

    mp.setattr(module, "apply_update", apply_update)
    return seen


def _spy_attention(mp):
    """The dtypes that reach the attention twins (K1-K4's plain versions
    on the CPU), by kernel."""
    seen = {}
    for name in ("packed_self_attention", "packed_self_attention_bwd",
                 "cross_attention", "cross_attention_bwd"):
        real = getattr(attn_ops, name)

        def spy(*args, _real=real, _name=name):
            seen.setdefault(_name, set()).add(args[0].dtype)
            return _real(*args)

        mp.setattr(attn_ops, name, spy)
    return seen


def _norm(tensors: dict) -> float:
    return float(torch.sqrt(sum(torch.sum(t.double() ** 2)
                                for t in tensors.values())))


def _dist(a: dict, b: dict) -> float:
    return _norm({k: a[k] - b[k] for k in a})


def _assert_grads(got: dict, want: dict, want_f32: dict, what: str):
    """Every port gradient f32; the whole within GRAD_REL of JAX's bf16
    ones (relative to their norm) and at least F32_GAP of JAX's bf16
    distance from the f32 step's `want_f32`."""
    assert set(got) == set(want) == set(want_f32), what
    for k, g in got.items():
        assert g.dtype == torch.float32, (what, k, g.dtype)
    scale = _norm(want)
    err = _dist(got, want)
    assert err <= GRAD_REL * scale, (what, err / scale)
    gap, jax_gap = _dist(got, want_f32), _dist(want, want_f32)
    assert gap >= F32_GAP * jax_gap, (what, gap / jax_gap)


def _assert_loss(got: float, want: float, what: str):
    assert abs(got - want) <= LOSS_REL * abs(want), (what, got, want)


def _assert_stepped(got: dict, want: dict, what: str):
    """Parameters after the first Adam step (lr times the sign of the
    gradient, within rounding): within 2 lr of JAX's, f32."""
    assert set(got) == set(want), what
    for k, p in got.items():
        assert p.dtype == torch.float32, (what, k)
        err = float((p.detach() - want[k]).abs().max())
        assert err <= 2 * LR * (1 + 1e-3), (what, k, err)


def _cfg(save_path, score=SCORE, **opt):
    d = run_cfg(save_path, score=score)
    d["common"]["train_dtype"] = "bfloat16"
    d["opt"].update(dict(lr=LR, warmup_iters=0), **opt)
    return d


# One step of each trainer in bf16 against JAX's, from the same weights. The
# JAX side runs its CPU training path (XLA attention, as its trainers build
# their nets off a TPU), jitted, with the draws as arguments; the f32
# reference is the port's own f32 step, which the f32 tests hold to JAX's
# at F32_TOL.

def _jit_pinned(fn):
    """jax.jit of `fn(*args)` whose Compressor reparameterization draws
    come, in decode order, from the `noise` passed at each call (traced:
    a draw closed over would be baked in)."""
    box = {}

    def traced(noise, *args):
        box["it"] = iter(noise)
        return fn(*args)

    jitted = jax.jit(traced)

    def call(noise, *args):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jcm, "reparameterize",
                       lambda rng, mu, logvar: mu + jnp.exp(logvar / 2.0)
                       * next(box["it"]).astype(mu.dtype))
            return jitted(tuple(jnp.asarray(e) for e in noise), *args)

    return call


def _discrete(idx, weight_q: bool = False):
    """(t, var, e2int, weight) of discrete indices `idx` on run_cfg's SDE;
    `weight_q` the hybrid KL's g2 / (2 var)."""
    d = run_cfg("")["sde"]
    jsde = jax_make_diffusion(jax_ns(d))
    t = jnp.linspace(1.0, d["sample_time_eps"], d["train_N"])[
        jnp.asarray(idx)]
    var = jsde.var(t)[:, None, None]
    weight = (jsde.g2(t)[:, None, None] / (2 * var) if weight_q
              else jnp.ones((len(idx), 1, 1)))
    return t, var, jsde.e2int_f(t)[:, None, None], weight


def _jscore(score=SCORE):
    return JaxScore(jax_ns(dict(score)), dtype=jnp.bfloat16)


def _jcomp():
    return JaxCompressor(jax_ns(dict(C)), dtype=jnp.bfloat16)


def _score_sd(tree, stats=None):
    sd = score_state_dict(_np(tree), None if stats is None else _np(stats))
    return {k: v for k, v in sd.items() if "running_" not in k}


def _comp_sd(tree, stats):
    sd = compressor_state_dict({"params": _np(tree),
                                "batch_stats": _np(stats)})
    return {k: v for k, v in sd.items() if "running_" not in k}


def _jax_adam_step(params, grads, ema_decay=None):
    """JAX's first optimizer step (clip 1, Adam, the EMA when given)."""
    tx = jstate.make_optimizer(0.9, 0.999, 0.0, 1.0)
    s = jstate.TrainState.create(params, tx, ema=ema_decay is not None)
    return jstate.apply_update(s, grads, tx, LR, ema_decay=ema_decay or 0.0)


def _port_steps(make, step, modules):
    """The port trainer `make(dtype)`'s step `step(trainer)` in bf16 and
    in f32: {dtype: (outputs, [captured gradients], trainer)}, the dtypes
    reaching the attention twins in bf16 under "seen"."""
    out = {}
    for dt in (BF16, torch.float32):
        with pytest.MonkeyPatch.context() as inner:
            grads = [_captured_grads(inner, m) for m in modules]
            seen = _spy_attention(inner)
            tr = make(dt)
            res = step(tr)
        out[dt] = (res, [g[0] for g in grads], tr)
        if dt == BF16:
            out["seen"] = seen
    return out


def _check_grads(port, i, want, what):
    _assert_grads(port[BF16][1][i], want, port[torch.float32][1][i], what)


def _stage2_cfg_mp(tmp_path, score=SCORE):
    return dict2namespace(_cfg(tmp_path, score=score))


@pytest.fixture(scope="module")
def stage2_case(nets):
    """The stage-2 step's draws and JAX's bf16 loss and gradients: the
    frozen bf16 encode, then the Score's objective."""
    pts, noise = _rand((B, N, 3), 20), _noise(30)
    idx, eta = np.array([7, 700]), _rand((B,) + Z, 40)
    params = _jx(score_params(nets["score"]))
    comp_vars = _jx(compressor_variables(nets["comp"]))

    def loss_and_grads(params, comp_vars, pts, t, var, e2int, w, eta):
        eps = _jcomp().apply(comp_vars, pts,
                             rngs={"sample": jax.random.key(0)})["all_eps"]
        return jax.value_and_grad(lambda p: jlt.score_objective(
            _jscore(), p, eps, t, var, e2int, w, eta, None, None, True,
            jax.random.key(9), "l2"))(params)

    loss, grads = _jit_pinned(loss_and_grads)(
        noise, params, comp_vars, jnp.asarray(pts), *_discrete(idx),
        jnp.asarray(eta))
    return dict(pts=pts, noise=noise, idx=idx, eta=eta, params=params,
                loss=loss, grads=grads)


def _stage2_port(tmp_path, nets, case, mp, dense=None):
    def make(dt):
        tr = tlt.Trainer(_stage2_cfg_mp(tmp_path), device="cpu", dtype=dt)
        tr.maybe_init({"tr_points": case["pts"]},
                      score_weights=nets["score"],
                      compressor_weights=nets["comp"])
        return tr

    def step(tr):
        if dense is not None and tr.dtype == BF16:
            mp.setattr(Dense, "forward", dense)
        out = tr.update({"tr_points": case["pts"]},
                        t_idx=torch.from_numpy(case["idx"]),
                        eta=_t(case["eta"]),
                        enc_noise=[_t(e) for e in case["noise"]])
        mp.undo()
        return out

    return _port_steps(make, step, [tlt])


def test_stage2_step_in_bf16_matches_jax(tmp_path, nets, stage2_case,
                                         monkeypatch):
    """`Trainer.update` with `train_dtype: bfloat16`: the frozen bf16
    encode (pinned noise), the bf16 Score's loss and f32 gradients (K1 and
    K3's twins in bf16), Adam and the EMA in f32 (one step: within 2 lr of
    JAX's)."""
    case = stage2_case
    port = _stage2_port(tmp_path, nets, case, monkeypatch)
    seen = port["seen"]
    assert seen["packed_self_attention"] == {BF16}
    assert seen["packed_self_attention_bwd"] == {BF16}
    assert seen["cross_attention"] == {BF16}  # the encode
    tr = port[BF16][2]
    assert tr.dtype == BF16
    _assert_loss(port[BF16][0].item(), float(case["loss"]), "stage 2")
    _check_grads(port, 0, _score_sd(case["grads"]), "stage 2")
    js = _jax_adam_step(case["params"], case["grads"], ema_decay=0.9)
    _assert_stepped(tr.state.params, _score_sd(js.params), "params")
    _assert_stepped(tr.state.ema_params, _score_sd(js.ema_params), "ema")
    for tree in (tr.state.opt_state.mu, tr.state.opt_state.nu):
        assert all(v.dtype == torch.float32 for v in tree.values())


def test_a_quiet_f32_compute_fails_the_check(tmp_path, nets, stage2_case,
                                             monkeypatch):
    """The wrong variant: a Dense that casts its input to its (f32) weight
    computes the bf16 net's products in f32; its gradients then sit near
    the f32 step's, and `_assert_grads` fails."""
    def f32_dense(self, x):
        return torch.nn.functional.linear(x.to(self.weight.dtype),
                                          self.weight, self.bias)

    port = _stage2_port(tmp_path, nets, stage2_case, monkeypatch,
                        dense=f32_dense)
    with pytest.raises(AssertionError):
        _check_grads(port, 0, _score_sd(stage2_case["grads"]), "quiet f32")


@pytest.mark.parametrize("module", [tct, tcct], ids=["stage1",
                                                     "completion_stage1"])
def test_stage1_steps_in_bf16_match_jax(tmp_path, nets, monkeypatch,
                                        module):
    """The stage-1 step, and the completion stage 1's (the same step on
    the entry's FPS'd clouds), with a bf16 Compressor: the loss (KL, CD,
    auction EMD in f32), its f32 gradients through K2 and K4's twins in
    bf16, Adam; the BatchNorm statistics f32."""
    pts, noise = _rand((B, N, 3), 50, 0.5), _noise(60)
    comp_vars = _jx(compressor_variables(nets["comp"]))
    stats = comp_vars["batch_stats"]

    def loss_and_grads(params, stats, pts):
        return jax.value_and_grad(lambda p: jax_compressor_objective(
            _jcomp(), p, stats, pts, None, jax.random.key(0), 1e-3),
            has_aux=True)(params)

    (loss, _), grads = _jit_pinned(loss_and_grads)(
        noise, comp_vars["params"], stats, jnp.asarray(pts))

    def make(dt):
        tr = module.Trainer(dict2namespace(_cfg(tmp_path)), device="cpu",
                            dtype=dt)
        tr.maybe_init({"tr_points": pts}, weights=nets["comp"])
        return tr

    def step(tr):
        return tr.update({"tr_points": pts} if module is tct else pts,
                         noise=[_t(e) for e in noise])

    port = _port_steps(make, step, [tct])
    seen = port["seen"]
    assert seen["cross_attention"] == seen["cross_attention_bwd"] == {BF16}
    _assert_loss(port[BF16][0][0].item(), float(loss), "stage 1")
    _check_grads(port, 0, _comp_sd(grads, stats), "stage 1")
    js = _jax_adam_step(comp_vars["params"], grads)
    tr = port[BF16][2]
    _assert_stepped(tr.state.params, _comp_sd(js.params, stats), "params")
    assert all(v.dtype == torch.float32
               for v in tr.state.batch_stats.values())


def test_hybrid_step_in_bf16_matches_jax(tmp_path, nets, monkeypatch):
    """The joint step with both nets in bf16: the Compressor's loss (CD +
    EMD + alpha KL through the frozen bf16 Score, K1 and K3 to its input)
    and f32 gradients, then the score step on that eps; both against
    JAX's bf16 `hybrid_comp_loss` and score objective. No Score `.grad`
    from the KL term (the Score frozen); its parameters stay f32."""
    pts, noise = _rand((B, N, 3), 100, 0.5), _noise(110)
    kl_idx, kl_eta = np.array([5, 500]), _rand((B,) + Z, 120)
    idx, eta = np.array([9, 900]), _rand((B,) + Z, 121)
    d = _cfg(tmp_path)
    d["opt"].update(alpha=0.1, compressor_warmup=0, compressor_beta1=0.9,
                    compressor_beta2=0.999, discrete=True)
    jsde = jax_make_diffusion(jax_ns(d["sde"]))
    comp_vars = _jx(compressor_variables(nets["comp"]))
    params = _jx(score_params(nets["score"]))
    stats = comp_vars["batch_stats"]
    ce_const = 0.5 * (1.0 + jnp.log(2.0 * jnp.pi * jsde.var(
        jnp.asarray(d["sde"]["time_eps"]))))

    def loss_and_grads(cparams, stats, params, pts, kl_draws, kl_eta,
                       draws, eta):
        (loss, aux), cgrads = jax.value_and_grad(
            lambda cp: jht.hybrid_comp_loss(
                _jcomp(), _jscore(), cp, stats, params, pts, None,
                jax.random.key(0), *kl_draws, ce_const, kl_eta, 0.1),
            has_aux=True)(cparams)
        eps = jax.lax.stop_gradient(aux[2])
        sloss, sgrads = jax.value_and_grad(lambda p: jlt.score_objective(
            _jscore(), p, eps, *draws, eta, None, None, True,
            jax.random.key(9), "l2"))(params)
        return loss, cgrads, sloss, sgrads

    loss, cgrads, sloss, sgrads = _jit_pinned(loss_and_grads)(
        noise, comp_vars["params"], stats, params, jnp.asarray(pts),
        _discrete(kl_idx, weight_q=True), jnp.asarray(kl_eta),
        _discrete(idx), jnp.asarray(eta))

    def make(dt):
        tr = tht.Trainer(dict2namespace(d), device="cpu", dtype=dt)
        tr.maybe_init({"tr_points": pts}, score_weights=nets["score"],
                      compressor_weights=nets["comp"])
        return tr

    def step(tr):
        out = tr.update({"tr_points": pts}, noise=[_t(e) for e in noise],
                        kl_t_idx=torch.from_numpy(kl_idx), kl_eta=_t(kl_eta),
                        t_idx=torch.from_numpy(idx), eta=_t(eta))
        return out

    port = _port_steps(make, step, [tht, tlt])
    seen = port["seen"]
    assert seen["packed_self_attention_bwd"] == {BF16}
    assert seen["cross_attention_bwd"] == {BF16}
    loss_score, kl, rec = port[BF16][0]
    _assert_loss((rec + 0.1 * kl).item(), float(loss), "hybrid compressor")
    _check_grads(port, 0, _comp_sd(cgrads, stats), "hybrid compressor")
    _assert_loss(loss_score.item(), float(sloss), "hybrid score")
    _check_grads(port, 1, _score_sd(sgrads), "hybrid score")
    tr = port[BF16][2]
    assert all(p.dtype == torch.float32 for p in tr.score.parameters())
