"""The completion stage 2's mixed-precision step (`common.train_dtype:
bfloat16`) against ldt_tpu on the CPU: the conditional Score in bf16, its
ConditionNet (the ResNet trunk's convolutions and BatchNorms, the
grouper) included, with the held quantities and tolerances of
test_torch_port_precision_steps.py. A file of its own: JAX's gradient runs
eagerly here (its jitted conditional gradient is off, ROADMAP Queue 3),
which compiles every operation once (~1 min on one worker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ldt_torch.training import completion_latent_sde_trainer as tclt
from ldt_torch.weights import compressor_variables, score_variables
from test_torch_port_precision import (  # noqa: F401  (fixtures)
    B,
    BF16,
    COND,
    IMG,
    N,
    Z,
    _jx,
    _rand,
    _t,
    nets,
    one_thread,
)
from test_torch_port_precision_steps import (
    _assert_loss,
    _assert_stepped,
    _check_grads,
    _discrete,
    _jax_adam_step,
    _jcomp,
    _jit_pinned,
    _jscore,
    _noise,
    _port_steps,
    _score_sd,
    _stage2_cfg_mp,
)


def test_completion_stage2_step_in_bf16_matches_jax(tmp_path, nets,
                                                    monkeypatch):
    """The conditional step with a bf16 Score: its ConditionNet (the ResNet
    trunk's convolutions and BatchNorms, the grouper) in bf16, K2 at the
    blocks' condition tokens; loss and f32 gradients, the parameters after
    Adam."""
    pts, noise = _rand((B, N, 3), 70), _noise(80)
    rng = np.random.default_rng(3)
    cond = {"img": rng.uniform(0, 1, (B, IMG, IMG, 3)).astype(np.float32),
            "pts": _rand((B, N, 3), 81, 0.5)}
    idx, eta = np.array([3, 600]), _rand((B,) + Z, 90)
    jvars = _jx(score_variables(nets["cond"]))
    comp_vars = _jx(compressor_variables(nets["comp"]))
    bs = jvars["batch_stats"]

    eps = _jit_pinned(lambda cv, p: _jcomp().apply(
        cv, p, rngs={"sample": jax.random.key(0)})["all_eps"])(
        noise, comp_vars, jnp.asarray(pts))
    t, var, e2int, w = _discrete(idx)
    xt = eps * e2int + jnp.sqrt(var) * jnp.asarray(eta)
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}

    def loss_fn(p):
        pred, _ = _jscore(COND).apply(
            {"params": p, "batch_stats": bs}, xt, t, None, jcond,
            train=True, mutable=["batch_stats"])
        return jnp.mean(jnp.square(jnp.asarray(eta) - pred) * w)

    # eagerly: JAX's jitted conditional gradient is off (ROADMAP, Queue
    # 3), and jitted bf16 keeps f32 inside its fusions
    loss, grads = jax.value_and_grad(loss_fn)(jvars["params"])

    def make(dt):
        tr = tclt.Trainer(_stage2_cfg_mp(tmp_path, COND), device="cpu",
                          dtype=dt)
        tr.maybe_init({"tr_points": pts}, score_weights=nets["cond"],
                      compressor_weights=nets["comp"])
        return tr

    def step(tr):
        return tr.update(pts, cond, t_idx=torch.from_numpy(idx),
                         eta=_t(eta), enc_noise=[_t(e) for e in noise])

    port = _port_steps(make, step, [tclt])
    seen = port["seen"]
    assert seen["cross_attention_bwd"] == {BF16}
    assert seen["packed_self_attention_bwd"] == {BF16}
    _assert_loss(port[BF16][0].item(), float(loss), "conditional")
    _check_grads(port, 0, _score_sd(grads, bs), "conditional")
    js = _jax_adam_step(jvars["params"], grads, ema_decay=0.99)
    _assert_stepped(port[BF16][2].state.params, _score_sd(js.params, bs),
                    "params")
