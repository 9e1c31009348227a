"""int8 serving through the trainers and the calibrate and gate entries,
ldt_torch against ldt_tpu on the CPU.

  * the stage-2 trainer's `sample(serve_int8=True)` (dynamic scales through
    K1, static ones through K8) and the completion trainer's
    `sample(int8=True)` against the JAX trainers' `sample` under
    LDT_SERVE_INT8=1 (LDT_ATTN_INT8, LDT_INT8_STATIC), each trainer
    restored from the same JAX `.msgpack`, every draw JAX's;
  * the gate stamp checked once per restored checkpoint and sampler config
    (warns, `strict` raises, a matching PASSED stamp is quiet), the static
    scales loaded once per restored checkpoint and anew after a `resume` to
    another one, and what serving refuses;
  * `ldt_torch.entries.int8_calibrate` and `int8_golden_gate` on tiny
    experiment dirs (the configs of tests/test_int8_gate.py with an 8-step
    schedule whose beta_end / N stays below 1: the flagship's 20 over 8
    steps gives NaN), both modes; the files they write load in the JAX
    package, and the JAX package's load in the port.

Each package's trainers are built once per module. The JAX side runs its
Pallas attention in interpret mode (its trainers' own choice on the CPU).
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import ldt_tpu.serving.int8 as jint8
import ldt_tpu.training.completion_latent_sde_trainer as jclt
import ldt_tpu.training.latent_sde_trainer as jlt
import ldt_torch.training.completion_latent_sde_trainer as tclt
import ldt_torch.training.latent_sde_trainer as tlt
from ldt_tpu.models import Compressor as JaxCompressor
from ldt_tpu.models import Score as JaxScore
from ldt_tpu.tools.io import dict2namespace as jax_ns
from ldt_tpu.training.checkpoint import wait_pending_saves as jax_wait
from ldt_torch.configs import dict2namespace
from ldt_torch.entries import int8_calibrate, int8_golden_gate
from ldt_torch.serving import int8 as tint8
from test_torch_port_common import (
    SMALL_COMPRESSOR,
    SMALL_SCORE,
    perturbed,
    to_np,
)
from test_torch_port_diffusion import _jax_draws

B = 4          # a multiple of K8's groups of 4
N_PTS = SMALL_COMPRESSOR["outsize"]  # 64, test_int8_gate.py's N_PTS
STEPS = 8
EPOCH = 5      # the saved checkpoint; training.csv ends at 7 (no file)
SCORE = dict(SMALL_SCORE, num_blocks=2)
SDE = dict(beta_start=0.1, beta_end=4.0, sde_type="vpsde", sigma2_0=0.0,
           iw_sample_p_mode="drop_all_iw", iw_sample_q_mode="drop_all_iw",
           time_eps=0.01, ode_tol=1e-4, sample_time_eps=1e-6,
           sample_mode="discrete", predictor="ancestral", corrector=None,
           train_N=8, sample_N=STEPS, snr=0.01, corrector_steps=1,
           denoise=True, probability_flow=False, alpha=1.0)
IMG = 16


def _cfg(exp, data, completion=False):
    """test_int8_gate.py's experiment config (its ViPC one with
    `completion`) with the short schedule SDE."""
    evalcols = ["epoch", "cd", "f1score"] if completion else \
        ["epoch", "mmd-CD"]
    return dict(
        data=data,
        opt=dict(adj_lr="warm_up", warmup_iters=2, lr=1e-3, beta1=0.9,
                 beta2=0.999, ema_decay=0.99, weight_decay=0.0,
                 grad_norm_clip_value=1.0, kl_weight=1e-6, loss_type="l2",
                 discrete=True),
        log=dict(save_epoch_freq=1, save_path=str(exp), log_epoch_freq=1,
                 eval_epoch_freq=1000,
                 traincolumns=["epoch", "itr", "loss", "time"],
                 trainformat=[None, None, "{:.4f}", "{:.0f}"],
                 evalcolumns=evalcols,
                 evalformat=[None] + ["{:.8f}"] * (len(evalcols) - 1)),
        common=dict(epochs=2, num_points=N_PTS, seed=0),
        # copies: one dict written twice becomes a YAML alias, which
        # `tools.io.load_yaml` does not read
        model=dict(SMALL_COMPRESSOR), compressor=dict(SMALL_COMPRESSOR),
        score=dict(SCORE, condition=completion), sde=dict(SDE))


def _exp(root, completion):
    """An experiment dir: config.yaml, a data tree and a JAX trainer's
    `.msgpack` at EPOCH (weights moved off the init) with a training.csv
    that ends at a later epoch; returns (exp dir, config dict, JAX
    trainer restored from the file)."""
    rng = np.random.RandomState(0)
    exp = root / "exp"
    exp.mkdir(parents=True)
    if completion:
        from ldt_torch.tools import synth_vipc

        vipc = root / "vipc"
        with contextlib.redirect_stdout(io.StringIO()):
            synth_vipc.write_tree(str(vipc), 2, 2, 24, gt_points=300,
                                  part_points=100, lists_dir=str(vipc),
                                  view_size=IMG)
        data = dict(type="ldt_tpu.data.vipc", train_cate="plane",
                    test_cate="plane", train_preload=False,
                    test_preload=False, data_dir=str(vipc),
                    train_list=str(vipc / "train_list2.txt"),
                    test_list=str(vipc / "test_list2.txt"),
                    tr_max_sample_points=N_PTS, te_max_sample_points=N_PTS,
                    batch_size=2, test_batch_size=2, num_categorys=1,
                    num_workers=0)
        batch = {"views": rng.uniform(0, 1, (2, IMG, IMG, 3)).astype(
            np.float32), "pc": rng.randn(2, N_PTS, 3).astype(np.float32),
            "pc_part": rng.randn(2, N_PTS, 3).astype(np.float32)}
    else:
        for split in ("train", "val"):
            d = root / "PC15k" / "02691156" / split
            d.mkdir(parents=True)
            for i in range(3):
                np.save(d / f"m{i}.npy", rng.randn(15000, 3).astype(
                    np.float32))
        data = dict(cates=["airplane"], num_categorys=1,
                    tr_max_sample_points=N_PTS, te_max_sample_points=N_PTS,
                    data_dir=str(root / "PC15k"), batch_size=2,
                    test_batch_size=2, boundary=True, num_workers=0)
        batch = {"tr_points": rng.randn(2, N_PTS, 3).astype(np.float32)}
    cfg = _cfg(exp, data, completion)
    with open(exp / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    ns = jax_ns(cfg)
    cls = jclt.Trainer if completion else jlt.Trainer
    jtr = cls(ns, JaxScore(ns.score), JaxCompressor(ns.compressor))
    jtr.maybe_init(batch)
    variables = {"params": jtr.state.params}
    if jtr.state.batch_stats is not None:
        variables["batch_stats"] = jtr.state.batch_stats
    moved = perturbed(jax.tree_util.tree_map(np.asarray, variables))
    jtr.state = jtr.state.replace(
        params=moved["params"], ema_params=perturbed(
            {"params": jtr.state.ema_params}, seed=4)["params"],
        batch_stats=moved.get("batch_stats"))
    jtr.epoch = EPOCH
    jtr.save()
    jax_wait()
    with open(exp / "training.csv", "w") as f:
        f.write(f"epoch,itr,loss,time\n{EPOCH},10,1.0,3\n7,14,0.9,5\n")
    jtr.resume(epoch=EPOCH)
    return exp, cfg, jtr


@pytest.fixture(scope="module")
def stage2(tmp_path_factory):
    return _exp(tmp_path_factory.mktemp("int8_stage2"), False)


@pytest.fixture(scope="module")
def completion(tmp_path_factory):
    return _exp(tmp_path_factory.mktemp("int8_completion"), True)


@pytest.fixture(autouse=True)
def env(monkeypatch):
    """The JAX package's int8 knobs start unset; `monkeypatch` undoes what a
    test sets."""
    for var in ("LDT_SERVE_INT8", "LDT_ATTN_INT8", "LDT_INT8_STATIC",
                "LDT_INT8_STATIC_FILE", "LDT_INT8_BF16_TAIL",
                "LDT_SERVE_INT8_STRICT"):
        monkeypatch.delenv(var, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(exp, cfg, completion=False, batch=None):
    """The port's trainer of `cfg`, restored with `resume()` (training.csv's
    last epoch has no file: the newest on disk)."""
    cls = tclt.Trainer if completion else tlt.Trainer
    tr = cls(dict2namespace(cfg), device="cpu")
    if batch is None:
        batch = {"tr_points": np.zeros((2, N_PTS, 3), np.float32)}
    tr.maybe_init(batch)
    tr.resume()
    assert tr.restored_ckpt == str(exp / f"checkpt_{EPOCH}.msgpack")
    return tr


def _pinned(monkeypatch, module, jtr):
    """The port's `sample_latents` in `module` takes the draws the JAX
    trainer's next `sample` makes from its key (rng -> (rng, k), k ->
    (k_sde, k_dec)); records what it was given."""
    shape = (B, SCORE["z_scale"], SCORE["z_dim"])
    _, k = jax.random.split(jtr.rng)
    x0, noise = _jax_draws(jax.random.split(k)[0], STEPS, shape)
    real, seen = module.sample_latents, []

    def sample_latents(*args, **kw):
        seen.append(kw)
        return real(*args, **dict(kw, x0=torch.from_numpy(x0),
                                  noise=torch.from_numpy(noise)))

    monkeypatch.setattr(module, "sample_latents", sample_latents)
    return seen


def _rms(a, b):
    return float(np.sqrt(np.mean((to_np(a) - to_np(b)) ** 2)))


# The int8 samplers against the JAX trainers' under LDT_SERVE_INT8=1, the
# same weights and draws, over 8 steps. Stage 2: the port's int8 latents
# must lie far closer to JAX's int8 run than the exact sampler's do,
# rms(port int8 - jax int8) <= ENVELOPE * rms(port exact - jax int8); the
# right variants read 1e-4 to 0.17 (dynamic K1, dynamic K8, static K8; a
# LayerNorm tie as in test_torch_port_int8_cond reads the most), K8 with
# scales per batch element 0.50-0.53, the static scales of the step before
# 0.74. The completion trainer (its JAX `sample` gives clouds, not latents)
# cannot be held as closely: its jitted step rounds the conditional chain
# (the stacked AdaLN GEMM, SiLU) other than the eager ops that the port
# follows bit for bit (test_torch_port_int8_cond), by about as much as the
# quantization moves the clouds (a JAX-jitted step against the eager one:
# 0.9% of the largest |value|). It is held to the size of the quantization
# error: rms(port int8 - exact) / rms(jax int8 - exact) within
# [1 / COND_FACTOR, COND_FACTOR]; the right variants read 0.91-1.32, k and
# v swapped in K2 50-63, an exact run 0.
ENVELOPE = 0.3
COND_FACTOR = 3.0


def _jax_sample(monkeypatch, jtr, completion=False, **env):
    """The JAX trainer's next sample (its `sample`'s key split) with the
    LDT_* knobs `env`: its step rebuilt, since the knobs are read at trace
    time (as the golden-gate script does), the static scales loaded as its
    `sample` does, and compiled without XLA's excess precision. By default
    XLA's CPU fusions keep bf16 chains in f32, which moves an 8-step int8
    run about as far as the quantization itself does; without it the jitted
    step rounds as the package's eager ops, and the port, do."""
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    jtr._build_steps()
    if env.get("LDT_INT8_STATIC") == "1":
        jtr._ensure_act_scales(True)
    jtr.rng, k = jax.random.split(jtr.rng)
    params = jtr.state.eval_params()
    if completion:
        step, static = jtr._cond_sample_step, (4, 5)
        args = (params, jtr.state.batch_stats, jtr.comp_vars, k, B, N_PTS,
                _jax_condition())
    else:
        step, static = jtr._sample_step, (3, 4)
        args = (params, jtr.comp_vars, k, B, N_PTS, None, None)
    compiled = step.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    out = compiled(*(a for i, a in enumerate(args) if i not in static))
    return out if completion else out[1]


def _condition():
    rng = np.random.default_rng(7)
    return {"img": rng.uniform(0, 1, (B, IMG, IMG, 3)).astype(np.float32),
            "pts": rng.standard_normal((B, N_PTS, 3)).astype(np.float32)}


def _jax_condition():
    return {k: jnp.asarray(v) for k, v in _condition().items()}


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_stage2_int8_sample_matches_jax(mode, stage2, monkeypatch, capsys):
    """`sample(B, serve_int8=True)`: dynamic scales through K1, or the
    checkpoint's static scales (written by the port's calibrate entry,
    read by both packages) through K8, against the JAX trainer under
    LDT_SERVE_INT8=1 (LDT_INT8_STATIC=1 and LDT_ATTN_INT8=1)."""
    exp, cfg, jtr = stage2
    static = mode == "static"
    knobs = dict(attn_int8=static, static_act=static)
    env = {"LDT_SERVE_INT8": "1"}
    if static:
        if not os.path.exists(tint8.act_scales_path(jtr._restored_ckpt)):
            int8_calibrate.main(int8_calibrate.get_parser().parse_args(
                ["--exp", str(exp), "--batch", str(B), "--device", "cpu"]))
        env.update(LDT_INT8_STATIC="1", LDT_ATTN_INT8="1")
    tr = _port(exp, cfg)
    seen = _pinned(monkeypatch, tlt, jtr)
    want = _jax_sample(monkeypatch, jtr, **env)
    got = tr.sample(B, serve_int8=True, **knobs)[1]
    exact = tr.sample(B)[1]
    assert seen[0]["int8"] and seen[0]["attn_int8"] == static
    assert ("act_scales" in seen[0]) == static and "int8" not in seen[1]
    if static:
        np.testing.assert_array_equal(
            seen[0]["act_scales"].numpy(), np.asarray(jint8.load_act_scales(
                jtr._restored_ckpt, STEPS, SCORE["num_blocks"], jtr.cfg)))
    assert got.shape == (B, SCORE["z_scale"], SCORE["z_dim"])
    ratio = _rms(got, want) / _rms(exact, want)
    assert ratio <= ENVELOPE, ratio
    # no stamp next to the checkpoint: a warning, once per restored
    # checkpoint and sampler config
    assert capsys.readouterr().out.count("no int8 golden-gate stamp") == 1


def test_completion_int8_sample_matches_jax(completion, monkeypatch):
    """`sample(B, condition=, int8=True, attn_int8=True)`: the condition
    encoded once, the conditional twin through K2 and K8, against the JAX
    completion trainer under LDT_SERVE_INT8=1 and LDT_ATTN_INT8=1."""
    exp, cfg, jtr = completion
    tr = _port(exp, cfg, True, _condition_batch())
    seen = _pinned(monkeypatch, tclt, jtr)
    want = _jax_sample(monkeypatch, jtr, True, LDT_SERVE_INT8="1",
                       LDT_ATTN_INT8="1")
    runs = tr.score.c_net.resnet.runs
    got = tr.sample(B, condition=_condition(), int8=True, attn_int8=True)[0]
    assert tr.score.c_net.resnet.runs == runs + 1
    exact = tr.sample(B, condition=_condition())[0]
    assert seen[0]["int8"] and seen[0]["attn_int8"]
    assert "int8" not in seen[1]
    ratio = _rms(got, exact) / _rms(want, exact)
    assert 1 / COND_FACTOR <= ratio <= COND_FACTOR, ratio


def _condition_batch():
    c = _condition()
    return {"views": c["img"], "pc": c["pts"], "pc_part": c["pts"]}


def test_gate_checked_once_per_restore_and_strict_raises(stage2,
                                                         completion,
                                                         monkeypatch):
    """The stamp is checked on the first int8 sample of a restored
    checkpoint and sampler config, again after a `resume`, never for the
    exact sampler; `strict` raises; the completion trainer checks with
    `completion=True`; a JAX-written PASSED stamp is quiet."""
    calls = []
    real = tint8.verify_gate_stamp

    def spy(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(tint8, "verify_gate_stamp", spy)
    exp, cfg, _ = stage2
    tr = _port(exp, cfg)
    tr.sample(2)
    assert calls == []
    for _ in range(2):
        tr.sample(2, serve_int8=True)
    assert len(calls) == 1 and calls[0][0][0] == tr.restored_ckpt
    tr.sample(2, serve_int8=True, attn_int8=True)
    assert len(calls) == 2
    with pytest.raises(RuntimeError, match="int8-gate"):
        tr.sample(2, serve_int8=True, strict=True)
    tr.resume()
    tr.sample(2, serve_int8=True)
    assert len(calls) == 4
    # the JAX package's verdict for this checkpoint and config is honoured
    path = jint8.write_gate_stamp(tr.restored_ckpt, jax_ns(cfg), False,
                                  passed=True, results={}, threshold=0.01)
    try:
        tr.resume()
        assert real(tr.restored_ckpt, tr.cfg, False) is None
        tr.sample(2, serve_int8=True, strict=True)
    finally:
        os.remove(path)
    exp, cfg, _ = completion
    ctr = _port(exp, cfg, True, _condition_batch())
    cond = {k: v[:2] for k, v in _condition().items()}
    ctr.sample(2, condition=cond, int8=True)
    assert calls[-1][0][2] is True and calls[-1][0][0] == ctr.restored_ckpt
    with pytest.raises(RuntimeError, match="int8-gate"):
        ctr.sample(2, condition=cond, int8=True, strict=True)
    n = len(calls)
    ctr.sample(2, condition=cond)  # exact: no check
    ctr.sample(2, condition=None, int8=True)  # no condition: exact
    assert len(calls) == n


def test_static_scales_reload_after_resume_to_another_checkpoint(
        stage2, tmp_path, monkeypatch):
    """Static scales load once per restored checkpoint; a `resume` to
    another checkpoint serves that one's scales (the JAX trainer's jitted
    step keeps the first ones as constants: the port does not); asking for
    them without a table raises."""
    exp, cfg, _ = stage2
    tr = _port(exp, cfg)
    seen = []
    real = tlt.sample_latents
    monkeypatch.setattr(tlt, "sample_latents",
                        lambda *a, **kw: seen.append(kw) or real(*a, **kw))
    loads = []
    real_load = tint8.load_act_scales
    monkeypatch.setattr(tint8, "load_act_scales",
                        lambda *a, **kw: loads.append(a[0]) or
                        real_load(*a, **kw))
    nb = SCORE["num_blocks"]
    first = tr.restored_ckpt
    s1 = np.full((STEPS, nb, 4), 0.05, np.float32)
    s2 = np.full((STEPS, nb, 4), 0.07, np.float32)
    # the JAX package writes the first table, the port the second
    jint8.save_act_scales(first, s1, predictor="ancestral")
    other = str(tmp_path / "checkpt_9.pt")
    tr.epoch = 9
    tlt.save_checkpoint(other, tr.state_tree(), cfg=tr.cfg, epoch=9, itr=0,
                        time=0.0)
    tint8.save_act_scales(other, s2, predictor="ancestral")
    with contextlib.redirect_stdout(io.StringIO()):
        tr.sample(2, serve_int8=True, static_act=True)
        tr.sample(2, serve_int8=True, static_act=True)
        tr.resume(pretrain=other)
        tr.sample(2, serve_int8=True, static_act=True)
    assert loads == [first, other]
    assert float(seen[0]["act_scales"].max()) == float(s1.max())
    assert float(seen[2]["act_scales"].max()) == float(s2.max())
    assert np.asarray(jint8.load_act_scales(other, STEPS, nb)).max() == \
        np.float32(0.07)
    os.remove(tint8.act_scales_path(other))
    tr.resume(pretrain=other)
    with pytest.raises(RuntimeError, match="int8-static"):
        tr.sample(2, serve_int8=True, static_act=True)
    # restore the module's checkpoint scales for the other tests
    os.remove(tint8.act_scales_path(first))


def _gate(exp, *extra):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = int8_golden_gate.main(int8_golden_gate.get_parser().parse_args(
            ["--exp", str(exp), "--device", "cpu", *extra]))
    return rc, out.getvalue()


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_entries_unconditional(mode, stage2, monkeypatch):
    """`int8_calibrate` writes the checkpoint's scale table (the JAX
    loader reads it); `int8_golden_gate` resolves the newest checkpoint on
    disk, samples both legs, prints the deltas and the verdict, and stamps
    it in the JAX format (the JAX check finds it); the port's trainer then
    serves quietly after a PASSED stamp."""
    exp, cfg, jtr = stage2
    ckpt = jtr._restored_ckpt
    extra = ["--num", "4", "--threshold", "inf"]
    if mode == "static":
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            path = int8_calibrate.main(int8_calibrate.get_parser().parse_args(
                ["--exp", str(exp), "--batch", "2", "--margin", "1.5",
                 "--device", "cpu"]))
        assert path == jint8.act_scales_path(ckpt)
        assert f"checkpt_{EPOCH}.msgpack" in out.getvalue()
        scales = np.asarray(jint8.load_act_scales(ckpt, STEPS,
                                                  SCORE["num_blocks"],
                                                  jtr.cfg))
        assert scales.shape == (STEPS, SCORE["num_blocks"], 4)
        assert (scales > 0).all()
        meta = json.loads(str(np.load(path)["meta"]))
        assert meta["margin"] == 1.5 and meta["epoch"] == EPOCH
        extra += ["--static-act", "--attn-int8"]
        monkeypatch.setenv("LDT_INT8_STATIC", "1")
        monkeypatch.setenv("LDT_ATTN_INT8", "1")
    rc, out = _gate(exp, *extra)
    assert f"checkpt_{EPOCH}.msgpack" in out
    assert "[gate] exact:" in out and "[gate] int8:" in out
    assert "clouds/min" in out and "rel delta" in out
    assert rc == 0 and "PASSED" in out
    assert jint8.verify_gate_stamp(ckpt, jax_ns(cfg), False) is None
    tr = _port(exp, cfg)
    knobs = dict(attn_int8=True, static_act=True) if mode == "static" \
        else {}
    assert tint8.verify_gate_stamp(ckpt, tr.cfg, False, **knobs) is None
    tr.sample(2, serve_int8=True, strict=True, **knobs)
    if mode == "static":
        os.remove(tint8.act_scales_path(ckpt))
    os.remove(tint8.gate_stamp_path(ckpt))


def test_entries_refuse(stage2, tmp_path):
    """The calibration refuses a predictor other than ancestral; the gate
    a conditional run with static scales; a real threshold gives a verdict
    either way (exit code 0 or 1, stamped as such)."""
    exp, cfg, jtr = stage2
    other = tmp_path / "exp"
    other.mkdir()
    with open(other / "config.yaml", "w") as f:
        yaml.safe_dump(dict(cfg, sde=dict(cfg["sde"], predictor="ddim")), f)
    with pytest.raises(SystemExit, match="ancestral"):
        int8_calibrate.main(int8_calibrate.get_parser().parse_args(
            ["--exp", str(other), "--device", "cpu"]))
    with pytest.raises(SystemExit, match="static"):
        _gate(exp, "--completion", "--static-act")
    rc, out = _gate(exp, "--num", "4")
    assert rc in (0, 1) and ("PASSED" in out) == (rc == 0)
    entries = tint8._load_stamp_entries(tint8.gate_stamp_path(
        jtr._restored_ckpt))
    assert entries == jint8._load_stamp_entries(jint8.gate_stamp_path(
        jtr._restored_ckpt))
    (entry,) = entries
    assert entry["passed"] == (rc == 0) and entry["threshold"] == 0.01
    assert entry["sampler"] == jint8._sampler_signature(jtr.cfg, False)
    os.remove(tint8.gate_stamp_path(jtr._restored_ckpt))


def test_entries_completion(completion, monkeypatch):
    """`int8_golden_gate --completion --attn-int8`: both legs on the ViPC
    test items, CD x 1000 and F1, the paired CD, a stamp that the JAX
    package's completion check finds."""
    exp, cfg, jtr = completion
    rc, out = _gate(exp, "--completion", "--attn-int8", "--num", "2",
                    "--threshold", "inf")
    assert f"checkpt_{EPOCH}.msgpack" in out
    assert "cd_x1000" in out and "f1score" in out and "paired CD" in out
    assert rc == 0 and "PASSED" in out
    monkeypatch.setenv("LDT_ATTN_INT8", "1")
    ckpt = jtr._restored_ckpt
    assert jint8.verify_gate_stamp(ckpt, jax_ns(cfg), True) is None
    tr = _port(exp, cfg, True, _condition_batch())
    cond = {k: v[:2] for k, v in _condition().items()}
    tr.sample(2, condition=cond, int8=True, attn_int8=True, strict=True)
    os.remove(tint8.gate_stamp_path(ckpt))


def test_hybrid_trainer_records_its_restores(stage2, tmp_path, monkeypatch):
    """The Hybrid trainer (the stage-2 trainer's serving branch) records
    the stage-2 dual checkpoint `load_pretrain` bootstraps from and the
    file a `resume` restores; its int8 sample checks the stamp of the one
    it holds."""
    from ldt_torch.training.checkpoint import wait_pending_saves
    from ldt_torch.training.hybrid_trainer import Trainer as Hybrid

    exp, cfg, jtr = stage2
    d = dict(cfg, opt=dict(cfg["opt"], alpha=1.0, compressor_warmup=0,
                           compressor_beta1=0.9, compressor_beta2=0.999,
                           pretrain_path=jtr._restored_ckpt),
             log=dict(cfg["log"], save_path=str(tmp_path)))
    tr = Hybrid(dict2namespace(d), device="cpu")
    tr.maybe_init({"tr_points": np.zeros((2, N_PTS, 3), np.float32)})
    assert tr.restored_ckpt is None
    tr.load_pretrain()
    assert tr.restored_ckpt == jtr._restored_ckpt
    calls = []
    monkeypatch.setattr(tint8, "verify_gate_stamp",
                        lambda *a, **kw: calls.append(a[0]))
    tr.sample(2, serve_int8=True)
    tr.epoch = 1
    tr.save()
    wait_pending_saves()
    tr.resume()
    assert tr.restored_ckpt == str(tmp_path / "checkpt_1.pt")
    tr.sample(2, serve_int8=True)
    assert calls == [jtr._restored_ckpt, tr.restored_ckpt]
