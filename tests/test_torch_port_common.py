"""Shared helpers of the ldt_torch port tests, and the package-level checks:
the port imports neither JAX nor ldt_tpu, and its entry points refuse to run
without a card unless the CPU is asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.configs as jax_configs
import ldt_torch.configs as torch_configs
from ldt_tpu.tools.io import dict2namespace as jax_ns
from ldt_torch.configs import dict2namespace as torch_ns

ROOT = Path(__file__).resolve().parents[1]

# tests/test_mods_fastpath.py::small_score_cfg
SMALL_SCORE = dict(
    num_steps=10, z_dim=8, z_scale=8, hidden_size=32, num_heads=4,
    num_blocks=3, num_categorys=1, t_dim=16, dropout=0.0,
    norm="layer_norm", learn_sigma=False, act="swish", unet=False,
    AdaLN=True, condition=False)

# tests/test_pallas_attention.py::test_compressor_fused_forward_and_grads_match
SMALL_COMPRESSOR = dict(
    outsize=64, max_outputs=64, input_dim=3, z_dim=4, z_scales=8,
    p_dim=16, n_layers=2, hidden_dim=32, num_heads=2, activation="swish",
    encoder_dropout_p=0.0, decoder_dropout_p=0.0, norm="layer_norm",
    neighbors=8, encoder_layers=1, mlp_ratio=2.0, min_sigma=-30,
    cluster_norm="anchor", norm_input=False, pre_group=False,
    decoder_act=None, ActNorm=True, AdaLN=True, pos_embedding="center",
    class_condition=False, num_categorys=1, pretrain_path=None)

SDE = dict(beta_start=0.1, beta_end=20.0, sde_type="vpsde", sigma2_0=0.0,
           time_eps=0.01, sample_time_eps=1e-6, sample_mode="discrete",
           train_N=1000, sample_N=64)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# f32: the same arithmetic in another order. bf16: JAX and PyTorch round to
# bf16 at different places (a GEMM's bias add, GELU's inner ops), so a few
# bf16 ulps (2^-8 relative each) of the largest |value|.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 3e-2


def cfgs(d):
    """The same config dict as a JAX-side and a torch-side namespace."""
    return jax_ns(dict(d)), torch_ns(dict(d))


def params_np(variables):
    """flax variables -> numpy params tree (the weight converter's input)."""
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, want, dtype: str, rel: float = BF16_REL) -> None:
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        err = np.abs(got - want).max()
        scale = max(1.0, float(np.abs(want).max()))
        assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("name", ["score_cfg", "compressor_cfg", "sde_cfg"])
def test_config_defaults_match_ldt_tpu(name):
    assert vars(getattr(torch_configs, name)()) == vars(
        getattr(jax_configs, name)())
    over = dict(num_heads=2, extra={"k": 1})
    got = getattr(torch_configs, name)(**over)
    want = getattr(jax_configs, name)(**over)
    assert got.num_heads == want.num_heads == 2 and got.extra.k == 1


def test_dict2namespace_matches_ldt_tpu():
    d = {"a": 1, "b": {"c": [1, 2], "d": {"e": None}}}
    got, want = torch_ns(d), jax_ns(d)
    assert got.a == want.a and got.b.c == want.b.c
    assert got.b.d.e is want.b.d.e is None
    assert vars(got.b.d) == vars(want.b.d)


def _port_sources():
    return sorted((ROOT / "ldt_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax(path):
    """No import of jax, flax, optax, yaml, msgpack or ldt_tpu anywhere in
    the port, lazy or not (the card's machine has none of them)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in (
                "jax", "jaxlib", "flax", "optax", "yaml", "msgpack",
                "ldt_tpu"), (path, name)


def test_import_leaves_jax_and_ldt_tpu_unloaded():
    mods = ["ldt_torch", "ldt_torch.configs", "ldt_torch.ops.attention",
            "ldt_torch.nn.layers", "ldt_torch.models", "ldt_torch.diffusion",
            "ldt_torch.diffusion.sampling", "ldt_torch.weights",
            "ldt_torch.generate", "ldt_torch.serving",
            "ldt_torch.serving.int8", "ldt_torch.ops.geometry",
            "ldt_torch.training.state", "ldt_torch.training.base",
            "ldt_torch.training.latent_sde_trainer",
            "ldt_torch.training.compressor_trainer", "ldt_torch.ops.chamfer",
            "ldt_torch.ops.emd", "ldt_torch.eval.loss", "ldt_torch.eval",
            "ldt_torch.eval.metrics", "ldt_torch.ops._eval_kernels",
            "ldt_torch.tools", "ldt_torch.tools.io", "ldt_torch.tools.log",
            "ldt_torch.tools.utils", "ldt_torch.data",
            "ldt_torch.data.loader", "ldt_torch.data.shapenet55",
            "ldt_torch.training.checkpoint",
            "ldt_torch.training.jax_checkpoint", "ldt_torch.cli",
            "ldt_torch.entries", "ldt_torch.entries.train_compressor",
            "ldt_torch.entries.train_latent_diffusion",
            "ldt_torch.entries.val_sample", "ldt_torch.entries.golden_eval",
            "ldt_torch.tools.port", "ldt_torch.data.png",
            "ldt_torch.data.vipc", "ldt_torch.tools.synth_vipc",
            "ldt_torch.training.completion_compressor_trainer",
            "ldt_torch.training.completion_latent_sde_trainer",
            "ldt_torch.entries.train_completion_compressor",
            "ldt_torch.entries.train_completion_latent_diffusion",
            "ldt_torch.diffusion.sde", "ldt_torch.training.hybrid_trainer",
            "ldt_torch.entries.train_hybrid", "ldt_torch.tools.profiling",
            "ldt_torch.entries.int8_calibrate", "ldt_torch.tools.vis_utils",
            "ldt_torch.data.fastload",
            "ldt_torch.entries.int8_golden_gate", "chip_smoke"]
    code = (f"import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'yaml', 'msgpack', "
            "'ldt_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_profiling_twin_traces_spans_and_times(tmp_path, monkeypatch):
    """`ldt_torch.tools.profiling` as `ldt_tpu.tools.profiling`: `trace`
    writes a trace file holding the `annotate` spans, `StepTimer` is the
    same meter (a rolling mean of the last `window` intervals)."""
    import ldt_tpu.tools.profiling as jprof
    from ldt_torch.tools import profiling

    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("ldt_span"):
            torch.ones(8).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert "ldt_span" in {e.key for e in prof.key_averages()}
    assert "ldt_span" in (tmp_path / "trace.json").read_text()
    ticks = []
    for timer in (jprof.StepTimer(window=2), profiling.StepTimer(window=2)):
        clock = iter([0.0, 1.0, 3.0, 6.0, 10.0])
        monkeypatch.setattr(profiling.time, "perf_counter",
                            lambda: next(clock))
        ticks.append(([timer.tick() for _ in range(5)], timer.rate(8)))
    assert ticks[0] == ticks[1] == ([None, 1.0, 1.5, 2.5, 3.5], 8 / 3.5)


def _entry_points():
    from ldt_torch import resolve_device
    from ldt_torch.configs import compressor_cfg, score_cfg, sde_cfg
    from ldt_torch.tools.utils import common_init
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.diffusion.sampling import sample_discrete, timesteps
    from ldt_torch.generate import generate, sample_latents
    from ldt_torch.models import Compressor, Score
    from ldt_torch.serving.int8 import (
        calibrate_act_scales,
        quantize_score_params,
    )

    small = torch_ns(dict(SMALL_SCORE))
    small_c = torch_ns(dict(SMALL_COMPRESSOR))

    def gen(**kw):
        s = Score(small, device="cpu")
        c = Compressor(small_c, device="cpu")
        d = make_diffusion(torch_ns(dict(SDE)), device="cpu")
        return generate(s, c, d, 2, 64, **kw)

    def latents(**kw):
        s = Score(small, device="cpu")
        d = make_diffusion(torch_ns(dict(SDE)), device="cpu")
        return sample_latents(s, d, 2, 64, **kw)

    def sampler(**kw):
        d = make_diffusion(torch_ns(dict(SDE)), device="cpu")
        return sample_discrete(d, lambda t, x, i: (-x, x), 2, (3,), 64, **kw)

    def calibrate(**kw):
        s = Score(small, device="cpu")
        d = make_diffusion(torch_ns(dict(SDE)), device="cpu")
        with torch.inference_mode():
            mods = s.precompute_mods(timesteps(64, 1e-6))
        return calibrate_act_scales(
            d, mods, quantize_score_params(s, small.num_blocks),
            small.num_heads, 2, (small.z_scale, small.z_dim), 64, **kw)

    def trainer(**kw):
        from ldt_torch.configs import latent_trainer_cfg
        from ldt_torch.training.latent_sde_trainer import Trainer

        return Trainer(latent_trainer_cfg(score=SMALL_SCORE,
                                          compressor=SMALL_COMPRESSOR,
                                          sde=SDE), **kw)

    def hybrid_trainer(**kw):
        from ldt_torch.configs import hybrid_trainer_cfg
        from ldt_torch.training.hybrid_trainer import Trainer

        return Trainer(hybrid_trainer_cfg(score=SMALL_SCORE,
                                          compressor=SMALL_COMPRESSOR,
                                          sde=SDE), **kw)

    def family(sde_type, **over):
        return lambda **kw: make_diffusion(
            sde_cfg(sde_type=sde_type, **over), **kw)

    def stage1_trainer(**kw):
        from ldt_torch.configs import compressor_trainer_cfg
        from ldt_torch.training.compressor_trainer import Trainer

        return Trainer(compressor_trainer_cfg(model=SMALL_COMPRESSOR), **kw)

    from ldt_torch import eval as metrics
    from ldt_torch.ops.chamfer import pairwise_cd_means
    from ldt_torch.ops.emd import approx_match_cost

    clouds = np.random.default_rng(0).uniform(0, 1, (3, 16, 3)).astype(
        np.float32)

    def on_device(fn):
        """`fn` on tensors on the device the entry point is given."""
        def run(device="cuda"):
            dev = resolve_device(device)
            return fn(*(torch.from_numpy(clouds).to(dev) for _ in range(2)))
        return run

    return {
        "compute_all_metrics": lambda **kw: metrics.compute_all_metrics(
            clouds, clouds, 2, verbose=False, **kw),
        "compute_CD_metrics": lambda **kw: metrics.compute_CD_metrics(
            clouds, clouds, 2, verbose=False, **kw),
        "EMD_CD": lambda **kw: metrics.EMD_CD(clouds, clouds, 2, **kw),
        "pairwise_CD": lambda **kw: metrics.pairwise_CD(clouds, clouds, 2,
                                                        **kw),
        "pairwise_EMD_CD": lambda **kw: metrics.pairwise_EMD_CD(
            clouds, clouds, 2, **kw),
        "jsd_between_point_cloud_sets":
        lambda **kw: metrics.jsd_between_point_cloud_sets(
            clouds - 0.5, clouds - 0.5, 8, **kw),
        "approx_match_cost": on_device(approx_match_cost),
        "pairwise_cd_means": on_device(pairwise_cd_means),
        "resolve_device": lambda **kw: resolve_device(**kw),
        "common_init": lambda **kw: common_init(0, **kw),
        "Trainer": trainer,
        "stage1_Trainer": stage1_trainer,
        "Score": lambda **kw: Score(score_cfg(num_blocks=1), **kw),
        "Compressor": lambda **kw: Compressor(compressor_cfg(), **kw),
        "make_diffusion": lambda **kw: make_diffusion(sde_cfg(), **kw),
        "make_diffusion_sub_vpsde": family("sub_vpsde"),
        "make_diffusion_vesde": family("vesde", sigma2_0=0.01,
                                       sigma2_min=0.01, sigma2_max=50.0),
        "make_diffusion_geometric_sde": family("geometric_sde",
                                               sigma2_min=3e-5,
                                               sigma2_max=0.999),
        "hybrid_Trainer": hybrid_trainer,
        "sample_discrete": sampler,
        "generate": gen,
        "generate_int8": lambda **kw: gen(int8=True, attn_int8=True, **kw),
        "sample_latents": latents,
        "calibrate_act_scales": calibrate,
    }


@pytest.mark.parametrize("name", ["resolve_device", "common_init", "Score",
                                  "Compressor",
                                  "make_diffusion", "sample_discrete",
                                  "generate", "generate_int8",
                                  "sample_latents", "calibrate_act_scales",
                                  "Trainer", "stage1_Trainer",
                                  "hybrid_Trainer",
                                  "make_diffusion_sub_vpsde",
                                  "make_diffusion_vesde",
                                  "make_diffusion_geometric_sde",
                                  "compute_all_metrics", "compute_CD_metrics",
                                  "EMD_CD", "pairwise_CD", "pairwise_EMD_CD",
                                  "jsd_between_point_cloud_sets",
                                  "approx_match_cost", "pairwise_cd_means"])
def test_entry_points_need_a_card_unless_cpu_is_asked(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    fn = _entry_points()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    fn(device="cpu")


def perturbed(variables, seed: int = 3):
    """flax variables (numpy) with every leaf moved off its initial value,
    so that each mapping is exercised: params + 0.05 N(0, 1), running means
    + 0.2 N(0, 1), running variances times U(0.5, 2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        if path[0].key == "batch_stats" and path[-1].key == "var":
            return (a * rng.uniform(0.5, 2.0, a.shape)).astype(np.float32)
        scale = 0.2 if path[0].key == "batch_stats" else 0.05
        return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(variables))


def compressor_variables(d, pts, label=None, train: bool = False):
    """numpy variables {'params', 'batch_stats'} of ldt_tpu's Compressor of
    the config dict `d`, initialized on the clouds `pts` (and `label`)."""
    import ldt_tpu.models.compressor as jcm

    jcfg, _ = cfgs(d)
    v = jax.jit(jcm.Compressor(jcfg).init, static_argnames=("train",))(
        {"params": jax.random.key(1), "sample": jax.random.key(2)},
        jnp.asarray(pts), label=None if label is None else jnp.asarray(label),
        train=train)
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  {"params": v["params"],
                                   "batch_stats": v.get("batch_stats", {})})


def pin_reparameterize(monkeypatch, noise):
    """ldt_tpu's Compressor draws its reparameterization noise from `noise`
    (numpy arrays, in decode order) instead of its rng."""
    import ldt_tpu.models.compressor as jcm

    draws = iter(noise)
    monkeypatch.setattr(jcm, "reparameterize",
                        lambda rng, mu, logvar: mu + jnp.exp(logvar / 2.0)
                        * jnp.asarray(next(draws)))


def trees_equal(a, b) -> bool:
    """Two trees of the same structure with equal leaves: arrays and
    tensors bit for bit, anything else (counters, None) by ==."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and set(a) == set(b)
                and all(trees_equal(a[k], b[k]) for k in a))
    if hasattr(a, "shape") and hasattr(b, "shape"):
        return np.array_equal(to_np(a), to_np(b))
    return a == b
