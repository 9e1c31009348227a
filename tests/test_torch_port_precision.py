"""Training precision against ldt_tpu on the CPU: the bf16 Adam moments
(`opt.moment_dtype`, the shipped `airplane_synth_mbf16` config) and the
pieces of mixed precision (`common.train_dtype: bfloat16`: f32
parameters, bf16 compute).

* The bf16-moment optimizer against `scale_by_adam_q`, its checkpoints both
  ways (f32 <-> bf16 moments, the JAX `.msgpack` bridge), and the mbf16
  config through both packages' stage-2 entries, with a resume leg.
* `train_dtype`'s names, f32 weights in a bf16 net without a cast, the
  losses on bf16 reconstructions. The trainers' bf16 steps against JAX's:
  test_torch_port_precision_steps.py and _conditional.py, which share
  this file's weights and helpers.
"""

import copy
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import ldt_tpu.training.checkpoint as jckpt
import ldt_tpu.training.latent_sde_trainer as jlt
import ldt_tpu.training.state as jstate
import train_Latent_Diffusion as jax_stage2_entry
from ldt_tpu.models import Compressor as JaxCompressor
from ldt_tpu.models import Score as JaxScore
from ldt_tpu.tools.io import dict2namespace as jax_ns
from ldt_torch.cli import get_parser
from ldt_torch.entries import train_latent_diffusion
from ldt_torch.models import Compressor, Score
from ldt_torch.ops.chamfer import chamfer_loss
from ldt_torch.ops.emd import emd_loss
from ldt_torch.tools.io import dict2namespace
from ldt_torch.tools.utils import train_dtype
from ldt_torch.training import checkpoint as tckpt
from ldt_torch.training import latent_sde_trainer as tlt
from ldt_torch.training import state as tstate
from ldt_torch.training.jax_checkpoint import save_jax_checkpoint
from ldt_torch.weights import score_state_dict
from test_torch_port_checkpoint import run_cfg
from test_torch_port_common import SMALL_COMPRESSOR, SMALL_SCORE

ROOT = Path(__file__).resolve().parents[1]
MBF16 = ROOT / ("experiments/Latent_Diffusion_Trainer/airplane_synth_mbf16/"
                "config.yaml")
B, N = 2, 64
C = SMALL_COMPRESSOR
SCORE = dict(SMALL_SCORE, num_blocks=2)
COND = dict(SCORE, condition=True)
Z = (SCORE["z_scale"], SCORE["z_dim"])
IMG = 16
LR = 1e-3
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _bf16(a):
    """`a` rounded to bf16, held in f32 (a draw both frameworks take)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _jx(tree):
    """A tree of the converters' torch tensors as JAX arrays."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), tree)


def _adam(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]


@pytest.fixture(scope="module")
def nets():
    """Random weights drawn by the port (sparing the JAX inits' compiles):
    an unconditional and a conditional Score and a Compressor whose ActNorm
    and decoder are set up as the hybrid tests set them (outputs ~1
    across, so the auction EMD has work)."""
    gen = torch.Generator().manual_seed(1)
    comp = Compressor(dict2namespace(C), device="cpu", generator=gen)
    comp.init_actnorm(_t(_rand((2, N, 3), 3)), train=True)
    sd = dict(comp.state_dict())
    for k in ("output_dense.weight", "output_dense.bias"):
        sd[k] = sd[k] * 0.1
    score = Score(dict2namespace(SCORE), device="cpu", generator=gen)
    cond = Score(dict2namespace(COND), device="cpu", generator=gen)
    return {"comp": sd, "score": dict(score.state_dict()),
            "cond": dict(cond.state_dict())}


# ------------------------------------------------ the bf16 Adam moments

def _tree_pair(seed):
    rng = np.random.default_rng(seed)
    p = {"a": rng.standard_normal((64, 33)).astype(np.float32),
         "b": rng.standard_normal((1000,)).astype(np.float32)}
    return p


def _grads(step, p):
    rng = np.random.default_rng(100 + step)
    scale = 0.001 if step % 3 == 0 else 0.3  # clipped and unclipped steps
    return {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in p.items()}


@pytest.mark.parametrize("weight_decay,clip", [(0.0, 1.0), (0.01, 0.5)])
def test_bf16_moments_track_scale_by_adam_q(weight_decay, clip):
    """Ten steps. From the same state each step's update is JAX's within
    1e-6 of its largest (f32 rounding of the clip's norm) and the stored
    bf16 moments equal, or one bf16 ulp apart where the f32 value sat on a
    rounding boundary (at most 0.1% of them); run freely, the stored
    moments stay equal or a bf16 ulp apart on at most 1%, and the updates
    within 1 bf16 ulp (2^-8) of their largest."""
    p = _tree_pair(0)
    jtx = jstate.make_optimizer(0.9, 0.999, weight_decay, clip, "bfloat16")
    ttx = tstate.make_optimizer(0.9, 0.999, weight_decay, clip, "bfloat16")
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    for pinned in (True, False):
        jo, to = jtx.init(jp), ttx.init(tp)
        assert all(t.dtype == BF16 for s in (to.mu, to.nu)
                   for t in s.values())
        for step in range(10):
            if pinned:
                adam = _adam(jo)
                for k in p:
                    to.mu[k].copy_(torch.from_numpy(np.asarray(
                        adam.mu[k], np.float32)))
                    to.nu[k].copy_(torch.from_numpy(np.asarray(
                        adam.nu[k], np.float32)))
            g = _grads(step, p)
            ju, jo = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jo, jp)
            tu = ttx.update({k: _t(v) for k, v in g.items()}, to, tp)
            for i, k in enumerate(p):
                want = np.asarray(ju[k])
                err = np.abs(tu[i].numpy() - want).max() / np.abs(want).max()
                assert err <= (1e-6 if pinned else 2 ** -8), (step, k, err)
        adam = _adam(jo)
        assert to.count == int(adam.count) == 10
        for n in ("mu", "nu"):
            for k in p:
                want = getattr(adam, n)[k]
                assert want.dtype == jnp.bfloat16
                got = getattr(to, n)[k]
                a = got.float().numpy()
                b = np.asarray(want, np.float32)
                ulp = np.abs(b) * 2 ** -7  # a bf16 ulp is <= 2^-7 |x|
                assert (np.abs(a - b) <= ulp).all(), (n, k)
                assert (a != b).mean() <= (1e-3 if pinned else 1e-2), (n, k)


def test_moment_dtype_names():
    """float32 keeps optax's `scale_by_adam` (f32 moments); a name JAX's
    `jnp.dtype` refuses is refused by the port too."""
    tx = tstate.make_optimizer(moment_dtype="float32")
    assert tx.init({"w": torch.zeros(3)}).mu["w"].dtype == torch.float32
    assert tstate.make_optimizer(moment_dtype="float16").init(
        {"w": torch.zeros(3)}).nu["w"].dtype == torch.float16
    for bad in ("bf16", "float8"):
        with pytest.raises(TypeError):
            jnp.dtype(bad)
        with pytest.raises(ValueError, match="moment_dtype"):
            tstate.make_optimizer(moment_dtype=bad)


def _stage2_cfg(save_path, moment_dtype):
    d = run_cfg(save_path, score=SCORE)
    d["opt"]["moment_dtype"] = moment_dtype
    return d


def _stepped_stage2(save_path, moment_dtype, seed=0):
    """A stage-2 trainer after two random-cloud steps, saved."""
    tr = tlt.Trainer(dict2namespace(_stage2_cfg(save_path, moment_dtype)),
                     device="cpu")
    for i in range(2):
        tr.update({"tr_points": _rand((B, N, 3), seed + i)})
    tr.save()
    tckpt.wait_pending_saves()
    return tr


@pytest.mark.parametrize("saved,resumed", [
    ("bfloat16", "bfloat16"), ("float32", "bfloat16"),
    ("bfloat16", "float32")])
def test_moment_checkpoints_restore_both_ways(tmp_path, saved, resumed):
    """Live bf16 moments through a save and resume unchanged; an f32-moment
    checkpoint (its moments rounded to bf16 on save, as the JAX trainer
    saves) restores into a bf16-moment trainer and a bf16-moment one into
    an f32-moment trainer, the moments cast to the live dtype."""
    src = _stepped_stage2(tmp_path / "a", saved)
    dst = tlt.Trainer(dict2namespace(_stage2_cfg(tmp_path / "a", resumed)),
                      device="cpu")
    dst.maybe_init({"tr_points": _rand((B, N, 3), 9)})
    dst.resume()
    want_dtype = tstate.MOMENT_DTYPES[resumed]
    for n in ("mu", "nu"):
        live, saved_m = (getattr(t.state.opt_state, n) for t in (dst, src))
        for k, v in live.items():
            assert v.dtype == want_dtype, (n, k)
            assert torch.equal(v, saved_m[k].to(BF16).to(want_dtype)), k
    assert dst.state.opt_state.count == 2 and dst.itr == 2
    for k, p in dst.state.params.items():
        assert torch.equal(p, src.state.params[k]), k
    # and the resumed trainer steps on
    dst.update({"tr_points": _rand((B, N, 3), 11)})
    assert dst.state.opt_state.mu[k].dtype == want_dtype


def _jax_stage2_trainer(d):
    jcfg = jax_ns(copy.deepcopy(d))
    return jlt.Trainer(jcfg, JaxScore(jcfg.score),
                       JaxCompressor(jcfg.compressor))


def test_the_jax_bridge_carries_bf16_moments_both_ways(tmp_path):
    """A bf16-moment port state written as a JAX `.msgpack` resumes into a
    JAX `moment_dtype: bfloat16` trainer with its moments bit for bit; and
    what that trainer saves, the port resumes bit for bit."""
    tr = _stepped_stage2(tmp_path / "port", "bfloat16")
    path = str(tmp_path / "checkpt_2.msgpack")
    save_jax_checkpoint(path, tr.state_tree(), tr.tx, tr.cfg, epoch=1,
                        itr=2)
    d = _stage2_cfg(tmp_path / "jax", "bfloat16")
    os.makedirs(d["log"]["save_path"])
    jt = _jax_stage2_trainer(d)
    jt.maybe_init({"tr_points": _rand((B, N, 3), 5)})
    restored = jckpt.restore_into({"score": jt.state,
                                   "compressor": jt.comp_vars},
                                  jckpt.load_checkpoint(path)["state"])
    adam = _adam(restored["score"].opt_state)
    assert int(adam.count) == 2
    for n in ("mu", "nu"):
        want = score_state_dict(_np(getattr(adam, n)))
        assert jax.tree_util.tree_leaves(getattr(adam, n))[0].dtype == \
            jnp.bfloat16
        for k, v in getattr(tr.state.opt_state, n).items():
            assert torch.equal(v.float(), want[k]), (n, k)
    # the JAX trainer saves that state; the port resumes it
    jt.state, jt.comp_vars = restored["score"], restored["compressor"]
    jt.epoch, jt.itr = 1, 2
    jt.save()
    jckpt.wait_pending_saves()
    back = tlt.Trainer(dict2namespace(d), device="cpu")
    back.maybe_init({"tr_points": _rand((B, N, 3), 6)})
    back.resume()
    for n in ("mu", "nu"):
        for k, v in getattr(back.state.opt_state, n).items():
            assert v.dtype == BF16
            assert torch.equal(v, getattr(tr.state.opt_state, n)[k]), k


def _tiny_mbf16(save_path, tree, stage1):
    """The shipped mbf16 config cut to size: the small nets and 64-point
    clouds on a fake tree, its `opt` section as shipped (bf16 moments,
    warm-up, EMA 0.9999)."""
    d = yaml.safe_load(MBF16.read_text())
    assert d["opt"]["moment_dtype"] == "bfloat16"
    comp = dict(C, outsize=N, max_outputs=N, pretrain_path=stage1)
    d.update(score=dict(SCORE), compressor=comp)
    d["data"].update(data_dir=str(tree), batch_size=3, test_batch_size=3,
                     tr_max_sample_points=N, te_max_sample_points=N,
                     num_workers=0)
    d["common"].update(epochs=2, num_points=N)
    d["log"].update(save_path=str(save_path), save_epoch_freq=1,
                    eval_epoch_freq=1000, log_epoch_freq=1)
    d["sde"].update(train_N=8, sample_N=64)
    return d


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("PC15k")
    rng = np.random.RandomState(0)
    for split in ("train", "val"):
        dd = root / "02691156" / split
        dd.mkdir(parents=True)
        for i in range(3):
            np.save(dd / f"m{i}.npy", rng.randn(15000, 3).astype(np.float32))
    return root


def test_the_mbf16_config_through_both_stage2_entries(tmp_path, tree):
    """The shipped mbf16 config (cut to the small nets) through the JAX
    stage-2 entry and the port's, from one JAX stage-1 checkpoint: two
    epochs, then a resume leg to three. Both keep bf16 moments; the port
    resumes the JAX entry's last checkpoint with its moments bit for bit,
    and its own resumed run writes a third training.csv row."""
    d1 = run_cfg(tmp_path / "stage1")
    from ldt_tpu.training import compressor_trainer as jct

    jcfg1 = jax_ns(copy.deepcopy(d1))
    jt1 = jct.Trainer(jcfg1, JaxCompressor(jcfg1.model))
    jt1.maybe_init({"tr_points": _rand((2, N, 3), 0)})
    jt1.save()
    stage1 = os.path.join(d1["log"]["save_path"], "checkpt_1.msgpack")

    dj = _tiny_mbf16(tmp_path / "jax", tree, stage1)
    args = get_parser("Latent_Diffusion_Trainer").parse_args(
        ["--save", str(tmp_path)])
    jax_stage2_entry.main(args, jax_ns(copy.deepcopy(dj)))
    jckpt.wait_pending_saves()

    dp = _tiny_mbf16(tmp_path / "port", tree, stage1)
    targs = get_parser("Latent_Diffusion_Trainer").parse_args(
        ["--save", str(tmp_path), "--device", "cpu"])
    tr = train_latent_diffusion.main(targs, dict2namespace(dp))
    tckpt.wait_pending_saves()
    assert tr.tx.moment_dtype == BF16
    assert all(v.dtype == BF16 for s in (tr.state.opt_state.mu,
                                         tr.state.opt_state.nu)
               for v in s.values())
    assert (tr.epoch, tr.itr) == (3, 2)

    # resume the port's run for a third epoch
    dp["common"]["epochs"] = 3
    rargs = get_parser("Latent_Diffusion_Trainer").parse_args(
        ["--save", str(tmp_path), "--device", "cpu", "--resume", "True"])
    resumed = train_latent_diffusion.main(rargs, dict2namespace(dp))
    tckpt.wait_pending_saves()
    assert (resumed.epoch, resumed.itr) == (4, 3)
    with open(os.path.join(dp["log"]["save_path"], "training.csv")) as f:
        assert len(f.read().strip().splitlines()) == 4  # header + 3 rows

    # the JAX entry's checkpoint into the port, moments bit for bit
    other = tlt.Trainer(dict2namespace(dj), device="cpu")
    other.maybe_init({"tr_points": _rand((3, N, 3), 1)})
    other.resume()
    ck = tckpt.load_checkpoint(
        os.path.join(dj["log"]["save_path"], "checkpt_2.msgpack"))
    assert (other.epoch, other.itr) == (3, ck["itr"])
    for n in ("mu", "nu"):
        for k, v in getattr(other.state.opt_state, n).items():
            assert v.dtype == BF16
            assert torch.equal(v, ck["state"]["score"]["opt_state"][n][k]
                               .to(BF16)), (n, k)


# ------------------------------------------------------ mixed precision

def test_train_dtype_names():
    for name, want in (("float32", torch.float32), ("f32", torch.float32),
                       ("bfloat16", BF16), ("bf16", BF16), (None,
                                                            torch.float32)):
        cfg = dict2namespace({"common": {"train_dtype": name}})
        assert train_dtype(cfg) == want
    with pytest.raises(ValueError, match="train_dtype"):
        train_dtype(dict2namespace({"common": {"train_dtype": "f16"}}))


def test_f32_weights_load_into_a_bf16_net_without_a_cast(nets):
    """Mixed precision: the state_dict's f32 tensors load as they are (no
    cast to the compute dtype), the forward computes in bf16 and its
    gradients are f32; bf16 serving keeps bf16 weights."""
    mixed = Score(dict2namespace(SCORE), dtype=BF16,
                  param_dtype=torch.float32, device="cpu")
    mixed.load_state_dict(nets["score"])
    for k, p in mixed.state_dict().items():
        assert p.dtype == torch.float32 and torch.equal(p, nets["score"][k])
    x, t = _t(_rand((B,) + Z, 1)), torch.tensor([0.3, 0.7])
    out = mixed(x, t)
    assert out.dtype == BF16
    out.float().sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in mixed.parameters())
    serving = Score(dict2namespace(SCORE), dtype=BF16, device="cpu")
    serving.load_state_dict(nets["score"])
    assert all(p.dtype == BF16 for p in serving.parameters())
    with torch.no_grad():
        assert serving(x, t).dtype == BF16


@pytest.mark.parametrize("loss", ["chamfer", "emd"])
def test_losses_take_bf16_reconstructions_in_f32(loss):
    """A bf16 prediction: the distances and the auction in f32 (the loss
    equals the f32 loss of the same bf16 values, and JAX's), the gradient
    back in bf16."""
    from ldt_tpu.ops.chamfer import chamfer_loss as jax_chamfer
    from ldt_tpu.ops.emd import emd_loss as jax_emd

    pred = torch.from_numpy(_bf16(_rand((B, N, 3), 1))).to(BF16)
    pred.requires_grad_(True)
    target = _t(_rand((B, N, 3), 2))
    fn, jfn = ((chamfer_loss, jax_chamfer) if loss == "chamfer"
               else (emd_loss, jax_emd))
    got = fn(pred, target)
    assert got.dtype == torch.float32
    assert torch.equal(got, fn(pred.detach().float(), target))
    want = jfn(jnp.asarray(pred.detach().float().numpy(), jnp.bfloat16),
               jnp.asarray(target.numpy()))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got.backward()
    assert pred.grad.dtype == BF16
