"""Reference weights: `ldt_torch.tools.port` (the converter of the
reference's torch checkpoints) against `ldt_tpu.tools.port` and
`ldt_torch.weights`, on the CPU.

A helper turns a random flax tree into a state_dict in the reference's
layout (the inverse of the rule tables: Conv1d(k=1) weights [out, in, 1],
Linear [out, in], the reference's module names, its BatchNorm and ActNorm
buffers). Then: `ldt_tpu.tools.port` gives the flax tree back;
`ldt_torch.tools.port` gives exactly `ldt_torch.weights` of that tree; nets
built with `ref_merge=True` on the ported weights agree with ldt_tpu's
(forward 1e-5, gradients rtol 1e-4: test_torch_port_ref_merge's limits);
and `port_checkpoint` round-trips through `load_pretrain` and a
`--strict False` resume."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.models.compressor as jcm
import ldt_tpu.tools.port as jport
from ldt_tpu.models import Score as JaxScore
from ldt_torch import weights
from ldt_torch.configs import latent_trainer_cfg
from ldt_torch.models import Compressor, Score
from ldt_torch.tools import port as tport
from ldt_torch.training.checkpoint import load_checkpoint
from ldt_torch.training.latent_sde_trainer import Trainer as Stage2
from test_torch_port_common import (
    F32_TOL,
    SMALL_COMPRESSOR,
    SMALL_SCORE,
    cfgs,
    compressor_variables,
    params_np,
    perturbed,
    pin_reparameterize,
    to_np,
    trees_equal,
)

B = 2
LABELS = np.array([1, 2])
CONFIGS = {
    "score": (SMALL_SCORE, "score"),
    "score_labels": (dict(SMALL_SCORE, num_categorys=3), "score"),
    "compressor": (SMALL_COMPRESSOR, "compressor"),
    "compressor_labels": (dict(SMALL_COMPRESSOR, class_condition=True,
                               num_categorys=3), "compressor"),
}
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------ flax tree -> reference sd

def _conv1(sd, key, p):
    sd[f"{key}.weight"] = torch.from_numpy(np.asarray(p["kernel"]).T[:, :,
                                                                     None])
    sd[f"{key}.bias"] = torch.from_numpy(np.asarray(p["bias"]))


def _linear(sd, key, p):
    sd[f"{key}.weight"] = torch.from_numpy(np.asarray(p["kernel"]).T.copy())
    sd[f"{key}.bias"] = torch.from_numpy(np.asarray(p["bias"]))


def _bn(sd, key, p, st):
    for name, leaf in (("weight", p["scale"]), ("bias", p["bias"]),
                       ("running_mean", st["mean"]),
                       ("running_var", st["var"])):
        sd[f"{key}.{name}"] = torch.from_numpy(np.asarray(leaf))
    sd[f"{key}.num_batches_tracked"] = torch.tensor(3)


def _block(sd, key, p):
    for n in ("fc_q", "fc_kv", "fc_o"):
        _conv1(sd, f"{key}.{n}", p["attn"][n])
    for flax_name in ("adaLN", "adaLN1", "adaLN2", "pos_embedding"):
        if flax_name in p:
            _linear(sd, f"{key}.{flax_name}.1", p[flax_name])
    for i, n in ((0, "norm1"), (1, "norm2")):
        if f"LayerNorm_{i}" in p:
            ln = p[f"LayerNorm_{i}"]
            sd[f"{key}.{n}.norm.weight"] = torch.from_numpy(ln["scale"])
            sd[f"{key}.{n}.norm.bias"] = torch.from_numpy(ln["bias"])
    _conv1(sd, f"{key}.mlp.fc.0.0", p["mlp"]["Dense_0"])
    _conv1(sd, f"{key}.mlp.out", p["mlp"]["Dense_1"])
    if "shortcut" in p:
        _conv1(sd, f"{key}.shortcut", p["shortcut"])


def _final(sd, key, p):
    _linear(sd, f"{key}.adaLN.1", p["adaLN"])
    _conv1(sd, f"{key}.ln", p["ln"])


def _label(sd, p):
    sd["LabelEmbedding.label_emb.weight"] = torch.from_numpy(
        p["Embed_0"]["embedding"])
    _linear(sd, "LabelEmbedding.mlp.0", p["Dense_0"])
    _linear(sd, "LabelEmbedding.mlp.2", p["Dense_1"])


def reference_score(params):
    """flax Score params -> a reference Score state_dict."""
    sd = {}
    _conv1(sd, "ln_in", params["ln_in"])
    i = 0
    while f"transformer_{i}" in params:
        _block(sd, f"Transformer.{i}", params[f"transformer_{i}"])
        i += 1
    _final(sd, "ln_out", params["ln_out"])
    _linear(sd, "TimeEmbedding.mlp.0", params["time_embedding"]["Dense_0"])
    _linear(sd, "TimeEmbedding.mlp.2", params["time_embedding"]["Dense_1"])
    if "label_embedding" in params:
        _label(sd, params["label_embedding"])
    return sd


def _grouper(sd, key, p, st):
    for n in ("affine_alpha", "affine_beta"):
        sd[f"{key}.{n}"] = torch.from_numpy(p[n])
    ext, est = p["extraction"], st["extraction"]
    _conv1(sd, f"{key}.extraction.transfer.net.0", ext["transfer_dense"])
    _bn(sd, f"{key}.extraction.transfer.net.1", ext["transfer_bn"],
        est["transfer_bn"])
    k = 0
    while f"op{k}" in ext:
        op, ost = ext[f"op{k}"], est[f"op{k}"]
        base = f"{key}.extraction.operation.{k}"
        _conv1(sd, f"{base}.net1.0", op["net1_dense"])
        _bn(sd, f"{base}.net1.1", op["net1_bn"], ost["net1_bn"])
        _conv1(sd, f"{base}.net2.0", op["net2_dense"])
        k += 1


def reference_compressor(variables):
    """flax Compressor variables -> a reference Compressor state_dict."""
    p, st = variables["params"], variables["batch_stats"]
    sd = {}
    _conv1(sd, "input", p["input_dense"])
    _conv1(sd, "output", p["output_dense"])
    for n in ("shift", "log_scale"):
        sd[f"conv_in.{n}"] = torch.from_numpy(p["conv_in"][n])
    sd["conv_in.initialized"] = torch.tensor(1, dtype=torch.uint8)
    sd["init_set.prior"] = torch.from_numpy(p["init_set"]["prior"])
    _grouper(sd, "group", p["group"], st["group"])
    pos, pst = p["pos_embedding"], st["pos_embedding"]
    _conv1(sd, "pos_embedding.conv1", pos["conv1"])
    _conv1(sd, "pos_embedding.conv2", pos["conv2"])
    _bn(sd, "pos_embedding.bn1", pos["bn1"], pst["bn1"])
    _bn(sd, "pos_embedding.bn2", pos["bn2"], pst["bn2"])
    _linear(sd, "pos_embedding.fc", pos["fc"])
    i = 0
    while f"encoder_{i}" in p:
        enc, j = p[f"encoder_{i}"], 0
        while f"att{j}" in enc:
            _block(sd, f"encoder.{i}.atts.{j}", enc[f"att{j}"])
            j += 1
        _final(sd, f"encoder.{i}.conv_out", enc["conv_out"])
        i += 1
    i = 0
    while f"decoder_{i}" in p:
        dec = p[f"decoder_{i}"]
        _block(sd, f"decoder.{i}.att", dec["att"])
        _block(sd, f"decoder.{i}.att1", dec["att1"])
        _conv1(sd, f"decoder.{i}.prior.1", dec["prior_dense"])
        _conv1(sd, f"decoder.{i}.ln", dec["ln"])
        i += 1
    if "label_embedding" in p:
        _label(sd, p["label_embedding"])
    return sd


# ---------------------------------------------------------------- the trees

@functools.lru_cache(maxsize=None)
def _flax(name):
    d, kind = CONFIGS[name]
    label = LABELS if d.get("num_categorys", 1) > 1 else None
    if kind == "score":
        jcfg, _ = cfgs(d)
        v = params_np(jax.jit(JaxScore(jcfg).init)(
            jax.random.key(3), jnp.zeros((B, jcfg.z_scale, jcfg.z_dim)),
            jnp.ones((B,)), None if label is None else jnp.asarray(label)))
        return {"params": perturbed({"params": v})["params"],
                "batch_stats": {}}
    return perturbed(compressor_variables(d, _rand((B, 64, 3), 4), label))


def _reference(name):
    v = _flax(name)
    if CONFIGS[name][1] == "score":
        return reference_score(v["params"])
    return reference_compressor(v)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jax_port_gives_the_flax_tree_back(name):
    jax_port = (jport.port_score if CONFIGS[name][1] == "score"
                else jport.port_compressor)
    got = jax_port(_reference(name))
    assert trees_equal(got["params"], _flax(name)["params"])
    assert trees_equal(got.get("batch_stats", {}), _flax(name)["batch_stats"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_torch_port_equals_the_weights_of_the_jax_port(name):
    sd = _reference(name)
    if CONFIGS[name][1] == "score":
        got = tport.port_score(sd)
        want = weights.score_state_dict(jport.port_score(sd)["params"])
        net = Score(cfgs(CONFIGS[name][0])[1], device="cpu")
    else:
        got = tport.port_compressor(sd)
        want = weights.compressor_state_dict(jport.port_compressor(sd))
        net = Compressor(cfgs(CONFIGS[name][0])[1], device="cpu")
    assert set(got) == set(want) == set(net.state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", ["score", "score_labels"])
def test_ref_merge_scores_agree_on_ported_weights(name):
    d = CONFIGS[name][0]
    sd = _reference(name)
    label = LABELS if d["num_categorys"] > 1 else None
    x = _rand((B, d["z_scale"], d["z_dim"]), 5)
    g = _rand(x.shape, 6)
    t = np.array([0.6, 0.2], np.float32)
    jm = JaxScore(cfgs(d)[0], ref_merge=True)
    p = jax.tree_util.tree_map(jnp.asarray, jport.port_score(sd)["params"])

    def jfwd(q):
        return jm.apply({"params": q}, jnp.asarray(x), jnp.asarray(t),
                        None if label is None else jnp.asarray(label))

    want = jfwd(p)
    jgrads = weights.score_state_dict(params_np({"params": jax.grad(
        lambda q: jnp.sum(jfwd(q) * g))(p)}))
    tm = Score(cfgs(d)[1], device="cpu", ref_merge=True)
    tm.load_state_dict(tport.port_score(sd))
    got = tm(torch.from_numpy(x), torch.from_numpy(t),
             None if label is None else torch.from_numpy(label))
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(to_np(got), np.asarray(want), **F32_TOL)
    for k, p_ in tm.named_parameters():
        np.testing.assert_allclose(to_np(p_.grad), to_np(jgrads[k]),
                                   err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("name", ["compressor", "compressor_labels"])
def test_ref_merge_compressors_agree_on_ported_weights(name, monkeypatch):
    d = CONFIGS[name][0]
    sd = _reference(name)
    label = LABELS if d["num_categorys"] > 1 else None
    pts = _rand((B, 64, 3), 7)
    noise = [_rand((B, d["z_scales"], d["z_dim"]), 8 + i)
             for i in range(d["n_layers"])]
    v = jport.port_compressor(sd)
    pin_reparameterize(monkeypatch, noise)
    want = jcm.Compressor(cfgs(d)[0], ref_merge=True).apply(
        v, jnp.asarray(pts),
        label=None if label is None else jnp.asarray(label),
        rngs={"sample": jax.random.key(0)})
    tm = Compressor(cfgs(d)[1], device="cpu", ref_merge=True).eval()
    tm.load_state_dict(tport.port_compressor(sd))
    with torch.no_grad():
        got = tm(torch.from_numpy(pts),
                 noise=[torch.from_numpy(e) for e in noise],
                 label=None if label is None else torch.from_numpy(label))
    for key in ("set", "all_eps"):
        np.testing.assert_allclose(to_np(got[key]), np.asarray(want[key]),
                                   **F32_TOL)


def _ema_state(sd, seed=9):
    """A reference EMA(Adam) optimizer state: the i-th parameter's shadow
    under 'ema'."""
    rng = np.random.default_rng(seed)
    params = [k for k in sd if "running_" not in k
              and k.rsplit(".", 1)[-1] not in ("num_batches_tracked",
                                               "initialized")]
    return {"state": {i: {"ema": sd[k] + torch.from_numpy(
        0.01 * rng.standard_normal(tuple(sd[k].shape)).astype(np.float32))}
        for i, k in enumerate(params)}}


def test_port_ema_matches_the_jax_port():
    sd = _reference("score_labels")
    opt = _ema_state(sd)
    got = tport.port_ema(sd, opt)
    want = weights.score_state_dict(jport.port_ema(sd, opt))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(got["ln_in.weight"], tport.port_score(sd)[
        "ln_in.weight"])
    assert tport.port_ema(sd, {"state": {}}) is None


def test_unported_reference_modules_raise():
    sd = _reference("score")
    for key in ("c_net.pc_conv_in.weight", "c_net.resnet.0.weight",
                "Transformer_Up.0.fc_q.weight"):
        with pytest.raises(NotImplementedError, match="Queue 1 #9"):
            tport.port_score({**sd, key: torch.zeros(2)})
    with pytest.raises(ValueError, match="unmapped reference keys"):
        tport.port_score({**sd, "mystery.weight": torch.zeros(2)})


def test_port_checkpoint_round_trips_through_load_pretrain(tmp_path):
    """A stage-1 reference file -> checkpt_7.pt, read by stage 2's
    `load_pretrain`; a dual file -> checkpt_9.pt, read by a `--strict False`
    resume (params and the ported EMA; no moments)."""
    comp_sd = _reference("compressor")
    score_sd = _reference("score")
    torch.save({"state_dict": comp_sd, "epoch": 7, "itr": 70},
               tmp_path / "stage1.pth")
    torch.save({"score_state_dict": score_sd,
                "compressor_state_dict": comp_sd,
                "score_optim_state_dict": _ema_state(score_sd),
                "epoch": 9, "itr": 90, "time": 12.5},
               tmp_path / "stage2.pth")
    out1 = str(tmp_path / "checkpt_7.pt")
    tport.main([str(tmp_path / "stage1.pth"), "--out", out1])
    assert load_checkpoint(out1)["epoch"] == 7
    want_comp = tport.port_compressor(comp_sd)
    cfg = latent_trainer_cfg(score=SMALL_SCORE,
                             compressor=dict(SMALL_COMPRESSOR,
                                             pretrain_path=out1))
    trainer = Stage2(cfg, device="cpu")
    trainer.maybe_init({"tr_points": _rand((B, 64, 3), 10)})
    trainer.load_pretrain()
    got = trainer.compressor.state_dict()
    assert set(got) == set(want_comp)
    assert all(torch.equal(got[k], want_comp[k]) for k in want_comp)

    save = tmp_path / "run"
    save.mkdir()
    out2 = str(save / "checkpt_9.pt")
    tree = tport.port_checkpoint(str(tmp_path / "stage2.pth"), out2)
    assert sorted(tree) == ["compressor", "score"]
    trainer.cfg.log = type(cfg)(save_path=str(save))
    step = trainer.state.step
    trainer.resume(strict=False)
    assert (trainer.epoch, trainer.itr, trainer.time) == (10, 90, 12.5)
    want_score = tport.port_score(score_sd)
    want_ema = tport.port_ema(score_sd, _ema_state(score_sd))
    for k, p in trainer.state.params.items():
        assert torch.equal(p, want_score[k]), k
        assert torch.equal(trainer.state.ema_params[k], want_ema[k]), k
    assert trainer.state.step == step  # no optimizer state was ported
    with pytest.raises(ValueError, match="strict"):
        trainer.resume(strict=True)


def test_cli_note_asks_for_ref_merge(tmp_path, capsys):
    torch.save({"state_dict": _reference("compressor")},
               tmp_path / "ref.pth")
    tport.main([str(tmp_path / "ref.pth"), "--out",
                str(tmp_path / "checkpt_0.pt")])
    assert "ref_merge=True" in capsys.readouterr().out
