"""The conditional Score, ldt_torch against ldt_tpu on the CPU: the
ConditionNet's ResNet-18 trunk (`BasicBlock`, `ResNet18Trunk`) and the
ConditionNet itself in eval and train mode (outputs and the BatchNorm
statistics a train-mode forward leaves), the conditional Score and the
conditional UNet Score (forward, and a train-mode loss's gradients against
`jax.grad`), an Attention whose keys and values have their own width, the
weight bridge both ways and `tools/port.py`'s `c_net.` rules against
`ldt_tpu.tools.port`'s.

Inputs come from a numpy seed, weights from JAX's init (moved off it by
`perturbed`) through `ldt_torch.weights`. The JAX nets run their attention
in XLA (their plain path). Tolerances, f32: outputs and statistics within
1e-5 absolute or 1e-4 of the largest |value| (convolutions and sums in
another order; a train-mode BatchNorm divides by the std of a small batch);
gradients 1e-4 of each tensor's largest |value|
(test_torch_port_labels's step tolerance)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.models.score as jsm
import ldt_tpu.nn.layers as jl
import ldt_tpu.tools.port as jport
from ldt_torch import weights
from ldt_torch.models import Score
from ldt_torch.models import score as tsm
from ldt_torch.nn import layers as tl
from ldt_torch.tools import port as tport
from test_torch_port_common import SMALL_SCORE, cfgs, perturbed, to_np
from test_torch_port_refweights import (
    _block,
    _bn,
    _conv1,
    _grouper,
    _linear,
    reference_score,
)

B = 3
IMG = 32       # view side of the trunk's tests (its output 4 x 4)
SCORE_IMG = 16  # the Score's (2 x 2: the JAX gradient runs eagerly)
POINTS = 64    # partial-cloud points
COND = dict(SMALL_SCORE, condition=True, num_blocks=4)
UNET = dict(COND, unet=True)
UNET_PLAIN = dict(SMALL_SCORE, unet=True, num_blocks=4)
ABS, REL = 1e-5, 1e-4



@pytest.fixture(autouse=True)
def one_thread():
    """The small models on one intra-op thread (the other test workers are
    busy)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _images(seed, size=IMG):
    return np.random.default_rng(seed).uniform(
        0, 1, (B, size, size, 3)).astype(np.float32)


def _condition(seed, size=IMG):
    return {"img": _images(seed, size), "pts": _rand((B, POINTS, 3),
                                                     seed + 1)}


def _close(got, want, what=""):
    """max |got - want| within 1e-5, or 1e-4 of the largest |want|."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= max(ABS, REL * float(np.abs(want).max())), (what, err)


def _bn_sd(sd: dict) -> dict:
    """The running statistics of a state_dict."""
    return {k: v for k, v in sd.items() if "running_" in k}


# ------------------------------------------------------------ the trunk


def _init_vars(jmod, x, seed=5):
    """JAX variables of `jmod` initialized on `x`, moved off their initial
    values (`perturbed`)."""
    return perturbed(_np(dict(jmod.init(jax.random.key(seed),
                                        jnp.asarray(x)))))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shape", [(64, 64, 1), (64, 128, 2)],
                         ids=["identity", "downsample"])
def test_basic_block_matches(shape, train):
    c_in, c_out, stride = shape
    x = _rand((2, 9, 9, c_in), 1)
    jmod = jsm.BasicBlock(c_out, stride=stride)
    v = _init_vars(jmod, x)
    sd = {}
    weights._conv_bn(sd, "m", v["params"], v["batch_stats"], "m",
                     weights._BASIC_BLOCK)
    tmod = tsm.BasicBlock(c_in, c_out, stride)
    tmod.load_state_dict({k[2:]: t for k, t in sd.items()})
    want, mut = jmod.apply(v, jnp.asarray(x), train=train,
                           mutable=["batch_stats"])
    got = tmod(_t(x), train)
    assert got.shape == want.shape
    _close(got, want)
    if train:
        stats = {}
        weights._conv_bn(stats, "m", v["params"], _np(mut["batch_stats"]),
                         "m", weights._BASIC_BLOCK)
        new = tl.take_batch_norm_updates(tmod)
        assert set(new) == {k[2:] for k in _bn_sd(stats)}
        for k, t in new.items():
            _close(t.numpy(), stats["m." + k].numpy(), k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("size", [32, 37])
def test_resnet18_trunk_matches(size, train):
    """Odd sizes too: the strides' and the -inf max pool's padding."""
    x = _images(2, size)
    jmod = jsm.ResNet18Trunk()
    v = _init_vars(jmod, x)
    sd = {}
    weights._condition_net(sd, {"resnet": v["params"], **_net_rest()},
                           {"resnet": v["batch_stats"], **_net_rest(True)})
    sd = {k[len("c_net.resnet."):]: t for k, t in sd.items()
          if k.startswith("c_net.resnet.")}
    tmod = tsm.ResNet18Trunk()
    tmod.load_state_dict(sd)
    want, mut = jmod.apply(v, jnp.asarray(x), train=train,
                           mutable=["batch_stats"])
    got = tmod(_t(x), train)
    assert tuple(got.shape) == (B, -(-size // 8), -(-size // 8), 128)
    _close(to_np(got), np.asarray(want))
    assert tmod.runs == 1
    if train:
        stats = {}
        weights._condition_net(
            stats, {"resnet": v["params"], **_net_rest()},
            {"resnet": _np(mut["batch_stats"]), **_net_rest(True)})
        new = tl.take_batch_norm_updates(tmod)
        assert len(new) == 2 * 10  # 10 BatchNorms, mean and var each
        for k, t in new.items():
            _close(t.numpy(), stats["c_net.resnet." + k].numpy(), k)


@functools.lru_cache(maxsize=None)
def _net_vars():
    jcfg, _ = cfgs(COND)
    cond = _condition(3)
    net = jsm.ConditionNet(jcfg.hidden_size, jcfg.t_dim,
                           patch_size=jcfg.z_scale)
    v = net.init(jax.random.key(4), jax.tree_util.tree_map(jnp.asarray,
                                                           cond))
    return perturbed(_np(dict(v)))


def _net_rest(stats: bool = False) -> dict:
    """The ConditionNet's leaves other than the trunk's (for converting a
    trunk alone through `_condition_net`)."""
    v = _net_vars()
    tree = v["batch_stats"] if stats else v["params"]
    return {k: t for k, t in tree.items() if k != "resnet"}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("keys", [("img", "pts"), ("img",), ("pts",)],
                         ids=["both", "image", "points"])
def test_condition_net_matches(keys, train):
    jcfg, _ = cfgs(COND)
    v = _net_vars()
    net = jsm.ConditionNet(jcfg.hidden_size, jcfg.t_dim,
                           patch_size=jcfg.z_scale)
    cond = _condition(6)
    cond = {k: (cond[k] if k in keys else None) for k in cond}
    (want_tok, want_emb), mut = net.apply(
        v, jax.tree_util.tree_map(jnp.asarray, cond), train=train,
        mutable=["batch_stats"])
    sd = {}
    weights._condition_net(sd, v["params"], v["batch_stats"])
    tnet = tsm.ConditionNet(jcfg.hidden_size, jcfg.t_dim,
                            patch_size=jcfg.z_scale)
    tnet.load_state_dict({k[len("c_net."):]: t for k, t in sd.items()})
    tok, emb = tnet({k: None if a is None else _t(a)
                     for k, a in cond.items()}, train)
    if "pts" in keys:
        assert tok.shape == (B, jcfg.z_scale, jcfg.hidden_size)
        _close(to_np(tok), np.asarray(want_tok))
    else:
        assert tok is None and want_tok is None
    if "img" in keys:
        _close(to_np(emb), np.asarray(want_emb))
    else:
        assert emb == 0.0 and want_emb == 0.0
    if train:
        stats = {}
        weights._condition_net(stats, v["params"], _np(mut["batch_stats"]))
        new = tl.take_batch_norm_updates(tnet)
        # only the branches that ran update their statistics
        assert bool(new) and all(
            (k.startswith("resnet.") and "img" in keys)
            or (k.startswith("group.") and "pts" in keys) for k in new)
        for k, t in new.items():
            _close(t.numpy(), stats["c_net." + k].numpy(), k)


def test_condition_net_keeps_the_neighbour_count_quirk(monkeypatch):
    """k = 128 // patch_size * 2 (PARITY #11), whatever the point count."""
    seen = []
    real = tsm.LocalGrouper.forward

    def spy(self, xyz, feature, groups, k, train=False):
        seen.append((xyz.shape[1], groups, k))
        return real(self, xyz, feature, groups, k, train)

    monkeypatch.setattr(tsm.LocalGrouper, "forward", spy)
    net = tsm.ConditionNet(32, 16, patch_size=32)
    net({"pts": _t(_rand((2, 100, 3), 1))})
    assert seen == [(100, 32, 8)]


# ------------------------------------------------------------- the Score


@functools.lru_cache(maxsize=None)
def _score_vars(name):
    d = {"cond": COND, "unet": UNET, "unet_plain": UNET_PLAIN}[name]
    jcfg, _ = cfgs(d)
    x = jnp.zeros((B, jcfg.z_scale, jcfg.z_dim))
    cond = (jax.tree_util.tree_map(jnp.asarray, _condition(7, SCORE_IMG))
            if jcfg.condition else None)
    v = jax.jit(jsm.Score(jcfg).init)(jax.random.key(8), x, jnp.ones((B,)),
                                      None, cond)
    v = _np(dict(v))
    return perturbed({"params": v["params"],
                      "batch_stats": v.get("batch_stats", {})})


def _tscore(name):
    d = {"cond": COND, "unet": UNET, "unet_plain": UNET_PLAIN}[name]
    v = _score_vars(name)
    score = Score(cfgs(d)[1], device="cpu")
    score.load_state_dict(weights.score_state_dict(v["params"],
                                                   v["batch_stats"]))
    return score


CASES = {
    "dict": ("cond", ("img", "pts"), False),
    "encoded": ("cond", ("img", "pts"), True),
    "image_only": ("cond", ("img",), False),
    "points_only": ("cond", ("pts",), False),
    "unet": ("unet", ("img", "pts"), False),
    "unet_unconditional": ("unet_plain", (), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_score_forward_and_gradients_match(case):
    """Eval-mode forward, then the gradients of a train-mode loss
    (mean(pred * r), r fixed) with respect to every parameter, against
    `jax.grad` of the same loss with `mutable=["batch_stats"]`."""
    name, keys, encoded = CASES[case]
    d = {"cond": COND, "unet": UNET, "unet_plain": UNET_PLAIN}[name]
    jcfg, _ = cfgs(d)
    v = _score_vars(name)
    x = _rand((B, jcfg.z_scale, jcfg.z_dim), 10)
    t = np.random.default_rng(11).uniform(0.05, 1.0, B).astype(np.float32)
    r = _rand((B, jcfg.z_scale, jcfg.z_dim), 12)
    cond = None
    if keys:
        full = _condition(13, SCORE_IMG)
        cond = {k: (full[k] if k in keys else None) for k in full}
    jm = jsm.Score(jcfg)
    jcond = None if cond is None else {
        k: None if a is None else jnp.asarray(a) for k, a in cond.items()}
    tcond = None if cond is None else {
        k: None if a is None else _t(a) for k, a in cond.items()}
    score = _tscore(name)
    if encoded:
        jin = jm.apply(v, jcond, method=jsm.Score.encode_condition)
        with torch.no_grad():
            tin = score.encode_condition(tcond)
    else:
        jin, tin = jcond, tcond
    want = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(t), None, jin)
    with torch.no_grad():
        got = score(_t(x), _t(t), None, tin)
    _close(got, want)
    ts = _t(np.linspace(1.0, 1e-3, 5))
    with torch.no_grad():
        _close(score.embed_times(ts), jm.apply(
            v, jnp.asarray(ts.numpy()), method=jsm.Score.embed_times))

    def jloss(p):
        out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), jnp.asarray(t), None, jcond,
                          train=True, mutable=["batch_stats"])
        return jnp.mean(out * jnp.asarray(r))

    # eager: under jit XLA recomputes the trunk's activations inside the
    # max's backward, and a max that lands one ulp off drops its channel's
    # gradient (the eager gradients and the port's agree with the port's
    # f64 ones to 3e-7; the jitted ones miss by ~40% on c_net's first conv)
    grad = jax.grad(jloss) if jcfg.condition else jax.jit(jax.grad(jloss))
    jgrads = grad(jax.tree_util.tree_map(jnp.asarray, v["params"]))
    score.zero_grad()
    loss = torch.mean(score(_t(x), _t(t), None, tcond, train=True) * _t(r))
    loss.backward()
    want_g = weights.score_state_dict(_np(jgrads), v["batch_stats"])
    # a branch the condition leaves out has no gradient (JAX's: zeros)
    got_g = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in score.named_parameters()}
    assert set(got_g) == {k for k in want_g if "running_" not in k}
    for k, g in got_g.items():
        w = want_g[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-3)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * scale, (k, err, scale)


def test_unet_down_block_cross_attends_at_the_condition_width():
    """A conditional UNet's down block: queries 2 hidden wide, keys and
    values from tokens hidden wide (flax's fc_q [2h, h], fc_kv [h, 2h]):
    separate q and kv weights, the block against JAX's; without y it
    refuses."""
    h, heads = 32, 4
    x, y = _rand((B, 8, 2 * h), 20), _rand((B, 8, h), 21)
    c = _rand((B, 16), 22)
    jb = jl.ResidualBlock(2 * h, dim_c=16, num_heads=heads, dim_out=h)
    v = _np(dict(jb.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(y),
                         jnp.asarray(c))))
    assert v["params"]["attn"]["fc_q"]["kernel"].shape == (2 * h, h)
    assert v["params"]["attn"]["fc_kv"]["kernel"].shape == (h, 2 * h)
    sd = {}
    weights._residual_block(sd, "b", v["params"], "b")
    tb = tl.ResidualBlock(2 * h, dim_c=16, num_heads=heads, dim_out=h,
                          dim_kv=h)
    tb.load_state_dict({k[2:]: t for k, t in sd.items()})
    assert not hasattr(tb.attn, "qkv")
    want = jb.apply(v, jnp.asarray(x), jnp.asarray(y), jnp.asarray(c))
    got = tb(_t(x), _t(y), _t(c))
    _close(to_np(got), np.asarray(want))
    with pytest.raises(ValueError, match="cross-attends only"):
        tb(_t(x), None, _t(c))
    # back to the flax layout
    e = weights._Entries({f"b.{k}": t for k, t in tb.state_dict().items()})
    back = weights._residual_block_inv(e, "b", {}, "layer_norm")
    e.done()
    for n in ("fc_q", "fc_kv"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(
                to_np(back["attn"][n][leaf]), v["params"]["attn"][n][leaf])


# ------------------------------------------------------------ the weights


@pytest.mark.parametrize("name", ["cond", "unet", "unet_plain"])
def test_weights_convert_both_ways(name):
    """flax -> state_dict gives the Score's keys and shapes (conv kernels
    OIHW, running statistics as buffers); back gives the flax tree
    exactly, params and batch_stats."""
    d = {"cond": COND, "unet": UNET, "unet_plain": UNET_PLAIN}[name]
    v = _score_vars(name)
    sd = weights.score_state_dict(v["params"], v["batch_stats"])
    live = Score(cfgs(d)[1], device="cpu").state_dict()
    assert set(sd) == set(live)
    for k in live:
        assert sd[k].shape == live[k].shape, k
    if d["condition"]:
        assert sd["c_net.resnet.conv1.weight"].shape == (64, 3, 7, 7)
        np.testing.assert_array_equal(
            sd["c_net.resnet.conv1.weight"].numpy(),
            v["params"]["c_net"]["resnet"]["conv1"]["kernel"].transpose(
                3, 2, 0, 1))
    back = weights.score_variables(sd)
    assert jax.tree_util.tree_structure(_np(back)) == \
        jax.tree_util.tree_structure(v)
    assert all(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(to_np(a), b), back, v)))
    if d["condition"]:
        with pytest.raises(ValueError, match="c_net"):
            weights.score_state_dict(v["params"])  # the statistics missing
        bad = jax.tree_util.tree_map(lambda a: a, v["params"])
        bad["c_net"]["resnet"]["layer1_0"]["Conv_9"] = {"kernel": 0}
        with pytest.raises(ValueError, match="layer1_0"):
            weights.score_state_dict(bad, v["batch_stats"])


def _reference_condition_net(sd, p, st):
    """flax c_net variables -> the reference's `c_net.` keys: Conv2d OIHW,
    torchvision's `resnet.{0,1,4,5}` Sequential indices, `downsample.0/1`,
    Conv1d pc_conv_in/out, Linear `ln`, the grouper, and the dead
    `conv_out` the reference builds."""
    def conv2d(key, q):
        sd[f"{key}.weight"] = torch.from_numpy(
            np.ascontiguousarray(q["kernel"].transpose(3, 2, 0, 1)))

    r, rs = p["resnet"], st["resnet"]
    conv2d("c_net.resnet.0", r["conv1"])
    _bn(sd, "c_net.resnet.1", r["bn1"], rs["bn1"])
    for seq, layer in ((4, "layer1"), (5, "layer2")):
        for i in range(2):
            blk, bst = r[f"{layer}_{i}"], rs[f"{layer}_{i}"]
            base = f"c_net.resnet.{seq}.{i}"
            conv2d(f"{base}.conv1", blk["Conv_0"])
            _bn(sd, f"{base}.bn1", blk["BatchNorm_0"], bst["BatchNorm_0"])
            conv2d(f"{base}.conv2", blk["Conv_1"])
            _bn(sd, f"{base}.bn2", blk["BatchNorm_1"], bst["BatchNorm_1"])
            if "downsample_conv" in blk:
                conv2d(f"{base}.downsample.0", blk["downsample_conv"])
                _bn(sd, f"{base}.downsample.1", blk["downsample_bn"],
                    bst["downsample_bn"])
    _linear(sd, "c_net.ln", p["ln"])
    _conv1(sd, "c_net.pc_conv_in", p["pc_conv_in"])
    _conv1(sd, "c_net.pc_conv_out", p["pc_conv_out"])
    _grouper(sd, "c_net.group", p["group"], st["group"])
    sd["c_net.conv_out.weight"] = torch.zeros(4, 128, 1)
    sd["c_net.conv_out.bias"] = torch.zeros(4)


def _reference(name):
    v = _score_vars(name)
    p = v["params"]
    if name == "cond":
        sd = reference_score(p)
    else:
        sd = reference_score({k: t for k, t in p.items()
                              if not k.startswith("transformer_")})
        for i in range(COND["num_blocks"] // 2):
            _block(sd, f"Transformer_Up.{i}", p[f"transformer_up_{i}"])
            _block(sd, f"Transformer_Down.{i}", p[f"transformer_down_{i}"])
        _block(sd, "Transformer_Mid", p["transformer_mid"])
    if "c_net" in p:
        _reference_condition_net(sd, p["c_net"], v["batch_stats"]["c_net"])
    return sd


@pytest.mark.parametrize("name", ["cond", "unet"])
def test_port_maps_c_net_and_unet_keys_as_the_jax_port(name):
    """`tools/port.py` on a reference-layout state_dict with `c_net.` (and
    the UNet's) keys: exactly `weights.py` applied to
    `ldt_tpu.tools.port`'s output, which is the flax tree; the dead
    conv_out is dropped, an unknown key raises."""
    sd = _reference(name)
    jv = jport.port_score(sd)
    got = tport.port_score(sd)
    want = weights.score_state_dict(jv["params"], jv.get("batch_stats"))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    v = _score_vars(name)
    ref_sd = weights.score_state_dict(v["params"], v["batch_stats"])
    assert set(got) == set(ref_sd)
    for k in ref_sd:
        assert torch.equal(got[k], ref_sd[k]), k
    with pytest.raises(ValueError, match="unmapped reference keys"):
        tport.port_score({**sd, "c_net.mystery.weight": torch.zeros(2)})
