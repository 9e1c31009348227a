"""Data, tensor and sequence parallelism of the port against `ldt_tpu` on
its mesh, on the CPU.

One 4-rank gloo job ({data: 2, model: 2}, the workers in
`ldt_torch.entries.dryrun_multichip`, so the ranks import no JAX) runs every
case of this file once; the tests hold its results against the JAX package
on conftest's virtual devices, `make_mesh(2, devices=jax.devices()[:4])`,
the same shape:
  * the tensor-parallel Attention at D=512, 8 heads (per shard: K1 on 4
    heads x 256 on each rank, K3 in the backward), forward and gradients
    against JAX's `fused_attention_packed_tp` route (2e-5, the bound of
    tests/test_parallel.py::TestTPFusedAttention); cross-attention and
    heads that do not divide through the gathered route against JAX's XLA
    route;
  * the sequence-parallel decode against JAX's decode under its SP mesh;
  * a sharded eval tile against JAX's `compute_all_metrics` (rtol 1e-4,
    atol 1e-5: the port keeps K5 where the JAX package takes XLA's chamfer
    under a mesh);
  * `make_mesh`'s shapes and refusal, `shard_batch`'s rows,
    `param_specs` over the flagship Score's names with the packed-qkv head
    alignment, and the dry-run entry's OK lines.
The launch records the ranks return are the kernel wrappers' own
(`ldt_torch.ops._build`): on the CPU the calls that took the plain twin,
by shape (on a card, the launches by shape).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldt_tpu.eval import compute_all_metrics as jax_metrics
from ldt_tpu.eval.metrics import set_eval_mesh as jax_set_eval_mesh
from ldt_tpu.models import Compressor as JaxCompressor
from ldt_tpu.nn.layers import Attention as JaxAttention
from ldt_tpu.parallel.sp import set_sp_mesh as jax_set_sp_mesh
from ldt_tpu.parallel.tp import make_mesh as jax_make_mesh
from ldt_tpu.parallel.tp import set_tp_mesh as jax_set_tp_mesh
from ldt_torch.configs import score_cfg
from ldt_torch.models import Score
from ldt_torch.parallel.tp import Shard, param_specs, shard_tensor
from ldt_torch.weights import compressor_state_dict
from test_torch_port_common import ROOT, SMALL_COMPRESSOR, cfgs

B, N, M = 4, 8, 16
ATT_TOL = dict(rtol=2e-5, atol=2e-5)
EVAL_TOL = dict(rtol=1e-4, atol=1e-5)
CASES = {"attn": (512, 8, False), "attn_cross": (512, 8, True),
         "attn_odd": (96, 3, False)}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _attention_sd(p) -> dict:
    """A flax Attention's params -> the port's Attention state_dict."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    return {"qkv.weight": t(np.concatenate([p["fc_q"]["kernel"],
                                            p["fc_kv"]["kernel"]], 1).T),
            "qkv.bias": t(np.concatenate([p["fc_q"]["bias"],
                                          p["fc_kv"]["bias"]])),
            "fc_o.weight": t(np.asarray(p["fc_o"]["kernel"]).T),
            "fc_o.bias": t(p["fc_o"]["bias"])}


def _attention_inputs(name):
    d, h, cross = CASES[name]
    x = _rand((B, N, d), 1)
    y = _rand((B, M, d), 2) if cross else None
    params = _np(JaxAttention(d, h).init(
        jax.random.key(3), jnp.asarray(x),
        jnp.asarray(x if y is None else y))["params"])
    return x, y, params


def _decode_inputs():
    jcfg, _ = cfgs(SMALL_COMPRESSOR)
    c = SMALL_COMPRESSOR
    pts = _rand((B, c["outsize"], 3), 4)
    variables = jax.jit(JaxCompressor(jcfg).init)(
        {"params": jax.random.key(5), "sample": jax.random.key(6)},
        jnp.asarray(pts))
    eps = _rand((B, c["z_scales"], c["n_layers"] * c["z_dim"]), 7)
    return _np(variables), eps


def _eval_inputs():
    return _rand((8, 32, 3), 8), _rand((8, 32, 3), 9)


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(2, devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Run the 4-rank job once; its rank 0's results."""
    work = tmp_path_factory.mktemp("parallel")
    inputs = {"mesh": True}
    for name in CASES:
        x, y, params = _attention_inputs(name)
        d, h, _ = CASES[name]
        inputs[name] = {"dim": d, "heads": h, "sd": _attention_sd(params),
                        "x": torch.from_numpy(x)}
        if y is not None:
            inputs[name]["y"] = torch.from_numpy(y)
    variables, eps = _decode_inputs()
    inputs["decode"] = {"cfg": dict(SMALL_COMPRESSOR),
                        "sd": compressor_state_dict(variables),
                        "eps": torch.from_numpy(eps),
                        "n": SMALL_COMPRESSOR["outsize"]}
    smp, ref = _eval_inputs()
    inputs["eval"] = {"smp": smp, "ref": ref, "batch_size": 8}
    torch.save(inputs, work / "inputs.pt")
    run = subprocess.run(
        [sys.executable, "-m", "ldt_torch.entries.dryrun_multichip",
         "--launch", "--ranks", "4", "--model-parallel", "2", "--device",
         "cpu", "--job", "parallel_test", "--workdir", str(work)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert run.returncode == 0, run.stderr[-4000:]
    return torch.load(work / "results.pt", weights_only=False)


def _jax_attention(name, jmesh):
    """JAX's Attention under its TP mesh: the output and the gradients of
    sum(out^2) with respect to the params and x."""
    d, h, _ = CASES[name]
    x, y, params = _attention_inputs(name)
    mod = JaxAttention(d, h, fused_core=True)
    kv = jnp.asarray(x if y is None else y)

    def loss(p, x):
        return jnp.sum(mod.apply({"params": p}, x,
                                 x if y is None else kv) ** 2)

    jax_set_tp_mesh(jmesh)
    try:
        with jmesh:
            out = jax.jit(lambda p, x: mod.apply(
                {"params": p}, x, x if y is None else kv))(
                    params, jnp.asarray(x))
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
                params, jnp.asarray(x))
    finally:
        jax_set_tp_mesh(None)
    return np.asarray(out), _attention_sd(_np(gp)), np.asarray(gx)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_attention_forward_and_grads_match_jax(job, jmesh, name):
    got = job[name]
    out, grads, gx = _jax_attention(name, jmesh)
    np.testing.assert_allclose(got["out"].numpy(), out, **ATT_TOL)
    scale = max(1.0, float(np.abs(gx).max()))
    np.testing.assert_allclose(got["x_grad"].numpy(), gx, rtol=2e-5,
                               atol=2e-5 * scale)
    for k, w in grads.items():
        scale = max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(got["grads"][k].numpy(), w.numpy(),
                                   rtol=2e-5, atol=2e-5 * scale, err_msg=k)
    # per shard where whole heads and 128-wide shards allow it (a
    # cross-attention takes the gathered route all the same)
    assert got["per_shard"] == (CASES[name][:2] == (512, 8))


def test_tp_attention_launches_k1_per_shard(job):
    """Every rank ran K1 on its 4 of the 8 heads, 256 wide (its packed qkv
    [B, N, 3 x 256]), and K3 at the same shape in the backward; the
    gathered routes ran the whole-width kernels."""
    for launches in job["launches_by_rank"]:
        assert launches["K1"][f"{B}x{N}x768/h4"] == 1
        assert launches["K3"][f"{B}x{N}x768/h4"] == 1
        assert launches["K1"][f"{B}x{N}x288/h3"] == 1  # attn_odd, gathered
        assert launches["K2"][f"{B}x{N}x512/h8"] == 1  # attn_cross
        assert launches["K4"][f"{B}x{N}x512/h8"] == 1


def test_sp_decode_matches_jax(job, jmesh):
    variables, eps = _decode_inputs()
    jcfg, _ = cfgs(SMALL_COMPRESSOR)
    comp = JaxCompressor(jcfg)
    n = SMALL_COMPRESSOR["outsize"]
    jax_set_sp_mesh(jmesh)
    try:
        with jmesh:
            want = jax.jit(lambda v, e: comp.apply(
                v, (B, n), e, method=JaxCompressor.sample))(
                    variables, jnp.asarray(eps))
    finally:
        jax_set_sp_mesh(None)
    np.testing.assert_allclose(job["decode"].numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # each rank decoded its half of the points: K2 on [B, n/2] queries
    half = f"{B}x{n // 2}x{SMALL_COMPRESSOR['hidden_dim']}/h2"
    for launches in job["launches_by_rank"]:
        assert launches["K2"][half] == SMALL_COMPRESSOR["n_layers"]


def test_sharded_eval_tile_matches_jax(job, jmesh):
    smp, ref = _eval_inputs()
    jax_set_eval_mesh(jmesh)
    try:
        with jmesh:
            want = jax_metrics(smp, ref, batch_size=8)
    finally:
        jax_set_eval_mesh(None)
    got = job["eval"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), **EVAL_TOL,
                                   err_msg=k)
    # every rank ran K5 and K6 on its share of the pairs
    for launches in job["launches_by_rank"]:
        assert launches["K5"] and launches["K6/K7"]


def test_make_mesh_and_shard_batch(job):
    checks = job["mesh_checks"]
    assert checks["shapes"] == {1: {"data": 4, "model": 1},
                                2: {"data": 2, "model": 2},
                                4: {"data": 1, "model": 4}}
    assert checks["mesh3"].startswith("ValueError") and "3" in \
        checks["mesh3"]
    r = checks["data_rank"]
    rows = checks["rows"]
    assert rows["a"] == list(range(4 * r, 4 * r + 4))
    assert rows["b"] == [0.0, 1.0, 2.0]  # 3 rows do not split: kept whole
    assert rows["c"] == [2 * r, 2 * r + 1] and rows["d"] == 5
    assert job["mesh"] == {"data": 2, "model": 2}
    # rank 0 writes these checks: its rows of the leading axis; a leading
    # axis that does not split raises; replicate broadcasts rank 0's
    # values; device_put_host makes tensors of the host arrays
    assert checks["leading"] == [0.0, 1.0, 2.0]
    assert checks["leading3"] == "ValueError"
    assert checks["replicated"] == [[0.0] * 3, [0.0] * 2]
    assert checks["put"] == ["Tensor", [1.0, 1.0]]


class _Mesh:
    """The two attributes the sharding rules read of a DeviceMesh."""

    mesh_dim_names = ("data", "model")

    def __init__(self, d, m):
        self.shape = (d, m)

    def size(self, dim=None):
        return self.shape[dim] if dim is not None else self.shape[0] * \
            self.shape[1]


def test_param_specs_megatron_pairing_over_the_flagship_names():
    """The flagship width (D=1024, 16 heads; depth cut to 2 blocks): q, k,
    v and the MLP's up-projection column-parallel, fc_o and the
    down-projection row-parallel, the rest replicated; rank r's packed qkv
    rows are the q, k and v rows of its own 8 heads."""
    score = Score(score_cfg(num_blocks=2), device="cpu")
    specs = param_specs(score, _Mesh(2, 2))
    blk = "transformer.0."
    assert specs[blk + "attn.qkv.weight"] == Shard(0, 3)
    assert specs[blk + "attn.qkv.bias"] == Shard(0, 3)
    assert specs[blk + "attn.fc_o.weight"] == Shard(1)
    assert specs[blk + "attn.fc_o.bias"] is None
    assert specs[blk + "mlp.dense_0.weight"] == Shard(0)
    assert specs[blk + "mlp.dense_0.bias"] == Shard(0)
    assert specs[blk + "mlp.dense_1.weight"] == Shard(1)
    assert specs[blk + "mlp.dense_1.bias"] is None
    assert specs[blk + "adaLN.weight"] is None
    sharded = {k for k, v in specs.items() if v}
    assert len(sharded) == 2 * 6
    assert param_specs(score, _Mesh(4, 1)) == {
        k: None for k, _ in score.named_parameters()}
    # head alignment: label each row of the packed weight by (part, head)
    d, h, dh = 1024, 16, 64
    label = torch.tensor([[p * h + i // dh] for p in range(3)
                          for i in range(d)], dtype=torch.float32)
    for r in range(2):
        rows = shard_tensor(label, Shard(0, 3), r, 2)[:, 0].long()
        heads = range(8 * r, 8 * r + 8)
        want = [p * h + hh for p in range(3) for hh in heads
                for _ in range(dh)]
        assert rows.tolist() == want


def test_dryrun_entry_prints_one_ok_line_per_rank(tmp_path):
    run = subprocess.run(
        [sys.executable, "-m", "ldt_torch.entries.dryrun_multichip",
         "--launch", "--ranks", "4", "--model-parallel", "2", "--device",
         "cpu", "--workdir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    ok = [ln for ln in run.stdout.splitlines()
          if ln.startswith("dryrun_multichip rank") and ln.endswith(" OK")]
    assert sorted(ln.split()[2] for ln in ok) == ["0/4:", "1/4:", "2/4:",
                                                   "3/4:"]
    assert all("mesh {'data': 2, 'model': 2}" in ln for ln in ok)


def test_dryrun_entry_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    """Without `--device cpu` the entry and `launch` ask for the card; with
    none they raise before a rank is spawned."""
    from ldt_torch.entries import dryrun_multichip as dm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: dm.main(["--launch", "--workdir", str(tmp_path)]),
                 lambda: dm.launch(workdir=str(tmp_path))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "rendezvous").exists()


def test_launch_record_reads_the_wrappers_own_records():
    """The launch record is each wrapper's own: on the CPU the plain
    twin's calls by shape, on a card the launches by shape, which must add
    up to the wrapper's `.launches`."""
    from ldt_torch.entries import dryrun_multichip as dm
    from ldt_torch.ops import attention as attn_ops

    dm.reset_launches()
    try:
        attn_ops.packed_self_attention(torch.zeros(2, 8, 48), 2)
        attn_ops.cross_attention(torch.zeros(2, 8, 16), torch.zeros(2, 4, 16),
                                 torch.zeros(2, 4, 16), 4)
        rec = dm.launch_record("cpu")
        assert rec["K1"] == {"2x8x48/h2": 1}
        assert rec["K2"] == {"2x8x16/h4": 1}
        assert rec["K3"] == rec["K4"] == rec["K5"] == rec["K6/K7"] == {}
        # no launch was counted: the card's record is empty and consistent
        assert all(v == {} for v in dm.launch_record("cuda").values())
        attn_ops.packed_self_attention.launches = 1
        with pytest.raises(RuntimeError, match="K1: 1 launches"):
            dm.launch_record("cuda")
    finally:
        dm.reset_launches()
