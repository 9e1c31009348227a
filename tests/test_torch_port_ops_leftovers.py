"""The ops leftovers against `ldt_tpu` on the CPU: the PVCNN geometry
primitives (`ball_query`, `nearest_neighbor_interpolate`, `avg_voxelize`,
`trilinear_devoxelize`, `normalize_point_clouds`), `ops.masks` with
`MaskedBatchNorm` through the weight bridge, and the compact auction
(the dense assignment exactly; the JAX package's compact schedule's).

Tolerances: f32 sums in another order, 1e-5 (the geometry reads the
direct-form distances, the JAX package the expanded form); the auction's
assignment equal, its distances to rtol 1e-6 (the bound of
tests/test_parallel.py::TestShardedEMD)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.ops as jops
from ldt_tpu.ops import emd as jemd
from ldt_tpu.ops.masks import MaskedBatchNorm as JaxMaskedBatchNorm
from ldt_torch import ops
from ldt_torch.ops import emd, geometry, masks
from ldt_torch.weights import (
    masked_batch_norm_state_dict,
    masked_batch_norm_variables,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_ops_exports_every_name_of_the_jax_package():
    assert sorted(ops.__all__) == sorted(jops.__all__)
    for name in ops.__all__:
        assert callable(getattr(ops, name)), name


@pytest.mark.parametrize("radius,nsample", [(0.6, 8), (0.3, 4), (1.5, 16)])
def test_ball_query_matches(radius, nsample):
    """Partly filled balls (empty slots take the first pick) and, with the
    queries far away, fully empty ones (index 0)."""
    xyz = _rand((2, 64, 3), 0)
    new = np.concatenate([_rand((2, 10, 3), 1), _rand((2, 3, 3), 2) + 20.0],
                         axis=1)
    want = np.asarray(jops.ball_query(radius, nsample, jnp.asarray(xyz),
                                      jnp.asarray(new)))
    got = geometry.ball_query(radius, nsample, _t(xyz), _t(new)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 10:] == 0).all()  # fully empty balls
    d = ((new[:, :, None] - xyz[:, None]) ** 2).sum(-1) <= radius ** 2
    counts = d.sum(-1)
    assert ((counts > 0) & (counts < nsample)).any()  # partly filled


def test_grouping_and_gather_match():
    feats = _rand((2, 20, 5), 3)
    idx3 = np.random.default_rng(4).integers(0, 20, (2, 6, 4))
    idx2 = idx3[..., 0]
    np.testing.assert_array_equal(
        geometry.grouping(_t(feats), _t(idx3)).numpy(),
        np.asarray(jops.grouping(jnp.asarray(feats), jnp.asarray(idx3))))
    np.testing.assert_array_equal(
        geometry.gather(_t(feats), _t(idx2)).numpy(),
        np.asarray(jops.gather(jnp.asarray(feats), jnp.asarray(idx2))))


def test_nearest_neighbor_interpolate_matches():
    pts, centers = _rand((2, 40, 3), 5), _rand((2, 12, 3), 6)
    feats = _rand((2, 12, 7), 7)
    want = jops.nearest_neighbor_interpolate(
        jnp.asarray(pts), jnp.asarray(centers), jnp.asarray(feats))
    got = geometry.nearest_neighbor_interpolate(_t(pts), _t(centers),
                                                _t(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_avg_voxelize_matches_with_repeated_voxels():
    r = 4
    feats = _rand((2, 50, 3), 8)
    coords = np.random.default_rng(9).integers(0, r, (2, 50, 3)).astype(
        np.int32)
    coords[:, 10:20] = coords[:, :1]  # eleven points in one voxel
    want = jops.avg_voxelize(jnp.asarray(feats), jnp.asarray(coords), r)
    got = geometry.avg_voxelize(_t(feats), _t(coords), r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.numpy() == 0).all(axis=-1).any()  # empty voxels are 0


def test_trilinear_devoxelize_matches_at_the_edges():
    r = 5
    grid = _rand((2, r, r, r, 4), 10)
    coords = np.random.default_rng(11).uniform(0, r - 1, (2, 30, 3)).astype(
        np.float32)
    coords[:, :4] = [[0, 0, 0], [r - 1, r - 1, r - 1], [0, r - 1, 2.5],
                     [r - 1, 0.25, 0]]  # corners and faces: clipped corners
    want = jops.trilinear_devoxelize(jnp.asarray(grid), jnp.asarray(coords))
    got = geometry.trilinear_devoxelize(_t(grid), _t(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got[:, 1].numpy(), grid[:, -1, -1, -1],
                               **TOL)


def test_normalize_point_clouds_matches():
    pc = _rand((3, 100, 3), 12, 2.0) + 1.0
    want = jops.normalize_point_clouds(jnp.asarray(pc))
    got = geometry.normalize_point_clouds(_t(pc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [16, 5])
def test_sample_mask_matches_on_pinned_permutations(n):
    key = jax.random.key(3)
    want = np.asarray(jops.sample_mask(key, (4, n), 16))
    perms = np.stack([np.asarray(jax.random.permutation(k, 16))
                      for k in jax.random.split(key, 4)])
    got = masks.sample_mask((4, n), 16, permutations=perms)
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = masks.sample_mask((4, n), 16,
                              generator=torch.Generator().manual_seed(0))
    assert ((~drawn).sum(1) == n).all()


def test_mask_helpers_match():
    np.testing.assert_array_equal(masks.get_mask((3, 5), 8).numpy(),
                                  np.asarray(jops.get_mask((3, 5), 8)))
    x = _rand((3, 8, 4), 13)
    m = np.asarray(jops.get_mask((3, 5), 8))
    np.testing.assert_array_equal(
        masks.masked_fill(_t(x), _t(m), 2.0).numpy(),
        np.asarray(jops.masked_fill(jnp.asarray(x), jnp.asarray(m), 2.0)))
    assert masks.masked_fill(_t(x)) is not None
    for p in (2, 3):
        np.testing.assert_allclose(
            masks.get_pairwise_distance(_t(x[0]), p).numpy(),
            np.asarray(jops.get_pairwise_distance(jnp.asarray(x[0]), p)),
            **TOL)
    masks.check(_t(x))
    with pytest.raises(AssertionError, match="isnan:True"):
        masks.check(torch.tensor([1.0, float("nan")]))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("with_mask", [True, False])
def test_masked_batch_norm_matches_through_the_bridge(train, with_mask):
    x = _rand((3, 10, 6), 14, 2.0) + 0.5
    mask = np.asarray(jops.get_mask((3, 7), 10)) if with_mask else None
    jm = JaxMaskedBatchNorm(6)
    variables = jm.init(jax.random.key(0), jnp.asarray(x))
    variables = {  # non-trivial parameters and statistics
        "params": {"scale": _rand((6,), 15) + 1.0, "bias": _rand((6,), 16)},
        "batch_stats": {"mean": _rand((6,), 17),
                        "var": np.abs(_rand((6,), 18)) + 0.5}}
    jmask = None if mask is None else jnp.asarray(mask)
    want, upd = jm.apply(variables, jnp.asarray(x), jmask, train=train,
                         mutable=["batch_stats"])
    tm = masks.MaskedBatchNorm(6)
    tm.load_state_dict(masked_batch_norm_state_dict(variables))
    got = tm(_t(x), None if mask is None else _t(mask), train=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    if with_mask:
        assert (got.detach().numpy()[:, 7:] == 0).all()
    if train:
        for k in ("mean", "var"):
            np.testing.assert_allclose(tm.update[k].numpy(),
                                       np.asarray(upd["batch_stats"][k]),
                                       **TOL)
    else:
        assert tm.update is None
    back = masked_batch_norm_variables(tm.state_dict())
    for col in ("params", "batch_stats"):
        for k, v in variables[col].items():
            np.testing.assert_array_equal(back[col][k], v)


def test_masked_batch_norm_bridge_refuses_unmapped_leaves():
    with pytest.raises(ValueError, match="unmapped"):
        masked_batch_norm_state_dict(
            {"params": {"scale": np.ones(2), "extra": np.ones(2)},
             "batch_stats": {"mean": np.zeros(2), "var": np.ones(2)}})


def _grid(shape, seed, step=0.25):
    k = int(round(1 / step))
    return (np.random.default_rng(seed).integers(-k, k + 1, shape)
            * step).astype(np.float32)


@pytest.mark.parametrize("enter", [32, 0, 256])
@pytest.mark.parametrize("iters", [50, 5])
def test_compact_auction_equals_dense_and_jax(monkeypatch, enter, iters):
    """On a dyadic grid (exact distances, many ties): the compact schedule
    gives the dense assignment exactly, and the JAX package's compact
    schedule at the same `enter` (its LDT_EMD_ENTER) gives the same."""
    x, y = _grid((3, 128, 3), 20 + iters), _grid((3, 128, 3), 30 + enter)
    dense_d, dense_a = emd.auction_emd(_t(x), _t(y), iters=iters)
    got_d, got_a = emd.auction_emd(_t(x), _t(y), iters=iters, compact=True,
                                   enter=enter)
    assert torch.equal(got_a, dense_a)
    monkeypatch.setenv("LDT_EMD_ENTER", str(enter))
    want_d, want_a = jemd.auction_emd(jnp.asarray(x), jnp.asarray(y),
                                      iters=iters, compact=True)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6)
    np.testing.assert_allclose(got_d.numpy(), dense_d.numpy(), rtol=1e-6)


def test_compact_auction_on_a_near_converged_pair():
    """The training regime: a prediction near its target, where most rows
    are assigned after a few dense rounds and the compact rounds finish;
    the same assignment as the dense rounds."""
    y = _rand((2, 300, 3), 40)
    x = y + _rand((2, 300, 3), 41, 0.02)
    _, dense_a = emd.auction_emd(_t(x), _t(y))
    _, got_a = emd.auction_emd(_t(x), _t(y), compact=True)
    assert torch.equal(got_a, dense_a)
