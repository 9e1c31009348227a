"""ldt_torch.ops.geometry vs ldt_tpu.ops.geometry on the CPU: distances to
1e-5, FPS indices equal, kNN groups equal as sets per row."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.ops.geometry as jg
from ldt_torch.ops import geometry as tg


def _cloud(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("b,n,m,c", [(2, 16, 40, 3), (3, 64, 64, 3),
                                     (1, 8, 5, 7)])
def test_square_distance_matches(b, n, m, c):
    src, dst = _cloud((b, n, c), 0), _cloud((b, m, c), 1)
    want = np.asarray(jg.square_distance(jnp.asarray(src), jnp.asarray(dst)))
    got = tg.square_distance(torch.from_numpy(src), torch.from_numpy(dst))
    assert got.shape == (b, n, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_square_distance_is_zero_on_the_diagonal():
    x = torch.from_numpy(_cloud((2, 32, 3), 2))
    d = tg.square_distance(x, x)
    assert torch.equal(torch.diagonal(d, dim1=1, dim2=2), torch.zeros(2, 32))
    assert (d >= 0).all()


@pytest.mark.parametrize("idx_shape", [(2, 5), (2, 4, 3)])
def test_index_points_matches(idx_shape):
    pts = _cloud((2, 20, 6), 3)
    idx = np.random.default_rng(4).integers(0, 20, idx_shape)
    want = np.asarray(jg.index_points(jnp.asarray(pts), jnp.asarray(idx)))
    got = tg.index_points(torch.from_numpy(pts), torch.from_numpy(idx))
    assert torch.equal(got, torch.from_numpy(np.array(want)))


def test_index_points_rejects_other_ranks():
    with pytest.raises(ValueError):
        tg.index_points(torch.zeros(2, 4, 3), torch.zeros(2, dtype=torch.long))


@pytest.mark.parametrize("b,n,s", [(2, 64, 8), (3, 256, 32), (2, 2048, 32)])
def test_furthest_point_sample_matches(b, n, s):
    xyz = _cloud((b, n, 3), 5)
    want = np.asarray(jg.furthest_point_sample(jnp.asarray(xyz), s))
    got = tg.furthest_point_sample(torch.from_numpy(xyz), s)
    assert got[:, 0].eq(0).all()  # the deterministic start
    np.testing.assert_array_equal(got.numpy(), want)


def test_furthest_point_sample_takes_the_first_index_on_ties():
    """Four corners of a square and its centre: from corner 0 the opposite
    corner (2) is furthest, then corners 1 and 3 tie, and 1 comes first."""
    xyz = torch.tensor([[[0., 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                         [.5, .5, 0]]])
    assert tg.furthest_point_sample(xyz, 4).tolist() == [[0, 2, 1, 3]]


@pytest.mark.parametrize("b,n,s,k", [(2, 64, 8, 16), (2, 2048, 32, 128)])
def test_knn_groups_match_as_sets(b, n, s, k):
    xyz, q = _cloud((b, n, 3), 6), _cloud((b, s, 3), 7)
    want = np.asarray(jg.knn_point(k, jnp.asarray(xyz), jnp.asarray(q)))
    got = tg.knn_point(k, torch.from_numpy(xyz), torch.from_numpy(q))
    assert got.shape == (b, s, k)
    np.testing.assert_array_equal(np.sort(got.numpy(), -1),
                                  np.sort(want, -1))
    # nearest first
    d = tg.square_distance(torch.from_numpy(q), torch.from_numpy(xyz))
    dk = torch.gather(d, 2, got)
    assert (dk[..., 1:] >= dk[..., :-1]).all()


def test_cluster_matches():
    xyz = _cloud((2, 128, 3), 8)
    jc, jfps, jidx = jg.cluster(jnp.asarray(xyz), 16, 16)
    tc, tfps, tidx = tg.cluster(torch.from_numpy(xyz), 16, 16)
    np.testing.assert_array_equal(tfps.numpy(), np.asarray(jfps))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(np.sort(tidx.numpy(), -1),
                                  np.sort(np.asarray(jidx), -1))
