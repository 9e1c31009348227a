"""The eval kernels' plain twins against ldt_tpu on the CPU: K5
(`pairwise_cd_means`) against the Pallas `pairwise_cd_means_pallas` in
interpret mode and the XLA chamfer means; K6/K7 (`approx_match_cost`)
against `_approx_match_cost_pallas` in interpret mode (both `_EMD_OTF`
modes) and the XLA form `_approx_match_cost_single`, with JAX's own
distances (the algorithm) and with the port's (the whole path); the matrix
form's mass conservation; the wrappers' CPU dispatch and their refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import synthetic_shapes
from ldt_tpu.ops import chamfer as jchamfer
from ldt_tpu.ops import emd as jemd
from ldt_tpu.ops.geometry import square_distance as jax_square_distance
from ldt_torch.ops import chamfer, emd

# The algorithm on JAX's own distances: the same f32 arithmetic, the sums in
# another order (the tolerance the JAX package holds its Pallas EMD kernel to
# against the XLA form, tests/test_ops.py).
ALGO_TOL = dict(rtol=2e-5, atol=1e-5)
# K5 / chamfer means: the port takes d in the direct form, JAX in the
# expanded form |x|^2 + |y|^2 - 2 x.y; a minimum moves by ~1 ulp of
# |x|^2 + |y|^2, which is largest relative to the smallest minima (a cloud
# against its jittered copy: read <= 5.8e-6 on unit-radius shapes at 512
# points, <= 1.4e-6 on uniform clouds).
CD_TOL = dict(rtol=2e-5, atol=1e-7)
# The whole EMD path, port vs JAX, each with its own distances: the
# expanded form's ~1-ulp error of |x|^2 + |y|^2 is multiplied by 4^7 = 16384
# in the first level's exponent, which moves the early matches; read on
# unit-radius clouds at 512 points: <= 7.9e-6 relative (a cloud against its
# jittered copy, where the early levels match most of the mass), 2.2e-7 on
# distinct shapes. A twin without the last level reads >= 3.2e-3 on the
# distinct shapes (test below).
PATH_REL = 1e-4


def _rand(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _shapes(seed, count=3, points=512):
    """Unit-radius clouds at ShapeNet's scale: references, and against each
    either a jittered copy or another shape."""
    rng = np.random.default_rng(seed)
    ref = synthetic_shapes(count, points, rng)
    smp = synthetic_shapes(count, points, rng)
    smp[0] = ref[0] + 0.01 * rng.standard_normal(ref[0].shape)
    return smp, ref


def test_pairwise_cd_means_plain_matches_the_pallas_kernel():
    x, y = _rand((3, 512, 3), 0), _rand((3, 256, 3), 1)
    want = np.asarray(jchamfer.pairwise_cd_means_pallas(
        jnp.asarray(x), jnp.asarray(y), interpret=True))
    got = chamfer.pairwise_cd_means_plain(_t(x), _t(y)).numpy()
    np.testing.assert_allclose(got, want, **CD_TOL)
    d1, d2, _, _ = jchamfer.chamfer_distance(jnp.asarray(x), jnp.asarray(y))
    xla = np.asarray(jnp.mean(d1, axis=1) + jnp.mean(d2, axis=1))
    np.testing.assert_allclose(got, xla, **CD_TOL)
    # and on unit-radius shapes
    smp, ref = _shapes(2)
    want = np.asarray(jchamfer.pairwise_cd_means_pallas(
        jnp.asarray(smp), jnp.asarray(ref), interpret=True))
    np.testing.assert_allclose(
        chamfer.pairwise_cd_means_plain(_t(smp), _t(ref)).numpy(), want,
        **CD_TOL)


@pytest.mark.parametrize("otf", [False, True])
def test_approx_match_cost_plain_on_jax_distances_matches_pallas(
        otf, monkeypatch):
    """K6 streams JAX's d, K7 builds it in the kernel (an MXU-precision dot
    in the expanded form); the twin gets `square_distance`'s d."""
    monkeypatch.setattr(jemd, "_EMD_OTF", otf)
    n = jemd._EMD_TILE * 2  # two row tiles
    x, y = _rand((3, n, 3), 3), _rand((3, n, 3), 4)
    want = np.asarray(jemd._approx_match_cost_pallas(
        jnp.asarray(x), jnp.asarray(y), interpret=True))
    d = np.asarray(jnp.maximum(jax_square_distance(jnp.asarray(x),
                                                   jnp.asarray(y)), 0.0))
    got = emd.approx_match_cost_plain(_t(x), _t(y), d=_t(d)).numpy()
    np.testing.assert_allclose(got, want, **ALGO_TOL)


@pytest.mark.parametrize("n,m", [(64, 64), (32, 64), (64, 32), (40, 96)])
def test_approx_match_cost_plain_on_jax_distances_matches_xla(n, m):
    """The XLA form, N != M included (multi_l = max(1, m // n),
    multi_r = max(1, n // m))."""
    x, y = _rand((2, n, 3), 5), _rand((2, m, 3), 6)
    want = np.asarray(jax.vmap(jemd._approx_match_cost_single)(
        jnp.asarray(x), jnp.asarray(y)))
    d = np.asarray(jnp.maximum(jax_square_distance(jnp.asarray(x),
                                                   jnp.asarray(y)), 0.0))
    got = emd.approx_match_cost_plain(_t(x), _t(y), d=_t(d)).numpy()
    np.testing.assert_allclose(got, want, **ALGO_TOL)


def test_approx_match_cost_port_path_against_jax(monkeypatch):
    """Each with its own distances (direct form here, expanded in JAX),
    within the measured limit; a twin that drops the last level does not
    pass it."""
    smp, ref = _shapes(7)
    want = np.asarray(jax.vmap(jemd._approx_match_cost_single)(
        jnp.asarray(smp), jnp.asarray(ref)))
    got = emd.approx_match_cost(_t(smp), _t(ref)).numpy()
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() <= PATH_REL, rel
    with monkeypatch.context() as mp:
        mp.setattr(emd, "LEVELS", emd.LEVELS[:-1])
        wrong = emd.approx_match_cost_plain(_t(smp), _t(ref)).numpy()
    assert (np.abs(wrong - want) / np.abs(want)).max() > 10 * PATH_REL
    np.testing.assert_allclose(emd.emd_approx(_t(smp), _t(ref)).numpy(),
                               got / smp.shape[1], rtol=1e-7)


def test_approx_match_mass_conservation_and_the_jax_matrix_form():
    x, y = _rand((1, 64, 3), 8), _rand((1, 64, 3), 9)
    match = emd.approx_match_plain(_t(x), _t(y))[0].numpy()
    np.testing.assert_allclose(match.sum(1), np.ones(64), atol=2e-2)
    np.testing.assert_allclose(match.sum(0), np.ones(64), atol=2e-2)
    # the match accumulates nine levels of products whose sums run in
    # another order; an element moves by up to ~1.3e-5 (read), of a match
    # whose rows sum to 1
    want = np.asarray(jemd._approx_match_single(jnp.asarray(x[0]),
                                                jnp.asarray(y[0])))
    np.testing.assert_allclose(match, want, rtol=0, atol=5e-5)
    # the cost-only form is the match's cost
    d = ((x[0][:, None] - y[0][None]) ** 2).sum(-1)
    np.testing.assert_allclose(
        emd.approx_match_cost_plain(_t(x), _t(y)).numpy()[0],
        (match * np.sqrt(np.maximum(d, 1e-20))).sum(), rtol=1e-5)


def test_cpu_tensors_take_the_plain_twins_and_count_nothing():
    x, y = _t(_rand((2, 48, 3), 10)), _t(_rand((2, 40, 3), 11))
    before = (chamfer.pairwise_cd_means.launches,
              emd.approx_match_cost.launches,
              emd.approx_match_cost.otf_launches)
    assert torch.equal(chamfer.pairwise_cd_means(x, y),
                       chamfer.pairwise_cd_means_plain(x, y))
    plain = emd.approx_match_cost_plain(x, y)
    for otf in (False, True):
        assert torch.equal(emd.approx_match_cost(x, y, otf=otf), plain)
    # other dtypes are taken as float32, as the JAX package casts them
    assert torch.equal(emd.approx_match_cost(x.double(), y.double()), plain)
    assert (chamfer.pairwise_cd_means.launches,
            emd.approx_match_cost.launches,
            emd.approx_match_cost.otf_launches) == before


@pytest.mark.parametrize("fn", [chamfer.pairwise_cd_means,
                                emd.approx_match_cost])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(fn):
    ok = torch.zeros(2, 8, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        fn(torch.zeros(2, 8, 3, device="meta"),
           torch.zeros(2, 8, 3, device="meta"))
    with pytest.raises(ValueError, match="expected clouds"):
        fn(ok, torch.zeros(3, 8, 3))
    with pytest.raises(ValueError, match="expected clouds"):
        fn(ok, torch.zeros(2, 8, 2))
    with pytest.raises(ValueError, match="empty"):
        fn(ok, torch.zeros(2, 0, 3))
    with pytest.raises(ValueError, match="shared memory"):
        fn(torch.zeros(1, 20000, 3), torch.zeros(1, 20000, 3))
