"""The stage-1 losses: ldt_torch.ops.chamfer, ldt_torch.ops.emd and
ldt_torch.eval.loss against their ldt_tpu counterparts on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.eval.loss as jloss
import ldt_tpu.ops.chamfer as jchamfer
import ldt_tpu.ops.emd as jemd
from ldt_torch.eval import loss as tloss
from ldt_torch.ops import chamfer, emd

# The JAX package takes distances in the expanded form |x|^2 + |y|^2 - 2 x.y,
# the port one coordinate at a time: they differ by the expanded form's
# cancellation, ~1e-7 of |x|^2 (clouds of scale 1 here).
DIST_TOL = dict(rtol=1e-5, atol=1e-6)
# losses and gradients from those distances (sqrt of a small distance
# magnifies its relative error)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _grid(shape, seed, step=0.25):
    """Points on a grid of `step` (a power of 2) in [-1, 1]: every squared
    distance is exact in f32, in either form, and many tie."""
    k = int(round(1 / step))
    return (np.random.default_rng(seed).integers(-k, k + 1, shape)
            * step).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("n,m", [(64, 48), (37, 64)])
def test_chamfer_distance_matches(n, m):
    x, y = _rand((2, n, 3), 0), _rand((2, m, 3), 1)
    want = jchamfer.chamfer_distance(jnp.asarray(x), jnp.asarray(y))
    got = chamfer.chamfer_distance(_t(x), _t(y))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **DIST_TOL)
    for g, w in zip(got[2:], want[2:]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert chamfer.chamfer_metric(_t(x), _t(y))[0].shape == (2, n)


@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_chamfer_loss_and_its_gradients_match(kind):
    x, y = _rand((2, 64, 3), 2), _rand((2, 48, 3), 3)
    want, (gx, gy) = jax.value_and_grad(
        lambda a, b: jchamfer.chamfer_loss(a, b, kind), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(y))
    tx, ty = _t(x, True), _t(y, True)
    got = chamfer.chamfer_loss(tx, ty, kind)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **LOSS_TOL)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy), **LOSS_TOL)


def test_chamfer_gradient_at_a_tie_goes_to_the_first_neighbour():
    """x is equidistant from y[0] and y[1]: `jnp.min` splits the gradient
    of d1 between them (here it cancels to 0); the port recomputes the
    distance at the first argmin, 2 (x - y[0])."""
    x = np.zeros((1, 1, 3), np.float32)
    y = np.array([[[1, 0, 0], [-1, 0, 0]]], np.float32)

    def jax_d1(a):
        return jnp.sum(jchamfer.chamfer_distance(a, jnp.asarray(y))[0])

    want = np.asarray(jax.grad(jax_d1)(jnp.asarray(x)))
    tx = _t(x, True)
    d1, _, idx1, _ = chamfer.chamfer_distance(tx, _t(y))
    d1.sum().backward()
    assert idx1.tolist() == [[0]]
    assert np.array_equal(tx.grad.numpy(), [[[-2.0, 0.0, 0.0]]])
    assert np.array_equal(want, np.zeros((1, 1, 3), np.float32))


@pytest.mark.parametrize("seed,iters", [(0, 50), (1, 50), (2, 50), (3, 5)])
def test_auction_assignment_equals_jax_on_a_dyadic_grid(seed, iters):
    """Clouds on a grid of quarters: distances exact in both forms and full
    of ties (first-index tie breaks in argmax and in the column awards);
    5 rounds leave rows unassigned, which fall back to their nearest
    column."""
    x, y = _grid((2, 128, 3), seed), _grid((2, 128, 3), seed + 10)
    d = ((x[:, :, None] - y[:, None]) ** 2).sum(-1)
    assert ((d == d.min(axis=2, keepdims=True)).sum(-1) > 1).any()  # ties
    _, want = jemd.auction_emd(jnp.asarray(x), jnp.asarray(y), iters=iters,
                               compact=False)
    dist, got = emd.auction_emd(_t(x), _t(y), iters=iters)
    assert np.array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        dist.numpy(), ((x - np.take_along_axis(y, got.numpy()[..., None],
                                                1)) ** 2).sum(-1))
    if iters == 5:
        assert any(len(set(a)) < len(a) for a in got.tolist())


def test_emd_loss_and_its_gradient_match():
    """The prediction on a grid of sixteenths, the target of quarters: the
    same assignment as JAX, then the loss and its gradient (to the
    prediction only)."""
    x, y = _grid((2, 96, 3), 4, step=1 / 16), _grid((2, 96, 3), 5)
    want, (gx, gy) = jax.value_and_grad(jemd.emd_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    tx, ty = _t(x, True), _t(y, True)
    got = emd.emd_loss(tx, ty)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **LOSS_TOL)
    assert ty.grad is None and not np.asarray(gy).any()


def _loss_cases():
    x, y = _rand((2, 40, 3), 6), _rand((2, 40, 3), 7)
    xs, ys = 0.05 * x, 0.05 * y + 0.01  # scores near the F1 threshold
    d1, d2 = np.abs(_rand((3, 20), 8)) * 2e-3, np.abs(_rand((3, 30), 9)) * 2e-3
    gx, gy = _grid((2, 64, 3), 10), _grid((2, 64, 3), 11)
    logits = (_rand((4, 10), 12), _rand((4, 10), 13))
    err = _rand((5, 7), 14)
    return {
        "CD_loss_l1": ("CD_loss", (x, y), {}),
        "CD_loss_l2": ("CD_loss", (x, y), {"kind": "l2"}),
        "EMD_loss": ("EMD_loss", (gx, gy), {}),
        "L2_ChamferEval_1000": ("L2_ChamferEval_1000", (x, y), {}),
        "fscore": ("fscore", (d1, d2), {}),
        "F1Score": ("F1Score", (xs, ys), {"threshold": 0.0005}),
        "kl_softmax_loss": ("kl_softmax_loss", logits, {}),
        "huber_loss": ("huber_loss", (err,), {"delta": 0.7}),
    }


@pytest.mark.parametrize("case", list(_loss_cases()))
def test_eval_loss_functions_match(case):
    name, args, kw = _loss_cases()[case]
    want = getattr(jloss, name)(*(jnp.asarray(a) for a in args), **kw)
    got = getattr(tloss, name)(*(_t(a) for a in args), **kw)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOSS_TOL)
    if name == "F1Score":  # the threshold splits the points
        assert 0 < float(want[0].mean()) < 1


def test_kl_softmax_loss_gradient_flows_to_y_only():
    x, y = _rand((4, 10), 15), _rand((4, 10), 16)
    gx, gy = jax.grad(jloss.kl_softmax_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    tx, ty = _t(x, True), _t(y, True)
    tloss.kl_softmax_loss(tx, ty).backward()
    assert tx.grad is None and not np.asarray(gx).any()
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy), **LOSS_TOL)
