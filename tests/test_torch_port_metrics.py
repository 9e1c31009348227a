"""The evaluation slice as a whole: `ldt_torch.eval.metrics` against
`ldt_tpu.eval.metrics` on the CPU, on the same numpy sets of unit-radius
clouds (references; samples that are jittered references or other shapes).

Distance matrices are compared under tolerances; the metrics derived from
them by argmins (COV, 1-NNA, the JSD's nearest grid cells) are compared
exactly, on sets whose nearest-neighbour margins exceed those tolerances by
far, which each test asserts first."""

import numpy as np
import pytest
import torch

import ldt_tpu.eval.metrics as jm
from chip_smoke import knn_margin, margin, synthetic_shapes
from ldt_torch.eval import metrics as tm

# CD matrices: the direct-form distances against JAX's expanded form, whose
# error is ~1 ulp of |x|^2 + |y|^2 <= 2 for unit-radius clouds (~2.4e-7):
# relative where the chamfer is large, absolute where it is small (a cloud
# against its jittered copy at 128 points: read 2.2e-8 absolute, 3.8e-5
# relative).
CD_TOL = dict(rtol=2e-5, atol=1e-7)
# EMD matrices: each side's own distances through the annealing's first
# level (x 16384); read <= 7.9e-6 relative.
EMD_TOL = dict(rtol=1e-4, atol=1e-8)
# Argmin-derived metrics are compared exactly only where every nearest
# neighbour beats the runner-up by this much, relative: 10x the EMD limit.
MARGIN = 1e-3
DISCRETE = ("cov", "acc")
# The JSD's nearest cells: the least gap between a point's two nearest cells
# (squared distances), 100x the f32 rounding of JAX's |g|^2 - 2 p.g.
GRID_GAP = 1e-5


def _sets(seed, n_ref=6, n_smp=6, points=128):
    """(samples, references): half the samples are jittered references,
    half other shapes."""
    rng = np.random.default_rng(seed)
    ref = synthetic_shapes(n_ref, points, rng)
    smp = synthetic_shapes(n_smp, points, rng)
    half = n_smp // 2
    smp[:half] = ref[:half] + 0.01 * rng.standard_normal(
        ref[:half].shape).astype(np.float32)
    return smp, ref


def assert_metrics_match(got: dict, want: dict, tol: dict) -> None:
    """Every key: the argmin-derived ones exactly, the others within `tol`
    ({'CD': ..., 'EMD': ...})."""
    assert set(got) == set(want)
    for k, v in want.items():
        if any(d in k for d in DISCRETE):
            assert got[k] == v, (k, got[k], v)
        else:
            np.testing.assert_allclose(got[k], v, err_msg=k,
                                       **tol["EMD" if "EMD" in k else "CD"])


@pytest.fixture(scope="module")
def sets():
    smp, ref = _sets(0)
    # the argmin-derived metrics are well defined on these sets
    cd, emd = jm.pairwise_EMD_CD(ref, smp, 4)
    rr = jm.pairwise_EMD_CD(ref, ref, 4)
    ss = jm.pairwise_EMD_CD(smp, smp, 4)
    for i, m_rs in enumerate((cd, emd)):
        assert margin(m_rs.T, 1) > MARGIN
        assert knn_margin(rr[i], m_rs, ss[i]) > MARGIN
    return smp, ref


def test_pairwise_cd_matches_jax_and_its_symmetric_tiles(sets):
    smp, ref = sets
    want = jm.pairwise_CD(smp, ref, batch_size=2)
    got = tm.pairwise_CD(smp, ref, batch_size=2, device="cpu")
    assert got.dtype == np.float32 and got.shape == (6, 6)
    np.testing.assert_allclose(got, want, **CD_TOL)
    for bs, block in ((4, None), (2, 3), (32, None), (2, 2)):
        full = tm.pairwise_CD(ref, ref, batch_size=bs, block=block,
                              device="cpu")
        sym = tm.pairwise_CD(ref, ref, batch_size=bs, block=block,
                             symmetric=True, device="cpu")
        # chamfer's minima are symmetric bit for bit, and so are the means
        np.testing.assert_array_equal(sym, full)
        np.testing.assert_array_equal(sym, sym.T)
    np.testing.assert_allclose(
        sym, jm.pairwise_CD(ref, ref, batch_size=2, symmetric=True),
        **CD_TOL)


def test_symmetric_tiles_need_the_same_array():
    a, b = _sets(1, 4, 4, 16)
    with pytest.raises(ValueError, match="SAME array"):
        tm.pairwise_CD(a, b, batch_size=2, symmetric=True, device="cpu")
    with pytest.raises(ValueError, match="SAME array"):
        tm.pairwise_CD(a, a.copy(), batch_size=2, symmetric=True,
                       device="cpu")


def test_pairwise_emd_cd_matches_jax(sets):
    smp, ref = sets
    want = jm.pairwise_EMD_CD(smp, ref, batch_size=4)
    got = tm.pairwise_EMD_CD(smp, ref, batch_size=4, device="cpu")
    np.testing.assert_allclose(got[0], want[0], **CD_TOL)
    np.testing.assert_allclose(got[1], want[1], **EMD_TOL)
    # the approx-match is not symmetric in its arguments
    assert not np.array_equal(tm.pairwise_EMD_CD(ref, smp, 4,
                                                 device="cpu")[1].T, got[1])


@pytest.mark.parametrize("fn", ["pairwise_CD", "pairwise_EMD_CD"])
def test_the_matrices_do_not_depend_on_the_tile_shape(fn):
    smp, ref = _sets(2, 5, 7, 32)
    f = getattr(tm, fn)
    a = f(smp, ref, batch_size=2, block=2, device="cpu")
    b = f(smp, ref, batch_size=8, block=8, device="cpu")
    c = f(smp, ref, batch_size=3, device="cpu")
    for x, y in ((a, b), (a, c)):
        np.testing.assert_array_equal(x, y)
    assert tm._tile_shape(256, 256, 64, None, 2048, 2048) == \
        jm._tile_shape(256, 256, 64, None, 2048, 2048)
    assert tm._tile_shape(256, 256, 64, None, 2048, 2048, True) == \
        jm._tile_shape(256, 256, 64, None, 2048, 2048, True)


def test_emd_cd_matches_jax(sets):
    smp, ref = sets
    want = jm.EMD_CD(smp, ref, batch_size=4, reduced=False)
    got = tm.EMD_CD(smp, ref, batch_size=4, reduced=False, device="cpu")
    np.testing.assert_allclose(got["mmd-CD"], want["mmd-CD"], **CD_TOL)
    np.testing.assert_allclose(got["mmd-EMD"], want["mmd-EMD"], **EMD_TOL)
    red = tm.EMD_CD(smp, ref, batch_size=5, device="cpu")
    np.testing.assert_allclose(red["mmd-CD"], got["mmd-CD"].mean(), rtol=1e-6)
    np.testing.assert_allclose(red["mmd-EMD"], got["mmd-EMD"].mean(),
                               rtol=1e-6)


def test_compute_all_metrics_matches_jax(sets):
    smp, ref = sets
    want = jm.compute_all_metrics(smp, ref, batch_size=4, verbose=False)
    got = tm.compute_all_metrics(smp, ref, batch_size=4, verbose=False,
                                 device="cpu")
    assert_metrics_match(got, want, {"CD": CD_TOL, "EMD": EMD_TOL})
    assert 0 < got["cov-CD"] < 1 and 0 < got["1-NN-CD-acc"] < 1
    # either forced route (K7, K6) gives the default's metrics
    for otf in (True, False):
        assert tm.compute_all_metrics(smp, ref, batch_size=4, verbose=False,
                                      emd_otf=otf, device="cpu") == got


def test_compute_mmd_and_cd_metrics_match_jax(sets):
    smp, ref = sets
    tol = {"CD": CD_TOL, "EMD": EMD_TOL}
    assert_metrics_match(
        tm.compute_MMD_metrics(smp, ref, 4, verbose=False, device="cpu"),
        jm.compute_MMD_metrics(smp, ref, 4, verbose=False), tol)
    assert_metrics_match(
        tm.compute_CD_metrics(smp, ref, 4, verbose=False, device="cpu"),
        jm.compute_CD_metrics(smp, ref, 4, verbose=False), tol)


def test_lgan_mmd_cov_and_knn_equal_jax_on_the_same_matrices():
    rng = np.random.default_rng(3)
    m = rng.uniform(0, 1, (7, 5)).astype(np.float32)
    assert tm.lgan_mmd_cov(m) == jm.lgan_mmd_cov(m)
    mxx, mxy, myy = (rng.uniform(0, 1, s) for s in ((5, 5), (5, 7), (7, 7)))
    for k in (1, 3):
        for sqrt in (False, True):
            assert tm.knn(mxx, mxy, myy, k, sqrt) == jm.knn(mxx, mxy, myy, k,
                                                            sqrt)


def _grid_clouds(seed, count, points, upper: bool):
    """Clouds of jittered cell centres of the resolution-28 in-sphere grid
    (each point within 0.3 cell spacings of its cell per coordinate, so its
    nearest cell wins by >= 0.22 spacing^2); `upper`: cells with z > 0."""
    rng = np.random.default_rng(seed)
    grid, spacing = tm.unit_cube_grid_point_cloud(28, True)
    grid = grid.reshape(-1, 3)
    if upper:
        grid = grid[grid[:, 2] > 0]
    cells = grid[rng.integers(0, len(grid), (count, points))]
    jitter = rng.uniform(-0.3, 0.3, cells.shape) * spacing
    return (cells + jitter).astype(np.float32)


def test_jsd_matches_jax():
    """The nearest grid cells in the direct form (here) and JAX's
    |g|^2 - 2 p.g (values up to ~1, rounded to ~1e-7) agree where no point's
    two nearest cells are within GRID_GAP of each other; then the counts and
    the JSD are equal."""
    smp = _grid_clouds(4, 4, 256, upper=False)
    ref = _grid_clouds(5, 4, 256, upper=True)
    grid, _ = tm.unit_cube_grid_point_cloud(28, True)
    grid = grid.reshape(-1, 3).astype(np.float64)
    for pcs in (smp, ref):
        d = np.sort(((pcs.reshape(-1, 1, 3).astype(np.float64)
                      - grid[None]) ** 2).sum(-1), axis=1)
        assert (d[:, 1] - d[:, 0]).min() > GRID_GAP
    for pcs in (smp, ref):
        got = tm.entropy_of_occupancy_grid(pcs, 28, True, device="cpu")
        want = jm.entropy_of_occupancy_grid(pcs, 28, True)
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0] == want[0]
    got = tm.jsd_between_point_cloud_sets(smp, ref, device="cpu")
    assert got == jm.jsd_between_point_cloud_sets(smp, ref) and got > 0
    assert tm.jsd_between_point_cloud_sets(smp, smp, device="cpu") == \
        pytest.approx(0.0, abs=1e-12)


def test_occupancy_counts_tiles_and_ties(monkeypatch):
    """Grid tiles change nothing; an exact tie goes to the first cell, as
    numpy's argmin."""
    grid = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0]])
    pts = torch.tensor([[[0.5, 0, 0], [1.5, 0, 0], [2.0, 0, 0]]])
    want = torch.tensor([[1.0, 1.0, 1.0]])
    assert torch.equal(tm._occupancy_counts(pts, grid), want)
    monkeypatch.setattr(tm, "_OCCUPANCY_TILE", 3)  # one cell per tile
    assert torch.equal(tm._occupancy_counts(pts, grid), want)


def test_inputs_may_be_tensors_and_results_are_numpy():
    smp, ref = _sets(5, 3, 3, 16)
    a = tm.pairwise_EMD_CD(torch.from_numpy(smp), torch.from_numpy(ref), 2,
                           device="cpu")
    b = tm.pairwise_EMD_CD(smp, ref.astype(np.float64), 2, device="cpu")
    for x, y in zip(a, b):
        assert isinstance(x, np.ndarray)
        np.testing.assert_array_equal(x, y)
