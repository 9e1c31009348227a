"""The renderer and the native bulk loader, ldt_torch against ldt_tpu on
the CPU: `tools.vis_utils` (the Mitsuba scene's XML text equal to JAX's,
`render_3D`'s files and fallbacks), `valsample(vis=True)` in the three
trainers that have it (stage 1, stage 2, completion), `data.fastload`
(bit for bit np.load, its per-file fallback, the not-ok and strict-shape
cases of tests/test_fastload.py, its build under build/ldt_torch/ and a
failed build's warning and flag) and the ShapeNet dataset that reads
through it, equal to the JAX one's."""

import os
import sys
import types
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

from ldt_tpu.data.shapenet55 import ShapeNet15kPointClouds as JaxShapeNet
from ldt_tpu.tools import vis_utils as jvis
from ldt_torch.configs import (
    compressor_trainer_cfg,
    dict2namespace,
    latent_trainer_cfg,
)
from ldt_torch.data import fastload
from ldt_torch.data.shapenet55 import ShapeNet15kPointClouds
from ldt_torch.ops import _build
from ldt_torch.tools import vis_utils as tvis
from ldt_torch.training.completion_latent_sde_trainer import (
    Trainer as Completion,
)
from ldt_torch.training.compressor_trainer import Trainer as Stage1
from ldt_torch.training.latent_sde_trainer import Trainer as Stage2
from test_torch_port_common import SMALL_COMPRESSOR, SMALL_SCORE
from test_torch_port_completion import _batch as _vipc_batch
from test_torch_port_completion import cfg_dict as completion_cfg

B, N = 2, SMALL_COMPRESSOR["outsize"]
SDE = dict(beta_start=0.1, beta_end=4.0, sde_type="vpsde", sample_N=8,
           train_N=8)


def _cloud(seed, n=N):
    return np.random.default_rng(seed).standard_normal((n, 3)).astype(
        np.float32)


# --- vis_utils ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["cloud", "flat", "float64", "one_point"])
def test_npy2xml_text_equals_jax(case):
    pts = {"cloud": _cloud(0), "flat": np.c_[_cloud(1)[:, :2],
                                             np.zeros(N, np.float32)],
           "float64": _cloud(2).astype(np.float64),
           "one_point": np.ones((1, 3), np.float32)}[case]
    with np.errstate(invalid="ignore", divide="ignore"):
        want = jvis.npy2xml(pts)
        got = tvis.npy2xml(pts)
    assert got == want
    assert got.startswith(jvis.XML_HEAD) and got.endswith(jvis.XML_TAIL)
    assert got.count('<shape type="sphere">') == len(pts)
    assert tvis.npy2xml(pts, radius=0.02) == jvis.npy2xml(pts, radius=0.02)


def test_render_3D_writes_jax_files_and_caps(tmp_path):
    """The first `max_renders` clouds as `smp_<i>.xml` (JAX's text) and,
    with matplotlib (imported here), `smp_<i>.png`."""
    sample = np.stack([_cloud(s) for s in range(5)])
    tvis.render_3D(str(tmp_path / "t"), sample, max_renders=3)
    jvis.render_3D(str(tmp_path / "j"), sample, max_renders=3)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        f"smp_{i}.{ext}" for i in range(3) for ext in ("png", "xml")]
    for i in range(3):
        assert (tmp_path / "t" / f"smp_{i}.xml").read_text() == \
            (tmp_path / "j" / f"smp_{i}.xml").read_text()
    tvis.render_3D(str(tmp_path / "all"), sample[:2], name="ref",
                   max_renders=None)
    assert sorted(os.listdir(tmp_path / "all")) == [
        "ref_0.png", "ref_0.xml", "ref_1.png", "ref_1.xml"]


def test_render_3D_falls_back_without_renderers(tmp_path, monkeypatch):
    """A bare `mitsuba` stub is no Mitsuba: matplotlib renders; without
    matplotlib the XML is written alone."""
    monkeypatch.setitem(sys.modules, "mitsuba", types.ModuleType("mitsuba"))
    tvis.render_3D(str(tmp_path / "a"), _cloud(0)[None])
    assert sorted(os.listdir(tmp_path / "a")) == ["smp_0.png", "smp_0.xml"]

    def no_matplotlib(*a, **k):
        raise ImportError("no matplotlib")

    monkeypatch.setattr(tvis, "_render_matplotlib", no_matplotlib)
    tvis.render_3D(str(tmp_path / "b"), _cloud(0)[None])
    assert os.listdir(tmp_path / "b") == ["smp_0.xml"]


def _test_loader(seed, batches=2):
    rng = np.random.default_rng(seed)
    return [{"te_points": rng.standard_normal((B, N, 3)).astype(np.float32),
             "shift": np.zeros((B, 1, 3), np.float32),
             "scale": np.ones((B, 1, 1), np.float32),
             "cate_idx": np.zeros(B, np.int32)} for _ in range(batches)]


def _assert_rendered(save_path, smp_file):
    smp = np.load(os.path.join(save_path, smp_file))
    vis = os.path.join(save_path, "vis")
    xml = sorted(f for f in os.listdir(vis) if f.endswith(".xml"))
    assert xml == [f"smp_{i}.xml" for i in range(min(len(smp), 16))]
    for i, name in enumerate(xml):
        with open(os.path.join(vis, name)) as f:
            assert f.read() == jvis.npy2xml(smp[i])


@pytest.mark.parametrize("stage", ["stage1", "stage2", "completion"])
def test_valsample_vis_renders_the_samples(stage, tmp_path):
    """`valsample(vis=True)` renders the samples it saved under
    `<save_path>/vis`, each scene JAX's `npy2xml` of the saved cloud;
    without a save path it raises before sampling."""
    if stage == "completion":
        d = completion_cfg(tmp_path)
        del d["log"]
        trainer = Completion(dict2namespace(d), device="cpu")
        loader = [_vipc_batch(s) for s in (5, 6)]
        trainer.maybe_init(loader[0])
        run = lambda: trainer.valsample(loader, vis=True)  # noqa: E731
    elif stage == "stage1":
        trainer = Stage1(compressor_trainer_cfg(model=SMALL_COMPRESSOR),
                         device="cpu")
        run = lambda: trainer.valsample(_test_loader(3), N, vis=True)  # noqa
    else:
        trainer = Stage2(latent_trainer_cfg(
            score=dict(SMALL_SCORE, num_blocks=1), compressor=SMALL_COMPRESSOR,
            sde=SDE), device="cpu")
        run = lambda: trainer.valsample(_test_loader(3), vis=True)  # noqa
    if stage != "completion":
        trainer.maybe_init({"tr_points": _test_loader(4)[0]["te_points"]})
    with pytest.raises(ValueError, match="save_path"):
        run()
    trainer.cfg.log = SimpleNamespace(save_path=str(tmp_path))
    res = run()
    assert res and all(np.isfinite(v) for v in res.values())
    _assert_rendered(str(tmp_path), "smp_ep1.npy")


# --- fastload ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("npys")
    rng = np.random.RandomState(0)
    paths, want = [], []
    for i in range(7):
        p = str(d / f"m{i}.npy")
        arr = rng.randn(50, 3).astype(np.float32)
        np.save(p, arr)
        paths.append(p)
        want.append(arr)
    return paths, np.stack(want), d


def test_load_npy_batch_bit_for_bit_and_built_in_build_dir(tree):
    paths, want, _ = tree
    for threads in (0, 1, 3):
        got, ok = fastload.load_npy_batch(paths, (50, 3), n_threads=threads)
        assert ok.all() and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert fastload.native_available() and not fastload.build_failed
    lib = fastload.library_path()
    assert lib.exists() and lib.parent == _build.BUILD_DIR
    assert not any(f.endswith(".so") for f in os.listdir(
        os.path.dirname(fastload.SOURCE)))
    empty, ok = fastload.load_npy_batch([], (50, 3))
    assert empty.shape == (0, 50, 3) and ok.shape == (0,)


def test_load_npy_batch_falls_back_per_file(tree):
    """A file the parser rejects (float64, Fortran order) is read by
    np.load, cast to float32; another shape or a missing file is not ok;
    the rest load natively, as JAX's loader gives them."""
    from ldt_tpu.data import fastload as jfastload

    paths, want, d = tree
    p64 = str(d / "f64.npy")
    np.save(p64, np.arange(150, dtype=np.float64).reshape(50, 3))
    pf = str(d / "fortran.npy")
    np.save(pf, np.asfortranarray(want[2]))
    bad = str(d / "bad.npy")
    np.save(bad, np.zeros((3, 3), np.float32))
    missing = str(d / "nope.npy")
    transposed = str(d / "t.npy")
    np.save(transposed, np.zeros((3, 50), np.float32))
    batch = [paths[0], p64, pf, bad, missing, transposed]
    got, ok = fastload.load_npy_batch(batch, (50, 3))
    assert list(ok) == [True, True, True, False, False, False]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], np.arange(150, dtype=np.float64)
                                  .reshape(50, 3).astype(np.float32))
    np.testing.assert_array_equal(got[2], want[2])
    jgot, jok = jfastload.load_npy_batch(batch, (50, 3))
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(got[ok], jgot[jok])


def test_load_npy_batch_strict_shape_raises(tree):
    paths, _, d = tree
    bad = str(d / "bad2.npy")
    np.save(bad, np.zeros((150,), np.float32))  # as many elements
    with pytest.raises(ValueError, match="shape"):
        fastload.load_npy_batch([paths[0], bad], (50, 3), strict_shape=True)
    _, ok = fastload.load_npy_batch([paths[0], str(d / "nope2.npy")],
                                    (50, 3), strict_shape=True)
    assert list(ok) == [True, False]


def test_failed_build_warns_once_and_reads_with_np_load(tree, tmp_path,
                                                        monkeypatch):
    """A source that does not compile: one warning, `build_failed` set,
    every file read by np.load with the same result."""
    paths, want, _ = tree
    broken = tmp_path / "fastload.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(fastload, "SOURCE", broken)
    monkeypatch.setattr(fastload, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(fastload, "_lib", None)
    monkeypatch.setattr(fastload, "build_failed", False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got, ok = fastload.load_npy_batch(paths, (50, 3))
        again, _ = fastload.load_npy_batch(paths, (50, 3))
    assert fastload.build_failed and not fastload.native_available()
    assert [str(w.message) for w in caught if "native loader" in str(
        w.message)] and len(caught) == 1
    assert ok.all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(again, want)


def test_shapenet_dataset_reads_through_fastload_as_jax(tmp_path,
                                                        monkeypatch):
    """The dataset's clouds, order (the 38383 shuffle), labels, ids and
    normalization equal the JAX dataset's on a tree with a float64 file
    (the per-file fallback) and an unreadable one (skipped); the port's
    loads went through `load_npy_batch`."""
    rng = np.random.RandomState(1)
    for synset in ("02691156", "02958343"):
        d = tmp_path / "PC15k" / synset / "train"
        d.mkdir(parents=True)
        for i in range(3):
            np.save(d / f"m{i}.npy", rng.randn(15000, 3).astype(np.float32))
    np.save(tmp_path / "PC15k" / "02691156" / "train" / "m9.npy",
            rng.randn(15000, 3))
    (tmp_path / "PC15k" / "02958343" / "train" / "broken.npy").write_bytes(
        b"not an npy")
    calls = []
    real = fastload.load_npy_batch
    import ldt_torch.data.shapenet55 as tsn
    monkeypatch.setattr(tsn, "load_npy_batch",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    kw = dict(root_dir=str(tmp_path / "PC15k"), categories=("airplane",
                                                            "car"),
              split="train", tr_sample_size=64, te_sample_size=64)
    got, want = ShapeNet15kPointClouds(**kw), JaxShapeNet(**kw)
    assert calls == [{"strict_shape": True}]
    assert len(got) == len(want) == 7
    np.testing.assert_array_equal(got.all_points, want.all_points)
    assert got.cate_idx_lst == want.cate_idx_lst
    assert got.all_cate_mids == want.all_cate_mids
    np.testing.assert_array_equal(got.per_points_shift,
                                  want.per_points_shift)
    np.testing.assert_array_equal(got.per_points_scale,
                                  want.per_points_scale)
    a, b = got[3], want[3]
    for k in ("tr_points", "te_points"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
