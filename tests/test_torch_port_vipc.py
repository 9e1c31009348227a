"""The ViPC data path without PIL, on the CPU: `ldt_torch.data.png` against
PIL (PIL is only a test oracle here: the card's machine has none), the
synthetic tree of `ldt_torch.tools.synth_vipc` against
`scripts/make_synth_vipc.py`'s, and `ldt_torch.data.vipc` against
`ldt_tpu.data.vipc` item for item and batch for batch.

Limits: decoded pixels exact; views at 224 x 224 (no resize) exact; views
resized (137 -> 224, non-square) within 1/255 of PIL's (the stated bound;
the port's resize gives PIL's bytes here); clouds exact. The random view is
drawn from Python's global `random`, seeded the same for both loaders, with
no worker threads."""

import os
import pickle
import random
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import ldt_tpu.data.vipc as jvipc
from ldt_tpu.tools.io import dict2namespace as jax_ns
from ldt_torch.configs import dict2namespace
from ldt_torch.data import png
from ldt_torch.data import vipc
from ldt_torch.tools import synth_vipc

ROOT = Path(__file__).resolve().parents[1]
SIZES = {"224": (224, 224), "137": (137, 137), "wide": (200, 150)}


def _smooth(rng, h, w, c):
    """A smooth random image (bicubic-upsampled noise), [h, w, c] uint8:
    rows whose filters PIL picks vary (Sub, Up, Average, Paeth)."""
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, c), dtype=np.uint8)
    up = [np.asarray(Image.fromarray(base[..., i]).resize((w, h),
                                                          Image.BICUBIC))
          for i in range(c)]
    return np.stack(up, axis=-1)


def _image(mode, size, seed=0):
    rng = np.random.default_rng(seed)
    w, h = size
    if mode == "P":
        return Image.fromarray(_smooth(rng, h, w, 3)).convert(
            "P", palette=Image.ADAPTIVE)
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    a = _smooth(rng, h, w, c)
    if c in (2, 4):  # alpha with fully transparent and opaque pixels
        alpha = a[..., -1]
        alpha[alpha < 80] = 0
        alpha[alpha > 200] = 255
    return Image.fromarray(a[..., 0] if c == 1 else a, mode)


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA"])
def test_read_png_matches_pil(mode, tmp_path):
    path = str(tmp_path / f"{mode}.png")
    _image(mode, (61, 47), 1).save(path)
    got_mode, got = png.read_png(path)
    with Image.open(path) as im:
        assert got_mode == im.mode
        np.testing.assert_array_equal(got, np.asarray(im))


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA"])
def test_load_view_matches_the_pil_loader(mode, size, tmp_path):
    """`load_view` against the JAX package's PIL read (`Resize(224)` of
    the short side, bilinear; RGBA and LA premultiplied)."""
    path = str(tmp_path / f"{mode}_{size}.png")
    _image(mode, SIZES[size], 2).save(path)
    got = png.load_view(path)
    want = jvipc._load_image(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    if size == "224":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1 / 255 + 1e-7


def test_resize_premultiplies_alpha(tmp_path):
    """A transparent pixel's colour must not bleed into its neighbours: the
    premultiplied resize differs from a plain per-channel one here."""
    a = np.zeros((6, 6, 4), np.uint8)
    a[..., :3] = 255          # white, but transparent ...
    a[:, :3] = (10, 20, 30, 255)  # ... beside an opaque dark half
    got = png.resize("RGBA", a, (9, 9))
    want = np.asarray(Image.fromarray(a, "RGBA").resize((9, 9),
                                                        Image.BILINEAR))
    np.testing.assert_array_equal(got, want)
    plain = png.resize("RGB", a[..., :3].copy(), (9, 9))
    assert not np.array_equal(plain, want[..., :3])


@pytest.mark.parametrize("channels", [3, 4])
def test_write_png_round_trips(channels, tmp_path):
    a = np.random.default_rng(3).integers(0, 256, (37, 53, channels),
                                          dtype=np.uint8)
    path = str(tmp_path / "w.png")
    png.write_png(path, a)
    with Image.open(path) as im:
        assert im.mode == ("RGB", "RGBA")[channels - 3]
        np.testing.assert_array_equal(np.asarray(im), a)
    np.testing.assert_array_equal(png.read_png(path)[1], a)
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(path, a[..., 0])


def _patch_ihdr(data: bytes, offset: int, value: int) -> bytes:
    """A PNG with one IHDR byte changed (and its CRC redone)."""
    body = bytearray(data[16:29])
    body[offset] = value
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + bytes(body)))
    return data[:16] + bytes(body) + crc + data[33:]


def test_unsupported_pngs_raise_by_name(tmp_path):
    good = tmp_path / "good.png"
    png.write_png(str(good), np.zeros((4, 4, 3), np.uint8))
    data = good.read_bytes()
    cases = {"bit depth 16": _patch_ihdr(data, 8, 16),
             "colour type 5": _patch_ihdr(data, 9, 5),
             "interlaced": _patch_ihdr(data, 12, 1),
             "CRC": data[:19] + b"\x05" + data[20:]}  # width, CRC kept
    for what, blob in cases.items():
        path = tmp_path / "bad.png"
        path.write_bytes(blob)
        with pytest.raises(ValueError, match=what.split()[0]):
            png.read_png(str(path))
    # a scanline filter outside 0-4
    raw = zlib.compress(bytes([7] + [0] * 12) * 4)
    idat = struct.pack(">I", len(raw)) + b"IDAT" + raw + struct.pack(
        ">I", zlib.crc32(b"IDAT" + raw))
    path = tmp_path / "filter.png"
    path.write_bytes(data[:33] + idat + data[-12:])  # IHDR, IDAT, IEND
    with pytest.raises(ValueError, match="filter 7"):
        png.read_png(str(path))


# ---------------------------------------------------------- the ViPC tree


def _write_both(tmp_path, **kw):
    """The port's tree and the script's, same arguments."""
    args = dict(train=2, test=1, views=3, gt_points=256, part_points=96)
    args.update(kw)
    port_dir, script_dir = tmp_path / "port", tmp_path / "script"
    synth_vipc.write_tree(str(port_dir), lists_dir=str(port_dir / "lists"),
                          **args)
    cmd = [sys.executable, str(ROOT / "scripts" / "make_synth_vipc.py"),
           "--out", str(script_dir), "--lists_dir",
           str(script_dir / "lists")]
    for k, v in args.items():
        cmd += [f"--{k}", str(v)]
    subprocess.run(cmd, check=True, capture_output=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=300)
    return port_dir, script_dir


def test_synth_tree_is_the_scripts_tree(tmp_path):
    """Every file of `tools.synth_vipc` (default views: 224 x 224 RGB)
    equals `scripts/make_synth_vipc.py`'s: clouds and metadata byte for
    byte, views pixel for pixel, the lists line for line."""
    port_dir, script_dir = _write_both(tmp_path, list_views=2)
    files = sorted(p.relative_to(script_dir) for p in script_dir.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(port_dir)
                           for p in port_dir.rglob("*") if p.is_file())
    assert sum(f.suffix == ".png" for f in files) == 9
    for f in files:
        a, b = port_dir / f, script_dir / f
        if f.suffix == ".png":
            with Image.open(b) as im:
                np.testing.assert_array_equal(png.read_png(str(a))[1],
                                              np.asarray(im))
        else:
            assert a.read_bytes() == b.read_bytes(), f


def test_synth_tree_writes_rgba_renderings(tmp_path):
    """`view_size` / `view_mode`: RGBA views at the renderings' size, the
    background transparent; the loader resizes them to 224."""
    out = tmp_path / "t"
    synth_vipc.write_tree(str(out), train=1, test=1, views=2,
                          gt_points=128, part_points=64,
                          lists_dir=str(out), view_size=137,
                          view_mode="RGBA")
    view = next(out.rglob("00.png"))
    mode, img = png.read_png(str(view))
    assert mode == "RGBA" and img.shape == (137, 137, 4)
    assert set(np.unique(img[..., 3])) == {0, 255}
    assert png.load_view(str(view)).shape == (224, 224, 3)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A port-written tree with ViPC's 24 views a model, RGBA 137 x 137
    (the resize runs), and a malformed line (the view glued to the model
    name) in the train list."""
    out = tmp_path_factory.mktemp("vipc")
    synth_vipc.write_tree(str(out), train=3, test=2, views=vipc.VIEWS,
                          gt_points=256, part_points=100, lists_dir=str(out),
                          list_views=2, view_size=137, view_mode="RGBA")
    with open(out / "train_list2.txt", "a") as f:
        f.write(f"{synth_vipc.SYNSET};x;synth_train_000201\n")
    return out


def _pair(tree, split, **kw):
    args = (str(tree / f"{split}_list2.txt"), str(tree), split)
    return vipc.ViPCDataLoader(*args, **kw), jvipc.ViPCDataLoader(*args,
                                                                  **kw)


def _same_item(a, b):
    assert set(a) == set(b) == {"views", "pc", "pc_part"}
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("preload", [True, False],
                         ids=["preload", "no_preload"])
@pytest.mark.parametrize("view_align", [False, True],
                         ids=["random_view", "view_align"])
def test_items_match_ldt_tpu(tree, preload, view_align):
    """Every item of the train split (the malformed line included; with
    `view_align` the lines whose own view exists) twice over: the same
    random views for the same `random` state."""
    port, jax_ds = _pair(tree, "train", preload=preload,
                         view_align=view_align, category="plane",
                         pc_input_num=300)
    assert len(port) == len(jax_ds) == 4
    if preload:
        assert port.view_ids == jax_ds.view_ids
    for rep in range(2):
        for idx in range(len(port)):
            random.seed(100 * rep + idx)
            a = port[idx]
            random.seed(100 * rep + idx)
            b = jax_ds[idx]
            _same_item(a, b)
            assert a["pc_part"].shape == (300, 3)  # pad-repeated from 100
            assert a["views"].shape == (224, 224, 3)


def test_preload_keys_views_by_id_and_skips_missing_ones(tmp_path):
    """A model whose view 1 files are gone: preloaded by view id (0, 2),
    its aligned line of view 2 fetched as the JAX loader fetches it."""
    synth_vipc.write_tree(str(tmp_path), train=2, test=1, views=3,
                          gt_points=128, part_points=50,
                          lists_dir=str(tmp_path))
    model = tmp_path / "ShapeNetViPC-View" / synth_vipc.SYNSET / \
        "synth_train_0001"
    (model / "rendering" / "01.png").unlink()
    (tmp_path / "ShapeNetViPC-GT" / synth_vipc.SYNSET / "synth_train_0001" /
     "01.dat").unlink()
    with open(tmp_path / "train_list2.txt", "a") as f:
        f.write(f"{synth_vipc.SYNSET};synth_train_0001;02\n")
    for align in (False, True):
        port, jax_ds = _pair(tmp_path, "train", preload=True,
                             view_align=align, category="plane")
        assert port.view_ids["synth_train_0001"] == [0, 2]
        assert port.view_ids == jax_ds.view_ids
        for idx in range(len(port)):
            random.seed(idx)
            a = port[idx]
            random.seed(idx)
            _same_item(a, jax_ds[idx])


def test_malformed_line_is_split_as_the_reference():
    key = "02691156;x;synth_train_000201\n"
    assert vipc.ViPCDataLoader._split(key) == \
        jvipc.ViPCDataLoader._split(key) == \
        ("02691156", "synth_train_0002", "01")


def test_loaders_give_the_same_batches(tree):
    """`get_data_loaders` of both packages, no worker threads: the train
    loader's shuffled batches and the test loader's, over two epochs."""
    d = dict(train_cate="plane", test_cate="all", train_preload=False,
             test_preload=True, data_dir=str(tree),
             train_list=str(tree / "train_list2.txt"),
             test_list=str(tree / "test_list2.txt"), batch_size=3,
             test_batch_size=2, num_workers=0, seed=5)
    port = vipc.get_data_loaders(dict2namespace(d))
    jax_l = jvipc.get_data_loaders(jax_ns(d))
    for _ in range(2):
        for name in ("train_loader", "test_loader"):
            random.seed(7)
            got = list(port[name])
            random.seed(7)
            want = list(jax_l[name])
            assert len(got) == len(want) == {"train_loader": 2,
                                             "test_loader": 2}[name]
            for a, b in zip(got, want):
                _same_item(a, b)


def test_dat_files_are_pickled_arrays(tree):
    path = next(tree.rglob("*.dat"))
    with open(path, "rb") as f:
        raw = pickle.load(f)
    np.testing.assert_array_equal(vipc._load_dat(str(path)), raw)
    assert vipc.CAT_MAP == jvipc.CAT_MAP
