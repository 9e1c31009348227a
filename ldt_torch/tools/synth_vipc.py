"""A synthetic ShapeNet-ViPC tree in the reference's layout, counterpart of
`scripts/make_synth_vipc.py` (the same files, written without PIL:
`data.png.write_png`), so that the completion path runs on a machine
without the dataset or PIL:

    python -m ldt_torch.tools.synth_vipc --out data/ShapeNetViPC-Dataset \
        --train 24 --test 8 --views 8 [--view_size 137 --view_mode RGBA]

writes `<out>/ShapeNetViPC-{GT,Partial,View}/02691156/<model>/...` (GT
clouds, partial clouds as pickled float32 arrays, views as PNGs and
`rendering/rendering_metadata.txt`) and `<lists_dir>/{train,test}_list2.txt`.
The clouds are the airplane composites of `scripts/make_synth_data.py`
(one per model, deterministic in its seed), partials view-dependent
half-space cuts, views orthographic splats of the cloud. By default the
views are 224 x 224 RGB, the files `scripts/make_synth_vipc.py` writes;
`--view_size` and `--view_mode RGBA` write them as the real renderings
are (137 x 137 RGBA, the background transparent), so the loader's resize
runs.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ldt_torch.data.png import write_png

SYNSET = "02691156"  # plane
N_POINTS = 15000


def _unit_sphere(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _ellipsoid(rng, n, radii):
    return _unit_sphere(rng, n) * np.asarray(radii)


def make_airplane(seed: int) -> np.ndarray:
    """One 15000-point airplane-like composite (an ellipsoid fuselage,
    swept wings, tailplane and fin), deterministic in `seed`: the
    `scripts/make_synth_data.py` generator."""
    rng = np.random.RandomState(seed)
    fuse_len = rng.uniform(0.7, 1.1)
    fuse_r = rng.uniform(0.08, 0.16)
    span = rng.uniform(0.6, 1.0)
    chord = rng.uniform(0.15, 0.3)
    sweep = rng.uniform(0.0, 0.35)
    wing_x = rng.uniform(-0.15, 0.1)
    tail_span = span * rng.uniform(0.3, 0.45)
    fin_h = rng.uniform(0.15, 0.3)

    n_fuse, n_wing, n_tail, n_fin = 6000, 5500, 2000, 1500
    fuse = _ellipsoid(rng, n_fuse, (fuse_len, fuse_r, fuse_r))
    wing = _ellipsoid(rng, n_wing, (chord / 2, 0.02, span / 2))
    wing[:, 0] += wing_x - sweep * np.abs(wing[:, 2]) / (span / 2 + 1e-9)
    tail = _ellipsoid(rng, n_tail, (chord * 0.35, 0.015, tail_span / 2))
    tail[:, 0] -= fuse_len * 0.85
    fin = _ellipsoid(rng, n_fin, (chord * 0.3, fin_h / 2, 0.015))
    fin[:, 0] -= fuse_len * 0.85
    fin[:, 1] += fin_h / 2

    pts = np.concatenate([fuse, wing, tail, fin]).astype(np.float32)
    th = rng.uniform(0.0, 2.0 * np.pi)
    rot = np.array([[np.cos(th), 0.0, np.sin(th)], [0.0, 1.0, 0.0],
                    [-np.sin(th), 0.0, np.cos(th)]], np.float32)
    pts = pts @ rot.T
    pts += rng.normal(scale=0.006, size=pts.shape).astype(np.float32)
    assert pts.shape == (N_POINTS, 3)
    return pts[rng.permutation(N_POINTS)]


def render_view(pts: np.ndarray, az_deg: float, el_deg: float,
                size: int = 224, mode: str = "RGB") -> np.ndarray:
    """An orthographic point splat from (azimuth, elevation): [size, size,
    3] uint8 on white, or with `mode` "RGBA" [size, size, 4] on a
    transparent background."""
    az, el = np.radians(az_deg), np.radians(el_deg)
    ry = np.array([[np.cos(az), 0, np.sin(az)], [0, 1, 0],
                   [-np.sin(az), 0, np.cos(az)]], np.float32)
    rx = np.array([[1, 0, 0], [0, np.cos(el), -np.sin(el)],
                   [0, np.sin(el), np.cos(el)]], np.float32)
    p = pts @ ry.T @ rx.T
    xy = p[:, :2]
    depth = p[:, 2]
    uv = ((xy / (np.abs(xy).max() + 1e-6)) * (size // 2 - 2)
          + size // 2).astype(np.int32)
    img = np.full((size, size), 255, np.uint8)
    order = np.argsort(-depth)  # far first, near overwrites
    shade = (120 + 100 * (depth - depth.min())
             / (np.ptp(depth) + 1e-6)).astype(np.uint8)
    img[uv[order, 1], uv[order, 0]] = shade[order]
    rgb = np.stack([img] * 3, axis=-1)
    if mode == "RGB":
        return rgb
    if mode != "RGBA":
        raise ValueError(f"view mode {mode!r}: RGB or RGBA")
    alpha = np.zeros((size, size), np.uint8)
    alpha[uv[:, 1], uv[:, 0]] = 255
    return np.concatenate([rgb, alpha[..., None]], axis=-1)


def write_tree(out: str, train: int = 24, test: int = 8, views: int = 8,
               gt_points: int = 2048, part_points: int = 1024,
               lists_dir: str = "datasets/ViPC", list_views: int = 1,
               view_size: int = 224, view_mode: str = "RGB") -> dict:
    """Write the tree (see the module docstring); returns {split: list
    rows}."""
    if list_views > views:
        raise ValueError(f"list_views {list_views} > views {views}: the test "
                         "list would name views that were never rendered")
    os.makedirs(lists_dir, exist_ok=True)
    rows = {}
    for split, count, offset in (("train", train, 0),
                                 ("test", test, 500_000)):
        lines = []
        for i in range(count):
            mid = f"synth_{split}_{i:04d}"
            seed = offset + i
            cloud = make_airplane(seed)
            sub = cloud[np.random.RandomState(seed).choice(
                len(cloud), gt_points, replace=False)]
            gt_dir = os.path.join(out, "ShapeNetViPC-GT", SYNSET, mid)
            part_dir = os.path.join(out, "ShapeNetViPC-Partial", SYNSET, mid)
            view_dir = os.path.join(out, "ShapeNetViPC-View", SYNSET, mid,
                                    "rendering")
            for d in (gt_dir, part_dir, view_dir):
                os.makedirs(d, exist_ok=True)
            meta = np.zeros((views, 5), np.float32)
            meta[:, 0] = np.arange(views) * (360.0 / views)
            meta[:, 1] = 25.0
            np.savetxt(os.path.join(view_dir, "rendering_metadata.txt"), meta)
            for v in range(views):
                vv = str(v).rjust(2, "0")
                az = np.radians(meta[v, 0])
                # a half-space cut facing the camera: a crude self-occlusion
                normal = np.array([np.sin(az), 0.25, np.cos(az)], np.float32)
                vis = sub @ normal > np.percentile(sub @ normal, 40)
                part = sub[vis]
                rng = np.random.RandomState(seed * 100 + v)
                sel = rng.choice(len(part), part_points,
                                 replace=len(part) < part_points)
                with open(os.path.join(gt_dir, f"{vv}.dat"), "wb") as f:
                    pickle.dump(sub.astype(np.float32), f)
                with open(os.path.join(part_dir, f"{vv}.dat"), "wb") as f:
                    pickle.dump(part[sel].astype(np.float32), f)
                write_png(os.path.join(view_dir, f"{vv}.png"),
                          render_view(sub, meta[v, 0], meta[v, 1],
                                      view_size, view_mode))
            for v in range(list_views if split == "test" else 1):
                lines.append(f"{SYNSET};{mid};{str(v).rjust(2, '0')}\n")
        with open(os.path.join(lists_dir, f"{split}_list2.txt"), "w") as f:
            f.writelines(lines)
        rows[split] = lines
        print(f"{split}: {count} models x {views} views ({len(lines)} list "
              f"rows)")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="data/ShapeNetViPC-Dataset")
    ap.add_argument("--train", type=int, default=24)
    ap.add_argument("--test", type=int, default=8)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--gt_points", type=int, default=2048)
    ap.add_argument("--part_points", type=int, default=1024)
    ap.add_argument("--lists_dir", default="datasets/ViPC",
                    help="where train_list2.txt / test_list2.txt go (the "
                         "shipped configs' path)")
    ap.add_argument("--list_views", type=int, default=1,
                    help="views per model in the test list (train keeps "
                         "one a model)")
    ap.add_argument("--view_size", type=int, default=224,
                    help="the views' side in pixels (ShapeNet's renderings: "
                         "137)")
    ap.add_argument("--view_mode", default="RGB", choices=("RGB", "RGBA"),
                    help="RGBA: a transparent background, as the renderings")
    a = ap.parse_args(argv)
    write_tree(a.out, a.train, a.test, a.views, a.gt_points, a.part_points,
               a.lists_dir, a.list_views, a.view_size, a.view_mode)


if __name__ == "__main__":
    main()
