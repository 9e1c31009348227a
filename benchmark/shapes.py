"""Synthetic clouds at ShapeNet's scale (a copy of the repository's
`synthetic_shapes`): surface points of random ellipsoids and boxes
(alternating), randomly rotated, centred and scaled to unit max radius."""

from __future__ import annotations

import numpy as np


def synthetic_shapes(count: int, points: int, rng) -> np.ndarray:
    """[count, points, 3] float32 clouds from a numpy Generator."""
    out = np.empty((count, points, 3), np.float64)
    for k in range(count):
        axes = rng.uniform(0.2, 1.0, 3)
        if k % 2 == 0:  # ellipsoid: unit directions scaled by the semi-axes
            v = rng.standard_normal((points, 3))
            pts = v / np.linalg.norm(v, axis=1, keepdims=True) * axes
        else:  # box: a face by its area, then a point on it
            area = np.array([axes[1] * axes[2], axes[0] * axes[2],
                             axes[0] * axes[1]])
            face = rng.choice(3, points, p=area / area.sum())
            pts = rng.uniform(-1.0, 1.0, (points, 3)) * axes
            pts[np.arange(points), face] = rng.choice([-1.0, 1.0],
                                                      points) * axes[face]
        q, r = np.linalg.qr(rng.standard_normal((3, 3)))
        pts = pts @ (q * np.sign(np.diag(r)))
        pts -= pts.mean(axis=0)
        out[k] = pts / np.linalg.norm(pts, axis=1).max()
    return out.astype(np.float32)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed, stream])
