"""Point-cloud rendering, counterpart of `ldt_tpu/tools/vis_utils.py` (the
same text, the same fallbacks).

`npy2xml` builds a Mitsuba path-tracer scene of a cloud (spheres coloured by
position); `render_3D` writes each cloud's scene as XML and renders it to
PNG with Mitsuba when a real one imports, else with a matplotlib 3-D
scatter of the same colours, else writes the XML only.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np

XML_HEAD = """<scene version="0.6.0">
    <integrator type="path">
        <integer name="maxDepth" value="-1"/>
    </integrator>
    <sensor type="perspective">
        <float name="farClip" value="100"/>
        <float name="nearClip" value="0.1"/>
        <transform name="toWorld">
            <lookat origin="3,3,3" target="0,0,0" up="0,0,1"/>
        </transform>
        <float name="fov" value="25"/>
        <sampler type="ldsampler">
            <integer name="sampleCount" value="256"/>
        </sampler>
        <film type="hdrfilm">
            <integer name="width" value="800"/>
            <integer name="height" value="800"/>
            <rfilter type="gaussian"/>
        </film>
    </sensor>
    <bsdf type="roughplastic" id="surfaceMaterial">
        <string name="distribution" value="ggx"/>
        <float name="alpha" value="0.05"/>
        <float name="intIOR" value="1.46"/>
        <rgb name="diffuseReflectance" value="1,1,1"/>
    </bsdf>
"""

XML_SPHERE = """    <shape type="sphere">
        <float name="radius" value="{radius}"/>
        <transform name="toWorld">
            <translate x="{x}" y="{y}" z="{z}"/>
        </transform>
        <bsdf type="diffuse">
            <rgb name="reflectance" value="{r},{g},{b}"/>
        </bsdf>
    </shape>
"""

XML_TAIL = """    <shape type="rectangle">
        <ref name="bsdf" id="surfaceMaterial"/>
        <transform name="toWorld">
            <scale x="10" y="10" z="1"/>
            <translate x="0" y="0" z="-0.5"/>
        </transform>
    </shape>
    <emitter type="constant">
        <rgb name="radiance" value="1.0,1.0,1.0"/>
    </emitter>
</scene>
"""


def colormap(pts: np.ndarray) -> np.ndarray:
    """Position-driven colours in [0, 1]: each axis min-max scaled."""
    mins, maxs = pts.min(0, keepdims=True), pts.max(0, keepdims=True)
    return (pts - mins) / np.maximum(maxs - mins, 1e-8)


def standardize(pts: np.ndarray) -> np.ndarray:
    """Centre, scale to the unit sphere and swap to z-up."""
    pts = pts - pts.mean(0, keepdims=True)
    pts = pts / np.max(np.linalg.norm(pts, axis=1))
    return pts[:, [2, 0, 1]]


def npy2xml(pts: np.ndarray, radius: float = 0.012) -> str:
    """Point cloud [N, 3] -> Mitsuba XML scene string."""
    pts = standardize(np.asarray(pts, np.float64))
    colors = colormap(pts)
    parts = [XML_HEAD]
    for p, c in zip(pts, colors):
        parts.append(XML_SPHERE.format(radius=radius, x=p[0], y=p[1], z=p[2],
                                       r=c[0], g=c[1], b=c[2]))
    parts.append(XML_TAIL)
    return "".join(parts)


def _render_matplotlib(pts: np.ndarray, out_png: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = standardize(np.asarray(pts, np.float64))
    colors = colormap(pts)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=colors, s=3)
    ax.set_axis_off()
    ax.set_box_aspect((1, 1, 1))
    fig.savefig(out_png, dpi=150, bbox_inches="tight")
    plt.close(fig)


def render_3D(path: str, sample: np.ndarray, name: str = "smp",
              max_renders: Optional[int] = 16) -> None:
    """Render the first `max_renders` clouds (all with None) of `sample`
    [B, N, 3] to `<path>/<name>_<i>.png`, each scene's XML written beside
    as `<name>_<i>.xml`: Mitsuba when it imports, else matplotlib, else the
    XML alone."""
    os.makedirs(path, exist_ok=True)
    sample = np.asarray(sample)
    n = len(sample) if max_renders is None else min(len(sample), max_renders)
    for i in range(n):
        xml = npy2xml(sample[i])
        xml_path = os.path.join(path, f"{name}_{i}.xml")
        with open(xml_path, "w") as f:
            f.write(xml)
        png_path = os.path.join(path, f"{name}_{i}.png")
        try:
            import mitsuba as mi

            if not hasattr(mi, "set_variant"):
                # a bare `mitsuba` stub in sys.modules is no Mitsuba; API
                # errors of a real install are not swallowed
                raise ImportError("bare mitsuba stub in sys.modules")
            mi.set_variant("scalar_rgb")
            img = mi.render(mi.load_file(xml_path))
            mi.util.write_bitmap(png_path, img)
        except ImportError:
            try:
                _render_matplotlib(sample[i], png_path)
            except ImportError:
                pass  # XML written; no renderer available
        except AttributeError as e:
            # a real Mitsuba whose API moved (e.g. util.write_bitmap):
            # matplotlib, and a warning that says so
            warnings.warn(f"mitsuba render failed ({e}); falling back to "
                          "matplotlib", RuntimeWarning)
            try:
                _render_matplotlib(sample[i], png_path)
            except ImportError:
                pass
