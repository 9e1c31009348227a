"""PNG read and write, and PIL's resize, with `zlib` and numpy (the card's
machine has no PIL), for the ViPC views (`data.vipc`).

`read_png(path)` -> (mode, array) as `np.asarray(PIL.Image.open(path))`
gives them: 8-bit, non-interlaced images of colour type 0 ("L", [H, W]),
2 ("RGB", [H, W, 3]), 3 ("P", [H, W] palette indices), 4 ("LA", [H, W, 2])
or 6 ("RGBA", [H, W, 4]), each scanline's filter (None, Sub, Up, Average,
Paeth) undone; any other bit depth, colour type or interlace raises by
name. An ancillary chunk (tRNS, gAMA, ...) is skipped, as `np.asarray`
ignores it.

`resize(mode, array, (w, h))` is `Image.resize((w, h), Image.BILINEAR)`
bit for bit: PIL's separable triangle filter (support 1, scaled by the
ratio when it shrinks), its coefficients in 22-bit fixed point, the
horizontal pass first, rounded to uint8, then the vertical; "RGBA" and
"LA" premultiplied by alpha for the passes and divided back after (PIL
resizes them as "RGBa" / "La"); "P" by nearest neighbour (PIL's rule for
palette images).

`load_view(path)` is the ViPC loader's image read (the reference's
`Resize(224)` then `ToTensor`, channels-last): the short side resized to
224, float32 in [0, 1]; a one-channel image stacked to three, the first
three channels of the rest (an "LA" image keeps its two, as the JAX
package's PIL path does).

`write_png(path, array)` writes [H, W, 3] ("RGB") or [H, W, 4] ("RGBA")
uint8 images (filter None on every row).
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_MODES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2),
          6: ("RGBA", 4)}
_PRECISION_BITS = 32 - 8 - 2  # PIL's Resample.c, 8-bit images
VIEW_SIZE = 224  # the reference's Resize(224)


def _chunks(data: bytes):
    """(type, body) of each chunk, its CRC checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends without IEND")


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines of `raw` (a filter byte, then `stride` bytes each)
    with their filters undone: [height, stride] uint8."""
    out = np.zeros((height, stride), np.uint8)
    prev = bytearray(stride)
    for y in range(height):
        start = y * (stride + 1)
        kind = raw[start]
        line = bytearray(raw[start + 1:start + 1 + stride])
        if kind == 1:  # Sub: a running sum of each channel, mod 256
            sums = np.cumsum(np.frombuffer(line, np.uint8).reshape(-1, bpp),
                             axis=0, dtype=np.uint64) & 0xFF
            line = bytearray(sums.astype(np.uint8).tobytes())
        elif kind == 2:  # Up
            line = bytearray(((np.frombuffer(line, np.uint8).astype(np.uint16)
                               + np.frombuffer(prev, np.uint8)) & 0xFF)
                             .astype(np.uint8).tobytes())
        elif kind == 3:  # Average
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif kind == 4:  # Paeth
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                line[i] = (line[i] + pred) & 0xFF
        elif kind != 0:
            raise ValueError(f"PNG scanline filter {kind} is not one of the "
                             "five (0-4)")
        out[y] = np.frombuffer(line, np.uint8)
        prev = line
    return out


def read_png(path: str) -> Tuple[str, np.ndarray]:
    """(mode, uint8 array) of an 8-bit non-interlaced PNG (see the module
    docstring); anything else raises by name."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _MODES:
        raise ValueError(f"{path}: PNG colour type {colour} is not one of "
                         f"{sorted(_MODES)}")
    if depth != 8:
        raise ValueError(f"{path}: PNG bit depth {depth}: only 8-bit images "
                         "are read")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not read")
    mode, channels = _MODES[colour]
    raw = zlib.decompress(b"".join(idat))
    stride = width * channels
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: image data too short")
    pixels = _unfilter(raw, height, stride, channels)
    if channels == 1:
        return mode, pixels.reshape(height, width)
    return mode, pixels.reshape(height, width, channels)


def write_png(path: str, image: np.ndarray) -> None:
    """Write a [H, W, 3] (RGB) or [H, W, 4] (RGBA) uint8 image."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"write_png takes [H, W, 3] or [H, W, 4] uint8, got "
                         f"{image.shape}")
    h, w, c = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def _coefficients(in_size: int, out_size: int):
    """PIL's `precompute_coeffs` for the bilinear filter, then
    `normalize_coeffs_8bpc`: (xmin [out], fixed-point weights [out, ksize]
    int64, zero past each row's taps)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    bounds = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss))
             for x in range(xmax)]
        total = sum(w)  # in order, as the C loop adds them
        for x in range(xmax):
            k = w[x] / total if total != 0.0 else w[x]
            kk[xx, x] = int(k * (1 << _PRECISION_BITS) + (0.5 if k >= 0
                                                           else -0.5))
        bounds[xx] = xmin
    return bounds, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of PIL's 8-bit resample along `axis` of [H, W, C] uint8."""
    in_size = img.shape[axis]
    xmin, kk = _coefficients(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1]), in_size - 1)
    taps = np.take(img.astype(np.int64), idx, axis=axis)
    # taps: [..., out, ksize, ...]; weigh and sum over the ksize axis
    shape = [1] * taps.ndim
    shape[axis], shape[axis + 1] = kk.shape
    acc = (taps * kk.reshape(shape)).sum(axis=axis + 1)
    acc = (acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def _premultiply(img: np.ndarray) -> np.ndarray:
    """PIL's RGBA -> RGBa (LA -> La): colour * alpha / 255 with its
    MULDIV255 rounding."""
    out = img.astype(np.uint32)
    alpha = out[..., -1:]
    tmp = out[..., :-1] * alpha + 128
    out[..., :-1] = ((tmp >> 8) + tmp) >> 8
    return out.astype(np.uint8)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """PIL's RGBa -> RGBA (La -> LA): colour * 255 / alpha, truncated and
    clipped, where alpha is neither 0 nor 255."""
    out = img.astype(np.uint32)
    alpha = out[..., -1:]
    scaled = np.minimum(out[..., :-1] * 255 // np.maximum(alpha, 1), 255)
    keep = (alpha == 0) | (alpha == 255)
    out[..., :-1] = np.where(keep, out[..., :-1], scaled)
    return out.astype(np.uint8)


def _nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's nearest-neighbour resize: output pixel x takes input pixel
    floor((x + 0.5) * in / out)."""
    w, h = size
    ys = np.minimum(((np.arange(h) + 0.5) * (img.shape[0] / h)).astype(
        np.int64), img.shape[0] - 1)
    xs = np.minimum(((np.arange(w) + 0.5) * (img.shape[1] / w)).astype(
        np.int64), img.shape[1] - 1)
    return img[ys][:, xs]


def resize(mode: str, image: np.ndarray, size: Tuple[int, int]
           ) -> np.ndarray:
    """`Image.resize(size, Image.BILINEAR)` of a `read_png` image: size is
    (width, height)."""
    if mode not in ("L", "RGB", "P", "LA", "RGBA"):
        raise ValueError(f"resize: mode {mode!r} is not read")
    w, h = size
    if (image.shape[1], image.shape[0]) == (w, h):
        return image.copy()
    if mode == "P":
        return _nearest(image, size)
    img = image if image.ndim == 3 else image[..., None]
    if mode in ("LA", "RGBA"):
        img = _premultiply(img)
    if img.shape[1] != w:
        img = _resample_axis(img, w, axis=1)
    if img.shape[0] != h:
        img = _resample_axis(img, h, axis=0)
    if mode in ("LA", "RGBA"):
        img = _unpremultiply(img)
    return img if image.ndim == 3 else img[..., 0]


def load_view(path: str) -> np.ndarray:
    """A ViPC view: [H', W', 3] float32 in [0, 1], the short side resized to
    `VIEW_SIZE` (the JAX package's `_load_image`)."""
    mode, img = read_png(path)
    h, w = img.shape[:2]
    s = min(w, h)
    img = resize(mode, img, (max(1, round(w * VIEW_SIZE / s)),
                             max(1, round(h * VIEW_SIZE / s))))
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr[..., :3]
