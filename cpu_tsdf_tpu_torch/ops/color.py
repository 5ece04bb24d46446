"""Color fusion transforms: RGB / RGBNormalized / LAB.

Port of ``cpu_tsdf_tpu.ops.color`` (cpu_tsdf/src/lib/octree.cpp:328-581).
Every function is elementwise over tensors of any shape; `rgb` inputs are
raw 0..255 values as float32.
"""

from __future__ import annotations

import torch

from ..config import COLOR_MODE_LAB, COLOR_MODE_RGB, COLOR_MODE_RGB_NORMALIZED


def rgb_to_lab(r, g, b):
    """sRGB (0..255) -> CIELAB, replicating octree.cpp:436-481 (including its
    nonstandard 0.0405 linearization threshold)."""
    def linearize(c):
        c = c / 255.0
        return torch.where(c > 0.0405, ((c + 0.055) / 1.055) ** 2.4, c / 12.92) * 100.0

    rf, gf, bf = linearize(r), linearize(g), linearize(b)
    X = (rf * 0.4124 + gf * 0.3576 + bf * 0.1805) / 95.047
    Y = (rf * 0.2126 + gf * 0.7152 + bf * 0.0722) / 100.0
    Z = (rf * 0.0193 + gf * 0.1192 + bf * 0.9505) / 108.883

    def f(t):
        cbrt = torch.sign(t) * torch.abs(t) ** (1.0 / 3.0)
        return torch.where(t > 0.008856, cbrt, 7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(X), f(Y), f(Z)
    L = 116.0 * fy - 16.0
    A = 500.0 * (fx - fy)
    B = 200.0 * (fy - fz)
    return L, A, B


def lab_to_rgb(L, A, B):
    """CIELAB -> sRGB (0..255 floats, truncated like the reference's uint8
    cast, clamped to 0..255; octree.cpp:483-528)."""
    Y = (L + 16.0) / 116.0
    X = A / 500.0 + Y
    Z = Y - B / 200.0

    def finv(t):
        t3 = t ** 3
        return torch.where(t3 > 0.008856, t3, (t - 16.0 / 116.0) / 7.787)

    X = finv(X) * 95.047 / 100.0
    Y = finv(Y) * 100.0 / 100.0
    Z = finv(Z) * 108.883 / 100.0
    rf = X * 3.2406 + Y * -1.5372 + Z * -0.4986
    gf = X * -0.9689 + Y * 1.8758 + Z * 0.0415
    bf = X * 0.0557 + Y * -0.2040 + Z * 1.0570

    def delin(c):
        return torch.where(c > 0.0031308, 1.055 * torch.abs(c) ** (1.0 / 2.4) - 0.055, c * 12.92)

    def to8(c):
        return torch.trunc(torch.clamp(delin(c) * 255.0, 0.0, 255.0))

    return to8(rf), to8(gf), to8(bf)


def update_color(mode: str, color_old, w_old, r, g, b, w_new):
    """One fused color observation. Shapes broadcast; returns updated channels.

    w_old is the PRE-update (already capped) weight, as in
    RGBNode::addObservation (octree.cpp:328-337). wsum == 0 keeps the old
    color (the raw 0/0 would write NaN)."""
    wsum = w_old + w_new
    seen = (wsum > 0)[..., None]
    den = torch.where(wsum > 0, wsum, torch.ones_like(wsum))[..., None]
    if mode == COLOR_MODE_RGB:
        # uint8 truncation after every update (octree.cpp:333-335).
        new = torch.trunc((w_old[..., None] * color_old
                           + w_new[..., None] * torch.stack([r, g, b], -1)) / den)
        return torch.where(seen, new, color_old)
    if mode == COLOR_MODE_RGB_NORMALIZED:
        # Chromaticity + intensity averaging (octree.cpp:379-393).
        i = torch.sqrt(r * r + g * g + b * b)
        obs = torch.stack([r / i, g / i, b / i, i], -1)
        new = (w_old[..., None] * color_old + w_new[..., None] * obs) / den
        return torch.where(seen, new, color_old)
    if mode == COLOR_MODE_LAB:
        # Average in CIELAB (octree.cpp:530-543).
        L, A, B = rgb_to_lab(r, g, b)
        obs = torch.stack([L, A, B], -1)
        new = (w_old[..., None] * color_old + w_new[..., None] * obs) / den
        return torch.where(seen, new, color_old)
    raise ValueError(f"unknown color mode {mode!r}")


def color_to_rgb(mode: str, color):
    """Recover displayable 0..255 RGB from stored channels (getRGB variants)."""
    if mode == COLOR_MODE_RGB:
        return color[..., 0], color[..., 1], color[..., 2]
    if mode == COLOR_MODE_RGB_NORMALIZED:
        # octree.cpp:395-402: r = r_n * i (uint8 cast).
        i = color[..., 3]
        return (torch.trunc(color[..., 0] * i), torch.trunc(color[..., 1] * i),
                torch.trunc(color[..., 2] * i))
    if mode == COLOR_MODE_LAB:
        return lab_to_rgb(color[..., 0], color[..., 1], color[..., 2])
    raise ValueError(f"unknown color mode {mode!r}")
