"""HOG-lite in float64: a frozen copy of the arithmetic of the port's
``models/hog.py`` (itself the JAX package's), written out again.

Per pixel: central-difference gradients (one-sided at the border), the
magnitude sqrt(gx² + gy² + 1e-12), the unsigned orientation in [0, pi)
binned into ``bins`` with linear interpolation between the two nearest
bins (wrapping), the two votes summed over ``cell``×``cell`` cells; then
per cell L2 normalisation (+1e-6 under the root), a clamp at 0.2, and L2
normalisation again. The image is cropped to whole cells.
"""

from __future__ import annotations

import math

import torch


def hog(image: torch.Tensor, cell: int = 8, bins: int = 9,
        dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(H, W) image → (H // cell, W // cell, bins) features in ``dtype``."""
    img = image.to(dtype)
    hc, wc = img.shape[0] // cell, img.shape[1] // cell
    img = img[: hc * cell, : wc * cell]
    gy = torch.empty_like(img)
    gx = torch.empty_like(img)
    gy[1:-1] = (img[2:] - img[:-2]) / 2
    gy[0] = img[1] - img[0]
    gy[-1] = img[-1] - img[-2]
    gx[:, 1:-1] = (img[:, 2:] - img[:, :-2]) / 2
    gx[:, 0] = img[:, 1] - img[:, 0]
    gx[:, -1] = img[:, -1] - img[:, -2]
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    pos = torch.remainder(torch.atan2(gy, gx), math.pi) / math.pi * bins
    lo = torch.floor(pos)
    frac = pos - lo
    b0 = lo.long() % bins
    b1 = (b0 + 1) % bins
    cy = torch.arange(hc * cell, device=img.device) // cell
    cx = torch.arange(wc * cell, device=img.device) // cell
    base = (cy[:, None] * wc + cx[None, :]) * bins
    hist = torch.zeros(hc * wc * bins, dtype=dtype, device=img.device)
    hist.index_add_(0, (base + b0).reshape(-1), (mag * (1 - frac)).reshape(-1))
    hist.index_add_(0, (base + b1).reshape(-1), (mag * frac).reshape(-1))
    h = hist.reshape(hc, wc, bins)
    h = torch.clamp(h / torch.sqrt((h * h).sum(-1, keepdim=True) + 1e-6), 0.0, 0.2)
    return h / torch.sqrt((h * h).sum(-1, keepdim=True) + 1e-6)
