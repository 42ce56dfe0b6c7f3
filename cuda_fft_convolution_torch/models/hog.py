"""HOG-style feature extraction: the DPM detector path's front end.

The port of ``cuda_fft_convolution_tpu/models/hog.py`` in plain torch (no
kernel): image → oriented-gradient cell histograms, which a filter bank then
scores through the FFT engines. "HOG-lite", as in the JAX package: unsigned
gradient orientations binned with linear interpolation, summed over cells,
L2-hys normalized per cell, without the block-overlap bookkeeping of the
full descriptor.
"""

from __future__ import annotations

import math

import torch

from cuda_fft_convolution_torch.utils.device import as_tensor


def hog_features(image, cell: int = 8, bins: int = 9, *, device=None) -> torch.Tensor:
    """(H, W) grayscale or (H, W, C) image (channels averaged), a numpy
    array or a tensor → (H//cell, W//cell, bins) float32 features. A numpy
    image goes to the card when ``device`` is None (``api.py``'s rule:
    ``device='cpu'`` runs on the CPU, a tensor stays on its device).

    The JAX function builds a one-hot (H, W, bins) histogram per pixel and
    sums it over cells; here each pixel's two interpolated votes are added
    into its cell with ``scatter_add``, which gives the same sums without
    the per-pixel tensor (2 GB at a 4096² image and 31 bins)."""
    img = as_tensor(image, device).to(torch.float32)
    if img.ndim == 3:
        img = img.mean(dim=-1)
    h, w = img.shape
    hc, wc = h // cell, w // cell
    img = img[: hc * cell, : wc * cell]

    gy, gx = torch.gradient(img, dim=(0, 1))
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    # unsigned orientation in [0, pi)
    ang = torch.remainder(torch.atan2(gy, gx), math.pi)
    pos = ang / math.pi * bins  # [0, bins)
    floor = torch.floor(pos)
    b0 = floor.to(torch.int64) % bins
    b1 = (b0 + 1) % bins
    w1 = pos - floor
    w0 = 1.0 - w1

    # each pixel votes into (its cell, b0) and (its cell, b1)
    rows = torch.arange(hc * cell, device=img.device) // cell
    cols = torch.arange(wc * cell, device=img.device) // cell
    slot = (rows[:, None] * wc + cols[None, :]) * bins
    hist = torch.zeros(hc * wc * bins, dtype=torch.float32, device=img.device)
    hist.scatter_add_(0, (slot + b0).reshape(-1), (mag * w0).reshape(-1))
    hist.scatter_add_(0, (slot + b1).reshape(-1), (mag * w1).reshape(-1))
    cells = hist.reshape(hc, wc, bins)

    # L2-hys normalization per cell
    norm = torch.sqrt(torch.sum(cells**2, dim=-1, keepdim=True) + 1e-6)
    cells = torch.clamp(cells / norm, 0.0, 0.2)
    norm2 = torch.sqrt(torch.sum(cells**2, dim=-1, keepdim=True) + 1e-6)
    return cells / norm2
