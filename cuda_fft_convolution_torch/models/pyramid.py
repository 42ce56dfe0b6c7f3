"""Multi-scale (image-pyramid) filter-bank detection.

The port of ``cuda_fft_convolution_tpu/models/pyramid.py``: the
deployment the reference was written for, a DPM/HOG detector scoring the
same filter bank against every level of an image pyramid with one data FFT
per level. ``build_pyramid`` keeps each level and its direct
``SpectralData``; ``detect_pyramid`` runs ``conv_spectral`` per level (the
MAC kernel on the card, ``ops/spectral_mac.py``); ``detect_pyramid_peaks``
reduces each level to per-kernel peaks with ``detect_peaks`` and joins
the levels on the host, with the JAX package's arithmetic.

Levels are downscaled with ``resize_bilinear``, which is
``jax.image.resize(..., method='bilinear')``: an antialiased (triangle
kernel widened by the scale) bilinear resize with half-pixel centres.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuda_fft_convolution_torch import api as _api
from cuda_fft_convolution_torch.models.detect import detect_peaks
from cuda_fft_convolution_torch.utils.device import as_tensor
from cuda_fft_convolution_torch.utils.errors import validate


def resize_bilinear(image: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H, W, F) → (h, w, F) float32, as ``jax.image.resize(image, (h, w,
    F), method='bilinear')``, whose ``antialias=True`` default widens the
    kernel when it downscales (without it the two differ by O(1))."""
    x = image.to(torch.float32).permute(2, 0, 1)[None]
    out = torch.nn.functional.interpolate(
        x, size=(h, w), mode="bilinear", antialias=True, align_corners=False
    )
    return out[0].permute(1, 2, 0).contiguous()


@dataclasses.dataclass(frozen=True)
class Pyramid:
    """Image pyramid + per-level precomputed spectra."""

    levels: tuple  # (Hi, Wi, F) float32 tensors, level 0 = full resolution
    spectra: tuple  # SpectralData per level (direct, float32)
    scale: float


def build_pyramid(
    image,  # (H, W, F)
    max_kernel_h: int,
    max_kernel_w: int,
    *,
    num_levels: int = 5,
    scale: float = 2 ** -0.5,
    policy=None,
    device=None,
) -> Pyramid:
    """Downscale ``image`` by ``scale`` per level (``resize_bilinear``)
    until ``num_levels`` levels exist, a level would be smaller than the
    kernel, or a level stops shrinking; one ``fft_data`` per level (≈ one
    cudaFFTData per level). ``device``: where an array input goes (the card
    when None, ``utils/device.py``); a tensor stays on its device."""
    image = as_tensor(image, device)
    validate(image.ndim == 3, f"image must be (H, W, F); got {tuple(image.shape)}")
    cur = image.to(torch.float32)
    levels, spectra = [], []
    for _ in range(num_levels):
        lh, lw = int(cur.shape[0]), int(cur.shape[1])
        if lh < max_kernel_h or lw < max_kernel_w:
            break
        levels.append(cur)
        spectra.append(_api.fft_data(cur, max_kernel_h, max_kernel_w, policy=policy))
        nh, nw = max(int(round(lh * scale)), 1), max(int(round(lw * scale)), 1)
        if (nh, nw) == (lh, lw):
            break
        cur = resize_bilinear(cur, nh, nw)
    validate(len(levels) > 0, "image smaller than the kernel at level 0")
    return Pyramid(levels=tuple(levels), spectra=tuple(spectra), scale=scale)


def detect_pyramid(
    pyramid: Pyramid,
    kernels,
    *,
    mode: str = "same",
    correlation: bool = True,
) -> list:
    """Score the bank against every level → one entry of per-kernel maps
    per level. Each level's data FFT is reused across the whole bank; the
    bank's spectra are made per level (levels have different FFT sizes)."""
    return [
        _api.conv_spectral(sd, kernels, mode=mode, correlation=correlation)
        for sd in pyramid.spectra
    ]


@dataclasses.dataclass(frozen=True)
class PyramidPeaks:
    """``detect_pyramid_peaks`` result: per-level top-1 peaks and their
    join across levels. ``values`` (L, N) and ``positions`` (L, N, 2) are
    each level's per-kernel peak and its (row, col) in that level's
    ``mode`` frame (the argmax of the ``detect_pyramid`` map); ``best_*``
    join the levels per kernel, ``best_position`` in level-0 coordinates
    (scaled by the per-axis level size ratio). All on the levels' device."""

    values: torch.Tensor  # (L, N) float32
    positions: torch.Tensor  # (L, N, 2) int32, per-level frame
    best_level: torch.Tensor  # (N,) int32
    best_value: torch.Tensor  # (N,) float32
    best_position: torch.Tensor  # (N, 2) int32, base-image coordinates


def detect_pyramid_peaks(
    pyramid: Pyramid,
    kernels,
    *,
    mode: str = "same",
    correlation: bool = True,
) -> PyramidPeaks:
    """Multi-scale detection that reads no maps back: ``detect_peaks`` on
    each level's spectra reduces the bank's maps to (max, argmax) on the
    device, and only (L, N) values and (L, N, 2) positions reach the host
    for the join. The join is the JAX package's: the first level of the
    largest value, and Python's ``round(y · h0 / lh)`` per axis.

    ``kernels`` is a stacked uniform bank (N, Kh, Kw, F) or, for
    mode='same' only (as ``detect_peaks``), a ragged cell list; 'fftmap'
    is rejected."""
    per_v, per_p = [], []
    for sd in pyramid.spectra:
        v, p = detect_peaks(sd, kernels, mode=mode, correlation=correlation)
        per_v.append(v)
        per_p.append(p)
    values = torch.stack(per_v)  # (L, N)
    positions = torch.stack(per_p)  # (L, N, 2)
    v = values.cpu().numpy()
    p = positions.cpu().numpy()
    best_level = v.argmax(axis=0).astype(np.int32)  # (N,)
    best_value = v.max(axis=0)
    h0, w0 = (int(s) for s in pyramid.levels[0].shape[:2])
    best_pos = np.empty((v.shape[1], 2), np.int32)
    for n in range(v.shape[1]):
        lvl = int(best_level[n])
        lh, lw = (int(s) for s in pyramid.levels[lvl].shape[:2])
        y, x = int(p[lvl, n, 0]), int(p[lvl, n, 1])
        best_pos[n] = (round(y * h0 / lh), round(x * w0 / lw))
    dev = values.device
    return PyramidPeaks(
        values=values,
        positions=positions,
        best_level=torch.as_tensor(best_level, device=dev),
        best_value=torch.as_tensor(best_value, device=dev),
        best_position=torch.as_tensor(best_pos, device=dev),
    )


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def top_detections(
    level_scores: list, k: int = 5
) -> list[tuple[int, int, int, int, float]]:
    """The top-k (level, kernel, row, col, score) peaks across the levels
    of a ``detect_pyramid`` result, on the host.

    Takes tensors or arrays of every shape ``detect_pyramid`` returns:
    stacked (N, H, W), batched (B, N, H, W) (searched across the batch;
    row/col are within the best image), and ragged per-kernel lists of
    (H, W) maps."""
    hits = []
    for lvl, scores in enumerate(level_scores):
        if isinstance(scores, (list, tuple)):
            per_kernel = [_host(s) for s in scores]
        else:
            arr = _host(scores)
            if arr.ndim == 3:  # (N, H, W)
                per_kernel = [arr[i] for i in range(arr.shape[0])]
            elif arr.ndim == 4:  # (B, N, H, W)
                per_kernel = [arr[:, i] for i in range(arr.shape[1])]
            else:
                raise ValueError(
                    f"level {lvl}: expected (N, H, W) or (B, N, H, W) "
                    f"scores, got shape {arr.shape}"
                )
        for kk, m in enumerate(per_kernel):
            flat_idx = int(np.argmax(m))
            best = float(m.reshape(-1)[flat_idx])
            coords = np.unravel_index(flat_idx, m.shape)
            r, c = int(coords[-2]), int(coords[-1])
            hits.append((lvl, kk, r, c, best))
    hits.sort(key=lambda t: -t[4])
    return hits[:k]

