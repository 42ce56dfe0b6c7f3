"""Detection heads: per-kernel peak extraction over score maps.

The port of ``cuda_fft_convolution_tpu/models/detect.py``. The reference
library exists to serve DPM/HOG detectors and its own demo checks its work
by peak location (demoCudaConvolutionFFT.m:58-61). A detection consumer
reads a few (value, position) pairs out of maps that cost 1.68 GB of writes
per call at the 2048² × 100 × 64² headline: on the tiled engine at fused
geometries the peaks kernel (``ops/block_conv.py`` ``block_conv_peaks``)
reduces each block to a (max, argmax) pair on the card and writes no maps;
elsewhere the maps are reduced in torch. Top-1 results are exact either
way (every cell max is exact).

Inputs are those of the JAX heads: channel-last data ((H, W, F) or
(B, H, W, F), numpy or tensors), or precomputed ``SpectralData`` /
``TiledSpectralData``; a stacked bank (N, Kh, Kw, F), a list of
(Kh, Kw, F) kernels, or ``SpectralKernels``. ``device=`` is ``api.py``'s:
a numpy input goes to the card when ``device`` is None (and raises where
there is none), ``device='cpu'`` runs on the CPU, a tensor stays on its
device; a raw bank follows the data's spectra.

``store_dtype='bfloat16'`` runs the heads at the bf16 serving tier: the
data spectra of an array input are stored bf16, and a raw bank is
transformed at the tier of the spectra it meets (the peaks kernel then
reads bf16 spectra; values stay float32, positions int32).
``detect_local_peaks`` also takes ``out_dtype``, the dtype of the maps it
reduces.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_fft_convolution_torch import api as _api
from cuda_fft_convolution_torch.ops.tiled import (
    choose_block_plan,
    conv_blocks_peaks,
    conv_blocks_top_k,
    local_peaks_from_maps,
    peaks_from_maps,
    top_k_from_maps,
)
from cuda_fft_convolution_torch.types import (
    SpectralData,
    SpectralKernels,
    TiledSpectralData,
)
from cuda_fft_convolution_torch.utils.device import as_tensor
from cuda_fft_convolution_torch.utils.errors import validate

_RAGGED_MODE_MSG = (
    "ragged cell arrays serve mode='same' detection only (the "
    "'valid'/'full' windows differ per kernel size, so their maps "
    "cannot share one reduction frame)"
)


def _check_mode(mode: str, head: str, what: str) -> None:
    validate(
        mode in ("same", "valid", "full"),
        f"{head} modes: 'same', 'valid', 'full' (fftmap's circular frame "
        f"has no meaningful {what})",
    )


def _positions(reduce, maps: torch.Tensor, *args):
    """Run a maps reduction on (N, H, W) or (B, N, H, W) maps → (values,
    (row, col) positions stacked on the last axis)."""
    batched = maps.ndim == 4
    vals, ys, xs = reduce(maps if batched else maps[None], *args)
    pos = torch.stack([ys, xs], dim=-1)
    return (vals, pos) if batched else (vals[0], pos[0])


def _kernel_hw(kernels) -> tuple[int, int]:
    if isinstance(kernels, SpectralKernels):
        hs, ws = set(kernels.kernel_hs), set(kernels.kernel_ws)
        validate(
            len(hs) == 1 and len(ws) == 1,
            "detect_peaks takes a uniform bank (bucket ragged cells first)",
        )
        return next(iter(hs)), next(iter(ws))
    if isinstance(kernels, (list, tuple)):
        shapes = {tuple(np.shape(k)) for k in kernels}
        validate(
            len(shapes) == 1,
            "detect_peaks takes a uniform bank (bucket ragged cells first)",
        )
        kh, kw, _ = next(iter(shapes))
        return int(kh), int(kw)
    shape = np.shape(kernels)
    validate(
        len(shape) == 4,
        "detect_peaks takes a stacked uniform bank (N, Kh, Kw, F)",
    )
    return int(shape[1]), int(shape[2])


def _ragged_sizes(kernels) -> bool:
    """True when ``kernels`` is a mixed-size cell array (the reference's
    cell-array scenario, demoCudaConvolutionFFT.m:41-43)."""
    if isinstance(kernels, SpectralKernels):
        return (
            len(set(kernels.kernel_hs)) > 1
            or len(set(kernels.kernel_ws)) > 1
        )
    if isinstance(kernels, (list, tuple)):
        return len({tuple(np.shape(k)) for k in kernels}) > 1
    return False


def _ragged_same_maps(
    data, kernels, *, correlation, algorithm, same_offset, store_dtype,
    device, out_dtype=None,
) -> torch.Tensor:
    """Stacked 'same' score maps for a mixed-size cell array: every 'same'
    map is data-sized, so the per-cell maps stack into one (…, N, H, W)
    tensor and the reduction runs once across the cell array. Raw arrays
    go through ``fft_conv``, which buckets a cell array that spans pow-2
    size envelopes (each bucket at its own FFT or block size)."""
    if isinstance(data, (SpectralData, TiledSpectralData)):
        # precomputed banks carry their flip already (fft_kernels
        # correlation=...), matching the uniform heads' contract
        corr = correlation and not isinstance(kernels, SpectralKernels)
        maps = _api.conv_spectral(
            data, kernels, mode="same", correlation=corr, out_dtype=out_dtype,
        )
    else:
        validate(
            not isinstance(kernels, SpectralKernels),
            "ragged SpectralKernels need the precomputed spectra they "
            "were built against (pass the SpectralData, not raw arrays)",
        )
        maps = _api.fft_conv(
            data, kernels=kernels, mode="same", correlation=correlation,
            algorithm=algorithm, same_offset=same_offset,
            store_dtype=store_dtype, out_dtype=out_dtype, device=device,
        )
    return torch.stack(list(maps), dim=-3)


def _tiled_head_operands(
    sd: TiledSpectralData, kernels, kh: int, kw: int, correlation: bool,
):
    """Shared tiled-engine setup for the detection heads: validated bank
    spectra, batched data planes, and the output window frame."""
    if isinstance(kernels, SpectralKernels):
        sk = kernels
        validate(
            not sk.flat and (sk.fft_h, sk.fft_w) == (sd.block_h, sd.block_w),
            "SpectralKernels geometry/layout does not match the tiled "
            "spectra (planar at the block FFT size required)",
        )
    else:
        # A raw bank takes the tier of the spectra it meets (the JAX head
        # takes the head's store_dtype, the same tier on every array input).
        sk = _api.fft_kernels(
            kernels, spectral=sd, correlation=correlation,
            store_dtype=_api._store_dtype_of(sd),
        )
    _api._check_tier(sk, sd)
    validate(
        kh <= sd.max_kh and kw <= sd.max_kw,
        f"kernel ({kh},{kw}) exceeds the tiled spectra's planned envelope "
        f"({sd.max_kh},{sd.max_kw})",
    )
    d_re = sd.re if sd.batched else sd.re[None]
    d_im = sd.im if sd.batched else sd.im[None]
    # The engine synthesizes the baked window (origin shift already in the
    # block tiling): peaks come back in that window's frame directly. With
    # no baked window the frame is the KERNEL's 'full' extent — the planned
    # envelope may be larger, and those extra rows/cols are zeros that must
    # not win the argmax.
    if sd.win_h is not None:
        out_h, out_w = sd.out_h, sd.out_w
    else:
        out_h, out_w = sd.data_h + kh - 1, sd.data_w + kw - 1
    return d_re, d_im, sk, out_h, out_w


def _tiled_head(sd: TiledSpectralData, kernels, kh, kw, correlation, head, *args):
    """Run a tiled head (``conv_blocks_peaks`` / ``conv_blocks_top_k``)
    → (values, positions), unbatched when the spectra are."""
    d_re, d_im, sk, out_h, out_w = _tiled_head_operands(
        sd, kernels, kh, kw, correlation
    )
    vals, ys, xs = head(
        d_re, d_im, sk.re, sk.im, sd.block_h, sd.block_w,
        sd.max_kh, sd.max_kw, out_h, out_w, *args,
    )
    pos = torch.stack([ys, xs], dim=-1).to(torch.int32)
    return (vals, pos) if sd.batched else (vals[0], pos[0])


def _peaks_tiled(sd, kernels, kh, kw, correlation):
    return _tiled_head(sd, kernels, kh, kw, correlation, conv_blocks_peaks)


def _top_k_tiled(sd, kernels, kh, kw, correlation, k):
    return _tiled_head(sd, kernels, kh, kw, correlation, conv_blocks_top_k, k)


def _route(data, kernels, *, mode, correlation, algorithm, same_offset,
           store_dtype, device, reduce, tiled, args=()):
    """The routing the top-1 and top-k heads share: ragged cells → stacked
    'same' maps; ``SpectralData`` → ``conv_spectral`` maps;
    ``TiledSpectralData`` → the tiled head; arrays → the tiled head where
    the planner tiles (or ``algorithm='tiled'``), else the direct engine's
    maps. Maps are reduced with ``reduce``."""
    if _ragged_sizes(kernels):
        validate(mode == "same", _RAGGED_MODE_MSG)
        maps = _ragged_same_maps(
            data, kernels, correlation=correlation, algorithm=algorithm,
            same_offset=same_offset, store_dtype=store_dtype, device=device,
        )
        return _positions(reduce, maps, *args)
    if isinstance(data, SpectralData):
        _kernel_hw(kernels)  # reject ragged banks up front
        maps = _api.conv_spectral(
            data, kernels, mode=mode, correlation=correlation
        )
        return _positions(reduce, maps, *args)
    if isinstance(data, TiledSpectralData):
        kh, kw = _kernel_hw(kernels)
        validate(
            data.win_h is not None or mode == "full",
            "TiledSpectralData without a baked window serves mode='full' "
            "detections; bake trim_mode='same'/'valid' at fft_data_tiled "
            "for windowed detections",
        )
        return tiled(data, kernels, kh, kw, correlation, *args)

    arr = as_tensor(data, device)
    batched = arr.ndim == 4
    h, w = (arr.shape[1], arr.shape[2]) if batched else (arr.shape[0], arr.shape[1])
    kh, kw = _kernel_hw(kernels)
    if algorithm != "direct":
        plan = choose_block_plan(
            h, w, kh, kw, feature_dim=int(arr.shape[-1]),
            store_dtype=store_dtype, head="peaks", device=arr.device,
        )
        if algorithm == "tiled" or plan is not None:
            window = dict(
                trim_mode=mode, trim_kernel_h=kh, trim_kernel_w=kw,
                same_offset=same_offset, store_dtype=store_dtype,
            )
            if plan is None:
                sd = _api.fft_data_tiled(arr, kh, kw, **window)
            else:
                lh, lw, pkh, pkw = plan
                sd = _api.fft_data_tiled(
                    arr, pkh, pkw, block_h=lh, block_w=lw, **window
                )
            return tiled(sd, kernels, kh, kw, correlation, *args)
    maps = _api.fft_conv(
        arr, kernels=kernels, mode=mode, correlation=correlation,
        algorithm="direct", same_offset=same_offset, store_dtype=store_dtype,
    )
    return _positions(reduce, maps, *args)


def detect_peaks(
    data,
    kernels,
    *,
    mode: str = "same",
    correlation: bool = True,
    algorithm: str = "auto",
    same_offset: str = "scipy",
    store_dtype: str = "float32",
    device=None,
):
    """Per-kernel top-1 detection: ``(values, positions)`` where ``values``
    is (N,) (or (B, N) batched) peak responses and ``positions`` is
    (N, 2) / (B, N, 2) int32 (row, col) in the ``mode`` window's frame
    ('same' → data coordinates, like the reference demo's peak check).

    ``correlation=True`` by default: detection scores are correlations
    (template matching); a ``SpectralKernels`` bank carries its flip from
    ``fft_kernels``. A ragged cell list is accepted for mode='same' only.

    ``algorithm='auto'|'tiled'`` routes through the overlap-save engine
    when the planner tiles — at fused geometries the peaks kernel, no maps
    written; 'direct' computes the direct engine's maps and reduces them.
    ``store_dtype='bfloat16'``: the bf16 serving tier; ``device``: where an
    array input runs (module docstring)."""
    _check_mode(mode, "detect_peaks", "global peak position")
    _api._resolve_store_dtype(store_dtype)
    return _route(
        data, kernels, mode=mode, correlation=correlation,
        algorithm=algorithm, same_offset=same_offset,
        store_dtype=store_dtype, device=device, reduce=peaks_from_maps,
        tiled=_peaks_tiled,
    )


def detect_top_k(
    data,
    kernels,
    k: int = 5,
    *,
    mode: str = "same",
    correlation: bool = True,
    algorithm: str = "auto",
    same_offset: str = "scipy",
    store_dtype: str = "float32",
    device=None,
):
    """Per-kernel top-k detection: ``(values, positions)`` with ``values``
    (N, k) descending (or (B, N, k) batched) and ``positions`` (N, k, 2) /
    (B, N, k, 2) int32 (row, col) in the ``mode`` window's frame.

    Same routing and input contract as :func:`detect_peaks`. On the tiled
    engine at fused geometries the candidates are the peaks kernel's CELL
    maxima, one per block's valid window: an approximate top-k whose hits
    are spatially distinct (a built-in coarse non-max suppression; exact
    for k = 1, and where k exceeds the number of blocks the maps are
    reduced exactly). The JAX package's cells are groups of blocks sized
    for TPU VMEM, and JAX on the CPU never takes this branch, so for k > 1
    the two packages' fused results can differ. The direct engine and the
    unfused tiled branch are EXACT, in ``lax.top_k``'s order (values
    descending, ties by ascending flat index)."""
    validate(int(k) >= 1, f"k must be >= 1; got {k}")
    _check_mode(mode, "detect_top_k", "global peak positions")
    _api._resolve_store_dtype(store_dtype)
    return _route(
        data, kernels, mode=mode, correlation=correlation,
        algorithm=algorithm, same_offset=same_offset,
        store_dtype=store_dtype, device=device, reduce=top_k_from_maps,
        tiled=_top_k_tiled,
        args=(int(k),),
    )


def detect_local_peaks(
    data,
    kernels,
    k: int = 16,
    *,
    threshold=None,
    window: int = 3,
    mode: str = "same",
    correlation: bool = True,
    algorithm: str = "auto",
    same_offset: str = "scipy",
    store_dtype: str = "float32",
    out_dtype: str | None = None,
    device=None,
):
    """Per-kernel thresholded LOCAL-MAXIMA detection — every candidate
    above a score cutoff, mutually non-adjacent — where
    :func:`detect_peaks` / :func:`detect_top_k` return only the globally
    strongest responses.

    Returns ``(values, positions)``: ``values`` (N, k) descending (or
    (B, N, k) batched), ``positions`` (N, k, 2) / (B, N, k, 2) int32
    (row, col) in the ``mode`` window's frame. A hit equals the max of its
    ``window``×``window`` neighbourhood and lies strictly above
    ``threshold`` (None keeps every local max); slots beyond the number of
    hits carry ``−inf`` / (−1, −1). Local maxima compare across block
    borders, so there is no per-block kernel: the maps come from the
    regular engine (``algorithm`` as in ``fft_conv``) and are reduced by
    ``local_peaks_from_maps``. Ragged cell lists are accepted for
    mode='same'. ``out_dtype='bfloat16'`` stores those maps bf16; the
    scores compare in float32 after the upcast, and the values returned are
    the upcast scores."""
    validate(int(k) >= 1, f"k must be >= 1; got {k}")
    validate(int(window) >= 2, f"window must be >= 2; got {window}")
    _check_mode(mode, "detect_local_peaks", "peak positions")
    _api._resolve_store_dtype(store_dtype)
    _api._resolve_out_dtype(out_dtype)
    if _ragged_sizes(kernels):
        validate(mode == "same", _RAGGED_MODE_MSG)
        maps = _ragged_same_maps(
            data, kernels, correlation=correlation, algorithm=algorithm,
            same_offset=same_offset, store_dtype=store_dtype,
            device=device, out_dtype=out_dtype,
        )
    elif isinstance(data, (SpectralData, TiledSpectralData)):
        _kernel_hw(kernels)
        corr = correlation and not isinstance(kernels, SpectralKernels)
        maps = _api.conv_spectral(
            data, kernels, mode=mode, correlation=corr, out_dtype=out_dtype,
        )
    else:
        _kernel_hw(kernels)
        maps = _api.fft_conv(
            data, kernels=kernels, mode=mode, correlation=correlation,
            algorithm=algorithm, same_offset=same_offset,
            store_dtype=store_dtype, out_dtype=out_dtype, device=device,
        )
    return _positions(
        local_peaks_from_maps, maps, int(k), int(window), threshold
    )
