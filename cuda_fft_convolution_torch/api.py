"""Public API: the JAX package's entry points on PyTorch.

  - ``fft_conv``       one-shot bank convolution (≈ cudaConvolutionFFT)
  - ``fft_data``       reusable data spectrum (≈ cudaFFTData)
  - ``fft_data_tiled`` reusable overlap-save block spectra
  - ``fft_kernels``    reusable bank spectra
  - ``conv_spectral``  bank convolution against stored spectra
                       (≈ cudaConvFFTData)

Layouts are the JAX package's: data ``(H, W, F)`` or ``(B, H, W, F)``,
kernels ``(N, Kh, Kw, F)``, one ``(Kh, Kw, F)`` array or a list of them
(ragged sizes allowed), maps ``(N, H', W')`` or ``(B, N, H', W')`` (a list
per kernel for ragged windows). Inputs may be numpy arrays or tensors.
``device=`` says where the work runs, and the card is the default: a numpy
input goes to ``device``, or to ``torch.device('cuda')`` when ``device`` is
None; a tensor stays on its device unless ``device`` is given;
``device='cpu'`` runs on the CPU. With no CUDA device and no
``device='cpu'`` a call on a numpy input raises ``InvalidInputError``:
nothing falls back to the CPU (``utils/device.py``).

``store_dtype='bfloat16'`` is the JAX package's bf16 serving tier: the
spectra are transformed in float32 and stored bfloat16, every MAC and
inverse accumulates float32, and a bank meets data spectra of its own tier
only. ``out_dtype='bfloat16'`` stores the output maps bfloat16. Both run
through the CUDA kernels on the card.

Options of the JAX package that are not ported yet raise
``InvalidInputError`` naming their ROADMAP item.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_fft_convolution_torch.ops.conv import (
    irfft2_norm_planes,
    rfft2_padded_planes,
)
from cuda_fft_convolution_torch.ops.spectral_mac import spectral_mac_auto_planes
from cuda_fft_convolution_torch.ops.tiled import (
    choose_block_plan,
    conv_blocks,
    fallback_block_fft,
    fft_data_blocks,
)
from cuda_fft_convolution_torch.types import (
    SpectralData,
    SpectralKernels,
    TiledSpectralData,
)
from cuda_fft_convolution_torch.utils.device import as_tensor
from cuda_fft_convolution_torch.utils.errors import InvalidInputError, validate
from cuda_fft_convolution_torch.utils.fft_size import (
    FftSizePolicy,
    compute_fft_size,
)

_MODES = ("fftmap", "full", "same", "valid")

# Share of a CUDA device's memory the tiled engine's bank-chunk model may
# plan with (the JAX package's default hbm_fraction); the CPU plans with
# the JAX package's 8 GiB fallback.
_DEVICE_MEMORY_FRACTION = 0.92
_CPU_MEMORY_BUDGET = 8 << 30


# ---------------------------------------------------------------------------
# options not ported yet
# ---------------------------------------------------------------------------


def _not_ported(cond: bool, what: str, item: str) -> None:
    if cond:
        raise InvalidInputError(
            f"{what} is not ported to cuda_fft_convolution_torch yet "
            f"(ROADMAP {item})"
        )


def _check_padding_layout(padding: str, kernel_layout: str) -> None:
    validate(padding in ("zero", "clamp"), "padding must be 'zero' or 'clamp'")
    validate(
        kernel_layout in ("corner", "centered"),
        "kernel_layout must be 'corner' or 'centered'",
    )
    _not_ported(padding == "clamp", "padding='clamp'", "queue 1 item 1")
    _not_ported(
        kernel_layout == "centered", "kernel_layout='centered'",
        "queue 1 item 1",
    )


# ---------------------------------------------------------------------------
# the bf16 serving tier
# ---------------------------------------------------------------------------


def _resolve_store_dtype(store_dtype: str) -> torch.dtype:
    """'float32' | 'bfloat16' → the dtype stored spectra take."""
    validate(
        store_dtype in ("float32", "bfloat16"),
        "store_dtype must be 'float32' or 'bfloat16'",
    )
    return torch.float32 if store_dtype == "float32" else torch.bfloat16


def _resolve_out_dtype(out_dtype) -> torch.dtype:
    """None | 'float32' | 'bfloat16' → the maps' dtype (float32 unless
    'bfloat16')."""
    validate(
        out_dtype in (None, "float32", "bfloat16"),
        f"out_dtype must be None, 'float32' or 'bfloat16', got {out_dtype!r}",
    )
    return torch.bfloat16 if out_dtype == "bfloat16" else torch.float32


def _store_dtype_of(spectral) -> str:
    """The tier of stored spectra: 'bfloat16' or 'float32'."""
    return "bfloat16" if spectral.re.dtype == torch.bfloat16 else "float32"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _check_tier(sk: SpectralKernels, spectral) -> None:
    """A bank meets data spectra of its own store dtype: a mixed pair is an
    error, never a silent upcast."""
    validate(
        sk.re.dtype == spectral.re.dtype,
        f"spectra store-dtype mismatch: kernels {_dtype_name(sk.re.dtype)}, "
        f"data {_dtype_name(spectral.re.dtype)} — precompute both sides with "
        "the same store_dtype ('bfloat16' tier pairs with a bf16 bank)",
    )


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def _data_to_cfirst(data, device=None) -> tuple[torch.Tensor, bool]:
    """(H, W, F) → (1, F, H, W); (B, H, W, F) → (B, F, H, W). Returns
    (tensor, batched)."""
    data = as_tensor(data, device)
    validate(
        all(d > 0 for d in data.shape),
        f"data has zero-size dimension: shape {tuple(data.shape)}",
    )
    if data.ndim == 3:
        return data.permute(2, 0, 1)[None], False
    if data.ndim == 4:
        return data.permute(0, 3, 1, 2), True
    raise InvalidInputError(
        f"data must be (H, W, F) or (B, H, W, F); got shape {tuple(data.shape)}"
    )


def _kernels_to_stack(
    kernels, feature_dim: int | None, device=None
) -> tuple[torch.Tensor, tuple[int, ...], tuple[int, ...]]:
    """Normalize a kernel bank to a stacked (N, F, maxKh, maxKw) tensor.

    Accepts a list/tuple of (Kh_i, Kw_i, F) arrays (ragged sizes allowed,
    zero-padded to the max — exact for linear convolution), a single
    (Kh, Kw, F) array, or a stacked (N, Kh, Kw, F) array. Returns
    (stack, kernel_hs, kernel_ws)."""
    if isinstance(kernels, (list, tuple)):
        ks = [as_tensor(k, device) for k in kernels]
        validate(len(ks) > 0, "kernel list is empty")
        for k in ks:
            validate(
                k.ndim == 3,
                f"each kernel must be (Kh, Kw, F); got shape {tuple(k.shape)}",
            )
            if feature_dim is not None:
                validate(
                    k.shape[2] == feature_dim,
                    f"kernel feature dim {k.shape[2]} != data feature dim "
                    f"{feature_dim} (reference check src/cudaConvolutionFFT.cu:242)",
                )
        khs = tuple(int(k.shape[0]) for k in ks)
        kws = tuple(int(k.shape[1]) for k in ks)
        max_kh, max_kw = max(khs), max(kws)
        stack = torch.stack([
            torch.nn.functional.pad(
                k.permute(2, 0, 1),
                (0, max_kw - k.shape[1], 0, max_kh - k.shape[0]),
            )
            for k in ks
        ])
        return stack, khs, kws
    k = as_tensor(kernels, device)
    if k.ndim == 3:  # single kernel (Kh, Kw, F)
        k = k[None]
    validate(
        k.ndim == 4,
        f"kernels must be (N, Kh, Kw, F) or a list; got {tuple(k.shape)}",
    )
    if feature_dim is not None:
        validate(
            k.shape[3] == feature_dim,
            f"kernel feature dim {k.shape[3]} != data feature dim {feature_dim}",
        )
    n, kh, kw = k.shape[0], int(k.shape[1]), int(k.shape[2])
    return k.permute(0, 3, 1, 2), (kh,) * n, (kw,) * n


def _apply_correlation_flip(kstack, khs, kws, correlation):
    """Flip kernels spatially for correlation. Uniform banks flip the padded
    stack; a ragged bank flips each kernel within its own extent (flipping
    the padded stack moves kernel i to offset (maxKh−kh_i, maxKw−kw_i); it
    is rolled back to the origin). Returns the flipped stack."""
    if not correlation:
        return kstack
    flipped = kstack.flip(-2, -1)
    if len(set(khs)) == 1 and len(set(kws)) == 1:
        return flipped
    max_kh, max_kw = kstack.shape[-2], kstack.shape[-1]
    return torch.stack([
        torch.roll(x, (kh - max_kh, kw - max_kw), dims=(-2, -1))
        for x, kh, kw in zip(flipped, khs, kws)
    ])


def _device_memory_budget(device: torch.device) -> int:
    """Bytes the tiled engine's bank-chunk model may plan with."""
    if device.type == "cuda":
        total = torch.cuda.mem_get_info(device)[1]
        return int(_DEVICE_MEMORY_FRACTION * total)
    return _CPU_MEMORY_BUDGET


def _resolve_policy(policy):
    return FftSizePolicy.FAST if policy is None else FftSizePolicy(policy)


def _bucket_ragged(kernels) -> list[list[int]] | None:
    """Size buckets (pow-2 envelope per axis, floor 8) of a ragged kernel
    list, or None when bucketing would not pay — the JAX package's rule."""
    def env(n):
        return max(1 << (int(n) - 1).bit_length(), 8)

    keys = [(env(k.shape[0]), env(k.shape[1])) for k in kernels]
    if len(set(keys)) <= 1:
        return None
    buckets: dict = {}
    for i, key in enumerate(keys):
        buckets.setdefault(key, []).append(i)
    gh = max(k[0] for k in keys)
    gw = max(k[1] for k in keys)
    if not any(k[0] * 2 <= gh or k[1] * 2 <= gw for k in buckets):
        return None
    return [idx for _, idx in sorted(buckets.items())]


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def fft_data(
    data,
    max_kernel_h: int,
    max_kernel_w: int,
    *,
    policy: FftSizePolicy | str | None = None,
    device=None,
    padding: str = "zero",
    kernel_layout: str = "corner",
    store_dtype: str = "float32",
) -> SpectralData:
    """Precompute the reusable data spectrum — ≈ ``cudaFFTData(data, Kh,
    Kw)``: zero padding, corner layout, FFT dims ``policy(data + maxK − 1)``
    (default 'fast'). ``store_dtype='bfloat16'``: the transform runs in
    float32 and the planes are stored bf16 (the serving tier; pair with
    ``fft_kernels(..., store_dtype='bfloat16')``)."""
    validate(max_kernel_h >= 1 and max_kernel_w >= 1, "kernel dims must be >= 1")
    _check_padding_layout(padding, kernel_layout)
    store_t = _resolve_store_dtype(store_dtype)
    policy = _resolve_policy(policy)
    data_cf, batched = _data_to_cfirst(data, device)
    b, f, h, w = data_cf.shape
    fft_h, fft_w = compute_fft_size(h, w, max_kernel_h, max_kernel_w, policy)
    re, im = rfft2_padded_planes(data_cf, fft_h, fft_w)
    re, im = re.to(store_t), im.to(store_t)
    if not batched:
        re, im = re[0], im[0]
    return SpectralData(
        re=re, im=im, fft_h=fft_h, fft_w=fft_w, data_h=h, data_w=w
    )


def fft_data_tiled(
    data,
    max_kernel_h: int,
    max_kernel_w: int,
    *,
    block_h: int | None = None,
    block_w: int | None = None,
    device=None,
    trim_mode: str = "full",
    trim_kernel_h: int | None = None,
    trim_kernel_w: int | None = None,
    same_offset: str = "scipy",
    store_dtype: str = "float32",
    policy: FftSizePolicy | str | None = None,
) -> TiledSpectralData:
    """Precompute overlap-save BLOCK spectra of the data (ops/tiled.py),
    reusable across the bank and across calls. Block size defaults to the
    planner's choice (``choose_block_plan``).

    ``trim_mode='same'``/``'valid'`` bakes that output window into the
    block tiling (for kernels of exactly ``trim_kernel_h/w``, default the
    max): the engine then writes the windowed maps directly, with no trim
    copy. ``trim_mode='fftmap'`` bakes the direct engine's FFT canvas
    (``policy(data + trim_kernel − 1)``, origin 0), so the assembled maps
    equal the direct engine's raw circular maps.

    ``store_dtype='bfloat16'``: the block spectra are stored bf16 (the
    serving tier, see ``fft_data``)."""
    validate(max_kernel_h >= 1 and max_kernel_w >= 1, "kernel dims must be >= 1")
    store_t = _resolve_store_dtype(store_dtype)
    validate(
        trim_mode in ("full", "same", "valid", "fftmap"),
        "trim_mode must be 'full', 'same', 'valid', or 'fftmap'",
    )
    validate(
        policy is None or trim_mode == "fftmap",
        "policy only sizes the trim_mode='fftmap' canvas — block dims are "
        "chosen by the overlap-save planner, not an FFT-size policy",
    )
    tkh = max_kernel_h if trim_kernel_h is None else int(trim_kernel_h)
    tkw = max_kernel_w if trim_kernel_w is None else int(trim_kernel_w)
    data_cf, batched = _data_to_cfirst(data, device)
    b, f, h, w = data_cf.shape
    if block_h is None or block_w is None:
        plan = choose_block_plan(h, w, max_kernel_h, max_kernel_w)
        if plan is None:
            # Caller forced tiling where the planner declines — still honor
            # it with the smallest sane block.
            block_h, block_w = fallback_block_fft(max_kernel_h, max_kernel_w)
        else:
            block_h, block_w, max_kernel_h, max_kernel_w = plan
    validate(
        block_h >= max_kernel_h and block_w >= max_kernel_w,
        f"block ({block_h},{block_w}) smaller than kernel "
        f"({max_kernel_h},{max_kernel_w})",
    )
    validate(
        same_offset in ("scipy", "matlab"),
        "same_offset must be 'scipy' or 'matlab'",
    )
    if trim_mode == "same":
        if same_offset == "matlab":
            origin_h, origin_w = tkh // 2, tkw // 2
        else:
            origin_h, origin_w = (tkh - 1) // 2, (tkw - 1) // 2
        win_h, win_w = h, w
    elif trim_mode == "valid":
        validate(
            h >= tkh and w >= tkw,
            f"trim_mode='valid' needs data >= kernel; got data ({h},{w}), "
            f"kernel ({tkh},{tkw})",
        )
        origin_h, origin_w = tkh - 1, tkw - 1
        win_h, win_w = h - tkh + 1, w - tkw + 1
    elif trim_mode == "fftmap":
        origin_h = origin_w = 0
        win_h, win_w = compute_fft_size(h, w, tkh, tkw, _resolve_policy(policy))
        validate(
            win_h >= h + tkh - 1 and win_w >= w + tkw - 1,
            f"fftmap canvas ({win_h},{win_w}) does not cover the linear "
            f"extent ({h + tkh - 1},{w + tkw - 1}) — the circular maps "
            "would alias; use an FFT-size policy that pads to at least "
            "data + kernel − 1",
        )
    else:
        origin_h = origin_w = 0
        win_h = win_w = None
    re, im = fft_data_blocks(
        data_cf, block_h, block_w, max_kernel_h, max_kernel_w,
        origin_h, origin_w, win_h, win_w, dtype=store_t,
    )
    if not batched:
        re, im = re[0], im[0]
    return TiledSpectralData(
        re=re, im=im, block_h=block_h, block_w=block_w,
        max_kh=max_kernel_h, max_kw=max_kernel_w, data_h=h, data_w=w,
        origin_h=origin_h, origin_w=origin_w, win_h=win_h, win_w=win_w,
        fftmap_canvas=trim_mode == "fftmap",
    )


def fft_kernels(
    kernels,
    fft_h: int | None = None,
    fft_w: int | None = None,
    *,
    spectral: SpectralData | TiledSpectralData | None = None,
    feature_dim: int | None = None,
    correlation: bool = False,
    device=None,
    kernel_layout: str = "corner",
    store_dtype: str = "float32",
) -> SpectralKernels:
    """Precompute a kernel bank's spectra at a fixed FFT size — planar
    planes, float32 or, with ``store_dtype='bfloat16'``, transformed in
    float32 and stored bf16 (the serving tier; pair with bf16 data
    spectra). Pass explicit (fft_h, fft_w) or the spectra the bank will be
    used against (their block size for ``TiledSpectralData``); the bank
    then lands on the spectra's device unless ``device`` is given.
    ``correlation=True`` flips each kernel spatially first."""
    _check_padding_layout("zero", kernel_layout)
    store_t = _resolve_store_dtype(store_dtype)
    if isinstance(spectral, TiledSpectralData):
        fft_h, fft_w = spectral.block_h, spectral.block_w
        feature_dim = spectral.feature_dim
    elif spectral is not None:
        fft_h, fft_w = spectral.fft_h, spectral.fft_w
        feature_dim = spectral.feature_dim
    validate(
        fft_h is not None and fft_w is not None,
        "pass fft_h/fft_w or spectral=SpectralData",
    )
    if device is None and spectral is not None:
        device = spectral.re.device
    kstack, khs, kws = _kernels_to_stack(kernels, feature_dim, device)
    validate(
        max(khs) <= fft_h and max(kws) <= fft_w,
        f"kernel ({max(khs)},{max(kws)}) exceeds FFT dims ({fft_h},{fft_w}) "
        "(reference check src/cudaConvolutionFFT.cu:242-243)",
    )
    kstack = _apply_correlation_flip(kstack, khs, kws, correlation)
    re, im = rfft2_padded_planes(kstack, fft_h, fft_w)
    re, im = re.to(store_t), im.to(store_t)
    return SpectralKernels(
        re=re, im=im, fft_h=fft_h, fft_w=fft_w, kernel_hs=khs, kernel_ws=kws
    )


def _trim(
    maps: torch.Tensor,  # (B, N, H', W')
    spectral: SpectralData | TiledSpectralData,
    khs: tuple[int, ...],
    kws: tuple[int, ...],
    mode: str,
    batched: bool,
    same_offset: str = "scipy",
):
    """Slice the maps down to the requested window.

    'fftmap' → raw maps. 'full' → top-left (H+Kh−1)×(W+Kw−1); 'same' →
    H×W at offset ``same_offset`` ('scipy' (Kh−1)//2, 'matlab' Kh//2);
    'valid' → (H−Kh+1)×(W−Kw+1) at (Kh−1, Kw−1). Window coordinates are
    'full'-window indices, shifted by the origin baked into tiled spectra.
    Ragged banks return a list for modes whose window depends on the
    kernel size."""
    h, w = spectral.data_h, spectral.data_w
    if mode == "fftmap":
        return maps if batched else maps[0]
    validate(
        same_offset in ("scipy", "matlab"),
        "same_offset must be 'scipy' or 'matlab'",
    )
    ragged = len(set(khs)) > 1 or len(set(kws)) > 1
    org_h = getattr(spectral, "origin_h", 0)
    org_w = getattr(spectral, "origin_w", 0)
    avail_h, avail_w = maps.shape[-2], maps.shape[-1]

    def window(kh, kw):
        if mode == "full":
            r = (0, 0, h + kh - 1, w + kw - 1)
        elif mode == "same":
            if same_offset == "matlab":
                r = (kh // 2, kw // 2, h, w)
            else:
                r = ((kh - 1) // 2, (kw - 1) // 2, h, w)
        else:  # valid
            validate(
                h >= kh and w >= kw, f"mode='valid' needs data >= kernel; "
                f"got data ({h},{w}), kernel ({kh},{kw})"
            )
            r = (kh - 1, kw - 1, h - kh + 1, w - kw + 1)
        r0, c0, rh, rw = r[0] - org_h, r[1] - org_w, r[2], r[3]
        validate(
            0 <= r0 and r0 + rh <= avail_h
            and 0 <= c0 and c0 + rw <= avail_w,
            f"mode='{mode}' window for kernel ({kh},{kw}) falls outside "
            "the window baked into these tiled spectra — recompute "
            "fft_data_tiled with trim_mode='full' (or the matching mode "
            "and kernel size)",
        )
        return r0, c0, rh, rw

    if not ragged:
        r0, c0, rh, rw = window(khs[0], kws[0])
        out = maps[:, :, r0 : r0 + rh, c0 : c0 + rw]
        return out if batched else out[0]
    outs = []
    for i, (kh, kw) in enumerate(zip(khs, kws)):
        r0, c0, rh, rw = window(kh, kw)
        m = maps[:, i, r0 : r0 + rh, c0 : c0 + rw]
        outs.append(m if batched else m[0])
    return outs


def _check_bank(sk: SpectralKernels, spectral, correlation: bool) -> None:
    validate(not correlation, "correlation must be baked into fft_kernels "
             "when passing SpectralKernels")
    _not_ported(sk.centered, "a kernel_layout='centered' bank", "queue 1 item 1")
    _not_ported(sk.flat, "a storage='flat' bank", "queue 1 item 5")
    _check_tier(sk, spectral)


def conv_spectral(
    spectral: SpectralData | TiledSpectralData,
    kernels,
    *,
    mode: str = "fftmap",
    correlation: bool = False,
    use_pallas: bool | None = None,
    same_offset: str = "scipy",
    kernel_layout: str = "corner",
    out_dtype: str | None = None,
):
    """Convolve a kernel bank against precomputed data spectra —
    ≈ ``cudaConvFFTData(fftData, {kernels})``.

    ``kernels``: a list of (Kh, Kw, F) arrays (ragged ok), a stacked
    (N, Kh, Kw, F) array, or a precomputed ``SpectralKernels``. Returns maps
    (N, H', W') (batched: (B, N, H', W')), or a list per kernel for ragged
    windows. ``SpectralData`` runs the direct engine (MAC + one irfft2 per
    kernel); ``TiledSpectralData`` runs the overlap-save engine.
    The spectral MAC of the direct engine and of the unfused tiled branch
    always runs through the MAC kernel (``ops/spectral_mac.py
    spectral_mac``); ``use_pallas``, the JAX package's selection between
    its einsum and its Pallas kernel, is accepted with no effect.

    bf16 spectra (the serving tier) take a bank of the same tier: raw
    kernels are transformed at it, and a ``SpectralKernels`` of the other
    tier is an error. On the direct engine their products are stored bf16
    and the inverse runs on them upcast to float32; the maps are float32.
    ``out_dtype='bfloat16'`` stores the maps bf16 (in the kernel on the
    fused tiled branch)."""
    validate(mode in _MODES, f"mode must be one of {_MODES}")
    out_t = _resolve_out_dtype(out_dtype)
    _check_padding_layout("zero", kernel_layout)
    _not_ported(
        getattr(spectral, "clamp", False), "padding='clamp' spectra",
        "queue 1 item 1",
    )
    if isinstance(spectral, TiledSpectralData):
        return _conv_spectral_tiled(
            spectral, kernels, mode=mode, correlation=correlation,
            same_offset=same_offset, out_dtype=out_t,
        )
    if isinstance(kernels, SpectralKernels):
        sk = kernels
        _check_bank(sk, spectral, correlation)
        validate(
            sk.fft_h == spectral.fft_h and sk.fft_w == spectral.fft_w,
            f"SpectralKernels FFT dims ({sk.fft_h},{sk.fft_w}) != "
            f"SpectralData dims ({spectral.fft_h},{spectral.fft_w})",
        )
        validate(
            sk.feature_dim == spectral.feature_dim,
            f"feature dim mismatch: kernels {sk.feature_dim}, "
            f"data {spectral.feature_dim}",
        )
    else:
        sk = fft_kernels(
            kernels, spectral=spectral, correlation=correlation,
            store_dtype=_store_dtype_of(spectral),
        )
    if mode != "fftmap":
        # Linear windows need FFT dims covering data + kernel − 1; a larger
        # kernel would return circularly aliased maps.
        validate(
            spectral.data_h + max(sk.kernel_hs) - 1 <= spectral.fft_h
            and spectral.data_w + max(sk.kernel_ws) - 1 <= spectral.fft_w,
            f"kernel ({max(sk.kernel_hs)},{max(sk.kernel_ws)}) too large for "
            f"linear convolution at FFT dims ({spectral.fft_h},"
            f"{spectral.fft_w}) with data ({spectral.data_h},"
            f"{spectral.data_w}): output would be circularly aliased. "
            "Recompute fft_data with larger max_kernel dims, or use "
            "mode='fftmap' for raw circular maps",
        )
    batched = spectral.batched
    d_re = spectral.re if batched else spectral.re[None]
    d_im = spectral.im if batched else spectral.im[None]
    p_re, p_im = spectral_mac_auto_planes(d_re, d_im, sk.re, sk.im)
    if d_re.dtype == torch.bfloat16:
        # The tier stores its products bf16 too, as the JAX package does.
        p_re, p_im = p_re.to(torch.bfloat16), p_im.to(torch.bfloat16)
    maps = irfft2_norm_planes(p_re, p_im, spectral.fft_h, spectral.fft_w)
    maps = maps.to(out_t)
    return _trim(
        maps, spectral, sk.kernel_hs, sk.kernel_ws, mode, batched,
        same_offset=same_offset,
    )


def _conv_spectral_tiled(
    spectral: TiledSpectralData,
    kernels,
    *,
    mode: str,
    correlation: bool,
    same_offset: str = "scipy",
    out_dtype: torch.dtype = torch.float32,
):
    """Overlap-save bank convolution against precomputed block spectra,
    maps in ``out_dtype``."""
    validate(
        mode != "fftmap" or spectral.fftmap_canvas,
        "mode='fftmap' (raw circular maps) needs spectra with the FFT "
        "canvas baked in — precompute with fft_data_tiled("
        "trim_mode='fftmap') or use the direct engine",
    )
    if isinstance(kernels, SpectralKernels):
        sk = kernels
        _check_bank(sk, spectral, correlation)
        validate(
            sk.fft_h == spectral.block_h and sk.fft_w == spectral.block_w,
            f"SpectralKernels FFT dims ({sk.fft_h},{sk.fft_w}) != block dims "
            f"({spectral.block_h},{spectral.block_w})",
        )
    else:
        sk = fft_kernels(
            kernels, spectral=spectral, correlation=correlation,
            store_dtype=_store_dtype_of(spectral),
        )
    validate(
        max(sk.kernel_hs) <= spectral.max_kh
        and max(sk.kernel_ws) <= spectral.max_kw,
        f"bank kernels up to ({max(sk.kernel_hs)},{max(sk.kernel_ws)}) exceed "
        f"the tiled spectra's planned max ({spectral.max_kh},{spectral.max_kw})",
    )
    if mode == "fftmap":
        validate(
            spectral.data_h + max(sk.kernel_hs) - 1 <= spectral.win_h
            and spectral.data_w + max(sk.kernel_ws) - 1 <= spectral.win_w,
            f"kernel ({max(sk.kernel_hs)},{max(sk.kernel_ws)}) exceeds the "
            f"fftmap canvas ({spectral.win_h},{spectral.win_w}) baked for "
            f"data ({spectral.data_h},{spectral.data_w}): the circular map "
            "would wrap. Recompute fft_data_tiled(trim_mode='fftmap') with "
            "larger trim_kernel dims",
        )
    batched = spectral.batched
    d_re = spectral.re if batched else spectral.re[None]
    d_im = spectral.im if batched else spectral.im[None]
    chunk = _tiled_chunk_size(spectral, d_re, sk.num_kernels)
    maps = _tiled_chunked_maps(spectral, d_re, d_im, sk, chunk, out_dtype)
    return _trim(
        maps, spectral, sk.kernel_hs, sk.kernel_ws, mode, batched,
        same_offset=same_offset,
    )


def _tiled_chunk_size(
    spectral: TiledSpectralData, d_re: torch.Tensor, n: int
) -> int:
    """Bank chunk size for the tiled engine from the JAX package's memory
    model: per-kernel cost = MAC products + inverse temps over every block
    plus its slice of the output maps; fixed cost = block + bank spectra +
    the full output."""
    b, nbh, nbw = d_re.shape[0], d_re.shape[1], d_re.shape[2]
    f = spectral.feature_dim
    lh, wc = spectral.block_h, spectral.block_w // 2 + 1
    nb = b * nbh * nbw
    pair = 2 * d_re.element_size()
    per_kernel = 2 * nb * lh * wc * 8 + b * spectral.out_h * spectral.out_w * 4
    fixed = (
        nb * f * lh * wc * pair  # block spectra
        + n * f * lh * wc * pair  # bank spectra
        + b * n * spectral.out_h * spectral.out_w * 4  # output maps
    )
    budget = max(_device_memory_budget(d_re.device) - fixed, per_kernel)
    return max(1, min(n, budget // per_kernel))


def _tiled_chunked_maps(
    spectral: TiledSpectralData,
    d_re: torch.Tensor,
    d_im: torch.Tensor,
    sk: SpectralKernels,
    chunk_size: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Run the bank through conv_blocks in ``chunk_size`` slices (one call
    when the whole bank fits), maps in ``out_dtype``."""
    n = sk.num_kernels
    geom = (
        spectral.block_h, spectral.block_w, spectral.max_kh, spectral.max_kw,
        spectral.out_h, spectral.out_w,
    )
    if chunk_size >= n:
        return conv_blocks(d_re, d_im, sk.re, sk.im, *geom, out_dtype)
    outs = [
        conv_blocks(d_re, d_im, sk.re[s : s + chunk_size],
                    sk.im[s : s + chunk_size], *geom, out_dtype)
        for s in range(0, n, chunk_size)
    ]
    return torch.cat(outs, dim=1)


def fft_conv(
    data,
    max_kernel_h: int | None = None,
    max_kernel_w: int | None = None,
    kernels=None,
    *,
    mode: str = "fftmap",
    correlation: bool = False,
    policy: FftSizePolicy | str | None = None,
    use_pallas: bool | None = None,
    algorithm: str = "auto",
    device=None,
    bucket_ragged: bool = True,
    padding: str = "zero",
    kernel_layout: str = "corner",
    same_offset: str = "scipy",
    store_dtype: str = "float32",
    out_dtype: str | None = None,
):
    """One-shot bank convolution — ≈ ``cudaConvolutionFFT(data, maxKh,
    maxKw, kernelCell)``.

    ``algorithm``: 'direct' = one image-sized FFT per kernel (the
    reference's engine); 'tiled' = overlap-save block FFTs through the fused
    block-conv; 'auto' = tiled when ``choose_block_plan`` says it pays, else
    direct. ``max_kernel_h/w`` may be omitted (inferred from the bank).
    Uniform banks with mode 'same'/'valid' bake the window into the block
    tiling, and mode 'fftmap' bakes the direct engine's canvas.
    ``use_pallas`` as in ``conv_spectral``. ``store_dtype='bfloat16'`` runs
    every spectrum at the bf16 serving tier (see ``fft_data``);
    ``out_dtype='bfloat16'`` stores the maps bf16 (see ``conv_spectral``);
    the two compose."""
    validate(kernels is not None, "kernels is required")
    validate(mode in _MODES, f"mode must be one of {_MODES}")
    _resolve_out_dtype(out_dtype)
    _resolve_store_dtype(store_dtype)
    validate(
        algorithm in ("auto", "direct", "tiled"),
        "algorithm must be 'auto', 'direct', or 'tiled'",
    )
    _check_padding_layout(padding, kernel_layout)
    if (
        bucket_ragged
        and mode != "fftmap"
        and isinstance(kernels, (list, tuple))
        and len(kernels) > 1
    ):
        _not_ported(
            _bucket_ragged(kernels) is not None,
            "ragged bucketing (pass bucket_ragged=False to run the bank at "
            "its largest kernel size)",
            "queue 1 item 5",
        )
    if isinstance(kernels, (list, tuple)):
        kshapes = {(int(k.shape[0]), int(k.shape[1])) for k in kernels}
    else:
        kshape = np.shape(kernels)
        kh_ax, kw_ax = (1, 2) if len(kshape) == 4 else (0, 1)
        kshapes = {(int(kshape[kh_ax]), int(kshape[kw_ax]))}
    if max_kernel_h is None or max_kernel_w is None:
        max_kernel_h = max(s[0] for s in kshapes)
        max_kernel_w = max(s[1] for s in kshapes)
    if algorithm == "auto" and policy is not None and mode != "fftmap":
        # A pinned FFT-size policy applies to the direct engine's linear
        # windows; the tiled engine's block geometry would supersede it.
        algorithm = "direct"
    if algorithm != "direct":
        dshape = np.shape(data)
        h, w = (dshape[0], dshape[1]) if len(dshape) == 3 else (dshape[1], dshape[2])
        plan = choose_block_plan(h, w, max_kernel_h, max_kernel_w)
        if algorithm == "tiled" or plan is not None:
            trim_kwargs = {}
            if mode == "fftmap":
                trim_kwargs = dict(
                    trim_mode="fftmap", trim_kernel_h=max_kernel_h,
                    trim_kernel_w=max_kernel_w, policy=policy,
                )
            elif mode in ("same", "valid") and len(kshapes) == 1:
                # Bake the window at the ACTUAL uniform kernel shape, which
                # may be smaller than a caller's max_kernel_h/w.
                ukh, ukw = next(iter(kshapes))
                trim_kwargs = dict(
                    trim_mode=mode, trim_kernel_h=ukh, trim_kernel_w=ukw,
                    same_offset=same_offset,
                )
            if plan is None:
                spectral = fft_data_tiled(
                    data, max_kernel_h, max_kernel_w, device=device,
                    store_dtype=store_dtype, **trim_kwargs,
                )
            else:
                lh, lw, pkh, pkw = plan
                spectral = fft_data_tiled(
                    data, pkh, pkw, block_h=lh, block_w=lw, device=device,
                    store_dtype=store_dtype, **trim_kwargs,
                )
            return conv_spectral(
                spectral, kernels, mode=mode, correlation=correlation,
                same_offset=same_offset, out_dtype=out_dtype,
            )
    # algorithm == 'direct', or 'auto' with the planner declining to tile
    spectral = fft_data(
        data, max_kernel_h, max_kernel_w, policy=policy, device=device,
        store_dtype=store_dtype,
    )
    return conv_spectral(
        spectral, kernels, mode=mode, correlation=correlation,
        same_offset=same_offset, out_dtype=out_dtype,
    )
