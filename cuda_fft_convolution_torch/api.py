"""Public API: the JAX package's entry points on PyTorch.

  - ``fft_conv``                one-shot bank convolution (≈ cudaConvolutionFFT)
  - ``fft_data``                reusable data spectrum (≈ cudaFFTData)
  - ``fft_data_tiled``          reusable overlap-save block spectra
  - ``fft_kernels``             reusable bank spectra
  - ``conv_spectral``           bank convolution against stored spectra
                                (≈ cudaConvFFTData)
  - ``conv_spectral_pipelined`` the same, a chunk of the bank at a time
                                (≈ cudaConvFFTDataStreams)

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

``padding='clamp'`` (border replication) and ``kernel_layout='centered'``
(un-shifted maps) run on the direct engine. Memory is planned against the
device budget (``utils/config.py``: ``hbm_budget_bytes``, else
``hbm_fraction`` of the card): a bank transform, a bank convolution or a
bank too large to hold as spectra runs in chunks of kernels
(``runtime/planner.py``), with maps equal to the whole-bank call's.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_fft_convolution_torch.ops.conv import rfft2_padded_planes
from cuda_fft_convolution_torch.ops.padding import (
    pad_clamp_to_border,
    pad_kernel_centered,
)
from cuda_fft_convolution_torch.ops.spectral_mac import spectral_mac_auto_planes
from cuda_fft_convolution_torch.ops.tiled import (
    choose_block_plan,
    conv_blocks,
    fallback_block_fft,
    fft_data_blocks,
)
from cuda_fft_convolution_torch.runtime.planner import (
    BankPlan,
    plan_bank,
    plan_streaming,
    plan_transform,
    spectra_bytes,
)
from cuda_fft_convolution_torch.types import (
    SpectralData,
    SpectralKernels,
    TiledSpectralData,
)
from cuda_fft_convolution_torch.utils.config import get_config
from cuda_fft_convolution_torch.utils.device import as_tensor, resolve_device
from cuda_fft_convolution_torch.utils.errors import InvalidInputError, validate
from cuda_fft_convolution_torch.utils.fft_size import (
    FftSizePolicy,
    compute_fft_size,
)

_MODES = ("fftmap", "full", "same", "valid")

# The memory budget on the CPU: the JAX package's 8 GiB fallback.
_CPU_MEMORY_BUDGET = 8 << 30


# ---------------------------------------------------------------------------
# option checks
# ---------------------------------------------------------------------------


def _check_padding_layout(padding: str, kernel_layout: str) -> None:
    validate(padding in ("zero", "clamp"), "padding must be 'zero' or 'clamp'")
    validate(
        kernel_layout in ("corner", "centered"),
        "kernel_layout must be 'corner' or 'centered'",
    )


def _check_centered_correlation(centered: bool, correlation: bool) -> None:
    validate(
        not (centered and correlation),
        "kernel_layout='centered' requires pre-flipped kernels "
        "(correlation=True is ambiguous for centered anchors — flip by "
        "hand like the reference demo, demoCudaConvolutionFFT.m:67-69)",
    )


def _check_clamp_mode(spectral, mode: str) -> None:
    validate(
        not (getattr(spectral, "clamp", False) and mode == "full"),
        "padding='clamp' spectra pair with mode 'same', 'fftmap', or "
        "'valid' — a 'full' window mixes the far-edge band with the "
        "wrap-to-origin replicas",
    )


_CENTERED_TILED_MSG = (
    "kernel_layout='centered' requires the direct engine "
    "(SpectralData) — tiled block decomposition assumes "
    "corner-anchored kernels"
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


def _check_fits_fft(khs, kws, fft_h: int, fft_w: int) -> None:
    validate(
        max(khs) <= fft_h and max(kws) <= fft_w,
        f"kernel ({max(khs)},{max(kws)}) exceeds FFT dims ({fft_h},{fft_w}) "
        "(reference check src/cudaConvolutionFFT.cu:242-243)",
    )


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
    """Bytes the bank planners may plan with on ``device``:
    ``Config.hbm_budget_bytes`` when set (on every device), else
    ``Config.hbm_fraction`` of a CUDA device's total memory, else the CPU's
    8 GiB. The total is the device's properties, which torch caches: every
    call plans with it, a stream's every frame too, and ``cudaMemGetInfo``
    can block behind the work in flight."""
    cfg = get_config()
    if cfg.hbm_budget_bytes is not None:
        return int(cfg.hbm_budget_bytes)
    if device.type == "cuda":
        return int(cfg.hbm_fraction * torch.cuda.get_device_properties(device).total_memory)
    return _CPU_MEMORY_BUDGET


def _resolve_policy(policy):
    return get_config().policy if policy is None else FftSizePolicy(policy)


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
    same_offset: str = "scipy",
    kernel_layout: str = "corner",
    store_dtype: str = "float32",
) -> SpectralData:
    """Precompute the reusable data spectrum — ≈ ``cudaFFTData(data, Kh,
    Kw)``: FFT dims ``policy(data + maxK − 1)`` (default 'fast').

    ``padding``: 'zero' (padData) or 'clamp', the reference's three-region
    border-replicate rule (padDataClampToBorder, ``ops/padding.py``), so
    that 'same' edge outputs see replicated pixels on every edge. Its
    far-edge band is the kernels' 'same'-window anchor: (K−1)//2 for
    ``same_offset='scipy'``, K//2 for 'matlab' or for
    ``kernel_layout='centered'`` (a centered kernel's anchor is its roll
    shift). The band is recorded on the result (``clamp``, ``band_h``,
    ``band_w``), and the 'same' trim checks it against the kernels. Pair
    clamp spectra with mode 'same', 'fftmap' or 'valid'.

    ``store_dtype='bfloat16'``: the transform runs in float32 and the
    planes are stored bf16 (the serving tier; pair with
    ``fft_kernels(..., store_dtype='bfloat16')``)."""
    validate(max_kernel_h >= 1 and max_kernel_w >= 1, "kernel dims must be >= 1")
    _check_padding_layout(padding, kernel_layout)
    validate(
        same_offset in ("scipy", "matlab"),
        "same_offset must be 'scipy' or 'matlab'",
    )
    store_t = _resolve_store_dtype(store_dtype)
    policy = _resolve_policy(policy)
    data_cf, batched = _data_to_cfirst(data, device)
    b, f, h, w = data_cf.shape
    fft_h, fft_w = compute_fft_size(h, w, max_kernel_h, max_kernel_w, policy)
    clamp = padding == "clamp"
    band_h = band_w = -1
    if clamp:
        if kernel_layout == "centered" or same_offset == "matlab":
            band_h, band_w = max_kernel_h // 2, max_kernel_w // 2
        else:
            band_h, band_w = (max_kernel_h - 1) // 2, (max_kernel_w - 1) // 2
        data_cf = pad_clamp_to_border(
            data_cf.to(torch.float32), fft_h, fft_w, band_h, band_w
        )
    re, im = rfft2_padded_planes(data_cf, fft_h, fft_w)
    re, im = re.to(store_t), im.to(store_t)
    if not batched:
        re, im = re[0], im[0]
    return SpectralData(
        re=re, im=im, fft_h=fft_h, fft_w=fft_w, data_h=h, data_w=w,
        clamp=clamp, band_h=band_h, band_w=band_w,
    )


def _baked_window(
    h: int, w: int, tkh: int, tkw: int, trim_mode: str, policy,
    same_offset: str = "scipy",
) -> tuple[int, int, int | None, int | None]:
    """The output window ``fft_data_tiled`` bakes into block spectra of an
    (h, w) image for kernels of (tkh, tkw) → (origin_h, origin_w, win_h,
    win_w); win None is the 'full' extent."""
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
    return origin_h, origin_w, win_h, win_w


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
        plan = choose_block_plan(
            h, w, max_kernel_h, max_kernel_w, feature_dim=f,
            store_dtype=store_dtype, device=data_cf.device,
        )
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
    origin_h, origin_w, win_h, win_w = _baked_window(
        h, w, tkh, tkw, trim_mode, policy, same_offset
    )
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
    storage: str = "auto",
    store_dtype: str = "float32",
) -> SpectralKernels:
    """Precompute a kernel bank's spectra at a fixed FFT size — planar
    planes, float32 or, with ``store_dtype='bfloat16'``, transformed in
    float32 and stored bf16 (the serving tier; pair with bf16 data
    spectra). Pass explicit (fft_h, fft_w) or the spectra the bank will be
    used against (their block size for ``TiledSpectralData``); the bank
    then lands on the spectra's device unless ``device`` is given.
    ``correlation=True`` flips each kernel spatially first.

    ``kernel_layout='centered'`` wraps each kernel's own centre to the
    origin (padKernel, ``ops/padding.py pad_kernel_centered``; ragged banks
    centre each kernel at its own size), so maps come out un-shifted:
    centered banks serve mode 'fftmap' and 'same' on the direct engine, and
    take pre-flipped kernels (``correlation=True`` is an error).

    ``storage``: 'auto', 'planar' or 'flat', with the JAX package's checks
    (flat banks are corner-anchored and serve the direct engine). The JAX
    package packs a flat bank to escape the TPU's (8, 128) tile padding; a
    CUDA tensor has none, so the port stores every bank planar and
    ``SpectralKernels.flat`` is False.

    A bank whose transform would not fit the device budget beside its
    stored spectra is padded and transformed a chunk of kernels at a time,
    into preallocated planes, so the padded float32 bank never exists
    whole."""
    store_t = _resolve_store_dtype(store_dtype)
    _check_padding_layout("zero", kernel_layout)
    validate(
        storage in ("auto", "planar", "flat"),
        "storage must be 'auto', 'planar', or 'flat'",
    )
    centered = kernel_layout == "centered"
    validate(
        not (centered and storage == "flat"),
        "storage='flat' serves corner-anchored banks only",
    )
    _check_centered_correlation(centered, correlation)
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
    _check_fits_fft(khs, kws, fft_h, fft_w)
    validate(
        not (isinstance(spectral, TiledSpectralData) and storage == "flat"),
        "storage='flat' serves the direct engine; tiled block spectra "
        "take planar banks",
    )
    kstack = _apply_correlation_flip(kstack, khs, kws, correlation)
    return _bank_from_stack(kstack, khs, kws, fft_h, fft_w, centered, store_t)


def _transform_bank_chunk(kstack, khs, kws, fft_h, fft_w, centered):
    """(n, F, Kh, Kw) → float32 (re, im) planes (n, F, fft_h, Wc); centered
    banks roll each kernel's own centre to the origin."""
    if not centered:
        return rfft2_padded_planes(kstack, fft_h, fft_w)
    kstack = kstack.to(torch.float32)
    if len(set(khs)) == 1 and len(set(kws)) == 1:
        # one size in this chunk (the stack may be padded to a larger bank's)
        padded = pad_kernel_centered(kstack[..., : khs[0], : kws[0]], fft_h, fft_w)
    else:
        padded = torch.stack([
            pad_kernel_centered(k[:, :kh, :kw], fft_h, fft_w)
            for k, kh, kw in zip(kstack, khs, kws)
        ])
    return rfft2_padded_planes(padded, fft_h, fft_w)


def _bank_from_stack(
    kstack, khs, kws, fft_h, fft_w, centered: bool, store_t: torch.dtype,
) -> SpectralKernels:
    """A stacked (N, F, Kh, Kw) bank, correlation flip applied, → its
    ``SpectralKernels``. The transform runs a chunk of kernels at a time
    when the whole bank's transform temporaries exceed a quarter of the
    budget left beside the stored spectra and the spatial bank
    (``runtime/planner.py plan_transform``); each chunk is written into
    the preallocated planes."""
    n, f = int(kstack.shape[0]), int(kstack.shape[1])
    step = plan_transform(
        n, f, fft_h, fft_w,
        hbm_budget_bytes=_device_memory_budget(kstack.device),
        store_bytes=store_t.itemsize,
        stack_bytes=kstack.numel() * kstack.element_size(),
    ).chunk_size
    if step >= n:
        re, im = _transform_bank_chunk(kstack, khs, kws, fft_h, fft_w, centered)
        re, im = re.to(store_t), im.to(store_t)
    else:
        shape = (n, f, fft_h, fft_w // 2 + 1)
        re = torch.empty(shape, dtype=store_t, device=kstack.device)
        im = torch.empty_like(re)
        for s in range(0, n, step):
            e = min(s + step, n)
            c_re, c_im = _transform_bank_chunk(
                kstack[s:e], khs[s:e], kws[s:e], fft_h, fft_w, centered
            )
            re[s:e].copy_(c_re)
            im[s:e].copy_(c_im)
            del c_re, c_im
    return SpectralKernels(
        re=re, im=im, fft_h=fft_h, fft_w=fft_w, kernel_hs=khs, kernel_ws=kws,
        centered=centered,
    )


def _trim(
    maps: torch.Tensor,  # (B, N, H', W')
    spectral: SpectralData | TiledSpectralData,
    khs: tuple[int, ...],
    kws: tuple[int, ...],
    mode: str,
    batched: bool,
    same_offset: str = "scipy",
    centered: bool = False,
):
    """Slice the maps down to the requested window.

    'fftmap' → raw maps. 'full' → top-left (H+Kh−1)×(W+Kw−1); 'same' →
    H×W at offset ``same_offset`` ('scipy' (Kh−1)//2, 'matlab' Kh//2);
    'valid' → (H−Kh+1)×(W−Kw+1) at (Kh−1, Kw−1). Window coordinates are
    'full'-window indices, shifted by the origin baked into tiled spectra.
    ``centered`` (a kernel_layout='centered' bank) → un-shifted maps:
    'same' is the top-left H×W, and 'full'/'valid' are errors. Clamp
    spectra's band is checked against each kernel's 'same' anchor before
    any window is taken. Ragged banks return a list for modes whose window
    depends on the kernel size."""
    h, w = spectral.data_h, spectral.data_w
    if mode == "fftmap":
        return maps if batched else maps[0]
    validate(
        same_offset in ("scipy", "matlab"),
        "same_offset must be 'scipy' or 'matlab'",
    )
    validate(
        not centered or mode == "same",
        "kernel_layout='centered' spectra support mode 'fftmap' or 'same' "
        "only (the 'full'/'valid' windows wrap circularly for centered "
        "anchors — use the default corner layout)",
    )
    if mode == "same" and getattr(spectral, "clamp", False) and spectral.band_h >= 0:
        # A bottom/right output taps rows up to D−1+anchor, which must be
        # far-edge replicas (pad rows [D, D+band)); a top/left output's
        # negative taps wrap to the last K−1−anchor rows, which must be
        # row-0 replicas (pad rows >= D+band). A kernel whose anchor the
        # band cannot serve would read the wrong replicas: refuse it
        # (src/convolutionFFTkernel.cu:65-74).
        for kh, kw in zip(khs, kws):
            for kk, band, fft_l, d_l, ax in (
                (kh, spectral.band_h, spectral.fft_h, h, "H"),
                (kw, spectral.band_w, spectral.fft_w, w, "W"),
            ):
                anchor = (
                    kk // 2
                    if (centered or same_offset == "matlab")
                    else (kk - 1) // 2
                )
                validate(
                    anchor <= band <= fft_l - d_l - (kk - 1 - anchor),
                    f"padding='clamp' band mismatch on the {ax} axis: the "
                    f"spectra's far-edge band ({band}) does not serve a "
                    f"'same' window anchored at {anchor} (kernel {kk}, "
                    f"{'centered' if centered else same_offset} anchor). "
                    "Recompute fft_data(padding='clamp') with the same "
                    "same_offset/kernel_layout and max_kernel dims as "
                    "this call",
                )
    ragged = len(set(khs)) > 1 or len(set(kws)) > 1
    org_h = getattr(spectral, "origin_h", 0)
    org_w = getattr(spectral, "origin_w", 0)
    avail_h, avail_w = maps.shape[-2], maps.shape[-1]

    def window(kh, kw):
        if centered:  # un-shifted maps: 'same' = top-left H×W
            r = (0, 0, h, w)
        elif mode == "full":
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
    _check_tier(sk, spectral)


def _check_direct_bank(sk: SpectralKernels, spectral: SpectralData) -> None:
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


def _check_tiled_canvas(spectral: TiledSpectralData, mode: str) -> None:
    validate(
        mode != "fftmap" or spectral.fftmap_canvas,
        "mode='fftmap' (raw circular maps) needs spectra with the FFT "
        "canvas baked in — precompute with fft_data_tiled("
        "trim_mode='fftmap') or use the direct engine",
    )


def _check_tiled_bank(sk: SpectralKernels, spectral: TiledSpectralData, mode: str) -> None:
    """A bank's fit to tiled spectra: corner-anchored, at the block FFT
    dims, within the planned kernel envelope and, for 'fftmap', within the
    baked canvas (the single-device and the sharded tiled engines, after
    ``_check_tiled_canvas``)."""
    validate(not sk.centered, _CENTERED_TILED_MSG)
    validate(
        sk.fft_h == spectral.block_h and sk.fft_w == spectral.block_w,
        f"SpectralKernels FFT dims ({sk.fft_h},{sk.fft_w}) != block dims "
        f"({spectral.block_h},{spectral.block_w})",
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


def _check_not_aliased(spectral: SpectralData, khs, kws, mode: str) -> None:
    """Linear windows need FFT dims covering data + kernel − 1; a larger
    kernel would return circularly aliased maps."""
    if mode == "fftmap":
        return
    validate(
        spectral.data_h + max(khs) - 1 <= spectral.fft_h
        and spectral.data_w + max(kws) - 1 <= spectral.fft_w,
        f"kernel ({max(khs)},{max(kws)}) too large for "
        f"linear convolution at FFT dims ({spectral.fft_h},"
        f"{spectral.fft_w}) with data ({spectral.data_h},"
        f"{spectral.data_w}): output would be circularly aliased. "
        "Recompute fft_data with larger max_kernel dims, or use "
        "mode='fftmap' for raw circular maps",
    )


def _batched_planes(spectral):
    if spectral.batched:
        return spectral.re, spectral.im
    return spectral.re[None], spectral.im[None]


def direct_bank_plan(
    spectral: SpectralData,
    n_kernels: int,
    *,
    raw_corner: bool = False,
    store_bytes: int | None = None,
    stack_bytes: int = 0,
) -> tuple[str, BankPlan]:
    """How ``conv_spectral`` runs a bank of ``n_kernels`` against direct
    ``spectral`` on its device's budget → (route, plan). A raw corner bank
    (``raw_corner``, its spatial kernels taking ``stack_bytes``) whose
    spectra would take over half the budget is 'streamed'
    (``plan_streaming``); any other bank is 'resident' when ``plan_bank``
    holds it whole, else 'chunked'. ``store_bytes`` is the bank spectra's
    element size (default the data's)."""
    budget = _device_memory_budget(spectral.re.device)
    store = spectral.re.element_size() if store_bytes is None else store_bytes
    dims = (n_kernels, spectral.feature_dim, spectral.fft_h, spectral.fft_w)
    batch = _batched_planes(spectral)[0].shape[0]
    if raw_corner and n_kernels > 1 and spectra_bytes(*dims, store) > budget // 2:
        return "streamed", plan_streaming(
            *dims, batch=batch, hbm_budget_bytes=budget, store_bytes=store,
            stack_bytes=stack_bytes,
        )
    plan = plan_bank(*dims, batch=batch, hbm_budget_bytes=budget, store_bytes=store)
    return ("resident" if plan.chunk_size >= n_kernels else "chunked"), plan


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
    ``kernel_layout='centered'`` transforms raw kernels centered (see
    ``fft_kernels``; direct engine, modes 'fftmap' and 'same').

    The direct engine plans its memory (``runtime/planner.py plan_bank``):
    a bank whose products and maps do not fit the device budget runs in
    chunks of kernels, and a raw corner bank whose spectra would take over
    half the budget is never held as spectra — each chunk of spatial
    kernels is transformed, multiplied and inverted in turn. A device
    out-of-memory error is re-raised as ``MemoryError`` naming the plan.

    bf16 spectra (the serving tier) take a bank of the same tier: raw
    kernels are transformed at it, and a ``SpectralKernels`` of the other
    tier is an error. On the direct engine their products are stored bf16
    and the inverse runs on them upcast to float32; the maps are float32.
    ``out_dtype='bfloat16'`` stores the maps bf16 (in the kernel on the
    fused tiled branch)."""
    validate(mode in _MODES, f"mode must be one of {_MODES}")
    out_t = _resolve_out_dtype(out_dtype)
    _check_padding_layout("zero", kernel_layout)
    _check_clamp_mode(spectral, mode)
    if isinstance(spectral, TiledSpectralData):
        validate(
            kernel_layout == "corner"
            and not (isinstance(kernels, SpectralKernels) and kernels.centered),
            _CENTERED_TILED_MSG,
        )
        return _conv_spectral_tiled(
            spectral, kernels, mode=mode, correlation=correlation,
            same_offset=same_offset, out_dtype=out_t,
        )
    if isinstance(kernels, SpectralKernels):
        sk = kernels
        _check_direct_bank(sk, spectral)
        _check_bank(sk, spectral, correlation)
        route, plan = direct_bank_plan(
            spectral, sk.num_kernels, store_bytes=sk.re.element_size()
        )
    else:
        kstack, khs, kws = _kernels_to_stack(
            kernels, spectral.feature_dim, spectral.re.device
        )
        _check_fits_fft(khs, kws, spectral.fft_h, spectral.fft_w)
        kstack = _apply_correlation_flip(kstack, khs, kws, correlation)
        route, plan = direct_bank_plan(
            spectral, int(kstack.shape[0]), raw_corner=kernel_layout == "corner",
            stack_bytes=kstack.numel() * kstack.element_size(),
        )
        if route == "streamed":
            return _conv_spectral_streaming_spatial(
                spectral, kstack, khs, kws, plan, mode=mode,
                same_offset=same_offset, out_dtype=out_t,
            )
        centered = kernel_layout == "centered"
        _check_centered_correlation(centered, correlation)
        sk = _bank_from_stack(
            kstack, khs, kws, spectral.fft_h, spectral.fft_w, centered,
            spectral.re.dtype,
        )
    _check_not_aliased(spectral, sk.kernel_hs, sk.kernel_ws, mode)
    d_re, d_im = _batched_planes(spectral)
    try:
        if route == "chunked":
            maps = _conv_from_spectra_chunked(
                d_re, d_im, sk.re, sk.im, spectral.fft_h, spectral.fft_w,
                plan.chunk_size, out_t,
            )
        else:
            maps = _conv_from_spectra(
                d_re, d_im, sk.re, sk.im, spectral.fft_h, spectral.fft_w,
            ).to(out_t)
    except torch.OutOfMemoryError as exc:
        raise MemoryError(_out_of_memory_message(exc, plan)) from exc
    return _trim(
        maps, spectral, sk.kernel_hs, sk.kernel_ws, mode, spectral.batched,
        same_offset=same_offset, centered=sk.centered,
    )


def _out_of_memory_message(exc: Exception, plan: BankPlan) -> str:
    return (
        f"{exc}\n[cuda_fft_convolution_torch] the bank plan "
        f"(chunk_size={plan.chunk_size}, est. peak "
        f"{plan.peak_bytes >> 20} MiB) exceeded device memory — lower "
        "Config.hbm_budget_bytes or hbm_fraction (FFTCONV_HBM_BUDGET_BYTES, "
        "FFTCONV_HBM_FRACTION) to plan smaller chunks, or pass "
        "conv_spectral_pipelined(chunk_size=...)"
    )


def _products_like(d_re, p_re, p_im):
    """The bf16 serving tier stores its products bf16, as the JAX package
    does (the MAC accumulated float32); float32 spectra keep float32
    products."""
    if d_re.dtype == torch.bfloat16:
        return p_re.to(torch.bfloat16), p_im.to(torch.bfloat16)
    return p_re, p_im


def _conv_from_spectra(d_re, d_im, k_re, k_im, fft_h, fft_w) -> torch.Tensor:
    """The MAC kernel over the bank, then one C2R inverse per (image,
    kernel) → float32 maps (B, N, fft_h, fft_w), normalized by
    1/(fft_h·fft_w). The products are released before the inverse runs,
    so the pass peaks at the complex input, the C2R transform's copy and
    the maps."""
    p_re, p_im = _products_like(
        d_re, *spectral_mac_auto_planes(d_re, d_im, k_re, k_im)
    )
    spec = torch.complex(p_re.to(torch.float32), p_im.to(torch.float32))
    del p_re, p_im
    return torch.fft.irfft2(spec, s=(fft_h, fft_w))


def _conv_from_spectra_chunked(
    d_re, d_im, k_re, k_im, fft_h, fft_w, chunk_size: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``_conv_from_spectra`` a chunk of ``chunk_size`` kernels at a time
    (≈ the streams variant's round-robin, src/cudaConvFFTDataStreams.cu:
    338-469), each chunk written into the preallocated (B, N, fft_h,
    fft_w) maps in ``out_dtype``: the peak is the maps plus one chunk's
    temporaries. Bank slices along N are views; the last chunk is the
    shorter remainder."""
    n = k_re.shape[0]
    out = torch.empty(
        (d_re.shape[0], n, fft_h, fft_w), dtype=out_dtype, device=d_re.device
    )
    for s in range(0, n, chunk_size):
        e = min(s + chunk_size, n)
        out[:, s:e] = _conv_from_spectra(
            d_re, d_im, k_re[s:e], k_im[s:e], fft_h, fft_w
        )
    return out


def _conv_from_spatial_chunked(
    d_re, d_im, kstack, fft_h, fft_w, chunk_size: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The streaming-spatial pipeline: kernel spectra are never resident.
    Each chunk of spatial kernels (N, F, Kh, Kw) is transformed in float32,
    multiplied against the data by the MAC kernel and inverted into the
    preallocated maps — the reference's own regime (src/cudaConvFFTData.cu:
    191-282). The kernel chunks are not rounded to the tier: bf16 data
    planes are upcast to float32 once, giving the float32 product the JAX
    package's mixed-dtype MAC gives; the products stay float32."""
    d_re, d_im = d_re.to(torch.float32), d_im.to(torch.float32)
    n = kstack.shape[0]
    out = torch.empty(
        (d_re.shape[0], n, fft_h, fft_w), dtype=out_dtype, device=d_re.device
    )
    for s in range(0, n, chunk_size):
        e = min(s + chunk_size, n)
        k_re, k_im = rfft2_padded_planes(kstack[s:e], fft_h, fft_w)
        out[:, s:e] = _conv_from_spectra(d_re, d_im, k_re, k_im, fft_h, fft_w)
        del k_re, k_im
    return out


def _conv_spectral_streaming_spatial(
    spectral: SpectralData,
    kstack: torch.Tensor,  # (N, F, Kh, Kw) spatial, correlation flip applied
    khs: tuple,
    kws: tuple,
    plan: BankPlan,
    *,
    mode: str,
    same_offset: str = "scipy",
    out_dtype: torch.dtype = torch.float32,
):
    """conv_spectral for a bank too large to hold as resident spectra: the
    chunked on-the-fly transform, MAC and inverse, in chunks of
    ``plan.chunk_size`` (``direct_bank_plan``'s 'streamed' plan)."""
    _check_not_aliased(spectral, khs, kws, mode)
    d_re, d_im = _batched_planes(spectral)
    try:
        maps = _conv_from_spatial_chunked(
            d_re, d_im, kstack, spectral.fft_h, spectral.fft_w,
            plan.chunk_size, out_dtype,
        )
    except torch.OutOfMemoryError as exc:
        raise MemoryError(_out_of_memory_message(exc, plan)) from exc
    return _trim(
        maps, spectral, khs, kws, mode, spectral.batched, same_offset=same_offset
    )


def _conv_spectral_tiled(
    spectral: TiledSpectralData,
    kernels,
    *,
    mode: str,
    correlation: bool,
    same_offset: str = "scipy",
    out_dtype: torch.dtype = torch.float32,
    chunk_size: int | None = None,
):
    """Overlap-save bank convolution against precomputed block spectra,
    maps in ``out_dtype``, ``chunk_size`` kernels at a time (None: the
    tiled memory model, ``_tiled_chunk_size``)."""
    _check_tiled_canvas(spectral, mode)
    if isinstance(kernels, SpectralKernels):
        sk = kernels
        _check_bank(sk, spectral, correlation)
    else:
        sk = fft_kernels(
            kernels, spectral=spectral, correlation=correlation,
            store_dtype=_store_dtype_of(spectral),
        )
    _check_tiled_bank(sk, spectral, mode)
    d_re, d_im = _batched_planes(spectral)
    if chunk_size is None:
        chunk_size = _tiled_chunk_size(spectral, d_re, sk.num_kernels)
    maps = _tiled_chunked_maps(spectral, d_re, d_im, sk, chunk_size, out_dtype)
    return _trim(
        maps, spectral, sk.kernel_hs, sk.kernel_ws, mode, spectral.batched,
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
    when the whole bank fits), maps in ``out_dtype``; chunks are written
    into the preallocated maps, so the peak is the maps plus one chunk."""
    n = sk.num_kernels
    geom = (
        spectral.block_h, spectral.block_w, spectral.max_kh, spectral.max_kw,
        spectral.out_h, spectral.out_w,
    )
    if chunk_size >= n:
        return conv_blocks(d_re, d_im, sk.re, sk.im, *geom, out_dtype)
    out = torch.empty(
        (d_re.shape[0], n, spectral.out_h, spectral.out_w), dtype=out_dtype,
        device=d_re.device,
    )
    for s in range(0, n, chunk_size):
        e = min(s + chunk_size, n)
        out[:, s:e] = conv_blocks(d_re, d_im, sk.re[s:e], sk.im[s:e], *geom, out_dtype)
    return out


def conv_spectral_pipelined(
    spectral: SpectralData | TiledSpectralData,
    kernels,
    *,
    chunk_size: int | None = None,
    mode: str = "fftmap",
    correlation: bool = False,
    use_pallas: bool | None = None,
    same_offset: str = "scipy",
    out_dtype: str | None = None,
):
    """Memory-bounded bank convolution — ≈ ``cudaConvFFTDataStreams``
    (src/cudaConvFFTDataStreams.cu): the bank runs ``chunk_size`` kernels at
    a time, on direct spectra (``SpectralData``: the MAC kernel and one
    inverse per kernel, chunks written into the preallocated maps) or on
    overlap-save block spectra (``TiledSpectralData``: the fused block-conv
    a chunk at a time). The maps equal ``conv_spectral``'s.

    ``chunk_size=None`` takes ``Config.chunk_size`` (``FFTCONV_CHUNK``), and
    when that is None too the planner sizes the chunks from the device
    budget (``runtime/planner.py plan_bank`` — the decision the reference
    hard-codes as 2 slots). ``use_pallas`` is accepted with no effect, as
    in ``conv_spectral``."""
    validate(mode in _MODES, f"mode must be one of {_MODES}")
    out_t = _resolve_out_dtype(out_dtype)
    _check_clamp_mode(spectral, mode)
    tiled = isinstance(spectral, TiledSpectralData)
    if isinstance(kernels, SpectralKernels):
        sk = kernels
        _check_bank(sk, spectral, correlation)
    else:
        sk = fft_kernels(
            kernels, spectral=spectral, correlation=correlation,
            store_dtype=_store_dtype_of(spectral),
        )
    if chunk_size is None:
        chunk_size = get_config().chunk_size
    if chunk_size is None:
        fft_h = spectral.block_h if tiled else spectral.fft_h
        fft_w = spectral.block_w if tiled else spectral.fft_w
        batch = spectral.re.shape[0] if spectral.batched else 1
        if tiled:
            batch *= np_prod_blocks(spectral)
        chunk_size = plan_bank(
            sk.num_kernels, spectral.feature_dim, fft_h, fft_w, batch=batch,
            hbm_budget_bytes=_device_memory_budget(spectral.re.device),
            store_bytes=sk.re.element_size(),
        ).chunk_size
    validate(chunk_size >= 1, "chunk_size must be >= 1")
    chunk_size = min(chunk_size, sk.num_kernels)
    if tiled:
        return _conv_spectral_tiled(
            spectral, sk, mode=mode, correlation=False,
            same_offset=same_offset, out_dtype=out_t, chunk_size=chunk_size,
        )
    _check_direct_bank(sk, spectral)
    _check_not_aliased(spectral, sk.kernel_hs, sk.kernel_ws, mode)
    d_re, d_im = _batched_planes(spectral)
    maps = _conv_from_spectra_chunked(
        d_re, d_im, sk.re, sk.im, spectral.fft_h, spectral.fft_w, chunk_size,
        out_t,
    )
    return _trim(
        maps, spectral, sk.kernel_hs, sk.kernel_ws, mode, spectral.batched,
        same_offset=same_offset, centered=sk.centered,
    )


def np_prod_blocks(spectral: TiledSpectralData) -> int:
    """The number of overlap-save blocks of one image (nbh · nbw)."""
    shape = spectral.re.shape
    return int(shape[-5] * shape[-4])


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

    ``padding='clamp'`` replicates edge pixels through the pad (see
    ``fft_data``) and pairs with mode 'same', 'fftmap' or 'valid';
    ``kernel_layout='centered'`` wraps kernel centres to the origin for
    un-shifted maps (see ``fft_kernels``); both run on the direct engine
    (``algorithm='tiled'`` with them is an error). ``same_offset='matlab'``
    takes MATLAB conv2's Kh//2 'same' offset (scipy's is (Kh−1)//2).

    A ragged cell list whose kernels span pow-2 size envelopes (the
    reference demo's scenario, demoCudaConvolutionFFT.m:41-43) is bucketed
    by envelope for linear modes (``bucket_ragged=True``): each bucket runs
    its own ``fft_conv`` at its own FFT or block size, and the maps come
    back in input order. ``use_pallas`` as in ``conv_spectral``.
    ``store_dtype='bfloat16'`` runs every spectrum at the bf16 serving tier
    (see ``fft_data``); ``out_dtype='bfloat16'`` stores the maps bf16 (see
    ``conv_spectral``); the two compose."""
    validate(kernels is not None, "kernels is required")
    validate(mode in _MODES, f"mode must be one of {_MODES}")
    _resolve_out_dtype(out_dtype)
    _resolve_store_dtype(store_dtype)
    validate(
        algorithm in ("auto", "direct", "tiled"),
        "algorithm must be 'auto', 'direct', or 'tiled'",
    )
    _check_padding_layout(padding, kernel_layout)
    if padding == "clamp" or kernel_layout == "centered":
        validate(
            algorithm != "tiled",
            "padding='clamp' / kernel_layout='centered' require the direct "
            "engine (algorithm='direct' or 'auto')",
        )
        algorithm = "direct"
    validate(
        padding != "clamp" or mode in ("same", "fftmap", "valid"),
        "padding='clamp' pairs with mode 'same', 'fftmap', or 'valid' — a "
        "'full' window mixes the far-edge band with the wrap-to-origin "
        "replicas (the pad regions exist to serve 'same' edge outputs, "
        "src/convolutionFFTkernel.cu:65-74)",
    )
    if (
        bucket_ragged
        and mode != "fftmap"  # fftmap's raw-map shape is FFT-size-defined
        and isinstance(kernels, (list, tuple))
        and len(kernels) > 1
    ):
        buckets = _bucket_ragged(kernels)
        if buckets is not None:
            data = as_tensor(data, device)
            results: list = [None] * len(kernels)
            for idx in buckets:
                sub = [kernels[i] for i in idx]
                out = fft_conv(
                    data, None, None, sub, mode=mode,
                    correlation=correlation, policy=policy,
                    algorithm=algorithm, bucket_ragged=False,
                    padding=padding, kernel_layout=kernel_layout,
                    same_offset=same_offset, store_dtype=store_dtype,
                    out_dtype=out_dtype,
                )
                if not isinstance(out, list):  # a uniform bucket: stacked maps
                    out = [out[..., i, :, :] for i in range(len(sub))]
                for i, o in zip(idx, out):
                    results[i] = o
            return results
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
        run_on = (
            data.device if isinstance(data, torch.Tensor) and device is None
            else resolve_device(device)
        )
        plan = choose_block_plan(
            h, w, max_kernel_h, max_kernel_w, feature_dim=int(dshape[-1]),
            store_dtype=store_dtype, device=run_on,
        )
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
        padding=padding, same_offset=same_offset, kernel_layout=kernel_layout,
        store_dtype=store_dtype,
    )
    return conv_spectral(
        spectral, kernels, mode=mode, correlation=correlation,
        same_offset=same_offset, kernel_layout=kernel_layout,
        out_dtype=out_dtype,
    )
