"""Convolution plans fixed ahead of the calls — the cufftPlanMany analogue.

The port of ``cuda_fft_convolution_tpu/runtime/plan.py``. The reference
builds its cuFFT plans once per call and reuses them across the kernel loop
(src/cudaConvolutionFFT.cu:128-142); a serving system keeps them across
calls. ``FftConvPlan`` fixes the geometry once: the engine, the FFT or
block size, the output window, the tier and an optional detection head.

PyTorch compiles nothing ahead of time, so the counterpart of the JAX
package's ``lower().compile()`` of each stage (data FFT, bank FFT, MAC and
inverse) is a warm-up of the stage: the CUDA library is built and loaded,
the DFT-matrix caches the fused kernel reads are filled (for the synthesis
tier in force: ``ops/block_conv.py fused_splits``), and the stage runs
once on zeros at the planned shapes, so that cuFFT's plan cache holds its
plans. The tier is read at every call, as JAX re-traces on a config
change: a plan built under one tier runs another's entries once the config
names it (filling that tier's matrices at its first call). ``make_plan`` warms all three stages (``compile_now``); with
``lazy=True`` each stage warms at its first use. After that ``execute``
only launches work.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cuda_fft_convolution_torch.ops.conv import (
    irfft2_norm_planes,
    rfft2_padded_planes,
)
from cuda_fft_convolution_torch.ops.spectral_mac import spectral_mac_auto_planes
from cuda_fft_convolution_torch.types import SpectralData
from cuda_fft_convolution_torch.utils.device import as_tensor, resolve_device
from cuda_fft_convolution_torch.utils.errors import validate
from cuda_fft_convolution_torch.utils.fft_size import FftSizePolicy, compute_fft_size

_STAGES = ("_data_fft_exec", "_kernel_fft_exec", "_conv_exec")


class PlaneSpec(NamedTuple):
    """The planned (shape, dtype) of one spectra plane."""

    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class FftConvPlan:
    """Warmed stages for a fixed (data, bank) geometry.

    Produced by ``make_plan``. ``execute(data, kernels)`` takes channel-last
    arrays or tensors of exactly the planned shapes and returns the stacked
    (N, h, w) maps ((B, N, ...) if batched) on the plan's device.
    """

    data_shape: tuple  # (H, W, F) or (B, H, W, F), API layout
    kernel_shape: tuple  # (N, Kh, Kw, F)
    fft_h: int
    fft_w: int
    kfft_aval: PlaneSpec  # each bank-spectra plane: shape and dtype
    device: torch.device
    # The stages once warmed, from ``_warmups`` (three zero-argument
    # warm-ups, each returning its stage): ``compile_now`` forces all three;
    # a lazy plan warms each at first use.
    _warmups: tuple = None
    _data_fft_exec: object = None
    _kernel_fft_exec: object = None
    _conv_exec: object = None
    head: str | None = None  # None (maps) | 'peaks' | 'top_k' | 'local_peaks'
    # The stage functions themselves, for a caller that composes the whole
    # frame (``trace_frame``): data → spectra planes → _conv_fn(d_re, d_im,
    # k_re, k_im) → maps (batched internal layout) or the head's tuple.
    _data_fft_fn: object = None
    _conv_fn: object = None
    # data → the spectra container (SpectralData / TiledSpectralData) at
    # the planned geometry, for ``data_spectra``.
    _spectra_fn: object = None

    def _exec(self, field: str):
        e = getattr(self, field)
        if e is None:
            e = self._warmups[_STAGES.index(field)]()
            object.__setattr__(self, field, e)  # frozen-dataclass cache
        return e

    def compile_now(self) -> "FftConvPlan":
        """Warm all three stages (a no-op for stages already warm); returns
        self. ``make_plan`` calls this unless ``lazy=True``."""
        for field in _STAGES:
            self._exec(field)
        return self

    def _unbatch(self, out):
        if len(self.data_shape) == 4:
            return out
        if self.head is None:
            return out[0]
        return tuple(x[0] for x in out)

    def trace_frame(self, frame: torch.Tensor, kfft):
        """The whole per-frame pipeline at this plan's geometry on a tensor
        already on the plan's device, launched without waiting; returns
        what ``execute_spectral`` returns. The serving streams call this."""
        dfft = self._data_fft_fn(frame)
        return self._unbatch(self._conv_fn(*dfft, *kfft))

    def data_spectra(self, frame: torch.Tensor):
        """The data spectra of a frame on the plan's device as the container
        ``conv_spectral`` and the sharded functions take (``TiledSpectralData``
        on the tiled engine, with the window baked; ``SpectralData`` on the
        direct one), staged as ``data_fft`` stages them."""
        return self._spectra_fn(frame)

    def data_fft(self, data):
        """≈ cudaFFTData: the (re, im) plane pair of the data spectra."""
        return self._exec("_data_fft_exec")(as_tensor(data, self.device))

    def kernel_fft(self, kernels):
        """The (re, im) plane pair of the bank spectra, ``kfft_aval`` each."""
        return self._exec("_kernel_fft_exec")(as_tensor(kernels, self.device))

    def execute(self, data, kernels):
        """≈ cudaConvolutionFFT for the planned geometry."""
        validate(
            tuple(data.shape) == self.data_shape,
            f"data shape {tuple(data.shape)} != planned {self.data_shape}",
        )
        validate(
            tuple(kernels.shape) == self.kernel_shape,
            f"kernel shape {tuple(kernels.shape)} != planned {self.kernel_shape}",
        )
        return self.execute_spectral(self.data_fft(data), self.kernel_fft(kernels))

    def execute_spectral(self, dfft, kfft):
        """≈ cudaConvFFTData: MAC and inverse only (the amortized path) on
        the plane pairs from ``data_fft`` / ``kernel_fft``. With a ``head``
        the plan returns ``(values, positions)`` instead of maps."""
        return self._unbatch(self._exec("_conv_exec")(*dfft, *kfft))


def _head_wrap(conv_fn, head, head_k, head_window, head_threshold):
    """Reduce ``conv_fn``'s (B, N, h, w) maps with the selected detection
    head → ``(values, positions)``; the maps stay a temporary."""
    if head is None:
        return conv_fn
    from cuda_fft_convolution_torch.ops.tiled import (
        local_peaks_from_maps,
        peaks_from_maps,
        top_k_from_maps,
    )

    def _conv_head(d_re, d_im, k_re, k_im):
        maps = conv_fn(d_re, d_im, k_re, k_im)
        if head == "peaks":
            vals, ys, xs = peaks_from_maps(maps)
        elif head == "top_k":
            vals, ys, xs = top_k_from_maps(maps, int(head_k))
        else:
            vals, ys, xs = local_peaks_from_maps(
                maps, int(head_k), int(head_window), head_threshold
            )
        return vals, torch.stack([ys, xs], dim=-1)

    return _conv_head


def _warmed(fn, make_inputs, device: torch.device):
    """A stage's warm-up: run ``fn`` once on ``make_inputs()`` — on a CUDA
    device after loading the kernel library, then synchronised — and
    return it."""
    def build():
        if device.type == "cuda":
            from cuda_fft_convolution_torch._build import library

            library()
        fn(*make_inputs())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return fn

    return build


def make_plan(
    data_shape: tuple,
    kernel_shape: tuple,
    *,
    policy: FftSizePolicy | str = FftSizePolicy.FAST,
    correlation: bool = False,
    use_pallas: bool | None = None,
    algorithm: str = "direct",
    mode: str = "fftmap",
    store_dtype: str = "float32",
    same_offset: str = "scipy",
    out_dtype: str | None = None,
    head: str | None = None,
    head_k: int = 1,
    head_window: int = 3,
    head_threshold: float | None = None,
    lazy: bool = False,
    device=None,
) -> FftConvPlan:
    """Plan channel-last ``data_shape`` ((H, W, F) or (B, H, W, F)) against
    a uniform bank ``kernel_shape`` (N, Kh, Kw, F) on ``device`` (the card
    unless ``device='cpu'``).

    ``algorithm='direct'`` runs one image-sized FFT, the MAC kernel over
    the bank (``spectral_mac_auto_planes``) and one inverse per kernel;
    ``'tiled'`` runs the overlap-save engine (``choose_block_plan`` for
    ``feature_dim`` and ``store_dtype``; the fused block-conv). ``mode``
    fixes the output window: 'fftmap' is the direct engine's FFT canvas
    (raw circular maps; the tiled engine bakes that canvas into its block
    tiling), and 'full'/'same'/'valid' (``same_offset``) are sliced on the
    direct engine and baked into the block tiling on the tiled one.

    ``store_dtype='bfloat16'``: the bf16 serving tier — spectra stored and
    exchanged bf16 (``data_fft``/``kernel_fft`` return bf16 planes), f32
    accumulation, direct products stored bf16. ``out_dtype='bfloat16'``:
    bf16 maps. ``use_pallas`` is accepted with no effect, as in
    ``conv_spectral``.

    ``head``: reduce the maps with a detection head — the plan then returns
    ``(values, positions)``: 'peaks' (N,)/(N, 2); 'top_k' (N, head_k)/
    (N, head_k, 2); 'local_peaks' window-local maxima over ``head_window``
    above ``head_threshold``, fixed at plan time.

    ``lazy=True`` defers each stage's warm-up to its first use
    (``compile_now()`` forces them)."""
    from cuda_fft_convolution_torch import api

    validate(algorithm in ("direct", "tiled"), "algorithm: 'direct'|'tiled'")
    validate(
        mode in ("fftmap", "full", "same", "valid"),
        "mode must be 'fftmap', 'full', 'same', or 'valid'",
    )
    validate(
        same_offset in ("scipy", "matlab"),
        "same_offset must be 'scipy' or 'matlab'",
    )
    validate(
        head in (None, "peaks", "top_k", "local_peaks"),
        f"head must be None, 'peaks', 'top_k' or 'local_peaks'; got {head!r}",
    )
    if head is not None:
        validate(
            mode != "fftmap",
            "detection heads need a linear output window ('full'/'same'/"
            "'valid') — fftmap's circular frame has no meaningful peak "
            "positions",
        )
        validate(int(head_k) >= 1, f"head_k must be >= 1; got {head_k}")
        validate(int(head_window) >= 2, f"head_window must be >= 2; got {head_window}")
    del use_pallas
    out_t = api._resolve_out_dtype(out_dtype)
    store_t = api._resolve_store_dtype(store_dtype)
    dev = resolve_device(device)
    h, w, f = data_shape[-3:]
    n, kh, kw, kf = kernel_shape
    validate(kf == f, f"feature dim mismatch: data {f}, kernels {kf}")
    policy = api._resolve_policy(policy)

    if algorithm == "tiled":
        from cuda_fft_convolution_torch.ops.tiled import (
            choose_block_plan,
            fallback_block_fft,
        )
        from cuda_fft_convolution_torch.types import (
            SpectralKernels,
            TiledSpectralData,
        )

        blk = choose_block_plan(
            h, w, kh, kw, feature_dim=f, store_dtype=store_dtype, device=dev
        )
        if blk is None:
            block_h, block_w = fallback_block_fft(kh, kw)
            pkh, pkw = kh, kw
        else:
            block_h, block_w, pkh, pkw = blk
        # The window is baked into the block tiling, as fft_conv bakes it:
        # the blocks cover the output window only.
        trim = dict(trim_mode=mode, trim_kernel_h=kh, trim_kernel_w=kw,
                    same_offset=same_offset)
        if mode == "fftmap":
            trim["policy"] = policy
        origin_h, origin_w, win_h, win_w = api._baked_window(
            h, w, kh, kw, mode, policy, same_offset
        )
        geom = dict(
            block_h=block_h, block_w=block_w, max_kh=pkh, max_kw=pkw,
            data_h=h, data_w=w, origin_h=origin_h, origin_w=origin_w,
            win_h=win_h, win_w=win_w, fftmap_canvas=mode == "fftmap",
        )

        @torch.no_grad()
        def _spectra(data):
            return api.fft_data_tiled(
                data, pkh, pkw, block_h=block_h, block_w=block_w,
                store_dtype=store_dtype, **trim,
            )

        def _data_fft(data):
            sd = _spectra(data)
            return sd.re, sd.im

        @torch.no_grad()
        def _kernel_fft(kernels):
            sk = api.fft_kernels(
                kernels, fft_h=block_h, fft_w=block_w, correlation=correlation,
                store_dtype=store_dtype, storage="planar",
            )
            return sk.re, sk.im

        @torch.no_grad()
        def _conv(d_re, d_im, k_re, k_im):
            # always batched internally; execute_spectral unwraps
            sd = TiledSpectralData(
                re=d_re if d_re.ndim == 6 else d_re[None],
                im=d_im if d_im.ndim == 6 else d_im[None], **geom,
            )
            sk = SpectralKernels(
                re=k_re, im=k_im, fft_h=block_h, fft_w=block_w,
                kernel_hs=(kh,) * n, kernel_ws=(kw,) * n,
            )
            return api.conv_spectral(
                sd, sk, mode=mode, same_offset=same_offset, out_dtype=out_dtype
            )

        fft_h, fft_w = block_h, block_w
    else:
        fft_h, fft_w = compute_fft_size(h, w, kh, kw, policy)
        # Linear windows are fixed for a uniform bank: the slice offsets
        # follow api._trim.
        if mode == "full":
            win = (0, 0, h + kh - 1, w + kw - 1)
        elif mode == "same":
            off = (kh // 2, kw // 2) if same_offset == "matlab" else (
                (kh - 1) // 2, (kw - 1) // 2
            )
            win = (off[0], off[1], h, w)
        elif mode == "valid":
            validate(
                h >= kh and w >= kw,
                f"mode='valid' needs data >= kernel; got data ({h},{w}), "
                f"kernel ({kh},{kw})",
            )
            win = (kh - 1, kw - 1, h - kh + 1, w - kw + 1)
        else:
            win = None

        @torch.no_grad()
        def _data_fft(data):
            x = data.permute(0, 3, 1, 2) if data.ndim == 4 else data.permute(2, 0, 1)[None]
            re, im = rfft2_padded_planes(x, fft_h, fft_w)
            return re.to(store_t), im.to(store_t)

        @torch.no_grad()
        def _kernel_fft(kernels):
            sk = api.fft_kernels(
                kernels, fft_h, fft_w, correlation=correlation,
                store_dtype=store_dtype, storage="planar",
            )
            return sk.re, sk.im

        def _spectra(data):
            re, im = _data_fft(data)
            if data.ndim == 3:
                re, im = re[0], im[0]
            return SpectralData(re=re, im=im, fft_h=fft_h, fft_w=fft_w, data_h=h, data_w=w)

        @torch.no_grad()
        def _conv(d_re, d_im, k_re, k_im):
            # one whole-bank MAC; the tier stores its products bf16
            p_re, p_im = spectral_mac_auto_planes(d_re, d_im, k_re, k_im)
            p_re, p_im = p_re.to(store_t), p_im.to(store_t)
            maps = irfft2_norm_planes(p_re, p_im, fft_h, fft_w).to(out_t)
            if win is not None:
                r0, c0, rh, rw = win
                maps = maps[:, :, r0 : r0 + rh, c0 : c0 + rw]
            return maps

    kfft_aval = PlaneSpec((n, f, fft_h, fft_w // 2 + 1), store_t)
    conv_fn = torch.no_grad()(
        _head_wrap(_conv, head, head_k, head_window, head_threshold)
    )

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def conv_inputs():
        return (*_data_fft(zeros(data_shape)), zeros(kfft_aval.shape, store_t),
                zeros(kfft_aval.shape, store_t))

    p = FftConvPlan(
        data_shape=tuple(data_shape),
        kernel_shape=tuple(kernel_shape),
        fft_h=fft_h,
        fft_w=fft_w,
        kfft_aval=kfft_aval,
        device=dev,
        _warmups=(
            _warmed(_data_fft, lambda: (zeros(data_shape),), dev),
            _warmed(_kernel_fft, lambda: (zeros(kernel_shape),), dev),
            _warmed(conv_fn, conv_inputs, dev),
        ),
        head=head,
        _data_fft_fn=_data_fft,
        _conv_fn=conv_fn,
        _spectra_fn=_spectra,
    )
    return p if lazy else p.compile_now()
