"""Spectral multiply-accumulate on split planes.

    out[b, n] = Σ_f data[b, f] ⊙ kernel[n, f]      (complex, per pixel)

Two implementations, as in the JAX package
(``cuda_fft_convolution_tpu/ops/spectral_mac.py``):
  - the einsum form, ``spectral_mac_planes`` — the plain version;
  - the MAC kernel, ``spectral_mac`` — the CUDA kernel
    ``csrc/spectral_mac.cu`` (replacing the Pallas ``_mac_kernel`` of
    ``spectral_mac_pallas_planes``) on CUDA tensors, and its plain version
    on CPU tensors.

``spectral_mac_auto_planes``, which every engine calls, always runs the
MAC kernel: it is faster than the einsum on the card, so the JAX package's
``use_pallas`` selection has nothing to choose and is accepted with no
effect. Its gradient is the einsum's VJP, as ``_mac_pallas_ad`` defines
it, and both of its cotangents run through the MAC kernel too.

The complex-facing wrappers of the JAX package keep their names:
``spectral_mac_einsum`` is the plain version on complex spectra;
``spectral_mac_pallas`` and ``spectral_mac_auto`` both run
``spectral_mac_auto_planes`` (the MAC kernel on CUDA tensors) on the
spectra's contiguous float32 planes.

The kernel works on register tiles of TB images × TN filters a thread,
or, where those grids would leave most of the card idle, in its split
form, the channels split across a CTA's warps (``csrc/spectral_mac.cu``):
``mac_tile`` is the rule that picks the form for a call, and
``MAC_TILES`` the set the kernel instantiates.

The bf16 serving tier (bf16 planes) takes the same route: bf16 operands,
float32 accumulation, float32 outputs — the function of the JAX package's
einsum at the tier (its Pallas MAC is f32 only and leaves the tier to the
einsum). The kernel widens each bf16 load to fp32; the plain einsum upcasts
the planes first.
"""

from __future__ import annotations

import collections

import torch

from cuda_fft_convolution_torch.ops.block_conv import (
    count_launch,
    cuda_operands,
    upcast,
)
from cuda_fft_convolution_torch.types import split_planes
from cuda_fft_convolution_torch.utils.errors import InvalidInputError


def spectral_mac_planes(
    dr: torch.Tensor, di: torch.Tensor,  # (B, F, H, Wc)
    kr: torch.Tensor, ki: torch.Tensor,  # (N, F, H, Wc)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, F, H, Wc) × (N, F, H, Wc) → (B, N, H, Wc) split planes, four
    real contractions over F; bf16 planes are upcast to float32 first."""
    dr, di, kr, ki = (upcast(t) for t in (dr, di, kr, ki))

    def e(a, b):
        return torch.einsum("bfhw,nfhw->bnhw", a, b)

    return e(dr, kr) - e(di, ki), e(di, kr) + e(dr, ki)


# The split form: TB = 0, the channels split across the CTA's 8 warps,
# 32 pixels a CTA.
MAC_SPLIT = (0, 8)
# The forms the kernel instantiates (``csrc/spectral_mac.cu``
# FFTCONV_MAC_TILES): the (TB, TN) register tiles and the split form.
MAC_TILES = ((1, 1), (8, 4), MAC_SPLIT)
# Pixels a CTA of the (1, 1) tile (256 threads × 4 pixels).
_ONE_ROW_PIXELS = 1024


def mac_tile(b: int, n: int, f: int, s: int, sms: int) -> tuple[int, int]:
    """The kernel's form for a MAC of B images, N filters, F channels and S
    pixels on a card of ``sms`` SMs. The split form where F ≥ 2 and the
    (1, 1) tile's grid, g = ceil(S / 1024)·B·N CTAs, leaves SMs idle
    (g < ``sms``) and is short beside the channels (g < 10·F − 5): the
    (1, 1) tile's time grows with its F dependent steps a thread, the split
    form's with its CTAs (g × 32), and on the H100 (12 shapes, PERF.md §6)
    the split form won exactly there — MOSSE's respond (3 CTAs of 31
    steps become 66 of at most 4), but not S ≈ 100k at F ≤ 8. Else one
    image keeps the one-row tile (the kernel of before tiles), and a
    batch takes tiles of 8 images × 4 filters, so the kernel operand
    leaves device memory about once."""
    g = -(-s // _ONE_ROW_PIXELS) * b * n
    if f >= 2 and g < sms and g < 10 * f - 5:
        return MAC_SPLIT
    return (1, 1) if b == 1 else (8, 4)


_SMS: dict[int, int] = {}


def sm_count(dev: torch.device) -> int:
    """The SMs of CUDA device ``dev``, read once per device."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def spectral_mac(
    dr: torch.Tensor, di: torch.Tensor,  # (B, F, H, Wc) f32/bf16
    kr: torch.Tensor, ki: torch.Tensor,  # (N, F, H, Wc) f32/bf16
) -> tuple[torch.Tensor, torch.Tensor]:
    """The MAC kernel → (B, N, H, Wc) f32 planes. CPU tensors run
    ``spectral_mac_planes``; CUDA tensors launch the CUDA kernel entry of
    their dtype on the current stream (no synchronisation) in the form
    ``mac_tile`` picks (the C entry refuses a form outside ``MAC_TILES``;
    the wrapper raises on any error) and count the launch
    in ``spectral_mac.launches``, per mode in
    ``spectral_mac.launches_by_mode``, per (mode, B, F, N, H, Wc) in
    ``spectral_mac.launches_by_shape`` and per form in
    ``spectral_mac.launches_by_form``."""
    ops = (dr, di, kr, ki)
    if dr.device.type == "cpu" and di.device.type == kr.device.type == ki.device.type == "cpu":
        return spectral_mac_planes(dr, di, kr, ki)
    dev, tag = cuda_operands("spectral_mac", ops)
    if not (dr.ndim == 4 and kr.ndim == 4 and dr.shape[1:] == kr.shape[1:]):
        raise InvalidInputError(f"spectral_mac takes (B, F, H, Wc) and (N, F, H, Wc) planes; "
                                f"got {tuple(dr.shape)} and {tuple(kr.shape)}")
    b, f, h, wc = dr.shape
    n = kr.shape[0]
    tb, tn = mac_tile(b, n, f, h * wc, sm_count(dev))
    mode, name = _MODES[tag]
    from cuda_fft_convolution_torch._build import library

    entry = getattr(library(), name)
    o_re = torch.empty((b, n, h, wc), dtype=torch.float32, device=dev)
    o_im = torch.empty_like(o_re)
    args = (dr.data_ptr(), di.data_ptr(), kr.data_ptr(), ki.data_ptr(), o_re.data_ptr(),
            o_im.data_ptr(), b, f, n, h * wc, tb, tn, torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = entry(*args)
    else:
        with torch.cuda.device(dev):
            err = entry(*args)
    if err != 0:
        raise RuntimeError(
            f"spectral_mac CUDA kernel launch failed (tile {(tb, tn)}): cudaError {err}")
    count_launch(spectral_mac, mode)
    spectral_mac.launches_by_shape[(mode, b, f, n, h, wc)] += 1
    spectral_mac.launches_by_form[(tb, tn)] += 1
    return o_re, o_im


spectral_mac.launches = 0
spectral_mac.launches_by_mode = collections.Counter()
spectral_mac.launches_by_shape = collections.Counter()
spectral_mac.launches_by_form = collections.Counter()
# dtype tag → (the launch mode, its C entry's name)
_MODES = {tag: (f"spectral_mac_{tag}", f"fftconv_spectral_mac_{tag}") for tag in ("f32", "bf16")}


def _conj_t(re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The conjugate of (re, im) with its two leading axes swapped, as
    contiguous float32 planes (bf16 planes upcast)."""
    re, im = upcast(re), upcast(im)
    return re.transpose(0, 1).contiguous(), im.transpose(0, 1).neg().contiguous()


class _SpectralMac(torch.autograd.Function):
    """Forward: the MAC kernel. Backward: the einsum's VJP
    (``_mac_pallas_ad`` in the JAX package), whose two cotangents are MACs
    themselves, so they run through this Function again (the kernel on
    CUDA tensors):

        dD[b, f] = Σ_n g[b, n] ⊙ conj(K[n, f])  = MAC(g, conj(K)ᵀ)
        dK[n, f] = Σ_b g[b, n] ⊙ conj(D[b, f])  = MAC(gᵀ, conj(D)ᵀ)

    No forward is recomputed, a cotangent no input asks for is not
    computed, and under ``create_graph`` both stay differentiable, so
    higher derivatives work. Gradients of bf16 planes are computed in
    float32 and returned in bf16."""

    @staticmethod
    def forward(ctx, dr, di, kr, ki):
        ctx.save_for_backward(dr, di, kr, ki)
        return spectral_mac(*(p.contiguous() for p in (dr, di, kr, ki)))

    @staticmethod
    def backward(ctx, g_re, g_im):
        dr, di, kr, ki = ctx.saved_tensors
        need_d = any(ctx.needs_input_grad[:2])
        need_k = any(ctx.needs_input_grad[2:])
        grads = [None] * 4
        if need_d:
            grads[:2] = _SpectralMac.apply(g_re, g_im, *_conj_t(kr, ki))
        if need_k:
            grads[2:] = _SpectralMac.apply(
                g_re.transpose(0, 1), g_im.transpose(0, 1), *_conj_t(dr, di))
        planes = (dr, di, kr, ki)
        return tuple(
            g.to(p.dtype) if need else None
            for g, p, need in zip(grads, planes, ctx.needs_input_grad)
        )


def spectral_mac_auto_planes(
    dr: torch.Tensor, di: torch.Tensor,
    kr: torch.Tensor, ki: torch.Tensor,
    *,
    use_pallas: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The MAC through the MAC kernel (its plain version on CPU tensors),
    differentiable: its backward is the einsum's VJP, computed by the same
    kernel (``_SpectralMac``). ``use_pallas`` is the JAX
    package's selection between its einsum and its Pallas kernel, kept for
    the signature; it has no effect here."""
    del use_pallas
    return _SpectralMac.apply(dr, di, kr, ki)


def spectral_mac_einsum(data_fft: torch.Tensor, kernel_fft: torch.Tensor) -> torch.Tensor:
    """Complex-facing form of ``spectral_mac_planes``: (B, F, H, Wc) ×
    (N, F, H, Wc) complex spectra → (B, N, H, Wc) complex64."""
    return torch.complex(*spectral_mac_planes(*split_planes(data_fft),
                                              *split_planes(kernel_fft)))


def spectral_mac_pallas(
    data_fft: torch.Tensor, kernel_fft: torch.Tensor, *, interpret: bool = False
) -> torch.Tensor:
    """The JAX package's Pallas MAC on complex spectra, whose Hopper port
    is the MAC kernel: ``spectral_mac_auto_planes`` on the contiguous
    float32 planes (the kernel on CUDA tensors, the plain version on CPU
    tensors) → (B, N, H, Wc) complex64. ``interpret`` (the Pallas
    interpreter) is kept for the signature and has no effect."""
    del interpret
    return torch.complex(*spectral_mac_auto_planes(*split_planes(data_fft),
                                                   *split_planes(kernel_fft)))


def spectral_mac_auto(
    data_fft: torch.Tensor, kernel_fft: torch.Tensor, *, use_pallas: bool | None = None
) -> torch.Tensor:
    """Complex-facing form of ``spectral_mac_auto_planes`` → (B, N, H, Wc)
    complex64; ``use_pallas`` has no effect, as there."""
    del use_pallas
    return spectral_mac_pallas(data_fft, kernel_fft)
