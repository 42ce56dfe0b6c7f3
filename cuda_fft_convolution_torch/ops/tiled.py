"""Overlap-save tiled FFT convolution.

The image is cut into overlapping blocks of a small FFT size L; each block
is transformed once for the whole bank and every kernel's spectrum is taken
at size L. Each block's circular convolution is the linear convolution in
its last V = L − K + 1 rows/cols (classic overlap-save); the wrapped band
is discarded and the valid windows are laid edge to edge.

Two engines assemble the maps from block and bank spectra:
  - fused: ``ops/block_conv.py`` ``block_conv`` — the Hopper kernel (its
    plain version on the CPU) does MAC, windowed inverse DFTs and the
    clipped write in one pass;
  - unfused: spectral MAC, then ``torch.fft.irfft2`` per block, then the
    valid-window slice and reassembly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cuda_fft_convolution_torch.ops.block_conv import (
    SMEM_LIMIT_BYTES,
    block_conv,
    smem_bytes,
)
from cuda_fft_convolution_torch.ops.conv import (
    irfft2_norm_planes,
    rfft2_padded_planes,
)
from cuda_fft_convolution_torch.ops.spectral_mac import spectral_mac_auto_planes
from cuda_fft_convolution_torch.utils.config import get_config
from cuda_fft_convolution_torch.utils.fft_size import next_fast_len


def choose_block_plan(
    data_h: int, data_w: int, max_kh: int, max_kw: int,
    *, min_ratio: int | None = None, max_block: int = 1024,
    matmul_engine: bool | None = None,
) -> tuple[int, int, int, int] | None:
    """The overlap-save plan (block_h, block_w, plan_kh, plan_kw), or None
    when tiling will not pay. The port's analytic branches never enlarge
    the kernel envelope, so (plan_kh, plan_kw) = (max_kh, max_kw)."""
    return choose_block_fft(
        data_h, data_w, max_kh, max_kw, min_ratio=min_ratio,
        max_block=max_block, matmul_engine=matmul_engine, _with_plan=True,
    )


def choose_block_fft(
    data_h: int, data_w: int, max_kh: int, max_kw: int,
    *, min_ratio: int | None = None, max_block: int = 1024,
    matmul_engine: bool | None = None, _with_plan: bool = False,
) -> tuple | None:
    """Pick the overlap-save block FFT size, or None when tiling won't pay.

    The analytic rules of the JAX package's ``choose_block_fft``, without
    its table of geometries measured on a TPU v5e (not ported: a Hopper
    table has to be measured on Hopper).

    ``matmul_engine`` selects the branch. True (the default, None) is the
    dense-DFT branch: the fused kernel's windowed inverse DFTs cost per
    output pixel what a dense DFT costs, so blocks are small — the valid
    window V = L − K + 1 is rounded up to (8, 128) multiples, ≈ K tall
    and ≈ 6K wide. False is the FFT branch: 5-smooth blocks ≈ 8K, whose
    cost per pixel grows only with log L."""
    if matmul_engine is None:
        matmul_engine = True
    if matmul_engine:
        ratio_h = 1 if min_ratio is None else min_ratio
        ratio_w = 6 if min_ratio is None else 2 * min_ratio
        vh = max(-(-(ratio_h * (max_kh - 1)) // 8) * 8, 8)
        vw = max(-(-(ratio_w * (max_kw - 1)) // 128) * 128, 128)
        lh = min(vh + max_kh - 1, max_block)
        lw = min(vw + max_kw - 1, max_block)
        # Decline when the overlap redundancy gets extreme (>~2x per axis).
        if lh < 2 * (max_kh - 1) or lw < 2 * (max_kw - 1):
            return None
    else:
        if min_ratio is None:
            min_ratio = 8
        lh = next_fast_len(min(max(min_ratio * max_kh, 128), max_block))
        lw = next_fast_len(min(max(min_ratio * max_kw, 128), max_block))
        # Decline when the block can't be ≥4× the kernel pad.
        if lh < 4 * (max_kh - 1) or lw < 4 * (max_kw - 1):
            return None
    # Decline when the image is small enough that one big FFT is comparable.
    if data_h + max_kh - 1 <= 2 * lh and data_w + max_kw - 1 <= 2 * lw:
        return None
    return (lh, lw, max_kh, max_kw) if _with_plan else (lh, lw)


def fallback_block_fft(max_kh: int, max_kw: int) -> tuple[int, int]:
    """Smallest sane block when the caller forces tiling against the
    planner's advice: 4× the kernel pad, 5-smooth, ≥32."""
    return (
        next_fast_len(max(4 * (max_kh - 1), 32)),
        next_fast_len(max(4 * (max_kw - 1), 32)),
    )


def fft_data_blocks(
    data_cf: torch.Tensor,  # (B, F, H, W)
    block_h: int,
    block_w: int,
    kh: int,
    kw: int,
    origin_h: int = 0,
    origin_w: int = 0,
    win_h: int | None = None,
    win_w: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Block spectra (B, nbh, nbw, F, block_h, block_w//2+1) split (re, im)
    f32 planes.

    Blocks start every V = L−K+1 output rows/cols; block g covers padded
    input rows [g·V, g·V+L) where the input carries K−1 leading zeros (the
    overlap-save prehistory) and trailing zeros to fill the last block.
    ``origin_h/origin_w`` shift the tiling so output row/col 0 is 'full'
    window index ``origin``; ``win_h/win_w`` bound the covered extent —
    together they bake a 'same'/'valid' window into the spectra."""
    b, f, h, w = data_cf.shape
    vh, vw = block_h - kh + 1, block_w - kw + 1
    oh = (h + kh - 1 - origin_h) if win_h is None else win_h
    ow = (w + kw - 1 - origin_w) if win_w is None else win_w
    nbh, nbw = -(-oh // vh), -(-ow // vw)
    hp = (nbh - 1) * vh + block_h
    wp = (nbw - 1) * vw + block_w
    pt, pl = kh - 1 - origin_h, kw - 1 - origin_w
    x = F.pad(
        data_cf.to(torch.float32),
        (pl, max(wp - pl - w, 0), pt, max(hp - pt - h, 0)),
    )[:, :, :hp, :wp]
    # (B, F, nbh, Wp, Lh) → (B, F, nbh, nbw, Lh, Lw) → (B, nbh, nbw, F, Lh, Lw)
    xb = x.unfold(2, block_h, vh).unfold(3, block_w, vw)
    xb = xb.permute(0, 2, 3, 1, 4, 5)
    return rfft2_padded_planes(xb, block_h, block_w)


def fused_dispatch_auto(
    block_w: int, spec_dtype: torch.dtype = torch.float32
) -> bool:
    """When ``conv_blocks`` runs the fused block-conv: the Hopper kernel's
    own legality rule — fp32 spectra and a shared-memory need within the
    per-block limit. The kernel takes any channel count, block height and
    window; the JAX rule's geometry, backend and channel-count tests were
    TPU v5e measurements. The rule is the same on the CPU, where the fused
    branch runs the kernel's plain version."""
    return (
        spec_dtype == torch.float32
        and smem_bytes(block_w // 2 + 1) <= SMEM_LIMIT_BYTES
    )


def _conv_blocks_unfused(
    d_re: torch.Tensor,  # (B, nbh, nbw, F, Lh, Lwc)
    d_im: torch.Tensor,
    k_re: torch.Tensor,  # (N, F, Lh, Lwc)
    k_im: torch.Tensor,
    block_h: int,
    block_w: int,
    kh: int,
    kw: int,
    out_h: int,
    out_w: int,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """The unfused pipeline (MAC → irfft2 per block → valid window →
    reassembly) in plain torch. The fallback when the fused kernel is off,
    and the backward of ``fused_block_conv``."""
    b, nbh, nbw, f, lh, lwc = d_re.shape
    n = k_re.shape[0]
    vh, vw = block_h - kh + 1, block_w - kw + 1
    p_re, p_im = spectral_mac_auto_planes(
        d_re.reshape(b * nbh * nbw, f, lh, lwc),
        d_im.reshape(b * nbh * nbw, f, lh, lwc),
        k_re, k_im, use_pallas=use_pallas,
    )
    maps = irfft2_norm_planes(p_re, p_im, block_h, block_w)
    valid = maps[:, :, kh - 1 : kh - 1 + vh, kw - 1 : kw - 1 + vw]
    out = valid.reshape(b, nbh, nbw, n, vh, vw).permute(0, 3, 1, 4, 2, 5)
    out = out.reshape(b, n, nbh * vh, nbw * vw)
    return out[:, :, :out_h, :out_w]


class _FusedBlockConv(torch.autograd.Function):
    """Forward: the fused kernel. Backward: the unfused pipeline's autograd
    (the forward is bilinear in the spectra planes, and both engines compute
    the same linear map) — mirroring the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, d_re, d_im, k_re, k_im, geom):
        ctx.save_for_backward(d_re, d_im, k_re, k_im)
        ctx.geom = geom
        return block_conv(d_re, d_im, k_re, k_im, *geom)

    @staticmethod
    def backward(ctx, g):
        planes = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in planes]
            out = _conv_blocks_unfused(*leaves, *ctx.geom)
            wanted = [x for x, need in zip(leaves, ctx.needs_input_grad) if need]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (
            *(next(grads) if need else None for need in ctx.needs_input_grad[:4]),
            None,
        )


def fused_block_conv(
    d_re: torch.Tensor,
    d_im: torch.Tensor,
    k_re: torch.Tensor,
    k_im: torch.Tensor,
    block_h: int,
    block_w: int,
    kh: int,
    kw: int,
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """The fused block-conv made differentiable: forward through
    ``block_conv``, backward through ``_conv_blocks_unfused``."""
    return _FusedBlockConv.apply(
        d_re, d_im, k_re, k_im, (block_h, block_w, kh, kw, out_h, out_w)
    )


def conv_blocks(
    d_re: torch.Tensor,  # (B, nbh, nbw, F, Lh, Lwc) f32
    d_im: torch.Tensor,
    k_re: torch.Tensor,  # (N, F, Lh, Lwc) f32 — at the BLOCK fft size
    k_im: torch.Tensor,
    block_h: int,
    block_w: int,
    kh: int,
    kw: int,
    out_h: int,
    out_w: int,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """Spectral MAC per block + inverse + overlap-save reassembly →
    (B, N, out_h, out_w) linear-convolution maps. ``Config.
    use_fused_block_conv`` None = ``fused_dispatch_auto``; True/False force
    the fused or unfused branch. Differentiable on both branches."""
    fused = get_config().use_fused_block_conv
    if fused is None:
        fused = fused_dispatch_auto(block_w, d_re.dtype)
    if fused:
        return fused_block_conv(
            d_re, d_im, k_re, k_im, block_h, block_w, kh, kw, out_h, out_w
        )
    return _conv_blocks_unfused(
        d_re, d_im, k_re, k_im, block_h, block_w, kh, kw, out_h, out_w,
        use_pallas=use_pallas,
    )
