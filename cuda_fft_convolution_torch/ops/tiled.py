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

Both take float32 spectra or the bf16 serving tier's bfloat16 spectra
(f32 accumulation either way), and write float32 or bfloat16 maps
(``out_dtype``).

The detection reductions sit on top: ``conv_blocks_peaks`` and
``conv_blocks_top_k`` take the fused branch through the peaks kernel
(``block_conv_peaks``: one (max, argmax) per block, no maps written), and
``peaks_from_maps``, ``top_k_from_maps`` and ``local_peaks_from_maps``
reduce assembled maps.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cuda_fft_convolution_torch.ops.block_conv import (
    SMEM_LIMIT_BYTES,
    block_conv,
    block_conv_peaks,
    fused_splits,
    radix_dispatch,
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
    matmul_engine: bool | None = None, feature_dim: int = 1,
    store_dtype: str = "float32", head: str = "conv", device=None,
) -> tuple[int, int, int, int] | None:
    """The overlap-save plan (block_h, block_w, plan_kh, plan_kw), or None
    when tiling will not pay. (plan_kh, plan_kw) is the effective kernel
    envelope: (max_kh, max_kw) on the analytic branches, larger where a
    measured geometry pins explicit blocks (``runtime/autotune.py``); a
    larger envelope only adds prehistory zeros, the maps are the same."""
    return choose_block_fft(
        data_h, data_w, max_kh, max_kw, min_ratio=min_ratio,
        max_block=max_block, matmul_engine=matmul_engine,
        feature_dim=feature_dim, store_dtype=store_dtype, head=head,
        device=device, _with_plan=True,
    )


def _tuned_block(
    data_h, data_w, max_kh, max_kw, max_block, feature_dim, store_dtype,
    head, device,
) -> tuple[int, int, int, int] | None:
    """The measured geometry for this shape on ``device``
    (``runtime/autotune.py``) as (lh, lw, plan_kh, plan_kw), or None when
    there is none or it does not fit this image and kernel. A measured
    entry skips the analytic redundancy guard (it is the measurement); it
    must keep the enlarged envelope valid and the image spanning more than
    two blocks on an axis."""
    from cuda_fft_convolution_torch.runtime.autotune import lookup_tuned_geometry

    tuned = lookup_tuned_geometry(
        max_kh, max_kw, feature_dim, store_dtype, head=head, device=device
    )
    if tuned is None:
        return None
    vh, vw = tuned[0], tuned[1]
    if len(tuned) >= 5:  # explicit blocks: an enlarged effective envelope
        lh, lw = tuned[3], tuned[4]
    else:
        lh = min(vh + max_kh - 1, max_block)
        lw = min(vw + max_kw - 1, max_block)
    pkh, pkw = lh - vh + 1, lw - vw + 1
    if pkh >= max_kh and pkw >= max_kw and not (
        data_h + pkh - 1 <= 2 * lh and data_w + pkw - 1 <= 2 * lw
    ):
        return lh, lw, pkh, pkw
    return None


def choose_block_fft(
    data_h: int, data_w: int, max_kh: int, max_kw: int,
    *, min_ratio: int | None = None, max_block: int = 1024,
    matmul_engine: bool | None = None, feature_dim: int = 1,
    store_dtype: str = "float32", head: str = "conv", device=None,
    _with_plan: bool = False,
) -> tuple | None:
    """Pick the overlap-save block FFT size, or None when tiling won't pay.

    The dense-DFT branch first consults the measured geometry table
    (``runtime/autotune.py``), keyed by ``device``'s name (None: the card
    where one is present, else the CPU), the feature count, the storage
    tier and the ``head`` ('conv', or 'peaks' for the detection heads).
    Its builtin table is empty; a geometry measured on a TPU v5e, as in the
    JAX package's table, is not applied. Without an entry the JAX
    package's analytic rules decide.

    ``matmul_engine`` selects the branch. True (the default, None) is the
    dense-DFT branch: the fused kernel's windowed inverse DFTs cost per
    output pixel what a dense DFT costs, so blocks are small — the valid
    window V = L − K + 1 is rounded up to (8, 128) multiples, ≈ K tall
    and ≈ 6K wide. False is the FFT branch: 5-smooth blocks ≈ 8K, whose
    cost per pixel grows only with log L."""
    if matmul_engine is None:
        matmul_engine = True
    if matmul_engine:
        tuned = _tuned_block(
            data_h, data_w, max_kh, max_kw, max_block, feature_dim,
            store_dtype, head, device,
        )
        if tuned is not None:
            return tuned if _with_plan else tuned[:2]
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
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Block spectra (B, nbh, nbw, F, block_h, block_w//2+1) split (re, im)
    planes, transformed in float32 and stored in ``dtype`` (float32, or
    bfloat16 for the serving tier).

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
    re, im = rfft2_padded_planes(xb, block_h, block_w)
    return re.to(dtype), im.to(dtype)


def fused_dispatch_auto(
    block_w: int, spec_dtype: torch.dtype = torch.float32, vh: int = 64,
    splits: int | None = None,
) -> bool:
    """When ``conv_blocks`` runs the fused block-conv: the Hopper kernel's
    own legality rule — fp32 or bf16 spectra (the JAX rule admits both) and
    a shared-memory need at window height ``vh`` and synthesis tier
    ``splits`` (None: ``fused_splits``, from the config) within the
    per-block limit (``smem_bytes``; blocks stack only where that fits, so
    the need is within it wherever the one-block configurations are). A
    tier's planes change the need: a block wide enough for 3×TF32 may not
    fit at 6×TF32, and then runs the unfused branch (IEEE fp32 through
    ``torch.fft``), decided before any launch. The kernel takes any channel
    count, block height and window; the JAX rule's geometry, backend and
    channel-count tests were TPU v5e measurements. The rule is the same on
    the CPU, where the fused branch runs the kernel's plain version."""
    if spec_dtype not in (torch.float32, torch.bfloat16):
        return False
    if splits is None:
        splits = fused_splits(spec_dtype)
    return smem_bytes(block_w // 2 + 1, vh, splits) <= SMEM_LIMIT_BYTES


def _fused(block_w: int, spec_dtype: torch.dtype, vh: int, splits: int) -> bool:
    """``Config.use_fused_block_conv``, with None resolved by
    ``fused_dispatch_auto`` at tier ``splits``."""
    fused = get_config().use_fused_block_conv
    return fused_dispatch_auto(block_w, spec_dtype, vh, splits) if fused is None else fused


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
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The unfused pipeline (MAC → irfft2 per block → valid window →
    reassembly): the MAC kernel, then torch. The branch taken when the fused
    kernel is off, and the backward of ``fused_block_conv``.

    At the bf16 tier the products are stored bf16, as in the JAX package
    (``torch.fft`` has no bf16, so the inverse runs on them upcast to
    float32, as JAX's inverse accumulates f32). ``out_dtype`` casts the
    valid windows before the reassembly, as JAX does."""
    b, nbh, nbw, f, lh, lwc = d_re.shape
    n = k_re.shape[0]
    vh, vw = block_h - kh + 1, block_w - kw + 1
    p_re, p_im = spectral_mac_auto_planes(
        d_re.reshape(b * nbh * nbw, f, lh, lwc),
        d_im.reshape(b * nbh * nbw, f, lh, lwc),
        k_re, k_im,
    )
    if d_re.dtype == torch.bfloat16:
        p_re, p_im = p_re.to(torch.bfloat16), p_im.to(torch.bfloat16)
    maps = irfft2_norm_planes(p_re, p_im, block_h, block_w)
    valid = maps[:, :, kh - 1 : kh - 1 + vh, kw - 1 : kw - 1 + vw]
    valid = valid.to(out_dtype)
    out = valid.reshape(b, nbh, nbw, n, vh, vw).permute(0, 3, 1, 4, 2, 5)
    out = out.reshape(b, n, nbh * vh, nbw * vw)
    return out[:, :, :out_h, :out_w]


def _flags(radix: tuple[bool, bool, bool]) -> dict:
    """``radix_dispatch``'s (radix_h, radix_w, xsliver) as the wrappers'
    keywords; none for v3, whose call stays the wrappers' default."""
    return dict(zip(("radix_h", "radix_w", "xsliver"), radix)) if any(radix) else {}


class _FusedBlockConv(torch.autograd.Function):
    """Forward: the fused kernel. Backward: the unfused pipeline's autograd
    (the forward is bilinear in the spectra planes, and both engines compute
    the same linear map) — mirroring the JAX package's custom VJP. Under
    ``create_graph`` the gradients keep their graph to the saved planes. A
    bf16-maps forward receives its cotangent in bf16: the unfused pipeline
    carries the same cast, so its backward upcasts the cotangent where the
    forward rounded, as JAX's cast transpose does."""

    @staticmethod
    def forward(ctx, d_re, d_im, k_re, k_im, geom, out_dtype, splits, radix):
        ctx.save_for_backward(d_re, d_im, k_re, k_im)
        ctx.geom = geom
        ctx.out_dtype = out_dtype
        return block_conv(d_re, d_im, k_re, k_im, *geom, out_dtype, splits, **_flags(radix))

    @staticmethod
    def backward(ctx, g):
        planes = ctx.saved_tensors
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            out = _conv_blocks_unfused(*planes, *ctx.geom, ctx.out_dtype)
            wanted = [x for x, need in zip(planes, ctx.needs_input_grad) if need]
            grads = iter(torch.autograd.grad(out, wanted, g, create_graph=create_graph))
        return (
            *(next(grads) if need else None for need in ctx.needs_input_grad[:4]),
            None,
            None,
            None,
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
    out_dtype: torch.dtype = torch.float32,
    splits: int | None = None,
) -> torch.Tensor:
    """The fused block-conv made differentiable: forward through
    ``block_conv`` at synthesis tier ``splits`` (None: ``fused_splits``) and
    the body ``radix_dispatch`` picks for the plan (the JAX package's
    ``fused_block_conv``: v5 or v5x for a registered plan, else v4 where
    ``radix_h_legal`` holds and the Hopper kernels take it, else v3),
    backward through ``_conv_blocks_unfused``."""
    splits = fused_splits(d_re.dtype) if splits is None else splits
    radix = radix_dispatch(block_h, block_w, kh, kw, d_re.dtype, d_re.shape[3], splits)
    return _FusedBlockConv.apply(
        d_re, d_im, k_re, k_im, (block_h, block_w, kh, kw, out_h, out_w),
        out_dtype, splits, radix,
    )


def conv_blocks(
    d_re: torch.Tensor,  # (B, nbh, nbw, F, Lh, Lwc) f32/bf16
    d_im: torch.Tensor,
    k_re: torch.Tensor,  # (N, F, Lh, Lwc) f32/bf16 — at the BLOCK fft size
    k_im: torch.Tensor,
    block_h: int,
    block_w: int,
    kh: int,
    kw: int,
    out_h: int,
    out_w: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Spectral MAC per block + inverse + overlap-save reassembly →
    (B, N, out_h, out_w) linear-convolution maps in ``out_dtype``. ``Config.
    use_fused_block_conv`` None = ``fused_dispatch_auto``; True/False force
    the fused or unfused branch. The fused kernels' synthesis tier is
    ``fused_splits``, read from the config at this call. Differentiable on
    both branches."""
    splits = fused_splits(d_re.dtype)
    if _fused(block_w, d_re.dtype, block_h - kh + 1, splits):
        return fused_block_conv(
            d_re, d_im, k_re, k_im, block_h, block_w, kh, kw, out_h, out_w,
            out_dtype, splits,
        )
    return _conv_blocks_unfused(
        d_re, d_im, k_re, k_im, block_h, block_w, kh, kw, out_h, out_w,
        out_dtype,
    )


# ---------------------------------------------------------------------------
# detection reductions
# ---------------------------------------------------------------------------


def top_k_ordered(
    x: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` over the last axis in ``lax.top_k``'s order: values
    descending, equal values by ascending index (``torch.topk`` promises no
    order among ties, nor which of several tied candidates it keeps)."""
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    above = x > kth
    tied = x == kth
    need = k - above.sum(-1, keepdim=True, dtype=torch.int32)
    keep = above | (tied & (tied.cumsum(-1, dtype=torch.int32) <= need))
    # exactly k kept per row: the k smallest of (index if kept, else L) are
    # the kept indices in ascending order (no host sync, unlike nonzero)
    n = x.shape[-1]
    pos = torch.arange(n, device=x.device).expand_as(x)
    idx = torch.where(keep, pos, n).topk(k, dim=-1, largest=False).values
    vals = x.gather(-1, idx)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return vals.gather(-1, order), idx.gather(-1, order)


def peaks_from_maps(
    maps: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, N, H, W) maps → per-kernel top-1 ``(vals, ys, xs)`` each (B, N);
    the first maximum in row-major order (``jnp.argmax``'s rule)."""
    b, n, h, w = maps.shape
    flat = maps.reshape(b, n, h * w)
    idx = flat.argmax(dim=-1)
    vals = flat.gather(-1, idx[..., None])[..., 0]
    return vals, (idx // w).to(torch.int32), (idx % w).to(torch.int32)


def top_k_from_maps(
    maps: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, N, H, W) maps → EXACT per-kernel top-k ``(vals, ys, xs)`` each
    (B, N, k), values descending, ties by ascending flat index."""
    b, n, h, w = maps.shape
    kv, ki = top_k_ordered(maps.reshape(b, n, h * w), k)
    return kv, (ki // w).to(torch.int32), (ki % w).to(torch.int32)


def local_peaks_from_maps(
    maps: torch.Tensor,
    k: int,
    window: int = 3,
    threshold=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, N, H, W) maps → per-kernel top-k LOCAL MAXIMA ``(vals, ys, xs)``
    each (B, N, k), values descending. A local maximum equals the max of
    its ``window``×``window`` neighbourhood and lies strictly above
    ``threshold`` (None keeps every local max). The neighbourhood is
    ``reduce_window``'s 'SAME' one: ``(window−1)//2`` before and the rest
    after, so an even window reaches one further down and right; edge
    pixels compare against their in-bounds neighbours. Slots beyond the
    number of maxima carry ``−inf`` and (−1, −1) positions. A constant
    plateau marks every plateau pixel (the JAX package's rule)."""
    b, n, h, w = maps.shape
    x = maps.to(torch.float32)
    lo = (window - 1) // 2
    hi = window - 1 - lo
    dil = F.max_pool2d(
        F.pad(x, (lo, hi, lo, hi), value=-math.inf), window, stride=1
    )
    is_peak = x >= dil
    if threshold is not None:
        is_peak = is_peak & (x > threshold)
    scores = torch.where(is_peak, x, -math.inf)
    kv, ki = top_k_ordered(scores.reshape(b, n, h * w), k)
    hit = torch.isfinite(kv)
    ys = torch.where(hit, ki // w, -1).to(torch.int32)
    xs = torch.where(hit, ki % w, -1).to(torch.int32)
    return kv, ys, xs


def _cell_pyramid(
    d_re, d_im, k_re, k_im, block_h, block_w, kh, kw, out_h, out_w, splits
) -> tuple[torch.Tensor, torch.Tensor]:
    """The peaks kernel's pyramid at synthesis tier ``splits`` flattened
    over cells → (vals, idxs), each (B, N, nbh·nbw) in row-major cell
    order; the body is ``radix_dispatch``'s for the peaks head (the JAX
    package's ``ops/tiled.py:534-548, 664-678``)."""
    radix = radix_dispatch(
        block_h, block_w, kh, kw, d_re.dtype, d_re.shape[3], splits, head="peaks"
    )
    vals, idxs = block_conv_peaks(
        d_re, d_im, k_re, k_im, block_h, block_w, kh, kw, out_h, out_w, splits,
        **_flags(radix),
    )
    b, n = vals.shape[:2]
    return vals.reshape(b, n, -1), idxs.reshape(b, n, -1)


def conv_blocks_peaks(
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Detection head over the overlap-save engine: per-kernel top-1
    ``(vals, ys, xs)`` each (B, N), positions in the output window's frame.

    On the fused branch (``conv_blocks``' dispatch) the peaks kernel
    reduces each block to a (max, argmax) pair and the maps are never
    written; the first-maximum cell of the pyramid then gives the exact
    top-1. On the unfused branch the assembled maps are reduced. The tier
    is ``fused_splits``, read at this call."""
    splits = fused_splits(d_re.dtype)
    if _fused(block_w, d_re.dtype, block_h - kh + 1, splits):
        cells, idxs = _cell_pyramid(
            d_re, d_im, k_re, k_im, block_h, block_w, kh, kw, out_h, out_w, splits
        )
        ci = cells.argmax(dim=-1, keepdim=True)
        flat = idxs.gather(-1, ci)[..., 0]
        return cells.gather(-1, ci)[..., 0], flat // out_w, flat % out_w
    maps = _conv_blocks_unfused(
        d_re, d_im, k_re, k_im, block_h, block_w, kh, kw, out_h, out_w
    )
    return peaks_from_maps(maps)


def conv_blocks_top_k(
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
    k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k detection head over the overlap-save engine: per-kernel
    ``(vals, ys, xs)`` each (B, N, k), values descending, positions in the
    output window's frame.

    On the fused branch the candidates are the peaks kernel's CELL maxima,
    one per block: an approximate top-k whose hits are spatially distinct
    (at most one per block's valid window — exact for k = 1). When k
    exceeds the number of blocks, and on the unfused branch, the assembled
    maps are reduced EXACTLY. The JAX package's cells are groups of blocks
    sized for TPU VMEM, so its fused top-k can differ from this one for
    k > 1. The tier is ``fused_splits``, read at this call."""
    splits = fused_splits(d_re.dtype)
    fused = _fused(block_w, d_re.dtype, block_h - kh + 1, splits)
    if fused and d_re.shape[1] * d_re.shape[2] >= k:
        cells, idxs = _cell_pyramid(
            d_re, d_im, k_re, k_im, block_h, block_w, kh, kw, out_h, out_w, splits
        )
        kv, ki = top_k_ordered(cells, k)
        flat = idxs.gather(-1, ki)
        return kv, flat // out_w, flat % out_w
    maps = _conv_blocks_unfused(
        d_re, d_im, k_re, k_im, block_h, block_w, kh, kw, out_h, out_w
    )
    return top_k_from_maps(maps, k)
