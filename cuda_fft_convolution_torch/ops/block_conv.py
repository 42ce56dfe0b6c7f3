"""Fused overlap-save block convolution: the Hopper kernels and their plain
twins.

Per cell (image b, block (i, j), kernel n) both compute what the JAX
package's ``block_conv_pallas`` computes (its v3 body,
``cuda_fft_convolution_tpu/ops/block_conv.py`` ``_make_kernel_v3``):

    S    = Σ_f K[n, f] ⊙ D[b, i, j, f]                complex MAC over F
    X    = G · S        G = _inv_full_mats(Lh)[kh−1 : kh−1+Vh]   (Vh, Lh)
    tile = Xr · Mr + Xi · Mi
                        M = _inv_packed_mats(Lw)[:, kw−1 : kw−1+Vw]  (Wc, Vw)

and write the tile into out[b, n, i·Vh : (i+1)·Vh, j·Vw : (j+1)·Vw], clipped
at (out_h, out_w) — the 'full'-window linear-convolution maps, assembled in
place with no reassembly pass.

Dtypes. The spectra are float32, or bfloat16 for the serving tier
(``store_dtype='bfloat16'``); the maps are float32, or bfloat16 with
``out_dtype=torch.bfloat16``. Both kernels read bf16 spectra and widen them
to fp32 in registers, and the channel MAC is fp32 either way; bf16 maps
round each fp32 value once, at its store. The plain versions do the same:
they upcast bf16 planes to float32, run the computation of the tier, and
cast the maps to ``out_dtype``.

Precision tiers. The kernels' syntheses run at the tier ``fused_splits``
reads from the config, JAX's rule for its precisions. At fp32 spectra:
3×TF32 (``fused_precision='bf16x3'``, the default; entries
``fftconv_block_conv_f32``…), 6×TF32 ('highest' with ``matmul_precision``
'highest': ``…_x6``, the TPU's fp32-exact HIGHEST) or one TF32 pass
('highest' with 'default': ``…_x1``); 'highest' with 'high' is 3×TF32.
bf16 spectra run ``BF16IO`` (``…_bf16_io``), JAX's single-pass bf16 tier:
S (the MAC's output), G, X (the H stage's output) and M are rounded to
bf16 right before each product, the products are exact and their sums
fp32; an explicit ``splits=3`` runs them at 3×TF32 (``…_bf16``, JAX's
explicit ``precision=BF16X3`` on bf16 planes). The tier changes the
kernels' shared memory (``smem_bytes(wc, vh, splits)``) and the matrix
operands (``_kernel_mats``). The plain versions are IEEE fp32 at every
fp32 tier and round as the kernels do at BF16IO; ``tf32_split`` and
``tf32_product`` emulate the tiers' arithmetic on the CPU for the tests.

``block_conv`` is the wrapper: a tensor on the CPU takes
``block_conv_reference`` (plain torch); a CUDA tensor launches the CUDA
kernel (``csrc/block_conv.cu``) or raises. There is no fallback between the
two.

``block_conv_peaks`` computes the same tiles and keeps, per cell of
``mbh × mbw`` blocks (one block by default), only the max and its global
flat index (the detection head's pyramid); its kernel
(``csrc/block_conv_peaks.cu``) shares the transform stages of
``csrc/block_conv.cuh`` with the maps kernel, and its plain version is
``block_conv_peaks_reference``.

Radix-2 bodies. ``radix_h``, ``radix_w`` and ``xsliver`` select the JAX
package's other bodies of the same function, with its legality rules
(``radix_h_legal``, ``radix_w_legal``) and its plan registry
(``register_radix_w_plan``): v4 (``radix_h``: the H inverse of an even
block, Lh = 2M, split into two M-point sub-transforms over the even and
the odd spectrum rows and a twiddle combine), v5 (``radix_w``, which
implies ``radix_h``: also the W inverse split radix-2, decimation in
frequency — the half-length synthesis P of the even bins and the
twiddle-folded synthesis Q of the odd bins give x[t'] = P + Q and
x[t' + W/2] = P − Q — with the Nyquist bin added as a (−1)^t rank-1 term)
and v5x (``xsliver``: v5 with that Nyquist term synthesised outside the
kernel, ``_xsliver``). Their kernel entries carry the suffixes ``_r4``,
``_r5``, ``_r5x`` (``RADIX_SUFFIX``); they run in the one-block 64- and
32-row configurations, and in the cluster pair where v3 runs it
(``kernel_layout``, ``radix_fits``). ``block_conv_reference``
follows each body's factorisation (``_radix_x``, ``_dif_tile``), which is
the JAX kernels': every window row from the sub-transforms Ê and Ô and the
twiddle, v5's Nyquist term from the unrounded S.

H-stage forms. ``karatsuba=True`` selects the JAX package's Karatsuba H
stage, X = G·S as three real products (t1 = Gr·Sr, t2 = Gi·Si, t3 =
(Gr + Gi)·(Sr + Si); Xr = t1 − t2, Xi = t3 − t1 − t2), in v3 (maps and
peaks; entries ``…_k``), v2 and the radix bodies (their sub-transforms Ê
and Ô, JAX's ``csub``: entries ``…_r4_k``, ``…_r5_k``, ``…_r5x_k``);
``wstack=False`` (maps only) its v2 body, one column-stacked H product
over ``v2_blocks`` blocks of one block column (entries ``…_v2``,
``…_v2_k``): each output element's products are v3's, and the entries
launch v3's configuration of the same form (``v2_rows``, ``v2_blocks``,
``v2_smem_bytes`` are v3's queries). ``karatsuba=None`` keeps the
4-product form on every body (JAX's None means Karatsuba but for v2: a
choice measured on a TPU, ROADMAP queue 3); a radix body does not take
``wstack=False`` (``_body``). The configuration mirror
takes the form (``smem_bytes(..., karatsuba)``, ``v2_rows``,
``v2_blocks``, ``form_smem_bytes``), and ``_h_synthesis`` / ``_v2_x``
compute the forms in the plain version.
"""

from __future__ import annotations

import collections
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from cuda_fft_convolution_torch.ops.dft import _inv_full_mats, _inv_packed_mats
from cuda_fft_convolution_torch.utils.config import get_config
from cuda_fft_convolution_torch.utils.errors import InvalidInputError, validate

# Mirrors csrc/block_conv.cuh's configuration rule, per synthesis tier
# (``splits``: the tensor-core products a product of two fp32 operands runs
# as, 3, 6 or 1, or ``BF16IO``, one product of bf16-rounded operands, laid
# out as one pass; ``fused_splits``). A CTA holds X, 64 rows × [Xr | Xi]
# over the packed bins padded to 32 (a row stride of 2·bins + 4 floats) —
# where that does not fit, the kernels pair two 64-row CTAs that split the
# bins (``pair_bins``, below), and take 32 rows where the pair does not fit
# either — plus a staging area, within
# Hopper's 227 KB (232,448 B) per-block shared-memory limit. The staging area is the larger
# of the H stage's (S^T, 128 bins, and a G chunk, as the TF32 pieces of 16
# spectrum rows — 2 at 3×TF32, 3 at 6×TF32, 1 at one pass — with −Gi's at
# 64 rows: 14,336 floats for 64 rows, 12,800 for 32 rows padded to 20
# floats, at 3×TF32) and the W stage's (a ring of two 32-row chunks of
# [Mr ; Mi] as M^T's TF32 pieces, 128 columns each: 16,384 floats at
# 3×TF32; one plane, M^T itself, in the 32-row configuration at 6×TF32).
# For windows of at most 32 rows it stacks g = min(64 // vh, 4) blocks of
# one image in 64 rows and takes T kernels, where that fits (``_stack``):
# T kernels' X, then the larger of the W stage's buffers and S (one
# kernel's g cells: a u-chunk's U spectrum rows × the bins padded to 8, re
# and im; U = 16 at BF16IO, 8 at the TF32 tiers) followed by a ring of 2 to
# 8 steps (as many as the limit leaves room for), each one channel of
# 2·(g + T) planes, a plane's span the 16-byte chunks that hold U rows × wc
# values of the tier's spectra (bf16 at BF16IO, else fp32) wherever they
# start, then the ring's 16 barriers (8 B each); and the u-chunk's pixels
# must fit the MAC's registers (96 sums a thread of its 224: 96 // (4·g·T)
# pixel pairs). T is 2 where that fits, else 1. bf16 spectra at the other
# tiers fill the same ring bytes with more steps.
SMEM_LIMIT_BYTES = 232448
_COLS = 128
_KB = 32
_UK = 16
_GS = _UK + 4
_KC = 32  # rows of [Mr ; Mi] per W-stage chunk
_M_PLANE = _COLS * _KC  # floats of one plane of a W-stage chunk
_STACK_G, _STACK_T = 4, 2  # blocks, kernels a stacked CTA
_MAC_THREADS, _MAC_ACC = 224, 96
_MIN_STEPS, _MAX_STEPS = 2, 8
_STACK_BARS = 2 * _MAX_STEPS
# JAX's single-pass bf16 tier (its ``BF16IO`` sentinel): the tier of bf16
# spectra, the value the C side names kBF16IO.
BF16IO = 0
# tier (splits, the C configuration queries' tier argument too) → pieces of
# an operand (TF32 pieces; at BF16IO its one bf16 rounding), and the suffix
# of its C entries (the 3×TF32 entries have none)
TIERS = {3: 2, 6: 3, 1: 1, BF16IO: 1}
TIER_SUFFIX = {3: "", 6: "_x6", 1: "_x1", BF16IO: "_io"}


def tier_name(splits: int) -> str:
    """'3xTF32', '6xTF32', '1xTF32' or 'bf16io', for messages."""
    return "bf16io" if splits == BF16IO else f"{splits}xTF32"


def _check_splits(splits: int) -> None:
    validate(splits in TIERS, f"splits must be one of {list(TIERS)}; got {splits!r}")


def m_planes(rows: int, splits: int) -> int:
    """Planes of M^T the W stage streams: its TF32 pieces, or, in the
    32-row configuration at 6×TF32, M^T itself (split in registers)."""
    return 1 if rows == 32 and splits == 6 else TIERS[splits]


def _stage_w(rows: int, splits: int) -> int:
    """Floats of the W stage's ring: 2 chunks of M^T's planes."""
    return 2 * m_planes(rows, splits) * _M_PLANE


def _stage_h(rows: int, splits: int, karatsuba: bool = False) -> int:
    """Floats of the H stage's staging: the pieces of S^T (re, im) and of
    the G chunk (re, im, and −im at 64 rows). The Karatsuba H stage stages
    a third S^T plane, Sr + Si, and Gr + Gi (in place of −Gi at 64 rows, a
    third G plane at 32)."""
    p = TIERS[splits]
    s = 3 if karatsuba else 2
    if rows == 64:  # unpadded, for wgmma
        return s * p * _COLS * _UK + 3 * p * rows * _UK
    return s * p * (_COLS + rows) * _GS


def _x_bytes(wc: int, rows: int) -> int:
    """Shared memory of X: ``rows`` rows of [Xr | Xi] over the bins padded
    to 32, and 4 floats of padding (where the 64-row W stage keeps its
    ring's barriers)."""
    return 4 * rows * (2 * (-(-wc // _KB) * _KB) + 4)


# Spectra dtype → the kernel-entry tag; maps dtype → the entry suffix.
_SPECTRA_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAPS_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16maps"}


def _stack_rows(splits: int) -> int:
    """Spectrum rows of a stacked u-chunk: one mma k-step (16 bf16 values
    at BF16IO, 8 TF32 ones at the other tiers)."""
    return 16 if splits == BF16IO else 8


def _stack(wc: int, blocks: int, kernels: int, splits: int = 3) -> tuple[int, int]:
    """(ring steps, shared-memory bytes) of a stack of ``blocks`` blocks ×
    ``kernels`` kernels at packed width ``wc`` and tier ``splits``; (0, 0)
    where 2 steps do not fit."""
    u, size = _stack_rows(splits), 2 if splits == BF16IO else 4
    span = 16 * ((u * wc * size + 15 - size) // 16 + 1)
    step = 2 * (blocks + kernels) * span
    x = kernels * _x_bytes(wc, 64)
    s = 4 * blocks * 2 * u * (-(-wc // 8) * 8)
    bars = 8 * _STACK_BARS
    steps = min(max(SMEM_LIMIT_BYTES - x - s - bars, 0) // step, _MAX_STEPS)
    if steps < _MIN_STEPS:
        return 0, 0
    return steps, x + max(s + steps * step, 4 * _stage_w(64, splits)) + bars


def _stack_fits(wc: int, blocks: int, kernels: int, splits: int) -> bool:
    pairs = _MAC_ACC // (4 * blocks * kernels)
    steps, smem = _stack(wc, blocks, kernels, splits)
    return (wc <= pairs * 2 * _MAC_THREADS // _stack_rows(splits) and steps >= _MIN_STEPS
            and smem <= SMEM_LIMIT_BYTES)


def _tile_smem_bytes(
    wc: int, rows: int, blocks: int = 1, splits: int = 3, karatsuba: bool = False,
    kernels: int = 1,
) -> int:
    """Shared memory of the configuration of ``rows`` rows stacking
    ``blocks`` blocks (and ``kernels`` kernels) at packed width ``wc``, tier
    ``splits`` and H-stage form (the stacked configuration's Karatsuba
    stage stages nothing more: its products form Sr + Si and Gr + Gi as
    they read S and G)."""
    if blocks > 1:
        return _stack(wc, blocks, kernels, splits)[1]
    return _x_bytes(wc, rows) + 4 * _stage_all(rows, splits, karatsuba)


def _stage_all(rows: int, splits: int, karatsuba: bool = False) -> int:
    """Floats of the staging area: the larger of the two stages'."""
    return max(_stage_h(rows, splits, karatsuba), _stage_w(rows, splits))


def blocks_per_cta(wc: int, vh: int, splits: int = 3) -> int:
    """Blocks one CTA stacks at packed width ``wc``, window height ``vh``
    and tier ``splits``: min(64 // vh, 4) for windows of at most 32 rows
    where that configuration fits with one kernel (its u-chunk's pixels in
    the MAC's registers, a ring of 2 steps or more beside the W stage's
    buffers), else 1."""
    _check_splits(splits)
    g = min(64 // vh, _STACK_G) if vh <= 32 else 1
    return g if g > 1 and _stack_fits(wc, g, 1, splits) else 1


def kernels_per_cta(wc: int, vh: int, splits: int = 3) -> int:
    """Kernels one stacked CTA takes (T): the most, up to 2, whose X, S
    and ring fit beside its blocks' (``blocks_per_cta``); 1 where the
    configuration does not stack."""
    g = blocks_per_cta(wc, vh, splits)
    if g == 1:
        return 1
    return next(t for t in range(_STACK_T, 0, -1) if t == 1 or _stack_fits(wc, g, t, splits))


def _one_block_rows(wc: int, splits: int = 3, karatsuba: bool = False) -> int:
    """Rows of the one-block configuration without pairs (where the pair
    does not fit): 64 where that X fits beside the staging area, else
    32."""
    fits = _tile_smem_bytes(wc, 64, splits=splits, karatsuba=karatsuba) <= SMEM_LIMIT_BYTES
    return 64 if fits else 32


# The paired configuration (v3 and the radix bodies, both H-stage forms,
# where the 64-row X does not fit: Wc > 320 at 3×TF32): a thread-block
# cluster of 2 CTAs of 64
# window rows of one cell, rank r holding X over its share of the bins 0 ..
# Wc − 2 (rank 0 the first ``pair_bins``, rank 1 the rest; X of
# ``pair_bins`` bins each, a row stride of 2·bins + 4 floats), and the
# Nyquist bin Wc − 1 apart: its X column summed in fp32 beside the products,
# added to the tiles as a rank-1 term in the epilogue. Each rank computes
# half of the output columns' passes over both halves of X (its partner's
# through distributed shared memory); a last column alone (Vw = 128·q + 1)
# is a dot of the two halves' partial sums, kept in float64. Shared memory:
# X, the 64-row staging area and a sliver of 256 floats (the Nyquist X and
# the last column's partial sums).
PAIR = 2  # CTAs of the paired configuration's cluster
_PAIR_SLIVER = 64 * 4  # floats


def _pass_ok(bins: int) -> bool:
    """Whether passes of 128 over ``bins`` end in one of at least 32 (or
    none): no pass runs for a handful of bins."""
    return bins % _COLS == 0 or bins % _COLS >= _KB


def _pair_smem(half: int, splits: int, karatsuba: bool) -> int:
    """Shared memory of the paired configuration whose X holds ``half``
    bins (a multiple of 32)."""
    return _x_bytes(half, 64) + 4 * (_stage_all(64, splits, karatsuba) + _PAIR_SLIVER)


def _pair_half(wc: int, splits: int, karatsuba: bool) -> int:
    """Rank 0's bins: half of the Wc − 1 bins rounded up to 32, or 32 more
    where that leaves rank 1 no pass under 32 bins and still fits; 0 where
    neither fits."""
    nb = wc - 1
    h0 = -(-(-(-nb // 2)) // _KB) * _KB
    for h in (h0, h0 + _KB):
        if h < nb and _pass_ok(nb - h) and _pair_smem(h, splits, karatsuba) <= SMEM_LIMIT_BYTES:
            return h
    return h0 if h0 < nb and _pair_smem(h0, splits, karatsuba) <= SMEM_LIMIT_BYTES else 0


def pair_bins(wc: int, vh: int, splits: int = 3, karatsuba: bool = False) -> int:
    """The bins rank 0 of the paired configuration takes at packed width
    ``wc``, window height ``vh``, tier ``splits`` and H-stage form; 0 where
    the v3 and radix bodies do not run that configuration (the blocks
    stack, the 64-row X fits, or the pair does not fit either: 32-row
    tiles)."""
    if blocks_per_cta(wc, vh, splits) > 1 or _one_block_rows(wc, splits, karatsuba) == 64:
        return 0
    return _pair_half(wc, splits, karatsuba)


def cluster_size(wc: int, vh: int, splits: int = 3, karatsuba: bool = False) -> int:
    """CTAs of a thread-block cluster in the v3 kernels: 2 in the paired
    configuration, else 1."""
    return PAIR if pair_bins(wc, vh, splits, karatsuba) else 1


def tile_rows(wc: int, vh: int, splits: int = 3, karatsuba: bool = False) -> int:
    """Window rows one CTA of the v3 kernels holds: 64 (stacked, one
    block's rows where that X fits, or a pair's), else 32."""
    if blocks_per_cta(wc, vh, splits) > 1 or pair_bins(wc, vh, splits, karatsuba):
        return 64
    return _one_block_rows(wc, splits, karatsuba)


def smem_bytes(wc: int, vh: int, splits: int = 3, karatsuba: bool = False) -> int:
    """Shared memory the v3 kernels need at packed width ``wc``, window
    height ``vh``, tier ``splits`` and H-stage form (``karatsuba``)."""
    half = pair_bins(wc, vh, splits, karatsuba)
    if half:
        return _pair_smem(half, splits, karatsuba)
    return _tile_smem_bytes(
        wc, tile_rows(wc, vh, splits, karatsuba), blocks_per_cta(wc, vh, splits), splits,
        karatsuba, kernels_per_cta(wc, vh, splits),
    )


def row_chunks(wc: int, vh: int, splits: int = 3, karatsuba: bool = False) -> int:
    """Row chunks of one block's window in the v3 kernels: 1 where blocks
    stack, else ceil(vh / tile_rows) (a pair's two CTAs share a chunk)."""
    if blocks_per_cta(wc, vh, splits) > 1:
        return 1
    return -(-vh // tile_rows(wc, vh, splits, karatsuba))


def peaks_chunks(wc: int, vh: int, splits: int = 3, karatsuba: bool = False,
                 body: str = "v3", lh: int | None = None) -> int:
    """Pairs the peaks kernel of ``body`` writes a block: one a row chunk
    (v3 ``row_chunks``; a radix body ``radix_row_chunks``, at block height
    ``lh``) and CTA of a cluster (a pair's ranks each reduce their own
    columns)."""
    chunks = (row_chunks(wc, vh, splits, karatsuba) if body == "v3"
              else radix_row_chunks(wc, lh, vh, splits, karatsuba))
    return chunks * (PAIR if kernel_layout(body, wc, vh, splits, karatsuba)[1] else 1)


def kernel_layout(body: str, wc: int, vh: int, splits: int = 3,
                  karatsuba: bool = False) -> tuple[int, int]:
    """(rows, pair bins) of the configuration ``body`` runs, whose operands
    ``_kernel_mats`` lays out: the radix bodies (v4, v5, v5x) the pair
    where v3 runs it (``pair_bins``), else the one-block rule without
    pairs; v3 and v2 (which runs v3's kernels) ``tile_rows`` and
    ``pair_bins``. In the DIF bodies'
    pair (v5, v5x) each rank holds W/4 bins, [even | odd], and the W stage
    runs P over both ranks' even bins and Q over their odd ones: a plan
    ``radix_w_legal`` admits (W a multiple of 512) splits so, and the
    kernels refuse one that does not."""
    if body in _RADIX_BODIES:
        return _radix_layout(wc, vh, splits, karatsuba)
    return tile_rows(wc, vh, splits, karatsuba), pair_bins(wc, vh, splits, karatsuba)


def _radix_layout(wc: int, vh: int, splits: int, karatsuba: bool) -> tuple[int, int]:
    """(rows, pair bins) of every radix body's configuration: the pair where
    v3 runs it, else the one-block rule without pairs."""
    half = pair_bins(wc, vh, splits, karatsuba)
    return (64, half) if half else (_one_block_rows(wc, splits, karatsuba), 0)


def v2_rows(wc: int, vh: int, splits: int = 3, karatsuba: bool = False) -> int:
    """Window rows of the configuration the v2 body runs: v3's of the same
    form (``tile_rows``; csrc/block_conv.cu, "JAX's v2 body")."""
    _check_splits(splits)
    return tile_rows(wc, vh, splits, karatsuba)


def v2_blocks(wc: int, vh: int, splits: int = 3, karatsuba: bool = False) -> int:
    """MBH, the blocks a CTA of the v2 body holds (``karatsuba`` changes
    nothing): v3's (``blocks_per_cta``: 4 at Vh 16, 2 at Vh 32 where they
    fit, else 1). The kernel cuts it to the grid's blocks; the plain
    version groups that many blocks of one block column, as JAX's v2 does
    (the grouping changes no product)."""
    return blocks_per_cta(wc, vh, splits)


def v2_smem_bytes(wc: int, vh: int, splits: int = 3, karatsuba: bool = False) -> int:
    """Shared memory of the v2 body: v3's of the same form
    (``smem_bytes``)."""
    return smem_bytes(wc, vh, splits, karatsuba)


def form_smem_bytes(
    wc: int, vh: int, splits: int = 3, wstack: bool = True, karatsuba: bool = False
) -> int:
    """Shared memory of a call's configuration with the H-stage form's
    flags: ``smem_bytes`` (v3 and the radix bodies), ``v2_smem_bytes``
    under ``wstack=False``. Over ``SMEM_LIMIT_BYTES`` the CUDA wrappers
    raise."""
    return (smem_bytes if wstack else v2_smem_bytes)(wc, vh, splits, karatsuba)


def form_taken(wc: int, vh: int, splits: int = 3, wstack: bool = True,
               karatsuba: bool = False) -> bool:
    """Whether the CUDA kernels take a call of the form at packed width
    ``wc``, window height ``vh`` and tier ``splits``: whether its shared
    memory (``form_smem_bytes``) fits."""
    return form_smem_bytes(wc, vh, splits, wstack, karatsuba) <= SMEM_LIMIT_BYTES


def fused_splits(spec_dtype: torch.dtype = torch.float32) -> int:
    """The fused kernels' synthesis tier for spectra of ``spec_dtype``,
    read from the config at every call — the JAX package's rule
    (``cuda_fft_convolution_tpu/ops/block_conv.py:683-693``): bf16 spectra
    run ``BF16IO`` (one pass on bf16-rounded operands, whatever the
    config); fp32 spectra run 3×TF32 under ``fused_precision='bf16x3'``,
    and under 'highest' the tier of ``matmul_precision``: 'highest' 6×TF32
    (fp32-exact products, the TPU's 6-pass HIGHEST), 'high' 3×TF32,
    'default' one TF32 pass."""
    if spec_dtype == torch.bfloat16:
        return BF16IO
    cfg = get_config()
    if cfg.fused_precision == "bf16x3":
        return 3
    return {"highest": 6, "high": 3, "default": 1}[cfg.matmul_precision]


# Kernel spectra (re and im) a launch tile of the stacked configuration
# keeps in L2 while every block group passes them.
L2_TILE_BYTES = 8 << 20


def kernel_tile(wc: int, vh: int, bank: torch.Tensor, splits: int = 3) -> int:
    """The stacked configuration's launch order: the kernels of one launch
    tile, inside which the kernel index runs fastest (a CTA's
    ``kernels_per_cta`` at a time) and then the block group. As many
    kernels as ``L2_TILE_BYTES`` of their spectra hold, a whole number of
    CTAs' kernels (the whole bank where it fits: the kernel index fastest,
    the other configurations' order), so a tile's spectra stay in L2 while
    the data spectra pass once per tile."""
    n = bank.shape[0]
    if blocks_per_cta(wc, vh, splits) == 1:
        return n
    per_kernel = 2 * bank[0].numel() * bank.element_size()
    t = kernels_per_cta(wc, vh, splits)
    tile = L2_TILE_BYTES // per_kernel
    return n if tile >= n else min(n, max(t, tile // t * t))


def _geometry(dr, kr, block_h, block_w, kh, kw, out_h, out_w):
    """Validate the operand shapes against the block geometry →
    (b, nbh, nbw, f, n, lh, wc, vh, vw)."""
    validate(dr.ndim == 6, f"data spectra must be (B, nbh, nbw, F, Lh, Wc); got {tuple(dr.shape)}")
    validate(kr.ndim == 4, f"kernel spectra must be (N, F, Lh, Wc); got {tuple(kr.shape)}")
    b, nbh, nbw, f, lh, wc = dr.shape
    n = kr.shape[0]
    vh, vw = block_h - kh + 1, block_w - kw + 1
    validate(
        lh == block_h and wc == block_w // 2 + 1,
        f"spectra planes ({lh}, {wc}) do not match blocks ({block_h}, {block_w})",
    )
    validate(
        tuple(kr.shape[1:]) == (f, lh, wc),
        f"kernel spectra {tuple(kr.shape)} do not match data spectra {tuple(dr.shape)}",
    )
    validate(vh >= 1 and vw >= 1, f"kernel ({kh},{kw}) exceeds blocks ({block_h},{block_w})")
    validate(
        0 < out_h <= nbh * vh and 0 < out_w <= nbw * vw,
        f"output ({out_h},{out_w}) not covered by {nbh}x{nbw} blocks of valid window ({vh},{vw})",
    )
    return b, nbh, nbw, f, n, lh, wc, vh, vw


@functools.lru_cache(maxsize=16)
def _window_mats(block_h: int, block_w: int, kh: int, kw: int, device: str):
    """(G_re, G_im) windowed (Vh, Lh) and (M_re, M_im) windowed (Wc, Vw)
    f32 planes on ``device``."""
    vh, vw = block_h - kh + 1, block_w - kw + 1
    gr, gi = _inv_full_mats(block_h)
    mr, mi = _inv_packed_mats(block_w)

    def t(x):
        return torch.from_numpy(x.copy()).to(device)

    return (
        t(gr[kh - 1 : kh - 1 + vh]), t(gi[kh - 1 : kh - 1 + vh]),
        t(mr[:, kw - 1 : kw - 1 + vw]), t(mi[:, kw - 1 : kw - 1 + vw]),
    )


# ---------------------------------------------------------------------------
# radix-2 bodies (the JAX package's v4, v5 and v5x)
# ---------------------------------------------------------------------------

# body → the suffix of its kernel entries (v3 has none)
RADIX_SUFFIX = {"v3": "", "v4": "_r4", "v5": "_r5", "v5x": "_r5x"}
_RADIX_BODIES = ("v4", "v5", "v5x")


def _pad128(x: int) -> int:
    return -(-x // 128) * 128


def radix_h_legal(lh: int, vh: int) -> bool:
    """The JAX package's rule for its v4 radix-2 H stage
    (``cuda_fft_convolution_tpu/ops/block_conv.py:239``): an even block
    height whose half period M and window start w0 = Lh − Vh are 8-aligned,
    the window spanning the period boundary (0 < w0 < M), and M ≤ 128."""
    m, w0 = lh // 2, lh - vh
    return lh % 2 == 0 and m % 8 == 0 and w0 % 8 == 0 and 0 < w0 < m and m <= 128


def radix_w_legal(block_w: int, kw: int, vw: int) -> bool:
    """The JAX package's rule for its v5 radix-2 DIF W stage
    (``cuda_fft_convolution_tpu/ops/block_conv.py:1021``): W a multiple of
    512, the halves-split boundary s1 = W/2 − (kw − 1) past the start and on
    a 128-lane edge or past the window, and fewer DIF products than the
    dense windowed stage's."""
    l2 = block_w // 2
    s1 = l2 - (kw - 1)
    return (
        block_w % 512 == 0
        and vw >= 1
        and 0 < s1
        and (s1 % 128 == 0 or s1 >= vw)
        and block_w * min(vw, l2) < 2 * _pad128(l2 + 1) * vw
    )


@functools.lru_cache(maxsize=32)
def _radix_mats(lh: int) -> tuple[np.ndarray, np.ndarray]:
    """The M-point sub-transform matrices U[u, j] = exp(+2πi uj/M)/Lh
    (M = Lh/2, the inverse's 1/Lh folded), split float32 planes: a copy of
    the JAX package's ``_radix_mats``."""
    m = lh // 2
    u = np.arange(m)[:, None].astype(np.float64)
    j = np.arange(m)[None, :].astype(np.float64)
    ph = 2.0 * np.pi * u * j / m
    return (np.cos(ph) / lh).astype(np.float32), (np.sin(ph) / lh).astype(np.float32)


@functools.lru_cache(maxsize=32)
def radix_twiddle(lh: int) -> tuple[np.ndarray, np.ndarray]:
    """The radix-2 H stage's twiddle t[v'] = exp(+iπ v'/M), v' < M = Lh/2,
    as float32 (cos, sin), built in float64 (the JAX kernel builds the same
    values in float32 in the kernel)."""
    v = np.arange(lh // 2, dtype=np.float64) * np.pi / (lh // 2)
    return np.cos(v).astype(np.float32), np.sin(v).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _dif_w_mats(block_w: int, kw: int, vw: int) -> tuple[np.ndarray, ...]:
    """The v5 DIF W stage's half-length syntheses (epr, epi, oqr, oqi), each
    (W/4, Tn), Tn = min(vw, W/2), over the t'-columns (kw − 1 + k) mod W/2:
    0.5 × the W/2-point packed synthesis of the even bins (the Nyquist row
    left out), and the twiddle-folded synthesis of the odd bins: a copy of
    the JAX package's ``_dif_w_mats``."""
    l2, l4 = block_w // 2, block_w // 4
    t0 = kw - 1
    tn = min(vw, l2)
    tcols = (t0 + np.arange(tn)) % l2
    mr, mi = _inv_packed_mats(l2)
    epr = 0.5 * mr[:l4, tcols].astype(np.float64)
    epi = 0.5 * mi[:l4, tcols].astype(np.float64)
    v = np.arange(l4)[:, None].astype(np.float64)
    th = 2.0 * np.pi * (2.0 * v + 1.0) * tcols[None, :] / block_w
    oqr = (2.0 / block_w) * np.cos(th)
    oqi = (-2.0 / block_w) * np.sin(th)
    return tuple(x.astype(np.float32) for x in (epr, epi, oqr, oqi))


@functools.lru_cache(maxsize=32)
def _sliver_h_mats(lh: int, vh: int) -> tuple[np.ndarray, np.ndarray]:
    """The windowed H synthesis of the Nyquist sliver (v5x): rows the
    window's output rows t = w0.. Lh − 1, columns the even-then-odd
    permuted H bins, 1/Lh folded — a copy of the JAX package's
    ``_sliver_h_mats``."""
    w0 = lh - vh
    u = np.concatenate([np.arange(0, lh, 2), np.arange(1, lh, 2)]).astype(np.float64)
    t = (w0 + np.arange(vh)).astype(np.float64)[:, None]
    ph = 2.0 * np.pi * t * u[None, :] / lh
    return (np.cos(ph) / lh).astype(np.float32), (np.sin(ph) / lh).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _sliver_parity_row(block_w: int, kw: int, vw: int) -> np.ndarray:
    """(1, Tn) the Nyquist term's parity row (−1)^(kw − 1 + k) / W: a copy of
    the JAX package's ``_sliver_parity_row``."""
    tn = min(vw, block_w // 2)
    k = np.arange(tn)
    return (np.where((k + kw - 1) % 2 == 0, 1.0, -1.0) / block_w).astype(np.float32)[None, :]


def radix_fits(wc: int, vh: int, splits: int = 3, karatsuba: bool = False) -> bool:
    """Whether the Hopper kernels take the radix-2 bodies (v4, v5 and v5x,
    which share a configuration) at packed width ``wc``, window height
    ``vh``, tier ``splits`` and H-stage form (``karatsuba``): their
    configuration (``kernel_layout``: the cluster pair where v3 runs it,
    else the one-block 64- or 32-row configuration; the radix stages stage
    no more than the plain ones: U's planes in G's room) within
    ``SMEM_LIMIT_BYTES``. The block-stacked configuration (Vh ≤ 32 where it
    fits) does not: its H stage runs v3's products over u-chunks of stacked
    blocks and kernels, with no radix split."""
    _check_splits(splits)
    if blocks_per_cta(wc, vh, splits) > 1:
        return False
    rows, half = _radix_layout(wc, vh, splits, karatsuba)
    return bool(half) or _tile_smem_bytes(wc, rows, splits=splits,
                                          karatsuba=karatsuba) <= SMEM_LIMIT_BYTES


def radix_chunks(lh: int, vh: int, rows: int) -> tuple[int, int]:
    """The radix kernels' row chunks of one block in the ``rows``-row
    configuration → (pair chunks, single chunks). The window's rows v =
    w0 + r of x[v] = Ê[v mod M] ± t⊙Ô[v mod M] pair up where both v' and
    v' + M lie in it (v' ∈ [w0, M)): a pair chunk takes rows/2 such v', runs
    the two sub-transforms on them and gives 2 · rows/2 rows. The rows
    whose partner falls outside it (v = v' + M, v' < w0, window rows
    [M − w0, M)) take x[v' + M] = Ê − t⊙Ô alone, ``rows`` a single chunk
    (two halves of rows/2 v', half the CTA's warps each: the products of
    the direct rows)."""
    m, w0 = lh // 2, lh - vh
    return -(-(m - w0) // (rows // 2)), -(-w0 // rows)


def radix_row_chunks(wc: int, lh: int, vh: int, splits: int = 3, karatsuba: bool = False) -> int:
    """Row chunks a block takes in the radix bodies' kernels (``radix_chunks``
    in the rows of their ``kernel_layout``) at the tier and H-stage form:
    its CTAs, or its clusters where they pair."""
    return sum(radix_chunks(lh, vh, _radix_layout(wc, vh, splits, karatsuba)[0]))


def _body(radix_h: bool, radix_w: bool, xsliver: bool, wstack: bool = True) -> str:
    """The body the flags select, with the JAX package's rules: ``radix_w``
    implies ``radix_h``, ``xsliver`` is read under ``radix_w`` only, and
    ``wstack=False`` selects v2, which takes neither radix flag (its assert
    at ``cuda_fft_convolution_tpu/ops/block_conv.py:737-741``; here
    ``InvalidInputError`` on either device)."""
    if not wstack:
        if radix_h or radix_w:
            raise InvalidInputError(
                "radix_h and radix_w run in the row-stacked bodies: they need wstack=True")
        return "v2"
    if radix_w:
        return "v5x" if xsliver else "v5"
    return "v4" if radix_h else "v3"


def body_suffix(body: str, karatsuba: bool = False) -> str:
    """The suffix of a body's C entries: the radix bodies' (``RADIX_SUFFIX``),
    '_v2' for v2, then '_k' for the Karatsuba H stage; v3 has none."""
    return RADIX_SUFFIX.get(body, "_v2" if body == "v2" else "") + ("_k" if karatsuba else "")


def _check_body(body: str, block_h: int, block_w: int, kh: int, kw: int) -> None:
    """Raise ``ValueError`` where the JAX package's block_conv_pallas
    asserts (``cuda_fft_convolution_tpu/ops/block_conv.py:737-741,
    773-776``): a radix body on a plan its legality rules reject."""
    vh, vw = block_h - kh + 1, block_w - kw + 1
    if body in _RADIX_BODIES and not radix_h_legal(block_h, vh):
        raise InvalidInputError(
            f"radix_h requires the v4 window/period alignment (block_h={block_h}, vh={vh})")
    if body in ("v5", "v5x") and not radix_w_legal(block_w, kw, vw):
        raise InvalidInputError(
            f"radix_w requires the v5 W alignment (block_w={block_w}, kw={kw}, vw={vw})")


def _check_radix_fits(body: str, wc: int, vh: int, splits: int, karatsuba: bool = False) -> None:
    """On CUDA tensors a radix body needs ``radix_fits`` at the call's tier
    and H-stage form: no other configuration runs it, and none is run in
    its place."""
    if body in _RADIX_BODIES and not radix_fits(wc, vh, splits, karatsuba):
        raise InvalidInputError(
            f"the {body} body runs in the one-block and paired configurations only; "
            f"Wc={wc}, Vh={vh} at "
            f"{tier_name(splits)} stacks {blocks_per_cta(wc, vh, splits)} blocks a CTA "
            f"(radix_fits is False)")


# The registered v5 plans, per head: {(block_h, block_w, kw, spec_bytes,
# f)}; the variant per plan, True = v5x, False = v5. The port has no
# builtin plans: the JAX package's (_BUILTIN_RADIX_W*) were measured on a
# TPU v5e and say nothing of the H100, so a plan runs v5 here only once it
# is registered (a plan measured on the card goes straight into these).
_RADIX_W_TABLE: set = set()
_RADIX_W_TABLE_PEAKS: set = set()
_RADIX_W_XSLIVER: dict = {}
_RADIX_W_XSLIVER_PEAKS: dict = {}


def register_radix_w_plan(
    block_h: int, block_w: int, kw: int, spec_bytes: int = 4, f: int = 1,
    head: str = "conv", sliver: str = "kernel",
) -> None:
    """Register a plan to run the v5 body for banks of ``f`` channels at
    spectra of ``spec_bytes`` (4 float32, 2 bfloat16), for the maps
    (``head='conv'``) or the peaks kernel (``head='peaks'``);
    ``sliver='xla'`` selects v5x, the default ``'kernel'`` v5 — the JAX
    package's ``register_radix_w_plan``."""
    key = (block_h, block_w, kw, int(spec_bytes), int(f))
    (_RADIX_W_TABLE_PEAKS if head == "peaks" else _RADIX_W_TABLE).add(key)
    (_RADIX_W_XSLIVER_PEAKS if head == "peaks" else _RADIX_W_XSLIVER)[key] = sliver == "xla"


def radix_w_enabled(
    block_h: int, block_w: int, kh: int, kw: int, spec_bytes: int = 4,
    f: int = 1, head: str = "conv",
) -> bool:
    """Whether dispatch runs the v5 body for this plan: registered for the
    head, legal under both of the JAX package's rules, and taken by the
    Hopper kernels at the spectra's tier (``radix_fits``)."""
    key = (block_h, block_w, kw, int(spec_bytes), int(f))
    listed = key in (_RADIX_W_TABLE_PEAKS if head == "peaks" else _RADIX_W_TABLE)
    vh, vw = block_h - kh + 1, block_w - kw + 1
    splits = fused_splits(torch.bfloat16 if spec_bytes == 2 else torch.float32)
    return (
        listed and radix_h_legal(block_h, vh) and radix_w_legal(block_w, kw, vw)
        and radix_fits(block_w // 2 + 1, vh, splits)
    )


def radix_w_xsliver(
    block_h: int, block_w: int, kw: int, spec_bytes: int = 4, f: int = 1,
    head: str = "conv",
) -> bool:
    """Whether a radix-w plan runs v5x rather than v5: the registration's
    choice (False for a plan not registered)."""
    key = (block_h, block_w, kw, int(spec_bytes), int(f))
    return (_RADIX_W_XSLIVER_PEAKS if head == "peaks" else _RADIX_W_XSLIVER).get(key, False)


def radix_dispatch(
    block_h: int, block_w: int, kh: int, kw: int, dtype: torch.dtype, f: int,
    splits: int, head: str = "conv",
) -> tuple[bool, bool, bool]:
    """The production route's flags (radix_h, radix_w, xsliver) for a plan,
    as the JAX package's ``ops/tiled.py:366-383, 534-548`` picks them: v5
    (or v5x) for registered plans, else v4 wherever ``radix_h_legal`` holds
    (for the peaks head at float32 spectra only) — and here also only where
    the Hopper kernels take it (``radix_fits``), on either device, so that
    the CPU and the card take the same route."""
    spec_bytes = 2 if dtype == torch.bfloat16 else 4
    vh = block_h - kh + 1
    use_w = radix_w_enabled(block_h, block_w, kh, kw, spec_bytes, f, head)
    use_h = use_w or (
        radix_h_legal(block_h, vh) and radix_fits(block_w // 2 + 1, vh, splits)
        and not (head == "peaks" and dtype == torch.bfloat16)
    )
    return use_h, use_w, use_w and radix_w_xsliver(block_h, block_w, kw, spec_bytes, f, head)


def _split_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(…, Lh, Wc) → its even and its odd spectrum rows."""
    return x[..., 0::2, :], x[..., 1::2, :]


def _radix_x(s_re, s_im, block_h, kh, rnd, karatsuba: bool, u_rnd=None):
    """The v4 H stage as the JAX kernel factors it (``csub``,
    ``cuda_fft_convolution_tpu/ops/block_conv.py:207-231``) → X (…, Vh,
    Wc) = re, im: Ê = U S_even and Ô = U S_odd over every v' < M
    (``_h_synthesis``: the 4-product form or the Karatsuba one, U and S
    rounded by ``rnd`` as the tier does), the twiddle t⊙Ô in fp32, and the
    window rows v = w0 + r as x[v] = Ê[v'] + t⊙Ô[v'] for v' = v ∈ [w0, M)
    and Ê[v'] − t⊙Ô[v'] for v' = v − M ∈ [0, M). The kernels' pair chunks
    give both rows of a v' ∈ [w0, M), their single chunks the minus row
    of a v' < w0."""
    m, w0 = block_h // 2, block_h - (block_h - kh + 1)
    dev, dt = s_re.device, s_re.dtype
    ur, ui = ((u_rnd or rnd)(torch.from_numpy(x).to(dev, dt)) for x in _radix_mats(block_h))
    twr, twi = (torch.from_numpy(x).to(dev, dt)[:, None] for x in radix_twiddle(block_h))
    (er_, or_), (ei_, oi_) = _split_rows(s_re), _split_rows(s_im)
    e_r, e_i = _h_synthesis(ur, ui, er_, ei_, rnd, karatsuba)
    o_r, o_i = _h_synthesis(ur, ui, or_, oi_, rnd, karatsuba)
    t_r, t_i = twr * o_r - twi * o_i, twr * o_i + twi * o_r
    x_re = torch.cat([(e_r + t_r)[..., w0:, :], e_r - t_r], dim=-2)
    x_im = torch.cat([(e_i + t_i)[..., w0:, :], e_i - t_i], dim=-2)
    return x_re, x_im


def _xsliver(dr, di, kr, ki, block_h, block_w, kh) -> torch.Tensor:
    """v5x's Nyquist sliver, synthesised outside the kernel as the JAX
    package's ``_xsliver_operands`` does it in XLA: the MAC at the Nyquist
    bin, then the windowed H synthesis (``_sliver_h_mats``, whose columns
    are the even-then-odd H bins) → its real part, (B, N, nbh, nbw, Vh)
    float32. Summed in float64, so the result does not hang on the
    device's matmul settings: 4·B·N·nbh·nbw·Lh·Vh flop for the synthesis
    (about 1.3 GFLOP for the 2048² image and 100 kernels at (256, 512, 65,
    129)) and 8·B·N·nbh·nbw·F·Lh for the MAC, on the device, inside every
    v5x call and so inside its times."""
    l2, vh = block_w // 2, block_h - kh + 1
    perm = torch.cat([torch.arange(0, block_h, 2), torch.arange(1, block_h, 2)]).to(dr.device)
    dn_r, dn_i = (x[..., l2].double()[..., perm] for x in (dr, di))  # (B, nbh, nbw, F, Lh)
    kn_r, kn_i = (x[..., l2].double()[..., perm] for x in (kr, ki))  # (N, F, Lh)

    def mac(d, k):
        return torch.einsum("bhwfu,nfu->bnhwu", d, k)

    pr = mac(dn_r, kn_r) - mac(dn_i, kn_i)
    pi = mac(dn_r, kn_i) + mac(dn_i, kn_r)
    cn, sn = (torch.from_numpy(x).to(dr.device, torch.float64) for x in _sliver_h_mats(block_h, vh))
    return (pr @ cn.t() - pi @ sn.t()).float()


def _dif_tile(x_re, x_im, nyq, block_w, kw, rnd):
    """The v5 DIF W stage → tile (…, Vh, Vw): P = the even bins' half
    synthesis plus the Nyquist term nyq ⊗ (−1)^t / W, Q = the odd bins'
    twiddled synthesis (``_dif_w_mats``, rounded by ``rnd`` as the tier
    does; ``x_re``, ``x_im`` arrive rounded), then output column c takes
    P ± Q at t'-column c mod W/2: + where kw − 1 + c < W/2."""
    l2 = block_w // 2
    vw, t0 = block_w - kw + 1, kw - 1
    dev, dt = x_re.device, x_re.dtype
    epr, epi, oqr, oqi = (rnd(torch.from_numpy(x).to(dev, dt)) for x in _dif_w_mats(block_w, kw, vw))
    par = torch.from_numpy(_sliver_parity_row(block_w, kw, vw)).to(dev, dt)
    p = x_re[..., 0:l2:2] @ epr + x_im[..., 0:l2:2] @ epi + nyq[..., None] * par
    q = x_re[..., 1:l2:2] @ oqr + x_im[..., 1:l2:2] @ oqi
    tn = p.shape[-1]
    sign = torch.where(t0 + torch.arange(tn, device=dev) < l2, 1.0, -1.0).to(dt)
    return torch.cat([p + sign * q, (p - q)[..., : vw - tn]], dim=-1)


def _h_synthesis(gr, gi, s_re, s_im, rnd, karatsuba: bool):
    """X = G S, complex, from the MAC's fp32 S: the 4-product form on S
    rounded by ``rnd`` (the tier's rounding), or the Karatsuba form —
    t1 = Gr Sr, t2 = Gi Si, t3 = (Gr + Gi)(Sr + Si), X = (t1 − t2,
    t3 − t1 − t2) — with Gr + Gi formed from the (rounded) G planes and
    rounded again and Sr + Si summed before its one rounding, where the
    JAX kernel's BF16IO dots round them."""
    if karatsuba:
        t1, t2 = gr @ rnd(s_re), gi @ rnd(s_im)
        t3 = rnd(gr + gi) @ rnd(s_re + s_im)
        return t1 - t2, t3 - t1 - t2
    s_re, s_im = rnd(s_re), rnd(s_im)
    return gr @ s_re - gi @ s_im, gr @ s_im + gi @ s_re


def _v2_x(gr, gi, s_re, s_im, rnd, karatsuba: bool, mbh: int):
    """The v2 body's H stage: the blocks' S (…, nbh, nbw, N, Lh, Wc) grouped
    ``mbh`` at a time down each block column and stacked side by side,
    (…, Lh, mbh·Wc), one product G [S_1 | … | S_mbh] per group, and the
    columns split back into blocks → X (…, nbh, nbw, N, Vh, Wc)."""
    b, nbh, nbw, n, lh, wc = s_re.shape
    gbh = -(-nbh // mbh)

    def stack(s):
        s = F.pad(s, (0, 0) * 4 + (0, gbh * mbh - nbh))
        return (s.reshape(b, gbh, mbh, nbw, n, lh, wc).permute(0, 1, 3, 4, 5, 2, 6)
                .reshape(b, gbh, nbw, n, lh, mbh * wc))

    def unstack(x):
        vh = x.shape[-2]
        return (x.reshape(b, gbh, nbw, n, vh, mbh, wc).permute(0, 1, 5, 2, 3, 4, 6)
                .reshape(b, gbh * mbh, nbw, n, vh, wc)[:, :nbh])

    x_re, x_im = _h_synthesis(gr, gi, stack(s_re), stack(s_im), rnd, karatsuba)
    return unstack(x_re), unstack(x_im)


def upcast(t: torch.Tensor) -> torch.Tensor:
    """bf16 planes as float32 (exact); any other tensor as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _check_out_dtype(out_dtype: torch.dtype) -> None:
    validate(
        out_dtype in _MAPS_SUFFIX,
        f"maps dtype must be torch.float32 or torch.bfloat16; got {out_dtype}",
    )


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest, ties to even), in ``x``'s dtype:
    what the kernels' BF16IO tier does to an operand (csrc/block_conv.cuh
    bf16r)."""
    return x.to(torch.bfloat16).to(x.dtype)


def block_conv_reference(
    dr: torch.Tensor, di: torch.Tensor,  # (B, nbh, nbw, F, Lh, Wc) f32/bf16
    kr: torch.Tensor, ki: torch.Tensor,  # (N, F, Lh, Wc) f32/bf16
    block_h: int, block_w: int, kh: int, kw: int, out_h: int, out_w: int,
    out_dtype: torch.dtype = torch.float32,
    splits: int | None = None,
    radix_h: bool = False, radix_w: bool = False, xsliver: bool = False,
    wstack: bool = True, karatsuba: bool | None = None,
) -> torch.Tensor:
    """Plain torch version of the fused kernel at synthesis tier ``splits``
    (None: ``fused_splits`` of the spectra's dtype) → (B, N, out_h, out_w)
    maps in ``out_dtype``: bf16 planes are upcast to float32 first. IEEE
    fp32 at every tier but ``BF16IO``, which rounds S, G, X and M to bf16
    right before each product (exact products, fp32 sums; ``_h_synthesis``
    says where the Karatsuba form rounds). float64 planes run in float64,
    with ``out_dtype=torch.float64`` for float64 maps (the checks' exact
    reference). Differentiable; used on the CPU and by the tests.

    ``wstack=False`` runs the v2 body (``_v2_x``: ``v2_blocks`` blocks of a
    column a column-stacked product, then the W stage), ``karatsuba=True``
    the Karatsuba H stage (every body; None and False: the 4-product form).

    ``radix_h``, ``radix_w``, ``xsliver`` select the body (``_body``; an
    illegal plan raises ``ValueError``), computed in the JAX kernels'
    factorisation, as the radix kernels run it: ``_radix_x`` (U rounded at
    ``BF16IO`` as S and X are, the twiddle in fp32), ``_dif_tile`` (its
    matrices rounded there too; v5's Nyquist term the VPU term of the JAX
    kernel, U times the Nyquist bin's unrounded S in fp32, 4-product; v5x's
    from ``_xsliver``, rounded to bf16 at ``BF16IO`` as the kernel rounds
    that operand)."""
    if out_dtype != torch.float64:
        _check_out_dtype(out_dtype)
    b, nbh, nbw, f, n, lh, wc, vh, vw = _geometry(
        dr, kr, block_h, block_w, kh, kw, out_h, out_w
    )
    body = _body(radix_h, radix_w, xsliver, wstack)
    _check_body(body, block_h, block_w, kh, kw)
    kara = bool(karatsuba)
    tier = _resolve_splits(splits, dr.dtype)
    rnd = bf16_round if tier == BF16IO else (lambda x: x)
    slv = _xsliver(dr, di, kr, ki, block_h, block_w, kh) if body == "v5x" else None
    dr, di, kr, ki = (upcast(t) for t in (dr, di, kr, ki))
    gr, gi, mr, mi = (
        rnd(m.to(dr.dtype))
        for m in _window_mats(block_h, block_w, kh, kw, str(dr.device))
    )

    def mac(d, k):
        return torch.einsum("bijfuv,nfuv->bijnuv", d, k)

    s_re = mac(dr, kr) - mac(di, ki)  # (B, nbh, nbw, N, Lh, Wc), fp32
    s_im = mac(di, kr) + mac(dr, ki)
    if body == "v3":
        x_re, x_im = _h_synthesis(gr, gi, s_re, s_im, rnd, kara)  # (B, nbh, nbw, N, Vh, Wc)
    elif body == "v2":
        mbh = min(v2_blocks(wc, vh, tier, kara), nbh)
        x_re, x_im = _v2_x(gr, gi, s_re, s_im, rnd, kara, mbh)
    else:
        x_re, x_im = _radix_x(s_re, s_im, block_h, kh, rnd, kara)
    if body in ("v3", "v4", "v2"):
        tile = rnd(x_re) @ mr + rnd(x_im) @ mi  # (B, nbh, nbw, N, Vh, Vw)
    else:
        if slv is None:
            l2 = block_w // 2
            nyq = _radix_x(s_re[..., l2 : l2 + 1], s_im[..., l2 : l2 + 1], block_h, kh,
                           lambda x: x, False, rnd)[0][..., 0]
        else:
            nyq = rnd(slv.to(x_re.dtype)).permute(0, 2, 3, 1, 4)
        tile = _dif_tile(rnd(x_re), rnd(x_im), nyq, block_w, kw, rnd)
    maps = tile.permute(0, 3, 1, 4, 2, 5).reshape(b, n, nbh * vh, nbw * vw)
    return maps[:, :, :out_h, :out_w].contiguous().to(out_dtype)


def cuda_operands(name: str, ops) -> tuple[torch.device, str]:
    """Check what the port's CUDA kernels take of their (re, im, re, im)
    spectra: one CUDA device, float32 or bfloat16 (one dtype for all four),
    contiguous, re/im planes of one shape → (the device, the dtype's entry
    tag 'f32' or 'bf16')."""
    dr, di, kr, ki = ops
    dev = dr.device
    # (messages are formatted only on failure: the checks run every launch)
    if not (dev.type == "cuda" and di.device == dev and kr.device == dev and ki.device == dev):
        raise InvalidInputError(f"{name} operands must share one CUDA device; got "
                                f"{[str(t.device) for t in ops]}")
    tag = _SPECTRA_TAGS.get(dr.dtype)
    if tag is None or not (di.dtype == kr.dtype == ki.dtype == dr.dtype):
        raise InvalidInputError(
            f"{name} kernel takes float32 or bfloat16 spectra, one dtype for "
            f"all four planes; got {[str(t.dtype) for t in ops]}"
        )
    if not (dr.is_contiguous() and di.is_contiguous() and kr.is_contiguous()
            and ki.is_contiguous()):
        raise InvalidInputError(f"{name} kernel takes contiguous spectra")
    validate(
        di.shape == dr.shape and ki.shape == kr.shape,
        "re/im planes differ in shape",
    )
    return dev, tag


def count_launch(wrapper, mode: str) -> None:
    """One launch of ``wrapper``'s kernel in dtype mode ``mode`` (the C
    entry's name without its ``fftconv_`` prefix)."""
    wrapper.launches += 1
    wrapper.launches_by_mode[mode] += 1


def reset_launches(*wrappers) -> None:
    """Set the launch counts of ``wrappers`` to zero (by mode, and by
    shape or MAC form where a wrapper keeps them)."""
    for w in wrappers:
        w.launches = 0
        w.launches_by_mode.clear()
        for by in ("launches_by_shape", "launches_by_form"):
            if hasattr(w, by):
                getattr(w, by).clear()


def _check_fit(block_w: int, wc: int, vh: int, splits: int, body: str, karatsuba: bool) -> None:
    """Raise where the kernels do not take the call (``form_taken``): its
    shared memory passes Hopper's limit."""
    need = form_smem_bytes(wc, vh, splits, body != "v2", karatsuba)
    form = f"the {body} body" + (" with the Karatsuba H stage" if karatsuba else "")
    validate(
        need <= SMEM_LIMIT_BYTES,
        f"block width {block_w} needs {need} B of shared memory in {form} at "
        f"{tier_name(splits)} (limit {SMEM_LIMIT_BYTES})",
    )


def _resolve_splits(splits: int | None, spec_dtype: torch.dtype) -> int:
    """The tier of a kernel call: ``splits``, or ``fused_splits`` of the
    spectra's dtype where it is None. bf16 spectra run ``BF16IO`` or, asked
    for, 3×TF32; ``BF16IO`` takes bf16 spectra only."""
    if splits is None:
        return fused_splits(spec_dtype)
    _check_splits(splits)
    if spec_dtype == torch.bfloat16:
        validate(splits in (BF16IO, 3),
                 f"bf16 spectra run BF16IO ({BF16IO}) or splits=3; got splits={splits!r}")
    else:
        validate(splits != BF16IO, f"the BF16IO tier (splits={BF16IO}) takes bf16 spectra")
    return splits


def block_conv(
    dr: torch.Tensor, di: torch.Tensor,  # (B, nbh, nbw, F, Lh, Wc) f32/bf16
    kr: torch.Tensor, ki: torch.Tensor,  # (N, F, Lh, Wc) f32/bf16
    block_h: int, block_w: int, kh: int, kw: int, out_h: int, out_w: int,
    out_dtype: torch.dtype = torch.float32,
    splits: int | None = None,
    radix_h: bool = False, radix_w: bool = False, xsliver: bool = False,
    wstack: bool = True, karatsuba: bool | None = None,
) -> torch.Tensor:
    """→ (B, N, out_h, out_w) maps in ``out_dtype``. CPU tensors run
    ``block_conv_reference`` at the tier; CUDA tensors launch the CUDA
    kernel entry of their (spectra, maps) dtypes, synthesis tier ``splits``
    (None: ``fused_splits``, read from the config) and body (``radix_h``,
    ``radix_w``, ``xsliver``: the JAX package's flags and rules, ``_body``)
    on the current stream (no synchronisation) and count the launch in
    ``block_conv.launches``, per mode (the entry's name without
    ``fftconv_``: ``block_conv_f32``, ``block_conv_f32_x6``,
    ``block_conv_bf16_io``, ``block_conv_f32_r5``, …) in
    ``block_conv.launches_by_mode`` and per (mode, block_h, block_w, kh,
    kw) in ``block_conv.launches_by_shape``. A radix body on a plan the
    JAX package's rules reject raises ``ValueError`` on either device; on
    CUDA tensors also where ``radix_fits`` is False.

    ``wstack=False`` runs JAX's v2 body (entries ``…_v2``: v3's
    configuration of the same form, whose products are v2's; no radix flag
    with it), ``karatsuba=True`` the Karatsuba H
    stage in every body (entries ``…_k``, ``…_v2_k``, ``…_r4_k``,
    ``…_r5_k``, ``…_r5x_k``). ``karatsuba=None`` is the 4-product form on
    every body (JAX's None is Karatsuba but for v2). On CUDA tensors a form
    the kernels do not take (``form_taken``: its shared memory does not
    fit) raises; no other entry runs in its place."""
    _check_out_dtype(out_dtype)
    ops = (dr, di, kr, ki)
    splits = _resolve_splits(splits, dr.dtype)
    if all(t.device.type == "cpu" for t in ops):
        return block_conv_reference(
            dr, di, kr, ki, block_h, block_w, kh, kw, out_h, out_w, out_dtype, splits,
            radix_h, radix_w, xsliver, wstack, karatsuba,
        )
    body = _body(radix_h, radix_w, xsliver, wstack)
    _check_body(body, block_h, block_w, kh, kw)
    kara = bool(karatsuba)
    dev, tag = cuda_operands("block_conv", ops)
    b, nbh, nbw, f, n, lh, wc, vh, vw = _geometry(
        dr, kr, block_h, block_w, kh, kw, out_h, out_w
    )
    rows, half = kernel_layout(body, wc, vh, splits, kara)
    _check_fit(block_w, wc, vh, splits, body, kara)
    _check_radix_fits(body, wc, vh, splits, kara)
    from cuda_fft_convolution_torch._build import library

    lib = library(radix=body in _RADIX_BODIES, forms=kara)
    gt_re, gt_im, g_pad, m_tc = _kernel_mats(block_h, block_w, kh, kw, str(dev), splits, rows,
                                             half)
    mode = (f"block_conv_{tag}{_MAPS_SUFFIX[out_dtype]}{TIER_SUFFIX[splits]}"
            f"{body_suffix(body, kara)}")
    ktile = kernel_tile(wc, vh, kr, splits)
    out = torch.empty((b, n, out_h, out_w), dtype=out_dtype, device=dev)
    m_tc, radix = _radix_args(ops, block_h, block_w, kh, kw, str(dev), splits, body, m_tc, rows)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"fftconv_{mode}")(
            dr.data_ptr(), di.data_ptr(), kr.data_ptr(), ki.data_ptr(),
            gt_re.data_ptr(), gt_im.data_ptr(), g_pad.data_ptr(), m_tc.data_ptr(),
            *_ptrs(radix), out.data_ptr(),
            b, nbh, nbw, f, n, lh, wc, vh, vw, out_h, out_w, ktile, stream,
        )
    if err != 0:
        raise RuntimeError(f"block_conv CUDA kernel launch failed: cudaError {err}")
    count_launch(block_conv, mode)
    block_conv.launches_by_shape[(mode, block_h, block_w, kh, kw)] += 1
    return out


block_conv.launches = 0
block_conv.launches_by_mode = collections.Counter()
block_conv.launches_by_shape = collections.Counter()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it (to
    nearest, ties away from zero), with the kernels' two integer operations
    (csrc/block_conv.cuh tf32)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor, pieces: int) -> list[torch.Tensor]:
    """float32 ``x`` as ``pieces`` TF32 planes that sum to it, as the
    kernels split an operand (csrc/block_conv.cuh split_n): p0 = tf32(x),
    p1 = tf32(x − p0), p2 = tf32(x − p0 − p1); 2 pieces hold x to ~2^-22
    relative, 3 to ~2^-33."""
    out = []
    for k in range(pieces):
        p = tf32(x)
        out.append(p)
        if k + 1 < pieces:
            x = x - p
    return out


def tf32_product(a: torch.Tensor, b: torch.Tensor, splits: int) -> torch.Tensor:
    """a @ b as the kernels' tier ``splits`` runs it on the tensor cores,
    emulated on the CPU (for the tests): the products of TF32 pieces whose
    indices sum below the pieces an operand has (6×TF32: all but the three
    below 2^-33; 3×TF32: a_lo·b_hi + a_hi·b_lo + a_hi·b_hi; one pass: hi·hi),
    smallest first, each an fp32 matmul of TF32 values (exact products,
    fp32 sums); at ``BF16IO`` one fp32 matmul of the operands rounded to
    bf16."""
    if splits == BF16IO:
        return bf16_round(a) @ bf16_round(b)
    p = TIERS[splits]
    pa, pb = tf32_split(a, p), tf32_split(b, p)
    terms = [(i, s - i) for s in range(p - 1, -1, -1) for i in range(s, -1, -1)]
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for i, j in terms:
        out = out + pa[i] @ pb[j]
    return out


@functools.lru_cache(maxsize=16)
def _kernel_mats(
    block_h: int, block_w: int, kh: int, kw: int, device: str, splits: int = 3,
    rows: int | None = None, half: int = 0,
):
    """The kernels' matrix operands at tier ``splits`` (csrc/block_conv.cuh
    launch_block_conv) → (gt_re, gt_im, g_pad, m_tc): G^T (Lh, Vh), re and
    im, exact — an argument of the C entries that no configuration reads
    since the block-stacked H stage moved to the tensor cores; G (2, Vh
    padded to 64, Lh padded to 16) = re, im, exact — every H stage's A
    operand (the stacked one's mma fragments read it from global memory),
    split in the kernel as it is staged; and M^T's planes in core matrices, the W stage's B operand,
    which wgmma reads from shared memory as it is: M^T is (Vw padded to
    128, 2·Wc'), Wc' = Wc padded to 32, row c holding column c of [Mr ; Mi]
    (Mr at k < Wc, Mi from k = Wc'); its planes are its ``tf32_split``
    pieces (3×TF32: hi = tf32(M^T), lo = tf32(M^T − hi); 6×TF32 adds a
    third; one pass, hi alone), or M^T itself where the configuration
    streams one plane and splits it in registers (``m_planes``: the 32-row
    configuration at 6×TF32); m_tc[p, c // 8, k // 4, c % 8, k % 4] is
    plane p at (c, k), 8 columns × 4 k of 128 contiguous bytes a core
    matrix. Zeros fill every padding. At ``BF16IO`` G, G^T and M^T (one
    plane) are the windows rounded to bf16, the operands of that tier's
    products. The operands depend on the tier, so the tier is part of the
    cache key; ``rows`` and ``half`` are the configuration's (``rows`` None:
    ``tile_rows`` and ``pair_bins`` at the tier — the v3 body's 4-product
    form), whose M^T planes these are. The paired configuration (``half``
    > 0: its rank 0's bins) reads ``_pair_m``'s operand instead."""
    gr, gi, mr, mi = _window_mats(block_h, block_w, kh, kw, device)
    if splits == BF16IO:
        gr, gi, mr, mi = (bf16_round(m) for m in (gr, gi, mr, mi))
    (vh, lh), (wc, vw) = gr.shape, mr.shape
    g_pad = torch.zeros((2, -(-vh // 64) * 64, -(-lh // _UK) * _UK), device=device)
    g_pad[0, :vh, :lh], g_pad[1, :vh, :lh] = gr, gi
    if rows is None:
        rows = tile_rows(wc, block_h - kh + 1, splits)
        half = pair_bins(wc, block_h - kh + 1, splits)
    if half:
        return gr.t().contiguous(), gi.t().contiguous(), g_pad, _pair_m(mr, mi, half, splits)
    bins = -(-wc // _KB) * _KB
    cols = -(-vw // _COLS) * _COLS
    m_t = torch.zeros((cols, 2 * bins), device=device)
    m_t[:vw, :wc], m_t[:vw, bins : bins + wc] = mr.t(), mi.t()
    return gr.t().contiguous(), gi.t().contiguous(), g_pad, _core_matrices(m_t, rows, splits)


def pair_columns(vw: int) -> int:
    """Output columns the paired configuration's passes cover: all of them,
    but a last column alone past whole passes (Vw = 128·q + 1), which is a
    dot of its own."""
    return vw - 1 if vw % _COLS == 1 else vw


def _pair_m(mr: torch.Tensor, mi: torch.Tensor, half: int, splits: int) -> torch.Tensor:
    """The paired configuration's W-stage operand, flat: M^T over the bins
    0 .. Wc − 2 in the pair's contraction order — rank 0's X columns [Xr |
    Xi] over its ``half`` bins, then rank 1's over the rest, each padded to
    ``half`` (K = 4·half) — and the passes' columns (``pair_columns``,
    padded to 128), laid out chunk by chunk as ``_core_matrices`` does for
    64 rows; then, exact (rounded to bf16 at BF16IO, as the planes), the
    Nyquist row of [Mr ; Mi] over those columns (re, then im; 2 × the
    padded columns), the last column alone over the K order (K values, zeros
    where the passes cover every column) and the Nyquist bin's two values of
    that column, padded to 4 floats."""
    wc, vw = mr.shape
    nb, vm = wc - 1, pair_columns(vw)
    cols, k = -(-vm // _COLS) * _COLS, 4 * half
    m_t = torch.zeros((cols, k), device=mr.device)
    last = torch.zeros(k + 4, device=mr.device)
    for r in range(PAIR):
        b0, cnt = r * half, min(half, nb - r * half)
        for c, m in enumerate((mr, mi)):
            at = r * 2 * half + c * half
            m_t[:vm, at : at + cnt] = m[b0 : b0 + cnt, :vm].t()
            if vm < vw:
                last[at : at + cnt] = m[b0 : b0 + cnt, vw - 1]
    nyq = torch.zeros((2, cols), device=mr.device)
    nyq[0, :vm], nyq[1, :vm] = mr[nb, :vm], mi[nb, :vm]
    if vm < vw:
        last[k], last[k + 1] = mr[nb, vw - 1], mi[nb, vw - 1]
    core = _core_matrices(m_t, 64, splits)
    return torch.cat([core.reshape(-1), nyq.reshape(-1), last])


def _core_matrices(m_t: torch.Tensor, rows: int, splits: int) -> torch.Tensor:
    """The W stage's B operand (cols, K) as the planes the ``rows``-row
    configuration streams at the tier (``m_planes``), in core matrices:
    32 rows, [plane][c // 8][k // 4][c % 8][k % 4]; 64 rows, chunk by
    chunk, so that the chunk of a W-stage step (a pass of 128 columns, 32
    k) is one contiguous run, as the TMA copies it: [c // 128][k // 32]
    [plane][c % 128 // 8][k % 32 // 4][c % 8][k % 4] (``m_core`` reads it
    back)."""
    cols, k = m_t.shape
    pieces = m_planes(rows, splits)
    planes = torch.stack([m_t] if pieces < TIERS[splits] else tf32_split(m_t, pieces))
    if rows == 64:
        return (planes.reshape(pieces, cols // _COLS, _COLS // 8, 8, k // _KC, _KC // 4, 4)
                .permute(1, 4, 0, 2, 5, 3, 6).contiguous())
    return planes.reshape(pieces, cols // 8, 8, k // 4, 4).permute(0, 1, 3, 2, 4).contiguous()


def m_core(m_tc: torch.Tensor) -> torch.Tensor:
    """M^T's planes in core matrices, [plane][c // 8][k // 4][c % 8][k %
    4], from either layout ``_core_matrices`` makes (the 64-row one's
    chunks read back; the 32-row one as it is)."""
    if m_tc.ndim == 5:
        return m_tc
    passes, chunks, pieces = m_tc.shape[:3]
    return (m_tc.permute(2, 0, 3, 1, 4, 5, 6)
            .reshape(pieces, passes * (_COLS // 8), chunks * (_KC // 4), 8, 4))


@functools.lru_cache(maxsize=16)
def _radix_kernel_mats(
    block_h: int, block_w: int, kh: int, kw: int, device: str, splits: int, body: str,
    rows: int,
):
    """The radix kernels' matrix operands at tier ``splits``
    (csrc/block_conv.cuh RadixOps) → (u_pad, tw, m_dif): U (3, M padded to
    64, M padded to 16) = re, im, re + im, the sub-transforms (exact, or
    rounded to bf16 at ``BF16IO``, and the sum of the rounded planes rounded
    again, as JAX's bf16 ``ur + ui``; the Karatsuba form's plane); the
    twiddle (2, M) = cos, sin, float32 at every tier; and for v5/v5x the
    DIF W stage's B operand — row c of (Tn padded to 128, W) holding [epr;
    epi; oqr; oqi] at t'-column c, as ``_core_matrices`` for the
    ``rows``-row configuration (v4's W stage takes ``_kernel_mats``' M^T:
    None)."""
    rnd = bf16_round if splits == BF16IO else (lambda x: x)
    m, vh, vw = block_h // 2, block_h - kh + 1, block_w - kw + 1
    ur, ui = (rnd(torch.from_numpy(x).to(device)) for x in _radix_mats(block_h))
    u_pad = torch.zeros((3, -(-m // 64) * 64, -(-m // _UK) * _UK), device=device)
    u_pad[0, :m, :m], u_pad[1, :m, :m], u_pad[2, :m, :m] = ur, ui, rnd(ur + ui)
    tw = torch.from_numpy(np.stack(radix_twiddle(block_h))).to(device)
    if body == "v4":
        return u_pad, tw, None
    mats = [rnd(torch.from_numpy(x).to(device)) for x in _dif_w_mats(block_w, kw, vw)]
    tn = mats[0].shape[1]
    m_t = torch.zeros((-(-tn // _COLS) * _COLS, block_w), device=device)
    m_t[:tn] = torch.cat(mats).t()
    return u_pad, tw, _core_matrices(m_t, rows, splits)


def _radix_args(ops, block_h, block_w, kh, kw, device, splits, body, m_tc, rows):
    """A launch's W-stage operand and the radix entries' extra pointers →
    (m_tc, (u_pad, tw, slv)): v5/v5x take the DIF operand (for the
    ``rows``-row configuration) in place of ``m_tc``; slv is v5x's sliver
    (B, N, nbh, nbw, Vh) from ``_xsliver``, a null pointer for v4 and v5; v3
    and v2 entries take no extra pointers."""
    if body not in _RADIX_BODIES:
        return m_tc, ()
    u_pad, tw, m_dif = _radix_kernel_mats(block_h, block_w, kh, kw, device, splits, body, rows)
    slv = _xsliver(*ops, block_h, block_w, kh).contiguous() if body == "v5x" else None
    return (m_tc if m_dif is None else m_dif), (u_pad, tw, slv)


def _ptrs(tensors) -> tuple:
    """Device pointers of ``tensors`` (None: a null pointer)."""
    return tuple(0 if t is None else t.data_ptr() for t in tensors)


def _check_index_range(nbh: int, nbw: int, vh: int, vw: int, out_w: int) -> None:
    last = (nbh * vh - 1) * out_w + nbw * vw - 1
    validate(
        last < 2**31,
        f"flat positions up to {last} do not fit the int32 peak indices",
    )


def cell_view(
    maps: torch.Tensor, nbh: int, nbw: int, vh: int, vw: int
) -> torch.Tensor:
    """(B, N, out_h, out_w) maps → (B, N, nbh, nbw, vh·vw): cell (i, j) =
    rows [i·vh, (i+1)·vh) × cols [j·vw, (j+1)·vw), row-major, with −inf at
    the positions past the maps."""
    b, n, out_h, out_w = maps.shape
    full = F.pad(
        maps, (0, nbw * vw - out_w, 0, nbh * vh - out_h), value=-math.inf
    )
    cells = full.reshape(b, n, nbh, vh, nbw, vw).permute(0, 1, 2, 4, 3, 5)
    return cells.reshape(b, n, nbh, nbw, vh * vw)


def cell_peaks(
    maps: torch.Tensor, nbh: int, nbw: int, vh: int, vw: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N, out_h, out_w) maps → per-cell ``(vals, idxs)``, each
    (B, N, nbh, nbw): the max of each ``cell_view`` cell and its global
    flat index y·out_w + x. The larger value wins, then the smaller index;
    positions past the maps are −inf, so a cell with none inside reports
    −inf at its first position — the rule of the JAX package's
    ``_peaks_reducer``."""
    out_w = maps.shape[-1]
    _check_index_range(nbh, nbw, vh, vw, out_w)
    cells = cell_view(maps, nbh, nbw, vh, vw)
    # Row-major order inside a cell is flat-index order over its positions
    # inside the maps, so the first maximum (torch.argmax's rule) is the
    # one with the smallest index.
    pos = cells.argmax(dim=-1)
    vals = cells.gather(-1, pos[..., None])[..., 0]
    dev = maps.device
    gy = torch.arange(nbh, device=dev)[:, None] * vh + pos // vw
    gx = torch.arange(nbw, device=dev) * vw + pos % vw
    return vals, (gy * out_w + gx).to(torch.int32)


def _check_group(mbh, mbw) -> None:
    validate(
        all(m is None or (isinstance(m, int) and m >= 1) for m in (mbh, mbw)),
        f"mbh and mbw must be None or positive ints; got {mbh!r}, {mbw!r}",
    )


def group_cells(
    vals: torch.Tensor, idxs: torch.Tensor, mbh=None, mbw=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """A per-block pyramid (vals, idxs), each (B, N, nbh, nbw), reduced to
    cells of ``mbh × mbw`` blocks → (B, N, ceil(nbh / mbh), ceil(nbw /
    mbw)) pairs, in the order of the JAX package's ``_peaks_reducer``
    (``cuda_fft_convolution_tpu/ops/block_conv.py:1436-1443``): inside a
    column of blocks the larger value wins, then the smallest flat index;
    across the columns j of a cell a later j wins only when it is strictly
    greater. Blocks past the grid (the last cells' padding) never win.
    None and 1 keep one block per cell; a group larger than the grid is
    cut to it, as in JAX."""
    b, n, nbh, nbw = vals.shape
    _check_group(mbh, mbw)
    mbh, mbw = min(mbh or 1, nbh), min(mbw or 1, nbw)
    if mbh == mbw == 1:
        return vals, idxs
    gbh, gbw = -(-nbh // mbh), -(-nbw // mbw)
    pad = (0, gbw * mbw - nbw, 0, gbh * mbh - nbh)
    last = torch.iinfo(torch.int32).max
    v = F.pad(vals, pad, value=-math.inf).reshape(b, n, gbh, mbh, gbw, mbw)
    i = F.pad(idxs, pad, value=last).reshape(b, n, gbh, mbh, gbw, mbw)
    col_v = v.amax(dim=3, keepdim=True)
    col_i = torch.where(v == col_v, i, last).amin(dim=3)  # (B, N, gbh, gbw, mbw)
    col_v = col_v[:, :, :, 0]
    j = col_v.argmax(dim=-1, keepdim=True)  # the first column at the max
    return col_v.gather(-1, j)[..., 0], col_i.gather(-1, j)[..., 0]


def block_conv_peaks_reference(
    dr: torch.Tensor, di: torch.Tensor,  # (B, nbh, nbw, F, Lh, Wc) f32/bf16
    kr: torch.Tensor, ki: torch.Tensor,  # (N, F, Lh, Wc) f32/bf16
    block_h: int, block_w: int, kh: int, kw: int, out_h: int, out_w: int,
    splits: int | None = None, mbh: int | None = None, mbw: int | None = None,
    radix_h: bool | None = None, radix_w: bool = False, xsliver: bool = False,
    karatsuba: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the peaks kernel: ``block_conv_reference`` at
    tier ``splits``, the body the flags select (``radix_h=None``: as
    ``block_conv_peaks`` resolves it) and the H stage's form
    (``karatsuba``) (f32 maps, bf16 planes upcast), then ``cell_peaks``
    over one-block cells and ``group_cells`` over cells of ``mbh × mbw``
    blocks → (vals f32, idxs int32), each (B, N, ceil(nbh / mbh), ceil(nbw
    / mbw))."""
    radix_h = _peaks_radix_h(radix_h, radix_w, dr, block_h, block_w, kh, splits, karatsuba)
    maps = block_conv_reference(
        dr, di, kr, ki, block_h, block_w, kh, kw, out_h, out_w, splits=splits,
        radix_h=radix_h, radix_w=radix_w, xsliver=xsliver, karatsuba=karatsuba,
    )
    vals, idxs = cell_peaks(
        maps, dr.shape[1], dr.shape[2], block_h - kh + 1, block_w - kw + 1
    )
    return group_cells(vals, idxs, mbh, mbw)


def _peaks_radix_h(radix_h, radix_w, dr, block_h, block_w, kh, splits, karatsuba=None) -> bool:
    """The peaks kernel's ``radix_h``: as given, True under ``radix_w``,
    and for None the JAX package's auto rule — v4 at float32 spectra where
    ``radix_h_legal`` holds — where the Hopper kernels take it
    (``radix_fits`` at the call's tier and H-stage form), on either
    device."""
    if radix_w:
        return True
    if radix_h is not None:
        return radix_h
    vh = block_h - kh + 1
    return (
        dr.dtype != torch.bfloat16 and radix_h_legal(block_h, vh)
        and radix_fits(block_w // 2 + 1, vh, _resolve_splits(splits, dr.dtype), bool(karatsuba))
    )


def _best_chunk(vals: torch.Tensor, idxs: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduce (value, flat index) pairs over ``dim`` by the peaks rule: the
    larger value wins, then the smaller index."""
    best = vals.amax(dim=dim, keepdim=True)
    at = torch.where(vals == best, idxs, torch.iinfo(torch.int32).max).amin(dim=dim)
    return best.squeeze(dim), at


def block_conv_peaks(
    dr: torch.Tensor, di: torch.Tensor,  # (B, nbh, nbw, F, Lh, Wc) f32/bf16
    kr: torch.Tensor, ki: torch.Tensor,  # (N, F, Lh, Wc) f32/bf16
    block_h: int, block_w: int, kh: int, kw: int, out_h: int, out_w: int,
    splits: int | None = None, mbh: int | None = None, mbw: int | None = None,
    radix_h: bool | None = None, radix_w: bool = False, xsliver: bool = False,
    karatsuba: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-cell max pyramid of the fused block conv, with no maps
    written → ``(vals, idxs)``, each (B, N, ceil(nbh / mbh), ceil(nbw /
    mbw)): the max response of each cell of ``mbh × mbw`` blocks' valid
    windows (clipped at (out_h, out_w)) and its global flat index
    y·out_w + x (int32). Larger value wins; between equal values the
    smaller index, in the JAX package's order across a cell's blocks
    (``group_cells``); positions past (out_h, out_w) never win. The values
    are float32 and the indices int32 at either spectra dtype.

    This is the JAX package's ``block_conv_peaks_pallas(..., mbh, mbw,
    radix_h, radix_w, xsliver)``. ``mbh = mbw = None`` (or 1) is one cell
    per block: the JAX package picks its groups by a model of TPU VMEM
    (``_choose_group``, ``lookup_fused_group``), which Hopper does not
    have; reducing the pyramid over cells gives the exact per-kernel top-1
    at any grouping. ``radix_h=None`` runs v4 where the JAX package's auto
    rule does and the Hopper kernels take it (``_peaks_radix_h``); an
    explicit radix flag on a plan JAX rejects raises ``ValueError``, and on
    CUDA tensors also where ``radix_fits`` is False. ``karatsuba=True``
    runs the Karatsuba H stage (entries ``…_k``, ``…_r4_k``, ``…_r5_k``,
    ``…_r5x_k``; the auto rule's v4 included, where ``radix_fits`` holds
    for the form); None and False the 4-product form (JAX's peaks kernel
    defaults to Karatsuba).

    CPU tensors run ``block_conv_peaks_reference``; CUDA tensors launch the
    CUDA kernel entry of their spectra dtype, synthesis tier ``splits``
    (None: ``fused_splits``) and body on the current stream and count the
    launch in ``block_conv_peaks.launches`` and, per mode, in
    ``block_conv_peaks.launches_by_mode``. A CTA holds one block (or a
    stack of blocks), so the kernel writes one pair per (block, row chunk
    and CTA of a pair: ``peaks_chunks``); a block split into several row
    chunks or a pair's column halves is combined here (``_best_chunk``: a radix
    body's chunks hold rows from both halves of the window, so the rule is
    applied by index, not by chunk order), and the blocks into cells by
    ``group_cells``."""
    ops = (dr, di, kr, ki)
    splits = _resolve_splits(splits, dr.dtype)
    _check_group(mbh, mbw)
    radix_h = _peaks_radix_h(radix_h, radix_w, dr, block_h, block_w, kh, splits, karatsuba)
    if all(t.device.type == "cpu" for t in ops):
        return block_conv_peaks_reference(
            dr, di, kr, ki, block_h, block_w, kh, kw, out_h, out_w, splits, mbh, mbw,
            radix_h, radix_w, xsliver, karatsuba,
        )
    body = _body(radix_h, radix_w, xsliver)
    _check_body(body, block_h, block_w, kh, kw)
    kara = bool(karatsuba)
    dev, tag = cuda_operands("block_conv_peaks", ops)
    b, nbh, nbw, f, n, lh, wc, vh, vw = _geometry(
        dr, kr, block_h, block_w, kh, kw, out_h, out_w
    )
    _check_fit(block_w, wc, vh, splits, body, kara)
    _check_radix_fits(body, wc, vh, splits, kara)
    _check_index_range(nbh, nbw, vh, vw, out_w)
    from cuda_fft_convolution_torch._build import library

    lib = library(radix=body in _RADIX_BODIES, forms=kara)
    rows, half = kernel_layout(body, wc, vh, splits, kara)
    gt_re, gt_im, g_pad, m_tc = _kernel_mats(block_h, block_w, kh, kw, str(dev), splits, rows,
                                             half)
    m_tc, radix = _radix_args(ops, block_h, block_w, kh, kw, str(dev), splits, body, m_tc, rows)
    chunks = peaks_chunks(wc, vh, splits, kara, body, lh)
    ktile = kernel_tile(wc, vh, kr, splits)
    shape = (b, n, nbh, chunks, nbw)
    vals = torch.empty(shape, dtype=torch.float32, device=dev)
    idxs = torch.empty(shape, dtype=torch.int32, device=dev)
    mode = f"block_conv_peaks_{tag}{TIER_SUFFIX[splits]}{body_suffix(body, kara)}"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"fftconv_{mode}")(
            dr.data_ptr(), di.data_ptr(), kr.data_ptr(), ki.data_ptr(),
            gt_re.data_ptr(), gt_im.data_ptr(), g_pad.data_ptr(), m_tc.data_ptr(),
            *_ptrs(radix), vals.data_ptr(), idxs.data_ptr(),
            b, nbh, nbw, f, n, lh, wc, vh, vw, out_h, out_w, ktile, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"block_conv_peaks CUDA kernel launch failed: cudaError {err}"
        )
    count_launch(block_conv_peaks, mode)
    block_conv_peaks.launches_by_shape[(mode, block_h, block_w, kh, kw)] += 1
    if chunks == 1:
        vals, idxs = vals[:, :, :, 0], idxs[:, :, :, 0]
    else:
        vals, idxs = _best_chunk(vals, idxs, 3)
    return group_cells(vals, idxs, mbh, mbw)


block_conv_peaks.launches = 0
block_conv_peaks.launches_by_mode = collections.Counter()
block_conv_peaks.launches_by_shape = collections.Counter()
