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
"""

from __future__ import annotations

import collections
import functools
import math

import torch
import torch.nn.functional as F

from cuda_fft_convolution_torch.ops.dft import _inv_full_mats, _inv_packed_mats
from cuda_fft_convolution_torch.utils.config import get_config
from cuda_fft_convolution_torch.utils.errors import InvalidInputError, validate

# Mirrors csrc/block_conv.cuh's configuration rule, per synthesis tier
# (``splits``: the tensor-core products a product of two fp32 operands runs
# as, 3, 6 or 1, or ``BF16IO``, one product of bf16-rounded operands, laid
# out as one pass; ``fused_splits``). A CTA holds X, 64 rows (32 where that
# does not fit) × [Xr | Xi] over the packed bins padded to 32 (a row stride
# of 2·bins + 4 floats), plus a staging area, within Hopper's 227 KB
# (232,448 B) per-block shared-memory limit. The staging area is the larger
# of the H stage's (S^T, 128 bins, and a G chunk, as the TF32 pieces of 16
# spectrum rows — 2 at 3×TF32, 3 at 6×TF32, 1 at one pass — with −Gi's at
# 64 rows: 14,336 floats for 64 rows, 12,800 for 32 rows padded to 20
# floats, at 3×TF32) and the W stage's (a ring of two 32-row chunks of
# [Mr ; Mi] as M^T's TF32 pieces, 128 columns each: 16,384 floats at
# 3×TF32; one plane, M^T itself, in the 32-row configuration at 6×TF32).
# For windows of at most 32 rows it stacks g = min(64 // vh, 16) blocks of
# one (image, kernel) in 64 rows, where that fits: after X, the larger of
# the W stage's buffers and S and G^T (5120 floats) followed by a ring of 2
# to 8 steps (as many as the limit leaves room for) of 4, 2 or 1 channels
# (the most that leave room for 2 steps) × 2·(g + 1)·(16 // g) row
# segments, each the 16-byte chunks that can hold min(wc, 128) fp32 values.
# bf16 spectra fill the same bytes with up to 8 channels a step.
SMEM_LIMIT_BYTES = 232448
_COLS = 128
_KB = 32
_UK = 16
_GS = _UK + 4
_KC = 32  # rows of [Mr ; Mi] per W-stage chunk
_M_PLANE = _COLS * _KC  # floats of one plane of a W-stage chunk
_MAX_GROUP = 16
_STACK_ROWS = 16
_STACK_STAGE = 2 * _STACK_ROWS * _COLS + 2 * 8 * 64
_MIN_STEPS, _MAX_STEPS = 2, 8
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


def _stage_h(rows: int, splits: int) -> int:
    """Floats of the H stage's staging: the pieces of S^T (re, im) and of
    the G chunk (re, im, and −im at 64 rows)."""
    p = TIERS[splits]
    if rows == 64:  # unpadded, for wgmma
        return 2 * p * _COLS * _UK + 3 * p * rows * _UK
    return 2 * p * _COLS * _GS + 2 * p * rows * _GS


def _x_bytes(wc: int, rows: int) -> int:
    """Shared memory of X: ``rows`` rows of [Xr | Xi] over the bins padded
    to 32, and 4 floats of padding."""
    return 4 * rows * (2 * (-(-wc // _KB) * _KB) + 4)


# Spectra dtype → the kernel-entry tag; maps dtype → the entry suffix.
_SPECTRA_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAPS_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16maps"}


def _stack(wc: int, blocks: int, splits: int = 3) -> tuple[int, int]:
    """(ring steps, shared-memory bytes) of a ``blocks``-block stack at
    packed width ``wc``, with the most channels a step (4, 2, 1) that leave
    room for 2 steps; (0, 0) where even 1 does not."""
    segment = 16 * ((4 * min(wc, _COLS) + 11) // 16 + 1)
    per_channel = 2 * (blocks + 1) * (_STACK_ROWS // blocks) * segment
    x = _x_bytes(wc, 64)
    left = SMEM_LIMIT_BYTES - x - 4 * _STACK_STAGE
    for channels in (4, 2, 1):
        steps = min(max(left, 0) // (channels * per_channel), _MAX_STEPS)
        if steps >= _MIN_STEPS:
            ring = steps * channels * per_channel
            return steps, x + max(4 * _STACK_STAGE + ring, 4 * _stage_w(64, splits))
    return 0, 0


def _tile_smem_bytes(wc: int, rows: int, blocks: int = 1, splits: int = 3) -> int:
    """Shared memory of the configuration of ``rows`` rows stacking
    ``blocks`` blocks at packed width ``wc`` and tier ``splits``."""
    if blocks > 1:
        return _stack(wc, blocks, splits)[1]
    return _x_bytes(wc, rows) + 4 * max(_stage_h(rows, splits), _stage_w(rows, splits))


def blocks_per_cta(wc: int, vh: int, splits: int = 3) -> int:
    """Blocks one CTA stacks at packed width ``wc``, window height ``vh``
    and tier ``splits``: min(64 // vh, 16) for windows of at most 32 rows
    where that configuration fits with a ring of 2 steps or more beside the
    W stage's buffers, else 1."""
    _check_splits(splits)
    g = min(64 // vh, _MAX_GROUP) if vh <= 32 else 1
    if g == 1:
        return 1
    steps, smem = _stack(wc, g, splits)
    return g if steps >= _MIN_STEPS and smem <= SMEM_LIMIT_BYTES else 1


def tile_rows(wc: int, vh: int, splits: int = 3) -> int:
    """Rows one CTA holds: 64 (stacked, or one block's window rows where
    that configuration's shared memory fits), else 32."""
    if blocks_per_cta(wc, vh, splits) > 1:
        return 64
    return 64 if _tile_smem_bytes(wc, 64, splits=splits) <= SMEM_LIMIT_BYTES else 32


def smem_bytes(wc: int, vh: int, splits: int = 3) -> int:
    """Shared memory the CUDA kernels need at packed width ``wc``, window
    height ``vh`` and tier ``splits``."""
    return _tile_smem_bytes(
        wc, tile_rows(wc, vh, splits), blocks_per_cta(wc, vh, splits), splits
    )


def row_chunks(wc: int, vh: int, splits: int = 3) -> int:
    """CTAs that split one block's window rows: 1 where blocks stack, else
    ceil(vh / tile_rows)."""
    if blocks_per_cta(wc, vh, splits) > 1:
        return 1
    return -(-vh // tile_rows(wc, vh, splits))


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
    tile, inside which the kernel index runs fastest and then the block
    group. As many kernels as ``L2_TILE_BYTES`` of their spectra hold (the
    whole bank where it fits: the kernel index fastest, the other
    configurations' order), so a tile's spectra stay in L2 while the data
    spectra pass once per tile."""
    n = bank.shape[0]
    if blocks_per_cta(wc, vh, splits) == 1:
        return n
    per_kernel = 2 * bank[0].numel() * bank.element_size()
    return max(1, min(n, L2_TILE_BYTES // per_kernel))


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
) -> torch.Tensor:
    """Plain torch version of the fused kernel at synthesis tier ``splits``
    (None: ``fused_splits`` of the spectra's dtype) → (B, N, out_h, out_w)
    maps in ``out_dtype``: bf16 planes are upcast to float32 first. IEEE
    fp32 at every tier but ``BF16IO``, which rounds S, G, X and M to bf16
    right before each product (exact products, fp32 sums, the kernels'
    4-product complex form). float64 planes run in float64, with
    ``out_dtype=torch.float64`` for float64 maps (the checks' exact
    reference). Differentiable; used on the CPU and by the tests."""
    if out_dtype != torch.float64:
        _check_out_dtype(out_dtype)
    b, nbh, nbw, f, n, lh, wc, vh, vw = _geometry(
        dr, kr, block_h, block_w, kh, kw, out_h, out_w
    )
    rnd = bf16_round if _resolve_splits(splits, dr.dtype) == BF16IO else (lambda x: x)
    dr, di, kr, ki = (upcast(t) for t in (dr, di, kr, ki))
    gr, gi, mr, mi = (
        rnd(m.to(dr.dtype))
        for m in _window_mats(block_h, block_w, kh, kw, str(dr.device))
    )

    def mac(d, k):
        return torch.einsum("bijfuv,nfuv->bijnuv", d, k)

    s_re = rnd(mac(dr, kr) - mac(di, ki))  # (B, nbh, nbw, N, Lh, Wc)
    s_im = rnd(mac(di, kr) + mac(dr, ki))
    x_re = rnd(gr @ s_re - gi @ s_im)  # (B, nbh, nbw, N, Vh, Wc)
    x_im = rnd(gr @ s_im + gi @ s_re)
    tile = x_re @ mr + x_im @ mi  # (B, nbh, nbw, N, Vh, Vw)
    maps = tile.permute(0, 3, 1, 4, 2, 5).reshape(b, n, nbh * vh, nbw * vw)
    return maps[:, :, :out_h, :out_w].contiguous().to(out_dtype)


def cuda_operands(name: str, ops) -> tuple[torch.device, str]:
    """Check what the port's CUDA kernels take of their (re, im, re, im)
    spectra: one CUDA device, float32 or bfloat16 (one dtype for all four),
    contiguous, re/im planes of one shape → (the device, the dtype's entry
    tag 'f32' or 'bf16')."""
    dr, di, kr, ki = ops
    dev = dr.device
    validate(
        dev.type == "cuda" and all(t.device == dev for t in ops),
        f"{name} operands must share one CUDA device; got "
        f"{[str(t.device) for t in ops]}",
    )
    if dr.dtype not in _SPECTRA_TAGS or any(t.dtype != dr.dtype for t in ops):
        raise InvalidInputError(
            f"{name} kernel takes float32 or bfloat16 spectra, one dtype for "
            f"all four planes; got {[str(t.dtype) for t in ops]}"
        )
    for t in ops:
        validate(t.is_contiguous(), f"{name} kernel takes contiguous spectra")
    validate(
        di.shape == dr.shape and ki.shape == kr.shape,
        "re/im planes differ in shape",
    )
    return dev, _SPECTRA_TAGS[dr.dtype]


def count_launch(wrapper, mode: str) -> None:
    """One launch of ``wrapper``'s kernel in dtype mode ``mode`` (the C
    entry's name without its ``fftconv_`` prefix)."""
    wrapper.launches += 1
    wrapper.launches_by_mode[mode] += 1


def reset_launches(*wrappers) -> None:
    """Set the launch counts of ``wrappers`` to zero (by mode, and by shape
    where a wrapper keeps them)."""
    for w in wrappers:
        w.launches = 0
        w.launches_by_mode.clear()
        if hasattr(w, "launches_by_shape"):
            w.launches_by_shape.clear()


def _check_smem(block_w: int, wc: int, vh: int, splits: int) -> None:
    validate(
        smem_bytes(wc, vh, splits) <= SMEM_LIMIT_BYTES,
        f"block width {block_w} needs {smem_bytes(wc, vh, splits)} B of shared "
        f"memory at {tier_name(splits)} (limit {SMEM_LIMIT_BYTES})",
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
) -> torch.Tensor:
    """→ (B, N, out_h, out_w) maps in ``out_dtype``. CPU tensors run
    ``block_conv_reference`` at the tier; CUDA tensors launch the CUDA
    kernel entry of their (spectra, maps) dtypes and synthesis tier
    ``splits`` (None: ``fused_splits``, read from the config) on the
    current stream (no synchronisation) and count the launch in
    ``block_conv.launches``, per mode (the entry's name without
    ``fftconv_``: ``block_conv_f32``, ``block_conv_f32_x6``,
    ``block_conv_bf16_io``, …) in ``block_conv.launches_by_mode`` and per
    (mode, block_h, block_w, kh, kw) in ``block_conv.launches_by_shape``."""
    _check_out_dtype(out_dtype)
    ops = (dr, di, kr, ki)
    splits = _resolve_splits(splits, dr.dtype)
    if all(t.device.type == "cpu" for t in ops):
        return block_conv_reference(
            dr, di, kr, ki, block_h, block_w, kh, kw, out_h, out_w, out_dtype, splits
        )
    dev, tag = cuda_operands("block_conv", ops)
    b, nbh, nbw, f, n, lh, wc, vh, vw = _geometry(
        dr, kr, block_h, block_w, kh, kw, out_h, out_w
    )
    _check_smem(block_w, wc, vh, splits)
    from cuda_fft_convolution_torch._build import library

    lib = library()
    gt_re, gt_im, g_pad, m_tc = _kernel_mats(block_h, block_w, kh, kw, str(dev), splits)
    mode = f"block_conv_{tag}{_MAPS_SUFFIX[out_dtype]}{TIER_SUFFIX[splits]}"
    ktile = kernel_tile(wc, vh, kr, splits)
    out = torch.empty((b, n, out_h, out_w), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"fftconv_{mode}")(
            dr.data_ptr(), di.data_ptr(), kr.data_ptr(), ki.data_ptr(),
            gt_re.data_ptr(), gt_im.data_ptr(), g_pad.data_ptr(), m_tc.data_ptr(),
            out.data_ptr(),
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
    block_h: int, block_w: int, kh: int, kw: int, device: str, splits: int = 3
):
    """The kernels' matrix operands at tier ``splits`` (csrc/block_conv.cuh
    launch_block_conv) → (gt_re, gt_im, g_pad, m_tc): G^T (Lh, Vh), re and
    im, exact — the block-stacked configuration's fp32 H stage stages G by
    spectrum rows; G (2, Vh padded to 64, Lh padded to 16) = re, im, exact
    — the tensor-core H stage's A operand, split in the kernel as it is
    staged; and M^T's planes in core matrices, the W stage's B operand,
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
    cache key."""
    gr, gi, mr, mi = _window_mats(block_h, block_w, kh, kw, device)
    if splits == BF16IO:
        gr, gi, mr, mi = (bf16_round(m) for m in (gr, gi, mr, mi))
    (vh, lh), (wc, vw) = gr.shape, mr.shape
    g_pad = torch.zeros((2, -(-vh // 64) * 64, -(-lh // _UK) * _UK), device=device)
    g_pad[0, :vh, :lh], g_pad[1, :vh, :lh] = gr, gi
    bins = -(-wc // _KB) * _KB
    cols = -(-vw // _COLS) * _COLS
    m_t = torch.zeros((cols, 2 * bins), device=device)
    m_t[:vw, :wc], m_t[:vw, bins : bins + wc] = mr.t(), mi.t()
    rows = tile_rows(wc, block_h - kh + 1, splits)
    pieces = m_planes(rows, splits)
    planes = torch.stack([m_t] if pieces < TIERS[splits] else tf32_split(m_t, pieces))
    m_tc = planes.reshape(pieces, cols // 8, 8, bins // 2, 4).permute(0, 1, 3, 2, 4).contiguous()
    return gr.t().contiguous(), gi.t().contiguous(), g_pad, m_tc


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the peaks kernel: ``block_conv_reference`` at
    tier ``splits`` (f32 maps, bf16 planes upcast), then ``cell_peaks``
    over one-block cells and ``group_cells`` over cells of ``mbh × mbw``
    blocks → (vals f32, idxs int32), each (B, N, ceil(nbh / mbh),
    ceil(nbw / mbw))."""
    maps = block_conv_reference(
        dr, di, kr, ki, block_h, block_w, kh, kw, out_h, out_w, splits=splits
    )
    vals, idxs = cell_peaks(
        maps, dr.shape[1], dr.shape[2], block_h - kh + 1, block_w - kw + 1
    )
    return group_cells(vals, idxs, mbh, mbw)


def block_conv_peaks(
    dr: torch.Tensor, di: torch.Tensor,  # (B, nbh, nbw, F, Lh, Wc) f32/bf16
    kr: torch.Tensor, ki: torch.Tensor,  # (N, F, Lh, Wc) f32/bf16
    block_h: int, block_w: int, kh: int, kw: int, out_h: int, out_w: int,
    splits: int | None = None, mbh: int | None = None, mbw: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-cell max pyramid of the fused block conv, with no maps
    written → ``(vals, idxs)``, each (B, N, ceil(nbh / mbh), ceil(nbw /
    mbw)): the max response of each cell of ``mbh × mbw`` blocks' valid
    windows (clipped at (out_h, out_w)) and its global flat index
    y·out_w + x (int32). Larger value wins; between equal values the
    smaller index, in the JAX package's order across a cell's blocks
    (``group_cells``); positions past (out_h, out_w) never win. The values
    are float32 and the indices int32 at either spectra dtype.

    This is the JAX package's ``block_conv_peaks_pallas(..., mbh, mbw)``.
    ``mbh = mbw = None`` (or 1) is one cell per block: the JAX package
    picks its groups by a model of TPU VMEM (``_choose_group``,
    ``lookup_fused_group``), which Hopper does not have; reducing the
    pyramid over cells gives the exact per-kernel top-1 at any grouping.

    CPU tensors run ``block_conv_peaks_reference``; CUDA tensors launch the
    CUDA kernel entry of their spectra dtype and synthesis tier ``splits``
    (None: ``fused_splits``) on the current stream and count the launch in
    ``block_conv_peaks.launches`` and, per mode, in
    ``block_conv_peaks.launches_by_mode``. A CTA holds one block (or a
    stack of blocks), so the kernel writes one pair per (block, row chunk
    of ``tile_rows`` window rows; ``row_chunks``); a block split into
    several row chunks is combined here (first maximum over chunks: chunk
    r's rows all precede chunk r+1's, so that keeps the tie rule), and the
    blocks into cells by ``group_cells``."""
    ops = (dr, di, kr, ki)
    splits = _resolve_splits(splits, dr.dtype)
    _check_group(mbh, mbw)
    if all(t.device.type == "cpu" for t in ops):
        return block_conv_peaks_reference(
            dr, di, kr, ki, block_h, block_w, kh, kw, out_h, out_w, splits, mbh, mbw
        )
    dev, tag = cuda_operands("block_conv_peaks", ops)
    b, nbh, nbw, f, n, lh, wc, vh, vw = _geometry(
        dr, kr, block_h, block_w, kh, kw, out_h, out_w
    )
    _check_smem(block_w, wc, vh, splits)
    _check_index_range(nbh, nbw, vh, vw, out_w)
    from cuda_fft_convolution_torch._build import library

    lib = library()
    gt_re, gt_im, g_pad, m_tc = _kernel_mats(block_h, block_w, kh, kw, str(dev), splits)
    chunks = row_chunks(wc, vh, splits)
    ktile = kernel_tile(wc, vh, kr, splits)
    shape = (b, n, nbh, chunks, nbw)
    vals = torch.empty(shape, dtype=torch.float32, device=dev)
    idxs = torch.empty(shape, dtype=torch.int32, device=dev)
    mode = f"block_conv_peaks_{tag}{TIER_SUFFIX[splits]}"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"fftconv_{mode}")(
            dr.data_ptr(), di.data_ptr(), kr.data_ptr(), ki.data_ptr(),
            gt_re.data_ptr(), gt_im.data_ptr(), g_pad.data_ptr(), m_tc.data_ptr(),
            vals.data_ptr(), idxs.data_ptr(),
            b, nbh, nbw, f, n, lh, wc, vh, vw, out_h, out_w, ktile, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"block_conv_peaks CUDA kernel launch failed: cudaError {err}"
        )
    count_launch(block_conv_peaks, mode)
    if chunks == 1:
        vals, idxs = vals[:, :, :, 0], idxs[:, :, :, 0]
    else:
        best = vals.argmax(dim=3, keepdim=True)
        vals, idxs = vals.gather(3, best)[:, :, :, 0], idxs.gather(3, best)[:, :, :, 0]
    return group_cells(vals, idxs, mbh, mbw)


block_conv_peaks.launches = 0
block_conv_peaks.launches_by_mode = collections.Counter()
