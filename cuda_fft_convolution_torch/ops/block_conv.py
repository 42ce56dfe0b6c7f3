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
(``store_dtype='bfloat16'``, the JAX kernel's BF16IO mode); the maps are
float32, or bfloat16 with ``out_dtype=torch.bfloat16``. Both kernels read
bf16 spectra and widen them to fp32 in registers, so all arithmetic is fp32
and bf16 spectra give exactly the fp32 result on the bf16-rounded planes;
bf16 maps round each fp32 value once, at its store. The plain versions do
the same: they upcast bf16 planes to float32, run the fp32 computation, and
cast the maps to ``out_dtype``.

``block_conv`` is the wrapper: a tensor on the CPU takes
``block_conv_reference`` (plain torch); a CUDA tensor launches the CUDA
kernel (``csrc/block_conv.cu``) or raises. There is no fallback between the
two.

``block_conv_peaks`` computes the same tiles and keeps, per cell, only the
max and its global flat index (the detection head's pyramid); its kernel
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
from cuda_fft_convolution_torch.utils.errors import InvalidInputError, validate

# Mirrors csrc/block_conv.cuh's configuration rule. A CTA holds X, 64 rows
# (32 where that does not fit) × [Xr | Xi] over the packed bins padded to 32
# (a row stride of 2·bins + 4 floats), plus a staging area, within Hopper's
# 227 KB (232,448 B) per-block shared-memory limit. The staging area is the
# larger of the H stage's (S^T, 128 bins, and a G chunk, as TF32 hi and lo
# planes of 16 spectrum rows, with −Gi's at 64 rows: 14,336 floats for 64
# rows, 12,800 for 32 rows padded to 20 floats) and the W stage's (a ring of
# two 32-row chunks of [Mr ; Mi] as M^T's TF32 hi and lo planes, 128 columns
# each: 16,384 floats). For windows of at most 32 rows it stacks
# g = min(64 // vh, 16) blocks of one (image, kernel) in 64 rows, where
# that fits: after X, the larger of the W stage's buffers and S and G^T
# (5120 floats) followed by a ring of 2 to 8 steps (as many as the limit
# leaves room for) of 4, 2 or 1 channels (the most that leave room for 2
# steps) × 2·(g + 1)·(16 // g) row segments, each the 16-byte chunks that
# can hold min(wc, 128) fp32 values. bf16 spectra fill the same bytes with
# up to 8 channels a step.
SMEM_LIMIT_BYTES = 232448
_COLS = 128
_KB = 32
_UK = 16
_GS = _UK + 4
_KC = 32  # rows of [Mr ; Mi] per W-stage chunk
_STAGE_W = 2 * 2 * _COLS * _KC
_MAX_GROUP = 16
_STACK_ROWS = 16
_STACK_STAGE = 2 * _STACK_ROWS * _COLS + 2 * 8 * 64
_MIN_STEPS, _MAX_STEPS = 2, 8


def _x_bytes(wc: int, rows: int) -> int:
    """Shared memory of X: ``rows`` rows of [Xr | Xi] over the bins padded
    to 32, and 4 floats of padding."""
    return 4 * rows * (2 * (-(-wc // _KB) * _KB) + 4)


# Spectra dtype → the kernel-entry tag; maps dtype → the entry suffix.
_SPECTRA_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAPS_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16maps"}


def _stack(wc: int, blocks: int) -> tuple[int, int]:
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
            return steps, x + max(4 * _STACK_STAGE + ring, 4 * _STAGE_W)
    return 0, 0


def _tile_smem_bytes(wc: int, rows: int, blocks: int = 1) -> int:
    """Shared memory of the configuration of ``rows`` rows stacking
    ``blocks`` blocks at packed width ``wc``."""
    if blocks > 1:
        return _stack(wc, blocks)[1]
    if rows == 64:  # S^T and G (with -Gi) unpadded, for wgmma
        stage_h = 4 * _COLS * _UK + 6 * rows * _UK
    else:
        stage_h = 4 * _COLS * _GS + 4 * rows * _GS
    return _x_bytes(wc, rows) + 4 * max(stage_h, _STAGE_W)


def blocks_per_cta(wc: int, vh: int) -> int:
    """Blocks one CTA stacks at packed width ``wc`` and window height
    ``vh``: min(64 // vh, 16) for windows of at most 32 rows where that
    configuration fits with a ring of 2 steps or more beside the W stage's
    buffers, else 1."""
    g = min(64 // vh, _MAX_GROUP) if vh <= 32 else 1
    if g == 1:
        return 1
    steps, smem = _stack(wc, g)
    return g if steps >= _MIN_STEPS and smem <= SMEM_LIMIT_BYTES else 1


def tile_rows(wc: int, vh: int) -> int:
    """Rows one CTA holds: 64 (stacked, or one block's window rows where
    that configuration's shared memory fits), else 32."""
    if blocks_per_cta(wc, vh) > 1:
        return 64
    return 64 if _tile_smem_bytes(wc, 64) <= SMEM_LIMIT_BYTES else 32


def smem_bytes(wc: int, vh: int) -> int:
    """Shared memory the CUDA kernels need at packed width ``wc`` and window
    height ``vh``."""
    return _tile_smem_bytes(wc, tile_rows(wc, vh), blocks_per_cta(wc, vh))


def row_chunks(wc: int, vh: int) -> int:
    """CTAs that split one block's window rows: 1 where blocks stack, else
    ceil(vh / tile_rows)."""
    return 1 if blocks_per_cta(wc, vh) > 1 else -(-vh // tile_rows(wc, vh))


# Kernel spectra (re and im) a launch tile of the stacked configuration
# keeps in L2 while every block group passes them.
L2_TILE_BYTES = 8 << 20


def kernel_tile(wc: int, vh: int, bank: torch.Tensor) -> int:
    """The stacked configuration's launch order: the kernels of one launch
    tile, inside which the kernel index runs fastest and then the block
    group. As many kernels as ``L2_TILE_BYTES`` of their spectra hold (the
    whole bank where it fits: the kernel index fastest, the other
    configurations' order), so a tile's spectra stay in L2 while the data
    spectra pass once per tile."""
    n = bank.shape[0]
    if blocks_per_cta(wc, vh) == 1:
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


def block_conv_reference(
    dr: torch.Tensor, di: torch.Tensor,  # (B, nbh, nbw, F, Lh, Wc) f32/bf16
    kr: torch.Tensor, ki: torch.Tensor,  # (N, F, Lh, Wc) f32/bf16
    block_h: int, block_w: int, kh: int, kw: int, out_h: int, out_w: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain torch version of the fused kernel → (B, N, out_h, out_w) maps
    in ``out_dtype``: bf16 planes are upcast to float32 first. Differentiable;
    used on the CPU and by the tests."""
    _check_out_dtype(out_dtype)
    b, nbh, nbw, f, n, lh, wc, vh, vw = _geometry(
        dr, kr, block_h, block_w, kh, kw, out_h, out_w
    )
    dr, di, kr, ki = (upcast(t) for t in (dr, di, kr, ki))
    gr, gi, mr, mi = _window_mats(block_h, block_w, kh, kw, str(dr.device))

    def mac(d, k):
        return torch.einsum("bijfuv,nfuv->bijnuv", d, k)

    s_re = mac(dr, kr) - mac(di, ki)  # (B, nbh, nbw, N, Lh, Wc)
    s_im = mac(di, kr) + mac(dr, ki)
    x_re = gr @ s_re - gi @ s_im  # (B, nbh, nbw, N, Vh, Wc)
    x_im = gr @ s_im + gi @ s_re
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


def _check_smem(block_w: int, wc: int, vh: int) -> None:
    validate(
        smem_bytes(wc, vh) <= SMEM_LIMIT_BYTES,
        f"block width {block_w} needs {smem_bytes(wc, vh)} B of shared memory "
        f"(limit {SMEM_LIMIT_BYTES})",
    )


def block_conv(
    dr: torch.Tensor, di: torch.Tensor,  # (B, nbh, nbw, F, Lh, Wc) f32/bf16
    kr: torch.Tensor, ki: torch.Tensor,  # (N, F, Lh, Wc) f32/bf16
    block_h: int, block_w: int, kh: int, kw: int, out_h: int, out_w: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """→ (B, N, out_h, out_w) maps in ``out_dtype``. CPU tensors run
    ``block_conv_reference``; CUDA tensors launch the CUDA kernel entry of
    their (spectra, maps) dtypes on the current stream (no synchronisation)
    and count the launch in ``block_conv.launches``, per mode in
    ``block_conv.launches_by_mode`` and per (mode, block_h, block_w, kh,
    kw) in ``block_conv.launches_by_shape``."""
    _check_out_dtype(out_dtype)
    ops = (dr, di, kr, ki)
    if all(t.device.type == "cpu" for t in ops):
        return block_conv_reference(
            dr, di, kr, ki, block_h, block_w, kh, kw, out_h, out_w, out_dtype
        )
    dev, tag = cuda_operands("block_conv", ops)
    b, nbh, nbw, f, n, lh, wc, vh, vw = _geometry(
        dr, kr, block_h, block_w, kh, kw, out_h, out_w
    )
    _check_smem(block_w, wc, vh)
    from cuda_fft_convolution_torch._build import library

    lib = library()
    gt_re, gt_im, g_pad, m_tc = _kernel_mats(block_h, block_w, kh, kw, str(dev))
    mode = f"block_conv_{tag}{_MAPS_SUFFIX[out_dtype]}"
    ktile = kernel_tile(wc, vh, kr)
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


@functools.lru_cache(maxsize=16)
def _kernel_mats(block_h: int, block_w: int, kh: int, kw: int, device: str):
    """The kernels' matrix operands (csrc/block_conv.cuh launch_block_conv)
    → (gt_re, gt_im, g_pad, m_tc): G^T (Lh, Vh), re and im, exact — the
    block-stacked configuration's fp32 H stage stages G by spectrum rows;
    G (2, Vh padded to 64, Lh padded to 16) = re, im, exact — the
    tensor-core H stage's A operand, split in the kernel as it is staged;
    and M^T's TF32 hi and lo planes in core matrices, the W stage's B
    operand, which wgmma reads from shared memory as it is: M^T is (Vw
    padded to 128, 2·Wc'), Wc' = Wc padded to 32, row c holding column c of
    [Mr ; Mi] (Mr at k < Wc, Mi from k = Wc'); hi = tf32(M^T), lo =
    tf32(M^T − hi); m_tc[p, c // 8, k // 4, c % 8, k % 4] is plane p (hi,
    lo) at (c, k), 8 columns × 4 k of 128 contiguous bytes a core matrix.
    Zeros fill every padding."""
    gr, gi, mr, mi = _window_mats(block_h, block_w, kh, kw, device)
    (vh, lh), (wc, vw) = gr.shape, mr.shape
    g_pad = torch.zeros((2, -(-vh // 64) * 64, -(-lh // _UK) * _UK), device=device)
    g_pad[0, :vh, :lh], g_pad[1, :vh, :lh] = gr, gi
    bins = -(-wc // _KB) * _KB
    cols = -(-vw // _COLS) * _COLS
    m_t = torch.zeros((cols, 2 * bins), device=device)
    m_t[:vw, :wc], m_t[:vw, bins : bins + wc] = mr.t(), mi.t()
    hi = tf32(m_t)
    planes = torch.stack([hi, tf32(m_t - hi)])
    m_tc = planes.reshape(2, cols // 8, 8, bins // 2, 4).permute(0, 1, 3, 2, 4).contiguous()
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


def block_conv_peaks_reference(
    dr: torch.Tensor, di: torch.Tensor,  # (B, nbh, nbw, F, Lh, Wc) f32/bf16
    kr: torch.Tensor, ki: torch.Tensor,  # (N, F, Lh, Wc) f32/bf16
    block_h: int, block_w: int, kh: int, kw: int, out_h: int, out_w: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the peaks kernel: ``block_conv_reference``
    (f32 maps, bf16 planes upcast), then ``cell_peaks`` over one-block
    cells → (vals f32, idxs int32), each (B, N, nbh, nbw)."""
    maps = block_conv_reference(
        dr, di, kr, ki, block_h, block_w, kh, kw, out_h, out_w
    )
    return cell_peaks(
        maps, dr.shape[1], dr.shape[2], block_h - kh + 1, block_w - kw + 1
    )


def block_conv_peaks(
    dr: torch.Tensor, di: torch.Tensor,  # (B, nbh, nbw, F, Lh, Wc) f32/bf16
    kr: torch.Tensor, ki: torch.Tensor,  # (N, F, Lh, Wc) f32/bf16
    block_h: int, block_w: int, kh: int, kw: int, out_h: int, out_w: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-cell block-max pyramid of the fused block conv, with no maps
    written → ``(vals, idxs)``, each (B, N, nbh, nbw): the max response of
    each block's valid window (clipped at (out_h, out_w)) and its global
    flat index y·out_w + x (int32). Larger value wins; between equal values
    the smaller index; positions past (out_h, out_w) never win. The values
    are float32 and the indices int32 at either spectra dtype.

    This is the JAX package's ``block_conv_peaks_pallas(..., mbh=1,
    mbw=1)``: one cell per block. The JAX package groups blocks into larger
    cells by a model of TPU VMEM (``_choose_group``,
    ``lookup_fused_group``); on Hopper a CTA may stack several short blocks
    (``blocks_per_cta``), but it still writes one pair per block. Reducing
    the pyramid over cells gives the exact per-kernel top-1 either way.

    CPU tensors run ``block_conv_peaks_reference``; CUDA tensors launch the
    CUDA kernel entry of their spectra dtype on the current stream and
    count the launch in ``block_conv_peaks.launches`` and, per mode, in
    ``block_conv_peaks.launches_by_mode``. The kernel writes one pair per (cell,
    row chunk of ``tile_rows`` window rows; ``row_chunks``); a cell split into
    several row chunks is combined here (first maximum over chunks: chunk
    r's rows all precede chunk r+1's, so that keeps the tie rule)."""
    ops = (dr, di, kr, ki)
    if all(t.device.type == "cpu" for t in ops):
        return block_conv_peaks_reference(
            dr, di, kr, ki, block_h, block_w, kh, kw, out_h, out_w
        )
    dev, tag = cuda_operands("block_conv_peaks", ops)
    b, nbh, nbw, f, n, lh, wc, vh, vw = _geometry(
        dr, kr, block_h, block_w, kh, kw, out_h, out_w
    )
    _check_smem(block_w, wc, vh)
    _check_index_range(nbh, nbw, vh, vw, out_w)
    from cuda_fft_convolution_torch._build import library

    lib = library()
    gt_re, gt_im, g_pad, m_tc = _kernel_mats(block_h, block_w, kh, kw, str(dev))
    chunks = row_chunks(wc, vh)
    ktile = kernel_tile(wc, vh, kr)
    shape = (b, n, nbh, chunks, nbw)
    vals = torch.empty(shape, dtype=torch.float32, device=dev)
    idxs = torch.empty(shape, dtype=torch.int32, device=dev)
    mode = f"block_conv_peaks_{tag}"
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
        return vals[:, :, :, 0], idxs[:, :, :, 0]
    best = vals.argmax(dim=3, keepdim=True)
    return (
        vals.gather(3, best)[:, :, :, 0],
        idxs.gather(3, best)[:, :, :, 0],
    )


block_conv_peaks.launches = 0
block_conv_peaks.launches_by_mode = collections.Counter()
