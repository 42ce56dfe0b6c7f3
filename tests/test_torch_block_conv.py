"""The fused block-conv (ops/block_conv.py) against the JAX package's
``block_conv_pallas``.

On the CPU the port's wrapper runs the kernel's plain version, which is
held here to the Pallas kernel run in interpret mode (where bf16x3 dots
become HIGHEST, so the reference is exact fp32): its v3 body, the function
the CUDA kernel reproduces, and the v5 body the TPU headline runs. The CUDA
kernel itself is checked against the plain version on the card by
``tests/test_torch_gpu.py`` and by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fft_convolution_torch.ops import block_conv as tbc
from cuda_fft_convolution_torch.utils.errors import InvalidInputError
from cuda_fft_convolution_tpu.ops.block_conv import (
    block_conv_pallas,
    radix_h_legal,
    radix_w_legal,
)
from cuda_fft_convolution_tpu.ops.tiled import fft_data_blocks

TOL = 1e-5


def _operands(rng, b, f, n, bh, bw, kh, kw, out_h, out_w):
    """Block spectra of random data with a baked 'same' window (JAX
    fft_data_blocks) and random bank spectra, as numpy f32 planes."""
    data = rng.standard_normal((b, f, out_h, out_w)).astype(np.float32)
    d_re, d_im = fft_data_blocks(
        jnp.asarray(data), bh, bw, kh, kw, origin_h=(kh - 1) // 2,
        origin_w=(kw - 1) // 2, win_h=out_h, win_w=out_w,
    )
    wc = bw // 2 + 1
    k_re = rng.standard_normal((n, f, bh, wc)).astype(np.float32)
    k_im = rng.standard_normal((n, f, bh, wc)).astype(np.float32)
    return np.array(d_re), np.array(d_im), k_re, k_im


def _torch(*xs):
    return [torch.as_tensor(x) for x in xs]


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize(
    "b,f,n,bh,bw,kh,kw,out_h,out_w",
    [
        # dense-DFT plan of 300×500 with 17×33 kernels: V = (16, 256)
        (2, 3, 5, 32, 288, 17, 33, 100, 300),
        # odd block, V = (36, 128); out not a multiple of V (clipped tiles)
        (1, 2, 3, 45, 151, 10, 24, 100, 300),
        # F=1, even block, full-height window
        (1, 1, 4, 64, 256, 1, 1, 130, 270),
    ],
)
def test_block_conv_reference_matches_jax_v3(rng, b, f, n, bh, bw, kh, kw,
                                             out_h, out_w):
    ops = _operands(rng, b, f, n, bh, bw, kh, kw, out_h, out_w)
    want = block_conv_pallas(
        *map(jnp.asarray, ops), bh, bw, kh, kw, out_h, out_w,
        interpret=True, wstack=True, radix_h=False,
    )
    got = tbc.block_conv_reference(*_torch(*ops), bh, bw, kh, kw, out_h, out_w)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= TOL


def test_block_conv_reference_matches_jax_v5(rng):
    """The production v5 body (radix-2 H stage + radix-2 DIF W stage) at its
    registered fp32 F=1 plan: the port reproduces what the TPU headline
    runs, not only the plain v3 form."""
    bh, bw, kh, kw, out_h, out_w = 256, 512, 65, 129, 300, 500
    assert radix_h_legal(bh, bh - kh + 1) and radix_w_legal(bw, kw, bw - kw + 1)
    ops = _operands(rng, 1, 1, 2, bh, bw, kh, kw, out_h, out_w)
    want = block_conv_pallas(
        *map(jnp.asarray, ops), bh, bw, kh, kw, out_h, out_w,
        interpret=True, radix_h=True, radix_w=True,
    )
    got = tbc.block_conv_reference(*_torch(*ops), bh, bw, kh, kw, out_h, out_w)
    assert _rel(got.numpy(), want) <= TOL


# A geometry that both of the JAX package's radix legality rules admit, at
# a small size: blocks 32 × 512, Vh 24, Vw 384 (radix_h_legal: Lh/2 = 16 and
# Lh − Vh = 8 are 8-aligned; radix_w_legal: W a multiple of 512, the
# halves-split store boundary W/2 − (kw − 1) = 128 on a lane-tile edge).
RADIX_GEOM = (32, 512, 9, 129, 40, 500)
BF16_TOL = 2e-2  # the bf16 tier: JAX's BF16IO dots against the port's fp32 arithmetic


def test_block_conv_reference_matches_jax_v4(rng):
    """The v4 body (``radix_h=True``, ``radix_w=False``: v3 with the H
    inverse split radix-2 over pre-permuted even and odd rows, then a
    twiddle combine) at a geometry ``radix_h_legal`` admits: the port's
    plain version reproduces it."""
    bh, bw, kh, kw, out_h, out_w = RADIX_GEOM
    assert radix_h_legal(bh, bh - kh + 1)
    ops = _operands(rng, 1, 2, 3, *RADIX_GEOM)
    want = block_conv_pallas(*map(jnp.asarray, ops), *RADIX_GEOM, interpret=True,
                             radix_h=True, radix_w=False)
    got = tbc.block_conv_reference(*_torch(*ops), *RADIX_GEOM)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_conv_reference_matches_jax_v5x(rng, dtype):
    """The v5x body (``xsliver=True``: the v5 body with the Nyquist sliver
    synthesized outside the kernel, the JAX tier's F=1 registration), at
    f32 and at BF16IO (bf16 planes): the port's plain version on the same
    planes, within TOL at f32 and the tier bar at bf16."""
    bh, bw, kh, kw, out_h, out_w = RADIX_GEOM
    assert radix_h_legal(bh, bh - kh + 1) and radix_w_legal(bw, kw, bw - kw + 1)
    ops = _operands(rng, 1, 1, 2, *RADIX_GEOM)
    jops = [jnp.asarray(x).astype(dtype) for x in ops]
    want = block_conv_pallas(*jops, *RADIX_GEOM, interpret=True, radix_h=True,
                             radix_w=True, xsliver=True)
    tops = [t.to(getattr(torch, dtype)) for t in _torch(*ops)]
    got = tbc.block_conv_reference(*tops, *RADIX_GEOM)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), np.asarray(want, np.float32)) <= (
        TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize(
    "b,f,n,bh,bw,kh,kw,out_h,out_w",
    [
        (1, 2, 3, 45, 151, 10, 24, 100, 300),
        (2, 1, 2, 32, 288, 17, 33, 40, 300),
    ],
)
def test_block_conv_reference_matches_jax_v2(rng, b, f, n, bh, bw, kh, kw, out_h, out_w):
    """The v2 body (``wstack=False``: a column-stacked H stage and per-block
    W dots), which only an explicit flag reaches: the port's plain version
    reproduces it."""
    ops = _operands(rng, b, f, n, bh, bw, kh, kw, out_h, out_w)
    want = block_conv_pallas(
        *map(jnp.asarray, ops), bh, bw, kh, kw, out_h, out_w,
        interpret=True, wstack=False, radix_h=False,
    )
    got = tbc.block_conv_reference(*_torch(*ops), bh, bw, kh, kw, out_h, out_w)
    assert tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= TOL


def test_block_conv_cpu_runs_plain_version(rng):
    ops = _torch(*_operands(rng, 1, 2, 3, 45, 151, 10, 24, 100, 300))
    before = tbc.block_conv.launches
    got = tbc.block_conv(*ops, 45, 151, 10, 24, 100, 300)
    want = tbc.block_conv_reference(*ops, 45, 151, 10, 24, 100, 300)
    assert torch.equal(got, want)
    assert tbc.block_conv.launches == before  # no kernel launched


def test_block_conv_non_cpu_tensor_never_falls_back(rng):
    """A tensor that is not on the CPU must reach the kernel or raise: here
    'meta' tensors, which no kernel takes, raise."""
    ops = [t.to("meta") for t in _torch(*_operands(rng, 1, 1, 2, 32, 288, 17, 33, 40, 60))]
    before = tbc.block_conv.launches
    with pytest.raises(InvalidInputError, match="one CUDA device"):
        tbc.block_conv(*ops, 32, 288, 17, 33, 40, 60)
    assert tbc.block_conv.launches == before


def test_block_conv_validates_geometry(rng):
    dr, di, kr, ki = _torch(*_operands(rng, 1, 1, 2, 32, 288, 17, 33, 40, 60))
    with pytest.raises(InvalidInputError, match="do not match blocks"):
        tbc.block_conv(dr, di, kr, ki, 32, 290, 17, 33, 40, 60)
    with pytest.raises(InvalidInputError, match="not covered"):
        tbc.block_conv(dr, di, kr, ki, 32, 288, 17, 33, 40 + 3 * 16, 60)
    with pytest.raises(InvalidInputError, match="kernel spectra"):
        tbc.block_conv(dr, di, kr[:, :, :-1], ki[:, :, :-1], 32, 288, 17, 33, 40, 60)


def test_smem_model_matches_kernel_constants():
    # 64-row tiles: X (64 rows of [Xr | Xi] over the bins padded to 32, plus
    # 4 floats) and the W stage's ring (two 32-row chunks of M^T's TF32 hi
    # and lo planes, 128 columns each: 16,384 floats) — 181,248 B at the
    # headline width (Wc = 224, Vh = 64). Past Wc = 320 the 32-row tiles
    # take over; JAX's largest block (1024) still fits.
    assert tbc.smem_bytes(224, 64) == (64 * (2 * 224 + 4) + 16384) * 4 == 181248
    assert tbc.smem_bytes(320, 64) == (64 * (2 * 320 + 4) + 16384) * 4
    assert tbc.smem_bytes(321, 64) == (32 * (2 * 352 + 4) + 16384) * 4
    assert tbc.smem_bytes(449, 64) == (32 * (2 * 480 + 4) + 16384) * 4
    assert tbc.smem_bytes(1024 // 2 + 1, 64) <= tbc.SMEM_LIMIT_BYTES
    assert tbc.smem_bytes(2048 // 2 + 1, 64) > tbc.SMEM_LIMIT_BYTES


def _stacked_smem(wc, g, channels, steps):
    """X for 64 rows (the bins padded to 32, twice, plus 4 floats a row),
    then the larger of the W stage's 16,384 staging floats and S and G^T
    (5120 floats) followed by a ring of ``steps`` steps of ``channels``
    channels × 2·(g + 1)·(16 // g) row segments, each the 16-byte chunks
    that can hold min(wc, 128) fp32 values."""
    bins = -(-wc // 32) * 32
    segment = 4 * ((4 * min(wc, 128) + 11) // 16 + 1)
    ring = steps * channels * 2 * (g + 1) * (16 // g) * segment
    return (64 * (2 * bins + 4) + max(5120 + ring, 16384)) * 4


def _one_block_smem(wc, rows):
    """X, then the W stage's ring of two chunks (16,384 floats), larger than
    the H stage's staging (S^T and G, 14,336 floats at 64 rows)."""
    return (rows * (2 * (-(-wc // 32) * 32) + 4) + 16384) * 4


@pytest.mark.parametrize(
    "wc,vh,blocks,rows,smem,chunks",
    [
        # the DPM plan (27, 139, 12, 12): Vh 16, Wc 70 → 4 blocks a CTA,
        # 3 ring steps of 4 channels
        (70, 16, 4, 64, _stacked_smem(70, 4, 4, 3), 1),
        # Vh = 1: 64 // 1 capped at 16 blocks
        (70, 1, 16, 64, _stacked_smem(70, 16, 4, 3), 1),
        # Vh = 21: 3 blocks, a thread's 8 rows straddle two blocks
        (70, 21, 3, 64, _stacked_smem(70, 3, 4, 3), 1),
        # Vh = 32: 2 blocks; wider blocks leave room for fewer channels
        (70, 32, 2, 64, _stacked_smem(70, 2, 4, 2), 1),
        (129, 32, 2, 64, _stacked_smem(129, 2, 2, 2), 1),
        (256, 32, 2, 64, _stacked_smem(256, 2, 1, 3), 1),
        # two column passes of 4 blocks (Wc 160, 224; Vh 16)
        (160, 16, 4, 64, _stacked_smem(160, 4, 2, 3), 1),
        (224, 16, 4, 64, _stacked_smem(224, 4, 2, 2), 1),
        # Wc 257: three column passes, one channel a ring step
        (257, 16, 4, 64, _stacked_smem(257, 4, 1, 3), 1),
        # Wc 320: a ring of two 1-channel steps beside X; Wc 384: no ring
        # fits, nor X for 64 rows beside the W stage: one block of 32 rows
        (320, 16, 4, 64, _stacked_smem(320, 4, 1, 2), 1),
        (384, 16, 1, 32, _one_block_smem(384, 32), 1),
        # Vh = 33 keeps the one-block 64-row configuration
        (70, 33, 1, 64, _one_block_smem(70, 64), 1),
        # the headline (Wc 224, Vh 64): 181,248 B, one block
        (224, 64, 1, 64, 181248, 1),
        # Wc 320, the widest 64-row block; Wc 321 takes 32 rows, 2 row chunks
        (288, 64, 1, 64, _one_block_smem(288, 64), 1),
        (289, 64, 1, 64, _one_block_smem(289, 64), 1),
        (320, 64, 1, 64, _one_block_smem(320, 64), 1),
        (321, 64, 1, 32, _one_block_smem(321, 32), 2),
        # Wc 449: 32-row tiles, one block, two row chunks at Vh 64
        (449, 16, 1, 32, _one_block_smem(449, 32), 1),
        (449, 64, 1, 32, _one_block_smem(449, 32), 2),
        # the 1024 block (Wc 513, Vh 961): 31 row chunks of 32
        (513, 961, 1, 32, _one_block_smem(513, 32), 31),
    ],
)
def test_configuration_mirror(wc, vh, blocks, rows, smem, chunks):
    """The Python mirror of the kernel's configuration rule: blocks per CTA,
    rows, shared memory and row chunks at (Wc, Vh). chip_smoke.py holds the
    same pairs against the compiled kernel's C entries."""
    assert tbc.blocks_per_cta(wc, vh) == blocks
    assert tbc.tile_rows(wc, vh) == rows
    assert tbc.smem_bytes(wc, vh) == smem <= tbc.SMEM_LIMIT_BYTES
    assert tbc.row_chunks(wc, vh) == chunks


@pytest.mark.parametrize(
    "wc,vh,n,f,dtype,tile",
    [
        # the DPM plan: 1024 bf16 kernels of 234 KB → tiles of 35 kernels
        (70, 16, 1024, 31, torch.bfloat16, (8 << 20) // (2 * 31 * 27 * 70 * 2)),
        # float32 spectra: half as many
        (70, 16, 1024, 31, torch.float32, (8 << 20) // (2 * 31 * 27 * 70 * 4)),
        # a bank that fits the tile: one tile, the kernel index fastest
        (70, 16, 100, 1, torch.float32, 100),
        # the headline (not stacked): the kernel index fastest
        (224, 64, 100, 1, torch.float32, 100),
        (449, 16, 1024, 31, torch.float32, 1024),
    ],
)
def test_kernel_tile_follows_what_fits_l2(wc, vh, n, f, dtype, tile):
    """The stacked configuration launches tiles of as many kernels as 8 MB
    of their spectra hold; the other configurations run the kernel index
    fastest."""
    bank = torch.empty((n, f, 27, wc), dtype=dtype, device="meta")
    assert tbc.kernel_tile(wc, vh, bank) == tile
