"""The fused kernels' bf16 tier, BF16IO, against the JAX package's.

JAX runs bf16 spectra as single-pass bf16 dots (``BF16IO``,
``cuda_fft_convolution_tpu/ops/block_conv.py:683-690``): it rounds S (the
MAC's output), G, X (the H stage's output) and M to bf16 right before each
product and sums the products in f32. The port's plain versions round at
the same places (``ops/block_conv.py block_conv_reference``) and use the
kernels' 4-product complex form, so on the CPU they match JAX's kernels run
in interpret mode with ``karatsuba=False`` (the same form) to ``IO_TOL`` =
5e-5 relative (the sums' order moves a few roundings of S and X by one bf16
step), and JAX's default Karatsuba form to the tier's 2e-2. bf16 maps are
the float32 maps rounded once, within ``IO_TOL`` plus one bf16 step of each
value of JAX's. Peak indices are equal outside near-tie cells (a second
value of the cell's plain maps within ``IO_TOL`` of its max).

Also here: the tier rule, the shared-memory mirror at the tier against the
C side's formulas, the tier's matrix operands, and the explicit 3×TF32
tier on bf16 spectra. The CUDA entries (``…_bf16_io``) are held to the
plain versions on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` step 35."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_fft_convolution_torch as tfc
from cuda_fft_convolution_torch.ops import block_conv as tbc
from cuda_fft_convolution_tpu.ops.block_conv import (
    block_conv_pallas,
    block_conv_peaks_pallas,
)
from tests.oracles import rel_err
from tests.test_torch_bf16 import BLOCK_CASES, _bf16, _block_operands, _f32, _jbf16

IO_TOL = 5e-5
BF16_TOL = 2e-2

# BLOCK_CASES and a block of 64 rows and more (Lh 64, Wc 129)
IO_CASES = [*BLOCK_CASES, (1, 2, 3, 64, 256, 16, 33, 120, 400)]


def _case(rng, b, f, n, bh, bw, kh, kw, h, w):
    ops = _block_operands(rng, b, f, n, bh, bw, kh, kw, h, w)
    return ops, (bh, bw, kh, kw, h, w)


@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,h,w", IO_CASES)
def test_block_conv_bf16io_matches_jax_bf16io(rng, b, f, n, bh, bw, kh, kw, h, w):
    """The plain version on bf16 planes (the default tier, BF16IO) against
    block_conv_pallas on the same planes (BF16IO, karatsuba=False):
    float32 maps within IO_TOL; bf16 maps are the port's float32 maps
    rounded once, and within IO_TOL plus one bf16 step of JAX's."""
    ops, geom = _case(rng, b, f, n, bh, bw, kh, kw, h, w)
    t16, j16 = [_bf16(x) for x in ops], [_jbf16(x) for x in ops]
    got = tbc.block_conv(*t16, *geom)
    want = _f32(block_conv_pallas(*j16, *geom, interpret=True, karatsuba=False))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (b, n, h, w)
    assert rel_err(got.numpy(), want) <= IO_TOL
    got16 = tbc.block_conv(*t16, *geom, torch.bfloat16)
    want16 = _f32(block_conv_pallas(*j16, *geom, interpret=True, karatsuba=False,
                                    out_dtype="bfloat16"))
    assert got16.dtype == torch.bfloat16 and torch.equal(got16, got.to(torch.bfloat16))
    step = 2.0 ** -7 * np.abs(want16)  # one bf16 step of each value, at most
    assert np.all(np.abs(_f32(got16) - want16) <= IO_TOL * np.abs(want16).max() + step)


@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,h,w", IO_CASES)
def test_block_conv_bf16io_matches_jax_default_form(rng, b, f, n, bh, bw, kh, kw, h, w):
    """Against JAX's default (Karatsuba H stage) BF16IO kernel: the same
    tier by another bilinear form, within the tier's bar."""
    ops, geom = _case(rng, b, f, n, bh, bw, kh, kw, h, w)
    got = tbc.block_conv(*map(_bf16, ops), *geom)
    want = block_conv_pallas(*map(_jbf16, ops), *geom, interpret=True)
    assert rel_err(got.numpy(), _f32(want)) <= BF16_TOL


@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,h,w", IO_CASES)
def test_block_conv_peaks_bf16io_matches_jax(rng, b, f, n, bh, bw, kh, kw, h, w):
    """The peaks kernel's plain version at BF16IO against
    block_conv_peaks_pallas (BF16IO, karatsuba=False, one block per cell):
    values within IO_TOL of the largest, indices equal outside near-tie
    cells."""
    ops, geom = _case(rng, b, f, n, bh, bw, kh, kw, h, w)
    t16 = [_bf16(x) for x in ops]
    gv, gi = tbc.block_conv_peaks(*t16, *geom)
    jv, ji = block_conv_peaks_pallas(*map(_jbf16, ops), *geom, interpret=True,
                                     karatsuba=False, mbh=1, mbw=1, radix_h=False)
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    assert tuple(gv.shape) == jv.shape
    atol = IO_TOL * np.abs(jv).max()
    assert np.abs(gv.numpy() - jv).max() <= atol
    vh, vw = bh - kh + 1, bw - kw + 1
    cells = tbc.cell_view(tbc.block_conv(*t16, *geom), *gv.shape[2:], vh, vw)
    near = ((cells >= gv[..., None] - atol).sum(-1) >= 2).numpy()
    flips = gi.numpy() != ji
    assert not (flips & ~near).any()


SETTINGS = [
    dict(fused_precision="bf16x3"),
    dict(fused_precision="highest", matmul_precision="highest"),
    dict(fused_precision="highest", matmul_precision="default"),
]


@pytest.mark.parametrize("setting", SETTINGS, ids=["bf16x3", "highest", "default"])
def test_fused_splits_bf16_is_bf16io(setting):
    """bf16 spectra take BF16IO under every setting; fp32 spectra keep
    their tier (3×TF32, 6×TF32, one pass)."""
    before = tfc.get_config()
    try:
        tfc.set_config(**setting)
        assert tbc.fused_splits(torch.bfloat16) == tbc.BF16IO
        f32 = {"bf16x3": 3, "highest": 6, "default": 1}[
            setting.get("matmul_precision", setting["fused_precision"])]
        assert tbc.fused_splits(torch.float32) == f32
    finally:
        tfc.set_config(fused_precision=before.fused_precision,
                       matmul_precision=before.matmul_precision)


def _c_smem(wc, vh):
    """csrc/block_conv.cuh smem_bytes at kBF16IO (one piece an operand, one
    plane of M^T), written out from the header's formulas → (shared
    memory, rows, blocks a CTA, kernels a CTA; a pair's CTA holds 64
    rows)."""
    x_stride = 2 * (-(-wc // 32) * 32) + 4
    m_plane = (128 // 8) * (32 // 4) * 32
    stage_w = 2 * 1 * m_plane

    def one_block(rows):
        stage_h = (2 * 128 * 16 + 3 * rows * 16) if rows == 64 else (2 * 128 * 20 + 2 * rows * 20)
        return 4 * (rows * x_stride + max(stage_h, stage_w))

    g = 1 if vh > 32 else min(64 // vh, 4)
    if g > 1:
        # the stack: t kernels' X, S of one kernel (16-row u-chunks), a ring
        # of 2 to 8 steps of bf16 spans, 16 barriers; the u-chunk's pixel
        # pairs within 96 // (4 g t) a thread of the MAC's 224
        span = 16 * ((16 * wc * 2 + 13) // 16 + 1)
        for t in (2, 1):
            x = 4 * t * 64 * x_stride
            s = 4 * g * 2 * 16 * (-(-wc // 8) * 8)
            steps = min((232448 - x - s - 128) // (2 * (g + t) * span), 8)
            smem = x + max(s + steps * 2 * (g + t) * span, 4 * stage_w) + 128
            fits = wc <= 96 // (4 * g * t) * 2 * 224 // 16
            if fits and steps >= 2 and smem <= 232448:
                return smem, 64, g, t
    if one_block(64) <= 232448:
        return one_block(64), 64, 1, 1
    # the pair: X of h bins a CTA (half of the wc - 1 below the last,
    # rounded up to 32; 32 more where that leaves the other CTA a pass of
    # under 32 bins), the 64-row staging area, a sliver of 256 floats
    nb = wc - 1

    def pair(h):
        return 4 * (64 * (2 * h + 4) + max(2 * 128 * 16 + 3 * 64 * 16, stage_w) + 256)

    h0 = ((nb + 1) // 2 + 31) // 32 * 32
    for h in (h0, h0 + 32):
        if h < nb and ((nb - h) % 128 == 0 or (nb - h) % 128 >= 32) and pair(h) <= 232448:
            return pair(h), 64, 1, 1
    if h0 < nb and pair(h0) <= 232448:
        return pair(h0), 64, 1, 1
    return one_block(32), 32, 1, 1


@pytest.mark.parametrize("wc", [17, 70, 129, 224, 256, 301, 320, 385, 513, 577, 769])
def test_mirror_at_bf16io(wc):
    """The shared-memory mirror at BF16IO is the C side's formulas (one
    piece an operand: the one-pass tier's layout in the one-block
    configurations; the stack's u-chunks of 16 rows and bf16 spans), at
    every window height:
    148,480 B at the headline (Wc 224, Vh 64); the DPM plan stacks 4
    blocks and 2 kernels; the C queries take the tier as 0."""
    assert tbc.BF16IO == 0 and tbc.TIERS[tbc.BF16IO] == 1
    for vh in (1, 2, 7, 16, 21, 32, 33, 64, 100, 961):
        smem, rows, g, t = _c_smem(wc, vh)
        io = tbc.BF16IO
        assert (tbc.smem_bytes(wc, vh, io), tbc.tile_rows(wc, vh, io),
                tbc.blocks_per_cta(wc, vh, io), tbc.kernels_per_cta(wc, vh, io)
                ) == (smem, rows, g, t), (wc, vh)
        if g == 1 == tbc.blocks_per_cta(wc, vh, 1):
            # the one-pass tier's layout; a stack's is its own (16-row u-chunks)
            assert tbc.smem_bytes(wc, vh, io) == tbc.smem_bytes(wc, vh, 1)
        assert tbc.m_planes(tbc.tile_rows(wc, vh, io), io) == 1
    assert tbc.smem_bytes(224, 64, tbc.BF16IO) == 148480
    assert tbc.blocks_per_cta(70, 16, tbc.BF16IO) == 4
    assert tbc.kernels_per_cta(70, 16, tbc.BF16IO) == 2


def test_kernel_mats_at_bf16io():
    """At BF16IO G^T, G and M^T (one plane) are the window matrices rounded
    to bf16 (to nearest, even), not TF32 pieces; the tier has its own cache
    entry."""
    gr, gi, mr, mi = tbc._window_mats(127, 447, 64, 64, "cpu")
    gt_re, gt_im, g_pad, m_tc = tbc._kernel_mats(127, 447, 64, 64, "cpu", tbc.BF16IO)
    x1 = tbc._kernel_mats(127, 447, 64, 64, "cpu", 1)
    r = tbc.bf16_round
    assert torch.equal(gt_re, r(gr).t()) and torch.equal(gt_im, r(gi).t())
    assert torch.equal(g_pad[0, :127, :127], r(gr)) and torch.equal(g_pad[1, :127, :127], r(gi))
    assert m_tc.shape == x1[3].shape and tbc.m_core(m_tc).shape[0] == 1
    core = tbc.m_core(m_tc)
    raw = core[0].permute(0, 2, 1, 3).reshape(core.shape[1] * 8, -1)
    assert torch.equal(raw[: mr.shape[1], : mr.shape[0]], r(mr).t())
    for t in (gt_re, g_pad, m_tc):
        assert not (t.view(torch.int32) & 0xFFFF).any()  # bf16 values
    assert not torch.equal(m_tc, x1[3])


def test_bf16_round_is_torch_rne():
    """bf16_round is the cast to bf16 and back (ties to even); the kernels'
    integer rule (csrc/block_conv.cuh bf16r) gives the same bits."""
    x = torch.tensor([1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, -1.0 - 2.0**-8, 3.0e-39, 1e30])
    got = tbc.bf16_round(x)
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).to(torch.int64)
    emulated = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)
    assert torch.equal(got, emulated)
    assert got[0] == 1.0 and got[1] == 1.0 + 4 * 2.0**-8 and got[2] == -1.0


def test_tier_validation(rng):
    """bf16 spectra take BF16IO or an explicit splits=3; BF16IO takes bf16
    spectra only; the explicit 3×TF32 tier on bf16 spectra is the float32
    computation on the rounded planes, and differs from BF16IO within the
    tier's bar."""
    ops, geom = _case(rng, *BLOCK_CASES[1])
    t16 = [_bf16(x) for x in ops]
    for splits in (6, 1):
        with pytest.raises(tfc.InvalidInputError, match="bf16 spectra"):
            tbc.block_conv(*t16, *geom, torch.float32, splits)
    with pytest.raises(tfc.InvalidInputError, match="takes bf16 spectra"):
        tbc.block_conv(*(x.float() for x in t16), *geom, torch.float32, tbc.BF16IO)
    with pytest.raises(tfc.InvalidInputError, match="mbh and mbw"):
        tbc.block_conv_peaks(*t16, *geom, mbh=0)
    io = tbc.block_conv(*t16, *geom)
    assert torch.equal(io, tbc.block_conv(*t16, *geom, torch.float32, tbc.BF16IO))
    x3 = tbc.block_conv(*t16, *geom, torch.float32, 3)
    assert torch.equal(x3, tbc.block_conv(*(x.float() for x in t16), *geom))
    assert 1e-5 < rel_err(io.numpy(), x3.numpy()) < BF16_TOL


@pytest.mark.parametrize("case", [BLOCK_CASES[1], IO_CASES[-1]])
def test_rms_bar_tells_a_missed_rounding(rng, case):
    """``chip_smoke.IO_RMS_TOL`` against variants of the plain version
    (``profile_torch_paths.io_plain``): written with the same expressions it
    equals ``block_conv_reference`` bitwise; summed in float64, another
    legitimate order, it stays within a tenth of the bar; each rounding
    left out (of S, of X, of G and M) puts it ten times beyond the bar."""
    import chip_smoke
    import profile_torch_paths

    ops, geom = _case(rng, *case)
    t16 = [_bf16(x) for x in ops]
    want, _ = profile_torch_paths.io_plain(t16, geom)
    assert torch.equal(want, tbc.block_conv_reference(*t16, *geom))
    wide, _ = profile_torch_paths.io_plain(t16, geom, wide=True)
    assert chip_smoke.rms_rel_err(wide, want) < chip_smoke.IO_RMS_TOL / 10
    for skip in ("s", "x", "gm"):
        planted, _ = profile_torch_paths.io_plain(t16, geom, (skip,))
        assert chip_smoke.rms_rel_err(planted, want) > 10 * chip_smoke.IO_RMS_TOL, skip
