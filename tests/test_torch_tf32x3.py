"""The 3×TF32 split that the fused kernels' syntheses run on the tensor cores
(csrc/block_conv.cuh), emulated on the CPU, and the operand planes
``_kernel_mats`` prepares for it.

Each fp32 operand x is split as hi = TF32(x) (``cvt.rna.tf32.f32``: round to
nearest, ties away from zero, 10 explicit mantissa bits) and lo = TF32(x −
hi); a product a·b runs as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi with fp32
accumulation. Products of TF32 values are exact in fp32, so float32 matmuls
of the TF32 planes emulate the tensor cores up to the order of the fp32
sums. The emulation here is independent of the port's own rounding: it adds
0x1000 to the bits of a numpy array and clears the low 13.

The synthesis is the kernels' H and W stages on the port's window matrices
(``_window_mats``): X = [Gr | −Gi ; Gi | Gr]·[Sr ; Si] as two real products
over the stacked contraction, then tile = [Xr | Xi]·[Mr ; Mi], against the
same float32 S, G and M in float64. The bar is the repo's fp32 one, 1e-5
(max |error| / max |float64|); the split must land well inside it (≤1e-6)
at every block size the planner makes, up to its largest (1024), and a
single TF32 pass must miss it, so a kernel that dropped the split would
fail its checks on the card."""

import numpy as np
import pytest
import torch

from cuda_fft_convolution_torch.ops import block_conv as tbc

SPLIT_TOL = 1e-6
FP32_BAR = 1e-5


def _rna(x) -> np.ndarray:
    """float32 ``x`` rounded to TF32, to nearest, ties away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm(a, b) -> np.ndarray:
    return (torch.from_numpy(a) @ torch.from_numpy(b)).numpy()


def _tc(a, b, passes: int) -> np.ndarray:
    """a @ b on TF32 tensor cores: 3 passes (the split) or 1."""
    ah, bh = _rna(a), _rna(b)
    if passes == 1:
        return _mm(ah, bh)
    al, bl = _rna(a - ah), _rna(b - bh)
    return _mm(al, bh) + _mm(ah, bl) + _mm(ah, bh)


def _synthesis_error(rng, bh, bw, kh, kw, f, passes) -> float:
    gr, gi, mr, mi = (t.numpy() for t in tbc._window_mats(bh, bw, kh, kw, "cpu"))
    wc = bw // 2 + 1

    def planes():
        return (rng.standard_normal((f, bh, wc), dtype=np.float32)
                + 1j * rng.standard_normal((f, bh, wc), dtype=np.float32)).astype(np.complex64)

    s = (planes() * planes()).sum(0).astype(np.complex64)  # the fp32 MAC's S
    sr, si = np.ascontiguousarray(s.real), np.ascontiguousarray(s.imag)
    s_k = np.concatenate([sr, si])  # [Sr ; Si]
    xr = _tc(np.concatenate([gr, -gi], 1), s_k, passes)
    xi = _tc(np.concatenate([gi, gr], 1), s_k, passes)
    tile = _tc(np.concatenate([xr, xi], 1), np.concatenate([mr, mi]), passes)
    g64 = gr.astype(np.float64) + 1j * gi.astype(np.float64)
    x64 = g64 @ s.astype(np.complex128)
    want = x64.real @ mr.astype(np.float64) + x64.imag @ mi.astype(np.float64)
    return float(np.abs(tile - want).max() / np.abs(want).max())


GEOMETRIES = [
    (127, 447, 64, 64, 1),  # the headline plan
    (27, 139, 12, 12, 31),  # the DPM plan
    (1024, 1024, 64, 64, 1),  # the planner's largest block (ops/tiled.py max_block)
]


@pytest.mark.parametrize("bh,bw,kh,kw,f", GEOMETRIES)
def test_tf32x3_synthesis_meets_the_fp32_bar(rng, bh, bw, kh, kw, f):
    three = _synthesis_error(rng, bh, bw, kh, kw, f, passes=3)
    one = _synthesis_error(np.random.default_rng(1), bh, bw, kh, kw, f, passes=1)
    assert three <= SPLIT_TOL, three
    assert one > FP32_BAR, one  # single-pass TF32 misses the bar


def test_tf32_rounding_is_cvt_rna():
    """The emulation's rounding is ``cvt.rna.tf32.f32``'s — the rule the
    kernels apply with two integer operations: the nearest value with 10
    explicit mantissa bits, ties away from zero on both signs, with the
    carry into the exponent; the split's lo is TF32 too."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 8, 4096)).astype(np.float32)
    hi = _rna(x)
    ulp = np.ldexp(1.0, np.frexp(x.astype(np.float64))[1] - 11)  # TF32's spacing at x
    assert (np.abs(hi.astype(np.float64) - x) <= ulp / 2).all()
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (_rna(x - hi).view(np.uint32) & 0x1FFF).any()
    ties = (np.arange(64, dtype=np.uint32) << 13 | 0x1000) + np.uint32(0x3F800000)
    t = ties.view(np.float32)
    assert np.array_equal(_rna(t), (ties + np.uint32(0x1000)).view(np.float32))
    assert np.array_equal(_rna(-t), -_rna(t))
    assert _rna(np.float32([1.0 + 2.0**-11]))[0] == np.float32(1.0 + 2.0**-10)
    assert _rna(np.float32([1.9999999]))[0] == 2.0  # the carry into the exponent


@pytest.mark.parametrize("bh,bw,kh,kw", [(127, 447, 64, 64), (27, 139, 12, 12), (45, 151, 10, 24)])
def test_kernel_mats_planes(bh, bw, kh, kw):
    """_kernel_mats' operands as the kernels read them: G^T and G (re and im
    over Vh padded to 64, Lh padded to 16), exact float32 (the kernels split
    them); and M^T over (Vw padded to 128, 2·Wc padded to 32 each), row c
    holding column c of [Mr ; Mi] with Mi from k = Wc', as its TF32 hi and
    lo planes in core matrices of 8 columns × 4 k — hi with its low 13 bits
    clear and equal to the emulation's rounding, lo = TF32(M^T − hi), hi +
    lo within 2^-22 of M^T; zeros in the padding."""
    gr, gi, mr, mi = tbc._window_mats(bh, bw, kh, kw, "cpu")
    gt_re, gt_im, g_pad, m_tc = tbc._kernel_mats(bh, bw, kh, kw, "cpu")
    vh, lh = gr.shape
    wc, vw = mr.shape
    wcp, cols = -(-wc // 32) * 32, -(-vw // 128) * 128
    assert torch.equal(gt_re, gr.t()) and torch.equal(gt_im, gi.t())
    assert gt_re.is_contiguous() and gt_im.is_contiguous()
    assert g_pad.shape == (2, -(-vh // 64) * 64, -(-lh // 16) * 16) and g_pad.is_contiguous()
    # 64 rows: chunk by chunk (a pass of 128 columns x 32 k, both planes)
    assert m_tc.shape == (cols // 128, 2 * wcp // 32, 2, 16, 8, 8, 4) and m_tc.is_contiguous()
    assert g_pad.dtype == m_tc.dtype == torch.float32
    m_tc = tbc.m_core(m_tc)
    assert m_tc.shape == (2, cols // 8, wcp // 2, 8, 4)
    assert torch.equal(g_pad[0, :vh, :lh], gr) and torch.equal(g_pad[1, :vh, :lh], gi)
    g_mask = torch.ones_like(g_pad, dtype=torch.bool)
    g_mask[:, :vh, :lh] = False
    assert not g_pad[g_mask].any()

    # Undo the core-matrix order: plane p at (column c, k).
    hi, lo = m_tc.permute(0, 1, 3, 2, 4).reshape(2, cols, 2 * wcp).numpy()
    m_t = np.zeros((cols, 2 * wcp), np.float32)
    m_t[:vw, :wc], m_t[:vw, wcp : wcp + wc] = mr.t().numpy(), mi.t().numpy()
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    assert np.array_equal(hi, _rna(m_t)) and np.array_equal(lo, _rna(m_t - hi))
    err = np.abs(hi.astype(np.float64) + lo - m_t)
    assert (err <= 2.0**-22 * np.abs(m_t)).all()
    assert not hi[m_t == 0].any() and not lo[m_t == 0].any()
    assert (m_t[:vw, :wc] != 0).any() and (m_t[:vw, wcp : wcp + wc] != 0).any()


def test_tf32_rounding_port_equals_emulation(rng):
    """ops.block_conv.tf32, which prepares M's planes, rounds as the
    emulation does (and as the kernels' tf32() does), both signs and every
    magnitude."""
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32)
    assert np.array_equal(tbc.tf32(torch.from_numpy(x)).numpy(), _rna(x))
