"""The stacked configuration's arithmetic (windows of at most 32 rows: the
DPM and F=8 plans) against the JAX package's kernels.

Since the configuration's redesign a stacked CTA takes g blocks × T
kernels (``ops/block_conv.py blocks_per_cta``, ``kernels_per_cta``) and
computes each cell as ``stacked_emulation`` does here, in plain torch on
the CPU: S = Σ_f K·D in channel order as fp32 fused multiply-adds (each
one rounded once); the H stage X = G·S over u-chunks of spectrum rows
(one mma k-step: 8 rows at the TF32 tiers, 16 at BF16IO), each chunk's
sum formed as the tier's tensor-core products (``tf32_split`` pieces at
3×, 6× and one TF32 pass; at BF16IO one product of the operands rounded
to bf16, ``bf16_round``) and added to X in fp32 — the 4-product
form as Xr = Gr·Sr + (−Gi)·Si, Xi = Gr·Si + Gi·Sr, or the Karatsuba form
t1 = Gr·Sr, t2 = Gi·Si, t3 = (Gr + Gi)·(Sr + Si), Xr += t1 − t2, Xi += t3 −
(t1 + t2) a chunk; then the W stage over chunks of 32 rows of [Mr ; Mi]
(X's bins padded to 32), each chunk the tier's product, added in fp32.

It is held to ``block_conv_pallas`` / ``block_conv_peaks_pallas`` run in
interpret mode with the same H-stage form (``karatsuba``), and to the
float64 plain version: 3×TF32 and 6×TF32 within ``TOL`` (the fp32 bar of
PERF.md §2), one pass within ``ONE_PASS_TOL``, BF16IO within the card's
bars (``IO_TOL`` largest, ``IO_RMS_TOL`` root mean square, relative to the
largest value); peak indices equal, first occurrence winning ties. The
cases are stacked geometries with a last group of fewer than g blocks and
N not a multiple of T. The CUDA entries are held to the plain versions on
the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fft_convolution_torch.ops import block_conv as tbc
from cuda_fft_convolution_tpu.ops.block_conv import (
    block_conv_pallas,
    block_conv_peaks_pallas,
)
from tests.test_torch_bf16 import _block_operands, _f32, _jbf16

TOL = 1e-5
ONE_PASS_TOL = 2e-3
IO_TOL = 5e-3
IO_RMS_TOL = 1e-4
# (b, f, n, block_h, block_w, kh, kw, out_h, out_w): the DPM plan's blocks
# (Vh 16, Wc 70: 4 blocks × 2 kernels a CTA) with 10 blocks an image (a
# last group of 2) and N = 3; Vh 21 (3 blocks, T = 2) with 8 blocks and
# N = 5; Vh 32 at an odd Wc (77: 2 blocks, T = 2) with 3 blocks and N = 3.
CASES = [
    (1, 3, 3, 27, 139, 12, 12, 70, 150),
    (1, 2, 5, 45, 151, 25, 24, 80, 200),
    (2, 2, 3, 40, 152, 9, 24, 90, 120),
]
W_CHUNK = 32


def _fma(a, b, c):
    """fp32 a·b + c rounded once (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _product(a, b, splits):
    """a @ b (batched) as the tier's tensor-core products: the TF32 pieces'
    products smallest first (``tf32_product``'s list), or at BF16IO one
    product of the operands rounded to bf16; fp32 sums."""
    if splits == tbc.BF16IO:
        return tbc.bf16_round(a) @ tbc.bf16_round(b)
    p = tbc.TIERS[splits]
    pa, pb = tbc.tf32_split(a, p), tbc.tf32_split(b, p)
    terms = [(i, s - i) for s in range(p - 1, -1, -1) for i in range(s, -1, -1)]
    out = torch.zeros(torch.broadcast_shapes(a.shape[:-1] + (1,), b.shape[:-2] + (1, 1))[:-1]
                      + (b.shape[-1],))
    for i, j in terms:
        out = out + pa[i] @ pb[j]
    return out


def _product2(a0, b0, a1, b1, splits):
    """a0 @ b0 + a1 @ b1 in one tensor-core sum: at 6×TF32 both products'
    small terms before their main terms (the kernels' mma_n2)."""
    if splits != 6:
        return _product(a0, b0, splits) + _product(a1, b1, splits)
    p0a, p0b, p1a, p1b = (tbc.tf32_split(x, 3) for x in (a0, b0, a1, b1))
    small = [(i, s - i) for s in range(2, 0, -1) for i in range(s, -1, -1)]
    out = 0
    for pa, pb in ((p0a, p0b), (p1a, p1b)):
        for i, j in small:
            out = out + pa[i] @ pb[j]
    return out + p0a[0] @ p0b[0] + p1a[0] @ p1b[0]


def stacked_emulation(dr, di, kr, ki, geom, splits, karatsuba=False):
    """The stacked kernels' maps (module docstring) → (B, N, out_h, out_w)
    float32, from float32 or bf16 planes."""
    bh, bw, kh, kw, out_h, out_w = geom
    dr, di, kr, ki = (tbc.upcast(t) for t in (dr, di, kr, ki))
    b, nbh, nbw, f, lh, wc = dr.shape
    n = kr.shape[0]
    vh, vw = bh - kh + 1, bw - kw + 1
    gr, gi, mr, mi = tbc._window_mats(bh, bw, kh, kw, "cpu")
    if splits == tbc.BF16IO:
        gr, gi, mr, mi = (tbc.bf16_round(m) for m in (gr, gi, mr, mi))
    s_re = torch.zeros((b, nbh, nbw, n, lh, wc))
    s_im = torch.zeros_like(s_re)
    for ff in range(f):
        dre, dim = dr[:, :, :, None, ff], di[:, :, :, None, ff]
        kre, kim = kr[:, ff], ki[:, ff]
        s_re = _fma(kre, dre, _fma(-kim, dim, s_re))
        s_im = _fma(kre, dim, _fma(kim, dre, s_im))
    x_re = torch.zeros((b, nbh, nbw, n, vh, wc))
    x_im = torch.zeros_like(x_re)
    u_chunk = 16 if splits == tbc.BF16IO else 8
    for u0 in range(0, lh, u_chunk):
        g_r, g_i = gr[:, u0:u0 + u_chunk], gi[:, u0:u0 + u_chunk]
        c_r, c_i = s_re[..., u0:u0 + u_chunk, :], s_im[..., u0:u0 + u_chunk, :]
        if karatsuba:
            g3 = g_r + g_i
            if splits == tbc.BF16IO:
                g3 = tbc.bf16_round(g3)
            t1, t2 = _product(g_r, c_r, splits), _product(g_i, c_i, splits)
            t3 = _product(g3, c_r + c_i, splits)
            x_re = x_re + (t1 - t2)
            x_im = x_im + (t3 - (t1 + t2))
        else:
            x_re = x_re + _product2(g_r, c_r, -g_i, c_i, splits)
            x_im = x_im + _product2(g_r, c_i, g_i, c_r, splits)
    bins = -(-wc // W_CHUNK) * W_CHUNK
    pad = (0, bins - wc)
    xcat = torch.cat([torch.nn.functional.pad(x_re, pad), torch.nn.functional.pad(x_im, pad)], -1)
    mcat = torch.cat([torch.nn.functional.pad(mr, (0, 0) + pad),
                      torch.nn.functional.pad(mi, (0, 0) + pad)], 0)
    tile = 0
    for c in range(0, 2 * bins, W_CHUNK):
        tile = tile + _product(xcat[..., c:c + W_CHUNK], mcat[c:c + W_CHUNK], splits)
    maps = tile.permute(0, 3, 1, 4, 2, 5).reshape(b, n, nbh * vh, nbw * vw)
    return maps[:, :, :out_h, :out_w].contiguous()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean()) / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _case(i):
    case = CASES[i]
    ops = _block_operands(np.random.default_rng(i), *case)
    return ops, case[3:]


@functools.lru_cache(maxsize=None)
def _jax_maps(i, bf16, karatsuba):
    ops, geom = _case(i)
    planes = [_jbf16(x) for x in ops] if bf16 else [jnp.asarray(x) for x in ops]
    return _f32(block_conv_pallas(*planes, *geom, interpret=True, karatsuba=karatsuba))


def _planes(i, bf16):
    ops, _ = _case(i)
    t = [torch.as_tensor(np.array(x)) for x in ops]
    return [x.to(torch.bfloat16) for x in t] if bf16 else t


def test_cases_stack_with_partial_groups_and_kernel_pairs():
    """Every case runs the stacked configuration at every tier, with a last
    group of fewer than g blocks and a last CTA of fewer than T kernels."""
    for i, (b, f, n, bh, bw, kh, kw, out_h, out_w) in enumerate(CASES):
        vh, vw, wc = bh - kh + 1, bw - kw + 1, bw // 2 + 1
        blocks = -(-out_h // vh) * -(-out_w // vw)
        for splits in tbc.TIERS:
            g, t = tbc.blocks_per_cta(wc, vh, splits), tbc.kernels_per_cta(wc, vh, splits)
            assert g > 1 and t == 2, (i, splits)
            assert blocks % g and n % t, (i, splits)


@pytest.mark.parametrize("karatsuba", [False, True])
@pytest.mark.parametrize("splits", [3, 6, 1])
@pytest.mark.parametrize("i", range(len(CASES)))
def test_stacked_emulation_matches_jax_at_f32(i, splits, karatsuba):
    """The emulation at each fp32 tier against JAX's kernel with the same
    H-stage form (interpret mode computes fp32), and at 3× and 6×TF32
    against the float64 plain version."""
    ops, geom = _case(i)
    planes = _planes(i, False)
    got = stacked_emulation(*planes, geom, splits, karatsuba).numpy()
    bar = ONE_PASS_TOL if splits == 1 else TOL
    assert _rel(got, _jax_maps(i, False, karatsuba)) <= bar
    if splits != 1:
        want64 = tbc.block_conv_reference(*(x.double() for x in planes), *geom,
                                          out_dtype=torch.float64)
        assert _rel(got, want64.numpy()) <= TOL


@pytest.mark.parametrize("karatsuba", [False, True])
@pytest.mark.parametrize("i", range(len(CASES)))
def test_stacked_emulation_matches_jax_at_bf16io(i, karatsuba):
    """At BF16IO against JAX's BF16IO kernel with the same H-stage form
    (``karatsuba=False``: the 4-product form; True: JAX's default), within
    the card's bars for rounding flips, and against the port's plain
    version of the same form within them too."""
    ops, geom = _case(i)
    planes = _planes(i, True)
    got = stacked_emulation(*planes, geom, tbc.BF16IO, karatsuba).numpy()
    want = _jax_maps(i, True, karatsuba)
    assert _rel(got, want) <= IO_TOL
    assert _rms(got, want) <= IO_RMS_TOL
    plain = tbc.block_conv_reference(*planes, *geom, karatsuba=karatsuba).numpy()
    assert _rel(got, plain) <= IO_TOL
    assert _rms(got, plain) <= IO_RMS_TOL


@pytest.mark.parametrize("splits", [3, tbc.BF16IO])
@pytest.mark.parametrize("i", range(len(CASES)))
def test_stacked_emulation_peaks_match_jax(i, splits):
    """The emulated maps' per-block (max, first index) against JAX's peaks
    kernel (its default form) on the same planes: equal indices; values
    within the tier's bar."""
    ops, geom = _case(i)
    bf16 = splits == tbc.BF16IO
    planes = _planes(i, bf16)
    jplanes = [_jbf16(x) for x in ops] if bf16 else [jnp.asarray(x) for x in ops]
    want_v, want_i = block_conv_peaks_pallas(*jplanes, *geom, interpret=True, mbh=1, mbw=1)
    b, nbh, nbw = ops[0].shape[:3]
    bh, bw, kh, kw = geom[:4]
    maps = stacked_emulation(*planes, geom, splits, karatsuba=True)
    got_v, got_i = tbc.cell_peaks(maps, nbh, nbw, bh - kh + 1, bw - kw + 1)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert _rel(got_v.numpy(), _f32(want_v)) <= (IO_TOL if bf16 else TOL)
