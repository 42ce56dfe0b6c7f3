"""The paired configuration's arithmetic (the v3 kernels on blocks whose
64-row X does not fit: Wc > 320 at 3×TF32, the large-kernel plan's 1024
block) against the JAX package's kernels.

A thread-block cluster of two 64-row CTAs takes 64 window rows of a cell
(``ops/block_conv.py pair_bins``, ``cluster_size``); the kernel computes
each cell as ``paired_emulation`` does here, in plain torch on the CPU:

- S = Σ_f K·D in channel order as fp32 fused multiply-adds;
- the bins 0 .. Wc − 2 split in two: rank 0 the first ``pair_bins``, rank
  1 the rest, each rank's X padded to ``pair_bins`` bins; its H stage X =
  G·S over chunks of 16 spectrum rows, each chunk's sum formed as the
  tier's tensor-core products (``tf32_split`` pieces; at BF16IO one product
  of the operands rounded to bf16) and added in fp32 — the 4-product form
  as Xr = Gr·Sr + (−Gi)·Si and Xi = Gr·Si + Gi·Sr, one tensor-core sum
  each, or the Karatsuba form's t1 = Gr·Sr, t2 = Gi·Si, t3 = (Gr + Gi)·(Sr
  + Si) folded in one at a time;
- the last bin (the Nyquist bin of an even block) apart: its X column
  G·S[:, Wc − 1] in fp32 fused multiply-adds, four partial sums a row
  (spectrum rows 4j .. 4j + 3 of each chunk) added pairwise, in the form's
  factorisation (S rounded at BF16IO as the staged S is);
- the W stage over the pair's contraction — rank 0's [Xr | Xi], then rank
  1's — in chunks of 32, each the tier's product, added in fp32; the last
  bin's term X_n ⊗ [Mr ; Mi][Wc − 1] added to each tile in fp32 (X_n
  rounded at BF16IO as X is);
- a last output column alone (Vw = 128·q + 1): its dot over both halves
  and the last bin's term summed in float64, rounded once.

It is held to ``block_conv_pallas`` / ``block_conv_peaks_pallas`` run in
interpret mode with the same H-stage form and to the float64 plain
version: 3×TF32 and 6×TF32 within ``TOL``, one pass within
``ONE_PASS_TOL``, BF16IO within ``IO_TOL`` largest and ``IO_RMS_TOL`` root
mean square (relative to the largest value); peak indices equal, first
occurrence winning ties, also when a block's pyramid entries are split
by row chunk and by the pair's column halves (``_best_chunk``). The cases
are wide blocks at small sizes: an even and an odd block width, a last
row chunk of one row, a last column alone, and a width that pairs only
at some tiers and forms. The CUDA entries are held to the plain versions
on the card by ``chip_smoke.py`` (steps 3, 33–35, 37) and
``tests/test_torch_gpu.py``."""

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
from tests.test_torch_stacked import _fma, _product, _product2

TOL = 1e-5
ONE_PASS_TOL = 2e-3
IO_TOL = 5e-3
IO_RMS_TOL = 1e-4
# (b, f, n, block_h, block_w, kh, kw, out_h, out_w):
# - an even block (Wc 401: bin 400 is the Nyquist bin), Vh 65 (two row
#   chunks, the last of one row), Vw 257 = 2·128 + 1 (the last column
#   alone); rank 0 takes 224 bins, rank 1 176;
# - an odd block width (Wc 401: the last bin is no Nyquist bin), Vh 32,
#   Vw 402 (a last pass of 18 columns), B = 2, N = 3;
# - Wc 301, which pairs only where the 64-row X does not fit: at 6×TF32
#   and in the Karatsuba form at 3×TF32.
CASES = [
    (1, 2, 2, 69, 800, 5, 544, 100, 400),
    (2, 1, 3, 40, 801, 9, 400, 60, 700),
    (1, 2, 2, 20, 600, 5, 200, 30, 700),
]
# (case, tier, karatsuba) that run the pair, at the fp32 tiers (the first
# two cases pair at BF16IO too)
F32_RUNS = [(i, s, k) for i in (0, 1) for s in (3, 6, 1) for k in (False, True)] + [
    (2, 6, False), (2, 6, True), (2, 3, True)]
W_CHUNK = 32
H_CHUNK = 16


def _nyquist_x(gr, gi, s_re, s_im, splits, karatsuba):
    """The last bin's X column (…, Vh) as the kernel sums it: four partial
    sums a row, thread j of a row taking spectrum rows 4j .. 4j + 3 of each
    16-row chunk in fp32 fused multiply-adds, then added pairwise (j ^ 1,
    then j ^ 2)."""
    rnd = tbc.bf16_round if splits == tbc.BF16IO else (lambda x: x)
    sr, si = s_re[..., -1], s_im[..., -1]  # (…, Lh)
    s3 = rnd(sr + si)
    sr, si = rnd(sr), rnd(si)
    lh = sr.shape[-1]
    shape = sr.shape[:-1] + (gr.shape[0],)
    parts = [[torch.zeros(shape) for _ in range(3)] for _ in range(4)]
    for u in range(lh):
        j = (u % H_CHUNK) // 4
        g_r, g_i = gr[:, u], gi[:, u]  # (Vh,)
        a, b, c = (x[..., u, None] for x in (sr, si, s3))
        p = parts[j]
        if karatsuba:
            g3 = rnd(g_r + g_i)
            p[0] = _fma(g_r, a, p[0])
            p[1] = _fma(g_i, b, p[1])
            p[2] = _fma(g3, c, p[2])
        else:
            p[0] = _fma(g_r, a, _fma(-g_i, b, p[0]))
            p[1] = _fma(g_r, b, _fma(g_i, a, p[1]))
    tot = [(parts[0][m] + parts[1][m]) + (parts[2][m] + parts[3][m]) for m in range(3)]
    if karatsuba:
        return tot[0] - tot[1], tot[2] - tot[0] - tot[1]
    return tot[0], tot[1]


def paired_emulation(dr, di, kr, ki, geom, splits, karatsuba=False):
    """The paired kernels' maps (module docstring) → (B, N, out_h, out_w)
    float32, from float32 or bf16 planes."""
    bh, bw, kh, kw, out_h, out_w = geom
    dr, di, kr, ki = (tbc.upcast(t) for t in (dr, di, kr, ki))
    b, nbh, nbw, f, lh, wc = dr.shape
    n = kr.shape[0]
    vh, vw = bh - kh + 1, bw - kw + 1
    half = tbc.pair_bins(wc, vh, splits, karatsuba)
    assert half > 0, "not a paired geometry"
    rnd = tbc.bf16_round if splits == tbc.BF16IO else (lambda x: x)
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
    nb = wc - 1
    xs = []  # each rank's [Xr | Xi] (…, Vh, 2 half)
    for r in range(tbc.PAIR):
        b0, cnt = r * half, min(half, nb - r * half)
        pad = (0, half - cnt)
        c_re = torch.nn.functional.pad(s_re[..., b0:b0 + cnt], pad)
        c_im = torch.nn.functional.pad(s_im[..., b0:b0 + cnt], pad)
        x_re = torch.zeros(c_re.shape[:-2] + (vh, half))
        x_im = torch.zeros_like(x_re)
        for u0 in range(0, lh, H_CHUNK):
            g_r, g_i = gr[:, u0:u0 + H_CHUNK], gi[:, u0:u0 + H_CHUNK]
            a_r, a_i = c_re[..., u0:u0 + H_CHUNK, :], c_im[..., u0:u0 + H_CHUNK, :]
            if karatsuba:
                g3 = rnd(g_r + g_i)
                t1, t2 = _product(g_r, a_r, splits), _product(g_i, a_i, splits)
                t3 = _product(g3, a_r + a_i, splits)
                x_re = (x_re + t1) - t2
                x_im = ((x_im - t1) - t2) + t3
            else:
                x_re = x_re + _product2(g_r, a_r, -g_i, a_i, splits)
                x_im = x_im + _product2(g_i, a_r, g_r, a_i, splits)
        xs.append(torch.cat([x_re, x_im], -1))
    xcat = torch.cat(xs, -1)  # (…, Vh, 4 half): the pair's contraction order
    mcat = torch.zeros((4 * half, vw))
    for r in range(tbc.PAIR):
        b0, cnt = r * half, min(half, nb - r * half)
        mcat[2 * r * half:2 * r * half + cnt] = mr[b0:b0 + cnt]
        mcat[(2 * r + 1) * half:(2 * r + 1) * half + cnt] = mi[b0:b0 + cnt]
    vm = tbc.pair_columns(vw)
    tile = 0
    for c in range(0, 4 * half, W_CHUNK):
        tile = tile + _product(xcat[..., c:c + W_CHUNK], mcat[c:c + W_CHUNK, :vm], splits)
    xn_re, xn_im = (rnd(x) for x in _nyquist_x(gr, gi, s_re, s_im, splits, karatsuba))
    tile = _fma(xn_im[..., None], mi[nb, :vm], _fma(xn_re[..., None], mr[nb, :vm], tile))
    if vm < vw:
        last = (rnd(xcat).double() @ mcat[:, -1].double()
                + xn_re.double() * float(mr[nb, -1]) + xn_im.double() * float(mi[nb, -1]))
        tile = torch.cat([tile, last.float()[..., None]], -1)
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
    ops = _block_operands(np.random.default_rng(100 + i), *case)
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


def test_cases_run_the_pair():
    """Each case runs the pair where F32_RUNS (and BF16IO on the first two)
    say: 64 rows, a cluster of 2, 2 × ceil(Vh / 64) peaks entries a block;
    the third case keeps the 64-row configuration elsewhere."""
    for i, (_, _, _, bh, bw, kh, _, _, _) in enumerate(CASES):
        vh, wc = bh - kh + 1, bw // 2 + 1
        for splits in tbc.TIERS:
            for kara in (False, True):
                paired = (i, splits, kara) in F32_RUNS or (i < 2 and splits == tbc.BF16IO)
                assert tbc.cluster_size(wc, vh, splits, kara) == (2 if paired else 1)
                assert tbc.tile_rows(wc, vh, splits, kara) == 64
                assert tbc.peaks_chunks(wc, vh, splits, kara) == (
                    -(-vh // 64) * (2 if paired else 1))
    assert tbc.pair_bins(401, 65) == 224 and tbc.row_chunks(401, 65) == 2
    assert tbc.pair_bins(351, 65) == 224  # 192 would leave rank 1 a pass of 30 bins
    assert tbc.pair_columns(257) == 256 and tbc.pair_columns(402) == 402


@pytest.mark.parametrize("i,splits,karatsuba", F32_RUNS)
def test_paired_emulation_matches_jax_at_f32(i, splits, karatsuba):
    """The emulation at each fp32 tier against JAX's kernel with the same
    H-stage form (interpret mode computes fp32), and at 3× and 6×TF32
    against the float64 plain version."""
    _, geom = _case(i)
    planes = _planes(i, False)
    got = paired_emulation(*planes, geom, splits, karatsuba).numpy()
    bar = ONE_PASS_TOL if splits == 1 else TOL
    assert _rel(got, _jax_maps(i, False, karatsuba)) <= bar
    if splits != 1:
        want64 = tbc.block_conv_reference(*(x.double() for x in planes), *geom,
                                          out_dtype=torch.float64)
        assert _rel(got, want64.numpy()) <= TOL


@pytest.mark.parametrize("karatsuba", [False, True])
@pytest.mark.parametrize("i", [0, 1])
def test_paired_emulation_matches_jax_at_bf16io(i, karatsuba):
    """At BF16IO against JAX's BF16IO kernel with the same H-stage form,
    within the card's bars for rounding flips, and against the port's
    plain version of the same form."""
    _, geom = _case(i)
    planes = _planes(i, True)
    got = paired_emulation(*planes, geom, tbc.BF16IO, karatsuba).numpy()
    want = _jax_maps(i, True, karatsuba)
    assert _rel(got, want) <= IO_TOL
    assert _rms(got, want) <= IO_RMS_TOL
    plain = tbc.block_conv_reference(*planes, *geom, karatsuba=karatsuba).numpy()
    assert _rel(got, plain) <= IO_TOL
    assert _rms(got, plain) <= IO_RMS_TOL


def _pair_pyramid(maps, nbh, nbw, vh, vw, wc, splits):
    """The paired peaks kernel's partial pyramid (B, N, nbh, row chunks × 2,
    nbw) from maps: entry rc·2 + rank is the (max, first flat index) of
    row chunk rc's 64 rows over rank's columns (rank 0 the first half of
    the passes, rounded up; rank 1 the rest and a last column alone)."""
    b, n, out_h, out_w = maps.shape
    passes = -(-tbc.pair_columns(vw) // 128)
    split = min(vw, 128 * -(-passes // 2))
    chunks = tbc.row_chunks(wc, vh, splits)
    full = torch.nn.functional.pad(maps, (0, nbw * vw - out_w, 0, nbh * vh - out_h),
                                   value=-float("inf"))
    gy = torch.arange(nbh * vh)[:, None].expand(-1, nbw * vw)
    gx = torch.arange(nbw * vw)[None, :].expand(nbh * vh, -1)
    flat = (gy * out_w + gx).to(torch.int32)
    vals = torch.empty((b, n, nbh, chunks * 2, nbw))
    idxs = torch.empty((b, n, nbh, chunks * 2, nbw), dtype=torch.int32)
    for i in range(nbh):
        for j in range(nbw):
            for rc in range(chunks):
                for rank, (c0, c1) in enumerate(((0, split), (split, vw))):
                    ys = slice(i * vh + 64 * rc, i * vh + min(vh, 64 * (rc + 1)))
                    xs = slice(j * vw + c0, j * vw + c1)
                    v = full[:, :, ys, xs].reshape(b, n, -1)
                    ix = flat[ys, xs].reshape(-1)
                    best = v.amax(-1, keepdim=True)
                    at = torch.where(v == best, ix, torch.iinfo(torch.int32).max).amin(-1)
                    vals[:, :, i, 2 * rc + rank, j] = best[..., 0]
                    idxs[:, :, i, 2 * rc + rank, j] = at
    return vals, idxs


@pytest.mark.parametrize("splits", [3, tbc.BF16IO])
@pytest.mark.parametrize("i", [0, 1])
def test_paired_emulation_peaks_match_jax(i, splits):
    """The emulated maps' pair pyramid (row chunks × the ranks' column
    halves) reduced as ``block_conv_peaks`` reduces it (``_best_chunk``)
    against JAX's peaks kernel (its default form) on the same planes: equal
    indices; values within the tier's bar; and the same as ``cell_peaks``
    of the maps, bitwise."""
    ops, geom = _case(i)
    bf16 = splits == tbc.BF16IO
    planes = _planes(i, bf16)
    jplanes = [_jbf16(x) for x in ops] if bf16 else [jnp.asarray(x) for x in ops]
    want_v, want_i = block_conv_peaks_pallas(*jplanes, *geom, interpret=True, mbh=1, mbw=1)
    b, nbh, nbw, _, _, wc = ops[0].shape
    bh, bw, kh, kw = geom[:4]
    vh, vw = bh - kh + 1, bw - kw + 1
    maps = paired_emulation(*planes, geom, splits, karatsuba=True)
    got_v, got_i = tbc._best_chunk(*_pair_pyramid(maps, nbh, nbw, vh, vw, wc, splits), 3)
    cell_v, cell_i = tbc.cell_peaks(maps, nbh, nbw, vh, vw)
    assert torch.equal(got_v, cell_v) and torch.equal(got_i, cell_i)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert _rel(got_v.numpy(), _f32(want_v)) <= (IO_TOL if bf16 else TOL)


def test_pair_pyramid_ties_keep_the_first_index():
    """Equal maxima in both ranks' halves and both row chunks: the reduced
    pyramid keeps the smallest flat index, as the JAX reducer does."""
    nbh, nbw, vh, vw, wc = 1, 1, 65, 257, 401
    maps = torch.zeros((1, 1, vh, vw))
    for y, x in ((64, 10), (3, 200), (3, 256), (40, 5)):
        maps[0, 0, y, x] = 7.0
    got_v, got_i = tbc._best_chunk(*_pair_pyramid(maps, nbh, nbw, vh, vw, wc, 3), 3)
    assert float(got_v) == 7.0 and int(got_i) == 3 * vw + 200


def _parent_smem(wc, vh, splits, kara):
    """The parent's rule (no pairs): stacked, else 64 rows where that X
    fits, else 32."""
    g = tbc.blocks_per_cta(wc, vh, splits)
    if g > 1:
        return tbc._stack(wc, g, tbc.kernels_per_cta(wc, vh, splits), splits)[1]
    return tbc._tile_smem_bytes(wc, tbc._one_block_rows(wc, splits, kara), splits=splits,
                                karatsuba=kara)


def _c_pair_half(wc, splits, kara):
    """csrc/block_conv.cuh pair_half written out."""
    pieces = tbc.TIERS[splits]
    s = 3 if kara else 2
    stage = max(s * pieces * 128 * 16 + 3 * pieces * 64 * 16, 2 * pieces * 128 * 32)

    def smem(h):
        return 4 * (64 * (2 * h + 4) + stage + 64 * 4)

    def ok(bins):
        return bins % 128 == 0 or bins % 128 >= 32

    nb = wc - 1
    h0 = ((nb + 1) // 2 + 31) // 32 * 32
    for h in (h0, h0 + 32):
        if h < nb and ok(nb - h) and smem(h) <= 232448:
            return h, smem(h)
    return (h0, smem(h0)) if h0 < nb and smem(h0) <= 232448 else (0, 0)


@pytest.mark.parametrize("splits", list(tbc.TIERS))
def test_configuration_model(splits):
    """Over a grid of (Wc, Vh, form): the rows (64 in a pair), the cluster
    size, the shared memory (the C side's formulas written out: X of
    ``pair_bins`` bins, the 64-row staging area and a 256-float sliver) and
    the row chunks; every (Wc, Vh, tier, form) the parent took is still
    taken; the radix bodies (v4, v5, v5x) take the pair where v3 does (and
    so also where the pair fits but the parent's 32 rows did not)."""
    taken_before = taken_now = 0
    for wc in (17, 70, 224, 257, 289, 301, 320, 321, 351, 385, 449, 451, 513, 577, 609,
               641, 705, 737, 769):
        for vh in (1, 16, 32, 33, 64, 65, 100, 256, 512, 961):
            for kara in (False, True):
                half, smem = _c_pair_half(wc, splits, kara)
                g = tbc.blocks_per_cta(wc, vh, splits)
                fits64 = tbc._tile_smem_bytes(wc, 64, splits=splits, karatsuba=kara) <= 232448
                paired = g == 1 and not fits64 and half > 0
                assert tbc.pair_bins(wc, vh, splits, kara) == (half if paired else 0)
                assert tbc.cluster_size(wc, vh, splits, kara) == (2 if paired else 1)
                rows = 64 if g > 1 or fits64 or paired else 32
                assert tbc.tile_rows(wc, vh, splits, kara) == rows
                assert tbc.row_chunks(wc, vh, splits, kara) == (1 if g > 1 else -(-vh // rows))
                before = _parent_smem(wc, vh, splits, kara)
                assert tbc.smem_bytes(wc, vh, splits, kara) == (smem if paired else before)
                if before <= tbc.SMEM_LIMIT_BYTES:
                    taken_before += 1
                    assert tbc.form_taken(wc, vh, splits, True, kara)
                taken_now += tbc.form_taken(wc, vh, splits, True, kara)
                assert tbc.radix_fits(wc, vh, splits, kara) == (
                    g == 1 and (paired or before <= tbc.SMEM_LIMIT_BYTES))
                for body in ("v4", "v5", "v5x"):
                    assert tbc.kernel_layout(body, wc, vh, splits, kara) == (
                        (64, half) if paired else (tbc._one_block_rows(wc, splits, kara), 0))
                if paired:
                    assert half % 32 == 0 and 2 * half >= wc - 1 > half
    assert taken_now >= taken_before > 0


def test_the_1024_block_per_tier():
    """The large-kernel plan's 1024 block (Wc 513, Vh 512): a pair of 64-row
    CTAs of 256 bins each at every tier in the 4-product form, 8 row
    chunks; shared memory as reckoned (X 132,096 B, the staging area, the
    sliver's 1,024 B): 198,656 at 3×TF32, 231,424 at 6×TF32, 165,888 at one
    pass and BF16IO; the Karatsuba form pairs but at 6×TF32, which stays
    refused; the radix bodies pair as v3 does (256 bins a rank, half of the
    DIF stage's W/2), and so does v2 (v3's configuration)."""
    x = 64 * (2 * 256 + 4) * 4
    assert x == 132096
    want = {3: x + 65536 + 1024, 6: x + 98304 + 1024, 1: x + 32768 + 1024,
            tbc.BF16IO: x + 32768 + 1024}
    for splits, smem in want.items():
        assert tbc.pair_bins(513, 512, splits) == 256
        assert tbc.smem_bytes(513, 512, splits) == smem <= tbc.SMEM_LIMIT_BYTES
        assert tbc.row_chunks(513, 512, splits) == 8 and tbc.peaks_chunks(513, 512, splits) == 16
    assert tbc.smem_bytes(513, 512, 3, True) == x + 73728 + 1024
    assert tbc.pair_bins(513, 512, 6, True) == 0
    assert not tbc.form_taken(513, 512, 6, True, True)
    for body in ("v4", "v5", "v5x"):
        assert tbc.kernel_layout(body, 513, 512, 3) == (64, 256)
        assert tbc.kernel_layout(body, 513, 512, 6, True) == (32, 0)
    assert tbc.kernel_layout("v2", 513, 512, 3) == (64, 256)
    assert tbc.kernel_layout("v2", 513, 512, 6, True) == (32, 0)


@pytest.mark.parametrize("splits", list(tbc.TIERS))
def test_pair_operand_layout(splits):
    """``_kernel_mats``' W-stage operand for the pair: M^T over the pair's
    contraction order (rank 0's [Mr | Mi] rows over its bins, rank 1's),
    the passes' columns, in 64-row chunks (read back with ``m_core``), then
    the last bin's row of [Mr ; Mi], the last column alone over the same
    order and its last-bin values, exact (rounded to bf16 at BF16IO)."""
    bh, bw, kh, kw = 69, 800, 5, 544
    wc, vh, vw = bw // 2 + 1, bh - kh + 1, bw - kw + 1
    half = tbc.pair_bins(wc, vh, splits)
    assert half == 224
    _, _, mr, mi = tbc._window_mats(bh, bw, kh, kw, "cpu")
    if splits == tbc.BF16IO:
        mr, mi = tbc.bf16_round(mr), tbc.bf16_round(mi)
    m_tc = tbc._kernel_mats(bh, bw, kh, kw, "cpu", splits)[3]
    pieces, k, cols, nb = tbc.m_planes(64, splits), 4 * half, 256, wc - 1
    main = pieces * cols * k
    assert m_tc.ndim == 1 and m_tc.numel() == main + 2 * cols + k + 4
    core = tbc.m_core(m_tc[:main].reshape(cols // 128, k // 32, pieces, 16, 8, 8, 4))
    m_t = core.permute(0, 1, 3, 2, 4).reshape(pieces, cols, k).double().sum(0)
    exact = torch.zeros((cols, k), dtype=torch.float64)
    for r in range(2):
        b0, cnt = r * half, min(half, nb - r * half)
        exact[:, 2 * r * half:2 * r * half + cnt] = mr[b0:b0 + cnt, :cols].t().double()
        exact[:, (2 * r + 1) * half:(2 * r + 1) * half + cnt] = mi[b0:b0 + cnt, :cols].t().double()
    reach = {1: 2.0**-10, 3: 2.0**-21, 6: 0.0, tbc.BF16IO: 0.0}[splits]
    assert float((m_t - exact).abs().max()) <= reach * float(exact.abs().max())
    tail = m_tc[main:]
    assert torch.equal(tail[:cols], mr[nb, :cols]) and torch.equal(tail[cols:2 * cols],
                                                                   mi[nb, :cols])
    last = tail[2 * cols:2 * cols + k]
    assert torch.equal(last[:half], mr[:half, vw - 1])
    assert torch.equal(last[2 * half:2 * half + nb - half], mr[half:nb, vw - 1])
    assert torch.equal(tail[2 * cols + k:2 * cols + k + 2], torch.stack([mr[nb, -1], mi[nb, -1]]))
