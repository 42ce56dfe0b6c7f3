"""The DIF radix bodies (v5, v5x) in the paired configuration (the maps and
peaks kernels' ``…_r5``, ``…_r5x`` entries and their Karatsuba forms
``…_r5_k``, ``…_r5x_k`` where v3 runs a cluster pair: the 64-row X does
not fit) against the JAX package's ``_make_kernel_v5``,
``_make_kernel_v5x`` and their peaks twins.

A thread-block cluster of two 64-row CTAs takes a radix row chunk of a
cell (``ops/block_conv.py kernel_layout``); the kernel computes each cell
as ``paired_dif_emulation`` does here, in plain torch on the CPU:

- S = Σ_f K·D in channel order as fp32 fused multiply-adds;
- the W/2 bins below the Nyquist bin split evenly: rank r takes bins
  r·W/4 .. (r + 1)·W/4 − 1;
- each rank's radix H stage as v4's pair runs it (``_sub_transforms``,
  ``_window_rows``), its X stored [even | odd] within its bins;
- the W stage over both ranks' X in chunks of 32 (the one-block DIF
  operand's order: even re, even im, odd re, odd im, each segment's bins
  rank 0's then rank 1's): P over the even-bin chunks, Q over the odd ones,
  each chunk the tier's product added in fp32;
- the Nyquist term into P, nyq ⊗ (−1)^(t0 + k) / W in fp32: v5's nyq the
  last bin's Ê ± t·Ô (re) from fp32 fused multiply-adds on the unrounded S
  (the JAX kernel's VPU term), v5x's the sliver synthesised outside the
  kernel (``_xsliver``, rounded at BF16IO);
- output column k of the t'-columns P + Q (P − Q where t0 + k ≥ W/2) and
  column k + W/2 P − Q.

It is held to ``block_conv_pallas(radix_h=True, radix_w=True, xsliver=…)``
and ``block_conv_peaks_pallas`` in interpret mode with the same H-stage
form, and to the float64 plain version: 3×TF32 and 6×TF32 within ``TOL``,
one pass within ``ONE_PASS_TOL``, BF16IO within ``IO_TOL`` largest and
``IO_RMS_TOL`` root mean square (relative to the largest value); peak
indices equal, the first occurrence winning ties, also across a rank's two
column stretches (its passes' t'-columns k and k + W/2) when a block's
pyramid entries are split by radix chunk and by rank (``_best_chunk``).
The cases: Wc 257 (JAX's F=1 plan's width; pairs at 6×TF32 only) and Wc
513 at Vw 896 (pairs at every tier but the Karatsuba form at 6×TF32, which
is refused). The CUDA entries are held to the plain versions on the card
by ``chip_smoke.py`` step 36 and ``tests/test_torch_gpu.py``."""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fft_convolution_torch.ops import block_conv as tbc
from cuda_fft_convolution_tpu.ops.block_conv import block_conv_pallas, block_conv_peaks_pallas
from tests.test_torch_bf16 import _f32, _jbf16
from tests.test_torch_paired import IO_RMS_TOL, IO_TOL, ONE_PASS_TOL, TOL, _rel, _rms
from tests.test_torch_paired_radix import (
    _nyquist_sub_transforms,
    _sub_transforms,
    _window_rows,
)
from tests.test_torch_radix import _operands
from tests.test_torch_stacked import _fma, _product

# (b, f, n, block_h, block_w, kh, kw, out_h, out_w):
# - Lh 64 (M 32, w0 16), Wc 257 (128 bins a rank), Vw 384 = Tn + 128: two
#   t'-passes, one a rank; F = 2, two block columns;
# - Lh 48 (M 24, w0 8), Wc 513 (256 bins a rank), Vw 896: four t'-passes,
#   two a rank, each rank's columns two stretches of 256 and 128 or 256.
CASES = [
    (1, 2, 2, 64, 512, 17, 129, 48, 700),
    (1, 1, 2, 48, 1024, 9, 129, 40, 896),
]
BODIES = ("v5", "v5x")
# (case, tier, karatsuba) that run the pair at the fp32 tiers
F32_RUNS = [(0, 6, False), (0, 6, True)] + [
    (1, s, k) for s in (3, 6, 1) for k in (False, True) if not (s == 6 and k)]
W_CHUNK = 32


@functools.lru_cache(maxsize=None)
def _case(i):
    case = CASES[i]
    return _operands(np.random.default_rng(500 + i), *case), case[3:]


def _planes(i, bf16):
    ops, _ = _case(i)
    t = [torch.as_tensor(np.array(x)) for x in ops]
    return [x.to(torch.bfloat16) for x in t] if bf16 else t


def _flags(body, karatsuba):
    return dict(radix_h=True, radix_w=True, xsliver=body == "v5x", karatsuba=karatsuba)


@functools.lru_cache(maxsize=None)
def _jax(i, bf16, body, karatsuba, head="maps"):
    """JAX's DIF kernel in interpret mode on the case's planes → float32
    maps, or (values, indices) of one-block cells."""
    ops, geom = _case(i)
    planes = [_jbf16(x) for x in ops] if bf16 else [jnp.asarray(x) for x in ops]
    flags = _flags(body, karatsuba)
    if head == "maps":
        return _f32(block_conv_pallas(*planes, *geom, interpret=True, **flags))
    vals, idxs = block_conv_peaks_pallas(*planes, *geom, interpret=True, mbh=1, mbw=1, **flags)
    return _f32(vals), np.asarray(idxs)


def _c_dif_chunks(wc):
    """csrc/block_conv.cuh's W-stage chunk map of the DIF pair written out
    (x_at): chunk kc of [epr; epi; oqr; oqi] → (the rank whose X
    holds it, its first column there), each rank's X [Xr | Xi] over its
    W/4 bins stored [even | odd]."""
    l2 = wc - 1
    half = l2 // 2
    seg_c = (l2 // 2) // W_CHUNK  # chunks of a segment: even re, even im, odd re, odd im
    own_c = seg_c // tbc.PAIR
    out = []
    for kc in range(2 * l2 // W_CHUNK):
        seg = kc // seg_c
        out.append((kc % seg_c // own_c, (seg & 1) * half + (seg >> 1) * (half // 2)
                    + kc % own_c * W_CHUNK))
    return out


def paired_dif_emulation(dr, di, kr, ki, geom, splits, body, karatsuba=False):
    """The paired DIF kernels' maps (module docstring) → (B, N, out_h,
    out_w) float32, from float32 or bf16 planes."""
    bh, bw, kh, kw, out_h, out_w = geom
    planes = (dr, di, kr, ki)
    dr, di, kr, ki = (tbc.upcast(t) for t in planes)
    b, nbh, nbw, f, lh, wc = dr.shape
    n = kr.shape[0]
    vh, vw = bh - kh + 1, bw - kw + 1
    l2, t0 = wc - 1, kw - 1
    rows, half = tbc.kernel_layout(body, wc, vh, splits, karatsuba)
    assert (rows, 2 * half) == (64, l2), "not a paired DIF geometry"
    rnd = tbc.bf16_round if splits == tbc.BF16IO else (lambda x: x)
    u_pad = tbc._radix_kernel_mats(bh, bw, kh, kw, "cpu", splits, body, 64)[0]
    m = lh // 2
    ur, ui, u3 = (u_pad[c, :m, :m] for c in range(3))
    s_re = torch.zeros((b, nbh, nbw, n, lh, wc))
    s_im = torch.zeros_like(s_re)
    for ff in range(f):
        dre, dim = dr[:, :, :, None, ff], di[:, :, :, None, ff]
        kre, kim = kr[:, ff], ki[:, ff]
        s_re = _fma(kre, dre, _fma(-kim, dim, s_re))
        s_im = _fma(kre, dim, _fma(kim, dre, s_im))
    perm = torch.cat([torch.arange(0, half, 2), torch.arange(1, half, 2)])
    xs = []  # each rank's [Xr | Xi], each [even | odd]: (…, Vh, 2 half)
    for r in range(tbc.PAIR):
        bins = slice(r * half, (r + 1) * half)
        x_re, x_im = _window_rows(*_sub_transforms(ur, ui, u3, s_re[..., bins], s_im[..., bins],
                                                   splits, karatsuba), lh, vh)
        xs.append(torch.cat([x_re[..., perm], x_im[..., perm]], -1))
    mats = torch.cat([rnd(torch.from_numpy(x)) for x in tbc._dif_w_mats(bw, kw, vw)])  # (W, Tn)
    p = q = 0
    for kc, (src, col) in enumerate(_c_dif_chunks(wc)):
        t = _product(xs[src][..., col:col + W_CHUNK], mats[kc * W_CHUNK:(kc + 1) * W_CHUNK],
                     splits)
        if kc < len(mats) // (2 * W_CHUNK):
            p = p + t
        else:
            q = q + t
    if body == "v5":
        ex = _nyquist_sub_transforms(ur, ui, s_re, s_im, splits, round_s=False)
        nyq = _window_rows(*(a[..., None] for a in ex), lh, vh)[0][..., 0]
    else:  # (B, N, nbh, nbw, Vh) → the cells' order
        nyq = rnd(tbc._xsliver(*planes, bh, bw, kh)).permute(0, 2, 3, 1, 4)
    par = torch.from_numpy(tbc._sliver_parity_row(bw, kw, vw))[0]
    p = _fma(nyq[..., None], par, p)
    tn = p.shape[-1]
    first = torch.where(t0 + torch.arange(tn) < l2, p + q, p - q)
    tile = torch.cat([first, (p - q)[..., :vw - tn]], -1)
    maps = tile.permute(0, 3, 1, 4, 2, 5).reshape(b, n, nbh * vh, nbw * vw)
    return maps[:, :, :out_h, :out_w].contiguous()


@functools.lru_cache(maxsize=None)
def _emulated(i, splits, body, karatsuba):
    _, geom = _case(i)
    return paired_dif_emulation(*_planes(i, splits == tbc.BF16IO), geom, splits, body, karatsuba)


def test_cases_run_the_pair():
    """v5 and v5x take v3's pair exactly where v4 does — 64 rows, half of
    the W/2 bins a rank, 2 × ``radix_row_chunks`` peaks entries a block — at
    the tiers ``F32_RUNS`` names (and BF16IO on the second case), the
    one-block rule elsewhere; the Karatsuba form at 6×TF32 on Wc 513 is
    refused."""
    for i, (_, _, _, bh, bw, kh, kw, _, _) in enumerate(CASES):
        vh, vw, wc = bh - kh + 1, bw - kw + 1, bw // 2 + 1
        assert tbc.radix_h_legal(bh, vh) and tbc.radix_w_legal(bw, kw, vw)
        for splits, kara in itertools.product(tbc.TIERS, (False, True)):
            paired = (i, splits, kara) in F32_RUNS or (i == 1 and splits == tbc.BF16IO)
            refused = i == 1 and splits == 6 and kara
            v4 = tbc.kernel_layout("v4", wc, vh, splits, kara)
            for body in BODIES:
                lay = tbc.kernel_layout(body, wc, vh, splits, kara)
                assert lay == v4 == ((64, (wc - 1) // 2) if paired
                                     else (64 if i == 0 else 32, 0)), (i, splits, kara, body)
                chunks = sum(tbc.radix_chunks(bh, vh, lay[0]))
                assert tbc.radix_row_chunks(wc, bh, vh, splits, kara) == chunks
                assert tbc.peaks_chunks(wc, vh, splits, kara, body, bh) == chunks * (
                    2 if paired else 1)
                assert tbc.radix_fits(wc, vh, splits, kara) != refused
            assert tbc.form_taken(wc, vh, splits, True, kara) != refused


@pytest.mark.parametrize("i", [0, 1])
def test_chunks_read_the_one_block_operand(i):
    """The pair's W stage reads the one-block DIF operand as it is: chunk
    kc of [epr; epi; oqr; oqi] (rows kc·32 ..) lands on the X columns, in
    the rank ``_c_dif_chunks`` names, of exactly the bins those rows
    synthesise — P's chunks on even bins, Q's on odd ones, re before im,
    each rank's bins in one stretch of whole chunks — and that operand
    (``_radix_args`` at 64 rows) is [epr; epi; oqr; oqi]^T in the 64-row
    chunk layout, its pieces summing to the (rounded at BF16IO) matrices
    to the tier's reach."""
    bh, bw, kh, kw = CASES[i][3:7]
    wc = bw // 2 + 1
    l2, l4 = wc - 1, (wc - 1) // 2
    half = l4
    chunks = _c_dif_chunks(wc)
    assert len(chunks) == 2 * l2 // W_CHUNK
    for kc, (src, col) in enumerate(chunks):
        for j in range(W_CHUNK):
            row = kc * W_CHUNK + j  # of [epr; epi; oqr; oqi]: (segment, v)
            seg, v = divmod(row, l4)
            want_bin = 2 * v + (seg >> 1)  # even bins for P (epr, epi), odd for Q
            c = col + j
            comp, local = divmod(c, half)  # [Xr | Xi], then [even | odd]
            assert comp == seg & 1
            parity, k = divmod(local, half // 2)
            assert src * half + 2 * k + parity == want_bin, (kc, j)
    assert sum(src for src, _ in chunks) == len(chunks) // 2
    vw = bw - kw + 1
    tn = min(vw, l2)
    cols = -(-tn // 128) * 128
    for splits in tbc.TIERS:
        rnd = tbc.bf16_round if splits == tbc.BF16IO else (lambda x: x)
        got = tbc._radix_args(_planes(i, False), bh, bw, kh, kw, "cpu", splits, "v5", None, 64)[0]
        pieces = tbc.m_planes(64, splits)
        assert got.shape == (cols // 128, 2 * l2 // W_CHUNK, pieces, 16, 8, 8, 4)
        core = tbc.m_core(got)
        m_t = core.permute(0, 1, 3, 2, 4).reshape(pieces, cols, 2 * l2).double().sum(0)
        exact = torch.zeros((cols, 2 * l2), dtype=torch.float64)
        exact[:tn] = torch.cat([rnd(torch.from_numpy(x)) for x in
                                tbc._dif_w_mats(bw, kw, vw)]).t().double()
        reach = {1: 2.0**-10, 3: 2.0**-21, 6: 0.0, tbc.BF16IO: 0.0}[splits]
        assert float((m_t - exact).abs().max()) <= reach * float(exact.abs().max())


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("i,splits,karatsuba", F32_RUNS)
def test_paired_dif_emulation_matches_jax_at_f32(i, splits, karatsuba, body):
    """The emulation at each fp32 tier against JAX's kernel of the body with
    the same H-stage form (interpret mode computes fp32), and at 3× and
    6×TF32 against the float64 plain version."""
    _, geom = _case(i)
    got = _emulated(i, splits, body, karatsuba).numpy()
    assert _rel(got, _jax(i, False, body, karatsuba)) <= (ONE_PASS_TOL if splits == 1 else TOL)
    if splits != 1:
        want64 = tbc.block_conv_reference(*(x.double() for x in _planes(i, False)), *geom,
                                          out_dtype=torch.float64, **_flags(body, karatsuba))
        assert _rel(got, want64.numpy()) <= TOL


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("karatsuba", [False, True])
def test_paired_dif_emulation_matches_jax_at_bf16io(karatsuba, body):
    """At BF16IO against JAX's BF16IO kernel of the body with the same
    H-stage form, within the card's bars for rounding flips, and against
    the port's plain version of the same form."""
    _, geom = _case(1)
    got = _emulated(1, tbc.BF16IO, body, karatsuba).numpy()
    want = _jax(1, True, body, karatsuba)
    assert _rel(got, want) <= IO_TOL and _rms(got, want) <= IO_RMS_TOL
    plain = tbc.block_conv_reference(*_planes(1, True), *geom, **_flags(body, karatsuba)).numpy()
    assert _rel(got, plain) <= IO_TOL and _rms(got, plain) <= IO_RMS_TOL


def _rank_columns(vw, l2):
    """Each rank's window columns in the DIF pair: its t'-passes of 128
    (rank 0 the first half, rounded up) at k and at k + W/2 → two
    (start, end) stretches a rank."""
    tn = min(vw, l2)
    passes = -(-tn // 128)
    split = min(tn, 128 * -(-passes // 2))
    return [((0, split), (l2, min(vw, l2 + split))), ((split, tn), (l2 + split, vw))]


def _dif_pair_pyramid(maps, nbh, nbw, vh, vw, lh, l2):
    """The paired DIF peaks kernel's partial pyramid (B, N, nbh, radix
    chunks × 2, nbw) from maps: entry rc·2 + rank is the (max, first flat
    index) of radix chunk rc's window rows over the rank's two column
    stretches (``_rank_columns``)."""
    b, n, out_h, out_w = maps.shape
    m, w0 = lh // 2, lh - vh
    npc, nsc = tbc.radix_chunks(lh, vh, 64)
    chunk_rows = []
    for rc in range(npc):
        vps = range(w0 + 32 * rc, min(w0 + 32 * (rc + 1), m))
        chunk_rows.append([v - w0 for v in vps] + [v + m - w0 for v in vps])
    for k in range(nsc):
        chunk_rows.append(list(range(m - w0 + 64 * k, min(m, m - w0 + 64 * (k + 1)))))
    full = torch.nn.functional.pad(maps, (0, nbw * vw - out_w, 0, nbh * vh - out_h),
                                   value=-float("inf"))
    gy = torch.arange(nbh * vh)[:, None].expand(-1, nbw * vw)
    gx = torch.arange(nbw * vw)[None, :].expand(nbh * vh, -1)
    flat = (gy * out_w + gx).to(torch.int32)
    chunks = len(chunk_rows)
    vals = torch.empty((b, n, nbh, chunks * 2, nbw))
    idxs = torch.empty((b, n, nbh, chunks * 2, nbw), dtype=torch.int32)
    for i, j in itertools.product(range(nbh), range(nbw)):
        for rc, rows in enumerate(chunk_rows):
            ys = torch.as_tensor([i * vh + r for r in rows])
            for rank, stretches in enumerate(_rank_columns(vw, l2)):
                xs = torch.cat([torch.arange(j * vw + c0, j * vw + c1) for c0, c1 in stretches])
                v = full[:, :, ys][..., xs].reshape(b, n, -1)
                ix = flat[ys][:, xs].reshape(-1)
                best = v.amax(-1, keepdim=True)
                at = torch.where(v == best, ix, torch.iinfo(torch.int32).max).amin(-1)
                vals[:, :, i, 2 * rc + rank, j] = best[..., 0]
                idxs[:, :, i, 2 * rc + rank, j] = at
    return vals, idxs


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("i,splits,karatsuba",
                         [(0, 6, True), (1, 3, False), (1, 6, False), (1, tbc.BF16IO, True)])
def test_paired_dif_peaks_match_jax(i, splits, karatsuba, body):
    """The emulated maps' pair pyramid (radix chunks × the ranks' column
    stretches) reduced as ``block_conv_peaks`` reduces it (``_best_chunk``)
    against JAX's peaks kernel of the body with the same form on the same
    planes: equal indices; values within the tier's bar; the same as
    ``cell_peaks`` of the maps, bitwise; and the pyramid has
    ``peaks_chunks`` entries a block."""
    ops, geom = _case(i)
    bf16 = splits == tbc.BF16IO
    b, nbh, nbw, _, lh, wc = ops[0].shape
    bh, bw, kh, kw = geom[:4]
    vh, vw = bh - kh + 1, bw - kw + 1
    maps = _emulated(i, splits, body, karatsuba)
    pyramid = _dif_pair_pyramid(maps, nbh, nbw, vh, vw, lh, wc - 1)
    assert pyramid[0].shape[3] == tbc.peaks_chunks(wc, vh, splits, karatsuba, body, lh)
    got_v, got_i = tbc._best_chunk(*pyramid, 3)
    cell_v, cell_i = tbc.cell_peaks(maps, nbh, nbw, vh, vw)
    assert torch.equal(got_v, cell_v) and torch.equal(got_i, cell_i)
    want_v, want_i = _jax(i, bf16, body, karatsuba, "peaks")
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert _rel(got_v.numpy(), want_v) <= (IO_TOL if bf16 else TOL)


@pytest.mark.parametrize("i", [0, 1])
def test_dif_pair_pyramid_ties_keep_the_first_index(i):
    """Equal maxima across a rank's two column stretches (k and k + W/2),
    across the ranks, and in a pair chunk's two row halves: the reduced
    pyramid keeps the smallest flat index, as the JAX reducer does,
    whichever entry holds it."""
    _, _, _, bh, bw, kh, kw, _, _ = CASES[i]
    vh, vw, l2 = bh - kh + 1, bw - kw + 1, bw // 2
    m, w0 = bh // 2, bh - vh
    (a0, a1), (b0, b1) = _rank_columns(vw, l2)
    maps = torch.zeros((1, 3, vh, vw))
    # kernel 0: one row, rank 0's second stretch and rank 1's first (rank 1
    # first in flat order); kernel 1: rank 0's two stretches, the second in
    # an earlier row; kernel 2: a pair chunk's second-half row M against
    # the same column of an earlier single-chunk row, and rank 1's second
    # stretch of row 0 where it has one
    sites = {0: [(1, a1[0] + 3), (1, b0[0])],
             1: [(2, a0[0] + 1), (1, a1[0])],
             2: [(m, 4), (m - w0 + 1, 4)] + ([(0, b1[0])] if b1[1] > b1[0] else [])}
    for k, pts in sites.items():
        for y, x in pts:
            maps[0, k, y, x] = 7.0
    got_v, got_i = tbc._best_chunk(*_dif_pair_pyramid(maps, 1, 1, vh, vw, bh, l2), 3)
    want_v, want_i = tbc.cell_peaks(maps, 1, 1, vh, vw)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    assert int(got_i[0, 0]) == vw + b0[0] and int(got_i[0, 1]) == vw + a1[0]
    assert int(got_i[0, 2]) == (b1[0] if b1[1] > b1[0] else (m - w0 + 1) * vw + 4)


def test_split_patches_apply_to_the_sources():
    """Every stage-split patch of the pair (``profile_torch_paths``
    ``RADIX_SPLIT_PATCHES`` and the paired ``WIDE_SPLIT_PATCHES``) finds its
    text, or one of its forms, exactly once in this tree's sources, and
    this tree pairs every radix body (``parent_paired_bodies``)."""
    import pathlib

    import profile_torch_paths as ptp

    csrc = pathlib.Path(tbc.__file__).resolve().parents[1] / "csrc"
    assert ptp.parent_paired_bodies(csrc) == ("v4", "v5", "v5x")
    for patches in (*ptp.RADIX_SPLIT_PATCHES.values(), *ptp.WIDE_SPLIT_PATCHES["paired"].values()):
        for file, text, _ in patches:
            src = (csrc / file).read_text()
            forms = text if isinstance(text, tuple) else (text,)
            assert any(src.count(t) == 1 for t in forms), (file, forms[0][:60])
