"""The v4 radix body in the paired configuration (the maps and peaks kernels'
``…_r4`` and ``…_r4_k`` entries where v3 runs a cluster pair: the 64-row X
does not fit) against the JAX package's ``_make_kernel_v4`` and
``_make_kernel_v4_peaks``.

A thread-block cluster of two 64-row CTAs takes a radix row chunk of a
cell (``ops/block_conv.py kernel_layout``, ``radix_row_chunks``); the
kernel computes each cell as ``paired_radix_emulation`` does here, in
plain torch on the CPU:

- S = Σ_f K·D in channel order as fp32 fused multiply-adds;
- the bins 0 .. Wc − 2 split in two: rank 0 the first ``pair_bins``, rank
  1 the rest, each rank's X padded to ``pair_bins`` bins;
- Ê = U·S_even and Ô = U·S_odd over chunks of 16 spectrum rows (8 even
  rows and 8 odd), each chunk's sum the tier's tensor-core products
  (``tf32_split`` pieces; at BF16IO one product of the operands rounded to
  bf16) added in fp32: the 4-product form's Er = Sr·Ur + Si·(−Ui) and Ei =
  Sr·Ui + Si·Ur, one tensor-core sum each, or the Karatsuba form's t1 =
  Sr·Ur, t2 = Si·Ui, t3 = (Sr + Si)·(Ur + Ui) folded in one at a time
  (Re += t1 − t2, Im += t3 − t1 − t2);
- the twiddle combine in fp32: window row v = w0 + r is Ê[v] + t·Ô[v] below
  M and Ê[v − M] − t·Ô[v − M] from M on (the pair chunks give both rows of
  a v' ∈ [w0, M), the single chunks the minus row of a v' < w0);
- the last bin (the Nyquist bin) apart: its Ê and Ô in fp32 fused
  multiply-adds over the spectrum rows in order, from U as staged (the sum
  of its pieces) and the bin's S (rounded at BF16IO as the staged S is),
  the 4-product form whatever the H stage's, then Ê ± t·Ô;
- the pair's W stage: rank 0's [Xr | Xi], then rank 1's, in chunks of 32,
  each the tier's product, added in fp32; the last bin's term X_n ⊗ [Mr ;
  Mi][Wc − 1] added to each tile in fp32 (X_n rounded at BF16IO as X is);
  a last output column alone (Vw = 128·q + 1) summed in float64 over both
  halves and the last bin's term, rounded once.

It is held to ``block_conv_pallas(radix_h=True)`` and
``block_conv_peaks_pallas(radix_h=True)`` in interpret mode with the same
H-stage form, and to the float64 plain version: 3×TF32 and 6×TF32 within
``TOL``, one pass within ``ONE_PASS_TOL``, BF16IO within ``IO_TOL`` largest
and ``IO_RMS_TOL`` root mean square (relative to the largest value); peak
indices equal, first occurrence winning ties, also when a block's pyramid
entries are split by radix chunk (whose rows come from both halves of the
window) and by the pair's column halves (``_best_chunk``). The cases are
small wide blocks: Wc 257 (pairs at 6×TF32 only) and Wc 513 with a last
output column alone (pairs at every tier; the Karatsuba form at 6×TF32
does not fit). The CUDA entries are held to the plain versions on the card
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
from tests.test_torch_karatsuba import _c_one_block, _c_pair
from tests.test_torch_paired import IO_RMS_TOL, IO_TOL, ONE_PASS_TOL, TOL, _rel, _rms
from tests.test_torch_radix import _operands
from tests.test_torch_stacked import _fma, _product, _product2

# (b, f, n, block_h, block_w, kh, kw, out_h, out_w):
# - Lh 64 (M 32, w0 16: one pair chunk of 16 v', one single chunk of 16
#   rows), Wc 257: pairs at 6×TF32 in both forms (128 bins a rank), 64 rows
#   at the other tiers; F = 2, two block columns;
# - Lh 48 (M 24, w0 8), Wc 513 (256 bins a rank), Vw 897 = 7·128 + 1: a
#   last output column alone; pairs at every tier but the Karatsuba form at
#   6×TF32, which is refused.
CASES = [
    (1, 2, 2, 64, 512, 17, 129, 48, 700),
    (1, 1, 2, 48, 1024, 9, 128, 40, 897),
]
# (case, tier, karatsuba) that run the pair at the fp32 tiers
F32_RUNS = [(0, 6, False), (0, 6, True)] + [
    (1, s, k) for s in (3, 6, 1) for k in (False, True) if not (s == 6 and k)]
W_CHUNK = 32
H_CHUNK = 16


@functools.lru_cache(maxsize=None)
def _case(i):
    case = CASES[i]
    return _operands(np.random.default_rng(300 + i), *case), case[3:]


def _planes(i, bf16):
    ops, _ = _case(i)
    t = [torch.as_tensor(np.array(x)) for x in ops]
    return [x.to(torch.bfloat16) for x in t] if bf16 else t


@functools.lru_cache(maxsize=None)
def _jax(i, bf16, karatsuba, head="maps"):
    """JAX's v4 kernel in interpret mode on the case's planes → float32
    maps, or (values, indices) of one-block cells."""
    ops, geom = _case(i)
    planes = [_jbf16(x) for x in ops] if bf16 else [jnp.asarray(x) for x in ops]
    if head == "maps":
        return _f32(block_conv_pallas(*planes, *geom, interpret=True, radix_h=True,
                                      karatsuba=karatsuba))
    vals, idxs = block_conv_peaks_pallas(*planes, *geom, interpret=True, mbh=1, mbw=1,
                                         radix_h=True, karatsuba=karatsuba)
    return _f32(vals), np.asarray(idxs)


def _staged(x, splits):
    """An operand as the kernel stages it for its fp32 sums: the sum of its
    pieces (its bf16 rounding at BF16IO), summed from zero in piece order."""
    if splits == tbc.BF16IO:
        return tbc.bf16_round(x)
    out = torch.zeros_like(x)
    for p in tbc.tf32_split(x, tbc.TIERS[splits]):
        out = out + p
    return out


def _sub_transforms(ur, ui, u3, s_re, s_im, splits, karatsuba):
    """(Êr, Êi, Ôr, Ôi), each (…, M, bins), as the radix H stage sums them:
    per 16-row chunk the tier's products over its 8 even and 8 odd spectrum
    rows, added to the running sums in fp32."""
    rnd = tbc.bf16_round if splits == tbc.BF16IO else (lambda x: x)
    lh = s_re.shape[-2]
    m = lh // 2
    sums = [torch.zeros(s_re.shape[:-2] + (m, s_re.shape[-1])) for _ in range(4)]
    for u0 in range(0, lh, H_CHUNK):
        j = slice(u0 // 2, u0 // 2 + H_CHUNK // 2)
        for parity in (0, 1):
            rows = slice(u0 + parity, u0 + H_CHUNK, 2)
            a_r, a_i = s_re[..., rows, :], s_im[..., rows, :]
            e_r, e_i = sums[2 * parity], sums[2 * parity + 1]
            if karatsuba:
                t1 = _product(ur[:, j], a_r, splits)
                t2 = _product(ui[:, j], a_i, splits)
                t3 = _product(u3[:, j], rnd(a_r + a_i), splits)
                e_r = (e_r + t1) - t2
                e_i = ((e_i - t1) - t2) + t3
            else:
                e_r = e_r + _product2(ur[:, j], a_r, -ui[:, j], a_i, splits)
                e_i = e_i + _product2(ui[:, j], a_r, ur[:, j], a_i, splits)
            sums[2 * parity], sums[2 * parity + 1] = e_r, e_i
    return sums


def _nyquist_sub_transforms(ur, ui, s_re, s_im, splits, round_s=True):
    """The last bin's (Êr, Êi, Ôr, Ôi), each (…, M): fp32 fused
    multiply-adds over the spectrum-row pairs in order (one thread a v'),
    U as staged, the bin's S rounded at BF16IO (v4; ``round_s=False``: v5's
    term, from the unrounded S)."""
    rnd = tbc.bf16_round if splits == tbc.BF16IO and round_s else (lambda x: x)
    sr, si = rnd(s_re[..., -1]), rnd(s_im[..., -1])  # (…, Lh)
    u_r, u_i = _staged(ur, splits), _staged(ui, splits)  # (M, M)
    m = u_r.shape[0]
    a = [torch.zeros(sr.shape[:-1] + (m,)) for _ in range(4)]
    for j in range(m):
        c_r, c_i = u_r[:, j], u_i[:, j]
        er, ei = sr[..., 2 * j, None], si[..., 2 * j, None]
        o_r, o_i = sr[..., 2 * j + 1, None], si[..., 2 * j + 1, None]
        a[0] = _fma(-c_i, ei, _fma(c_r, er, a[0]))
        a[1] = _fma(c_i, er, _fma(c_r, ei, a[1]))
        a[2] = _fma(-c_i, o_i, _fma(c_r, o_r, a[2]))
        a[3] = _fma(c_i, o_r, _fma(c_r, o_i, a[3]))
    return a


def _window_rows(e_r, e_i, o_r, o_i, lh, vh):
    """The twiddle combine in fp32, (…, M, bins) → X's window rows (…, Vh,
    bins) re, im: Ê + t·Ô for v = w0 + r below M, Ê − t·Ô at v − M from M
    on."""
    w0 = lh - vh
    twr, twi = (torch.from_numpy(x)[:, None] for x in tbc.radix_twiddle(lh))
    t_r, t_i = twr * o_r - twi * o_i, twr * o_i + twi * o_r
    x_re = torch.cat([(e_r + t_r)[..., w0:, :], e_r - t_r], dim=-2)
    x_im = torch.cat([(e_i + t_i)[..., w0:, :], e_i - t_i], dim=-2)
    return x_re, x_im


def paired_radix_emulation(dr, di, kr, ki, geom, splits, karatsuba=False):
    """The paired v4 kernels' maps (module docstring) → (B, N, out_h,
    out_w) float32, from float32 or bf16 planes."""
    bh, bw, kh, kw, out_h, out_w = geom
    dr, di, kr, ki = (tbc.upcast(t) for t in (dr, di, kr, ki))
    b, nbh, nbw, f, lh, wc = dr.shape
    n = kr.shape[0]
    vh, vw = bh - kh + 1, bw - kw + 1
    rows, half = tbc.kernel_layout("v4", wc, vh, splits, karatsuba)
    assert (rows, half > 0) == (64, True), "not a paired geometry"
    rnd = tbc.bf16_round if splits == tbc.BF16IO else (lambda x: x)
    _, _, mr, mi = tbc._window_mats(bh, bw, kh, kw, "cpu")
    mr, mi = rnd(mr), rnd(mi)
    u_pad = tbc._radix_kernel_mats(bh, bw, kh, kw, "cpu", splits, "v4", 64)[0]
    m = lh // 2
    ur, ui, u3 = (u_pad[c, :m, :m] for c in range(3))
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
        x_re, x_im = _window_rows(*_sub_transforms(ur, ui, u3, c_re, c_im, splits, karatsuba),
                                  lh, vh)
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
    xn_re, xn_im = (rnd(x[..., 0]) for x in _window_rows(
        *(a[..., None] for a in _nyquist_sub_transforms(ur, ui, s_re, s_im, splits)), lh, vh))
    tile = _fma(xn_im[..., None], mi[nb, :vm], _fma(xn_re[..., None], mr[nb, :vm], tile))
    if vm < vw:
        last = (rnd(xcat).double() @ mcat[:, -1].double()
                + xn_re.double() * float(mr[nb, -1]) + xn_im.double() * float(mi[nb, -1]))
        tile = torch.cat([tile, last.float()[..., None]], -1)
    maps = tile.permute(0, 3, 1, 4, 2, 5).reshape(b, n, nbh * vh, nbw * vw)
    return maps[:, :, :out_h, :out_w].contiguous()


@functools.lru_cache(maxsize=None)
def _emulated(i, splits, karatsuba):
    ops, geom = _case(i)
    return paired_radix_emulation(*_planes(i, splits == tbc.BF16IO), geom, splits, karatsuba)


def test_cases_run_the_pair():
    """Each case runs v4 in the pair where ``F32_RUNS`` (and BF16IO on the
    second) say — 64 rows, ``pair_bins`` bins a rank, 2 ×
    ``radix_row_chunks`` peaks entries a block — and v5 and v5x take the
    same configuration (``tests/test_torch_paired_dif.py`` runs them), v2
    takes v3's; v4 keeps the 64-row configuration elsewhere, and the
    Karatsuba form at 6×TF32 on Wc 513 is refused (``form_taken``)."""
    for i, (_, _, _, bh, bw, kh, _, _, _) in enumerate(CASES):
        vh, wc = bh - kh + 1, bw // 2 + 1
        assert tbc.radix_h_legal(bh, vh) and tbc.blocks_per_cta(wc, vh, 3) == 1
        for splits, kara in itertools.product(tbc.TIERS, (False, True)):
            paired = (i, splits, kara) in F32_RUNS or (i == 1 and splits == tbc.BF16IO)
            half = tbc.pair_bins(wc, vh, splits, kara)
            assert tbc.kernel_layout("v4", wc, vh, splits, kara) == (
                (64, half) if paired else (64 if i == 0 else 32, 0))
            assert bool(half) == paired
            chunks = sum(tbc.radix_chunks(bh, vh, 64 if paired or i == 0 else 32))
            assert tbc.radix_row_chunks(wc, bh, vh, splits, kara) == chunks
            assert tbc.peaks_chunks(wc, vh, splits, kara, "v4", bh) == chunks * (
                2 if paired else 1)
            for body in ("v5", "v5x"):
                assert tbc.kernel_layout(body, wc, vh, splits, kara) == tbc.kernel_layout(
                    "v4", wc, vh, splits, kara)
            assert tbc.kernel_layout("v2", wc, vh, splits, kara) == tbc.kernel_layout(
                "v3", wc, vh, splits, kara)
            refused = i == 1 and splits == 6 and kara
            assert tbc.radix_fits(wc, vh, splits, kara) != refused
            assert tbc.form_taken(wc, vh, splits, True, kara) != refused
    assert tbc.pair_bins(257, 48, 6) == 128 and tbc.pair_bins(513, 40, 3) == 256
    assert tbc.radix_chunks(64, 48, 64) == (1, 1) and tbc.radix_chunks(48, 40, 64) == (1, 1)


@pytest.mark.parametrize("i,splits,karatsuba", F32_RUNS)
def test_paired_radix_emulation_matches_jax_at_f32(i, splits, karatsuba):
    """The emulation at each fp32 tier against JAX's v4 kernel with the same
    H-stage form (interpret mode computes fp32), and at 3× and 6×TF32
    against the float64 plain version."""
    _, geom = _case(i)
    got = _emulated(i, splits, karatsuba).numpy()
    assert _rel(got, _jax(i, False, karatsuba)) <= (ONE_PASS_TOL if splits == 1 else TOL)
    if splits != 1:
        want64 = tbc.block_conv_reference(*(x.double() for x in _planes(i, False)), *geom,
                                          out_dtype=torch.float64, radix_h=True,
                                          karatsuba=karatsuba)
        assert _rel(got, want64.numpy()) <= TOL


@pytest.mark.parametrize("karatsuba", [False, True])
def test_paired_radix_emulation_matches_jax_at_bf16io(karatsuba):
    """At BF16IO against JAX's BF16IO v4 kernel with the same H-stage form,
    within the card's bars for rounding flips, and against the port's plain
    version of the same form."""
    _, geom = _case(1)
    got = _emulated(1, tbc.BF16IO, karatsuba).numpy()
    want = _jax(1, True, karatsuba)
    assert _rel(got, want) <= IO_TOL and _rms(got, want) <= IO_RMS_TOL
    plain = tbc.block_conv_reference(*_planes(1, True), *geom, radix_h=True,
                                     karatsuba=karatsuba).numpy()
    assert _rel(got, plain) <= IO_TOL and _rms(got, plain) <= IO_RMS_TOL


def test_nyquist_sub_transforms_match_the_products():
    """The last bin's Ê and Ô from the fp32 fused multiply-adds agree with
    the same bin's through the tier's products (the H stage it replaces)
    to the fp32 bar, and with the float64 sub-transforms, at 3×TF32."""
    ops, geom = _case(1)
    dr, di, kr, ki = (torch.as_tensor(np.array(x)) for x in ops)
    m = geom[0] // 2
    s_re = torch.einsum("bijfuv,nfuv->bijnuv", dr, kr) - torch.einsum("bijfuv,nfuv->bijnuv", di, ki)
    s_im = torch.einsum("bijfuv,nfuv->bijnuv", di, kr) + torch.einsum("bijfuv,nfuv->bijnuv", dr, ki)
    u_pad = tbc._radix_kernel_mats(*geom[:4], "cpu", 3, "v4", 64)[0]
    ur, ui, u3 = (u_pad[c, :m, :m] for c in range(3))
    fma = _nyquist_sub_transforms(ur, ui, s_re, s_im, 3)
    tc = _sub_transforms(ur, ui, u3, s_re[..., -1:], s_im[..., -1:], 3, False)
    ex = torch.einsum("vj,...j->...v", ur.double() + 1j * ui.double(),
                      s_re[..., 0::2, -1].double() + 1j * s_im[..., 0::2, -1].double())
    big = float(ex.abs().max())
    for k in range(4):
        assert float((fma[k] - tc[k][..., 0]).abs().max()) <= TOL * big
    assert float((fma[0].double() - ex.real).abs().max()) <= TOL * big
    assert float((fma[1].double() - ex.imag).abs().max()) <= TOL * big


def _radix_pair_pyramid(maps, nbh, nbw, vh, vw, lh):
    """The paired v4 peaks kernel's partial pyramid (B, N, nbh, radix chunks
    × 2, nbw) from maps: entry rc·2 + rank is the (max, first flat index)
    of radix chunk rc's window rows (a pair chunk's rows v' − w0 and v' + M
    − w0 for its 32 v' ∈ [w0, M), a single chunk's 64 rows of [M − w0, M))
    over rank's columns (rank 0 the first half of the passes, rounded up;
    rank 1 the rest and a last column alone)."""
    b, n, out_h, out_w = maps.shape
    m, w0 = lh // 2, lh - vh
    npc, nsc = tbc.radix_chunks(lh, vh, 64)
    chunk_rows = []
    for rc in range(npc):
        vps = range(w0 + 32 * rc, min(w0 + 32 * (rc + 1), m))
        chunk_rows.append([v - w0 for v in vps] + [v + m - w0 for v in vps])
    for k in range(nsc):
        chunk_rows.append(list(range(m - w0 + 64 * k, min(m, m - w0 + 64 * (k + 1)))))
    passes = -(-tbc.pair_columns(vw) // 128)
    split = min(vw, 128 * -(-passes // 2))
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
            for rank, (c0, c1) in enumerate(((0, split), (split, vw))):
                xs = slice(j * vw + c0, j * vw + c1)
                v = full[:, :, ys, xs].reshape(b, n, -1)
                ix = flat[ys, xs].reshape(-1)
                best = v.amax(-1, keepdim=True)
                at = torch.where(v == best, ix, torch.iinfo(torch.int32).max).amin(-1)
                vals[:, :, i, 2 * rc + rank, j] = best[..., 0]
                idxs[:, :, i, 2 * rc + rank, j] = at
    return vals, idxs


@pytest.mark.parametrize("i,splits,karatsuba",
                         [(0, 6, True), (1, 3, False), (1, 3, True), (1, tbc.BF16IO, True)])
def test_paired_radix_peaks_match_jax(i, splits, karatsuba):
    """The emulated maps' pair pyramid (radix chunks × the ranks' column
    halves) reduced as ``block_conv_peaks`` reduces it (``_best_chunk``)
    against JAX's v4 peaks kernel with the same form on the same planes:
    equal indices; values within the tier's bar; the same as ``cell_peaks``
    of the maps, bitwise; and the pyramid has ``peaks_chunks`` entries a
    block."""
    ops, geom = _case(i)
    bf16 = splits == tbc.BF16IO
    b, nbh, nbw, _, lh, wc = ops[0].shape
    bh, bw, kh, kw = geom[:4]
    vh, vw = bh - kh + 1, bw - kw + 1
    maps = _emulated(i, splits, karatsuba)
    pyramid = _radix_pair_pyramid(maps, nbh, nbw, vh, vw, lh)
    assert pyramid[0].shape[3] == tbc.peaks_chunks(wc, vh, splits, karatsuba, "v4", lh)
    got_v, got_i = tbc._best_chunk(*pyramid, 3)
    cell_v, cell_i = tbc.cell_peaks(maps, nbh, nbw, vh, vw)
    assert torch.equal(got_v, cell_v) and torch.equal(got_i, cell_i)
    want_v, want_i = _jax(i, bf16, karatsuba, "peaks")
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert _rel(got_v.numpy(), want_v) <= (IO_TOL if bf16 else TOL)


@pytest.mark.parametrize("i", [0, 1])
def test_radix_pair_pyramid_ties_keep_the_first_index(i):
    """Equal maxima in both ranks' column halves, in a pair chunk's two
    row halves and in a single chunk: the reduced pyramid keeps the
    smallest flat index, as the JAX reducer does, whichever entry holds
    it."""
    _, _, _, bh, bw, kh, kw, _, _ = CASES[i]
    vh, vw = bh - kh + 1, bw - kw + 1
    m, w0 = bh // 2, bh - vh
    maps = torch.zeros((1, 2, vh, vw))
    # kernel 0: the pair chunk's second half (row M) and the single chunk
    # (row M − w0) at the same column, rank 1's half first in the flat
    # order of row M − w0; kernel 1: both ranks' halves of one row
    sites = {0: [(m, 3), (m - w0, vw - 1), (m - w0 + 1, 2)], 1: [(0, vw - 1), (0, 5), (vh - 1, 0)]}
    for k, pts in sites.items():
        for y, x in pts:
            maps[0, k, y, x] = 7.0
    got_v, got_i = tbc._best_chunk(*_radix_pair_pyramid(maps, 1, 1, vh, vw, bh), 3)
    want_v, want_i = tbc.cell_peaks(maps, 1, 1, vh, vw)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    assert int(got_i[0, 0]) == (m - w0) * vw + vw - 1 and int(got_i[0, 1]) == 5


@pytest.mark.parametrize("splits", list(tbc.TIERS))
def test_configuration_mirrors_the_c_formulas(splits):
    """Over a grid of (Wc, Vh, form): v4's configuration is v3's pair
    exactly where ``pair_bins`` is nonzero (the C side's ``pair_half``
    written out in ``_c_pair``: X of h bins a rank, the 64-row staging
    area, the 256-float sliver) and the one-block rule without pairs
    elsewhere (``_c_one_block``); v5 and v5x take v4's configuration, v2
    v3's; the radix bodies' shared memory is the mirror's
    (``smem_bytes``) wherever v4 pairs, and ``radix_fits`` is whether that
    configuration fits, for every radix body."""
    for wc, vh in itertools.product((129, 224, 257, 289, 321, 385, 451, 513, 577, 641, 705,
                                     769), (16, 33, 40, 48, 96, 192, 200)):
        for kara in (False, True):
            g = tbc.blocks_per_cta(wc, vh, splits)
            fits64 = _c_one_block(wc, 64, splits, kara) <= tbc.SMEM_LIMIT_BYTES
            rows = 64 if fits64 else 32
            half, smem = _c_pair(wc, splits, kara) if g == 1 and not fits64 else (0, 0)
            assert tbc.pair_bins(wc, vh, splits, kara) == half
            v4 = tbc.kernel_layout("v4", wc, vh, splits, kara)
            assert v4 == ((64, half) if half else (rows, 0)), (wc, vh, kara)
            assert v4 == ((64, half) if half else (tbc._one_block_rows(wc, splits, kara), 0))
            for body in ("v5", "v5x"):
                assert tbc.kernel_layout(body, wc, vh, splits, kara) == v4
            assert tbc.kernel_layout("v2", wc, vh, splits, kara) == tbc.kernel_layout(
                "v3", wc, vh, splits, kara)
            if half:
                assert tbc.smem_bytes(wc, vh, splits, kara) == smem
                assert tbc.kernel_layout("v3", wc, vh, splits, kara) == v4
            one = _c_one_block(wc, rows, splits, kara) <= tbc.SMEM_LIMIT_BYTES
            assert tbc.radix_fits(wc, vh, splits, kara) == (g == 1 and (half > 0 or one))
