"""The port on a CUDA GPU: the fused block-conv, peaks and spectral-MAC
kernels against their plain versions, in every dtype mode (float32 or
bfloat16 spectra, float32 or bfloat16 maps), and the one-shot call, the
direct engine (through the MAC kernel) and ``detect_peaks`` on the card
against the same calls on the CPU, at float32 and at the bf16 tier. These
tests need a card and skip without one; they import neither jax nor the
JAX package, so on a GPU host without jax they run as

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import collections
import itertools

import numpy as np
import pytest
import torch

import cuda_fft_convolution_torch as tfc
from cuda_fft_convolution_torch.ops import block_conv as tbc
from cuda_fft_convolution_torch.utils.errors import InvalidInputError

TOL = 1e-5
BF16_OUT_TOL = 5e-3  # bf16 rounding of the maps alone
BF16_TOL = 2e-2  # the bf16 tier against float32 maps
# BF16IO (bf16 spectra's default tier) against its plain version: S and X
# are rounded to bf16 after sums taken in other orders, so a value at a
# rounding boundary may land one bf16 step away (chip_smoke.py IO_TOL):
# the largest error and the root mean square one
IO_TOL = 5e-3
IO_RMS_TOL = 1e-4
# Windows of at most 32 rows stack blocks in a CTA, and a CTA takes T
# kernels (ops/block_conv.py blocks_per_cta, kernels_per_cta): the DPM
# plan's blocks (Vh 16, Wc 70: 4 blocks, T = 2) at F = 31 with 15 blocks an
# image (a last group of 3 of 4), clipped edges and N = 3 (a last CTA of one
# kernel); Vh = 1 (4 blocks of 64 rows' 4); Vh = 21 (3 blocks, two 16-row
# m-tiles, one masked past 21); Vh = 32 (2 blocks); Wc = 320 (no longer
# stacked: the one-block 64-row configuration at Vh 16); T's limits at Vh
# 16: Wc 84 and 85 (the widest T = 2 at BF16IO, and T = 1), 96 and 97 (at
# the TF32 tiers), Wc 160 (the widest stack at the TF32 tiers; one block at
# BF16IO); Vh 32 at Wc 128 (its widest T = 2); Vh 8 (4 blocks in 32 rows);
# an odd Wc (77: no element pairs, one value a load).
SHORT_WINDOWS = [
    (1, 31, 3, 27, 139, 12, 12, 70, 300),
    (2, 3, 5, 17, 151, 17, 24, 10, 300),
    (2, 3, 5, 45, 151, 25, 24, 100, 300),
    (1, 2, 3, 40, 151, 9, 24, 100, 300),
    (1, 2, 3, 27, 639, 12, 40, 60, 1500),
    (1, 4, 3, 27, 166, 12, 24, 70, 300),
    (1, 4, 3, 27, 168, 12, 24, 70, 300),
    (1, 4, 3, 27, 190, 12, 24, 70, 300),
    (1, 4, 3, 27, 192, 12, 24, 70, 300),
    (1, 2, 3, 27, 318, 12, 40, 60, 600),
    (1, 3, 3, 40, 254, 9, 24, 100, 300),
    (1, 2, 3, 20, 151, 13, 24, 40, 300),
    (2, 3, 5, 45, 152, 25, 24, 100, 300),
]
GEOMETRIES = [
    (2, 3, 5, 45, 151, 10, 24, 100, 300),
    (1, 1, 3, 127, 447, 64, 64, 2048, 2048),  # the headline plan
    (1, 2, 3, 80, 601, 17, 50, 200, 1100),  # Wc = 301: the widest 64-row tiles
    (1, 2, 2, 40, 901, 9, 101, 150, 1700),  # Wc = 451: a pair of 64-row CTAs, Vh 32
    # the planner's largest block (Wc = 513, Vh = 961): a pair, 16 row
    # chunks, the longest contractions the 3xTF32 syntheses see
    (1, 1, 2, 1024, 1024, 64, 64, 1500, 1200),
    # the large-kernel plan (bench.py's 512² kernels on a 2048² image): an
    # odd Lh of 1023, Wc = 513, the longest H contraction; a pair, the last
    # output column (Vw 513) alone
    (1, 1, 3, 1023, 1024, 512, 512, 1500, 1200),
    # the F=8 tier's plan (bench.py's 64 kernels of 32²x8): stacked, F = 8
    (1, 8, 5, 63, 287, 32, 32, 200, 700),
    *SHORT_WINDOWS,
    # the (256, 896) plan of 129² kernels: a pair, 7 W passes (4 / 3)
    (1, 1, 3, 384, 1024, 129, 129, 700, 1500),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _rms(got, want):
    return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,out_h,out_w", GEOMETRIES)
def test_block_conv_kernel_matches_plain_on_gpu(cuda, b, f, n, bh, bw, kh, kw,
                                                out_h, out_w):
    rng = np.random.default_rng(7)
    vh, vw = bh - kh + 1, bw - kw + 1
    nbh, nbw, wc = -(-out_h // vh), -(-out_w // vw), bw // 2 + 1

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)

    ops = (t(b, nbh, nbw, f, bh, wc), t(b, nbh, nbw, f, bh, wc),
           t(n, f, bh, wc), t(n, f, bh, wc))
    before = tbc.block_conv.launches
    got = tbc.block_conv(*ops, bh, bw, kh, kw, out_h, out_w)
    want = tbc.block_conv_reference(*ops, bh, bw, kh, kw, out_h, out_w)
    torch.cuda.synchronize()
    assert tbc.block_conv.launches == before + 1
    assert got.is_cuda and got.shape == want.shape
    assert _rel(got, want) <= TOL
    with pytest.raises(InvalidInputError, match="float32"):
        tbc.block_conv(*(x.half() for x in ops), bh, bw, kh, kw, out_h, out_w)
    with pytest.raises(InvalidInputError, match="contiguous"):
        tbc.block_conv(ops[0].transpose(1, 2), *ops[1:], bh, bw, kh, kw, out_h, out_w)


def _planes(rng, cuda, b, f, n, bh, bw, kh, kw, out_h, out_w):
    vh, vw = bh - kh + 1, bw - kw + 1
    nbh, nbw, wc = -(-out_h // vh), -(-out_w // vw), bw // 2 + 1

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)

    return (t(b, nbh, nbw, f, bh, wc), t(b, nbh, nbw, f, bh, wc),
            t(n, f, bh, wc), t(n, f, bh, wc))


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,out_h,out_w", GEOMETRIES)
def test_block_conv_kernel_bf16_modes_on_gpu(cuda, b, f, n, bh, bw, kh, kw, out_h, out_w):
    """bf16 spectra at their default tier, BF16IO (``_io``): the plain
    version at that tier on the same planes, within IO_TOL and IO_RMS_TOL;
    at the explicit 3×TF32: the fp32 result on the bf16-rounded planes
    (within TOL); bf16 maps: within BF16_OUT_TOL of the plain version's
    float32 maps, and at BF16IO the kernel's float32 maps rounded once.
    Each call counts one launch on its own entry."""
    rng = np.random.default_rng(13)
    geom = (bh, bw, kh, kw, out_h, out_w)
    ops = _planes(rng, cuda, b, f, n, *geom)
    ops16 = tuple(x.to(torch.bfloat16) for x in ops)
    want32 = tbc.block_conv_reference(*ops, *geom)
    want_io = tbc.block_conv_reference(*ops16, *geom)
    want16 = tbc.block_conv_reference(*ops16, *geom, splits=3)
    io = None
    for planes, out_dtype, splits, want, tol, mode in (
        (ops16, torch.float32, None, want_io, IO_TOL, "block_conv_bf16_io"),
        (ops16, torch.bfloat16, None, want_io, BF16_OUT_TOL, "block_conv_bf16_bf16maps_io"),
        (ops16, torch.float32, 3, want16, TOL, "block_conv_bf16"),
        (ops16, torch.bfloat16, 3, want16, BF16_OUT_TOL, "block_conv_bf16_bf16maps"),
        (ops, torch.bfloat16, None, want32, BF16_OUT_TOL, "block_conv_f32_bf16maps"),
    ):
        before = tbc.block_conv.launches_by_mode[mode]
        got = tbc.block_conv(*planes, *geom, out_dtype, splits)
        torch.cuda.synchronize()
        assert tbc.block_conv.launches_by_mode[mode] == before + 1
        assert got.dtype == out_dtype and got.shape == want.shape
        assert _rel(got.float(), want) <= tol, mode
        if mode == "block_conv_bf16_io":
            assert _rms(got, want) <= IO_RMS_TOL
            io = got
        if mode == "block_conv_bf16_bf16maps_io":
            assert torch.equal(got, io.to(torch.bfloat16))
    with pytest.raises(InvalidInputError, match="one dtype"):
        tbc.block_conv(ops16[0], *ops[1:], *geom)


X6_TOL = 5e-7  # 6×TF32 against the plain version in float64
ONE_PASS_TOL = 2e-3  # the one-pass TF32 tier


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,out_h,out_w", GEOMETRIES)
def test_block_conv_tiers_match_plain_on_gpu(cuda, b, f, n, bh, bw, kh, kw, out_h, out_w):
    """The 6×TF32 (``_x6``) and one-pass (``_x1``) entries — f32 maps, bf16
    maps, peaks — against the plain version on the same planes: 6×TF32
    within X6_TOL of the plain version run in float64 (the fp32 plain
    version is itself up to ~9e-7 from it at the 1023-long contractions)
    and within TOL of the fp32 one, equal peak indices; one pass within
    ONE_PASS_TOL, a peak index that differs only in a near tie of that
    size. ``fused_precision='highest'`` with ``matmul_precision='high'``
    runs the 3×TF32 entry, bitwise. Each call counts one launch on its
    mode."""
    rng = np.random.default_rng(19)
    geom = (bh, bw, kh, kw, out_h, out_w)
    ops = _planes(rng, cuda, b, f, n, *geom)
    want = tbc.block_conv_reference(*ops, *geom)
    want64 = tbc.block_conv_reference(*(x.double() for x in ops), *geom, torch.float64)
    want_v, want_i = tbc.block_conv_peaks_reference(*ops, *geom, radix_h=False)
    for splits, tier, tol in ((6, "_x6", TOL), (1, "_x1", ONE_PASS_TOL)):
        for out_dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16maps")):
            mode = f"block_conv_f32{suffix}{tier}"
            before = tbc.block_conv.launches_by_mode[mode]
            got = tbc.block_conv(*ops, *geom, out_dtype, splits)
            torch.cuda.synchronize()
            assert tbc.block_conv.launches_by_mode[mode] == before + 1
            assert got.dtype == out_dtype and got.shape == want.shape
            bar = tol if out_dtype == torch.float32 else max(tol, BF16_OUT_TOL)
            assert _rel(got.float(), want) <= bar, mode
            if mode == "block_conv_f32_x6":
                assert _rel(got.double(), want64) <= X6_TOL
        mode = f"block_conv_peaks_f32{tier}"
        before = tbc.block_conv_peaks.launches_by_mode[mode]
        got_v, got_i = tbc.block_conv_peaks(*ops, *geom, splits, radix_h=False)
        torch.cuda.synchronize()
        assert tbc.block_conv_peaks.launches_by_mode[mode] == before + 1
        assert _rel(got_v, want_v) <= tol
        flips = got_i != want_i
        if splits == 6:
            assert not flips.any()
        elif flips.any():  # a near tie: the kernel's position holds a value that close
            flat = want.reshape(b, n, -1)
            at = flat.gather(-1, got_i.reshape(b, n, -1).long()).reshape(got_i.shape)
            assert (at[flips] >= want_v[flips] - tol * want_v.abs().max()).all()
    before = tfc.get_config()
    try:
        tfc.set_config(fused_precision="highest", matmul_precision="high")
        high = tbc.block_conv(*ops, *geom)
    finally:
        tfc.set_config(fused_precision=before.fused_precision,
                       matmul_precision=before.matmul_precision)
    assert torch.equal(high, tbc.block_conv(*ops, *geom, torch.float32, 3))


@pytest.mark.gpu
def test_highest_tier_calls_on_gpu(cuda):
    """Under ``fused_precision='highest'`` the tiled ``fft_conv`` and
    ``detect_peaks`` on the card run the 6×TF32 entries and agree with the
    same calls on the CPU (the plain versions); under
    ``matmul_precision='default'`` too, the one-pass entries, at that
    tier's bar."""
    rng = np.random.default_rng(23)
    data = rng.standard_normal((300, 280, 1)).astype(np.float32)
    bank = rng.standard_normal((5, 24, 24, 1)).astype(np.float32)
    kw = dict(mode="same", algorithm="tiled")
    before = tfc.get_config()
    try:
        for matmul, tier, tol in (("highest", "_x6", TOL), ("default", "_x1", ONE_PASS_TOL)):
            tfc.set_config(fused_precision="highest", matmul_precision=matmul)
            tbc.reset_launches(tbc.block_conv, tbc.block_conv_peaks)
            got = tfc.fft_conv(data, kernels=bank, **kw, device="cuda")
            vals, pos = tfc.detect_peaks(data, bank, **kw, device="cuda")
            torch.cuda.synchronize()
            assert tbc.block_conv.launches_by_mode[f"block_conv_f32{tier}"] == 1
            assert tbc.block_conv_peaks.launches_by_mode[f"block_conv_peaks_f32{tier}"] == 1
            want = tfc.fft_conv(data, kernels=bank, **kw, device="cpu")
            assert _rel(got.cpu(), want) <= tol
            cpu_vals, cpu_pos = tfc.detect_peaks(data, bank, **kw, device="cpu")
            assert _rel(vals.cpu(), cpu_vals) <= tol
            if matmul == "highest":
                assert torch.equal(pos.cpu(), cpu_pos)
    finally:
        tfc.set_config(fused_precision=before.fused_precision,
                       matmul_precision=before.matmul_precision)


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,out_h,out_w", GEOMETRIES)
def test_block_conv_peaks_kernel_bf16_on_gpu(cuda, b, f, n, bh, bw, kh, kw, out_h, out_w):
    """bf16 spectra through the peaks kernel, at BF16IO (the default) and
    at the explicit 3×TF32: values within the tier's bar (IO_TOL, TOL) of
    the plain version at the tier on the same planes, f32 values, int32
    indices, equal indices (random spectra: no near-ties at these sizes;
    at BF16IO, but in a near tie of IO_TOL, where the kernel's position
    holds a plain value that close to the max); at BF16IO the pairs are the
    cell maxima of the maps kernel's maps, bitwise (one arithmetic, two
    epilogues)."""
    rng = np.random.default_rng(17)
    geom = (bh, bw, kh, kw, out_h, out_w)
    ops16 = tuple(x.to(torch.bfloat16) for x in _planes(rng, cuda, b, f, n, *geom))
    for splits, tol, mode in ((None, IO_TOL, "block_conv_peaks_bf16_io"),
                              (3, TOL, "block_conv_peaks_bf16")):
        before = tbc.block_conv_peaks.launches_by_mode[mode]
        got_v, got_i = tbc.block_conv_peaks(*ops16, *geom, splits)
        want_v, want_i = tbc.block_conv_peaks_reference(*ops16, *geom, splits)
        torch.cuda.synchronize()
        assert tbc.block_conv_peaks.launches_by_mode[mode] == before + 1
        assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
        assert _rel(got_v, want_v) <= tol
        flips = got_i != want_i
        if splits == 3:
            assert not flips.any()
        elif flips.any():
            flat = tbc.block_conv_reference(*ops16, *geom).reshape(b, n, -1)
            at = flat.gather(-1, got_i.reshape(b, n, -1).long()).reshape(got_i.shape)
            assert (at[flips] >= want_v[flips] - tol * want_v.abs().max()).all()
    got_v, got_i = tbc.block_conv_peaks(*ops16, *geom)
    cell_v, cell_i = tbc.cell_peaks(tbc.block_conv(*ops16, *geom), *got_v.shape[2:],
                                    bh - kh + 1, bw - kw + 1)
    assert torch.equal(got_v, cell_v) and torch.equal(got_i, cell_i)


@pytest.mark.gpu
def test_kernel_build_failure_raises(cuda, monkeypatch, tmp_path):
    """A kernel that cannot be built raises on a CUDA tensor; nothing falls
    back to the plain version."""
    from cuda_fft_convolution_torch import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_library_path", lambda sources: tmp_path / "missing.so")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    ops = _planes(np.random.default_rng(1), cuda, *GEOMETRIES[0])
    before = tbc.block_conv.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        tbc.block_conv(*(x.to(torch.bfloat16) for x in ops), *GEOMETRIES[0][3:])
    assert tbc.block_conv.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("mode,data_shape,bank_shape,store", [
    pytest.param(m, (2, 300, 500, 2), (4, 17, 33, 2), "float32", id=m)
    for m in ("same", "full", "fftmap")
] + [
    # a large odd kernel: blocks (256, 896)
    pytest.param("same", (400, 400, 1), (2, 129, 129, 1), "float32", id="large_kernel"),
    # the F=8 tier's plan (63, 287)
    pytest.param("same", (200, 200, 8), (3, 32, 32, 8), "bfloat16", id="f8_tier"),
])
def test_fft_conv_on_gpu_matches_cpu(cuda, mode, data_shape, bank_shape, store):
    """fft_conv on the card: one maps launch, at the planner's plan; the
    maps within TOL (BF16_TOL at the tier) of the CPU's float32 maps."""
    from cuda_fft_convolution_torch.ops.tiled import choose_block_plan

    rng = np.random.default_rng(3)
    data = rng.standard_normal(data_shape).astype(np.float32)
    bank = rng.standard_normal(bank_shape).astype(np.float32)
    h, w, f = data_shape[-3:]
    plan = choose_block_plan(h, w, *bank_shape[1:3], feature_dim=f, store_dtype=store,
                             device=cuda)
    assert plan is not None
    before = collections.Counter(tbc.block_conv.launches_by_shape)
    got = tfc.fft_conv(data, kernels=bank, mode=mode, store_dtype=store, device=cuda)
    torch.cuda.synchronize()
    kernel_mode = "block_conv_f32" if store == "float32" else "block_conv_bf16_io"
    # the main path ran the kernel, once, at the plan
    assert collections.Counter(tbc.block_conv.launches_by_shape) - before == {
        (kernel_mode, *plan): 1}
    want = tfc.fft_conv(data, kernels=bank, mode=mode, device="cpu")
    assert got.is_cuda and got.shape == want.shape
    assert _rel(got.cpu(), want) <= (TOL if store == "float32" else BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,out_h,out_w", GEOMETRIES)
def test_block_conv_peaks_kernel_matches_plain_on_gpu(cuda, b, f, n, bh, bw, kh, kw,
                                                      out_h, out_w):
    """Values within TOL of the plain version relative to the largest value;
    indices equal (random spectra: no near-ties at these sizes)."""
    rng = np.random.default_rng(11)
    vh, vw = bh - kh + 1, bw - kw + 1
    nbh, nbw, wc = -(-out_h // vh), -(-out_w // vw), bw // 2 + 1

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)

    ops = (t(b, nbh, nbw, f, bh, wc), t(b, nbh, nbw, f, bh, wc),
           t(n, f, bh, wc), t(n, f, bh, wc))
    before = tbc.block_conv_peaks.launches
    got_v, got_i = tbc.block_conv_peaks(*ops, bh, bw, kh, kw, out_h, out_w)
    want_v, want_i = tbc.block_conv_peaks_reference(*ops, bh, bw, kh, kw, out_h, out_w)
    torch.cuda.synchronize()
    assert tbc.block_conv_peaks.launches == before + 1
    assert got_v.shape == want_v.shape == (b, n, nbh, nbw)
    assert got_i.dtype == torch.int32
    assert _rel(got_v, want_v) <= TOL
    assert torch.equal(got_i, want_i)
    with pytest.raises(InvalidInputError, match="float32"):
        tbc.block_conv_peaks(*(x.double() for x in ops), bh, bw, kh, kw, out_h, out_w)


@pytest.mark.gpu
@pytest.mark.parametrize("mbh,mbw", [(2, 2), (3, 1), (4, 5)])
@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,out_h,out_w", GEOMETRIES[:1] + SHORT_WINDOWS[:1])
def test_block_conv_peaks_cells_on_gpu(cuda, mbh, mbw, b, f, n, bh, bw, kh, kw, out_h, out_w):
    """Cells of mbh × mbw blocks on the card: the kernel's per-block pairs
    (one launch) reduced by ``group_cells`` = the plain version's cells,
    values within TOL, indices equal, at f32 and at the explicit 3×TF32
    on bf16 spectra (a stacked geometry among them)."""
    rng = np.random.default_rng(31)
    geom = (bh, bw, kh, kw, out_h, out_w)
    ops = _planes(rng, cuda, b, f, n, *geom)
    for planes, splits in ((ops, None), (tuple(x.to(torch.bfloat16) for x in ops), 3)):
        before = tbc.block_conv_peaks.launches
        got_v, got_i = tbc.block_conv_peaks(*planes, *geom, splits, mbh, mbw)
        want_v, want_i = tbc.block_conv_peaks_reference(*planes, *geom, splits, mbh, mbw)
        one_v, one_i = tbc.block_conv_peaks(*planes, *geom, splits)
        torch.cuda.synchronize()
        assert tbc.block_conv_peaks.launches == before + 2
        nbh, nbw = planes[0].shape[1:3]
        assert got_v.shape == (b, n, -(-nbh // min(mbh, nbh)), -(-nbw // min(mbw, nbw)))
        assert _rel(got_v, want_v) <= TOL and torch.equal(got_i, want_i)
        cells = tbc.group_cells(one_v, one_i, mbh, mbw)
        assert torch.equal(got_v, cells[0]) and torch.equal(got_i, cells[1])


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,out_h,out_w", SHORT_WINDOWS[:1] + SHORT_WINDOWS[2:3])
def test_block_conv_peaks_planted_ties_on_gpu(cuda, b, f, n, bh, bw, kh, kw, out_h, out_w):
    """Spectra with only the DC bin make every block's window constant, so
    every position of a cell ties exactly; each block's pair must be its
    first position inside the output (the first-index rule), in stacked
    CTAs too, and the values must match the plain version's."""
    rng = np.random.default_rng(29)
    geom = (bh, bw, kh, kw, out_h, out_w)
    ops = [torch.zeros_like(x) for x in _planes(rng, cuda, b, f, n, *geom)]
    ops[0][..., 0, 0] = torch.as_tensor(
        rng.standard_normal(ops[0].shape[:4]).astype(np.float32), device=cuda)
    ops[2][..., 0, 0] = 1.0
    ops16 = [x.to(torch.bfloat16) for x in ops]
    for planes, splits, tol in ((ops, None, TOL), (ops16, 3, TOL), (ops16, None, IO_TOL)):
        got_v, got_i = tbc.block_conv_peaks(*planes, *geom, splits)
        want_v, want_i = tbc.block_conv_peaks_reference(*planes, *geom, splits)
        torch.cuda.synchronize()
        assert _rel(got_v, want_v) <= tol
        assert torch.equal(got_i, want_i)
        vh, vw = bh - kh + 1, bw - kw + 1
        first = (torch.arange(got_i.shape[2], device=cuda)[:, None] * vh * out_w
                 + torch.arange(got_i.shape[3], device=cuda) * vw)
        assert torch.equal(got_i, first.to(torch.int32).expand_as(got_i))


@pytest.mark.gpu
@pytest.mark.parametrize("f", [1, 3])
def test_spectral_mac_kernel_matches_einsum_on_gpu(cuda, f):
    from cuda_fft_convolution_torch.ops import spectral_mac as tmac

    rng = np.random.default_rng(5)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)

    ops = (t(2, f, 67, 35), t(2, f, 67, 35), t(7, f, 67, 35), t(7, f, 67, 35))
    before = tmac.spectral_mac.launches
    got = tmac.spectral_mac(*ops)
    want = tmac.spectral_mac_planes(*ops)
    torch.cuda.synchronize()
    assert tmac.spectral_mac.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == (2, 7, 67, 35)
        assert _rel(g, w) <= TOL
    # bf16 planes: f32 accumulation and outputs, against the upcast einsum
    ops16 = tuple(x.to(torch.bfloat16) for x in ops)
    before16 = tmac.spectral_mac.launches_by_mode["spectral_mac_bf16"]
    got16 = tmac.spectral_mac(*ops16)
    want16 = tmac.spectral_mac_planes(*ops16)
    torch.cuda.synchronize()
    assert tmac.spectral_mac.launches_by_mode["spectral_mac_bf16"] == before16 + 1
    for g, w in zip(got16, want16):
        assert g.dtype == torch.float32 and w.dtype == torch.float32
        assert _rel(g, w) <= 1e-6
    # the direct engine runs the kernel
    data = rng.standard_normal((90, 110, f)).astype(np.float32)
    bank = rng.standard_normal((3, 9, 7, f)).astype(np.float32)
    before = tmac.spectral_mac.launches
    maps = tfc.fft_conv(data, kernels=bank, mode="same", algorithm="direct",
                        device=cuda)
    torch.cuda.synchronize()
    assert tmac.spectral_mac.launches == before + 1
    want_maps = tfc.fft_conv(data, kernels=bank, mode="same", algorithm="direct",
                             device="cpu")
    assert _rel(maps.cpu(), want_maps) <= TOL


# (B, N, F, H, Wc) for the MAC kernel's tiles: ragged in every direction
# (partial image and filter tiles, S = 1000 a partial chunk), the trainer's
# launch pattern at 20 x 11 (forward, and B, N and F traded as in dK and
# dD), and one image (the B = 1 tile).
MAC_SHAPES = [(3, 13, 5, 40, 25), (8, 5, 3, 20, 11), (5, 3, 2, 20, 11), (2, 3, 5, 20, 11),
              (1, 7, 3, 67, 35)]


CUDA_ERROR_INVALID_VALUE = 1  # cudaErrorInvalidValue


def _mac_entry(planes, tile):
    """The MAC kernel's C entry for the planes' dtype with register tile
    ``tile``, called bare (the wrapper always takes ``mac_tile``'s) → (the
    entry's return code, (re, im) output planes)."""
    from cuda_fft_convolution_torch._build import library

    b, f, h, wc = planes[0].shape
    n = planes[2].shape[0]
    o_re = torch.empty((b, n, h, wc), device=planes[0].device)
    o_im = torch.empty_like(o_re)
    tag = "bf16" if planes[0].dtype == torch.bfloat16 else "f32"
    err = getattr(library(), f"fftconv_spectral_mac_{tag}")(
        *(t.data_ptr() for t in (*planes, o_re, o_im)), b, f, n, h * wc, *tile,
        torch.cuda.current_stream().cuda_stream)
    return err, (o_re, o_im)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MAC_SHAPES, ids=lambda s: "B{}N{}F{}_{}x{}".format(*s))
def test_spectral_mac_every_tile_matches_einsum_on_gpu(cuda, shape):
    """Every form the kernel instantiates (through the C entry), on float32
    and bf16 planes, against the einsum (1e-5; 1e-6 on bf16 planes, whose
    products are exact); each output's arithmetic is the same in every
    register tile (f ascending, the same two fmaf chains), so the register
    tiles agree bitwise; the split form sums the channels in another order
    (held to the same bars, not bitwise); the wrapper, one launch a call,
    equals the form the rule picks, bitwise."""
    from cuda_fft_convolution_torch.ops import spectral_mac as tmac

    b, n, f, h, wc = shape
    rng = np.random.default_rng(sum(shape))
    ops = tuple(torch.as_tensor(rng.standard_normal((m, f, h, wc)).astype(np.float32),
                                device=cuda) for m in (b, b, n, n))
    rule = tmac.mac_tile(b, n, f, h * wc, tmac.sm_count(ops[0].device))
    assert rule in tmac.MAC_TILES
    for planes, tol in ((ops, TOL), (tuple(x.to(torch.bfloat16) for x in ops), 1e-6)):
        want = tmac.spectral_mac_planes(*planes)
        first, outs = None, {}
        for tile in tmac.MAC_TILES:
            err, got = _mac_entry(planes, tile)
            torch.cuda.synchronize()
            assert err == 0, tile
            for g, w in zip(got, want):
                assert g.dtype == torch.float32 and g.shape == (b, n, h, wc)
                assert _rel(g, w) <= tol, tile
            outs[tile] = got
            if tile == tmac.MAC_SPLIT:
                continue
            if first is None:
                first = got
            assert all(torch.equal(g, w) for g, w in zip(got, first)), tile
        before = tmac.spectral_mac.launches
        got = tmac.spectral_mac(*planes)
        torch.cuda.synchronize()
        assert tmac.spectral_mac.launches == before + 1
        assert all(torch.equal(g, w) for g, w in zip(got, outs[rule]))


@pytest.mark.gpu
def test_spectral_mac_tile_outside_the_set_is_refused_on_gpu(cuda):
    """A tile the kernel does not instantiate is refused by the C entry
    with cudaErrorInvalidValue, at both dtypes, and launches nothing."""
    from cuda_fft_convolution_torch.ops import spectral_mac as tmac

    ops = tuple(torch.ones((m, 2, 8, 5), device=cuda) for m in (2, 2, 3, 3))
    for planes in (ops, tuple(x.to(torch.bfloat16) for x in ops)):
        for tile in ((3, 3), (1, 4), (4, 4), (8, 8), (0, 0)):
            assert tile not in tmac.MAC_TILES
            err, _ = _mac_entry(planes, tile)
            assert err == CUDA_ERROR_INVALID_VALUE, tile


@pytest.mark.gpu
def test_spectral_mac_split_form_at_mosse_on_gpu(cuda):
    """MOSSE's respond (B 1, F 31, N 1, 64 × 33 bins): the rule picks the
    split form on the H100 (3 CTAs of the (1, 1) tile on 132 SMs), the
    wrapper launches it once, within 1e-5 of the plain version, and a
    launch gives the same bits every run."""
    from cuda_fft_convolution_torch.ops import spectral_mac as tmac

    rng = np.random.default_rng(31)
    ops = tuple(torch.as_tensor(rng.standard_normal((1, 31, 64, 33)).astype(np.float32),
                                device=cuda) for _ in range(4))
    assert tmac.mac_tile(1, 1, 31, 64 * 33, tmac.sm_count(ops[0].device)) == tmac.MAC_SPLIT
    before = tmac.spectral_mac.launches_by_form[tmac.MAC_SPLIT]
    got = tmac.spectral_mac(*ops)
    again = tmac.spectral_mac(*ops)
    torch.cuda.synchronize()
    assert tmac.spectral_mac.launches_by_form[tmac.MAC_SPLIT] == before + 2
    for g, w, a in zip(got, tmac.spectral_mac_planes(*ops), again):
        assert _rel(g, w) <= TOL
        assert torch.equal(g, a)


# The headline plan with N = 101 kernels: 192 blocks (19,392 CTAs), and a
# 5 × 3 block crop of it (1,515 CTAs).
HEADLINE_N101 = [(1, 1, 101, 127, 447, 64, 64, 2048, 2048),
                 (1, 1, 101, 127, 447, 64, 64, 5 * 64, 3 * 384)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,out_h,out_w", HEADLINE_N101)
def test_w_stage_ring_every_tier_on_gpu(cuda, b, f, n, bh, bw, kh, kw, out_h, out_w):
    """The one-block 64-row configuration's W stage on its TMA ring: one
    maps and one peaks entry per tier (3×TF32, 6×TF32, one pass on f32
    spectra; BF16IO on bf16) against the plain version, each launch
    counted; peak indices equal (at one pass and BF16IO, whose rounding
    flips allow it, a differing index holds a near tie)."""
    rng = np.random.default_rng(41)
    geom = (bh, bw, kh, kw, out_h, out_w)
    ops = _planes(rng, cuda, b, f, n, *geom)
    ops16 = tuple(x.to(torch.bfloat16) for x in ops)
    assert tbc.tile_rows(bw // 2 + 1, bh - kh + 1) == 64
    for planes, splits, tol in ((ops, 3, TOL), (ops, 6, TOL), (ops, 1, ONE_PASS_TOL),
                                (ops16, tbc.BF16IO, IO_TOL)):
        want = tbc.block_conv_reference(*planes, *geom, splits=splits)
        before = tbc.block_conv.launches
        got = tbc.block_conv(*planes, *geom, torch.float32, splits)
        torch.cuda.synchronize()
        assert tbc.block_conv.launches == before + 1
        assert _rel(got, want) <= tol, splits
        want_v, want_i = tbc.block_conv_peaks_reference(*planes, *geom, splits, radix_h=False)
        got_v, got_i = tbc.block_conv_peaks(*planes, *geom, splits, radix_h=False)
        torch.cuda.synchronize()
        assert _rel(got_v, want_v) <= tol, splits
        flips = got_i != want_i
        if splits in (3, 6):
            assert not flips.any()
        elif flips.any():
            flat = want.reshape(b, n, -1)
            at = flat.gather(-1, got_i.reshape(b, n, -1).long()).reshape(got_i.shape)
            assert (at[flips] >= want_v[flips] - tol * want_v.abs().max()).all()
        del want, got, want_v, want_i, got_v, got_i


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,n", [(8, 3, 5), (5, 2, 3), (2, 5, 3)])
def test_mac_gradient_at_the_trainer_pattern_on_gpu(cuda, b, f, n):
    """The kernel's backward at the trainer's launch pattern (20 x 11
    pixels) against the einsum's autograd (1e-5): the forward at (B, F, N),
    dD at (B, N, F) and dK at (N, B, F), each launched once."""
    from cuda_fft_convolution_torch.ops import spectral_mac as tmac

    rng = np.random.default_rng(b * 100 + f * 10 + n)
    planes = [rng.standard_normal((m, f, 20, 11)).astype(np.float32) for m in (b, b, n, n)]
    cot = [torch.as_tensor(rng.standard_normal((b, n, 20, 11)).astype(np.float32), device=cuda)
           for _ in range(2)]

    def grads(mac):
        xs = [torch.tensor(p, device=cuda, requires_grad=True) for p in planes]
        return torch.autograd.grad(mac(*xs), xs, cot)

    by_shape = collections.Counter(tmac.spectral_mac.launches_by_shape)
    kernel = grads(tmac.spectral_mac_auto_planes)
    torch.cuda.synchronize()
    by_shape = collections.Counter(tmac.spectral_mac.launches_by_shape) - by_shape
    assert by_shape == collections.Counter(
        {("spectral_mac_f32", *m, 20, 11): 1 for m in ((b, f, n), (b, n, f), (n, b, f))})
    for g, w in zip(kernel, grads(tmac.spectral_mac_planes)):
        assert _rel(g, w) <= TOL


@pytest.mark.gpu
def test_detect_peaks_on_gpu_matches_cpu(cuda):
    from cuda_fft_convolution_torch.models import detect_peaks

    rng = np.random.default_rng(9)
    data = rng.standard_normal((300, 500, 2)).astype(np.float32)
    bank = rng.standard_normal((4, 17, 33, 2)).astype(np.float32)
    before = tbc.block_conv_peaks.launches
    vals, pos = detect_peaks(torch.as_tensor(data, device=cuda),
                             torch.as_tensor(bank, device=cuda))
    torch.cuda.synchronize()
    assert tbc.block_conv_peaks.launches == before + 1
    want_v, want_p = detect_peaks(data, bank, device="cpu")
    assert torch.equal(pos.cpu(), want_p)
    assert _rel(vals.cpu(), want_v) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["tiled", "direct"])
def test_bf16_tier_on_gpu_matches_cpu(cuda, algorithm):
    """fft_conv at the bf16 tier and with bf16 maps on the card: the same
    dtype and shape as on the CPU, within BF16_TOL of the CPU's float32
    maps, through the bf16 entries of the kernels."""
    from cuda_fft_convolution_torch.ops import spectral_mac as tmac

    rng = np.random.default_rng(21)
    data = rng.standard_normal((300, 500, 2)).astype(np.float32)
    bank = rng.standard_normal((4, 17, 33, 2)).astype(np.float32)
    want = tfc.fft_conv(data, kernels=bank, mode="same", algorithm=algorithm, device="cpu")
    counts = (tbc.block_conv.launches_by_mode if algorithm == "tiled"
              else tmac.spectral_mac.launches_by_mode)
    for out_dtype, entry in ((None, "bf16_io"), ("bfloat16", "bf16_bf16maps_io")):
        key = f"block_conv_{entry}" if algorithm == "tiled" else "spectral_mac_bf16"
        before = counts[key]
        got = tfc.fft_conv(data, kernels=bank, mode="same", algorithm=algorithm,
                           store_dtype="bfloat16", out_dtype=out_dtype, device=cuda)
        torch.cuda.synchronize()
        assert counts[key] == before + 1
        cpu = tfc.fft_conv(data, kernels=bank, mode="same", algorithm=algorithm,
                           store_dtype="bfloat16", out_dtype=out_dtype, device="cpu")
        assert got.dtype == cpu.dtype and got.shape == want.shape
        assert _rel(got.float().cpu(), want) <= BF16_TOL


@pytest.mark.gpu
def test_detect_peaks_bf16_tier_on_gpu(cuda):
    """detect_peaks at the bf16 tier runs the peaks kernel's BF16IO entry
    and finds planted templates."""
    from cuda_fft_convolution_torch.models import detect_peaks

    rng = np.random.default_rng(23)
    data = rng.standard_normal((300, 500, 2)).astype(np.float32)
    bank = rng.standard_normal((4, 17, 33, 2)).astype(np.float32)
    corners = [(20, 30), (150, 400), (240, 60), (100, 200)]
    for t, (y0, x0) in enumerate(corners):
        data[y0 : y0 + 17, x0 : x0 + 33] += 3.0 * bank[t]
    before = tbc.block_conv_peaks.launches_by_mode["block_conv_peaks_bf16_io"]
    vals, pos = detect_peaks(torch.as_tensor(data, device=cuda),
                             torch.as_tensor(bank, device=cuda), store_dtype="bfloat16")
    torch.cuda.synchronize()
    assert tbc.block_conv_peaks.launches_by_mode["block_conv_peaks_bf16_io"] == before + 1
    assert vals.dtype == torch.float32
    want = torch.tensor([(y0 + 8, x0 + 16) for y0, x0 in corners], dtype=torch.int32)
    assert torch.equal(pos.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [dict(padding="clamp"), dict(kernel_layout="centered"),
                                  dict(padding="clamp", same_offset="matlab")],
                         ids=["clamp", "centered", "clamp-matlab"])
def test_clamp_and_centered_on_gpu_match_cpu(cuda, opts):
    """Clamp padding and centered kernels run the direct engine on the card,
    through the MAC kernel, and equal the CPU call."""
    from cuda_fft_convolution_torch.ops import spectral_mac as tmac

    rng = np.random.default_rng(31)
    data = rng.standard_normal((300, 500, 2)).astype(np.float32)
    bank = rng.standard_normal((4, 17, 32, 2)).astype(np.float32)
    before = tmac.spectral_mac.launches
    got = tfc.fft_conv(data, kernels=bank, mode="same", device=cuda, **opts)
    torch.cuda.synchronize()
    assert tmac.spectral_mac.launches == before + 1
    want = tfc.fft_conv(data, kernels=bank, mode="same", device="cpu", **opts)
    assert got.is_cuda and got.shape == want.shape
    assert _rel(got.cpu(), want) <= TOL


@pytest.mark.gpu
def test_ragged_bucketing_on_gpu(cuda):
    """A cell array spanning three pow-2 envelopes: each bucket launches the
    fused kernel at its own plan; the maps equal the CPU call's."""
    rng = np.random.default_rng(33)
    data = rng.standard_normal((512, 512, 1)).astype(np.float32)
    bank = [rng.standard_normal((s, s, 1)).astype(np.float32) for s in (9, 33, 17, 64, 9)]
    before = tbc.block_conv.launches
    got = tfc.fft_conv(data, kernels=bank, mode="same", device=cuda)
    torch.cuda.synchronize()
    assert tbc.block_conv.launches == before + 3
    want = tfc.fft_conv(data, kernels=bank, mode="same", device="cpu")
    for g, w in zip(got, want):
        assert g.is_cuda and _rel(g.cpu(), w) <= TOL


@pytest.mark.gpu
def test_chunked_streaming_and_pipelined_on_gpu(cuda):
    """The direct engine's chunked, streaming-spatial and pipelined paths on
    the card, forced through Config.hbm_budget_bytes and chunk_size: one MAC
    launch a chunk, maps equal to the whole-bank call."""
    from cuda_fft_convolution_torch.ops import spectral_mac as tmac
    from cuda_fft_convolution_torch.runtime import planner

    rng = np.random.default_rng(35)
    data = rng.standard_normal((2, 200, 300, 3)).astype(np.float32)
    bank = rng.standard_normal((9, 12, 12, 3)).astype(np.float32)
    sd = tfc.fft_data(data, 12, 12, device=cuda)
    sk = tfc.fft_kernels(bank, spectral=sd)
    whole = tfc.conv_spectral(sd, sk, mode="same")
    piped = tfc.conv_spectral_pipelined(sd, sk, chunk_size=4, mode="same")
    resident = planner.spectra_bytes(9, 3, sd.fft_h, sd.fft_w)
    try:
        for nbytes, raw in ((resident + 2 * 9 * 4 * sd.fft_h * sd.fft_w, False),
                            (resident, True)):
            tfc.set_config(hbm_budget_bytes=nbytes)
            before = tmac.spectral_mac.launches
            got = tfc.conv_spectral(sd, bank if raw else sk, mode="same")
            torch.cuda.synchronize()
            assert tmac.spectral_mac.launches - before > 1  # chunked
            assert _rel(got, whole) <= 1e-6
    finally:
        tfc.set_config(hbm_budget_bytes=None)
    assert _rel(piped, whole) <= 1e-6
    tiled = tfc.fft_data_tiled(data, 12, 12, trim_mode="same", device=cuda)
    before = tbc.block_conv.launches
    got = tfc.conv_spectral_pipelined(tiled, bank, chunk_size=4, mode="same")
    torch.cuda.synchronize()
    assert tbc.block_conv.launches == before + 3
    assert _rel(got, tfc.conv_spectral(tiled, bank, mode="same")) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["tiled", "direct"])
def test_stream_bitwise_equals_plan_on_gpu(cuda, algorithm):
    """ConvStream at depth 3 on host numpy frames (the pinned ring): every
    frame's maps bitwise equal to the synchronous plan's for that frame,
    through the frame's kernel, with a bank swap mid-stream."""
    from cuda_fft_convolution_torch.ops import spectral_mac as tmac

    rng = np.random.default_rng(41)
    bank = rng.standard_normal((6, 17, 33, 2)).astype(np.float32)
    bank2 = rng.standard_normal((6, 17, 33, 2)).astype(np.float32)
    frames = [rng.standard_normal((300, 500, 2)).astype(np.float32) for _ in range(7)]
    wrapper = tbc.block_conv if algorithm == "tiled" else tmac.spectral_mac
    stream = tfc.ConvStream.create((300, 500, 2), bank, depth=3, mode="same",
                                   algorithm=algorithm, device=cuda)
    before = wrapper.launches
    futs = [stream.submit(f) for f in frames[:4]]
    assert stream.inflight <= 3
    stream.update_kernels(bank2)
    futs += [stream.submit(f) for f in frames[4:]]
    stream.flush()
    assert wrapper.launches - before == len(frames)
    for i, (f, fut) in enumerate(zip(frames, futs)):
        want = stream.plan.execute(f, bank if i < 4 else bank2)
        assert fut.result().is_cuda and torch.equal(fut.result(), want)


@pytest.mark.gpu
def test_stream_submit_does_not_sync_on_gpu(cuda):
    """A submit of a host frame into a queue with room neither synchronises
    (torch's sync debug mode raises on any synchronising call) nor waits
    for the work already queued."""
    rng = np.random.default_rng(42)
    bank = rng.standard_normal((16, 33, 33, 1)).astype(np.float32)
    frame = rng.standard_normal((1024, 1024, 1)).astype(np.float32)
    stream = tfc.ConvStream.create((1024, 1024, 1), bank, depth=3, mode="same",
                                   algorithm="tiled", head="peaks", device=cuda)
    stream.submit(frame).result()  # warm: DFT matrices, cuFFT plans
    stream.flush()
    first = stream.submit(frame)
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = stream.submit(frame)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not first.done() and not second.done()
    vals, pos = second.result()
    assert torch.equal(pos, first.result()[1])


@pytest.mark.gpu
def test_stream_fifo_events_on_gpu(cuda):
    """With real CUDA events: resolving the last future marks every earlier
    one done without synchronising its own event, and a later submission
    is not implied done by the old watermark."""
    rng = np.random.default_rng(43)
    bank = rng.standard_normal((2, 4, 4, 1)).astype(np.float32)
    frame = torch.as_tensor(rng.standard_normal((256, 256, 1)).astype(np.float32),
                            device=cuda)
    stream = tfc.ConvStream.create((256, 256, 1), bank, depth=8, mode="same",
                                   algorithm="direct", device=cuda)
    futs = [stream.submit(frame) for _ in range(5)]
    assert all(f._event is not None for f in futs)
    assert not any(f.done() for f in futs[:4])
    futs[-1].result()
    assert all(f.done() for f in futs)
    assert all(f._event is not None for f in futs[:-1])  # never synchronised
    for f in futs[:-1]:
        assert torch.equal(f.result(), futs[-1].result())
    f6 = stream.submit(frame)
    assert not f6.done()
    stream.flush()
    assert f6.done()


@pytest.mark.gpu
def test_autotune_registers_under_device_name_on_gpu(cuda):
    """The tuner measures on the card and registers under
    torch.cuda.get_device_name; choose_block_plan then returns the winner
    on the card and nowhere else."""
    from cuda_fft_convolution_torch.ops import tiled as tt
    from cuda_fft_convolution_torch.runtime import autotune as ta

    ta._MEASURED.clear()
    try:
        best, timings = ta.autotune_block_geometry(
            (512, 512, 1), 9, 9, n_kernels=4, candidates=[(24, 120, 40, 160), (16, 248)],
            iters=2, device=cuda)
        assert set(timings) == {(24, 120, 40, 160), (16, 248)}
        (key,) = ta._MEASURED
        assert key[0] == torch.cuda.get_device_name(cuda)
        vh, vw, bh, bw = ta._blocks(best, 9, 9)
        plan = (bh, bw, bh - vh + 1, bw - vw + 1)
        assert tt.choose_block_plan(1024, 1024, 9, 9, device=cuda) == plan
        assert tt.choose_block_plan(1024, 1024, 9, 9, device="cpu") == (16, 136, 9, 9)
    finally:
        ta._MEASURED.clear()


@pytest.mark.gpu
@pytest.mark.parametrize("f", [3, 31])
def test_mac_backward_kernel_matches_einsum_backward_on_gpu(cuda, f):
    """The MAC's backward on the card launches the kernel once per
    cotangent asked for (dD, dK) and agrees with the einsum's autograd on
    the same CUDA planes; a second derivative runs through it too."""
    from cuda_fft_convolution_torch.ops import spectral_mac as tmac

    rng = np.random.default_rng(11)
    shapes = [(2, f, 67, 35)] * 2 + [(5, f, 67, 35)] * 2
    planes = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    cot = [torch.as_tensor(rng.standard_normal((2, 5, 67, 35)).astype(np.float32),
                           device=cuda) for _ in range(2)]

    def grads(mac, need=(True,) * 4):
        xs = [torch.tensor(p, device=cuda, requires_grad=r) for p, r in zip(planes, need)]
        out = mac(*xs)
        torch.cuda.synchronize()
        before = tmac.spectral_mac.launches
        by_shape = collections.Counter(tmac.spectral_mac.launches_by_shape)
        g = torch.autograd.grad(out, [x for x in xs if x.requires_grad], cot)
        torch.cuda.synchronize()
        by_shape = collections.Counter(tmac.spectral_mac.launches_by_shape) - by_shape
        return g, tmac.spectral_mac.launches - before, by_shape

    kernel, launches, by_shape = grads(tmac.spectral_mac_auto_planes)
    einsum, none, _ = grads(tmac.spectral_mac_planes)
    assert (launches, none) == (2, 0)
    # dD = MAC(g, conj(K)ᵀ) at (B, F, N) = (2, 5, f); dK = MAC(gᵀ, conj(D)ᵀ) at (5, 2, f)
    assert by_shape == collections.Counter({("spectral_mac_f32", 2, 5, f, 67, 35): 1,
                                          ("spectral_mac_f32", 5, 2, f, 67, 35): 1})
    for g, w in zip(kernel, einsum):
        assert _rel(g, w) <= TOL
    only_k, launches, by_shape = grads(tmac.spectral_mac_auto_planes, (False, False, True, True))
    assert launches == 1 and list(by_shape) == [("spectral_mac_f32", 5, 2, f, 67, 35)]
    for g, w in zip(only_k, einsum[2:]):
        assert _rel(g, w) <= TOL
    # grad of grad: d/dk_re <d loss/d d_re, tan>
    tan = torch.as_tensor(rng.standard_normal(shapes[0]).astype(np.float32), device=cuda)

    def second(mac):
        xs = [torch.tensor(p, device=cuda, requires_grad=True) for p in planes]
        loss = sum((o * c).sum() for o, c in zip(mac(*xs), cot))
        (g_dr,) = torch.autograd.grad(loss, [xs[0]], create_graph=True)
        return torch.autograd.grad((g_dr * tan).sum(), [xs[2]])[0]

    assert _rel(second(tmac.spectral_mac_auto_planes), second(tmac.spectral_mac_planes)) <= TOL


@pytest.mark.gpu
def test_models_on_gpu_match_cpu(cuda):
    """The pyramid, MOSSE and the filter-bank detector on the card against
    the same calls on the CPU, each through the MAC kernel."""
    from cuda_fft_convolution_torch import models as tm
    from cuda_fft_convolution_torch.ops import spectral_mac as tmac

    rng = np.random.default_rng(13)
    img = rng.standard_normal((96, 80, 3)).astype(np.float32)
    bank = rng.standard_normal((4, 9, 9, 3)).astype(np.float32)
    pyr = tm.build_pyramid(img, 9, 9, num_levels=3)
    before = tmac.spectral_mac.launches
    det = tm.detect_pyramid_peaks(pyr, bank)
    torch.cuda.synchronize()
    assert tmac.spectral_mac.launches == before + 3 and det.values.is_cuda
    want = tm.detect_pyramid_peaks(tm.build_pyramid(img, 9, 9, num_levels=3, device="cpu"),
                                   bank)
    assert torch.equal(det.positions.cpu(), want.positions)
    assert torch.equal(det.best_position.cpu(), want.best_position)
    assert _rel(det.values.cpu(), want.values) <= TOL

    patches = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    targets = np.stack([tm.gaussian_target(32, 32, (16, 16 + i), device="cpu").numpy()
                        for i in range(4)])
    filt = tm.train_mosse(patches, targets, 32, 32)
    sd = tfc.fft_data(rng.standard_normal((32, 32, 3)).astype(np.float32), 1, 1)
    before = tmac.spectral_mac.launches
    resp = tm.respond(filt, sd)
    torch.cuda.synchronize()
    assert tmac.spectral_mac.launches == before + 1
    cpu_filt = tm.MosseFilter(filt.h_re.cpu(), filt.h_im.cpu(), 32, 32)
    want_resp = tm.respond(cpu_filt, tfc.SpectralData(
        re=sd.re.cpu(), im=sd.im.cpu(), fft_h=32, fft_w=32, data_h=32, data_w=32))
    assert _rel(resp.cpu(), want_resp) <= TOL

    kernels = rng.standard_normal((3, 3, 5, 5)).astype(np.float32) / 8
    fields = {"kernels": kernels, "bias": np.zeros(3, np.float32)}
    images = rng.standard_normal((2, 3, 40, 36)).astype(np.float32)
    targets = rng.standard_normal((2, 3, 40, 36)).astype(np.float32)
    losses = []
    for device in (cuda, "cpu"):
        model = tfc.detector_from_numpy(fields, device=device)
        opt = torch.optim.Adam(model.parameters(), lr=3e-2)
        before = tmac.spectral_mac.launches
        model, opt, loss = tm.train_step(model, opt, images, targets)
        launches = tmac.spectral_mac.launches - before
        losses.append((float(loss), model.kernels.detach().cpu(), launches))
    (l_gpu, k_gpu, n_gpu), (l_cpu, k_cpu, n_cpu) = losses
    assert (n_gpu, n_cpu) == (2, 0)  # forward + dK; the images need no gradient
    assert abs(l_gpu - l_cpu) <= TOL * l_cpu
    assert _rel(k_gpu, k_cpu) <= 1e-4


def _conv_full_f64(data, kern):
    """float64 'full' convolution summed over channels, (F, H, W) data with
    an (F, Kh, Kw) kernel."""
    f, h, w = data.shape
    oh, ow = h + kern.shape[1] - 1, w + kern.shape[2] - 1
    return np.fft.irfft2((np.fft.rfft2(data.astype(np.float64), s=(oh, ow))
                          * np.fft.rfft2(kern.astype(np.float64), s=(oh, ow))).sum(0),
                         s=(oh, ow))


@pytest.mark.gpu
@pytest.mark.parametrize("f,h,w,k", [(3, 300, 280, 64), (64, 128, 120, 3), (16, 256, 250, 7)])
def test_direct_conv_single_without_tf32_on_gpu(cuda, f, h, w, k):
    """cuDNN's TF32 (PyTorch's default) is off inside the call, and the
    setting is restored: within 1e-5 of float64. At 64² kernels cuDNN's
    fp32 algorithms do not round to TF32 even when allowed; with many
    channels and small kernels they do (``chip_smoke.py`` prints a plain
    ``conv2d``'s error with TF32 on beside the call's)."""
    rng = np.random.default_rng(7)
    data = rng.standard_normal((f, h, w)).astype(np.float32)
    kern = rng.standard_normal((f, k, k)).astype(np.float32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = tfc.direct_conv_single(data, kern)
        torch.cuda.synchronize()
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert got.is_cuda and tuple(got.shape) == (h + k - 1, w + k - 1)
    assert _rel(got.double().cpu(), torch.as_tensor(_conv_full_f64(data, kern))) <= TOL


@pytest.mark.gpu
def test_cores_and_complex_wrappers_reach_the_mac_kernel_on_gpu(cuda):
    from cuda_fft_convolution_torch.ops import conv as tconv
    from cuda_fft_convolution_torch.ops import spectral_mac as tmac

    rng = np.random.default_rng(11)
    data = rng.standard_normal((3, 70, 50)).astype(np.float32)
    bank = rng.standard_normal((5, 3, 9, 7)).astype(np.float32)
    before = tmac.spectral_mac.launches
    got = tfc.fft_conv_stack(data, bank)
    torch.cuda.synchronize()
    assert tmac.spectral_mac.launches == before + 1 and got.is_cuda
    assert _rel(got.cpu(), tfc.fft_conv_stack(data, bank, device="cpu")) <= 1e-6

    def spectra(*shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.as_tensor(z.astype(np.complex64))

    d, k = spectra(2, 3, 20, 11), spectra(4, 3, 20, 11)
    for fn in (tmac.spectral_mac_pallas, tmac.spectral_mac_auto):
        before = tmac.spectral_mac.launches
        out = fn(d.to(cuda), k.to(cuda))
        torch.cuda.synchronize()
        assert tmac.spectral_mac.launches == before + 1
        want = fn(d, k)
        assert out.dtype == torch.complex64
        assert _rel(out.real.cpu(), want.real) <= 1e-6
        assert _rel(out.imag.cpu(), want.imag) <= 1e-6
    before = tmac.spectral_mac.launches
    out = tconv.spectral_mac(d[0].to(cuda), k.reshape(2, 2, 3, 20, 11).to(cuda))
    torch.cuda.synchronize()
    assert tmac.spectral_mac.launches == before + 1 and tuple(out.shape) == (2, 2, 20, 11)
    want = tconv.spectral_mac(d[0], k.reshape(2, 2, 3, 20, 11))
    assert _rel(out.real.cpu(), want.real) <= 1e-6


@pytest.mark.gpu
def test_selftest_kernels_ok_on_gpu(cuda):
    rep = tfc.selftest()
    assert rep["backend"] == "cuda" and rep["fft_ok"] is True
    assert rep["device_kind"] == torch.cuda.get_device_name()
    assert rep["kernels_ok"] is True, rep.get("kernels_failed", rep.get("kernels_error"))
    # 3 configurations x (6 entries + 3 of each of the 6xTF32, one-pass and
    # BF16IO tiers) + 2 MAC entries at each of the 3 MAC forms (the (1, 1)
    # and (8, 4) register tiles and the split form)
    assert len(rep["kernels"]) == 51


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A world of one NCCL rank on the card → its (1, 1) mesh."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=(tmp_path / "store").as_uri(), rank=0,
                            world_size=1, device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield tfc.make_mesh(data=1, kernels=1)
    finally:
        dist.destroy_process_group()


def _counted(fn):
    """``fn()`` with every kernel launch count set to 0 just before →
    (its output, the launches by C entry)."""
    from cuda_fft_convolution_torch.ops import spectral_mac as tmac

    wrappers = (tbc.block_conv, tbc.block_conv_peaks, tmac.spectral_mac)
    tbc.reset_launches(*wrappers)
    out = fn()
    torch.cuda.synchronize()
    counts = collections.Counter()
    for w in wrappers:
        counts.update(w.launches_by_mode)
    return out, counts


@pytest.mark.gpu
def test_make_mesh_needs_a_process_group_on_gpu(cuda):
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(InvalidInputError, match="init_process_group"):
        tfc.make_mesh()


@pytest.mark.gpu
def test_sharded_calls_equal_single_device_on_gpu(nccl_mesh):
    """In a world of one NCCL rank the sharded tiled, direct and peaks
    calls give the single-device outputs bitwise, through the same C
    entries the same number of times (no DTensor reaches a kernel)."""
    rng = np.random.default_rng(44)
    data = torch.as_tensor(rng.standard_normal((300, 500, 2)).astype(np.float32), device="cuda")
    bank = torch.as_tensor(rng.standard_normal((7, 17, 33, 2)).astype(np.float32), device="cuda")
    st = tfc.fft_data_tiled(data, 17, 33, trim_mode="same")
    sd = tfc.fft_data(data, 17, 33)
    placed = tfc.shard_kernel_bank(tfc.fft_kernels(bank, spectral=st), nccl_mesh)
    assert tfc.shard_kernel_bank(placed, nccl_mesh) is placed
    pairs = [
        (lambda: tfc.conv_spectral_sharded(st, placed, nccl_mesh, mode="same"),
         lambda: tfc.conv_spectral(st, bank, mode="same")),
        (lambda: tfc.conv_spectral_sharded(sd, bank, nccl_mesh, mode="same"),
         lambda: tfc.conv_spectral(sd, bank, mode="same")),
        (lambda: tfc.detect_peaks_sharded(st, bank, nccl_mesh),
         lambda: tfc.detect_peaks(st, bank, mode="same")),
        (lambda: tfc.detect_peaks_sharded(st, bank, nccl_mesh, k=3),
         lambda: tfc.detect_top_k(st, bank, k=3, mode="same")),
    ]
    for sharded, single in pairs:
        got, got_counts = _counted(sharded)
        want, want_counts = _counted(single)
        assert got_counts == want_counts and sum(got_counts.values()) >= 1
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.to_local().is_cuda and torch.equal(g.full_tensor(), w)


@pytest.mark.gpu
def test_sharded_stream_on_gpu(nccl_mesh):
    """ShardedConvStream on host frames: each frame bitwise equal to
    ConvStream's, one maps-kernel launch a frame, and a submit into a queue
    with room does not synchronise."""
    rng = np.random.default_rng(45)
    bank = rng.standard_normal((6, 17, 33, 2)).astype(np.float32)
    frames = [rng.standard_normal((300, 500, 2)).astype(np.float32) for _ in range(5)]
    kw = dict(depth=3, mode="same", algorithm="tiled")
    stream = tfc.ShardedConvStream(nccl_mesh, bank, (300, 500, 2), **kw)
    plain = tfc.ConvStream.create((300, 500, 2), bank, device="cuda", **kw)
    futs, counts = _counted(lambda: [stream.submit(f) for f in frames])
    assert counts == {"block_conv_f32": len(frames)}
    for f, fut in zip(frames, futs):
        assert torch.equal(fut.result().full_tensor(), plain.submit(f).result())
    stream.flush()
    first = stream.submit(frames[0])
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = stream.submit(frames[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(second.result().to_local(), futs[1].result().to_local())
    assert first.done()


@pytest.mark.gpu
def test_train_step_sharded_on_gpu(nccl_mesh):
    """The DP×TP step in a world of one equals train_step: the loss within
    1e-6, the updated kernels within 1e-5, the MAC kernel launched for the
    forward and dK."""
    from cuda_fft_convolution_torch.models import detector_from_numpy, train_step
    from cuda_fft_convolution_torch.parallel import train_step_sharded

    rng = np.random.default_rng(46)
    init = {"kernels": (0.1 * rng.standard_normal((8, 3, 5, 5))).astype(np.float32),
            "bias": rng.standard_normal(8).astype(np.float32)}
    images = torch.as_tensor(rng.standard_normal((4, 3, 64, 64)).astype(np.float32),
                             device="cuda")
    targets = torch.as_tensor(rng.standard_normal((4, 8, 64, 64)).astype(np.float32),
                              device="cuda")
    a, b = (detector_from_numpy(init) for _ in range(2))
    _, _, want = train_step(a, torch.optim.Adam(a.parameters(), lr=1e-2), images, targets)
    (_, _, got), counts = _counted(lambda: train_step_sharded(
        b, torch.optim.Adam(b.parameters(), lr=1e-2), images, targets, nccl_mesh))
    assert counts == {"spectral_mac_f32": 2}
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    assert _rel(b.kernels.detach(), a.kernels.detach()) <= TOL


# The radix-2 bodies (JAX's v4, v5, v5x; ops/block_conv.py radix_h_legal,
# radix_w_legal): JAX's fp32 and bf16 F=1 plan (256, 512, 65, 129) in the
# 64-row configuration (every body the cluster pair at 6×TF32), its 32²
# plan (128, 512, 33, 129), Wc = 513 (every body the pair where v3 pairs),
# a window start that leaves a partial pair chunk and a partial single
# chunk (Vh 200: M − w0 = 72 pairs, 56 single rows), and a v4-only plan
# (Wc = 301, M = 40; W odd, so no DIF).
RADIX_GEOMETRIES = [
    (1, 1, 3, 256, 512, 65, 129, 400, 800),
    (1, 2, 3, 128, 512, 33, 129, 200, 800),
    (1, 1, 2, 256, 1024, 65, 129, 400, 1800),
    (2, 1, 2, 256, 512, 57, 129, 450, 700),
    (1, 2, 3, 80, 601, 17, 50, 200, 1100),
]
RADIX_BODIES = {"v4": dict(radix_h=True), "v5": dict(radix_w=True),
                "v5x": dict(radix_w=True, xsliver=True)}


def _radix_bodies(geom):
    bh, bw, kh, kw = geom[:4]
    legal_w = tbc.radix_w_legal(bw, kw, bw - kw + 1)
    return [b for b in RADIX_BODIES if b == "v4" or legal_w]


def _check_radix_entries(cuda, b, f, n, geom, karatsuba, bodies=None):
    """Every radix entry of the H-stage form ``karatsuba`` at ``geom`` (of
    ``bodies``, None: every body the plan's rules admit) against its plain
    version with the same flags, at every tier (see
    ``test_radix_entries_match_plain_on_gpu``); a tier whose form the
    kernels do not take (``form_taken``) raises and launches nothing."""
    rng = np.random.default_rng(37)
    bh, bw, kh, kw, out_h, out_w = geom
    ops = _planes(rng, cuda, b, f, n, *geom)
    ops16 = tuple(x.to(torch.bfloat16) for x in ops)
    for body in bodies or _radix_bodies(geom):
        flags = dict(RADIX_BODIES[body], karatsuba=karatsuba)
        suffix = tbc.body_suffix(body, karatsuba)
        want64 = tbc.block_conv_reference(*(x.double() for x in ops), *geom, torch.float64,
                                          None, **flags)
        for planes, tag, splits, tol in ((ops, "f32", 3, TOL), (ops, "f32", 6, TOL),
                                         (ops, "f32", 1, ONE_PASS_TOL),
                                         (ops16, "bf16", tbc.BF16IO, IO_TOL),
                                         (ops16, "bf16", 3, TOL)):
            tier = tbc.TIER_SUFFIX[splits]
            if not tbc.form_taken(bw // 2 + 1, bh - kh + 1, splits, karatsuba=karatsuba):
                before = (tbc.block_conv.launches, tbc.block_conv_peaks.launches)
                with pytest.raises(InvalidInputError, match="shared memory"):
                    tbc.block_conv(*planes, *geom, torch.float32, splits, **flags)
                with pytest.raises(InvalidInputError, match="shared memory"):
                    tbc.block_conv_peaks(*planes, *geom, splits, **flags)
                assert (tbc.block_conv.launches, tbc.block_conv_peaks.launches) == before
                continue
            want = tbc.block_conv_reference(*planes, *geom, torch.float32, splits, **flags)
            for out_dtype, maps in ((torch.float32, ""), (torch.bfloat16, "_bf16maps")):
                mode = f"block_conv_{tag}{maps}{tier}{suffix}"
                before = tbc.block_conv.launches_by_mode[mode]
                got = tbc.block_conv(*planes, *geom, out_dtype, splits, **flags)
                torch.cuda.synchronize()
                assert tbc.block_conv.launches_by_mode[mode] == before + 1, mode
                assert got.dtype == out_dtype and got.shape == want.shape
                bar = tol if out_dtype == torch.float32 else max(tol, BF16_OUT_TOL)
                assert _rel(got.float(), want) <= bar, mode
                if out_dtype == torch.float32 and splits == tbc.BF16IO:
                    assert _rms(got, want) <= IO_RMS_TOL, mode
                if out_dtype == torch.float32 and splits == 6:
                    assert _rel(got.double(), want64) <= X6_TOL, mode
            mode = f"block_conv_peaks_{tag}{tier}{suffix}"
            before = tbc.block_conv_peaks.launches_by_mode[mode]
            got_v, got_i = tbc.block_conv_peaks(*planes, *geom, splits, **flags)
            want_v, want_i = tbc.block_conv_peaks_reference(*planes, *geom, splits, **flags)
            torch.cuda.synchronize()
            assert tbc.block_conv_peaks.launches_by_mode[mode] == before + 1, mode
            assert _rel(got_v, want_v) <= tol, mode
            flips = got_i != want_i
            if flips.any():
                flat = want.reshape(b, n, -1)
                at = flat.gather(-1, got_i.reshape(b, n, -1).long()).reshape(got_i.shape)
                assert (at[flips] >= want_v[flips] - tol * want_v.abs().max()).all(), mode


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,out_h,out_w", RADIX_GEOMETRIES)
def test_radix_entries_match_plain_on_gpu(cuda, b, f, n, bh, bw, kh, kw, out_h, out_w):
    """Every radix entry (maps at f32 and bf16 maps, peaks) at every tier
    (3×, 6× and 1×TF32 on f32 spectra; BF16IO and the explicit 3×TF32 on
    bf16 spectra) against its plain version with the same flags: TOL (6×TF32
    also within X6_TOL of the plain version run in float64), ONE_PASS_TOL,
    IO_TOL and IO_RMS_TOL, BF16_OUT_TOL for bf16 maps; peak values within
    the bar and indices equal but in near ties of the bar, where the
    kernel's position holds a plain value that close. Each call counts one
    launch on its own mode."""
    _check_radix_entries(cuda, b, f, n, (bh, bw, kh, kw, out_h, out_w), False)


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,out_h,out_w", RADIX_GEOMETRIES)
def test_radix_karatsuba_entries_match_plain_on_gpu(cuda, b, f, n, bh, bw, kh, kw, out_h,
                                                    out_w):
    """Every radix entry in the Karatsuba form (``…_r4_k``, ``…_r5_k``,
    ``…_r5x_k``: maps at f32 and bf16 maps, peaks) at every tier against
    its plain version with the same flags, at the 4-product entries' bars;
    at 6×TF32 on Wc 513 the form does not fit (``form_taken``): both heads
    raise and launch nothing."""
    geom = (bh, bw, kh, kw, out_h, out_w)
    assert tbc.form_taken(513, 192, 6, karatsuba=True) is False
    _check_radix_entries(cuda, b, f, n, geom, True)


# The plans where the radix bodies run the cluster pair (ops/block_conv.py
# kernel_layout: where v3 does): W 1024 (Wc 513, 256 bins a rank) at every
# tier but the Karatsuba form at 6×TF32 (refused), with a last output
# column alone (Vw 897 = 7·128 + 1: v4 only, the DIF rule rejects it) and
# with partial pair and single chunks (Vh 200: 72 pair rows, 56 single
# rows; every body); JAX's 32² plan (Wc 257, 128 bins a rank) at 6×TF32
# (64 rows at the other tiers; every body).
PAIRED_RADIX_GEOMETRIES = [
    (1, 2, 2, 256, 1024, 65, 128, 400, 1800),
    (2, 1, 2, 256, 1024, 57, 129, 450, 1700),
    RADIX_GEOMETRIES[1],
]


@pytest.mark.gpu
@pytest.mark.parametrize("karatsuba", [False, True])
@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,out_h,out_w", PAIRED_RADIX_GEOMETRIES)
def test_paired_radix_entries_match_plain_on_gpu(cuda, karatsuba, b, f, n, bh, bw, kh, kw,
                                                 out_h, out_w):
    """Each radix body where v3 pairs: ``kernel_layout`` gives the pair (64
    rows, ``pair_bins`` bins a rank, half of W/2 for v5 and v5x; the peaks
    kernel writes 2 × ``radix_row_chunks`` entries a block), and every
    entry of the form at every tier of every body the plan's rules admit
    matches its plain version at the radix entries' bars, 6×TF32 also in
    float64; where the pair does not fit (the Karatsuba form at 6×TF32 on
    Wc 513) both heads raise and launch nothing."""
    geom = (bh, bw, kh, kw, out_h, out_w)
    wc, vh = bw // 2 + 1, bh - kh + 1
    for body in _radix_bodies(geom):
        paired = [s for s in tbc.TIERS if tbc.kernel_layout(body, wc, vh, s, karatsuba)[1]]
        assert paired == ([6] if bw == 512 else
                          [s for s in tbc.TIERS if not (karatsuba and s == 6)]), body
        for s in paired:
            half = tbc.pair_bins(wc, vh, s, karatsuba)
            assert tbc.kernel_layout(body, wc, vh, s, karatsuba) == (64, half) and half % 32 == 0
            assert body == "v4" or 2 * half == wc - 1
            assert tbc.peaks_chunks(wc, vh, s, karatsuba, body, bh) == 2 * sum(
                tbc.radix_chunks(bh, vh, 64))
            assert tbc.radix_fits(wc, vh, s, karatsuba)
    _check_radix_entries(cuda, b, f, n, geom, karatsuba)


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,out_h,out_w",
                         RADIX_GEOMETRIES[:1] + RADIX_GEOMETRIES[3:4] + PAIRED_RADIX_GEOMETRIES[:2])
def test_radix_peaks_planted_ties_on_gpu(cuda, b, f, n, bh, bw, kh, kw, out_h, out_w):
    """DC-only spectra make every block's window constant through every
    body (the twiddles and the DIF halves see zeros but for bin 0), so each
    block's pair must be its first position inside the output: the
    first-index rule survives pair chunks that hold rows from both halves
    of the window, DIF columns t' and t' + W/2 that are not adjacent, and
    the pair, whose ranks each write an entry (W 1024: v4 alone, and every
    body, whose DIF ranks each hold two stretches of columns)."""
    rng = np.random.default_rng(41)
    geom = (bh, bw, kh, kw, out_h, out_w)
    ops = [torch.zeros_like(x) for x in _planes(rng, cuda, b, f, n, *geom)]
    ops[0][..., 0, 0] = torch.as_tensor(
        rng.standard_normal(ops[0].shape[:4]).astype(np.float32), device=cuda)
    ops[2][..., 0, 0] = 1.0
    vh, vw = bh - kh + 1, bw - kw + 1
    for body, kara in itertools.product(_radix_bodies(geom), (False, True)):
        flags = dict(RADIX_BODIES[body], karatsuba=kara)
        got_v, got_i = tbc.block_conv_peaks(*ops, *geom, **flags)
        want_v, _ = tbc.block_conv_peaks_reference(*ops, *geom, **flags)
        torch.cuda.synchronize()
        assert _rel(got_v, want_v) <= TOL, body
        first = (torch.arange(got_i.shape[2], device=cuda)[:, None] * vh * out_w
                 + torch.arange(got_i.shape[3], device=cuda) * vw)
        assert torch.equal(got_i, first.to(torch.int32).expand_as(got_i)), body


@pytest.mark.gpu
def test_radix_flags_refused_on_gpu(cuda):
    """On the card an explicit radix flag raises where the JAX package's
    rules reject the plan, and where they admit it but the Hopper kernels
    stack blocks (Vh = 24 at Wc 129: radix_fits is False; v4 only, since no
    plan the DIF rule admits, W a multiple of 512, stacks); nothing runs v3
    in its place."""
    rng = np.random.default_rng(43)
    stacked = (32, 256, 9, 129, 40, 300)
    ops = _planes(rng, cuda, 1, 1, 2, *stacked)
    assert tbc.radix_h_legal(32, 24) and not tbc.radix_fits(129, 24)
    before = (tbc.block_conv.launches, tbc.block_conv_peaks.launches)
    for flags in (RADIX_BODIES["v4"], dict(radix_h=True, karatsuba=True)):
        with pytest.raises(ValueError, match="radix_fits"):
            tbc.block_conv(*ops, *stacked, **flags)
        with pytest.raises(ValueError, match="radix_fits"):
            tbc.block_conv_peaks(*ops, *stacked, **flags)
    illegal = (45, 151, 10, 24, 100, 300)
    ops = _planes(rng, cuda, 1, 1, 2, *illegal)
    with pytest.raises(ValueError, match="radix_h"):
        tbc.block_conv(*ops, *illegal, radix_h=True)
    with pytest.raises(ValueError, match="radix_w"):
        tbc.block_conv_peaks(*_planes(rng, cuda, 1, 1, 2, *RADIX_GEOMETRIES[4][3:]),
                             *RADIX_GEOMETRIES[4][3:], radix_w=True)
    assert (tbc.block_conv.launches, tbc.block_conv_peaks.launches) == before


# The other H-stage forms (ops/block_conv.py karatsuba, wstack): the
# Karatsuba H stage in v3's configurations (64 rows, paired and stacked)
# and v2 (v2_rows, v2_blocks: v3's configuration of the same form), at the
# small ragged shape, the headline plan, Wc 301 (the
# Karatsuba stage's 64 rows stop at Wc 288: a pair), Wc 451 (a pair), the
# 1024 block (where 6xTF32's Karatsuba stage does not fit),
# the F=8 and the DPM plans (stacked: 2 and 4 blocks a CTA).
FORM_GEOMETRIES = [GEOMETRIES[0], GEOMETRIES[1], GEOMETRIES[2], GEOMETRIES[3], GEOMETRIES[4],
                   GEOMETRIES[6], SHORT_WINDOWS[0]]
FORMS = {"_k": dict(karatsuba=True), "_v2": dict(wstack=False),
         "_v2_k": dict(wstack=False, karatsuba=True)}


def _fits(geom, splits, flags):
    bh, bw, kh = geom[:3]
    return tbc.form_taken(bw // 2 + 1, bh - kh + 1, splits, **flags)


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,out_h,out_w", FORM_GEOMETRIES)
def test_form_entries_match_plain_on_gpu(cuda, b, f, n, bh, bw, kh, kw, out_h, out_w):
    """Every Karatsuba and v2 entry (maps at f32 and bf16 maps; the
    Karatsuba peaks) at every tier against its plain version with the same
    flags, at the bars of the v3 entries (6×TF32 also within X6_TOL of the
    plain version in float64); each call counts one launch on its own mode.
    Where the kernels do not take a form (``form_taken``: its shared
    memory) it raises and launches nothing."""
    rng = np.random.default_rng(53)
    geom = (bh, bw, kh, kw, out_h, out_w)
    ops = _planes(rng, cuda, b, f, n, *geom)
    ops16 = tuple(x.to(torch.bfloat16) for x in ops)
    for suffix, flags in FORMS.items():
        for planes, tag, splits, tol in ((ops, "f32", 3, TOL), (ops, "f32", 6, TOL),
                                         (ops, "f32", 1, ONE_PASS_TOL),
                                         (ops16, "bf16", tbc.BF16IO, IO_TOL),
                                         (ops16, "bf16", 3, TOL)):
            tier = tbc.TIER_SUFFIX[splits]
            if not _fits(geom, splits, flags):
                before = tbc.block_conv.launches
                with pytest.raises(InvalidInputError, match="shared memory"):
                    tbc.block_conv(*planes, *geom, torch.float32, splits, **flags)
                assert tbc.block_conv.launches == before
                continue
            want = tbc.block_conv_reference(*planes, *geom, torch.float32, splits, **flags)
            for out_dtype, maps in ((torch.float32, ""), (torch.bfloat16, "_bf16maps")):
                mode = f"block_conv_{tag}{maps}{tier}{suffix}"
                before = tbc.block_conv.launches_by_mode[mode]
                got = tbc.block_conv(*planes, *geom, out_dtype, splits, **flags)
                torch.cuda.synchronize()
                assert tbc.block_conv.launches_by_mode[mode] == before + 1, mode
                assert got.dtype == out_dtype and got.shape == want.shape
                bar = tol if out_dtype == torch.float32 else max(tol, BF16_OUT_TOL)
                assert _rel(got.float(), want) <= bar, mode
                if out_dtype == torch.float32 and splits == tbc.BF16IO:
                    assert _rms(got, want) <= IO_RMS_TOL, mode
                if out_dtype == torch.float32 and splits == 6:
                    want64 = tbc.block_conv_reference(*(x.double() for x in ops), *geom,
                                                      torch.float64, **flags)
                    assert _rel(got.double(), want64) <= X6_TOL, mode
            if suffix != "_k":
                continue
            mode = f"block_conv_peaks_{tag}{tier}_k"
            before = tbc.block_conv_peaks.launches_by_mode[mode]
            got_v, got_i = tbc.block_conv_peaks(*planes, *geom, splits, radix_h=False, **flags)
            want_v, want_i = tbc.block_conv_peaks_reference(*planes, *geom, splits,
                                                            radix_h=False, **flags)
            torch.cuda.synchronize()
            assert tbc.block_conv_peaks.launches_by_mode[mode] == before + 1, mode
            assert _rel(got_v, want_v) <= tol, mode
            flips = got_i != want_i
            if flips.any():
                flat = want.reshape(b, n, -1)
                at = flat.gather(-1, got_i.reshape(b, n, -1).long()).reshape(got_i.shape)
                assert (at[flips] >= want_v[flips] - tol * want_v.abs().max()).all(), mode


# The v2 body's configurations (ops/block_conv.py v2_blocks,
# kernel_layout('v2'): v3's of the same form): v3's stacks — the DPM
# plan's blocks (Vh 16, 4 blocks, 2 kernels) over 13 block rows, Vh 21 (3
# blocks), the F=8 plan (Vh 32, 2 blocks, 1 kernel), Vh 1, narrow blocks
# (Vh 16 at Wc 17 over 20 block rows; Vh 8 at Wc 40 over 13) — and the
# one-block configurations: 64 rows (the headline's blocks), the pair (Wc
# 451), and at Wc 545 the pair at 3xTF32 and 32 rows at 6xTF32.
V2_GEOMETRIES = [
    (1, 3, 3, 27, 139, 12, 12, 208, 300),
    (1, 2, 3, 27, 32, 12, 12, 344, 60),
    (1, 3, 3, 20, 78, 13, 12, 100, 200),
    (2, 3, 3, 45, 151, 25, 24, 140, 300),
    (1, 8, 5, 63, 287, 32, 32, 200, 700),
    (1, 2, 3, 17, 151, 17, 24, 10, 300),
    (1, 1, 3, 127, 447, 64, 64, 600, 900),
    (1, 2, 2, 40, 901, 9, 101, 150, 1700),
    (1, 1, 2, 100, 1088, 37, 129, 128, 960),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,out_h,out_w", V2_GEOMETRIES)
def test_v2_configurations_match_plain_on_gpu(cuda, b, f, n, bh, bw, kh, kw, out_h, out_w):
    """Every v2 entry (both forms, maps at f32 and bf16 maps, every tier)
    in each of its configurations against its plain version at the bars of
    the v3 entries (6×TF32 also within X6_TOL of the plain version in
    float64, BF16IO within IO_RMS_TOL rms), one launch on its mode each;
    its maps are bitwise v3's entry of the same form (the same kernel), and
    where v3's form is refused so is v2's."""
    rng = np.random.default_rng(61)
    geom = (bh, bw, kh, kw, out_h, out_w)
    vh, wc = bh - kh + 1, bw // 2 + 1
    ops = _planes(rng, cuda, b, f, n, *geom)
    ops16 = tuple(x.to(torch.bfloat16) for x in ops)
    nbh = ops[0].shape[1]
    for kara in (False, True):
        suffix = tbc.body_suffix("v2", kara)
        flags = dict(wstack=False, karatsuba=kara)
        for planes, tag, splits, tol in ((ops, "f32", 3, TOL), (ops, "f32", 6, TOL),
                                         (ops, "f32", 1, ONE_PASS_TOL),
                                         (ops16, "bf16", tbc.BF16IO, IO_TOL),
                                         (ops16, "bf16", 3, TOL)):
            tier = tbc.TIER_SUFFIX[splits]
            assert tbc.v2_blocks(wc, vh, splits, kara) == tbc.blocks_per_cta(wc, vh, splits)
            if not tbc.form_taken(wc, vh, splits, False, kara):
                assert not tbc.form_taken(wc, vh, splits, True, kara)
                with pytest.raises(InvalidInputError, match="shared memory"):
                    tbc.block_conv(*planes, *geom, torch.float32, splits, **flags)
                continue
            want = tbc.block_conv_reference(*planes, *geom, torch.float32, splits, **flags)
            for out_dtype, maps in ((torch.float32, ""), (torch.bfloat16, "_bf16maps")):
                mode = f"block_conv_{tag}{maps}{tier}{suffix}"
                before = tbc.block_conv.launches_by_mode[mode]
                got = tbc.block_conv(*planes, *geom, out_dtype, splits, **flags)
                torch.cuda.synchronize()
                assert tbc.block_conv.launches_by_mode[mode] == before + 1, mode
                assert got.dtype == out_dtype and got.shape == want.shape
                bar = tol if out_dtype == torch.float32 else max(tol, BF16_OUT_TOL)
                assert _rel(got.float(), want) <= bar, (mode, nbh)
                if out_dtype == torch.float32 and splits == tbc.BF16IO:
                    assert _rms(got, want) <= IO_RMS_TOL, mode
                if out_dtype == torch.float32 and splits == 6:
                    want64 = tbc.block_conv_reference(*(x.double() for x in ops), *geom,
                                                      torch.float64, **flags)
                    assert _rel(got.double(), want64) <= X6_TOL, mode
                v3 = tbc.block_conv(*planes, *geom, out_dtype, splits, karatsuba=kara)
                assert torch.equal(got, v3), mode


@pytest.mark.gpu
def test_form_flags_and_defaults_on_gpu(cuda):
    """On the card the form flags keep JAX's rules (a radix body does not
    take wstack=False: it raises, launching nothing; it takes
    karatsuba=True, and so does the peaks auto rule's v4: the ``_k``
    entries), and a call with neither flag set launches the entry it
    launched before them (no suffix), bitwise equal to karatsuba=False."""
    rng = np.random.default_rng(59)
    radix = (256, 512, 65, 129, 400, 800)
    ops = _planes(rng, cuda, 1, 1, 2, *radix)
    before = (tbc.block_conv.launches, tbc.block_conv_peaks.launches)
    with pytest.raises(InvalidInputError, match="wstack"):
        tbc.block_conv(*ops, *radix, radix_h=True, wstack=False)
    assert (tbc.block_conv.launches, tbc.block_conv_peaks.launches) == before
    tbc.reset_launches(tbc.block_conv, tbc.block_conv_peaks)
    tbc.block_conv(*ops, *radix, radix_w=True, karatsuba=True)
    tbc.block_conv_peaks(*ops, *radix, karatsuba=True)  # the auto rule's v4
    torch.cuda.synchronize()
    assert dict(tbc.block_conv.launches_by_mode) == {"block_conv_f32_r5_k": 1}
    assert dict(tbc.block_conv_peaks.launches_by_mode) == {"block_conv_peaks_f32_r4_k": 1}
    for geom in (GEOMETRIES[0], GEOMETRIES[1], SHORT_WINDOWS[0]):
        ops = _planes(rng, cuda, *geom)
        tbc.reset_launches(tbc.block_conv, tbc.block_conv_peaks)
        got = tbc.block_conv(*ops, *geom[3:])
        same = tbc.block_conv(*ops, *geom[3:], karatsuba=False, wstack=True)
        tbc.block_conv_peaks(*ops, *geom[3:], radix_h=False)
        torch.cuda.synchronize()
        assert torch.equal(got, same)
        assert dict(tbc.block_conv.launches_by_mode) == {"block_conv_f32": 2}
        assert dict(tbc.block_conv_peaks.launches_by_mode) == {"block_conv_peaks_f32": 1}
