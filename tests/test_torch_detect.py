"""The port's detection path against the JAX package: the peaks kernel's
plain version against ``block_conv_peaks_pallas`` (interpret mode, one block
per cell, and cells of mbh × mbw blocks), the tiled reductions against
their JAX twins, and the detection heads against
``cuda_fft_convolution_tpu.models.detect``.

Tolerances: values within 1e-5 relative to the largest |value| (the repo's
fp32 bar); positions and indices exactly equal (random continuous data has
no near-ties at these sizes; the tie rules are tested on integer maps,
where both sides compute exactly). The CUDA kernel itself is held to the
plain version on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_fft_convolution_torch as tfc
import cuda_fft_convolution_tpu as jfc
from cuda_fft_convolution_torch.models import (
    detect_local_peaks,
    detect_peaks,
    detect_top_k,
    hog_features,
)
from cuda_fft_convolution_torch.ops import block_conv as tbc
from cuda_fft_convolution_torch.ops import tiled as tt
from cuda_fft_convolution_tpu.models import detect_local_peaks as j_local_peaks
from cuda_fft_convolution_tpu.models import detect_peaks as j_peaks
from cuda_fft_convolution_tpu.models import detect_top_k as j_top_k
from cuda_fft_convolution_tpu.ops import tiled as jt
from cuda_fft_convolution_tpu.ops.block_conv import (
    block_conv_peaks_pallas,
    radix_h_legal,
    radix_w_legal,
)

TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _operands(rng, b, f, n, bh, bw, kh, kw, out_h, out_w, extra=0):
    """Block spectra of random data with a baked 'same' window (JAX
    fft_data_blocks) and random bank spectra, as numpy f32 planes;
    ``extra`` block rows/cols past the output are appended (cells with no
    position inside the output)."""
    data = rng.standard_normal((b, f, out_h, out_w)).astype(np.float32)
    d_re, d_im = jt.fft_data_blocks(
        jnp.asarray(data), bh, bw, kh, kw, origin_h=(kh - 1) // 2,
        origin_w=(kw - 1) // 2, win_h=out_h, win_w=out_w,
    )
    pad = ((0, 0), (0, extra), (0, extra), (0, 0), (0, 0), (0, 0))
    d_re, d_im = np.pad(np.array(d_re), pad), np.pad(np.array(d_im), pad)
    wc = bw // 2 + 1
    k_re = rng.standard_normal((n, f, bh, wc)).astype(np.float32)
    k_im = rng.standard_normal((n, f, bh, wc)).astype(np.float32)
    return d_re, d_im, k_re, k_im


def _torch(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def _jax_pyramid(ops, geom, radix_h=False, **variant):
    vals, idxs = block_conv_peaks_pallas(
        *map(jnp.asarray, ops), *geom, interpret=True, mbh=1, mbw=1,
        radix_h=radix_h, **variant,
    )
    return np.asarray(vals), np.asarray(idxs)


@pytest.mark.parametrize(
    "b,f,n,bh,bw,kh,kw,out_h,out_w,extra",
    [
        # odd blocks; out not a multiple of the valid window (clipped cells)
        (2, 3, 4, 45, 151, 10, 24, 100, 300, 0),
        # dense-DFT plan of 300×500 with 17×33 kernels: V = (16, 256)
        (2, 3, 3, 32, 288, 17, 33, 100, 300, 0),
        # F=1, full-height window
        (1, 1, 3, 64, 256, 1, 1, 130, 270, 0),
        # blocks past the output: cells with no position inside it
        (2, 3, 2, 40, 160, 9, 33, 70, 200, 1),
    ],
)
def test_block_conv_peaks_reference_matches_jax_v3(rng, b, f, n, bh, bw, kh, kw,
                                                   out_h, out_w, extra):
    ops = _operands(rng, b, f, n, bh, bw, kh, kw, out_h, out_w, extra)
    geom = (bh, bw, kh, kw, out_h, out_w)
    want_v, want_i = _jax_pyramid(ops, geom)
    got_v, got_i = tbc.block_conv_peaks_reference(*_torch(*ops), *geom)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    assert tuple(got_v.shape) == want_v.shape == got_i.shape
    fin = np.isfinite(want_v)
    assert np.array_equal(np.isfinite(got_v.numpy()), fin)
    assert fin.all() == (extra == 0)
    assert _rel(got_v.numpy()[fin], want_v[fin]) <= TOL
    assert np.array_equal(got_i.numpy(), want_i)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = tbc.block_conv_peaks.launches
    wv, wi = tbc.block_conv_peaks(*_torch(*ops), *geom)
    assert tbc.block_conv_peaks.launches == before
    assert torch.equal(wv, got_v) and torch.equal(wi, got_i)


def test_block_conv_peaks_reference_matches_jax_v4(rng):
    """The v4 body (radix-2 H stage) of the JAX peaks kernel at a
    radix-legal geometry: the port reproduces it too."""
    bh, bw, kh, kw, out_h, out_w = 256, 512, 65, 129, 300, 700
    assert radix_h_legal(bh, bh - kh + 1)
    ops = _operands(rng, 1, 2, 3, bh, bw, kh, kw, out_h, out_w)
    geom = (bh, bw, kh, kw, out_h, out_w)
    want_v, want_i = _jax_pyramid(ops, geom, radix_h=True)
    got_v, got_i = tbc.block_conv_peaks_reference(*_torch(*ops), *geom)
    assert _rel(got_v.numpy(), want_v) <= TOL
    assert np.array_equal(got_i.numpy(), want_i)


@pytest.mark.parametrize("xsliver", [False, True], ids=["v5", "v5x"])
def test_block_conv_peaks_reference_matches_jax_v5(rng, xsliver):
    """The v5 peaks body (``radix_w=True``: radix-2 H stage, radix-2 DIF W
    stage, per-segment reduction) and the v5x one (``xsliver=True``: the
    Nyquist sliver synthesized outside) at a geometry both radix rules
    admit (blocks 32 × 512, Vh 24, Vw 384): the port's plain version gives
    the same pyramid."""
    bh, bw, kh, kw, out_h, out_w = geom = (32, 512, 9, 129, 40, 500)
    assert radix_h_legal(bh, bh - kh + 1) and radix_w_legal(bw, kw, bw - kw + 1)
    ops = _operands(rng, 1, 1, 2, bh, bw, kh, kw, out_h, out_w)
    want_v, want_i = _jax_pyramid(ops, geom, radix_h=True, radix_w=True, xsliver=xsliver)
    got_v, got_i = tbc.block_conv_peaks_reference(*_torch(*ops), *geom)
    assert tuple(got_v.shape) == want_v.shape
    assert _rel(got_v.numpy(), want_v) <= TOL
    assert np.array_equal(got_i.numpy(), want_i)


RADIX_BODIES = {"v4": dict(radix_h=True), "v5": dict(radix_w=True),
                "v5x": dict(radix_w=True, xsliver=True)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("body", list(RADIX_BODIES))
@pytest.mark.parametrize("geom", [(32, 512, 9, 129, 40, 500), (256, 512, 65, 129, 300, 500)],
                         ids=["radix_geom", "jax_plan"])
def test_radix_peaks_plain_matches_jax(rng, geom, body, dtype):
    """Each radix body's peaks plain version (the wrapper on CPU tensors,
    explicit flags) against ``block_conv_peaks_pallas`` with the same
    flags, N=2: values within 1e-5 at float32 and the bf16 tier's 2e-2 at
    bf16 spectra (BF16IO on both sides); indices equal."""
    ops = _operands(rng, 1, 1, 2, *geom)
    jops = [np.asarray(jnp.asarray(x).astype(dtype)) for x in ops]
    want_v, want_i = _jax_pyramid(jops, geom, **RADIX_BODIES[body])
    tops = [torch.as_tensor(x).to(getattr(torch, dtype)) for x in ops]
    got_v, got_i = tbc.block_conv_peaks(*tops, *geom, **RADIX_BODIES[body])
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    assert tuple(got_v.shape) == want_v.shape
    assert _rel(got_v.numpy(), want_v) <= (TOL if dtype == "float32" else 2e-2)
    assert np.array_equal(got_i.numpy(), want_i)


def test_cell_peaks_tie_rule():
    """Equal values: the smallest flat index wins inside a cell; positions
    past the maps never win."""
    maps = torch.zeros((1, 1, 5, 7))
    maps[0, 0, 1, 4] = maps[0, 0, 3, 2] = 2.0  # tie inside cell (0, 0)
    maps[0, 0, 4, 6] = -1.0  # cell (1, 1) is all zeros but this
    vals, idxs = tbc.cell_peaks(maps, 2, 2, 4, 5)
    assert vals.tolist() == [[[[2.0, 0.0], [0.0, 0.0]]]]
    assert idxs.tolist() == [[[[1 * 7 + 4, 5], [4 * 7, 4 * 7 + 5]]]]


def _integer_maps(rng, shape):
    """Maps with many exact ties, where every implementation computes the
    same values."""
    return rng.integers(0, 6, shape).astype(np.float32)


@pytest.mark.parametrize("k", [1, 5, 17])
def test_peaks_and_top_k_from_maps_tie_order(rng, k):
    maps = _integer_maps(rng, (2, 3, 9, 11))
    v, y, x = tt.peaks_from_maps(torch.as_tensor(maps))
    jv, jy, jx = jt.peaks_from_maps(jnp.asarray(maps))
    assert np.array_equal(v.numpy(), jv) and np.array_equal(y.numpy(), jy)
    assert np.array_equal(x.numpy(), jx) and y.dtype == torch.int32
    v, y, x = tt.top_k_from_maps(torch.as_tensor(maps), k)
    jv, jy, jx = jt.top_k_from_maps(jnp.asarray(maps), k)
    assert np.array_equal(v.numpy(), jv)
    assert np.array_equal(y.numpy(), jy) and np.array_equal(x.numpy(), jx)


@pytest.mark.parametrize("threshold", [None, 0.5])
@pytest.mark.parametrize("window", [3, 4, 5])
def test_local_peaks_from_maps_matches_jax(rng, window, threshold):
    """Window 4 pads 'SAME' asymmetrically (1 before, 2 after); k=60 leaves
    empty slots (−inf, (−1, −1)) at every window."""
    maps = rng.standard_normal((2, 3, 20, 23)).astype(np.float32)
    maps[0, 0, -1, -1] = 9.0  # a maximum in the bottom-right corner
    v, y, x = tt.local_peaks_from_maps(torch.as_tensor(maps), 60, window, threshold)
    jv, jy, jx = jt.local_peaks_from_maps(jnp.asarray(maps), 60, window, threshold)
    assert np.array_equal(v.numpy(), jv)
    assert np.array_equal(y.numpy(), jy) and np.array_equal(x.numpy(), jx)
    assert np.isinf(jv).any() and (np.asarray(jy) == -1).any()
    # plateaus (integer maps) mark every plateau pixel, on both sides
    ints = _integer_maps(rng, (1, 2, 12, 13))
    v, y, x = tt.local_peaks_from_maps(torch.as_tensor(ints), 40, window)
    jv, jy, jx = jt.local_peaks_from_maps(jnp.asarray(ints), 40, window)
    assert np.array_equal(v.numpy(), jv)
    assert np.array_equal(y.numpy(), jy) and np.array_equal(x.numpy(), jx)


def _spectra_case(rng):
    """Block spectra (B=2, F=3) at blocks (45, 151) for 10×24 kernels with a
    clipped edge, and a random bank's spectra."""
    return _operands(rng, 2, 3, 4, 45, 151, 10, 24, 100, 300), (
        45, 151, 10, 24, 100, 300)


@pytest.mark.parametrize("fused", [None, False])
def test_conv_blocks_peaks_matches_jax(rng, fused):
    """The port's fused branch (the peaks kernel's plain version on the
    CPU) and its unfused branch against JAX (unfused off-TPU)."""
    ops, geom = _spectra_case(rng)
    jv, jy, jx = jt.conv_blocks_peaks(*map(jnp.asarray, ops), *geom)
    tfc.set_config(use_fused_block_conv=fused)
    try:
        v, y, x = tt.conv_blocks_peaks(*_torch(*ops), *geom)
    finally:
        tfc.set_config(use_fused_block_conv=None)
    assert v.shape == (2, 4)
    assert _rel(v.numpy(), jv) <= TOL
    assert np.array_equal(y.numpy(), jy) and np.array_equal(x.numpy(), jx)


def test_conv_blocks_top_k_matches_jax_unfused(rng):
    ops, geom = _spectra_case(rng)
    tfc.set_config(use_fused_block_conv=False)
    jfc.set_config(use_fused_block_conv=False)
    try:
        v, y, x = tt.conv_blocks_top_k(*_torch(*ops), *geom, 6)
        jv, jy, jx = jt.conv_blocks_top_k(*map(jnp.asarray, ops), *geom, 6)
    finally:
        tfc.set_config(use_fused_block_conv=None)
        jfc.set_config(use_fused_block_conv=None)
    assert _rel(v.numpy(), jv) <= TOL
    assert np.array_equal(y.numpy(), jy) and np.array_equal(x.numpy(), jx)


def test_conv_blocks_top_k_fused_is_top_k_of_cells(rng):
    """The fused branch's candidates are one-block cell maxima: the JAX
    pyramid at mbh = mbw = 1, then a numpy top-k over cells (values
    descending, ties by cell order)."""
    ops, geom = _spectra_case(rng)
    out_w = geom[-1]
    vals, idxs = _jax_pyramid(ops, geom)
    cells_v, cells_i = vals.reshape(2, 4, -1), idxs.reshape(2, 4, -1)
    order = np.argsort(-cells_v, axis=-1, kind="stable")[..., :5]
    want_v = np.take_along_axis(cells_v, order, -1)
    want_i = np.take_along_axis(cells_i, order, -1)
    v, y, x = tt.conv_blocks_top_k(*_torch(*ops), *geom, 5)
    assert _rel(v.numpy(), want_v) <= TOL
    assert np.array_equal(y.numpy(), want_i // out_w)
    assert np.array_equal(x.numpy(), want_i % out_w)
    # k beyond the 9 cells: the exact reduction of the maps
    v, y, x = tt.conv_blocks_top_k(*_torch(*ops), *geom, 12)
    jv, jy, jx = jt.conv_blocks_top_k(*map(jnp.asarray, ops), *geom, 12)
    assert np.array_equal(y.numpy(), jy) and np.array_equal(x.numpy(), jx)


@pytest.fixture
def detect_case(rng):
    data = rng.standard_normal((60, 70, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 5, 7, 2)).astype(np.float32)
    return data, bank


def _same(got, want):
    (gv, gp), (wv, wp) = got, want
    assert gp.dtype == torch.int32 and tuple(gp.shape) == np.shape(wp)
    assert np.array_equal(gp.numpy(), np.asarray(wp))
    fin = np.isfinite(np.asarray(wv))
    assert np.array_equal(np.isfinite(gv.numpy()), fin)
    assert _rel(gv.numpy()[fin], np.asarray(wv)[fin]) <= TOL


@pytest.mark.parametrize("algorithm", ["direct", "tiled"])
@pytest.mark.parametrize("mode", ["same", "valid", "full"])
def test_detect_heads_match_jax(detect_case, mode, algorithm):
    """detect_peaks on the default dispatch (the port's fused branch runs
    on the CPU too); detect_top_k with the unfused branch on both sides,
    where both are exact; detect_local_peaks."""
    data, bank = detect_case
    kw = dict(mode=mode, algorithm=algorithm)
    _same(detect_peaks(data, bank, **kw, device="cpu"), j_peaks(data, bank, **kw))
    tfc.set_config(use_fused_block_conv=False)
    jfc.set_config(use_fused_block_conv=False)
    try:
        _same(detect_top_k(data, bank, 4, **kw, device="cpu"), j_top_k(data, bank, 4, **kw))
    finally:
        tfc.set_config(use_fused_block_conv=None)
        jfc.set_config(use_fused_block_conv=None)
    _same(detect_local_peaks(data, bank, 6, window=4, **kw, device="cpu"),
          j_local_peaks(data, bank, 6, window=4, **kw))


def test_detect_heads_on_spectral_inputs(rng):
    """SpectralData (direct engine), TiledSpectralData with a baked window
    and without one, and SpectralKernels banks (which carry their flip),
    batched and unbatched — against the JAX heads on the same spectra."""
    data = rng.standard_normal((2, 48, 56, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 7, 5, 2)).astype(np.float32)
    # direct spectra, raw bank, batched
    _same(detect_peaks(tfc.fft_data(data, 7, 5, device="cpu"), bank, mode="full", device="cpu"),
          j_peaks(jfc.fft_data(data, 7, 5), bank, mode="full"))
    # direct spectra with a precomputed bank: correlation is baked in
    sd, jsd = tfc.fft_data(data[0], 7, 5, device="cpu"), jfc.fft_data(data[0], 7, 5)
    sk = tfc.fft_kernels(bank, spectral=sd, correlation=True)
    jsk = jfc.fft_kernels(bank, spectral=jsd, correlation=True, storage="planar")
    _same(detect_peaks(sd, sk, correlation=False, device="cpu"),
          j_peaks(jsd, jsk, correlation=False))
    _same(detect_top_k(sd, sk, 3, correlation=False, mode="valid", device="cpu"),
          j_top_k(jsd, jsk, 3, correlation=False, mode="valid"))
    # tiled spectra with a baked 'same' window, raw bank and SpectralKernels
    td = tfc.fft_data_tiled(data, 7, 5, trim_mode="same", device="cpu")
    jtd = jfc.fft_data_tiled(data, 7, 5, trim_mode="same")
    _same(detect_peaks(td, bank, device="cpu"), j_peaks(jtd, bank))
    tk = tfc.fft_kernels(bank, spectral=td, correlation=True)
    jtk = jfc.fft_kernels(bank, spectral=jtd, correlation=True, storage="planar")
    _same(detect_peaks(td, tk, device="cpu"), j_peaks(jtd, jtk))
    _same(detect_local_peaks(td, tk, 5, device="cpu"), j_local_peaks(jtd, jtk, 5))
    # tiled spectra with no baked window serve mode='full' only
    tf, jtf = tfc.fft_data_tiled(data, 9, 9, device="cpu"), jfc.fft_data_tiled(data, 9, 9)
    _same(detect_peaks(tf, bank, mode="full", device="cpu"), j_peaks(jtf, bank, mode="full"))
    with pytest.raises(tfc.InvalidInputError, match="baked window"):
        detect_peaks(tf, bank, mode="same", device="cpu")


def test_detect_top_k_fused_planted_cells(rng):
    """Fused dispatch: candidates are one-block cell maxima, so templates
    planted in distinct blocks are all recovered, k=1 equals detect_peaks,
    and k beyond the cell count is the exact top-k of the maps."""
    templ = rng.standard_normal((5, 9, 1)).astype(np.float32)
    data = 0.05 * rng.standard_normal((96, 600, 1)).astype(np.float32)
    # blocks (36, 256), valid windows (32, 128): the centres (12, 44),
    # (52, 564) and (72, 154) lie in cells (0, 0), (1, 4) and (2, 1)
    plants = [(10, 40), (50, 560), (70, 150)]
    for y0, x0 in plants:
        data[y0 : y0 + 5, x0 : x0 + 9] += 3.0 * templ
    sd = tfc.fft_data_tiled(data, 5, 129, block_h=36, block_w=256,
                            trim_mode="same", trim_kernel_h=5, trim_kernel_w=9, device="cpu")
    vals, pos = detect_top_k(sd, templ[None], k=3, device="cpu")
    pv, pp = detect_peaks(sd, templ[None], device="cpu")
    assert vals.shape == (1, 3) and pos.shape == (1, 3, 2)
    assert {tuple(p) for p in pos[0].tolist()} == {(y0 + 2, x0 + 4) for y0, x0 in plants}
    assert bool((vals[0, :-1] >= vals[0, 1:]).all())
    assert pos[0, 0].tolist() == pp[0].tolist() and vals[0, 0] == pv[0]
    maps = jfc.conv_spectral(
        jfc.fft_data_tiled(data, 5, 129, block_h=36, block_w=256, trim_mode="same",
                           trim_kernel_h=5, trim_kernel_w=9),
        templ[None], mode="same", correlation=True,
    )
    jv, jy, jx = jt.top_k_from_maps(jnp.asarray(maps)[None], 40)  # > 15 cells
    bv, bp = detect_top_k(sd, templ[None], k=40, device="cpu")
    assert np.array_equal(bp[0, :, 0].numpy(), jy[0, 0])
    assert np.array_equal(bp[0, :, 1].numpy(), jx[0, 0])


def test_fused_top_k_cells_against_jax_grouped_cells(rng, monkeypatch):
    """Cells of several blocks (ROADMAP queue 2 item 7): JAX's
    ``conv_blocks_top_k``, forced onto its fused branch and run through
    ``block_conv_peaks_pallas`` in interpret mode at mbh = mbw = 2, and the
    port's, through ``block_conv_peaks`` at the same group, give the same
    top-k: equal positions, values within TOL. The cells of 2×2 blocks are
    ragged here (3×5 blocks). Two plants in one cell but in two blocks:
    both sides return one of them and a cell's noise maximum; the port's
    default, one block per cell, returns all three plants."""
    from cuda_fft_convolution_tpu.ops import block_conv as jbc

    templ = rng.standard_normal((5, 9, 1)).astype(np.float32)
    data = 0.05 * rng.standard_normal((96, 600, 1)).astype(np.float32)
    # blocks (36, 256), valid windows (32, 128): the centres (12, 44) and
    # (52, 184) lie in blocks (0, 0) and (1, 1), one cell (0, 0) of 2×2
    # blocks; the centre (72, 404) in block (2, 3), cell (1, 1)
    plants = [(10, 40), (50, 180), (70, 400)]
    for y0, x0 in plants:
        data[y0 : y0 + 5, x0 : x0 + 9] += 3.0 * templ
    kw = dict(block_h=36, block_w=256, trim_mode="same", trim_kernel_h=5, trim_kernel_w=9)
    sd = tfc.fft_data_tiled(data, 5, 129, **kw, device="cpu")
    jsd = jfc.fft_data_tiled(data, 5, 129, **kw)
    sk = tfc.fft_kernels(templ[None], spectral=sd, correlation=True)
    jsk = jfc.fft_kernels(templ[None], spectral=jsd, correlation=True)
    geom = (36, 256, 5, 129, 96, 600)
    assert sd.re.shape[:2] == (3, 5)
    grouped = []

    def pallas_2x2(*args, **kwargs):
        grouped.append(kwargs["interpret"])
        return block_conv_peaks_pallas(*args, **{**kwargs, "mbh": 2, "mbw": 2})

    monkeypatch.setattr(jbc, "block_conv_peaks_pallas", pallas_2x2)
    jfc.set_config(use_fused_block_conv=True)
    try:
        jv, jy, jx = jt.conv_blocks_top_k(jsd.re[None], jsd.im[None], jsk.re, jsk.im, *geom, 3)
    finally:
        jfc.set_config(use_fused_block_conv=None)
    assert grouped == [True]  # the kernel function ran, in interpret mode
    one_block = tt.conv_blocks_top_k(sd.re[None], sd.im[None], sk.re, sk.im, *geom, 3)
    real = tt.block_conv_peaks
    monkeypatch.setattr(tt, "block_conv_peaks",
                        lambda *a, **k: real(*a, **{**k, "mbh": 2, "mbw": 2}))
    v, y, x = tt.conv_blocks_top_k(sd.re[None], sd.im[None], sk.re, sk.im, *geom, 3)
    jv, jy, jx = (np.asarray(a)[0, 0] for a in (jv, jy, jx))
    v, y, x = (a[0, 0].numpy() for a in (v, y, x))
    assert np.array_equal(y, jy) and np.array_equal(x, jx)
    assert np.abs(v - jv).max() <= TOL * np.abs(jv).max()
    centres = {(y0 + 2, x0 + 4) for y0, x0 in plants}
    theirs = set(zip(jy.tolist(), jx.tolist()))
    assert len(centres & theirs) == 2 and len({(12, 44), (52, 184)} & theirs) == 1
    ours = set(zip(one_block[1][0, 0].tolist(), one_block[2][0, 0].tolist()))
    assert ours == centres


@pytest.mark.parametrize("mbh,mbw", [(2, 2), (3, 2), (1, 3), (2, 1), (4, 5)])
def test_block_conv_peaks_cells_match_jax(rng, mbh, mbw):
    """``block_conv_peaks(..., mbh, mbw)`` = JAX's ``block_conv_peaks_pallas``
    at the same group, indices included: 5×4 blocks (ragged groups: the
    last cells padded), one block row and column past the output (cells
    with no position inside it, whose pairs are −inf at their first
    position), and a group larger than the grid (cut to it)."""
    b, f, n, bh, bw, kh, kw, out_h, out_w = 2, 2, 3, 40, 160, 9, 33, 100, 350
    ops = _operands(rng, b, f, n, bh, bw, kh, kw, out_h, out_w, extra=1)
    assert ops[0].shape[1:3] == (5, 4)
    geom = (bh, bw, kh, kw, out_h, out_w)
    jv, ji = block_conv_peaks_pallas(*map(jnp.asarray, ops), *geom, interpret=True,
                                     mbh=mbh, mbw=mbw, radix_h=False)
    jv, ji = np.asarray(jv), np.asarray(ji)
    gv, gi = tbc.block_conv_peaks(*_torch(*ops), *geom, mbh=mbh, mbw=mbw)
    rv, ri = tbc.block_conv_peaks_reference(*_torch(*ops), *geom, mbh=mbh, mbw=mbw)
    assert torch.equal(gv, rv) and torch.equal(gi, ri)
    assert tuple(gv.shape) == jv.shape == (b, n, -(-5 // min(mbh, 5)), -(-4 // min(mbw, 4)))
    fin = np.isfinite(jv)
    assert np.array_equal(np.isfinite(gv.numpy()), fin)
    assert _rel(gv.numpy()[fin], jv[fin]) <= TOL
    assert np.array_equal(gi.numpy(), ji)


def test_group_cells_tie_rule():
    """Inside a column of blocks the smallest flat index wins a tie; across
    a cell's columns a later column wins only when strictly greater; blocks
    past the grid never win."""
    vals = torch.tensor([[[[1.0, 3.0, 2.0], [3.0, 0.0, 5.0], [4.0, 4.0, 1.0]]]])
    idxs = torch.tensor([[[[0, 1, 2], [3, 4, 5], [6, 7, 8]]]], dtype=torch.int32)
    v, i = tbc.group_cells(vals, idxs, 2, 2)
    assert v.tolist() == [[[[3.0, 5.0], [4.0, 1.0]]]]
    assert i.tolist() == [[[[3, 5], [6, 8]]]]
    v1, i1 = tbc.group_cells(vals, idxs, None, 1)
    assert torch.equal(v1, vals) and torch.equal(i1, idxs)
    vals[0, 0, 1, 0] = 1.0  # column 0 ties at 1: index 0 beats 3
    assert tbc.group_cells(vals, idxs, 2, 2)[1][0, 0, 0, 0] == 1  # column 1's 3 > 1


def test_detect_heads_ragged_and_not_ported(rng):
    data = rng.standard_normal((60, 60, 1)).astype(np.float32)
    # one pow-2 envelope: the ragged 'same' route runs without bucketing
    ragged = [rng.standard_normal((9, 13, 1)).astype(np.float32),
              rng.standard_normal((12, 10, 1)).astype(np.float32)]
    _same(detect_peaks(data, ragged, device="cpu"), j_peaks(data, ragged))
    _same(detect_local_peaks(data, ragged, 4, device="cpu"), j_local_peaks(data, ragged, 4))
    with pytest.raises(tfc.InvalidInputError, match="mode='same'"):
        detect_top_k(data, ragged, mode="valid", device="cpu")
    # envelopes that need bucketing (ROADMAP queue 1 item 5, ported): the
    # cell array is bucketed, each bucket at its own plan, as in JAX
    spans = [rng.standard_normal((3, 3, 1)).astype(np.float32),
             rng.standard_normal((20, 20, 1)).astype(np.float32),
             rng.standard_normal((5, 4, 1)).astype(np.float32)]
    _same(detect_peaks(data, spans, device="cpu"), j_peaks(data, spans))
    _same(detect_top_k(data, spans, 3, device="cpu"), j_top_k(data, spans, 3))
    _same(detect_local_peaks(data, spans, 4, device="cpu"), j_local_peaks(data, spans, 4))
    bank = rng.standard_normal((2, 5, 5, 1)).astype(np.float32)
    # the bf16 tier and bf16 maps (queue 1 item 6) are ported: the heads run
    # them, at the positions of the JAX heads (tests/test_torch_bf16.py
    # holds the values)
    assert np.array_equal(
        detect_peaks(data, bank, store_dtype="bfloat16", device="cpu")[1].numpy(),
        j_peaks(data, bank, store_dtype="bfloat16")[1])
    assert np.array_equal(
        detect_local_peaks(data, bank, out_dtype="bfloat16", device="cpu")[1].numpy(),
        j_local_peaks(data, bank, out_dtype="bfloat16")[1])
    with pytest.raises(tfc.InvalidInputError):
        detect_peaks(data, bank, mode="fftmap", device="cpu")
    with pytest.raises(tfc.InvalidInputError):
        detect_top_k(data, bank, k=0, device="cpu")
    with pytest.raises(tfc.InvalidInputError):
        detect_local_peaks(data, bank, window=1, device="cpu")


def test_detect_peaks_on_jax_checkpoint(tmp_path, rng):
    """Block spectra and a correlation bank saved by the JAX package load
    into the port (utils/checkpoint.py) and give the JAX heads' peaks."""
    data = rng.standard_normal((130, 170, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 9, 13, 2)).astype(np.float32)
    jsd = jfc.fft_data_tiled(data, 9, 13, trim_mode="same")
    jsk = jfc.fft_kernels(bank, spectral=jsd, correlation=True, storage="planar")
    jfc.save_spectral(str(tmp_path / "d.npz"), jsd)
    jfc.save_spectral(str(tmp_path / "k.npz"), jsk)
    sd = tfc.load_spectral(str(tmp_path / "d.npz"), device="cpu")
    sk = tfc.load_spectral(str(tmp_path / "k.npz"), device="cpu")
    assert isinstance(sk, tfc.SpectralKernels) and sk.kernel_hs == (9, 9, 9)
    _same(detect_peaks(sd, sk, device="cpu"), j_peaks(jsd, jsk))
    v1, p1 = detect_top_k(sd, sk, 1, device="cpu")
    _same((v1[:, 0], p1[:, 0]), j_peaks(jsd, jsk))


_HEADS = {
    "detect_peaks": lambda data, bank, **kw: detect_peaks(data, bank, **kw)[0],
    "detect_top_k": lambda data, bank, **kw: detect_top_k(data, bank, 3, **kw)[0],
    "detect_local_peaks": lambda data, bank, **kw: detect_local_peaks(data, bank, 4, **kw)[0],
    "hog_features": lambda data, bank, **kw: hog_features(data[..., 0], cell=8, bins=9, **kw),
}


@pytest.mark.parametrize("head", sorted(_HEADS))
def test_heads_run_on_the_card_by_default(rng, head):
    """The heads and hog_features take api.py's device rule: a numpy input
    with no device goes to the card, and raises naming device='cpu' where
    there is none; device='cpu' and CPU tensors run on the CPU, alike."""
    data = rng.standard_normal((64, 72, 1)).astype(np.float32)
    bank = rng.standard_normal((2, 5, 7, 1)).astype(np.float32)
    if torch.cuda.is_available():
        assert _HEADS[head](data, bank).device.type == "cuda"
    else:
        with pytest.raises(tfc.InvalidInputError, match="device='cpu'"):
            _HEADS[head](data, bank)
    on_cpu = _HEADS[head](data, bank, device="cpu")
    kept = _HEADS[head](torch.as_tensor(data), torch.as_tensor(bank))
    assert on_cpu.device.type == kept.device.type == "cpu"
    assert torch.equal(on_cpu, kept)
