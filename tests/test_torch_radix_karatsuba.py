"""The radix-2 bodies' H stage (the JAX package's v4, v5 and v5x) in the JAX
kernels' factorisation, and its Karatsuba form (``karatsuba=True`` with a
radix flag), against the JAX package.

JAX's radix bodies compute every window row from the sub-transforms Ê = U
S_even and Ô = U S_odd and the twiddle t, x = Ê ± t⊙Ô (``csub``,
``cuda_fft_convolution_tpu/ops/block_conv.py:207-231``), by default in the
Karatsuba form (``karatsuba = wstack or radix_h``, ``:701-702``; the peaks
kernel ``:1893-1894``); v5 adds the Nyquist term as fp32 VPU matvecs of U
on the unrounded S (``:1376-1388``). The port's plain versions
(``ops/block_conv.py`` ``_radix_x``, ``block_conv_reference``) compute the
same, in either form, and are held here to JAX's kernels in interpret mode
with the same flags:

- the repair: at BF16IO (bf16 planes) the 4-product form against JAX's
  ``karatsuba=False`` kernel within ``IO_RMS_BAR`` in root mean square and
  ``IO_MAX_BAR`` at most, both relative to the largest value, on seeds 0, 1
  and 1234, maps and peak values, the single-chunk rows (window rows [M −
  w0, M)) and the pair rows each within the rms bar. Before the repair the
  single rows came from G's rows rounded to bf16 (2.4e-4 rms over the maps,
  4.3e-4 over those rows) and v5's Nyquist term from the rounded S (1.1e-5);
- the Karatsuba form against JAX's default kernel: within ``TOL`` at
  float32 (interpret mode runs HIGHEST), the BF16IO bars at bf16 spectra,
  peak indices equal, the first-occurrence tie-break on exact ties;
- the rules: the flag runs on the CPU with every radix body, an illegal
  plan still raises ValueError, ``radix_fits(..., karatsuba)`` mirrors the
  C side's shared-memory formulas, the peaks auto rule takes v4 with the
  Karatsuba form where JAX's does (and the kernels take it), and the
  default calls keep their entries.

JAX's interpret-mode outputs are cached for the module (``_jax``): each
geometry, flag set and dtype compiles once. The CUDA entries (``…_r4_k``,
``…_r5_k``, ``…_r5x_k``) are held to these plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` step 36."""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fft_convolution_torch import _build
from cuda_fft_convolution_torch.ops import block_conv as tbc
from cuda_fft_convolution_tpu.ops import block_conv as jbc
from tests.test_torch_karatsuba import IO_MAX_BAR, IO_RMS_BAR, SEEDS, TOL, _c_one_block, _c_pair
from tests.test_torch_radix import BODIES, _operands

# JAX's one-block radix plans at N=2: its 32² plan (Vh 96, w0 32: one pair
# chunk and one single chunk of 64 rows, half of it past the window) and its
# F=1 plan (Vh 192, w0 64: two pair chunks and one single chunk).
GEOMS = {"jax_32": (128, 512, 33, 129, 200, 500), "jax_f1": (256, 512, 65, 129, 300, 500)}
CASES = list(itertools.product(GEOMS, SEEDS))


@functools.lru_cache(maxsize=None)
def _ops(geom_id, seed):
    return _operands(np.random.default_rng(seed), 1, 1, 2, *GEOMS[geom_id])


def _planes(geom_id, seed, dtype):
    return [torch.as_tensor(x).to(getattr(torch, dtype)) for x in _ops(geom_id, seed)]


@functools.lru_cache(maxsize=None)
def _jax(geom_id, seed, body, dtype, karatsuba, head="maps"):
    """JAX's kernel in interpret mode on the case's planes at ``dtype``
    (``karatsuba=None``: its default, the Karatsuba form) → float64 maps,
    or (float64 values, int32 indices) of one-block cells."""
    jops = [jnp.asarray(x).astype(dtype) for x in _ops(geom_id, seed)]
    geom = GEOMS[geom_id]
    flags = dict(BODIES[body], karatsuba=karatsuba)
    if head == "maps":
        return np.asarray(jbc.block_conv_pallas(*jops, *geom, interpret=True, **flags),
                          np.float64)
    vals, idxs = jbc.block_conv_peaks_pallas(*jops, *geom, interpret=True, mbh=1, mbw=1,
                                             **flags)
    return np.asarray(vals, np.float64), np.asarray(idxs)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rms(got, want):
    got = np.asarray(got, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean()) / np.abs(want).max())


def _single_rows(geom) -> np.ndarray:
    """The output rows that are window rows [M − w0, M) of their block: the
    kernels' single chunks."""
    bh, _, kh, _, out_h, _ = geom
    vh = bh - kh + 1
    m, w0 = bh // 2, bh - vh
    return (m - w0 <= np.arange(out_h) % vh) & (np.arange(out_h) % vh < m)


@pytest.mark.parametrize("body", list(BODIES))
@pytest.mark.parametrize("geom_id,seed", CASES)
def test_repair_matches_jax_same_form_at_bf16io(geom_id, seed, body):
    """The 4-product plain version at BF16IO against JAX's
    ``karatsuba=False`` kernel with the same flags: within IO_RMS_BAR rms
    and IO_MAX_BAR at most over the maps, and the single-chunk rows within
    the rms bar as the pair rows are (they read 4.3e-4 before the repair)."""
    geom = GEOMS[geom_id]
    want = _jax(geom_id, seed, body, "bfloat16", False)
    got = tbc.block_conv(*_planes(geom_id, seed, "bfloat16"), *geom, **BODIES[body])
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    assert _rms(got, want) <= IO_RMS_BAR
    assert _rel(got, want) <= IO_MAX_BAR
    single = _single_rows(geom)
    assert single.any() and not single.all()
    scale = np.abs(want).max()
    for rows in (single, ~single):
        err = (got[:, :, rows] - want[:, :, rows]) / scale
        assert float(np.sqrt((err ** 2).mean())) <= IO_RMS_BAR


@pytest.mark.parametrize("body", list(BODIES))
@pytest.mark.parametrize("geom_id,seed", CASES)
def test_repair_peaks_match_jax_same_form_at_bf16io(geom_id, seed, body):
    """The peaks plain version (one block a cell) at BF16IO against JAX's
    ``karatsuba=False`` peaks kernel with the same flags: values within the
    rms and max bars, indices equal outside near-tie cells (a second value
    of the cell's plain maps within IO_MAX_BAR of its max)."""
    geom = GEOMS[geom_id]
    jv, ji = _jax(geom_id, seed, body, "bfloat16", False, "peaks")
    planes = _planes(geom_id, seed, "bfloat16")
    gv, gi = tbc.block_conv_peaks(*planes, *geom, karatsuba=False, **BODIES[body])
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32 and gv.shape == jv.shape
    assert _rms(gv.numpy(), jv) <= IO_RMS_BAR
    assert _rel(gv.numpy(), jv) <= IO_MAX_BAR
    bh, bw, kh, kw = geom[:4]
    maps = tbc.block_conv(*planes, *geom, **BODIES[body])
    cells = tbc.cell_view(maps, *gv.shape[2:], bh - kh + 1, bw - kw + 1)
    atol = IO_MAX_BAR * np.abs(jv).max()
    near = ((cells >= gv[..., None] - atol).sum(-1) >= 2).numpy()
    assert not ((gi.numpy() != ji) & ~near).any()


@pytest.mark.parametrize("body", list(BODIES))
@pytest.mark.parametrize("geom_id", list(GEOMS))
def test_karatsuba_matches_jax_default_at_f32(geom_id, body):
    """``karatsuba=True`` at float32 against JAX's default (Karatsuba)
    kernel with the same flags: maps and peak values within TOL, indices
    equal; the form is not the 4-product one's (the products run)."""
    geom = GEOMS[geom_id]
    planes = _planes(geom_id, 0, "float32")
    want = _jax(geom_id, 0, body, "float32", None)
    got = tbc.block_conv(*planes, *geom, karatsuba=True, **BODIES[body])
    assert _rel(got.numpy(), want) <= TOL
    four = tbc.block_conv(*planes, *geom, **BODIES[body])
    assert not torch.equal(got, four)
    jv, ji = _jax(geom_id, 0, body, "float32", None, "peaks")
    gv, gi = tbc.block_conv_peaks(*planes, *geom, karatsuba=True, **BODIES[body])
    assert _rel(gv.numpy(), jv) <= TOL
    assert np.array_equal(gi.numpy(), ji)


@pytest.mark.parametrize("body", list(BODIES))
@pytest.mark.parametrize("geom_id,seed", CASES)
def test_karatsuba_matches_jax_default_at_bf16io(geom_id, seed, body):
    """``karatsuba=True`` at BF16IO against JAX's default kernel with the
    same flags, maps and peak values: within IO_RMS_BAR rms and IO_MAX_BAR
    at most, where the 4-product form reads over 10 times the rms bar (JAX
    rounds Ur + Ui and Sr + Si, not −t⊙U); the bf16 maps are the float32
    maps rounded once."""
    geom = GEOMS[geom_id]
    planes = _planes(geom_id, seed, "bfloat16")
    want = _jax(geom_id, seed, body, "bfloat16", None)
    got = tbc.block_conv(*planes, *geom, karatsuba=True, **BODIES[body])
    assert _rms(got.numpy(), want) <= IO_RMS_BAR
    assert _rel(got.numpy(), want) <= IO_MAX_BAR
    assert _rms(tbc.block_conv(*planes, *geom, **BODIES[body]).numpy(), want) > 10 * IO_RMS_BAR
    got16 = tbc.block_conv(*planes, *geom, torch.bfloat16, karatsuba=True, **BODIES[body])
    assert torch.equal(got16, got.to(torch.bfloat16))
    jv, _ = _jax(geom_id, seed, body, "bfloat16", None, "peaks")
    gv, _ = tbc.block_conv_peaks(*planes, *geom, karatsuba=True, **BODIES[body])
    assert _rms(gv.numpy(), jv) <= IO_RMS_BAR
    assert _rel(gv.numpy(), jv) <= IO_MAX_BAR


def _planted(bh, bw, kh, kw, h, w, plants, amplitude=4.0):
    """Noise with the bank's kernels planted at ``plants`` (one a kernel),
    its block spectra and the flipped bank's (correlation), as the JAX
    package's transforms make them → (float32 numpy planes, the centres'
    flat indices)."""
    from cuda_fft_convolution_tpu.ops.tiled import fft_data_blocks
    from tests.test_torch_bf16 import j_rfft2

    rng = np.random.default_rng(61)
    data = rng.standard_normal((1, 1, h, w)).astype(np.float32)
    bank = rng.standard_normal((len(plants), 1, kh, kw)).astype(np.float32)
    for t, (y0, x0) in enumerate(plants):
        data[0, :, y0 : y0 + kh, x0 : x0 + kw] += amplitude * bank[t]
    d_re, d_im = fft_data_blocks(jnp.asarray(data), bh, bw, kh, kw, origin_h=(kh - 1) // 2,
                                 origin_w=(kw - 1) // 2, win_h=h, win_w=w)
    k_re, k_im = j_rfft2(jnp.asarray(bank[:, :, ::-1, ::-1].copy()), bh, bw)
    planes = [np.array(x, np.float32) for x in (d_re, d_im, k_re, k_im)]
    return planes, [(y0 + kh // 2) * w + x0 + kw // 2 for y0, x0 in plants]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("body", list(BODIES))
def test_karatsuba_peaks_indices_at_plants_and_ties(body, dtype):
    """The Karatsuba peaks plain version against JAX's default peaks kernel
    with the same flags: on planted kernels both report each planted
    centre in its cell (and equal indices everywhere); on DC-only spectra,
    where every position of a block's window ties exactly through every
    body and form, both report each block's first position (the
    first-occurrence rule)."""
    geom = GEOMS["jax_f1"]
    bh, bw, kh, kw, h, w = geom
    vh, vw = bh - kh + 1, bw - kw + 1
    flags = BODIES[body]
    def pyramids(planes):
        _, ji = jbc.block_conv_peaks_pallas(*(jnp.asarray(x).astype(dtype) for x in planes),
                                            *geom, interpret=True, mbh=1, mbw=1, **flags)
        tops = [torch.as_tensor(x).to(getattr(torch, dtype)) for x in planes]
        return np.asarray(ji), tbc.block_conv_peaks(*tops, *geom, karatsuba=True, **flags)[1]

    planes, centres = _planted(*geom, [(40, 60), (200, 300)])
    ji, gi = pyramids(planes)
    assert np.array_equal(gi.numpy(), ji)
    for t, c in enumerate(centres):
        cell = (0, t, (c // w) // vh, (c % w) // vw)
        assert int(gi[cell]) == int(ji[cell]) == c
    dc = [np.zeros_like(x) for x in planes]
    dc[0][..., 0, 0] = np.random.default_rng(67).standard_normal(dc[0].shape[:4])
    dc[2][..., 0, 0] = 1.0
    ji, gi = pyramids(dc)
    nbh, nbw = gi.shape[2:]
    first = np.arange(nbh)[:, None] * vh * w + np.arange(nbw) * vw
    assert np.array_equal(gi.numpy(), np.broadcast_to(first, gi.shape))
    assert np.array_equal(np.asarray(ji), gi.numpy())


def test_karatsuba_radix_runs_on_cpu():
    """``karatsuba=True`` with each radix flag set runs on CPU tensors (the
    plain version; no launch), maps and peaks, within TOL of the 4-product
    form; with an illegal plan it still raises ValueError, as JAX
    asserts."""
    geom = GEOMS["jax_32"]
    planes = _planes("jax_32", 0, "float32")
    before = (tbc.block_conv.launches, tbc.block_conv_peaks.launches)
    for flags in BODIES.values():
        got = tbc.block_conv(*planes, *geom, karatsuba=True, **flags)
        four = tbc.block_conv(*planes, *geom, **flags)
        assert got.shape == four.shape
        assert 0 < _rel(got.numpy(), four.numpy().astype(np.float64)) <= TOL
        vals, idxs = tbc.block_conv_peaks(*planes, *geom, karatsuba=True, **flags)
        assert vals.dtype == torch.float32 and idxs.dtype == torch.int32
    assert (tbc.block_conv.launches, tbc.block_conv_peaks.launches) == before
    illegal_h = (45, 151, 10, 24, 100, 300)
    ops = [torch.as_tensor(x) for x in _operands(np.random.default_rng(3), 1, 1, 2, *illegal_h)]
    for flags in BODIES.values():
        with pytest.raises(ValueError, match="radix_h"):
            tbc.block_conv(*ops, *illegal_h, karatsuba=True, **flags)
        with pytest.raises(ValueError, match="radix_h"):
            tbc.block_conv_peaks(*ops, *illegal_h, karatsuba=True, **flags)
    illegal_w = (80, 601, 17, 50, 200, 1100)
    ops = [torch.as_tensor(x) for x in _operands(np.random.default_rng(3), 1, 1, 2, *illegal_w)]
    with pytest.raises(ValueError, match="radix_w"):
        tbc.block_conv(*ops, *illegal_w, radix_w=True, karatsuba=True)


@pytest.mark.parametrize("splits", list(tbc.TIERS))
def test_radix_fits_mirrors_the_c_formulas(splits):
    """``radix_fits(..., karatsuba)``: every radix body (v4, v5, v5x,
    ``kernel_layout``) the cluster pair where 64 rows do not fit and the pair does
    (``_c_pair``, v3's rule: U's planes in G's room there too), else the
    one-block configuration (no stack) whose shared memory
    (``csrc/block_conv.cuh`` tile_smem_bytes, written out in
    ``_c_one_block``: the Karatsuba form stages Sr + Si, and U's planes, Ur
    + Ui among them, in G's room) fits, 64 rows where they fit;
    ``radix_row_chunks`` counts each configuration's chunks (a pair's two
    CTAs one chunk) and ``peaks_chunks`` the peaks kernel's entries (two a
    pair's chunk). The Karatsuba form at 6×TF32 does not fit Wc 513 (W
    1024), paired or not."""
    legal = ((48, 40), (80, 64), (128, 96), (256, 192), (256, 200), (32, 24))
    for wc, (lh, vh) in itertools.product((129, 224, 257, 288, 289, 301, 385, 449, 513, 577,
                                           641), legal):
        assert tbc.radix_h_legal(lh, vh)
        for kara in (False, True):
            g = tbc.blocks_per_cta(wc, vh, splits)
            rows = 64 if _c_one_block(wc, 64, splits, kara) <= tbc.SMEM_LIMIT_BYTES else 32
            one = _c_one_block(wc, rows, splits, kara) <= tbc.SMEM_LIMIT_BYTES
            half = _c_pair(wc, splits, kara)[0] if g == 1 and rows == 32 else 0
            assert tbc.pair_bins(wc, vh, splits, kara) == half
            chunks = sum(tbc.radix_chunks(lh, vh, 64 if half else rows))
            assert tbc.radix_fits(wc, vh, splits, kara) == (g == 1 and (half > 0 or one)), (
                wc, vh, kara)
            assert tbc.radix_row_chunks(wc, lh, vh, splits, kara) == chunks
            for body in ("v4", "v5", "v5x"):
                assert tbc.kernel_layout(body, wc, vh, splits, kara) == (
                    (64, half) if half else (rows, 0))
                assert tbc.peaks_chunks(wc, vh, splits, kara, body, lh) == chunks * (
                    2 if half else 1)
    assert tbc.radix_fits(257, 192, splits, True)
    assert tbc.radix_fits(513, 192, splits, True) == (splits != 6)
    assert tbc.kernel_layout("v5", 513, 192, splits, True) == tbc.kernel_layout(
        "v4", 513, 192, splits, True)
    assert tbc.radix_fits(513, 192, splits)


def test_peaks_auto_rule_with_karatsuba():
    """``block_conv_peaks(..., radix_h=None, karatsuba=True)`` resolves the
    body as JAX's auto rule does — v4 at float32 spectra where
    ``radix_h_legal`` holds — wherever the kernels take the Karatsuba radix
    form (``radix_fits``), on either device; at JAX's F=1 plan it runs v4
    Karatsuba (the same pyramid as the explicit flag)."""
    for bh, bw, kh in itertools.product((48, 64, 80, 128, 256), (256, 512, 1024), (9, 17, 33, 65)):
        vh = bh - kh + 1
        for dtype in (torch.float32, torch.bfloat16):
            dr = torch.zeros((1, 1, 1, 1, bh, bw // 2 + 1), dtype=dtype)
            tier = tbc.fused_splits(dtype)
            theirs = dtype != torch.bfloat16 and jbc.radix_h_legal(bh, vh)
            mine = tbc._peaks_radix_h(None, False, dr, bh, bw, kh, None, True)
            assert mine == (theirs and tbc.radix_fits(bw // 2 + 1, vh, tier, True)), (bh, bw, kh)
    geom = GEOMS["jax_f1"]
    planes = _planes("jax_f1", 1, "float32")
    auto = tbc.block_conv_peaks(*planes, *geom, karatsuba=True)
    v4 = tbc.block_conv_peaks(*planes, *geom, radix_h=True, karatsuba=True)
    v3 = tbc.block_conv_peaks(*planes, *geom, radix_h=False, karatsuba=True)
    assert all(torch.equal(a, b) for a, b in zip(auto, v4))
    assert not torch.equal(auto[0], v3[0])


def test_default_calls_keep_their_entries():
    """With ``karatsuba`` None or False every radix body keeps its entry
    (``_r4``, ``_r5``, ``_r5x``) and library; True takes the ``_k`` entries,
    every one of which the radix forms library binds (45: 10 maps and 5
    peaks modes a body); the routes' flags (``radix_dispatch``) do not read
    the form."""
    names = set(_build._KINDS["radix_forms"][1])
    radix = set(_build._KINDS["radix"][1])
    assert len(names) == 45 and names == {f"{n}_k" for n in radix}
    assert _build._kind(True, True) == "radix_forms"
    assert {s.name for s in _build._sources(True, True) if s.suffix == ".cu"} == {
        "block_conv_r4_k.cu", "block_conv_r5_k.cu", "block_conv_r5x_k.cu"}
    for body in ("v4", "v5", "v5x"):
        assert tbc.body_suffix(body) == tbc.RADIX_SUFFIX[body]
        suffix = tbc.body_suffix(body, True)
        assert suffix == tbc.RADIX_SUFFIX[body] + "_k"
        for tag, maps, tier in itertools.product(("f32", "bf16"), ("", "_bf16maps"), tbc.TIERS):
            if (tag == "bf16") == (tier in (3, tbc.BF16IO)) or tier == 3:
                stem = f"fftconv_block_conv_{tag}{maps}{tbc.TIER_SUFFIX[tier]}"
                assert stem + suffix in names and stem + tbc.RADIX_SUFFIX[body] in radix
    for dtype in (torch.float32, torch.bfloat16):
        flags = tbc.radix_dispatch(256, 511, 65, 128, dtype, 1, tbc.fused_splits(dtype))
        assert flags == (True, False, False)
