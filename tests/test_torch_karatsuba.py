"""The fused kernels' last two JAX forms against the JAX package's: the
Karatsuba H stage (``karatsuba=True``) and the v2 body (``wstack=False``).

JAX's ``block_conv_pallas`` runs the complex H product as three real
products by default — t1 = Gr·Sr, t2 = Gi·Si, t3 = (Gr + Gi)·(Sr + Si);
Xr = t1 − t2, Xi = t3 − t1 − t2 (``cuda_fft_convolution_tpu/ops/
block_conv.py:153-157``) — and under ``wstack=False`` its v2 body
(``_make_kernel``, ``:269-308``): blocks of one block column stacked side
by side in one H product, then a W product per block. The port's plain
versions (``ops/block_conv.py block_conv_reference``) compute each form as
the JAX kernel does, and are held here to JAX's kernels run in interpret
mode with the same flags: at float32 (every fp32 tier: interpret mode
runs HIGHEST) within ``TOL``; at BF16IO, against JAX's *default* kernel
(Karatsuba), within ``IO_RMS_BAR`` in root mean square and ``IO_MAX_BAR``
at most, both relative to the largest value, on several seeds (the
4-product form reads 5.9–7.7e-4 rms there). Also the flags' rules, the
shared-memory mirror of both forms against the C side's formulas, and
that no default call changes its entry. The CUDA entries (``…_k``,
``…_v2``, ``…_v2_k``) are held to these plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` step 37."""

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
from tests.test_torch_bf16 import _bf16, _block_operands, _f32, _jbf16
from tests.test_torch_bf16io import IO_CASES

TOL = 1e-5
# BF16IO: both sides round S, G, X and M to bf16 and sum the exact products
# in f32 in other orders, so a value at a rounding boundary may land one
# bf16 step the other way; on the CPU (IO_CASES x SEEDS) the Karatsuba plain
# version read at most 3.0e-6 rms and 2.1e-4 max from JAX's default kernel.
IO_RMS_BAR = 1e-5
IO_MAX_BAR = 1e-3
SEEDS = (0, 1, 1234)
# v2 at BF16IO: the same flips, on the small V2_CASES; one X value a bf16
# step the other way read 1.5e-5 rms there (the DPM-plan case, seed 1,
# Karatsuba, 3.0e-4 max), so the rms bar is the card's kernel-against-plain
# bar for the same flips (chip_smoke.py IO_RMS_TOL).
V2_IO_RMS_BAR = 1e-4
# Cases of several block rows for v2: groups of v2_blocks() blocks a column
# (the DPM plan's blocks, 4 a group over the case's 9 block rows, a partial
# last group; and the F=8 plan's, 2 a group), beside blocks of 36 and 49
# window rows (one a group).
V2_CASES = [
    (1, 3, 2, 27, 139, 12, 12, 130, 150),
    (1, 2, 2, 63, 287, 32, 32, 170, 300),
    (2, 3, 3, 45, 151, 10, 24, 100, 300),
    (1, 2, 3, 64, 256, 16, 33, 120, 400),
]
SETTINGS = {
    "bf16x3": dict(fused_precision="bf16x3"),
    "highest": dict(fused_precision="highest", matmul_precision="highest"),
    "default": dict(fused_precision="highest", matmul_precision="default"),
}


def _case(rng, b, f, n, bh, bw, kh, kw, h, w):
    return _block_operands(rng, b, f, n, bh, bw, kh, kw, h, w), (bh, bw, kh, kw, h, w)


def _torch(ops):
    return [torch.as_tensor(np.array(x)) for x in ops]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean()) / np.abs(want).max())


@pytest.fixture
def setting(request):
    before = tfc.get_config()
    tfc.set_config(**SETTINGS[request.param])
    yield request.param
    tfc.set_config(fused_precision=before.fused_precision,
                   matmul_precision=before.matmul_precision)


@pytest.mark.parametrize("setting", list(SETTINGS), indirect=True)
@pytest.mark.parametrize("case", IO_CASES)
def test_karatsuba_matches_jax_at_f32(rng, setting, case):
    """The Karatsuba plain version at each fp32 tier's config against JAX's
    default (Karatsuba) v3 kernel in interpret mode, within TOL; the
    4-product form agrees with it too (the two forms are the same bilinear
    form)."""
    ops, geom = _case(rng, *case)
    want = np.asarray(block_conv_pallas(*map(jnp.asarray, ops), *geom, interpret=True))
    got = tbc.block_conv(*_torch(ops), *geom, karatsuba=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= TOL
    assert _rel(tbc.block_conv(*_torch(ops), *geom).numpy(), want) <= TOL


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", IO_CASES)
def test_karatsuba_matches_jax_default_at_bf16io(seed, case):
    """At BF16IO (bf16 planes) against JAX's default kernel, whose H stage
    is Karatsuba: the port's Karatsuba plain version within IO_RMS_BAR rms
    and IO_MAX_BAR at most, where its 4-product form reads over 50 times
    the rms bar; the bf16 maps are its float32 maps rounded once."""
    ops, geom = _case(np.random.default_rng(seed), *case)
    t16 = [_bf16(x) for x in ops]
    want = _f32(block_conv_pallas(*map(_jbf16, ops), *geom, interpret=True))
    got = tbc.block_conv(*t16, *geom, karatsuba=True)
    assert _rms(got.numpy(), want) <= IO_RMS_BAR
    assert _rel(got.numpy(), want) <= IO_MAX_BAR
    four = tbc.block_conv(*t16, *geom).numpy()
    assert _rms(four, want) > 50 * IO_RMS_BAR
    got16 = tbc.block_conv(*t16, *geom, torch.bfloat16, karatsuba=True)
    assert torch.equal(got16, got.to(torch.bfloat16))


@pytest.mark.parametrize("karatsuba", [False, True])
@pytest.mark.parametrize("case", V2_CASES)
def test_v2_matches_jax_v2(rng, case, karatsuba):
    """The v2 body (``wstack=False``), both H-stage forms, at float32
    against JAX's v2 kernel with the same flags, within TOL."""
    ops, geom = _case(rng, *case)
    want = np.asarray(block_conv_pallas(*map(jnp.asarray, ops), *geom, interpret=True,
                                        wstack=False, karatsuba=karatsuba))
    got = tbc.block_conv(*_torch(ops), *geom, wstack=False, karatsuba=karatsuba)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("karatsuba", [False, True])
@pytest.mark.parametrize("case", V2_CASES[:2])
def test_v2_matches_jax_v2_at_bf16io(case, karatsuba):
    """The v2 body at BF16IO against JAX's v2 with the same form, on
    several seeds: at most IO_MAX_BAR, and V2_IO_RMS_BAR in root mean
    square, which the other form's plain version passes by far."""
    for seed in SEEDS:
        ops, geom = _case(np.random.default_rng(seed), *case)
        want = _f32(block_conv_pallas(*map(_jbf16, ops), *geom, interpret=True, wstack=False,
                                      karatsuba=karatsuba))
        t16 = [_bf16(x) for x in ops]
        got = tbc.block_conv(*t16, *geom, wstack=False, karatsuba=karatsuba).numpy()
        assert _rms(got, want) <= V2_IO_RMS_BAR, seed
        assert _rel(got, want) <= IO_MAX_BAR, seed
        other = tbc.block_conv(*t16, *geom, wstack=False, karatsuba=not karatsuba).numpy()
        assert _rms(other, want) > 3 * V2_IO_RMS_BAR, seed


@pytest.mark.parametrize("case", V2_CASES)
def test_v2_is_v3_column_by_column(rng, case):
    """v2 stacks ``v2_blocks`` blocks' columns into one H product; each
    column's sums are v3's, so both forms of v2 land within TOL of v3's
    same form (rounding of the products' order alone)."""
    ops, geom = _case(rng, *case)
    t = _torch(ops)
    for kara in (False, True):
        v3 = tbc.block_conv(*t, *geom, karatsuba=kara)
        assert _rel(tbc.block_conv(*t, *geom, wstack=False, karatsuba=kara).numpy(),
                    v3.numpy()) <= TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", IO_CASES)
def test_karatsuba_peaks_match_jax(rng, case, dtype):
    """The peaks kernel's Karatsuba plain version (one block a cell, v3)
    against ``block_conv_peaks_pallas`` (its default Karatsuba form) with
    ``mbh=1, mbw=1, radix_h=False``: values within the tier's bar of the
    largest (TOL at float32, IO_MAX_BAR at BF16IO), indices equal outside
    near-tie cells (a second value of the cell's plain maps that close)."""
    ops, geom = _case(rng, *case)
    if dtype == "float32":
        tops, jops, bar = _torch(ops), list(map(jnp.asarray, ops)), TOL
    else:
        tops, jops, bar = [_bf16(x) for x in ops], list(map(_jbf16, ops)), IO_MAX_BAR
    gv, gi = tbc.block_conv_peaks(*tops, *geom, radix_h=False, karatsuba=True)
    jv, ji = block_conv_peaks_pallas(*jops, *geom, interpret=True, mbh=1, mbw=1,
                                     radix_h=False)
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32 and gv.shape == jv.shape
    atol = bar * np.abs(jv).max()
    assert np.abs(gv.numpy() - jv).max() <= atol
    bh, bw, kh, kw = geom[:4]
    maps = tbc.block_conv(*tops, *geom, karatsuba=True)
    cells = tbc.cell_view(maps, *gv.shape[2:], bh - kh + 1, bw - kw + 1)
    near = ((cells >= gv[..., None] - atol).sum(-1) >= 2).numpy()
    assert not ((gi.numpy() != ji) & ~near).any()
    want_v, want_i = tbc.cell_peaks(maps, *gv.shape[2:], bh - kh + 1, bw - kw + 1)
    assert torch.equal(gv, want_v) and torch.equal(gi, want_i)


def test_flag_rules(rng):
    """JAX's rules on either device: a radix flag needs ``wstack``;
    ``karatsuba=True`` runs in every body, a radix body's included (within
    TOL of its 4-product form), and the peaks auto rule picks v4 with it;
    ``karatsuba=None`` is the 4-product form; v2 has no peaks head."""
    radix_geom = (64, 256, 9, 33, 120, 400)
    ops, geom = _case(rng, 1, 1, 2, *radix_geom)
    t = _torch(ops)
    assert tbc.radix_h_legal(64, 56)
    for flags in (dict(radix_h=True), dict(radix_w=True)):
        with pytest.raises(tfc.InvalidInputError, match="wstack"):
            tbc.block_conv(*t, *geom, wstack=False, **flags)
        with pytest.raises(tfc.InvalidInputError, match="wstack"):
            tbc.block_conv_reference(*t, *geom, wstack=False, **flags)
    v4_k = tbc.block_conv(*t, *geom, radix_h=True, karatsuba=True)
    v4 = tbc.block_conv(*t, *geom, radix_h=True)
    assert not torch.equal(v4_k, v4) and _rel(v4_k.numpy(), v4.numpy()) <= TOL
    auto = tbc.block_conv_peaks(*t, *geom, karatsuba=True)  # the auto rule picks v4 here
    for got, want in zip(auto, tbc.block_conv_peaks(*t, *geom, radix_h=True, karatsuba=True)):
        assert torch.equal(got, want)
    with pytest.raises(TypeError):
        tbc.block_conv_peaks(*t, *geom, wstack=False)
    v3 = tbc.block_conv(*t, *geom)
    assert torch.equal(tbc.block_conv(*t, *geom, karatsuba=None), v3)
    assert torch.equal(tbc.block_conv(*t, *geom, karatsuba=False), v3)
    assert not torch.equal(tbc.block_conv(*t, *geom, karatsuba=True), v3)
    vp = tbc.block_conv_peaks(*t, *geom, radix_h=False, karatsuba=True)
    assert all(x.shape == y.shape for x, y in zip(vp, tbc.block_conv_peaks(*t, *geom)))


def test_default_calls_keep_their_entries():
    """With neither flag set, every body keeps its C entry's name and the
    v3 configuration its operands: ``body_suffix`` of the default form is
    the radix suffix (none for v3), and ``_kernel_mats`` with the default
    form's rows is the parent's call (``rows=None``). The new forms' names:
    ``_k``, ``_v2``, ``_v2_k``."""
    for body, suffix in tbc.RADIX_SUFFIX.items():
        flags = dict(radix_h=body != "v3", radix_w=body in ("v5", "v5x"), xsliver=body == "v5x")
        got = tbc._body(**flags)
        assert got == body and tbc.body_suffix(got) == suffix
    assert tbc.body_suffix("v3", True) == "_k"
    assert tbc.body_suffix("v2") == "_v2" and tbc.body_suffix("v2", True) == "_v2_k"
    for splits in tbc.TIERS:
        a = tbc._kernel_mats(127, 447, 64, 64, "cpu", splits)
        b = tbc._kernel_mats(127, 447, 64, 64, "cpu", splits, tbc.tile_rows(224, 64, splits))
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _c_stage_h(rows, pieces, kara):
    """csrc/block_conv.cuh stage_h, written out: S^T's planes (2, or 3 with
    Sr + Si) and G's (3 at 64 rows: re, im and −im or Gr + Gi; at 32 rows
    as many as S^T's), each plane kCols (128) or ``rows`` rows of 16
    floats, rows of 20 at 32 rows."""
    s = 3 if kara else 2
    if rows == 64:
        return s * pieces * 128 * 16 + 3 * pieces * rows * 16
    return s * pieces * (128 + rows) * 20


def _c_pair(wc, splits, kara):
    """csrc/block_conv.cuh's paired configuration written out → (rank 0's
    bins, shared memory), (0, 0) where it does not fit: X of h bins a CTA
    (half of the wc - 1 below the last, rounded up to 32; 32 more where
    that leaves rank 1 a pass of under 32 bins), the 64-row staging area, a
    sliver of 256 floats."""
    pieces = tbc.TIERS[splits]
    stage = max(_c_stage_h(64, pieces, kara), 2 * pieces * 128 * 32)

    def smem(h):
        return 4 * (64 * (2 * h + 4) + stage + 256)

    nb = wc - 1
    h0 = ((nb + 1) // 2 + 31) // 32 * 32
    for h in (h0, h0 + 32):
        if h < nb and ((nb - h) % 128 == 0 or (nb - h) % 128 >= 32) and smem(h) <= 232448:
            return h, smem(h)
    return (h0, smem(h0)) if h0 < nb and smem(h0) <= 232448 else (0, 0)


def _c_one_block(wc, rows, splits, kara):
    """csrc/block_conv.cuh tile_smem_bytes written out (the W stage's ring:
    2 chunks of M^T's planes, one plane at 32 rows and 6xTF32)."""
    pieces = tbc.TIERS[splits]
    stage_w = 2 * (1 if rows == 32 and splits == 6 else pieces) * 128 * 32
    x_stride = 2 * (-(-wc // 32) * 32) + 4
    return 4 * (rows * x_stride + max(_c_stage_h(rows, pieces, kara), stage_w))


@pytest.mark.parametrize("splits", list(tbc.TIERS))
def test_mirror_of_both_forms(splits):
    """The shared-memory mirror with ``karatsuba`` and the v2 rule against
    the C side's formulas: the one-block configurations stage Sr + Si and
    Gr + Gi (the stacked one nothing more); v2 takes v3's configuration
    of the same form (its rows, blocks a CTA, pair and shared memory); v3
    pairs 64-row CTAs where 64 rows do not fit and the pair does
    (``_c_pair``), else 32 rows."""
    for wc in (17, 70, 129, 144, 224, 225, 256, 257, 301, 320, 321, 451, 513):
        for vh in (1, 8, 16, 21, 32, 33, 64, 100, 961):
            g = tbc.blocks_per_cta(wc, vh, splits)
            rows = tbc.tile_rows(wc, vh, splits, True)
            if g > 1:
                assert rows == 64
                assert tbc.smem_bytes(wc, vh, splits, True) == tbc.smem_bytes(wc, vh, splits)
            else:
                fits64 = _c_one_block(wc, 64, splits, True) <= 232448
                half, pair_smem = (0, 0) if fits64 else _c_pair(wc, splits, True)
                assert rows == (64 if fits64 or half else 32)
                assert tbc.cluster_size(wc, vh, splits, True) == (2 if half else 1)
                assert tbc.smem_bytes(wc, vh, splits, True) == (
                    pair_smem if half else _c_one_block(wc, rows, splits, True))
            assert tbc.row_chunks(wc, vh, splits, True) == (1 if g > 1 else -(-vh // rows))
            for kara in (False, True):
                smem = tbc.smem_bytes(wc, vh, splits, kara)
                want = (tbc.tile_rows(wc, vh, splits, kara), g, smem,
                        tbc.kernel_layout("v3", wc, vh, splits, kara))
                assert (tbc.v2_rows(wc, vh, splits, kara), tbc.v2_blocks(wc, vh, splits, kara),
                        tbc.v2_smem_bytes(wc, vh, splits, kara),
                        tbc.kernel_layout("v2", wc, vh, splits, kara)) == want
                assert tbc.form_smem_bytes(wc, vh, splits, False, kara) == smem
                assert (tbc.form_smem_bytes(wc, vh, splits, True, kara)
                        == tbc.smem_bytes(wc, vh, splits, kara))
    # the headline (Wc 224, Vh 64): Sr + Si's pieces add 8 KB at 3xTF32 and
    # 12 KB at 6xTF32, still 64 rows
    assert tbc.smem_bytes(224, 64, 3, True) == 181248 + 8192 == 189440
    assert tbc.smem_bytes(224, 64, 6, True) == 214016 + 12288 == 226304
    assert tbc.tile_rows(224, 64, 6, True) == 64
    # the 1024 block at 6xTF32 does not fit the Karatsuba stage
    assert tbc.smem_bytes(513, 961, 6, True) > tbc.SMEM_LIMIT_BYTES
    assert tbc.v2_blocks(70, 16, 3) == 4 and tbc.v2_blocks(144, 32, 3) == 2
    assert tbc.v2_blocks(224, 64, 3) == 1


def test_forms_the_kernels_take():
    """``form_taken``: a form runs on the card where its shared memory
    fits. The Karatsuba stage at 6×TF32 does not fit the 1024 blocks (Wc
    513) in either body; every form takes the DPM plan (stacked for v3)
    and the headline at every tier."""
    assert tbc.blocks_per_cta(70, 16, 6) > 1
    for splits in tbc.TIERS:
        for wstack in (True, False):
            for kara in (False, True):
                assert tbc.form_taken(70, 16, splits, wstack, kara)
                assert tbc.form_taken(224, 64, splits, wstack, kara)
    for wstack in (True, False):
        assert not tbc.form_taken(513, 961, 6, wstack, True)
        assert tbc.form_taken(513, 961, 6, wstack) and tbc.form_taken(513, 961, 3, wstack, True)


def test_v2_groups_cover_every_block(rng):
    """v2's plain version groups ``v2_blocks`` blocks of a column (here 4,
    over 5 block rows: one partial group of 1) and gives each block the
    maps v3 gives it."""
    ops, geom = _case(rng, 1, 2, 2, 27, 139, 12, 12, 75, 150)
    assert tbc.v2_blocks(70, 16, 3) == 4 and ops[0].shape[1] == 5
    t = _torch(ops)
    assert _rel(tbc.block_conv(*t, *geom, wstack=False).numpy(),
                tbc.block_conv(*t, *geom).numpy()) <= TOL
