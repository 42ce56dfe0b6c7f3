"""The radix-2 bodies of the fused block conv (the JAX package's v4, v5 and
v5x: ``ops/block_conv.py`` ``radix_h``, ``radix_w``, ``xsliver``) against
the JAX package.

On the CPU the port's wrapper runs the plain version of the body the flags
select, which follows the JAX kernels' factorisation, as the Hopper
kernels do (the radix H stage's sub-transforms and twiddle, the DIF
halves, the Nyquist term); it is held here to ``block_conv_pallas`` in
interpret mode with the same flags (bf16x3 becomes HIGHEST there, so the
reference is exact fp32) within 1e-5 at float32 and within the bf16 tier's
2e-2 at bf16 spectra (JAX's default form there is Karatsuba; the forms at
the BF16IO bars are in ``tests/test_torch_radix_karatsuba.py``). Also: the
legality rules, the matrices, the plan registry and the dispatch against
their JAX twins; the flags' refusals. The peaks head is in
``tests/test_torch_detect.py``; the CUDA kernels are held to the plain
versions on the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fft_convolution_torch.ops import block_conv as tbc
from cuda_fft_convolution_torch.ops import tiled as tt
from cuda_fft_convolution_tpu.ops import block_conv as jbc
from cuda_fft_convolution_tpu.ops.tiled import fft_data_blocks

TOL = 1e-5
BF16_TOL = 2e-2  # the bf16 tier (tests/test_bf16_tier.py)
# tests/test_torch_block_conv.py's RADIX_GEOM (blocks 32 × 512, Vh 24, Vw
# 384: both of JAX's rules admit it; the Hopper kernels stack it) and JAX's
# fp32/bf16 F=1 plan (256, 512, 65, 129)
GEOMS = [(32, 512, 9, 129, 40, 500), (256, 512, 65, 129, 300, 500)]
BODIES = {"v4": dict(radix_h=True), "v5": dict(radix_h=True, radix_w=True),
          "v5x": dict(radix_h=True, radix_w=True, xsliver=True)}


def _operands(rng, b, f, n, bh, bw, kh, kw, out_h, out_w):
    data = rng.standard_normal((b, f, out_h, out_w)).astype(np.float32)
    d_re, d_im = fft_data_blocks(
        jnp.asarray(data), bh, bw, kh, kw, origin_h=(kh - 1) // 2,
        origin_w=(kw - 1) // 2, win_h=out_h, win_w=out_w,
    )
    wc = bw // 2 + 1
    k_re = rng.standard_normal((n, f, bh, wc)).astype(np.float32)
    k_im = rng.standard_normal((n, f, bh, wc)).astype(np.float32)
    return np.array(d_re), np.array(d_im), k_re, k_im


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("body", list(BODIES))
@pytest.mark.parametrize("geom", GEOMS, ids=["radix_geom", "jax_plan"])
def test_radix_plain_matches_jax(rng, geom, body, dtype):
    """Each body's plain version (the wrapper on CPU tensors) against
    ``block_conv_pallas`` with the same flags, N=2: 1e-5 at float32, 2e-2
    at bf16 spectra (BF16IO on both sides)."""
    ops = _operands(rng, 1, 1, 2, *geom)
    want = jbc.block_conv_pallas(*(jnp.asarray(x).astype(dtype) for x in ops), *geom,
                                 interpret=True, **BODIES[body])
    tops = [torch.as_tensor(x).to(getattr(torch, dtype)) for x in ops]
    before = tbc.block_conv.launches
    got = tbc.block_conv(*tops, *geom, **BODIES[body])
    assert tbc.block_conv.launches == before  # the CPU runs the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= (TOL if dtype == "float32" else BF16_TOL)


def test_radix_plain_is_v3_within_fp32(rng):
    """At float32 every body computes v3's maps (the same function, other
    factorisations), within 1e-5 of the v3 plain version, and each differs
    from it (the factorisation runs)."""
    geom = GEOMS[1]
    ops = [torch.as_tensor(x) for x in _operands(rng, 1, 2, 2, *geom)]
    v3 = tbc.block_conv_reference(*ops, *geom)
    for flags in BODIES.values():
        got = tbc.block_conv_reference(*ops, *geom, **flags)
        assert 0 < _rel(got, v3) <= TOL


def test_radix_plain_in_float64_is_exact(rng):
    """In float64 every body's plain version gives v3's float64 maps within
    the float32 rounding of the matrices (both packages build them in
    float64 and round them once), 1e-7: the pair chunks' combine, the
    single rows, the DIF halves and both Nyquist terms together are the
    whole inverse (a term left out reads O(1))."""
    geom = (128, 512, 33, 129, 200, 500)
    ops = [torch.as_tensor(x).double() for x in _operands(rng, 2, 2, 2, *geom)]
    v3 = tbc.block_conv_reference(*ops, *geom, torch.float64)
    for flags in BODIES.values():
        got = tbc.block_conv_reference(*ops, *geom, torch.float64, **flags)
        assert float((got - v3).abs().max() / v3.abs().max()) <= 1e-7


def test_legality_rules_match_jax():
    """``radix_h_legal`` over (lh, vh) and ``radix_w_legal`` over (block_w,
    kw, vw) answer as JAX's do."""
    for lh, vh in itertools.product(range(2, 300, 3), range(1, 300, 7)):
        assert tbc.radix_h_legal(lh, vh) == jbc.radix_h_legal(lh, vh), (lh, vh)
    for bw, kw in itertools.product((256, 384, 500, 512, 768, 1024, 1536, 2048), range(1, 700, 17)):
        for vw in (1, 64, 128, 200, bw - kw + 1, bw):
            assert tbc.radix_w_legal(bw, kw, vw) == jbc.radix_w_legal(bw, kw, vw), (bw, kw, vw)


@pytest.mark.parametrize("lh,vh,bw,kw", [(256, 192, 512, 129), (128, 96, 512, 33),
                                         (32, 24, 1024, 65), (80, 64, 512, 1)])
def test_matrices_are_jax_bitwise(lh, vh, bw, kw):
    """The copies of ``_radix_mats``, ``_dif_w_mats``, ``_sliver_h_mats`` and
    ``_sliver_parity_row`` give the JAX package's arrays bit for bit."""
    vw = bw - kw + 1
    for mine, theirs in ((tbc._radix_mats(lh), jbc._radix_mats(lh)),
                         (tbc._dif_w_mats(bw, kw, vw), jbc._dif_w_mats(bw, kw, vw)),
                         (tbc._sliver_h_mats(lh, vh), jbc._sliver_h_mats(lh, vh)),
                         ((tbc._sliver_parity_row(bw, kw, vw),),
                          (jbc._sliver_parity_row(bw, kw, vw),))):
        for a, b in zip(mine, theirs, strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    cos, sin = tbc.radix_twiddle(lh)
    v = np.arange(lh // 2)
    assert np.allclose(cos, np.cos(np.pi * v / (lh // 2)), atol=1e-7)
    assert np.allclose(sin, np.sin(np.pi * v / (lh // 2)), atol=1e-7)


def test_xsliver_matches_jax(rng):
    """v5x's Nyquist sliver, synthesised outside the kernel, against JAX's
    ``_xsliver_operands`` (one block a cell), within fp32 rounding."""
    bh, bw, kh, kw, out_h, out_w = geom = GEOMS[1]
    ops = _operands(rng, 2, 3, 2, *geom)
    perm = np.concatenate([np.arange(0, bh, 2), np.arange(1, bh, 2)])
    jops = [jnp.asarray(x).take(perm, axis=-2) for x in ops]  # H-permuted, as JAX calls it
    nbh, nbw = ops[0].shape[1:3]
    want, par = jbc._xsliver_operands(*jops, bh, bw, kw, bh - kh + 1, bw - kw + 1,
                                      1, 1, nbh, nbw)
    got = tbc._xsliver(*(torch.as_tensor(x) for x in ops), bh, bw, kh)
    assert tuple(got.shape) == (2, 2, nbh, nbw, bh - kh + 1)
    assert _rel(got.numpy(), np.asarray(want).reshape(got.shape)) <= TOL
    assert np.array_equal(np.asarray(par), tbc._sliver_parity_row(bw, kw, bw - kw + 1))


@pytest.fixture
def registries():
    """Both packages' radix-w registries, restored after the test."""
    names = ("_RADIX_W_TABLE", "_RADIX_W_TABLE_PEAKS", "_RADIX_W_XSLIVER",
             "_RADIX_W_XSLIVER_PEAKS")
    saved = [(mod, n, getattr(mod, n).copy()) for mod in (tbc, jbc) for n in names]
    yield
    for mod, n, value in saved:
        getattr(mod, n).clear()
        getattr(mod, n).update(value)


def _jax_builtin(key, head):
    return key in (jbc._BUILTIN_RADIX_W_PEAKS if head == "peaks" else jbc._BUILTIN_RADIX_W)


def test_registry_matches_jax(registries):
    """After the same registrations ``radix_w_enabled`` and
    ``radix_w_xsliver`` answer as JAX's, for both heads, with the
    ``sliver='kernel'`` override of a v5x registration — but for the plans
    JAX's builtin tables (measured on a TPU v5e) list, which the port does
    not have, and the plans the Hopper kernels stack (``radix_fits``)."""
    plans = [(256, 512, 65, 129), (128, 512, 33, 129), (256, 1024, 65, 129),
             (32, 512, 9, 129), (256, 511, 65, 128), (256, 512, 64, 129)]
    # nothing registered: no plan runs v5 or v5x in the port, while JAX's
    # builtin tables enable its F=1 plan
    for (bh, bw, kh, kw), spec, head in itertools.product(plans, (4, 2), ("conv", "peaks")):
        assert not tbc.radix_w_enabled(bh, bw, kh, kw, spec, 1, head)
        assert not tbc.radix_w_xsliver(bh, bw, kw, spec, 1, head)
    assert jbc.radix_w_enabled(256, 512, 65, 129, 4, 1, "conv")
    regs = [((256, 512, 129), dict(sliver="xla")), ((128, 512, 129), dict(f=3)),
            ((256, 1024, 129), dict(head="peaks", sliver="xla")),
            ((32, 512, 129), dict(spec_bytes=2)), ((256, 511, 128), {}),
            ((256, 512, 129), dict(sliver="kernel"))]  # overrides the first
    for args, kw in regs:
        tbc.register_radix_w_plan(*args, **kw)
        jbc.register_radix_w_plan(*args, **kw)
    seen = set()
    for (bh, bw, kh, kw), spec, f, head in itertools.product(plans, (4, 2), (1, 3), ("conv", "peaks")):
        key = (bh, bw, kw, spec, f)
        vh = bh - kh + 1
        tier = tbc.fused_splits(torch.bfloat16 if spec == 2 else torch.float32)
        mine = tbc.radix_w_enabled(bh, bw, kh, kw, spec, f, head)
        theirs = jbc.radix_w_enabled(bh, bw, kh, kw, spec, f, head)
        registered = key in (tbc._RADIX_W_TABLE_PEAKS if head == "peaks" else tbc._RADIX_W_TABLE)
        if _jax_builtin(key, head) and not registered:
            assert not mine
        else:
            assert mine == (theirs and tbc.radix_fits(bw // 2 + 1, vh, tier)), (key, head)
        seen.add(mine)
        xs_builtin = key in (jbc._BUILTIN_RADIX_W_XSLIVER_PEAKS if head == "peaks"
                             else jbc._BUILTIN_RADIX_W_XSLIVER)
        xs_set = key in (jbc._RADIX_W_XSLIVER_PEAKS if head == "peaks" else jbc._RADIX_W_XSLIVER)
        if xs_builtin and not xs_set:
            assert not tbc.radix_w_xsliver(bh, bw, kw, spec, f, head)
        else:
            assert tbc.radix_w_xsliver(bh, bw, kw, spec, f, head) == jbc.radix_w_xsliver(
                bh, bw, kw, spec, f, head), (key, head)
    assert seen == {True, False}
    # the override: re-registered with sliver='kernel', the plan runs v5
    assert not tbc.radix_w_xsliver(256, 512, 129)
    assert tbc.radix_w_xsliver(256, 1024, 129, head="peaks")
    # (32, 512, 9, 129) (Wc 257, Vh 24) no longer stacks on Hopper (the
    # stack ends at 168 bins; the DIF rule's W, a multiple of 512, is wider):
    # registered and legal, it is taken as JAX takes it
    assert jbc.radix_w_enabled(32, 512, 9, 129, 2) and tbc.radix_w_enabled(32, 512, 9, 129, 2)


def _routes(monkeypatch, plan, ops_shape, dtype=torch.float32):
    """The flags the tiled route passes the maps and the peaks wrapper at
    ``plan`` (a CPU call on zero spectra)."""
    seen = {}
    for name in ("block_conv", "block_conv_peaks"):
        real = getattr(tt, name)

        def rec(*a, _real=real, _name=name, **k):
            seen[_name] = tuple(bool(k.get(f)) for f in ("radix_h", "radix_w", "xsliver"))
            return _real(*a, **k)

        monkeypatch.setattr(tt, name, rec)
    bh, bw, kh, kw = plan
    b, f, n, nbh, nbw = ops_shape
    wc = bw // 2 + 1
    d = [torch.zeros((b, nbh, nbw, f, bh, wc), dtype=dtype) for _ in range(2)]
    k = [torch.zeros((n, f, bh, wc), dtype=dtype) for _ in range(2)]
    out = (nbh * (bh - kh + 1), nbw * (bw - kw + 1))
    tt.conv_blocks(*d, *k, *plan, *out)
    tt.conv_blocks_peaks(*d, *k, *plan, *out)
    return seen


def test_dispatch_follows_jax(monkeypatch, registries):
    """The production route picks the body as JAX's ``ops/tiled.py`` does:
    v4 wherever ``radix_h_legal`` holds (peaks: at float32 only), v5 or v5x
    for registered plans per head, v3 elsewhere and where the Hopper kernels
    stack the blocks."""
    v4_plan = (256, 511, 65, 128)  # the tuner's (4·Ke, 511) candidate at 64² kernels
    assert _routes(monkeypatch, v4_plan, (1, 1, 2, 1, 1)) == {
        "block_conv": (True, False, False), "block_conv_peaks": (True, False, False)}
    assert _routes(monkeypatch, v4_plan, (1, 1, 2, 1, 1), torch.bfloat16) == {
        "block_conv": (True, False, False), "block_conv_peaks": (False, False, False)}
    v5_plan = (256, 512, 65, 129)
    assert _routes(monkeypatch, v5_plan, (1, 1, 2, 1, 1))["block_conv"] == (True, False, False)
    tbc.register_radix_w_plan(256, 512, 129)
    tbc.register_radix_w_plan(256, 512, 129, head="peaks", sliver="xla")
    assert _routes(monkeypatch, v5_plan, (1, 1, 2, 1, 1)) == {
        "block_conv": (True, True, False), "block_conv_peaks": (True, True, True)}
    # registered at F=1 only
    assert _routes(monkeypatch, v5_plan, (1, 2, 2, 1, 1))["block_conv"] == (True, False, False)
    # a plan the Hopper kernels stack (Wc 129, Vh 24: 2 blocks a CTA) keeps
    # v3 though JAX's radix_h_legal holds; (32, 512, 9, 129), stacked before
    # the configuration's redesign, now runs v5 once registered
    stacked = (32, 256, 9, 129)
    assert tbc.radix_h_legal(32, 24) and tbc.blocks_per_cta(129, 24) == 2
    assert _routes(monkeypatch, stacked, (1, 1, 2, 1, 1)) == {
        "block_conv": (False, False, False), "block_conv_peaks": (False, False, False)}
    tbc.register_radix_w_plan(32, 512, 129)
    assert _routes(monkeypatch, (32, 512, 9, 129), (1, 1, 2, 1, 1)) == {
        "block_conv": (True, True, False), "block_conv_peaks": (True, False, False)}


@pytest.mark.parametrize("shape,kernel,f,store", [
    ((2048, 2048), 64, 1, "float32"),  # the headline and the detection headline
    ((512, 512), 12, 31, "bfloat16"),  # DPM
    ((1024, 1024), 32, 8, "bfloat16"),  # the F=8 tier
    ((2048, 2048), 512, 1, "float32"),  # 16 kernels of 512²
    ((512, 512), 9, 1, "float32"),  # the ragged cell array's buckets
    ((512, 512), 17, 1, "float32"),
    ((512, 512), 33, 1, "float32"),
    ((512, 512), 64, 1, "float32"),
])
def test_main_paths_stay_v3(shape, kernel, f, store):
    """Every plan ``choose_block_plan`` makes on the smoke's paths keeps
    v3: JAX's ``radix_h_legal`` is false at each (odd block heights, or a
    window starting at the half period), so no default route changes."""
    plan = tt.choose_block_plan(*shape, kernel, kernel, feature_dim=f, store_dtype=store,
                                device="cpu")
    if plan is None:
        return
    bh, bw, kh, kw = plan
    assert not tbc.radix_h_legal(bh, bh - kh + 1), plan
    for dtype in (torch.float32, torch.bfloat16):
        flags = tbc.radix_dispatch(bh, bw, kh, kw, dtype, f, tbc.fused_splits(dtype))
        assert flags == (False, False, False)


def test_flags_on_illegal_plans_raise(rng):
    """An explicit radix flag on a plan the JAX package's rules reject
    raises ValueError, as JAX asserts; ``radix_w`` implies ``radix_h``, and
    ``xsliver`` alone selects nothing."""
    illegal_h = (45, 151, 10, 24, 100, 300)
    ops = [torch.as_tensor(x) for x in _operands(rng, 1, 1, 2, *illegal_h)]
    for flags in BODIES.values():
        with pytest.raises(ValueError, match="radix_h"):
            tbc.block_conv(*ops, *illegal_h, **flags)
        with pytest.raises(ValueError, match="radix_h"):
            tbc.block_conv_peaks(*ops, *illegal_h, **flags)
    illegal_w = (80, 601, 17, 50, 200, 1100)
    ops = [torch.as_tensor(x) for x in _operands(rng, 1, 1, 2, *illegal_w)]
    tbc.block_conv(*ops, *illegal_w, radix_h=True)  # v4 is legal there
    with pytest.raises(ValueError, match="radix_w"):
        tbc.block_conv(*ops, *illegal_w, radix_w=True)
    with pytest.raises(ValueError, match="radix_w"):
        tbc.block_conv_peaks(*ops, *illegal_w, radix_w=True, xsliver=True)
    assert tbc._body(False, True, False) == "v5" and tbc._body(False, False, True) == "v3"


@pytest.mark.parametrize("splits", [3, 6, 1, tbc.BF16IO])
def test_radix_fits_is_the_one_block_configurations(splits):
    """``radix_fits``: the one-block 64- and 32-row configurations at the
    tier, not the stacked one; the pair and single chunks of a block cover
    its window once."""
    # RADIX_GEOM (Wc 257, Vh 24) runs the one-block configuration (the stack
    # ends at 168 bins); at Wc 129 the same window stacks 2 blocks a CTA
    assert tbc.radix_fits(257, 24, splits)
    assert tbc.radix_fits(257, 24, splits) == (tbc.blocks_per_cta(257, 24, splits) == 1)
    assert not tbc.radix_fits(129, 24, splits) and tbc.blocks_per_cta(129, 24, splits) == 2
    assert tbc.radix_fits(257, 192, splits) and tbc.radix_fits(513, 192, splits)
    for lh, vh in ((256, 192), (256, 200), (128, 96), (80, 64), (48, 40)):
        for rows in (64, 32):
            pairs, singles = tbc.radix_chunks(lh, vh, rows)
            m, w0 = lh // 2, lh - vh
            assert (pairs - 1) * rows // 2 < m - w0 <= pairs * rows // 2
            assert (singles - 1) * rows < w0 <= singles * rows
    assert tbc.radix_row_chunks(257, 256, 192, 3) == 2 + 1
