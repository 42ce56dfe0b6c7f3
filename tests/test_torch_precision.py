"""The fused kernels' precision tiers against the JAX package's.

``Config.fused_precision`` and ``Config.matmul_precision`` select the
arithmetic of the fused maps and peaks kernels as in JAX
(``cuda_fft_convolution_tpu/ops/block_conv.py:683-693``): at fp32 spectra
'bf16x3' runs 3×TF32, 'highest' the tier of ``matmul_precision`` —
'highest' 6×TF32, 'high' 3×TF32, 'default' one TF32 pass; bf16 spectra run
BF16IO (``tests/test_torch_bf16io.py``). Here, on the CPU:

  - the resolution rule against JAX's, over every setting and both spectra
    dtypes;
  - the n-way TF32 split (``ops/block_conv.py tf32_split``,
    ``tf32_product``) on the port's window matrices at the headline, DPM
    and 1024 blocks, against float64: 6×TF32 within 1.25× of IEEE fp32's
    own error (root mean square: the largest error of one sample is
    rounding noise that swings 0.7–1.5× between seeds) and within 1e-6 at
    its largest, 3×TF32 within 1e-6, one pass above the repo's 1e-5 bar
    and within the tier's 2e-3 (largest errors, relative to max |float64|);
  - the port's plain versions (what a CPU tensor runs at every tier)
    against JAX's Pallas kernels in interpret mode under the same config:
    maps within 1e-5 ('highest') or 2e-3 ('default'), equal peak indices,
    ``detect_top_k`` k = 1;
  - the shared-memory mirror and the operand planes per tier, the unfused
    branch where a tier does not fit, and plans and streams that take the
    tier of each call.

The CUDA entries of each tier are held to the plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_fft_convolution_torch as tfc
import cuda_fft_convolution_tpu as jfc
from cuda_fft_convolution_torch.models import detect_top_k
from cuda_fft_convolution_torch.ops import block_conv as tbc
from cuda_fft_convolution_torch.ops import tiled as tt
from cuda_fft_convolution_tpu.models import detect_top_k as j_top_k
from cuda_fft_convolution_tpu.ops import block_conv as jbc
from cuda_fft_convolution_tpu.ops import conv as jconv
from cuda_fft_convolution_tpu.ops import tiled as jt
from cuda_fft_convolution_tpu.ops.conv import rfft2_padded_planes as jrfft2

TOL = 1e-5  # the repo's fp32 bar
ONE_PASS_TOL = 2e-3  # the single-pass tier (JAX's DEFAULT, ~2e-3)
SPLIT_TOL = 1e-6  # 3×TF32 on the window matrices
X6_RATIO = 1.25  # 6×TF32 against IEEE fp32's own error


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rms(got, want) -> float:
    d = np.asarray(got, np.float64) - want
    return float(np.sqrt((d**2).mean() / (np.asarray(want) ** 2).mean()))


@pytest.fixture
def tier():
    """Set the same precision fields on both packages; restore both."""
    fields = ("use_fused_block_conv", "fused_precision", "matmul_precision")
    t_before, j_before = tfc.get_config(), jfc.get_config()
    saved = {f: getattr(j_before, f) for f in fields}

    def set_both(**kw):
        tfc.set_config(**kw)
        jfc.set_config(**kw)

    yield set_both
    tfc.set_config(**{f: getattr(t_before, f) for f in fields})
    jfc.set_config(**saved)


# ---- the resolution rule ----

# JAX's precision → the port's tier (TF32 products per product)
_JAX_TIERS = {jbc.BF16X3: 3, jax.lax.Precision.HIGHEST: 6, jax.lax.Precision.HIGH: 3,
              jax.lax.Precision.DEFAULT: 1}


def _jax_precision(dtype):
    """The precision JAX's block_conv_pallas resolves for spectra of
    ``dtype`` under the current config (ops/block_conv.py:682-693)."""
    if dtype == jnp.bfloat16:
        return jbc.BF16IO
    fp = jfc.get_config().fused_precision
    return jbc.BF16X3 if fp == jbc.BF16X3 else jconv._matmul_precision()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("matmul", ["highest", "high", "default"])
@pytest.mark.parametrize("fused", ["bf16x3", "highest"])
def test_fused_splits_is_the_jax_rule(tier, fused, matmul, dtype):
    tier(fused_precision=fused, matmul_precision=matmul)
    got = tbc.fused_splits(getattr(torch, dtype))
    want = _jax_precision(getattr(jnp, dtype))
    if dtype == "bfloat16":
        assert want == jbc.BF16IO and got == tbc.BF16IO  # JAX's single bf16 pass
    else:
        assert got == _JAX_TIERS[want]
    table = {"bf16x3": 3, "highest": {"highest": 6, "high": 3, "default": 1}[matmul]}
    assert got == (tbc.BF16IO if dtype == "bfloat16" else table[fused])


def test_fused_precision_highest_from_the_environment():
    """``FFTCONV_FUSED_PRECISION=highest`` imports (the config is read at
    import) and selects 6×TF32, as JAX's ``Config.from_env`` reads it."""
    env = dict(os.environ, FFTCONV_FUSED_PRECISION="highest",
               FFTCONV_MATMUL_PRECISION="highest")
    code = ("import torch, cuda_fft_convolution_torch as f\n"
            "from cuda_fft_convolution_torch.ops.block_conv import fused_splits\n"
            "print(f.get_config().fused_precision, fused_splits(torch.float32))")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["highest", "6"]


# ---- the n-way split on the port's window matrices ----

GEOMETRIES = [
    (127, 447, 64, 64, 1),  # the headline plan
    (27, 139, 12, 12, 31),  # the DPM plan
    (1024, 1024, 64, 64, 1),  # the planner's largest block
]


def _synthesis(rng, bh, bw, kh, kw, f):
    """(G as [Gr | −Gi ; Gi | Gr] halves, S stacked [Sr ; Si], M stacked
    [Mr ; Mi], the float64 tile) on the port's window matrices and a
    random fp32 S summed over ``f`` channels."""
    gr, gi, mr, mi = tbc._window_mats(bh, bw, kh, kw, "cpu")
    wc = bw // 2 + 1

    def planes():
        return (rng.standard_normal((f, bh, wc), dtype=np.float32)
                + 1j * rng.standard_normal((f, bh, wc), dtype=np.float32)).astype(np.complex64)

    s = (planes() * planes()).sum(0).astype(np.complex64)
    s_k = torch.from_numpy(np.concatenate([s.real, s.imag]))
    g = (torch.cat([gr, -gi], 1), torch.cat([gi, gr], 1))
    m = torch.cat([mr, mi])
    g64 = gr.double().numpy() + 1j * gi.double().numpy()
    x64 = g64 @ s.astype(np.complex128)
    want = x64.real @ mr.double().numpy() + x64.imag @ mi.double().numpy()
    return g, s_k, m, want


def _tile(g, s_k, m, product):
    xr, xi = product(g[0], s_k), product(g[1], s_k)
    return product(torch.cat([xr, xi], 1), m).numpy()


@pytest.mark.parametrize("bh,bw,kh,kw,f", GEOMETRIES)
def test_split_tiers_on_the_window_matrices(rng, bh, bw, kh, kw, f):
    g, s_k, m, want = _synthesis(rng, bh, bw, kh, kw, f)
    fp32 = _tile(g, s_k, m, torch.matmul)
    tiles = {s: _tile(g, s_k, m, lambda a, b, s=s: tbc.tf32_product(a, b, s)) for s in tbc.TIERS}
    err = {s: _rel(t, want) for s, t in tiles.items()}
    assert _rms(tiles[6], want) <= X6_RATIO * _rms(fp32, want), (err, _rel(fp32, want))
    assert err[6] <= SPLIT_TOL, err
    assert err[3] <= SPLIT_TOL, err
    assert TOL < err[1] <= ONE_PASS_TOL, err


def _rna(x) -> np.ndarray:
    """An emulation independent of the port's: float32 ``x`` to TF32,
    nearest, ties away from zero (add 0x1000 to the bits, clear 13)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("pieces", [1, 2, 3])
def test_tf32_split_pieces(rng, pieces):
    """The pieces are TF32, each the rounding of what the earlier ones
    leave, and sum to x within the tier's reach: 2^-10 (one), 2^-21 (two),
    2^-32 (three) relative."""
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(np.float32)
    got = [p.numpy() for p in tbc.tf32_split(torch.from_numpy(x), pieces)]
    rest = x.copy()
    for p in got:
        assert not (p.view(np.uint32) & 0x1FFF).any()
        assert np.array_equal(p, _rna(rest))
        rest = (rest - p).astype(np.float32)
    total = np.sum([p.astype(np.float64) for p in got], axis=0)
    reach = {1: 2.0**-10, 2: 2.0**-21, 3: 2.0**-32}[pieces]
    assert (np.abs(total - x) <= reach * np.abs(x)).all()


def test_tf32_product_three_passes_is_the_split_product(rng):
    """At 3×TF32 the emulation is a_lo·b_hi + a_hi·b_lo + a_hi·b_hi in that
    order (the kernels' and ``tests/test_torch_tf32x3.py``'s)."""
    a = rng.standard_normal((40, 70)).astype(np.float32)
    b = rng.standard_normal((70, 30)).astype(np.float32)
    ah, bh = _rna(a), _rna(b)
    al, bl = _rna(a - ah), _rna(b - bh)
    mm = [torch.from_numpy(x) @ torch.from_numpy(y) for x, y in ((al, bh), (ah, bl), (ah, bh))]
    want = ((torch.zeros(40, 30) + mm[0]) + mm[1]) + mm[2]
    got = tbc.tf32_product(torch.from_numpy(a), torch.from_numpy(b), 3)
    assert torch.equal(got, want)
    hi = tbc.tf32_product(torch.from_numpy(a), torch.from_numpy(b), 1)
    assert torch.equal(hi, torch.zeros(40, 30) + torch.from_numpy(ah) @ torch.from_numpy(bh))


# ---- the plain versions against JAX's Pallas kernels ----


def _spectra(rng, b=1, f=2, n=3, bh=20, bw=36, kh=5, kw=7, h=60, w=80):
    """JAX block spectra of random data ('full' extent) and JAX bank
    spectra, as numpy planes, with the geometry of a conv_blocks call."""
    x = rng.standard_normal((b, f, h, w)).astype(np.float32)
    k = rng.standard_normal((n, f, kh, kw)).astype(np.float32)
    d = jt.fft_data_blocks(jnp.asarray(x), bh, bw, kh, kw)
    kk = jrfft2(jnp.asarray(k), bh, bw)
    return [np.array(p) for p in (*d, *kk)], (bh, bw, kh, kw, h + kh - 1, w + kw - 1)


@pytest.mark.parametrize("matmul,bar", [("highest", TOL), ("default", ONE_PASS_TOL)])
def test_fused_maps_at_the_tier_match_jax(rng, tier, matmul, bar):
    planes, geom = _spectra(rng)
    tier(use_fused_block_conv=True, fused_precision="highest", matmul_precision=matmul)
    want = jt.conv_blocks(*map(jnp.asarray, planes), *geom)
    got = tt.conv_blocks(*map(torch.as_tensor, planes), *geom)
    assert tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= bar


@pytest.mark.parametrize("matmul,bar", [("highest", TOL), ("default", ONE_PASS_TOL)])
def test_fused_peaks_at_the_tier_match_jax(rng, tier, matmul, bar):
    planes, geom = _spectra(rng, b=2, n=4)
    tier(use_fused_block_conv=True, fused_precision="highest", matmul_precision=matmul)
    jv, jy, jx = jt.conv_blocks_peaks(*map(jnp.asarray, planes), *geom)
    v, y, x = tt.conv_blocks_peaks(*map(torch.as_tensor, planes), *geom)
    assert v.shape == (2, 4)
    assert _rel(v.numpy(), jv) <= bar
    assert np.array_equal(y.numpy(), jy) and np.array_equal(x.numpy(), jx)


@pytest.mark.parametrize("matmul,bar", [("highest", TOL), ("default", ONE_PASS_TOL)])
def test_detect_top_k_one_at_the_tier_matches_jax(rng, tier, matmul, bar):
    data = rng.standard_normal((60, 70, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 5, 7, 2)).astype(np.float32)
    tier(use_fused_block_conv=True, fused_precision="highest", matmul_precision=matmul)
    kw = dict(mode="same", algorithm="tiled")
    gv, gp = detect_top_k(data, bank, 1, **kw, device="cpu")
    wv, wp = j_top_k(data, bank, 1, **kw)
    assert np.array_equal(gp.numpy(), np.asarray(wp))
    assert _rel(gv.numpy(), wv) <= bar


@pytest.mark.parametrize("field,value", [
    ("matmul_precision", "high"), ("matmul_precision", "default"),
    ("inverse_precision", "high"), ("inverse_precision", "default"),
])
def test_transform_precisions_change_nothing_off_the_tpu(rng, field, value):
    """``matmul_precision`` and ``inverse_precision`` select the tiers of
    JAX's MXU-DFT transforms, which it takes only on a TPU
    (``cuda_fft_convolution_tpu/ops/dft.py:256-267``): the port's direct
    engine (``torch.fft``) gives the same maps bitwise, and JAX's under the
    same config on the CPU agrees."""
    data = rng.standard_normal((40, 50, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 6, 5, 2)).astype(np.float32)
    kw = dict(kernels=bank, mode="same", algorithm="direct")
    want = tfc.fft_conv(data, **kw, device="cpu")
    t_before, j_before = tfc.get_config(), getattr(jfc.get_config(), field)
    try:
        tfc.set_config(**{field: value})
        jfc.set_config(**{field: value})
        got = tfc.fft_conv(data, **kw, device="cpu")
        jax_maps = np.asarray(jfc.fft_conv(data, **kw))
    finally:
        tfc.set_config(**{field: getattr(t_before, field)})
        jfc.set_config(**{field: j_before})
    assert torch.equal(got, want)
    assert _rel(got.numpy(), jax_maps) <= TOL


# ---- the mirror, the operands and the dispatch per tier ----


@pytest.mark.parametrize("splits", [3, 6, 1])
def test_smem_within_the_limit_wherever_admitted(splits):
    """Wherever ``fused_dispatch_auto`` admits a geometry at a tier, the
    tier's configuration fits; the configuration is one of the three."""
    admitted = 0
    for wc in [*range(1, 800, 9), 224, 256, 257, 320, 321, 385, 513, 577, 609]:
        for vh in (1, 2, 7, 16, 21, 32, 33, 64, 961):
            bw = 2 * (wc - 1)
            if not tt.fused_dispatch_auto(bw, torch.float32, vh, splits):
                assert tbc.smem_bytes(bw // 2 + 1, vh, splits) > tbc.SMEM_LIMIT_BYTES
                continue
            admitted += 1
            wc_ = bw // 2 + 1
            assert tbc.smem_bytes(wc_, vh, splits) <= tbc.SMEM_LIMIT_BYTES
            rows, g = tbc.tile_rows(wc_, vh, splits), tbc.blocks_per_cta(wc_, vh, splits)
            assert rows in (32, 64) and (g == 1 or rows == 64)
            assert tbc.row_chunks(wc_, vh, splits) == (1 if g > 1 else -(-vh // rows))
    assert admitted > 500


def test_smem_per_tier_at_the_plans():
    """The headline (Wc 224) stays on 64 rows at every tier; 6×TF32 holds
    three planes of M^T in the ring (64 × 452 + 24,576 floats); the 1024
    block (Wc 513) runs a pair of 64-row CTAs of 256 bins each, at 6×TF32
    with M^T's three planes in the ring and the 256-float sliver; the DPM
    plan stacks 4 blocks at every tier; Wc 301 takes a pair at 6×TF32."""
    assert tbc.smem_bytes(224, 64) == 181248  # unchanged
    assert tbc.smem_bytes(224, 64, 6) == 4 * (64 * 452 + 2 * 3 * 4096) == 214016
    assert tbc.smem_bytes(224, 64, 1) == 4 * (64 * 452 + 2 * 4096) == 148480
    assert tbc.tile_rows(513, 961, 6) == 64 and tbc.cluster_size(513, 961, 6) == 2
    assert tbc.smem_bytes(513, 961, 6) == 4 * (64 * 516 + 2 * 3 * 4096 + 256) == 231424
    assert all(tbc.blocks_per_cta(70, 16, s) == 4 for s in tbc.TIERS)
    assert tbc.tile_rows(301, 64, 3) == 64 and tbc.cluster_size(301, 64, 3) == 1
    assert tbc.tile_rows(301, 64, 6) == 64 and tbc.pair_bins(301, 64, 6) == 192


def test_a_tier_that_does_not_fit_runs_unfused(rng, tier, monkeypatch):
    """Blocks 1200 wide (Wc 601) fit the 32-row configuration at 3×TF32 but
    not at 6×TF32: under 'highest' the auto dispatch takes the unfused
    branch, decided before any launch, with the same maps."""
    assert tt.fused_dispatch_auto(1200, torch.float32, 16, 3)
    assert not tt.fused_dispatch_auto(1200, torch.float32, 16, 6)
    calls = []
    real = tt.block_conv
    monkeypatch.setattr(tt, "block_conv", lambda *a, **k: calls.append(a[-1]) or real(*a, **k))
    planes, geom = _spectra(rng, n=2, bh=20, bw=1200, kh=5, kw=7, h=30, w=1300)
    ops = [torch.as_tensor(p) for p in planes]
    fused = tt.conv_blocks(*ops, *geom)
    assert calls == [3]
    tier(fused_precision="highest", matmul_precision="highest")
    unfused = tt.conv_blocks(*ops, *geom)
    assert calls == [3]
    assert _rel(unfused.numpy(), fused.numpy()) <= TOL


@pytest.mark.parametrize("splits,planes", [(3, 2), (6, 3), (1, 1)])
def test_kernel_mats_planes_per_tier(splits, planes):
    """M^T's planes are the tier's TF32 pieces (the default tier's hi and lo
    unchanged), also in the pair's operand (the 1024 block), whose pieces
    at 6×TF32 sum to M^T exactly; the tier is part of the operands' cache
    key."""
    m3 = tbc.m_core(tbc._kernel_mats(127, 447, 64, 64, "cpu")[3])
    m6 = tbc.m_core(tbc._kernel_mats(127, 447, 64, 64, "cpu", 6)[3])
    m = tbc.m_core(tbc._kernel_mats(127, 447, 64, 64, "cpu", splits)[3])
    assert m.shape[0] == planes and m.shape[1:] == m3.shape[1:]
    assert torch.equal(m[:2], m3[: min(planes, 2)] if splits != 1 else m3[:1])
    if splits == 3:
        assert torch.equal(m, m3)
    # the pieces sum to M^T within the tier's reach (three: fp32-exact)
    exact = m6.double().sum(0)
    reach = {1: 2.0**-10, 3: 2.0**-21, 6: 0.0}[splits]
    assert (m.double().sum(0) - exact).abs().max() <= reach * exact.abs().max()
    wide = tbc._kernel_mats(1024, 1024, 64, 64, "cpu", splits)[3]
    # the pair: K = 4 × 256 (rank 0's [Mr | Mi], rank 1's), 961 columns in
    # 8 passes of 128, then the sliver's 2 × 1024 + 1024 + 4 floats
    main = planes * 1024 * 1024
    assert wide.ndim == 1 and wide.numel() == main + 2 * 1024 + 1024 + 4
    if splits == 6:
        core = tbc.m_core(wide[:main].reshape(8, 32, planes, 16, 8, 8, 4))
        raw = core.permute(0, 1, 3, 2, 4).reshape(planes, 1024, 1024).double().sum(0)
        _, _, mr1, mi1 = tbc._window_mats(1024, 1024, 64, 64, "cpu")
        assert torch.equal(raw[: mr1.shape[1], :256], mr1[:256].t().double())
        assert torch.equal(raw[: mr1.shape[1], 256:512], mi1[:256].t().double())


def _recording(monkeypatch):
    """Record the tier of every maps and peaks wrapper call of ops.tiled."""
    seen = []
    for name in ("block_conv", "block_conv_peaks"):
        real = getattr(tt, name)

        def rec(*a, _real=real, **k):
            seen.append(a[-1])
            return _real(*a, **k)

        monkeypatch.setattr(tt, name, rec)
    return seen


def test_plans_and_streams_take_the_tier_of_each_call(rng, tier, monkeypatch):
    """A plan and a stream built (and warmed) under the default tier run
    6×TF32 once 'highest' is set, and one pass under 'default': the tier is
    read at each call, as JAX re-traces on a config change."""
    seen = _recording(monkeypatch)
    data = rng.standard_normal((64, 80, 1)).astype(np.float32)
    bank = rng.standard_normal((3, 9, 9, 1)).astype(np.float32)
    plan = tfc.make_plan(data.shape, bank.shape, algorithm="tiled", mode="same", device="cpu")
    peaks = tfc.make_plan(data.shape, bank.shape, algorithm="tiled", mode="same",
                          head="peaks", device="cpu")
    assert seen and set(seen) == {3}
    want = plan.execute(data, bank)
    seen.clear()
    tier(fused_precision="highest", matmul_precision="highest")
    got = plan.execute(data, bank)
    peaks.execute(data, bank)
    assert seen == [6, 6]
    seen.clear()
    with tfc.ConvStream.create(data.shape, bank, algorithm="tiled", mode="same",
                               depth=2, device="cpu") as stream:
        streamed = stream.submit(data).result()
        assert seen and set(seen) == {6}
        seen.clear()
        tier(matmul_precision="default")
        stream.submit(data).result()
    assert seen == [1]
    assert torch.equal(got, want) and torch.equal(streamed, want)  # plain versions
