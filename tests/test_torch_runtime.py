"""The port's plans and block-geometry table against the JAX package's
(``cuda_fft_convolution_tpu/runtime/plan.py`` and ``autotune.py``), on the
CPU at the JAX tests' own shapes (``tests/test_runtime.py``): each port
call holds the JAX function of the same name on the same numpy inputs,
within 1e-5 scale-relative at float32 and 2e-2 at the bf16 tier, and the
JAX tests' own checks. Port-only: the table is keyed by device name, its
builtin table is empty, and a foreign or unreadable cache is not applied."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_fft_convolution_torch as tfc
from cuda_fft_convolution_torch.ops import tiled as tt
from cuda_fft_convolution_torch.runtime import autotune as ta
from cuda_fft_convolution_tpu.runtime import autotune as ja
from cuda_fft_convolution_tpu.runtime import make_plan as j_make_plan
from tests.oracles import fft_conv_full_f64, rel_err

TOL = 1e-5
BF16_TOL = 2e-2
CPU = dict(device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _scaled(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture
def table(monkeypatch):
    """Both packages' measured tables and cache state, cleared before and
    after the test; no cache file unless the test sets one."""
    monkeypatch.delenv("FFTCONV_AUTOTUNE_CACHE", raising=False)
    for mod in (ta, ja):
        mod._MEASURED.clear()
        mod._user_cache_loaded = False
    yield
    for mod in (ta, ja):
        mod._MEASURED.clear()
        mod._user_cache_loaded = False


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


def test_aot_plan_matches_api(rng):
    data = rng.standard_normal((32, 24, 2)).astype(np.float32)
    kerns = rng.standard_normal((3, 5, 7, 2)).astype(np.float32)
    plan = tfc.make_plan(data.shape, kerns.shape, **CPU)
    jplan = j_make_plan(data.shape, kerns.shape)
    got = plan.execute(data, kerns)
    assert got.device.type == "cpu"
    assert _scaled(got, tfc.fft_conv(data, kernels=kerns, **CPU)) < TOL
    assert _scaled(got, jplan.execute(data, kerns)) < TOL
    dfft, kfft = plan.data_fft(data), plan.kernel_fft(kerns)
    assert tuple(kfft[0].shape) == plan.kfft_aval.shape == tuple(jplan.kfft_aval.shape)
    assert _scaled(plan.execute_spectral(dfft, kfft), got) < TOL
    for mine, theirs in zip((*dfft, *kfft), (*jplan.data_fft(data), *jplan.kernel_fft(kerns))):
        assert _scaled(mine, theirs) < TOL


def test_aot_plan_batched_and_correlation(rng):
    data = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    kerns = rng.standard_normal((4, 3, 3, 1)).astype(np.float32)
    got = tfc.make_plan(data.shape, kerns.shape, correlation=True, **CPU).execute(data, kerns)
    assert tuple(got.shape[:2]) == (2, 4)
    flipped = np.ascontiguousarray(kerns[:, ::-1, ::-1, :])
    np.testing.assert_allclose(_np(got), _np(tfc.fft_conv(data, kernels=flipped, **CPU)),
                               atol=1e-6)
    want = j_make_plan(data.shape, kerns.shape, correlation=True).execute(data, kerns)
    assert _scaled(got, want) < TOL


def test_aot_plan_shape_validation(rng):
    data = rng.standard_normal((16, 16, 1)).astype(np.float32)
    kerns = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    plan = tfc.make_plan(data.shape, kerns.shape, **CPU)
    with pytest.raises(ValueError):
        plan.execute(data[:8], kerns)
    with pytest.raises(ValueError):
        plan.execute(data, kerns[:, :2])
    with pytest.raises(ValueError, match="feature dim"):
        tfc.make_plan((16, 16, 2), kerns.shape, **CPU)
    with pytest.raises(ValueError, match="algorithm"):
        tfc.make_plan(data.shape, kerns.shape, algorithm="fft", **CPU)


def test_plan_full_window_correct(rng):
    data = rng.standard_normal((20, 20, 3)).astype(np.float32)
    kerns = rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
    maps = _np(tfc.make_plan(data.shape, kerns.shape, **CPU).execute(data, kerns))
    for i in range(2):
        assert rel_err(maps[i][:24, :24], fft_conv_full_f64(data, kerns[i])) < TOL
    want = j_make_plan(data.shape, kerns.shape).execute(data, kerns)
    assert _scaled(maps, want) < TOL


def test_aot_plan_tiled(rng):
    data = rng.standard_normal((80, 70, 2)).astype(np.float32)
    kerns = rng.standard_normal((3, 6, 6, 2)).astype(np.float32)
    plan = tfc.make_plan(data.shape, kerns.shape, algorithm="tiled", mode="full", **CPU)
    got = _np(plan.execute(data, kerns))
    assert got.shape == (3, 85, 75)
    for i in range(3):
        assert rel_err(got[i], fft_conv_full_f64(data, kerns[i])) < TOL
    got2 = plan.execute_spectral(plan.data_fft(data), plan.kernel_fft(kerns))
    np.testing.assert_allclose(_np(got2), got, atol=1e-6)
    jplan = j_make_plan(data.shape, kerns.shape, algorithm="tiled", mode="full")
    assert _scaled(got, jplan.execute(data, kerns)) < TOL


def test_aot_plan_tiled_batched(rng):
    data = rng.standard_normal((2, 60, 60, 1)).astype(np.float32)
    kerns = rng.standard_normal((2, 5, 5, 1)).astype(np.float32)
    plan = tfc.make_plan(data.shape, kerns.shape, algorithm="tiled", mode="same", **CPU)
    got = plan.execute(data, kerns)
    assert tuple(got.shape) == (2, 2, 60, 60)
    want = tfc.fft_conv(data, kernels=kerns, mode="same", algorithm="direct", **CPU)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-4)
    jwant = j_make_plan(data.shape, kerns.shape, algorithm="tiled", mode="same").execute(
        data, kerns)
    assert _scaled(got, jwant) < TOL


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("off", ["scipy", "matlab"])
def test_plan_direct_linear_modes(rng, mode, off):
    data = rng.standard_normal((20, 22, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 4, 5, 2)).astype(np.float32)
    kw = dict(algorithm="direct", mode=mode, same_offset=off)
    got = tfc.make_plan((20, 22, 2), (3, 4, 5, 2), **kw, **CPU).execute(data, bank)
    want = tfc.fft_conv(data, kernels=bank, mode=mode, algorithm="direct",
                        same_offset=off, **CPU)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)
    assert _scaled(got, j_make_plan((20, 22, 2), (3, 4, 5, 2), **kw).execute(data, bank)) < TOL


@pytest.mark.parametrize("algorithm", ["direct", "tiled"])
def test_plan_bf16_tier_and_bf16_maps(rng, algorithm):
    """store_dtype='bfloat16': the spectra ABI is bf16 planes; with
    out_dtype='bfloat16' the maps are bf16 — each within 2e-2 of the JAX
    plan at the same tier."""
    data = rng.standard_normal((40, 36, 3)).astype(np.float32)
    bank = rng.standard_normal((4, 5, 5, 3)).astype(np.float32)
    kw = dict(algorithm=algorithm, mode="same", store_dtype="bfloat16")
    plan = tfc.make_plan(data.shape, bank.shape, **kw, **CPU)
    assert plan.kfft_aval.dtype == torch.bfloat16
    assert plan.kernel_fft(bank)[0].dtype == torch.bfloat16
    want = j_make_plan(data.shape, bank.shape, **kw).execute(data, bank)
    assert _scaled(plan.execute(data, bank), want) < BF16_TOL
    maps16 = tfc.make_plan(data.shape, bank.shape, out_dtype="bfloat16", **kw,
                           **CPU).execute(data, bank)
    assert maps16.dtype == torch.bfloat16
    assert _scaled(maps16, want) < BF16_TOL


def test_aot_plan_lazy_compiles_on_demand(rng):
    """lazy=True defers each stage's warm-up to its first use and gives the
    eager plan's maps bit for bit; compile_now() warms the rest."""
    data = rng.standard_normal((40, 52, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 7, 5, 2)).astype(np.float32)
    lazy = tfc.make_plan(data.shape, bank.shape, mode="same", lazy=True, **CPU)
    assert lazy._data_fft_exec is None
    assert lazy._kernel_fft_exec is None
    assert lazy._conv_exec is None
    eager = tfc.make_plan(data.shape, bank.shape, mode="same", **CPU)
    assert eager._conv_exec is not None
    kfft = lazy.kernel_fft(bank)
    assert lazy._kernel_fft_exec is not None
    assert lazy._data_fft_exec is None and lazy._conv_exec is None
    out_lazy = lazy.execute_spectral(lazy.data_fft(data), kfft)
    assert lazy._data_fft_exec is not None and lazy._conv_exec is not None
    assert torch.equal(out_lazy, eager.execute(data, bank))
    assert lazy.compile_now() is lazy
    fresh = tfc.make_plan(data.shape, bank.shape, mode="same", algorithm="tiled",
                          lazy=True, **CPU).compile_now()
    assert fresh._conv_exec is not None
    jlazy = j_make_plan(data.shape, bank.shape, mode="same", lazy=True)
    assert _scaled(out_lazy, jlazy.execute(data, bank)) < TOL


def test_plan_needs_a_device_or_cpu():
    """Without a card a plan asks for device='cpu' (the port's device
    rule) rather than running elsewhere."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: make_plan takes it")
    with pytest.raises(tfc.InvalidInputError, match="device='cpu'"):
        tfc.make_plan((16, 16, 1), (2, 3, 3, 1))


# ---------------------------------------------------------------------------
# the geometry table
# ---------------------------------------------------------------------------


def test_autotune_table_lookup_and_registration(table):
    """Registration keys by pow-2 envelope and feature bucket, as in JAX;
    choose_block_fft consults the table before the analytic rule."""
    for mod in (ta, ja):
        mod.register_tuned_geometry(200, 200, 48, 192, f=1)
    for args in [(200, 200, 1), (140, 250, 1), (200, 200, 31), (512, 512, 1)]:
        assert ta.lookup_tuned_geometry(*args) == ja.lookup_tuned_geometry(*args)
    assert ta.lookup_tuned_geometry(140, 250, 1) == (48, 192, False)
    assert ta.lookup_tuned_geometry(512, 512, 1) is None
    blk = tt.choose_block_fft(4096, 4096, 200, 200, matmul_engine=True)
    assert blk == (48 + 199, 192 + 199)
    from cuda_fft_convolution_tpu.ops.tiled import choose_block_fft as j_choose

    assert blk == j_choose(4096, 4096, 200, 200, matmul_engine=True)
    # ...but declines when the tuned block doesn't fit the image
    assert tt.choose_block_fft(200, 200, 200, 200, matmul_engine=True) != blk


def test_autotune_dtype_keys_and_fallback(table, tmp_path, monkeypatch):
    """The tier and head are in the key: bf16 falls back to f32, a non-conv
    head to the conv entry; the cache round-trips the keys."""
    reg = [
        ((200, 200, 48, 192), dict(f=1)),
        ((200, 200, 96, 384), dict(f=1, fused=True, block_h=160, block_w=511,
                                    store_dtype="bfloat16")),
        ((100, 100, 40, 256), dict(f=1, head="peaks")),
    ]
    lookups = [(200, 200, 1), (200, 200, 1, "bfloat16"), (200, 200, 1, "f32", "peaks"),
               (100, 100, 1, "float32", "peaks"), (100, 100, 1)]
    for mod in (ta, ja):
        for args, kw in reg[:1]:
            mod.register_tuned_geometry(*args, **kw)
    assert ta.lookup_tuned_geometry(200, 200, 1, "bfloat16") == (48, 192, False)
    for mod in (ta, ja):
        for args, kw in reg[1:]:
            mod.register_tuned_geometry(*args, **kw)
    want = [ja.lookup_tuned_geometry(*a) for a in lookups]
    assert [ta.lookup_tuned_geometry(*a) for a in lookups] == want
    assert want[1] == (96, 384, True, 160, 511) and want[4] is None
    monkeypatch.setenv("FFTCONV_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    ta.save_user_cache()
    ta._MEASURED.clear()
    ta._user_cache_loaded = False
    assert [ta.lookup_tuned_geometry(*a) for a in lookups] == want


def test_autotune_multi_f_bucket(table):
    """2 <= F < 8 is its own bucket and falls back to F = 1; F >= 8 does
    not; user bucket-2 entries override — the JAX chain, on registrations
    (the port has no builtin entries)."""
    for mod in (ta, ja):
        mod.register_tuned_geometry(300, 300, 64, 384, f=1, fused=True,
                                    block_h=575, block_w=767)
    for f in (1, 2, 4, 7, 8):
        assert ta.lookup_tuned_geometry(300, 300, f) == ja.lookup_tuned_geometry(300, 300, f)
    assert ta.lookup_tuned_geometry(300, 300, 5)[4] == 767
    assert ta.lookup_tuned_geometry(300, 300, 8) is None
    for mod in (ta, ja):
        mod.register_tuned_geometry(300, 300, 48, 192, f=3, fused=False)
    assert ta.lookup_tuned_geometry(300, 300, 5) == (48, 192, False)
    assert ta.lookup_tuned_geometry(300, 300, 5) == ja.lookup_tuned_geometry(300, 300, 5)
    assert ta.lookup_tuned_geometry(300, 300, 1)[4] == 767


def test_autotune_live_measure_cpu(table, tmp_path, monkeypatch):
    """The tuner measures its candidates on the CPU when asked, registers
    the winner under "cpu" with its blocks and fused flag, and the cache
    round-trips it; the JAX tuner registers the same geometry for the same
    single candidate."""
    best, timings = ta.autotune_block_geometry(
        (96, 96, 1), 5, 5, n_kernels=4, candidates=[(16, 32), (32, 32)], iters=1,
        device="cpu",
    )
    assert best in timings and len(timings) == 2
    vh, vw = best
    want = (vh, vw, tt.fused_dispatch_auto(vw + 4, torch.float32, vh), vh + 4, vw + 4)
    assert ta.lookup_tuned_geometry(5, 5, 1, device="cpu") == want
    cache = tmp_path / "tune.json"
    monkeypatch.setenv("FFTCONV_AUTOTUNE_CACHE", str(cache))
    ta.save_user_cache()
    assert json.loads(cache.read_text()) == {"devices": {"cpu": {"8,8,1,f32": list(want)}}}
    ta._MEASURED.clear()
    ta._user_cache_loaded = False
    assert ta.lookup_tuned_geometry(5, 5, 1, device="cpu") == want
    monkeypatch.delenv("FFTCONV_AUTOTUNE_CACHE")
    jbest, _ = ja.autotune_block_geometry((96, 96, 1), 5, 5, n_kernels=4,
                                          candidates=[best], iters=1, sweep_groups=False)
    assert jbest == best
    assert ja.lookup_tuned_geometry(5, 5, 1)[:2] == want[:2]
    assert ja.lookup_tuned_geometry(5, 5, 1)[3:] == want[3:]


def test_autotune_roundtrip_preserves_fused_plan(table, rng):
    """tune → register → lookup → choose_block_plan keeps explicit blocks
    (an enlarged envelope), and fft_conv at that plan is right."""
    best, _ = ta.autotune_block_geometry(
        (128, 256, 1), 9, 9, n_kernels=2, candidates=[(24, 120, 40, 160)], iters=1,
        device="cpu",
    )
    assert best == (24, 120, 40, 160)
    hit = ta.lookup_tuned_geometry(9, 9, 1, device="cpu")
    assert hit[:2] == (24, 120) and hit[3:] == (40, 160)
    plan = tt.choose_block_plan(1024, 1024, 9, 9, matmul_engine=True, device="cpu")
    assert plan == (40, 160, 40 - 24 + 1, 160 - 120 + 1)
    ja.autotune_block_geometry((128, 256, 1), 9, 9, n_kernels=2,
                               candidates=[(24, 120, 40, 160)], iters=1,
                               sweep_groups=False)
    from cuda_fft_convolution_tpu.ops.tiled import choose_block_plan as j_choose

    assert plan == j_choose(1024, 1024, 9, 9, matmul_engine=True)
    data = rng.standard_normal((300, 280, 1)).astype(np.float32)
    bank = rng.standard_normal((2, 9, 9, 1)).astype(np.float32)
    got = tfc.fft_conv(data, kernels=bank, mode="full", algorithm="tiled", **CPU)
    for i in range(2):
        assert rel_err(_np(got[i]), fft_conv_full_f64(data, bank[i])) < TOL


@pytest.mark.parametrize("k", [5, 8, 9, 12, 32, 33, 64, 100, 128, 200, 512])
def test_default_candidates_match_jax(k):
    """The candidate list is the JAX list; its plain candidates keep the
    Hermitian width a multiple of 128."""
    cands = ta.default_candidates(k, k)
    assert cands == ja.default_candidates(k, k)
    for c in cands:
        if len(c) == 2:
            assert ((c[1] + k - 1) // 2 + 1) % 128 == 0 and c[1] >= 128
    if k == 64:
        assert (192, 384, 256, 511) in cands


def test_builtin_table_empty_and_headline_unchanged(table):
    """No geometry measured on another device ships: the headline plan is
    the analytic (127, 447, 64, 64) on the CPU and on any CUDA device."""
    assert ta._BUILTIN == {}
    assert ja.lookup_tuned_geometry(64, 64, 1) is not None  # JAX's v5e seed
    for dev in ("cpu", None):
        assert ta.lookup_tuned_geometry(64, 64, 1, device=dev) is None
        assert tt.choose_block_plan(2048, 2048, 64, 64, device=dev) == (127, 447, 64, 64)
    assert tt.choose_block_plan(
        512, 512, 12, 12, feature_dim=31, store_dtype="bfloat16", head="peaks",
        device="cpu") == (27, 139, 12, 12)


def test_entry_of_another_device_not_applied(table, monkeypatch):
    """An entry is applied only on a device of its own name."""
    ta.register_tuned_geometry(64, 64, 192, 384, fused=True, block_h=256, block_w=511,
                               device="cpu")
    assert tt.choose_block_plan(2048, 2048, 64, 64, device="cpu") == (256, 511, 65, 128)
    monkeypatch.setattr(ta, "device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert ta.lookup_tuned_geometry(64, 64, 1) is None
    assert tt.choose_block_plan(2048, 2048, 64, 64) == (127, 447, 64, 64)
    ta._MEASURED.clear()
    ta.register_tuned_geometry(64, 64, 192, 384, fused=True, block_h=256, block_w=511)
    assert next(iter(ta._MEASURED))[0] == "NVIDIA H100 80GB HBM3"
    monkeypatch.undo()
    assert tt.choose_block_plan(2048, 2048, 64, 64, device="cpu") == (127, 447, 64, 64)


def test_jax_cache_file_not_applied(table, tmp_path, monkeypatch):
    """A JAX-package cache (no device in its keys) is not applied, and the
    port will not overwrite it."""
    path = tmp_path / "jax_tune.json"
    monkeypatch.setenv("FFTCONV_AUTOTUNE_CACHE", str(path))
    ja.register_tuned_geometry(64, 64, 192, 384, f=1, fused=True, block_h=256, block_w=512)
    ja.save_user_cache()
    before = path.read_text()
    with pytest.warns(UserWarning, match="not applied"):
        assert ta.lookup_tuned_geometry(64, 64, 1, device="cpu") is None
    assert tt.choose_block_plan(2048, 2048, 64, 64, device="cpu") == (127, 447, 64, 64)
    ta.register_tuned_geometry(9, 9, 24, 120, device="cpu")
    with pytest.raises(tfc.InvalidInputError, match="not this package's"):
        ta.save_user_cache()
    assert path.read_text() == before


@pytest.mark.parametrize("content", ["{not json", '{"devices": {"cpu": {"8,8": [1]}}}', "[]"])
def test_unreadable_cache_raises(table, tmp_path, monkeypatch, content):
    """A cache file that exists but cannot be read raises and names the
    file, on every lookup, instead of leaving the analytic plan in place
    unannounced."""
    path = tmp_path / "broken.json"
    path.write_text(content)
    monkeypatch.setenv("FFTCONV_AUTOTUNE_CACHE", str(path))
    for _ in range(2):
        with pytest.raises(tfc.InvalidInputError, match="broken.json"):
            ta.lookup_tuned_geometry(64, 64, 1, device="cpu")
    with pytest.raises(tfc.InvalidInputError, match="broken.json"):
        tt.choose_block_plan(2048, 2048, 64, 64, device="cpu")
