"""The port's memory planning against the JAX package: the config fields
that set the budget, ``runtime/planner.py`` (``plan_bank``'s plain-bytes
model and the streaming plan), the chunked, streaming-spatial and pipelined
bank convolutions (direct and tiled) forced through ``Config.
hbm_budget_bytes`` or ``chunk_size`` — each equal to the unchunked call
within 1e-6 and to the JAX call within 1e-5 (float32) or 2e-2 (the bf16
tier) — the chunked bank transform, ``storage=``, ragged bucketing, JAX
flat-bank checkpoints, and the out-of-memory annotation."""

import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import cuda_fft_convolution_torch as tfc
import cuda_fft_convolution_tpu as jfc
from cuda_fft_convolution_torch import api as tapi
from cuda_fft_convolution_torch.runtime import planner
from cuda_fft_convolution_torch.utils import config as tconfig
from cuda_fft_convolution_tpu import api as japi
from cuda_fft_convolution_tpu.runtime.planner import plan_bank as j_plan_bank
from tests.oracles import fft_map_f64, rel_err

TOL = 1e-5
CHUNK_TOL = 1e-6  # chunked against whole: the same arithmetic per map
BF16_TOL = 2e-2
BF16_OUT_TOL = 5e-3
CPU = dict(device="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture
def budget():
    """Set both packages' ``hbm_budget_bytes`` (None restores the device's
    own budget); restored after the test."""
    def set_budget(nbytes):
        tfc.set_config(hbm_budget_bytes=nbytes)
        jfc.set_config(hbm_budget_bytes=nbytes)

    yield set_budget
    set_budget(None)
    tfc.set_config(chunk_size=None)


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(args)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def _budget_for_chunk(chunk, *args, **kwargs):
    """The least budget at which ``plan_bank(*args, **kwargs)`` plans
    ``chunk`` kernels a chunk (``chip_smoke.budget_for_chunk``, which the
    smoke forces its chunked DPM run with)."""
    nbytes = chip_smoke.budget_for_chunk(chunk, *args, **kwargs)
    assert planner.plan_bank(*args, hbm_budget_bytes=nbytes, **kwargs).chunk_size == chunk
    assert chunk == 1 or planner.plan_bank(
        *args, hbm_budget_bytes=nbytes - 1, **kwargs).chunk_size < chunk
    return nbytes


# ---------------------------------------------------------------------------
# the config and the budget
# ---------------------------------------------------------------------------


def test_config_memory_fields(monkeypatch):
    cfg = tconfig.Config()
    assert (cfg.hbm_fraction, cfg.hbm_budget_bytes, cfg.chunk_size) == (0.92, None, None)
    assert (cfg.hbm_fraction, cfg.hbm_budget_bytes, cfg.chunk_size) == (
        jfc.get_config().__class__().hbm_fraction, None, None)
    monkeypatch.setenv("FFTCONV_HBM_FRACTION", "0.5")
    monkeypatch.setenv("FFTCONV_HBM_BUDGET_BYTES", str(3 << 30))
    monkeypatch.setenv("FFTCONV_CHUNK", "16")
    env = tconfig.Config.from_env()
    assert (env.hbm_fraction, env.hbm_budget_bytes, env.chunk_size) == (0.5, 3 << 30, 16)
    for name in ("FFTCONV_HBM_BUDGET_BYTES", "FFTCONV_CHUNK"):
        monkeypatch.setenv(name, "")
    env = tconfig.Config.from_env()
    assert (env.hbm_budget_bytes, env.chunk_size) == (None, None)
    try:
        assert tfc.set_config(chunk_size=4, hbm_fraction=0.8).chunk_size == 4
        assert tfc.get_config().hbm_fraction == 0.8
    finally:
        tfc.set_config(chunk_size=None, hbm_fraction=0.92)


def test_device_memory_budget(monkeypatch, budget):
    """hbm_budget_bytes wins on every device; a CUDA device plans with
    hbm_fraction of its total memory; the CPU keeps 8 GiB."""
    cpu, card = torch.device("cpu"), torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(total_memory=80 << 30))
    assert tapi._device_memory_budget(cpu) == 8 << 30
    assert tapi._device_memory_budget(card) == int(0.92 * (80 << 30))
    try:
        tfc.set_config(hbm_fraction=0.5)
        assert tapi._device_memory_budget(card) == 40 << 30
    finally:
        tfc.set_config(hbm_fraction=0.92)
    budget(12345)
    assert tapi._device_memory_budget(cpu) == tapi._device_memory_budget(card) == 12345


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

PLAN_SHAPES = [
    (100, 1, 2160, 2160, 1, 4),  # the direct headline
    (576, 31, 540, 540, 1, 2),  # the DPM giant bank at the bf16 tier
    (1024, 31, 540, 540, 1, 4),  # the 1024-filter bank at float32
    (100, 1, 2160, 2160, 8, 4),  # the pipelined batch of 8
    (7, 3, 30, 17, 2, 4),  # small, odd width
]


@pytest.mark.parametrize("n,f,fh,fw,b,sb", PLAN_SHAPES)
def test_plan_bank_plain_bytes_model(n, f, fh, fw, b, sb):
    """Unchunked when it fits, with the plain-bytes peak; chunk >= 1 at any
    budget; the chunk size never falls as the budget grows; a chunked plan
    stays within its budget wherever one chunk fits beside the residents."""
    wc = fw // 2 + 1
    spec = 2 * sb * fh * wc
    maps = 4 * fh * fw
    fixed = b * f * spec + b * f * maps + n * f * spec + b * n * maps
    inverse = 8 * fh * wc + ((2 * sb + 8) * fh * wc if sb < 4 else 0) + 16 * fh * wc
    extra = n * f * spec // 16 if f > 1 else 0
    whole = fixed + n * b * inverse + extra
    assert planner.plan_bank(n, f, fh, fw, b, whole, sb) == planner.BankPlan(n, whole)
    below = planner.plan_bank(n, f, fh, fw, b, whole - 1, sb)
    assert below.peak_bytes <= whole - 1 and below.peak_bytes < whole
    assert planner.plan_bank(n, f, fh, fw, b, 0, sb).chunk_size == 1
    per_chunked = b * (inverse + maps)
    last = 0
    for budget in np.linspace(0, 1.2 * whole, 97).astype(np.int64):
        plan = planner.plan_bank(n, f, fh, fw, b, int(budget), sb)
        assert 1 <= plan.chunk_size <= n and plan.chunk_size >= last
        last = plan.chunk_size
        if plan.chunk_size < n and budget >= fixed + per_chunked:
            assert plan.peak_bytes <= budget
            assert plan.peak_bytes == fixed + plan.chunk_size * per_chunked


@pytest.mark.parametrize("n,f,fh,fw,b,sb", PLAN_SHAPES)
def test_plan_bank_never_below_the_padded_model(n, f, fh, fw, b, sb):
    """Plain bytes are never more than the JAX package's (8, 128)-padded
    model counts for the same work, so the port plans at least its chunk
    wherever that model plans a chunk of more than one kernel."""
    for budget in (1 << 30, 7 << 30, 16 << 30, int(0.92 * 85e9)):
        ours = planner.plan_bank(n, f, fh, fw, b, budget, sb).chunk_size
        theirs = j_plan_bank(n, f, fh, fw, batch=b, hbm_budget_bytes=budget,
                             store_bytes=sb).chunk_size
        assert ours >= theirs or theirs == 1


def test_plan_bank_store_bytes():
    """The bf16 tier halves the stored spectra, so it never plans a smaller
    chunk than float32 under the same budget."""
    for budget in (6 << 30, 8 << 30, 12 << 30):
        f32 = planner.plan_bank(1024, 31, 540, 540, 1, budget, 4)
        bf16 = planner.plan_bank(1024, 31, 540, 540, 1, budget, 2)
        assert bf16.chunk_size >= f32.chunk_size
    assert planner.plan_bank(1024, 31, 540, 540, 1, 40 << 30, 4).chunk_size < 1024


def test_plan_streaming_bounds():
    n, f, fh, fw = 576, 31, 540, 540
    stack = n * f * 12 * 12 * 4
    last = 0
    for budget in (0, 1 << 30, 4 << 30, 16 << 30, 64 << 30, 1 << 40):
        plan = planner.plan_streaming(n, f, fh, fw, 1, budget, 2, stack)
        assert 1 <= plan.chunk_size <= n and plan.chunk_size >= last
        last = plan.chunk_size
        if 1 < plan.chunk_size < n:
            assert plan.peak_bytes <= budget
    assert last == n
    per_k = planner.transform_bytes(f, fh, fw) + 8 * fh * (fw // 2 + 1) * 3 + 4 * fh * fw
    assert planner.plan_streaming(n, f, fh, fw, 1, 1 << 40, 2, stack).peak_bytes == (
        2 * (2 + 4) * f * fh * (fw // 2 + 1) + n * 4 * fh * fw + stack + n * per_k)


# ---------------------------------------------------------------------------
# chunked, streaming and pipelined against whole (direct engine)
# ---------------------------------------------------------------------------


def _direct_case(rng, batched=False, f=2, n=7, k=5):
    shape = (2, 24, 22, f) if batched else (24, 22, f)
    data = rng.standard_normal(shape).astype(np.float32)
    bank = rng.standard_normal((n, k, k, f)).astype(np.float32)
    return data, bank


@pytest.mark.parametrize("store_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("chunk", [3, 1])
def test_conv_spectral_chunked_equals_whole(rng, monkeypatch, budget, store_dtype, batched,
                                            chunk):
    """A resident bank over the budget runs in chunks (7 kernels in chunks
    of 3: a short last chunk; or of 1), equal to the whole-bank call, and
    to the JAX call."""
    data, bank = _direct_case(rng, batched)
    sd = tfc.fft_data(data, 5, 5, store_dtype=store_dtype, **CPU)
    sk = tfc.fft_kernels(bank, spectral=sd, store_dtype=store_dtype)
    jsd = jfc.fft_data(data, 5, 5, store_dtype=store_dtype)
    jsk = jfc.fft_kernels(bank, spectral=jsd, store_dtype=store_dtype)
    for mode in ("fftmap", "same"):
        whole = tfc.conv_spectral(sd, sk, mode=mode)
        plan_args = (7, 2, sd.fft_h, sd.fft_w, 2 if batched else 1)
        budget(_budget_for_chunk(chunk, *plan_args, store_bytes=sk.re.element_size()))
        calls = _count_calls(monkeypatch, tapi, "_conv_from_spectra")
        got = tfc.conv_spectral(sd, sk, mode=mode)
        want = jfc.conv_spectral(jsd, jsk, mode=mode)
        budget(None)
        monkeypatch.undo()
        assert len(calls) == -(-7 // chunk)
        assert [c[2].shape[0] for c in calls][-1] == 7 - chunk * (len(calls) - 1)
        assert got.shape == whole.shape and got.dtype == torch.float32
        assert rel_err(got.numpy(), whole.numpy()) <= CHUNK_TOL
        bar = TOL if store_dtype == "float32" else BF16_TOL
        assert rel_err(got.numpy(), _np(want)) < bar


@pytest.mark.parametrize("correlation", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_streaming_spatial_equals_whole(rng, monkeypatch, budget, correlation, ragged):
    """Raw kernels whose spectra would take over half the budget are never
    held as spectra: each chunk of spatial kernels is transformed,
    multiplied and inverted in turn — equal to the resident call and to
    the JAX package's streaming call (the per-kernel correlation flip of a
    ragged bank included)."""
    data = rng.standard_normal((24, 24, 1)).astype(np.float32)
    sizes = [(3, 3), (7, 7), (7, 5), (6, 7), (7, 7)] if ragged else [(7, 7)] * 5
    bank = [rng.standard_normal(s + (1,)).astype(np.float32) for s in sizes]
    sd = tfc.fft_data(data, 7, 7, **CPU)
    jsd = jfc.fft_data(data, 7, 7)
    whole = tfc.conv_spectral(sd, bank, mode="full", correlation=correlation)
    resident = planner.spectra_bytes(5, 1, sd.fft_h, sd.fft_w)
    budget(resident)  # below twice the resident bytes, above one chunk
    calls = _count_calls(monkeypatch, tapi, "_conv_from_spatial_chunked")
    got = tfc.conv_spectral(sd, bank, mode="full", correlation=correlation)
    want = jfc.conv_spectral(jsd, bank, mode="full", correlation=correlation)
    assert len(calls) == 1 and calls[0][5] < 5  # streamed, in chunks
    budget(None)
    ws = whole if ragged else list(whole)
    gs = got if ragged else list(got)
    assert len(gs) == len(ws) == 5
    for g, w, j in zip(gs, ws, want):
        assert rel_err(g.numpy(), w.numpy()) <= CHUNK_TOL
        assert rel_err(g.numpy(), np.asarray(j)) < TOL


@pytest.mark.parametrize("route,raw", [("resident", True), ("resident", False),
                                       ("chunked", False), ("streamed", True)])
def test_direct_bank_plan_is_the_route_conv_spectral_takes(rng, monkeypatch, budget, route,
                                                           raw):
    """``direct_bank_plan`` names the route and chunk that ``conv_spectral``
    runs a direct bank with: resident (one MAC over the bank), chunked
    (a resident bank over the budget) or streamed (raw kernels whose
    spectra would take over half the budget)."""
    data, bank = _direct_case(rng)
    sd = tfc.fft_data(data, 5, 5, **CPU)
    sk = tfc.fft_kernels(bank, spectral=sd)
    if route == "chunked":
        budget(_budget_for_chunk(3, 7, 2, sd.fft_h, sd.fft_w, 1))
    elif route == "streamed":
        budget(planner.spectra_bytes(7, 2, sd.fft_h, sd.fft_w))
    got, plan = tapi.direct_bank_plan(
        sd, 7, raw_corner=raw, stack_bytes=bank.nbytes if raw else 0)
    names = {"resident": "_conv_from_spectra", "chunked": "_conv_from_spectra_chunked",
             "streamed": "_conv_from_spatial_chunked"}
    calls = {r: _count_calls(monkeypatch, tapi, name) for r, name in names.items()}
    maps = tfc.conv_spectral(sd, bank if raw else sk, mode="same")
    assert got == route and tuple(maps.shape) == (7, 24, 22)
    assert bool(calls["chunked"]) == (route == "chunked")
    assert bool(calls["streamed"]) == (route == "streamed")
    if route == "resident":
        assert plan.chunk_size == 7 and [c[2].shape[0] for c in calls[route]] == [7]
    elif route == "chunked":
        assert plan.chunk_size == 3 and [c[6] for c in calls[route]] == [3]
    else:
        assert [c[5] for c in calls[route]] == [plan.chunk_size] and plan.chunk_size < 7


def test_streaming_spatial_at_the_tier(rng, monkeypatch, budget):
    """At the bf16 tier the streamed kernel chunks are float32 and the data
    planes are upcast once: exactly the float32 call on the bf16-rounded
    data spectra, and the JAX streaming call within the tier's bar."""
    data = rng.standard_normal((32, 30, 2)).astype(np.float32)
    bank = rng.standard_normal((6, 5, 5, 2)).astype(np.float32)
    sd = tfc.fft_data(data, 5, 5, store_dtype="bfloat16", **CPU)
    jsd = jfc.fft_data(data, 5, 5, store_dtype="bfloat16")
    rounded = tfc.SpectralData(re=sd.re.float(), im=sd.im.float(), fft_h=sd.fft_h,
                               fft_w=sd.fft_w, data_h=sd.data_h, data_w=sd.data_w)
    exact = tfc.conv_spectral(rounded, bank, mode="same")
    budget(planner.spectra_bytes(6, 2, sd.fft_h, sd.fft_w, 2))
    calls = _count_calls(monkeypatch, tapi, "_conv_from_spatial_chunked")
    got = tfc.conv_spectral(sd, bank, mode="same")
    want = jfc.conv_spectral(jsd, bank, mode="same")
    assert len(calls) == 1
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), exact.numpy()) <= CHUNK_TOL
    assert rel_err(got.numpy(), _np(want)) < BF16_TOL
    budget(None)
    f32 = tfc.fft_conv(data, kernels=bank, mode="same", algorithm="direct", **CPU)
    assert rel_err(got.numpy(), f32.numpy()) < BF16_TOL


@pytest.mark.parametrize("batched", [False, True])
def test_pipelined_direct_equals_conv_spectral(rng, budget, batched):
    """conv_spectral_pipelined on direct spectra equals conv_spectral for
    every chunk size, dividing or not, and the JAX pipelined call;
    chunk_size=None takes Config.chunk_size, then the planner."""
    data, bank = _direct_case(rng, batched)
    sd = tfc.fft_data(data, 5, 5, **CPU)
    jsd = jfc.fft_data(data, 5, 5)
    want = tfc.conv_spectral(sd, bank)
    for chunk in (1, 2, 3, 7, 16):
        got = tfc.conv_spectral_pipelined(sd, bank, chunk_size=chunk)
        jgot = jfc.conv_spectral_pipelined(jsd, bank, chunk_size=chunk)
        assert rel_err(got.numpy(), want.numpy()) <= CHUNK_TOL
        assert rel_err(got.numpy(), np.asarray(jgot)) < TOL
    tfc.set_config(chunk_size=3)
    assert rel_err(tfc.conv_spectral_pipelined(sd, bank).numpy(), want.numpy()) <= CHUNK_TOL
    tfc.set_config(chunk_size=None)
    budget(_budget_for_chunk(2, 7, 2, sd.fft_h, sd.fft_w, 2 if batched else 1))
    same = tfc.conv_spectral_pipelined(sd, bank, mode="same")
    assert rel_err(same.numpy(), np.asarray(jfc.conv_spectral(jsd, bank, mode="same"))) < TOL
    for p, s in ((tfc, sd), (jfc, jsd)):
        with pytest.raises(p.InvalidInputError, match="chunk_size"):
            p.conv_spectral_pipelined(s, bank, chunk_size=0)


def test_pipelined_tiled_equals_conv_spectral(rng):
    """On tiled spectra the fused block-conv runs a chunk at a time into
    the preallocated maps: equal to conv_spectral and to the JAX call."""
    data = rng.standard_normal((60, 50, 1)).astype(np.float32)
    kerns = [rng.standard_normal((5, 5, 1)).astype(np.float32) for _ in range(7)]
    sd = tfc.fft_data_tiled(data, 5, 5, block_h=32, block_w=32, **CPU)
    jsd = jfc.fft_data_tiled(data, 5, 5, block_h=32, block_w=32)
    want = tfc.conv_spectral(sd, kerns, mode="same")
    for chunk in (2, 3, 7, 16, None):
        got = tfc.conv_spectral_pipelined(sd, kerns, chunk_size=chunk, mode="same")
        assert rel_err(got.numpy(), want.numpy()) <= CHUNK_TOL
    jgot = jfc.conv_spectral_pipelined(jsd, kerns, chunk_size=3, mode="same")
    assert rel_err(got.numpy(), np.asarray(jgot)) < TOL
    for p, s in ((tfc, sd), (jfc, jsd)):
        with pytest.raises(p.InvalidInputError, match="fftmap"):
            p.conv_spectral_pipelined(s, kerns, chunk_size=2, mode="fftmap")
    assert tapi.np_prod_blocks(sd) == japi.np_prod_blocks(jsd) == sd.re.shape[0] * sd.re.shape[1]


@pytest.mark.parametrize("tiled", [False, True])
def test_pipelined_tier_and_bf16_maps(rng, tiled):
    """The pipelined call at the bf16 tier (raw kernels take the tier) and
    with bf16 maps, against the JAX call at the tier's bars."""
    data = rng.standard_normal((48, 40, 2)).astype(np.float32)
    bank = rng.standard_normal((5, 7, 7, 2)).astype(np.float32)
    spectra = "fft_data_tiled" if tiled else "fft_data"
    kw = dict(trim_mode="same") if tiled else {}
    for store_dtype, out_dtype, bar in (("bfloat16", None, BF16_TOL),
                                        ("float32", "bfloat16", BF16_OUT_TOL)):
        sd = getattr(tfc, spectra)(data, 7, 7, store_dtype=store_dtype, **kw, **CPU)
        jsd = getattr(jfc, spectra)(data, 7, 7, store_dtype=store_dtype, **kw)
        got = tfc.conv_spectral_pipelined(sd, bank, chunk_size=2, mode="same",
                                          out_dtype=out_dtype)
        want = jfc.conv_spectral_pipelined(jsd, bank, chunk_size=2, mode="same",
                                           out_dtype=out_dtype)
        whole = tfc.conv_spectral(sd, bank, mode="same", out_dtype=out_dtype)
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        assert rel_err(_np(got), _np(want)) < bar
        assert rel_err(_np(got), _np(whole)) <= CHUNK_TOL


def test_chunked_paths_write_preallocated_maps(rng, monkeypatch, budget):
    """The chunked paths write each chunk into the preallocated maps; none
    collects chunks for a concatenation (which doubles the peak)."""
    data, bank = _direct_case(rng)
    sd = tfc.fft_data(data, 5, 5, **CPU)
    sdt = tfc.fft_data_tiled(data, 5, 5, block_h=16, block_w=16, **CPU)
    want = [tfc.conv_spectral(sd, bank), tfc.conv_spectral(sdt, bank, mode="same")]

    def no_cat(*args, **kwargs):
        raise AssertionError("a chunked path concatenated its chunks")

    monkeypatch.setattr(torch, "cat", no_cat)
    got = [tfc.conv_spectral_pipelined(sd, bank, chunk_size=3),
           tfc.conv_spectral_pipelined(sdt, bank, chunk_size=3, mode="same")]
    budget(planner.spectra_bytes(7, 2, sd.fft_h, sd.fft_w))
    got.append(tfc.conv_spectral(sd, bank))  # streaming spatial
    for g, w in zip(got, want + want[:1]):
        assert rel_err(g.numpy(), w.numpy()) <= CHUNK_TOL


def test_out_of_memory_is_annotated(rng, monkeypatch):
    """A device out-of-memory error in the direct engine is re-raised as a
    MemoryError naming the plan and the settings that shrink it."""
    data, bank = _direct_case(rng)
    sd = tfc.fft_data(data, 5, 5, **CPU)

    def oom(*args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 9.00 GiB")

    monkeypatch.setattr(tapi, "_conv_from_spectra", oom)
    with pytest.raises(MemoryError, match=r"chunk_size=7.*hbm_budget_bytes") as info:
        tfc.conv_spectral(sd, bank)
    assert isinstance(info.value.__cause__, torch.OutOfMemoryError)


# ---------------------------------------------------------------------------
# the bank transform, storage, bucketing, checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["corner", "centered-ragged", "correlation-ragged", "bf16"])
def test_fft_kernels_chunked_equals_whole(rng, monkeypatch, budget, case):
    """A bank whose transform does not fit beside its spectra is
    transformed a chunk at a time into preallocated planes: the planes
    equal the whole transform's, and the JAX package's."""
    sizes = [(5, 5), (3, 5), (5, 2), (4, 4), (5, 5), (1, 3), (2, 2)]
    if case in ("corner", "bf16"):
        sizes = [(5, 5)] * 7
    bank = [rng.standard_normal(s + (2,)).astype(np.float32) for s in sizes]
    kw = dict(kernel_layout="centered" if case.startswith("centered") else "corner",
              correlation=case.startswith("correlation"),
              store_dtype="bfloat16" if case == "bf16" else "float32")
    whole = tfc.fft_kernels(bank, 20, 18, **kw, **CPU)
    want = jfc.fft_kernels(bank, 20, 18, **kw)
    store = 2 if case == "bf16" else 4
    step_bytes = 4 * planner.transform_bytes(2, 20, 18)
    budget(planner.spectra_bytes(7, 2, 20, 18, store) + 7 * 2 * 5 * 5 * 4 + 3 * step_bytes)
    calls = _count_calls(monkeypatch, tapi, "_transform_bank_chunk")
    got = tfc.fft_kernels(bank, 20, 18, **kw, **CPU)
    assert [c[0].shape[0] for c in calls] == [3, 3, 1]
    assert got.centered == whole.centered == want.centered
    assert got.re.dtype == whole.re.dtype and got.kernel_hs == whole.kernel_hs
    for g, w, j in ((got.re, whole.re, want.re), (got.im, whole.im, want.im)):
        assert rel_err(_np(g), _np(w)) <= CHUNK_TOL
        assert rel_err(_np(g), _np(j)) < (TOL if store == 4 else BF16_TOL)


@pytest.mark.parametrize("storage", ["auto", "planar", "flat"])
def test_storage_gives_the_jax_maps(rng, storage):
    """storage= is accepted with the JAX package's checks; the port stores
    every bank planar (flat=False), and its maps equal the JAX maps at each
    storage."""
    data = rng.standard_normal((40, 36, 3)).astype(np.float32)
    kerns = rng.standard_normal((6, 7, 5, 3)).astype(np.float32)
    sd = tfc.fft_data(data, 7, 5, **CPU)
    jsd = jfc.fft_data(data, 7, 5)
    sk = tfc.fft_kernels(kerns, spectral=sd, storage=storage)
    jsk = jfc.fft_kernels(kerns, spectral=jsd, storage=storage)
    assert sk.flat is False and tuple(sk.re.shape) == (6, 3, sd.fft_h, sd.fft_w // 2 + 1)
    assert jsk.flat is (storage == "flat")
    for call in (lambda p, s, k: p.conv_spectral(s, k, mode="same"),
                 lambda p, s, k: p.conv_spectral_pipelined(s, k, chunk_size=2, mode="same")):
        got, want = call(tfc, sd, sk), call(jfc, jsd, jsk)
        assert rel_err(got.numpy(), np.asarray(want)) < TOL


def test_storage_errors_match_jax(rng):
    data = rng.standard_normal((32, 32, 1)).astype(np.float32)
    kerns = rng.standard_normal((4, 5, 5, 1)).astype(np.float32)
    for p, c in ((tfc, CPU), (jfc, {})):
        with pytest.raises(p.InvalidInputError, match="storage must be"):
            p.fft_kernels(kerns, 16, 16, storage="packed", **c)
        sdt = p.fft_data_tiled(data, 5, 5, block_h=16, block_w=16, **c)
        with pytest.raises(p.InvalidInputError, match="tiled block spectra"):
            p.fft_kernels(kerns, spectral=sdt, storage="flat")
        with pytest.raises(p.InvalidInputError, match="corner-anchored"):
            p.fft_kernels(kerns, 16, 16, storage="flat", kernel_layout="centered", **c)


@pytest.mark.parametrize("correlation", [False, True])
@pytest.mark.parametrize("mode", ["same", "valid"])
def test_ragged_bucketing_matches_jax(rng, mode, correlation):
    """A small BASELINE configs[1]: a 64² image and a cell array of 3, 5, 9
    and 17 kernels (three pow-2 envelopes) — each bucket runs at its own
    plan, and the maps come back per kernel in input order, equal to the
    JAX package's."""
    data = rng.standard_normal((64, 64, 1)).astype(np.float32)
    sizes = (9, 3, 17, 5, 17, 3, 9, 5)
    bank = [rng.standard_normal((s, s, 1)).astype(np.float32) for s in sizes]
    assert tapi._bucket_ragged(bank) == japi._bucket_ragged([jnp.asarray(k) for k in bank])
    assert len(tapi._bucket_ragged(bank)) == 3
    got = tfc.fft_conv(data, kernels=bank, mode=mode, correlation=correlation, **CPU)
    want = jfc.fft_conv(data, kernels=bank, mode=mode, correlation=correlation)
    assert isinstance(got, list) and len(got) == len(bank)
    for g, w, s in zip(got, want, sizes):
        assert tuple(g.shape) == w.shape == ((64, 64) if mode == "same" else (65 - s, 65 - s))
        assert rel_err(g.numpy(), np.asarray(w)) < TOL
    # batched data buckets the same way
    batch = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    got = tfc.fft_conv(batch, kernels=bank[:4], mode=mode, **CPU)
    want = jfc.fft_conv(batch, kernels=bank[:4], mode=mode)
    for g, w in zip(got, want):
        assert g.shape[0] == 2 and rel_err(g.numpy(), np.asarray(w)) < TOL


def test_jax_flat_checkpoint_loads_planar(rng, tmp_path):
    """A JAX flat bank (planes (N, F, fft_h·Wc)) loads as planar planes
    with flat=False and convolves to the JAX maps; the port saves planar,
    which the JAX package loads."""
    data = rng.standard_normal((30, 26, 2)).astype(np.float32)
    kerns = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    jsd = jfc.fft_data(data, 4, 4)
    jsk = jfc.fft_kernels(kerns, spectral=jsd, storage="flat")
    assert jsk.flat and jsk.re.ndim == 3
    jfc.save_spectral(str(tmp_path / "flat.npz"), jsk)
    sk = tfc.load_spectral(str(tmp_path / "flat.npz"), **CPU)
    assert sk.flat is False
    assert tuple(sk.re.shape) == (3, 2, jsd.fft_h, jsd.fft_w // 2 + 1)
    sd = tfc.fft_data(data, 4, 4, **CPU)
    want = np.asarray(jfc.conv_spectral(jsd, jsk, mode="same"))
    assert rel_err(tfc.conv_spectral(sd, sk, mode="same").numpy(), want) < TOL
    tfc.save_spectral(str(tmp_path / "planar.npz"), sk)
    back = jfc.load_spectral(str(tmp_path / "planar.npz"))
    assert back.flat is False and back.re.ndim == 4
    assert rel_err(np.asarray(jfc.conv_spectral(jsd, back, mode="same")), want) < TOL
    with np.load(str(tmp_path / "flat.npz")) as z:
        fields = {k: z[k] for k in z.files}
    fields["fft_re"] = fields["fft_re"][..., :-1]
    with pytest.raises(tfc.InvalidInputError, match="flat bank planes"):
        tfc.from_numpy(fields, **CPU)


def test_planning_module_imports_without_jax():
    """runtime/planner.py carries its own arithmetic: importable, and
    planning, with jax blocked."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from cuda_fft_convolution_torch.runtime.planner import plan_bank\n"
        "assert plan_bank(576, 31, 540, 540, 1, 70 << 30, 2).chunk_size == 576\n"
        "assert not any(m == 'jax' or m.startswith('cuda_fft_convolution_tpu')\n"
        "    for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_direct_maps_match_the_float64_map(rng, budget):
    """The chunked direct maps against the float64 circular map oracle."""
    data, bank = _direct_case(rng, f=3, n=5, k=4)
    sd = tfc.fft_data(data, 4, 4, **CPU)
    budget(_budget_for_chunk(2, 5, 3, sd.fft_h, sd.fft_w, 1))
    got = tfc.conv_spectral(sd, bank)
    for g, k in zip(got, bank):
        assert rel_err(g.numpy(), fft_map_f64(data, k, sd.fft_h, sd.fft_w)) < TOL
