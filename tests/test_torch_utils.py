"""The port's utilities against the JAX package's: every ``Config`` field
(from ``set_config`` and from its environment variable, and the values the
port refuses), image I/O, profiling and the device self-test on the CPU."""

import os
import types

import numpy as np
import pytest
import torch

import cuda_fft_convolution_torch as tfc
from cuda_fft_convolution_torch.utils import config as tconfig
from cuda_fft_convolution_torch.utils import image_io as tio
from cuda_fft_convolution_torch.utils import profiling
from cuda_fft_convolution_torch.utils.profiling import Timer, benchmark, trace
from cuda_fft_convolution_tpu.utils import config as jconfig
from cuda_fft_convolution_tpu.utils import image_io as jio

# field → (a value set_config takes, its environment variable, that value
# as the environment spells it, the value parsed back)
FIELDS = {
    "policy": ("pow2", "FFTCONV_POLICY", "pow2", tfc.FftSizePolicy.POW2),
    "use_pallas": (True, "FFTCONV_USE_PALLAS", "0", False),
    "hbm_fraction": (0.5, "FFTCONV_HBM_FRACTION", "0.5", 0.5),
    "hbm_budget_bytes": (1 << 30, "FFTCONV_HBM_BUDGET_BYTES", "1073741824", 1 << 30),
    "chunk_size": (4, "FFTCONV_CHUNK", "4", 4),
    "use_matmul_fft": (False, "FFTCONV_USE_MATMUL_FFT", "0", False),
    "matmul_precision": ("highest", "FFTCONV_MATMUL_PRECISION", "highest", "highest"),
    "inverse_precision": ("highest", "FFTCONV_INVERSE_PRECISION", "highest", "highest"),
    "use_fused_block_conv": (False, "FFTCONV_FUSED_BLOCK_CONV", "1", True),
    "fused_precision": ("bf16x3", "FFTCONV_FUSED_PRECISION", "bf16x3", "bf16x3"),
}
REFUSED = [
    ("use_matmul_fft", True, "FFTCONV_USE_MATMUL_FFT", "1"),
    ("matmul_precision", "high", "FFTCONV_MATMUL_PRECISION", "high"),
    ("matmul_precision", "default", "FFTCONV_MATMUL_PRECISION", "default"),
    ("inverse_precision", "high", "FFTCONV_INVERSE_PRECISION", "high"),
    ("inverse_precision", "default", "FFTCONV_INVERSE_PRECISION", "default"),
    ("fused_precision", "highest", "FFTCONV_FUSED_PRECISION", "highest"),
]


def test_config_fields_are_jax_fields():
    import dataclasses

    names = [f.name for f in dataclasses.fields(tconfig.Config)]
    assert set(names) == {f.name for f in dataclasses.fields(jconfig.Config)} == set(FIELDS)
    for f in dataclasses.fields(jconfig.Config):
        if f.name != "policy":
            assert getattr(tconfig.Config(), f.name) == f.default, f.name


@pytest.mark.parametrize("name", list(FIELDS))
def test_config_field_from_set_config_and_env(name, monkeypatch):
    value, env, spelled, parsed = FIELDS[name]
    before = tfc.get_config()
    try:
        got = getattr(tfc.set_config(**{name: value}), name)
        assert got == (tfc.FftSizePolicy(value) if name == "policy" else value)
        assert getattr(tfc.get_config(), name) == got
    finally:
        tfc.set_config(**{name: getattr(before, name)})
    assert tfc.get_config() == before
    monkeypatch.setenv(env, spelled)
    assert getattr(tconfig.Config.from_env(), name) == parsed
    assert getattr(jconfig.Config.from_env(), name) == parsed


@pytest.mark.parametrize("name,value,env,spelled", REFUSED)
def test_config_refuses_what_the_port_lacks(name, value, env, spelled, monkeypatch):
    before = tfc.get_config()
    with pytest.raises(tfc.InvalidInputError, match=f"{name}={value!r}"):
        tfc.set_config(**{name: value})
    assert tfc.get_config() is before
    monkeypatch.setenv(env, spelled)
    with pytest.raises(tfc.InvalidInputError, match=name):
        tconfig.Config.from_env()
    assert getattr(jconfig.Config.from_env(), name) == value  # the JAX package has it


def test_use_pallas_changes_nothing(rng):
    data = rng.standard_normal((24, 20, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 5, 5, 2)).astype(np.float32)
    want = tfc.fft_conv(data, kernels=bank, algorithm="direct", device="cpu")
    try:
        tfc.set_config(use_pallas=False)
        got = tfc.fft_conv(data, kernels=bank, algorithm="direct", device="cpu")
    finally:
        tfc.set_config(use_pallas=None)
    assert torch.equal(got, want)


@pytest.mark.parametrize("maxval", [255, 65535])
def test_image_io_roundtrip_and_jax_loader(tmp_path, rng, maxval):
    img = rng.random((17, 23)).astype(np.float32)
    p = str(tmp_path / "t.pgm")
    tio.save_pgm(p, img, maxval=maxval)
    back = tio.load_pgm(p)
    assert back.dtype == np.float32 and back.shape == img.shape
    assert np.max(np.abs(back - img)) <= 1.0 / maxval + 1e-6
    assert np.array_equal(back, jio.load_pgm(p))
    assert np.array_equal(tio.load_pgm(p, normalize=False), jio.load_pgm(p, normalize=False))
    jp = str(tmp_path / "j.pgm")
    jio.save_pgm(jp, img, maxval=maxval)
    assert open(jp, "rb").read() == open(p, "rb").read()
    assert tio.compare_l2(back, img, eps=0.01) == jio.compare_l2(back, img, eps=0.01) is True
    assert tio.compare_max(img, img, atol=1e-9) is True
    assert tio.compare_max(back, img, atol=1e-9) == jio.compare_max(back, img, atol=1e-9)


def test_image_io_ascii_and_errors(tmp_path):
    p = tmp_path / "a.pgm"
    p.write_bytes(b"P2\n# a comment\n3 2\n4\n0 1 2\n3 4 0\n")
    got = tio.load_pgm(str(p))
    assert np.array_equal(got, jio.load_pgm(str(p)))
    assert np.array_equal(got * 4, [[0, 1, 2], [3, 4, 0]])
    (tmp_path / "b.pgm").write_bytes(b"P6\n1 1\n255\n\0\0\0")
    with pytest.raises(tfc.InvalidInputError, match="not a PGM"):
        tio.load_pgm(str(tmp_path / "b.pgm"))
    with pytest.raises(tfc.InvalidInputError, match="shape mismatch"):
        tio.compare_l2(np.zeros(3), np.zeros(4))


def test_benchmark_stats_on_the_host_clock(rng):
    x = torch.as_tensor(rng.standard_normal((64, 64)).astype(np.float32))
    calls = []
    stats = benchmark(lambda a: calls.append(1) or a @ a, x, warmup=1, iters=3)
    assert set(stats) == {"mean_s", "median_s", "min_s", "iters", "times_s"}
    assert stats["iters"] == 3 and len(calls) == 4 and len(stats["times_s"]) == 3
    assert 0 < stats["min_s"] <= stats["median_s"] and stats["mean_s"] >= stats["min_s"]
    assert stats["min_s"] == min(stats["times_s"])


def test_benchmark_windows_of_back_to_back_calls(monkeypatch):
    """``reps`` calls a window, ``iters`` windows, after ``warmup`` calls;
    a window's time is over its calls (on a host clock where a call takes
    one second)."""
    clock = [0.0]
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter=lambda: clock[0]))

    def fn():
        clock[0] += 1.0

    stats = benchmark(fn, warmup=2, iters=3, reps=4)
    assert clock[0] == 2 + 3 * 4
    assert stats["times_s"] == [1.0, 1.0, 1.0] and stats["iters"] == 3


def test_timer_accumulates():
    t = Timer()
    t.start()
    dt = t.stop()
    assert dt >= 0 and t.total == dt
    t.start()
    t.stop()
    assert t.total >= dt
    t.reset()
    assert t.total == 0.0
    with pytest.raises(RuntimeError):
        t.stop()


def test_trace_writes_a_chrome_trace(tmp_path, rng):
    x = torch.as_tensor(rng.standard_normal((32, 32)).astype(np.float32))
    with trace(str(tmp_path / "t")) as prof:
        tfc.fft_conv(x[..., None], kernels=x[None, :5, :5, None], mode="same")
    files = os.listdir(tmp_path / "t")
    assert files == ["trace.json"] and os.path.getsize(tmp_path / "t" / "trace.json") > 0
    assert len(prof.key_averages()) > 0


def test_selftest_on_the_cpu():
    rep = tfc.selftest(device="cpu")
    assert rep["backend"] == "cpu" and rep["device_kind"] == "cpu"
    assert rep["device_count"] == 1 and rep["hbm_bytes_limit"] == 0
    assert rep["fft_ok"] is True
    assert rep["kernels"] == {} and rep["kernels_ok"] is None
    assert rep["kernels_reason"] == "no CUDA device; kernels run only on the card"
    assert "pallas_ok" not in rep and "native_planner_ok" not in rep


def test_selftest_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tfc.InvalidInputError, match="device='cpu'"):
        tfc.selftest()
    with pytest.raises(tfc.InvalidInputError, match="device='cpu'"):
        tfc.selftest(run_pallas=False)


def test_debug_logger(caplog):
    import logging

    from cuda_fft_convolution_torch.utils import logging as tlog

    assert tlog.logger.name == "cuda_fft_convolution_torch"
    with caplog.at_level(logging.DEBUG, logger="cuda_fft_convolution_torch"):
        tlog.debug("fft size %d", 2160)
    assert "fft size 2160" in caplog.text
