"""The port's configured default FFT-size policy against the JAX package's:
``Config.policy``, read from ``FFTCONV_POLICY`` or set by
``set_config(policy=...)``, is the policy every entry point takes when its
``policy`` is None (``api._resolve_policy``), as in
``cuda_fft_convolution_tpu/api.py`` and ``tests/test_aux.py``.

Tolerance: 1e-5 relative to the largest |value| (the repo's fp32 bar)."""

import numpy as np
import pytest

import cuda_fft_convolution_torch as tfc
import cuda_fft_convolution_tpu as jfc
from cuda_fft_convolution_torch.models import build_pyramid
from cuda_fft_convolution_torch.utils import config as tconfig
from cuda_fft_convolution_torch.utils.fft_size import FftSizePolicy
from cuda_fft_convolution_tpu.models.pyramid import build_pyramid as jax_build_pyramid
from cuda_fft_convolution_tpu.utils import config as jconfig
from tests.oracles import rel_err

TOL = 1e-5


def test_config_set_and_policy_effect():
    """``tests/test_aux.py``'s check, on the port: a name is coerced to the
    policy and ``fft_data`` with ``policy=None`` takes it."""
    orig = tfc.get_config().policy
    assert orig is FftSizePolicy.FAST
    try:
        tfc.set_config(policy="multiple16")
        assert tfc.get_config().policy is FftSizePolicy.MULTIPLE16
        sd = tfc.fft_data(np.zeros((64, 8, 1), np.float32), 10, 4, device="cpu")
        assert (sd.fft_h, sd.fft_w) == (80, 16)
        tfc.set_config(policy=FftSizePolicy.TPU)
        assert tfc.get_config().policy is FftSizePolicy.TPU
        with pytest.raises(ValueError):
            tfc.set_config(policy="fastest")
    finally:
        tfc.set_config(policy=orig)
    assert tfc.get_config().policy is FftSizePolicy.FAST


def test_config_policy_from_env(monkeypatch):
    monkeypatch.setenv("FFTCONV_POLICY", "pow2")
    assert tconfig.Config.from_env().policy is FftSizePolicy.POW2
    monkeypatch.delenv("FFTCONV_POLICY")
    assert tconfig.Config.from_env().policy is FftSizePolicy.FAST


@pytest.fixture(params=["FFTCONV_POLICY", "set_config"])
def pow2_default(request, monkeypatch):
    """Both packages with pow2 as their configured default policy, from the
    environment (the configuration re-read as at import) or from
    ``set_config``; both restored afterwards."""
    if request.param == "FFTCONV_POLICY":
        monkeypatch.setenv("FFTCONV_POLICY", "pow2")
        monkeypatch.setattr(tconfig, "_CONFIG", tconfig.Config.from_env())
        monkeypatch.setattr(jconfig, "_CONFIG", jconfig.Config.from_env())
        yield
        return
    saved = tfc.get_config().policy, jfc.get_config().policy
    tfc.set_config(policy="pow2")
    jfc.set_config(policy="pow2")
    try:
        yield
    finally:
        tfc.set_config(policy=saved[0])
        jfc.set_config(policy=saved[1])


def test_configured_policy_reaches_fft_conv_direct(pow2_default):
    """The fault's inputs: (50, 70, 1) data, a (3, 5, 7, 1) bank, seed 0,
    ``fft_conv(mode='fftmap', algorithm='direct')``: pow2 maps (3, 64, 128)
    in both packages, within 1e-5 (the fast policy gave (3, 54, 80))."""
    assert tfc.get_config().policy is FftSizePolicy.POW2
    rng = np.random.default_rng(0)
    data = rng.standard_normal((50, 70, 1)).astype(np.float32)
    bank = rng.standard_normal((3, 5, 7, 1)).astype(np.float32)
    got = tfc.fft_conv(data, kernels=bank, mode="fftmap", algorithm="direct", device="cpu")
    want = np.asarray(jfc.fft_conv(data, kernels=bank, mode="fftmap", algorithm="direct"))
    assert tuple(got.shape) == want.shape == (3, 64, 128)
    assert rel_err(got.numpy(), want) < TOL


def test_configured_policy_reaches_the_other_entry_points(pow2_default):
    """``fft_data``, the fftmap canvas of ``fft_data_tiled`` and
    ``build_pyramid`` size their FFTs by the configured policy, as JAX's
    do; an explicit policy still wins."""
    rng = np.random.default_rng(0)
    data = rng.standard_normal((50, 70, 1)).astype(np.float32)
    sd = tfc.fft_data(data, 5, 7, device="cpu")
    jsd = jfc.fft_data(data, 5, 7)
    assert (sd.fft_h, sd.fft_w) == (jsd.fft_h, jsd.fft_w) == (64, 128)
    assert (tfc.fft_data(data, 5, 7, policy="fast", device="cpu").fft_h,) == (54,)
    td = tfc.fft_data_tiled(data, 5, 7, trim_mode="fftmap", device="cpu")
    jtd = jfc.fft_data_tiled(data, 5, 7, trim_mode="fftmap")
    assert (td.win_h, td.win_w) == (jtd.win_h, jtd.win_w) == (64, 128)
    image = rng.standard_normal((40, 48, 2)).astype(np.float32)
    pyr = build_pyramid(image, 5, 5, num_levels=3, device="cpu")
    jpyr = jax_build_pyramid(image, 5, 5, num_levels=3)
    sizes = [(s.fft_h, s.fft_w) for s in pyr.spectra]
    assert sizes == [(s.fft_h, s.fft_w) for s in jpyr.spectra] == [(64, 64), (32, 64), (32, 32)]
    for s, js in zip(pyr.spectra, jpyr.spectra):
        assert rel_err(s.re.numpy(), np.asarray(js.re)) < TOL
