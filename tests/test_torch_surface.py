"""The port's public surface against the JAX package on the same numpy
inputs: the ``ops/conv.py`` cores and their bank gradients, the complex MAC
wrappers, ``SpectralData`` interop (``split_planes``, ``combine_planes``,
``from_complex``, ``from_packed``, ``from_reference_packed``) and the public
names of the top level, ``ops`` and ``utils``. On the CPU the port runs its
plain versions; the JAX package's Pallas MAC runs in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_fft_convolution_torch as tfc
import cuda_fft_convolution_tpu as jfc
from cuda_fft_convolution_torch import ops as tops
from cuda_fft_convolution_torch import types as ttypes
from cuda_fft_convolution_torch import utils as tutils
from cuda_fft_convolution_torch.ops import conv as tconv
from cuda_fft_convolution_torch.ops import spectral_mac as tmac
from cuda_fft_convolution_tpu import ops as jops
from cuda_fft_convolution_tpu import types as jtypes
from cuda_fft_convolution_tpu import utils as jutils
from cuda_fft_convolution_tpu.ops import conv as jconv
from cuda_fft_convolution_tpu.ops import spectral_mac as jmac
from tests.oracles import fft_conv_full_f64, fft_map_f64, rel_err

TOL = 1e-5
MAC_TOL = 1e-6
# Names left behind (ROADMAP leave-behind list): the TPU transfer helper.
LEFT_BEHIND = {"fetch"}


def _cf(x):
    """channels-last (H, W, F) → channel-leading (F, H, W)."""
    return np.ascontiguousarray(np.moveaxis(x, -1, 0))


def _bank_cf(x):
    """(N, Kh, Kw, F) → (N, F, Kh, Kw)."""
    return np.ascontiguousarray(np.moveaxis(x, -1, 1))


@pytest.mark.parametrize("module,jax_module", [(tfc, jfc), (tops, jops), (tutils, jutils)],
                         ids=["top level", "ops", "utils"])
def test_public_names_cover_jax(module, jax_module):
    missing = set(jax_module.__all__) - LEFT_BEHIND - set(module.__all__)
    assert not missing
    for name in module.__all__:
        assert hasattr(module, name), name


@pytest.mark.parametrize("h,w,f,kh,kw,fft", [
    (64, 8, 5, 10, 4, (80, 16)),  # the reference demo's geometry
    (17, 23, 2, 5, 1, None),  # odd shapes, the FAST policy
    (8, 100, 3, 8, 31, None),
    (33, 9, 4, 33, 9, None),  # the kernel as large as the data
    (5, 5, 1, 1, 1, None),
])
def test_fft_conv_single_matches_jax_and_oracle(rng, h, w, f, kh, kw, fft):
    data = rng.standard_normal((h, w, f)).astype(np.float32)
    kern = rng.standard_normal((kh, kw, f)).astype(np.float32)
    size = fft or (None, None)
    got = tconv.fft_conv_single(_cf(data), _cf(kern), *size, device="cpu").numpy()
    want = np.asarray(jconv.fft_conv_single(jnp.asarray(_cf(data)), jnp.asarray(_cf(kern)),
                                            *size))
    assert got.shape == want.shape
    assert rel_err(got, want) < TOL
    assert rel_err(got[: h + kh - 1, : w + kw - 1], fft_conv_full_f64(data, kern)) < TOL
    if fft is not None:
        assert rel_err(got, fft_map_f64(data, kern, *fft)) < TOL


@pytest.mark.parametrize("policy", ["fast", "multiple16", "pow2"])
def test_fft_conv_stack_matches_jax_and_singles(rng, policy):
    data = rng.standard_normal((32, 24, 2)).astype(np.float32)
    bank = rng.standard_normal((4, 6, 5, 2)).astype(np.float32)
    got = tfc.fft_conv_stack(_cf(data), _bank_cf(bank), policy=policy, device="cpu")
    want = np.asarray(jfc.fft_conv_stack(jnp.asarray(_cf(data)), jnp.asarray(_bank_cf(bank)),
                                         policy=policy))
    assert tuple(got.shape) == want.shape
    assert rel_err(got.numpy(), want) < TOL
    for i in range(4):
        single = tfc.fft_conv_single(_cf(data), _cf(bank[i]), policy=policy, device="cpu")
        assert rel_err(got[i].numpy(), single.numpy()) < TOL
        assert rel_err(got[i, :37, :28].numpy(), fft_conv_full_f64(data, bank[i])) < TOL


def test_fft_conv_stack_bank_gradient_matches_jax(rng):
    """Gradients of a loss through ``fft_conv_stack`` (the MAC through
    ``_SpectralMac``) against ``jax.grad`` of the JAX package's."""
    data = rng.standard_normal((2, 20, 18)).astype(np.float32)
    bank = rng.standard_normal((3, 2, 5, 4)).astype(np.float32)
    weight = rng.standard_normal((3, 24, 24)).astype(np.float32)

    def jloss(k, d):
        return jnp.sum(jfc.fft_conv_stack(d, k, 24, 24) * weight)

    jk, jd = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(bank), jnp.asarray(data))
    k = torch.tensor(bank, requires_grad=True)
    d = torch.tensor(data, requires_grad=True)
    (tfc.fft_conv_stack(d, k, 24, 24) * torch.as_tensor(weight)).sum().backward()
    assert rel_err(k.grad.numpy(), np.asarray(jk)) < TOL
    assert rel_err(d.grad.numpy(), np.asarray(jd)) < TOL


def test_direct_conv_single_matches_jax_and_oracle(rng):
    data = rng.standard_normal((20, 30, 3)).astype(np.float32)
    kern = rng.standard_normal((7, 5, 3)).astype(np.float32)
    got = tfc.direct_conv_single(_cf(data), _cf(kern), device="cpu").numpy()
    want = np.asarray(jfc.direct_conv_single(jnp.asarray(_cf(data)), jnp.asarray(_cf(kern))))
    assert got.shape == (26, 34) == want.shape
    assert rel_err(got, want) < TOL
    assert rel_err(got, fft_conv_full_f64(data, kern)) < TOL
    assert torch.backends.cudnn.allow_tf32  # restored (PyTorch's default)


@pytest.mark.parametrize("fn", ["fft_conv_single", "fft_conv_stack", "direct_conv_single"])
def test_cores_channel_mismatch_is_value_error(fn):
    data = np.zeros((2, 8, 8), np.float32)
    kern = np.zeros((1, 3, 3, 3) if fn == "fft_conv_stack" else (3, 3, 3), np.float32)
    with pytest.raises(ValueError, match="channel mismatch"):
        getattr(tfc, fn)(data, kern, device="cpu")
    with pytest.raises(ValueError, match="channel mismatch"):
        getattr(jfc, fn)(jnp.asarray(data), jnp.asarray(kern))


def _spectra(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("lead", [(), (4,), (2, 3)])
def test_ops_spectral_mac_bank_axes_match_jax(rng, lead):
    d = _spectra(rng, 3, 9, 6)
    k = _spectra(rng, *lead, 3, 9, 6)
    before = tmac.spectral_mac.launches
    got = tconv.spectral_mac(torch.as_tensor(d), torch.as_tensor(k))
    want = np.asarray(jconv.spectral_mac(jnp.asarray(d), jnp.asarray(k)))
    assert tmac.spectral_mac.launches == before  # the plain version on the CPU
    assert got.dtype == torch.complex64 and tuple(got.shape) == (*lead, 9, 6)
    assert rel_err(got.real.numpy(), want.real) < MAC_TOL
    assert rel_err(got.imag.numpy(), want.imag) < MAC_TOL


@pytest.mark.parametrize("name", ["spectral_mac_einsum", "spectral_mac_pallas",
                                  "spectral_mac_auto"])
def test_complex_mac_wrappers_match_jax(rng, name):
    d = _spectra(rng, 2, 3, 9, 11)
    k = _spectra(rng, 5, 3, 9, 11)
    kwargs = {"interpret": True} if name == "spectral_mac_pallas" else {}
    if name == "spectral_mac_auto":
        kwargs = {"use_pallas": True}
    want = np.asarray(getattr(jmac, name)(jnp.asarray(d), jnp.asarray(k), **kwargs))
    got = getattr(tmac, name)(torch.as_tensor(d), torch.as_tensor(k), **kwargs)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (2, 5, 9, 11)
    assert rel_err(got.real.numpy(), want.real) < MAC_TOL
    assert rel_err(got.imag.numpy(), want.imag) < MAC_TOL


def test_rfft2_padded_and_irfft2_norm_match_jax(rng):
    x = rng.standard_normal((2, 13, 29)).astype(np.float32)
    got = tconv.rfft2_padded(torch.as_tensor(x), 16, 45)
    want = np.asarray(jconv.rfft2_padded(jnp.asarray(x), 16, 45))
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape == (2, 16, 23)
    assert rel_err(got.real.numpy(), want.real) < TOL
    assert rel_err(got.imag.numpy(), want.imag) < TOL
    back = tconv.irfft2_norm(got, 16, 45).numpy()
    assert back.shape == (2, 16, 45)
    assert rel_err(back, np.asarray(jconv.irfft2_norm(jnp.asarray(want), 16, 45))) < TOL
    assert rel_err(back[:, :13, :29], x) < TOL


def _equal(t, a):
    return np.array_equal(t.numpy(), np.asarray(a))


def test_split_and_combine_planes_match_jax(rng):
    z = _spectra(rng, 3, 5, 7)
    for x in (z, torch.as_tensor(z)):
        re, im = ttypes.split_planes(x, device="cpu")
        jre, jim = jtypes.split_planes(z)
        assert re.dtype == torch.float32 and re.is_contiguous() and im.is_contiguous()
        assert _equal(re, jre) and _equal(im, jim)
    real = z.real.astype(np.float64)
    re, im = ttypes.split_planes(real, device="cpu")
    assert re.dtype == torch.float32 and _equal(re, real.astype(np.float32))
    assert not im.any()
    c = ttypes.combine_planes(torch.as_tensor(z.real).to(torch.bfloat16),
                              torch.as_tensor(z.imag))
    jc = jtypes.combine_planes(np.asarray(torch.as_tensor(z.real).to(torch.bfloat16).float()),
                               z.imag)
    assert c.dtype == torch.complex64 and _equal(c, jc)


def test_from_complex_matches_jax(rng):
    z = _spectra(rng, 2, 16, 9)
    sd = tfc.SpectralData.from_complex(z, 16, 16, 10, 12, device="cpu")
    jsd = jfc.SpectralData.from_complex(z, 16, 16, 10, 12)
    assert _equal(sd.re, jsd.re) and _equal(sd.im, jsd.im)
    assert (sd.fft_h, sd.fft_w, sd.data_h, sd.data_w) == (16, 16, 10, 12)
    assert (sd.batch_size, sd.cfft_w, sd.feature_dim) == (1, 9, 2)
    assert _equal(sd.fft, jsd.fft)


@pytest.mark.parametrize("shape,fft_w", [((2, 24, 13), None), ((24, 13), None),
                                         ((3, 2, 24, 13), None), ((2, 24, 13), 25)])
def test_from_packed_matches_jax(rng, shape, fft_w):
    z = _spectra(rng, *shape)
    for src in (z, (z.real, z.imag), torch.as_tensor(z)):
        sd = tfc.SpectralData.from_packed(src, 20, 22, fft_w=fft_w, device="cpu")
        jsrc = (z.real, z.imag) if isinstance(src, tuple) else z
        jsd = jfc.SpectralData.from_packed(jsrc, 20, 22, fft_w=fft_w)
        assert _equal(sd.re, jsd.re) and _equal(sd.im, jsd.im)
        assert (sd.fft_h, sd.fft_w) == (jsd.fft_h, jsd.fft_w) == (24, fft_w or 24)
        assert sd.batch_size == jsd.batch_size
    with pytest.raises(ValueError, match="inconsistent"):
        tfc.SpectralData.from_packed(z, 20, 22, fft_w=(fft_w or 24) + 2, device="cpu")


def test_from_packed_convolves_as_fft_data(rng):
    """A user's own rfft2 of the zero-padded data, loaded by ``from_packed``,
    convolves as ``fft_data``'s spectrum."""
    data = rng.standard_normal((20, 24, 2)).astype(np.float32)
    kern = rng.standard_normal((5, 5, 2)).astype(np.float32)
    sd_ref = tfc.fft_data(data, 5, 5, device="cpu")
    raw = tconv.rfft2_padded(torch.as_tensor(_cf(data)), sd_ref.fft_h, sd_ref.fft_w)
    sd = tfc.SpectralData.from_packed(raw, data_h=20, data_w=24)
    assert torch.equal(sd.re, sd_ref.re) and torch.equal(sd.im, sd_ref.im)
    got = tfc.conv_spectral(sd, [kern], mode="full")[0]
    want = tfc.conv_spectral(sd_ref, [kern], mode="full")[0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("fft_h,fft_w,f", [(32, 32, 3), (31, 30, 2), (25, 27, 1)])
def test_from_reference_packed_matches_jax(rng, fft_h, fft_w, f):
    """The reference's H-packed (CFFT_H, FFT_W, F) layout, even and odd
    FFT_H: the same planes as the JAX package's gather, bitwise, and the
    rfft2 of the same data within fp32 rounding."""
    data = rng.standard_normal((20, 24, f)).astype(np.float32)
    padded = np.zeros((fft_h, fft_w, f))
    padded[:20, :24] = data
    packed = np.fft.fft2(padded, axes=(0, 1))[: fft_h // 2 + 1].astype(np.complex64)
    src = packed[..., 0] if f == 1 else packed
    explicit = {} if fft_h % 2 == 0 else {"fft_h": fft_h}
    sd = tfc.SpectralData.from_reference_packed(src, 20, 24, device="cpu", **explicit)
    jsd = jfc.SpectralData.from_reference_packed(src, 20, 24, **explicit)
    assert _equal(sd.re, jsd.re) and _equal(sd.im, jsd.im)
    assert (sd.fft_h, sd.fft_w, sd.feature_dim) == (fft_h, fft_w, f)
    want = np.fft.rfft2(np.moveaxis(padded, -1, 0))
    assert rel_err(sd.re.numpy(), want.real) < TOL and rel_err(sd.im.numpy(), want.imag) < TOL
    pair = tfc.SpectralData.from_reference_packed((src.real, src.imag), 20, 24, device="cpu",
                                                  **explicit)
    assert torch.equal(pair.re, sd.re) and torch.equal(pair.im, sd.im)
    with pytest.raises(ValueError, match="inconsistent"):
        tfc.SpectralData.from_reference_packed(src, 20, 24, fft_h=fft_h + 2, device="cpu")


def test_container_fft_properties(rng):
    data = rng.standard_normal((2, 40, 30, 2)).astype(np.float32)
    sdt = tfc.fft_data_tiled(data, 5, 5, device="cpu")
    assert sdt.batch_size == 2 and sdt.fft.dtype == torch.complex64
    assert torch.equal(sdt.fft.real, sdt.re) and torch.equal(sdt.fft.imag, sdt.im)
    sk = tfc.fft_kernels(rng.standard_normal((3, 5, 5, 2)).astype(np.float32), spectral=sdt)
    assert torch.equal(sk.fft.imag, sk.im) and tuple(sk.fft.shape) == tuple(sk.re.shape)
    assert tfc.fft_data(data, 5, 5, device="cpu").batch_size == 2


def test_interop_numpy_input_needs_a_device_without_a_card(rng, monkeypatch):
    """Array input goes to the card when ``device`` is None: without one the
    constructors raise (utils/device.py); nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tfc.InvalidInputError, match="device='cpu'"):
        tfc.SpectralData.from_complex(_spectra(rng, 1, 8, 5), 8, 8, 4, 4)
    with pytest.raises(tfc.InvalidInputError, match="device='cpu'"):
        tfc.fft_conv_stack(np.zeros((1, 8, 8), np.float32), np.zeros((2, 1, 3, 3), np.float32))
