"""The spectral-MAC kernel path of the port, which every engine runs,
against the JAX package's Pallas MAC (``spectral_mac_pallas_planes``,
interpret mode on the CPU) and its ``use_pallas=True`` engines, on its own
and through the direct and unfused tiled engines; its first and second
derivatives against the einsum's; and ``use_pallas``, which selects
nothing in the port.

Tolerance: 1e-5 relative to the largest |value| (the repo's fp32 bar). On
the CPU the wrapper runs the kernel's plain version (the einsum); the CUDA
kernel is held to it on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_fft_convolution_torch as tfc
import cuda_fft_convolution_tpu as jfc
from cuda_fft_convolution_torch.ops import spectral_mac as tmac
from cuda_fft_convolution_torch.utils import config as tconfig
from cuda_fft_convolution_tpu.ops import spectral_mac as jmac
from tests.oracles import fft_conv_full_f64, rel_err

TOL = 1e-5


def _planes(rng, b, n, f, h, wc):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, f, h, wc),) * 2 + ((n, f, h, wc),) * 2]


@pytest.mark.parametrize("f", [1, 3])
def test_mac_kernel_path_matches_jax_pallas(rng, f):
    planes = _planes(rng, 2, 5, f, 13, 9)
    before = tmac.spectral_mac.launches
    got = tmac.spectral_mac_auto_planes(
        *map(torch.as_tensor, planes), use_pallas=True)
    want = jmac.spectral_mac_pallas_planes(*map(jnp.asarray, planes), interpret=True)
    assert tmac.spectral_mac.launches == before  # no kernel on the CPU
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (2, 5, 13, 9)
        assert rel_err(g.numpy(), np.asarray(w)) < TOL
    # the wrapper alone is the plain version on CPU tensors
    plain = tmac.spectral_mac_planes(*map(torch.as_tensor, planes))
    for g, w in zip(tmac.spectral_mac(*map(torch.as_tensor, planes)), plain):
        assert torch.equal(g, w)


@pytest.mark.parametrize("f", [1, 3])
def test_fft_conv_direct_use_pallas_matches_jax(rng, f):
    data = rng.standard_normal((50, 61, f)).astype(np.float32)
    bank = rng.standard_normal((3, 7, 9, f)).astype(np.float32)
    got = tfc.fft_conv(data, kernels=bank, mode="full", algorithm="direct",
                       use_pallas=True, device="cpu")
    want = jfc.fft_conv(data, kernels=bank, mode="full", algorithm="direct",
                        use_pallas=True)
    assert tuple(got.shape) == np.shape(want) == (3, 56, 69)
    assert rel_err(got.numpy(), np.asarray(want)) < TOL
    oracle = np.stack([fft_conv_full_f64(data, k) for k in bank])
    assert rel_err(got.numpy(), oracle) < TOL


def test_tiled_unfused_use_pallas_matches_jax(rng):
    """The unfused tiled branch runs its MAC through the kernel path too."""
    data = rng.standard_normal((2, 130, 170, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 9, 13, 2)).astype(np.float32)
    tfc.set_config(use_fused_block_conv=False)
    jfc.set_config(use_fused_block_conv=False)
    try:
        spec = tfc.fft_data_tiled(data, 9, 13, trim_mode="same", device="cpu")
        got = tfc.conv_spectral(spec, bank, mode="same", use_pallas=True)
        jspec = jfc.fft_data_tiled(data, 9, 13, trim_mode="same")
        want = jfc.conv_spectral(jspec, bank, mode="same", use_pallas=True)
    finally:
        tfc.set_config(use_fused_block_conv=None)
        jfc.set_config(use_fused_block_conv=None)
    assert tuple(got.shape) == np.shape(want) == (2, 3, 130, 170)
    assert rel_err(got.numpy(), np.asarray(want)) < TOL


def test_mac_kernel_gradient_is_the_einsums(rng):
    """The autograd.Function's backward is the einsum's autograd: equal
    gradients for all four planes, matching JAX's custom VJP
    (``_mac_pallas_ad``); and so are its second derivatives, which the
    backward's ``create_graph`` keeps."""
    planes = _planes(rng, 2, 3, 2, 7, 5)
    cot = [rng.standard_normal((2, 3, 7, 5)).astype(np.float32) for _ in range(2)]
    tan = rng.standard_normal((2, 2, 7, 5)).astype(np.float32)

    def loss(mac, *xs):
        return sum((o * torch.as_tensor(c)).sum() for o, c in zip(mac(*xs), cot))

    def grads(mac):
        xs = [torch.as_tensor(p).requires_grad_(True) for p in planes]
        return torch.autograd.grad(loss(mac, *xs), xs)

    def second(mac):
        """d/dk_re of <d loss/d d_re, tan>."""
        xs = [torch.as_tensor(p).requires_grad_(True) for p in planes]
        (g_dr,) = torch.autograd.grad(loss(mac, *xs), [xs[0]], create_graph=True)
        return torch.autograd.grad((g_dr * torch.as_tensor(tan)).sum(), [xs[2]])[0]

    kernel = grads(tmac.spectral_mac_auto_planes)
    einsum = grads(tmac.spectral_mac_planes)
    _, vjp = jax.vjp(
        lambda *a: jmac.spectral_mac_auto_planes(*a, use_pallas=True),
        *map(jnp.asarray, planes),
    )
    jax_grads = vjp(tuple(map(jnp.asarray, cot)))
    for g, e, j in zip(kernel, einsum, jax_grads):
        assert torch.equal(g, e)
        assert rel_err(g.numpy(), np.asarray(j)) < TOL

    def jloss(*a):
        out = jmac.spectral_mac_auto_planes(*a, use_pallas=True)
        return sum(jnp.sum(o * c) for o, c in zip(out, cot))

    jax_second = jax.grad(
        lambda *a: jnp.sum(jax.grad(jloss)(*a) * tan), argnums=2,
    )(*map(jnp.asarray, planes))
    got = second(tmac.spectral_mac_auto_planes)
    assert torch.equal(got, second(tmac.spectral_mac_planes))
    assert rel_err(got.numpy(), np.asarray(jax_second)) < TOL
    # a gradient for only some planes
    xs = [torch.as_tensor(p) for p in planes]
    xs[2].requires_grad_(True)
    out = tmac.spectral_mac_auto_planes(*xs, use_pallas=True)
    (g2,) = torch.autograd.grad(out[0].sum() + out[1].sum(), [xs[2]])
    assert g2.shape == xs[2].shape


@pytest.mark.parametrize("f", [1, 3, 31])
@pytest.mark.parametrize("wanted", ["all", "kernel planes", "data planes", "k_im"])
def test_mac_backward_matches_jax_vjp(rng, monkeypatch, f, wanted):
    """The backward computes the einsum's two cotangents as MACs of their
    own, dD = MAC(g, conj(K)ᵀ) and dK = MAC(gᵀ, conj(D)ᵀ), with no forward
    recomputed and only the cotangents asked for: against ``jax.vjp`` of
    the JAX package's ``spectral_mac_planes`` (1e-5), with B, N > 1, and
    the MACs the backward ran counted by their output shapes."""
    b, n, h, wc = 2, 3, 6, 5
    planes = _planes(rng, b, n, f, h, wc)
    cot = [rng.standard_normal((b, n, h, wc)).astype(np.float32) for _ in range(2)]
    need = {"all": (1, 1, 1, 1), "kernel planes": (0, 0, 1, 1),
            "data planes": (1, 1, 0, 0), "k_im": (0, 0, 0, 1)}[wanted]
    xs = [torch.tensor(p, requires_grad=bool(r)) for p, r in zip(planes, need)]
    out = tmac.spectral_mac_auto_planes(*xs)
    shapes = []
    real = tmac.spectral_mac

    def spy(*a):
        shapes.append(tuple(a[0].shape[:1]) + tuple(a[2].shape[:1]))
        return real(*a)

    monkeypatch.setattr(tmac, "spectral_mac", spy)
    got = torch.autograd.grad(out, [x for x in xs if x.requires_grad],
                              [torch.as_tensor(c) for c in cot])
    want_shapes = ([(b, f)] if any(need[:2]) else []) + ([(n, f)] if any(need[2:]) else [])
    assert shapes == want_shapes  # one MAC per cotangent, no forward
    _, vjp = jax.vjp(jmac.spectral_mac_planes, *map(jnp.asarray, planes))
    want = [w for w, r in zip(vjp(tuple(map(jnp.asarray, cot))), need) if r]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert rel_err(g.numpy(), np.asarray(w)) < TOL


def test_reset_launches_clears_the_counts_by_shape():
    """``reset_launches`` sets the MAC kernel's counts to zero: in total,
    by mode and by (mode, B, F, N, H, Wc)."""
    from cuda_fft_convolution_torch.ops.block_conv import reset_launches

    mac = tmac.spectral_mac
    saved = mac.launches, dict(mac.launches_by_mode), dict(mac.launches_by_shape)
    try:
        mac.launches += 1
        mac.launches_by_mode["spectral_mac_f32"] += 1
        mac.launches_by_shape[("spectral_mac_f32", 1, 3, 5, 7, 4)] += 1
        reset_launches(mac)
        assert (mac.launches, dict(mac.launches_by_mode), dict(mac.launches_by_shape)) == (
            0, {}, {})
    finally:
        mac.launches = saved[0]
        mac.launches_by_mode.update(saved[1])
        mac.launches_by_shape.update(saved[2])


def test_use_pallas_config_and_env(rng, monkeypatch):
    """The MAC runs through the kernel path whatever ``use_pallas`` says:
    the option is accepted for the JAX package's signature, and the port's
    configuration reads ``Config.use_pallas`` from ``FFTCONV_USE_PALLAS``
    as JAX's does, with no effect."""
    data = rng.standard_normal((40, 40, 1)).astype(np.float32)
    bank = rng.standard_normal((2, 5, 5, 1)).astype(np.float32)
    calls = []
    real = tmac._SpectralMac.apply

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(tmac._SpectralMac, "apply", spy)
    monkeypatch.setenv("FFTCONV_USE_PALLAS", "0")
    assert tconfig.Config.from_env().use_pallas is False
    maps = [tfc.fft_conv(data, kernels=bank, mode="same", algorithm="direct", **kw, device="cpu")
            for kw in ({}, dict(use_pallas=False), dict(use_pallas=True))]
    try:
        tfc.set_config(use_pallas=False)
        maps.append(tfc.fft_conv(data, kernels=bank, mode="same", algorithm="direct",
                                 device="cpu"))
    finally:
        tfc.set_config(use_pallas=None)
    assert calls == [1, 1, 1, 1]
    assert all(torch.equal(maps[0], m) for m in maps[1:])
