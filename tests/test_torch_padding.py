"""The port's clamp padding and centered kernels against the JAX package.

``ops/padding.py`` ``pad_clamp_to_border`` and ``pad_kernel_centered``
against their JAX twins (equal arrays); ``fft_conv``, ``fft_data`` +
``conv_spectral`` and ``conv_spectral_pipelined`` at ``padding='clamp'`` and
``kernel_layout='centered'`` against the JAX calls and the float64 oracles
(≤1e-5 at float32), mirroring ``tests/test_padding.py`` and
``tests/test_padding_api.py`` (their shapes, both ``same_offset`` values,
odd and even kernels, ragged centered banks, the errors); the bf16 tier and
bf16 maps with clamp or centered kernels at their bars (2e-2, 5e-3); and
the edge-padded float64 reference ``chip_smoke.py`` holds the clamp
headline to, against ``conv_same_nearest_f64``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import cuda_fft_convolution_torch as tfc
import cuda_fft_convolution_tpu as jfc
from cuda_fft_convolution_torch.ops import padding as tpad
from cuda_fft_convolution_tpu.ops import padding as jpad
from tests.oracles import conv_same_nearest_f64, fft_map_f64, rel_err

TOL = 1e-5
BF16_TOL = 2e-2
BF16_OUT_TOL = 5e-3
CPU = dict(device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _clamp_pad_f64(x, fft_h, fft_w, bh, bw):
    """float64 oracle of the three-region rule (tests/test_padding_api.py)."""
    h, w = x.shape
    ih, iw = np.arange(fft_h), np.arange(fft_w)
    rows = np.where(ih < h, ih, np.where(ih < h + bh, h - 1, 0))
    cols = np.where(iw < w, iw, np.where(iw < w + bw, w - 1, 0))
    return x[np.ix_(rows, cols)]


# ---------------------------------------------------------------------------
# the padding ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,fft,border",
    [
        ((4, 6), (8, 12), (2, 3)),  # tests/test_padding.py's case
        ((3, 5, 7), (16, 9), (0, 0)),  # a (0, 0) band: the whole pad wraps to 0
        ((2, 3, 10, 4), (13, 11), (3, 7)),  # rank 4, a band filling the pad
        ((1, 6, 6), (6, 6), (1, 1)),  # no pad at all
    ],
)
def test_pad_clamp_to_border_matches_jax(rng, shape, fft, border):
    x = rng.standard_normal(shape).astype(np.float32)
    got = tpad.pad_clamp_to_border(torch.as_tensor(x), *fft, *border)
    want = np.asarray(jpad.pad_clamp_to_border(jnp.asarray(x), *fft, *border))
    assert tuple(got.shape) == want.shape == shape[:-2] + fft
    assert np.array_equal(got.numpy(), want)
    if len(shape) == 2:
        assert np.array_equal(got.numpy(), _clamp_pad_f64(x, *fft, *border))


@pytest.mark.parametrize(
    "shape,fft",
    [((5, 3), (16, 16)), ((2, 6, 4), (9, 10)), ((3, 2, 7, 8), (7, 8)), ((1, 1), (4, 4))],
)
def test_pad_kernel_centered_matches_jax(rng, shape, fft):
    k = rng.standard_normal(shape).astype(np.float32)
    got = tpad.pad_kernel_centered(torch.as_tensor(k), *fft)
    want = np.asarray(jpad.pad_kernel_centered(jnp.asarray(k), *fft))
    assert np.array_equal(got.numpy(), want)
    kh, kw = shape[-2:]
    assert got[..., 0, 0].tolist() == torch.as_tensor(k)[..., kh // 2, kw // 2].tolist()


def test_padding_ops_reject_oversize(rng):
    x = torch.as_tensor(rng.standard_normal((5, 7)).astype(np.float32))
    with pytest.raises(ValueError):
        tpad.pad_clamp_to_border(x, 4, 7, 1, 1)
    with pytest.raises(ValueError):
        tpad.pad_kernel_centered(x, 5, 6)
    assert tpad.pad_to_fft(x, 5, 7) is x


# ---------------------------------------------------------------------------
# the API at clamp and centered (tests/test_padding_api.py)
# ---------------------------------------------------------------------------


def test_fft_conv_padding_clamp_vs_oracle(rng):
    data = rng.standard_normal((40, 36, 2)).astype(np.float32)
    kern = rng.standard_normal((7, 5, 2)).astype(np.float32)
    kw = dict(mode="fftmap", padding="clamp", policy="fast")
    out = tfc.fft_conv(data, 7, 5, [kern], **kw, **CPU)[0].numpy()
    want = np.asarray(jfc.fft_conv(data, 7, 5, [kern], **kw))[0]
    fft_h, fft_w = out.shape
    ref = np.zeros((fft_h, fft_w))
    for c in range(2):
        dp = _clamp_pad_f64(data[:, :, c].astype(np.float64), fft_h, fft_w, 3, 2)
        kf = np.fft.fft2(kern[:, :, c].astype(np.float64), (fft_h, fft_w))
        ref += np.real(np.fft.ifft2(np.fft.fft2(dp) * kf))
    assert rel_err(out, want) < TOL
    assert rel_err(out, ref) < TOL


@pytest.mark.parametrize("ksz,off", [((7, 5), "scipy"), ((6, 4), "matlab"), ((6, 5), "scipy")])
def test_clamp_same_equals_nearest_boundary(rng, ksz, off):
    """mode='same' + clamp = direct convolution with replicated borders on
    every edge, at exact-fit FFT sizes (policy='fast')."""
    kh, kw = ksz
    data = rng.standard_normal((26, 28)).astype(np.float32)
    kern = rng.standard_normal((kh, kw)).astype(np.float32)
    kw_ = dict(mode="same", padding="clamp", policy="fast", same_offset=off)
    out = tfc.fft_conv(data[:, :, None], kh, kw, [kern[:, :, None]], **kw_, **CPU)[0].numpy()
    want = np.asarray(jfc.fft_conv(data[:, :, None], kh, kw, [kern[:, :, None]], **kw_))[0]
    dh = kh // 2 if off == "matlab" else (kh - 1) // 2
    dw = kw // 2 if off == "matlab" else (kw - 1) // 2
    ref = conv_same_nearest_f64(data.astype(np.float64), kern.astype(np.float64), dh, dw)
    assert out.shape == ref.shape
    assert rel_err(out, want) < TOL
    assert rel_err(out, ref) < TOL


def test_fft_data_padding_clamp_split_api(rng):
    """fft_data(padding='clamp') → conv_spectral = the one-shot call, and the
    spectra equal the JAX package's."""
    data = rng.standard_normal((30, 30, 1)).astype(np.float32)
    kern = rng.standard_normal((6, 6, 1)).astype(np.float32)
    one = tfc.fft_conv(data, 6, 6, [kern], mode="fftmap", padding="clamp", **CPU)
    sd = tfc.fft_data(data, 6, 6, padding="clamp", **CPU)
    jsd = jfc.fft_data(data, 6, 6, padding="clamp")
    assert (sd.clamp, sd.band_h, sd.band_w) == (jsd.clamp, jsd.band_h, jsd.band_w)
    assert rel_err(sd.re.numpy(), np.asarray(jsd.re)) < TOL
    split = tfc.conv_spectral(sd, [kern], mode="fftmap")
    assert torch.allclose(one, split, atol=1e-6)
    assert rel_err(split.numpy(), np.asarray(jfc.conv_spectral(jsd, [kern], mode="fftmap"))) < TOL


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("layout,off", [("corner", "scipy"), ("corner", "matlab"),
                                        ("centered", "scipy")])
def test_clamp_spectra_modes_match_jax(rng, batched, layout, off):
    """Clamp spectra through conv_spectral (same, valid, fftmap) and
    conv_spectral_pipelined, batched and not, at each anchor convention."""
    shape = (2, 24, 20, 2) if batched else (24, 20, 2)
    data = rng.standard_normal(shape).astype(np.float32)
    bank = rng.standard_normal((3, 6, 5, 2)).astype(np.float32)
    sd = tfc.fft_data(data, 6, 5, padding="clamp", same_offset=off, kernel_layout=layout, **CPU)
    jsd = jfc.fft_data(data, 6, 5, padding="clamp", same_offset=off, kernel_layout=layout)
    modes = ("same", "fftmap") if layout == "centered" else ("same", "valid", "fftmap")
    for mode in modes:
        kw = dict(mode=mode, same_offset=off, kernel_layout=layout)
        got = tfc.conv_spectral(sd, bank, **kw)
        want = np.asarray(jfc.conv_spectral(jsd, bank, **kw))
        assert tuple(got.shape) == want.shape, mode
        assert rel_err(got.numpy(), want) < TOL, mode
    if layout == "corner":
        piped = tfc.conv_spectral_pipelined(sd, bank, chunk_size=2, mode="same", same_offset=off)
        want = np.asarray(jfc.conv_spectral_pipelined(jsd, bank, chunk_size=2, mode="same",
                                                      same_offset=off))
        assert rel_err(piped.numpy(), want) < TOL


def test_kernel_layout_centered_equals_matlab_same(rng):
    """Centered kernels give un-shifted maps: mode='same' centered = corner
    with the MATLAB Kh//2 offset; the scipy offset differs for even kernels."""
    data = rng.standard_normal((32, 28, 3)).astype(np.float32)
    for ksz in [(6, 4), (5, 7)]:
        kern = rng.standard_normal((*ksz, 3)).astype(np.float32)
        cent = tfc.fft_conv(data, kernels=[kern], mode="same", kernel_layout="centered", **CPU)
        jcent = np.asarray(jfc.fft_conv(data, kernels=[kern], mode="same",
                                        kernel_layout="centered"))
        matl = tfc.fft_conv(data, kernels=[kern], mode="same", same_offset="matlab",
                            algorithm="direct", **CPU)
        scip = tfc.fft_conv(data, kernels=[kern], mode="same", algorithm="direct", **CPU)
        assert rel_err(cent.numpy(), jcent) < TOL
        assert rel_err(cent.numpy(), matl.numpy()) < TOL
        if ksz[0] % 2 == 1 and ksz[1] % 2 == 1:
            assert rel_err(cent.numpy(), scip.numpy()) < TOL
        else:
            assert rel_err(cent.numpy(), scip.numpy()) > 1e-3


@pytest.mark.parametrize("mode", ["same", "fftmap"])
def test_centered_ragged_bank(rng, mode):
    """Each ragged kernel centres at its own size, in fft_kernels and in the
    raw-kernel path of conv_spectral, as in the JAX package."""
    data = rng.standard_normal((24, 24, 1)).astype(np.float32)
    kerns = [rng.standard_normal(s + (1,)).astype(np.float32) for s in ((5, 5), (9, 3), (4, 6))]
    cent = tfc.fft_conv(data, kernels=kerns, mode=mode, kernel_layout="centered",
                        bucket_ragged=False, **CPU)
    jcent = jfc.fft_conv(data, kernels=kerns, mode=mode, kernel_layout="centered",
                         bucket_ragged=False)
    if mode == "fftmap":
        assert rel_err(cent.numpy(), np.asarray(jcent)) < TOL
        sd = tfc.fft_data(data, 9, 6, **CPU)
        sk = tfc.fft_kernels(kerns, spectral=sd, kernel_layout="centered")
        jsk = jfc.fft_kernels(kerns, spectral=jfc.fft_data(data, 9, 6), kernel_layout="centered")
        assert sk.centered and jsk.centered
        assert rel_err(sk.re.numpy(), np.asarray(jsk.re)) < TOL
        return
    for k, c, j in zip(kerns, cent, jcent):
        m = tfc.fft_conv(data, kernels=[k], mode="same", same_offset="matlab",
                         algorithm="direct", **CPU)[0]
        assert rel_err(c.numpy(), m.numpy()) < TOL
        assert rel_err(c.numpy(), np.asarray(j)) < TOL


def test_matlab_same_offset_tiled_matches_direct(rng):
    data = rng.standard_normal((96, 96, 1)).astype(np.float32)
    kerns = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    kw = dict(mode="same", same_offset="matlab")
    t = tfc.fft_conv(data, 8, 8, kerns, algorithm="tiled", **kw, **CPU)
    d = tfc.fft_conv(data, 8, 8, kerns, algorithm="direct", **kw, **CPU)
    assert rel_err(t.numpy(), d.numpy()) < TOL
    assert rel_err(d.numpy(), np.asarray(jfc.fft_conv(data, 8, 8, kerns, algorithm="direct",
                                                      **kw))) < TOL
    s = tfc.fft_conv(data, 8, 8, kerns, mode="same", algorithm="direct", **CPU)
    np.testing.assert_allclose(d.numpy()[:, :-1, :-1], s.numpy()[:, 1:, 1:], atol=1e-4)


def _both_raise(call, match):
    """``call(package, extra_kwargs)`` raises InvalidInputError matching
    ``match`` in both packages."""
    with pytest.raises(tfc.InvalidInputError, match=match):
        call(tfc, CPU)
    with pytest.raises(jfc.InvalidInputError, match=match):
        call(jfc, {})


def test_centered_rejects_unsupported_combos(rng):
    data = rng.standard_normal((16, 16, 1)).astype(np.float32)
    kern = rng.standard_normal((4, 4, 1)).astype(np.float32)
    _both_raise(lambda p, c: p.fft_conv(data, kernels=[kern], mode="full",
                                        kernel_layout="centered", **c), "centered")
    _both_raise(lambda p, c: p.fft_conv(data, kernels=[kern], mode="same",
                                        kernel_layout="centered", algorithm="tiled", **c),
                "direct")
    _both_raise(lambda p, c: p.fft_kernels([kern], 16, 16, kernel_layout="centered",
                                           correlation=True, **c), "pre-flipped")
    _both_raise(lambda p, c: p.fft_conv(data, kernels=[kern], mode="same", padding="clamp",
                                        algorithm="tiled", **c), "direct")
    _both_raise(lambda p, c: p.fft_kernels([kern], 16, 16, kernel_layout="centered",
                                           storage="flat", **c), "corner")
    # a centered bank meets tiled spectra: refused by both engines' entries
    _both_raise(lambda p, c: p.conv_spectral(
        p.fft_data_tiled(data, 4, 4, **c), [kern], mode="same", kernel_layout="centered"),
        "direct engine")
    sd = tfc.fft_data_tiled(data, 4, 4, **CPU)
    sk = tfc.fft_kernels([kern], spectral=sd, **CPU)
    centered = tfc.fft_kernels([kern], sd.block_h, sd.block_w, kernel_layout="centered", **CPU)
    assert not sk.centered and centered.centered
    for call in (tfc.conv_spectral, tfc.conv_spectral_pipelined):
        with pytest.raises(tfc.InvalidInputError, match="direct engine"):
            call(sd, centered, mode="same")
    _both_raise(lambda p, c: p.fft_conv(data, kernels=[kern], padding="edge", **c),
                "padding")
    _both_raise(lambda p, c: p.fft_conv(data, kernels=[kern], kernel_layout="middle", **c),
                "kernel_layout")


def test_centered_kernels_checkpoint_roundtrip(rng, tmp_path):
    """A centered bank saved by either package loads centered into the
    other and convolves to the same maps."""
    data = rng.standard_normal((12, 12, 1)).astype(np.float32)
    kern = rng.standard_normal((5, 5, 1)).astype(np.float32)
    sk = tfc.fft_kernels([kern], 16, 16, kernel_layout="centered", **CPU)
    assert sk.centered
    tfc.save_spectral(str(tmp_path / "t.npz"), sk)
    jback = jfc.load_spectral(str(tmp_path / "t.npz"))
    assert jback.centered is True
    jfc.save_spectral(str(tmp_path / "j.npz"), jfc.fft_kernels([kern], 16, 16,
                                                              kernel_layout="centered"))
    back = tfc.load_spectral(str(tmp_path / "j.npz"), **CPU)
    assert back.centered is True
    assert rel_err(back.re.numpy(), sk.re.numpy()) < TOL
    sd = tfc.fft_data(data, 5, 5, policy="pow2", **CPU)
    maps = tfc.conv_spectral(sd, back, mode="same")
    want = jfc.conv_spectral(jfc.fft_data(data, 5, 5, policy="pow2"), jback, mode="same")
    assert rel_err(maps.numpy(), np.asarray(want)) < TOL


def test_clamp_full_mode_rejected(rng):
    """mode='full' under clamp is an error on every entry point; 'valid'
    never reads the pad and equals the zero-padded 'valid'."""
    data = rng.standard_normal((24, 24, 1)).astype(np.float32)
    kern = rng.standard_normal((5, 5, 1)).astype(np.float32)
    _both_raise(lambda p, c: p.fft_conv(data, 5, 5, [kern], mode="full", padding="clamp", **c),
                "clamp")
    sd = tfc.fft_data(data, 5, 5, padding="clamp", **CPU)
    jsd = jfc.fft_data(data, 5, 5, padding="clamp")
    assert sd.clamp
    for call in ("conv_spectral", "conv_spectral_pipelined"):
        _both_raise(lambda p, c: getattr(p, call)(sd if p is tfc else jsd, [kern], mode="full"),
                    "clamp")
    v_clamp = tfc.conv_spectral(sd, [kern], mode="valid")
    v_zero = tfc.conv_spectral(tfc.fft_data(data, 5, 5, **CPU), [kern], mode="valid")
    np.testing.assert_allclose(v_clamp.numpy(), v_zero.numpy(), atol=1e-5)


def test_clamp_flag_checkpoint_roundtrip(rng, tmp_path):
    """Clamp spectra saved by either package load with their flag and band
    and convolve (no longer refused) to the JAX maps."""
    data = rng.standard_normal((20, 20, 1)).astype(np.float32)
    kern = rng.standard_normal((4, 4, 1)).astype(np.float32)
    jsd = jfc.fft_data(data, 4, 4, padding="clamp", same_offset="matlab")
    jfc.save_spectral(str(tmp_path / "j.npz"), jsd)
    sd = tfc.load_spectral(str(tmp_path / "j.npz"), **CPU)
    assert (sd.clamp, sd.band_h, sd.band_w) == (True, 2, 2)
    got = tfc.conv_spectral(sd, [kern], mode="same", same_offset="matlab")
    want = jfc.conv_spectral(jsd, [kern], mode="same", same_offset="matlab")
    assert rel_err(got.numpy(), np.asarray(want)) < TOL
    with pytest.raises(tfc.InvalidInputError, match="clamp"):
        tfc.conv_spectral(sd, [kern], mode="full")
    tfc.save_spectral(str(tmp_path / "t.npz"), sd)
    jback = jfc.load_spectral(str(tmp_path / "t.npz"))
    assert jback.clamp is True and (jback.band_h, jback.band_w) == (2, 2)


def test_clamp_centered_even_kernel_default_offset(rng):
    """Clamp + centered with an even kernel at the default offset: the band
    is the centered anchor K//2."""
    data = rng.standard_normal((26, 24, 1)).astype(np.float32)
    kern = rng.standard_normal((6, 6, 1)).astype(np.float32)
    kw = dict(mode="same", padding="clamp", kernel_layout="centered")
    out = tfc.fft_conv(data, 6, 6, [kern], **kw, **CPU)[0].numpy()
    want = np.asarray(jfc.fft_conv(data, 6, 6, [kern], **kw))[0]
    ref = conv_same_nearest_f64(data[:, :, 0], kern[:, :, 0], 3, 3)
    assert out.shape == ref.shape
    assert rel_err(out, ref) < TOL
    assert rel_err(out, want) < TOL


def test_clamp_band_mismatch_rejected(rng):
    """The 'same' trim refuses a kernel whose anchor the recorded band
    cannot serve, with the JAX message, and runs where it can."""
    data = rng.standard_normal((30, 30, 1)).astype(np.float32)
    k6 = rng.standard_normal((6, 6, 1)).astype(np.float32)
    k12 = rng.standard_normal((12, 12, 1)).astype(np.float32)

    def spectra(p, c, *args, **kw):
        return p.fft_data(data, *args, padding="clamp", **kw, **c)

    sd = spectra(tfc, CPU, 6, 6)
    assert (sd.band_h, sd.band_w) == (2, 2)
    _both_raise(lambda p, c: p.conv_spectral(spectra(p, c, 6, 6), [k6], mode="same",
                                             same_offset="matlab"), "band")
    _both_raise(lambda p, c: p.conv_spectral(spectra(p, c, 6, 6, policy="pow2"), [k12],
                                             mode="same"), "band")
    _both_raise(lambda p, c: p.conv_spectral(spectra(p, c, 6, 6), [k6], mode="same",
                                             kernel_layout="centered"), "band")
    for args, kw, kern, conv in (
        ((6, 6), {}, k6, {}),
        ((12, 12), {}, k12, {}),
        ((6, 6), dict(kernel_layout="centered"), k6, dict(kernel_layout="centered")),
    ):
        got = tfc.conv_spectral(spectra(tfc, CPU, *args, **kw), [kern], mode="same", **conv)
        want = jfc.conv_spectral(spectra(jfc, {}, *args, **kw), [kern], mode="same", **conv)
        assert rel_err(got.numpy(), np.asarray(want)) < TOL
    assert spectra(tfc, CPU, 6, 6, kernel_layout="centered").band_h == 3


def test_clamp_band_checkpoint_roundtrip(rng, tmp_path):
    data = rng.standard_normal((20, 20, 1)).astype(np.float32)
    sd = tfc.fft_data(data, 6, 6, padding="clamp", same_offset="matlab", **CPU)
    p = str(tmp_path / "band.npz")
    tfc.save_spectral(p, sd)
    sd2 = tfc.load_spectral(p, **CPU)
    assert (sd2.band_h, sd2.band_w) == (sd.band_h, sd.band_w) == (3, 3)
    with pytest.raises(tfc.InvalidInputError, match="band"):
        tfc.conv_spectral(sd2, [rng.standard_normal((6, 6, 1)).astype(np.float32)],
                          mode="same")
    tfc.save_spectral(p, tfc.fft_data(data, 6, 6, **CPU))
    back = tfc.load_spectral(p, **CPU)
    assert back.band_h == -1 and back.band_w == -1 and back.clamp is False


# ---------------------------------------------------------------------------
# the bf16 tier and bf16 maps (tests/test_bf16_tier.py, tests/test_out_dtype.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opts", [dict(padding="clamp"), dict(kernel_layout="centered"),
                                  dict(padding="clamp", kernel_layout="centered")],
                         ids=["clamp", "centered", "clamp-centered"])
def test_tier_composes_with_clamp_and_centered(rng, opts):
    """The bf16 tier × clamp / centered: the port's maps are bf16-tier
    float32 maps within the tier's bar of its float32 call and of the JAX
    tier call."""
    data = rng.standard_normal((40, 32, 2)).astype(np.float32)
    kerns = [rng.standard_normal((5, 5, 2)).astype(np.float32) for _ in range(2)]
    want = tfc.fft_conv(data, 5, 5, kerns, mode="same", **opts, **CPU)
    got = tfc.fft_conv(data, 5, 5, kerns, mode="same", store_dtype="bfloat16", **opts, **CPU)
    jgot = jfc.fft_conv(data, 5, 5, kerns, mode="same", store_dtype="bfloat16", **opts)
    assert got.dtype == torch.float32 and tuple(got.shape) == jgot.shape
    assert rel_err(_np(got), want.numpy()) < BF16_TOL
    assert rel_err(_np(got), _np(jgot)) < BF16_TOL
    # the tier's spectra and bank keep the clamp band and the centered flag
    sd = tfc.fft_data(data, 5, 5, store_dtype="bfloat16", **opts, **CPU)
    assert sd.re.dtype == torch.bfloat16 and sd.clamp == (opts.get("padding") == "clamp")
    sk = tfc.fft_kernels(kerns, spectral=sd, store_dtype="bfloat16",
                         kernel_layout=opts.get("kernel_layout", "corner"))
    split = tfc.conv_spectral(sd, sk, mode="same")
    assert rel_err(split.numpy(), got.numpy()) < 1e-6


@pytest.mark.parametrize("opts", [dict(padding="clamp"), dict(kernel_layout="centered")],
                         ids=["clamp", "centered"])
def test_bf16_maps_with_clamp_and_centered(rng, opts):
    data = rng.standard_normal((36, 30, 1)).astype(np.float32)
    bank = rng.standard_normal((3, 6, 6, 1)).astype(np.float32)
    want = tfc.fft_conv(data, kernels=bank, mode="same", **opts, **CPU)
    got = tfc.fft_conv(data, kernels=bank, mode="same", out_dtype="bfloat16", **opts, **CPU)
    jgot = jfc.fft_conv(data, kernels=bank, mode="same", out_dtype="bfloat16", **opts)
    assert got.dtype == torch.bfloat16 and str(jgot.dtype) == "bfloat16"
    assert rel_err(_np(got), want.numpy()) < BF16_OUT_TOL
    assert rel_err(_np(got), _np(jgot)) < BF16_OUT_TOL


# ---------------------------------------------------------------------------
# the smoke's float64 clamp reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ksz,anchor", [((7, 5), (3, 2)), ((6, 4), (3, 2)), ((6, 4), (2, 1)),
                                        ((1, 3), (0, 1))])
def test_smoke_clamp_reference_is_the_nearest_oracle(rng, ksz, anchor):
    """chip_smoke.clamp_same_reference_f64 (edge padding and a float64 FFT
    linear convolution, fast at full width) equals the tap-loop oracle."""
    image = rng.standard_normal((23, 31, 1)).astype(np.float32)
    bank = rng.standard_normal((2, *ksz, 1)).astype(np.float32)
    got = chip_smoke.clamp_same_reference_f64(image, bank, [1, 0], anchor)
    for g, i in zip(got, [1, 0]):
        want = conv_same_nearest_f64(image[:, :, 0], bank[i, :, :, 0], *anchor)
        assert g.shape == want.shape
        assert np.abs(g - want).max() <= 1e-12 * np.abs(want).max()
    # and the port's clamp call is within the bar of it
    off = "matlab" if anchor == (ksz[0] // 2, ksz[1] // 2) else "scipy"
    if anchor in (((ksz[0] - 1) // 2, (ksz[1] - 1) // 2), (ksz[0] // 2, ksz[1] // 2)):
        maps = tfc.fft_conv(image, kernels=bank, mode="same", padding="clamp",
                            same_offset=off, **CPU)
        assert rel_err(maps[[1, 0]].numpy(), got) < TOL


def test_smoke_centered_reference_is_the_fft_map(rng):
    """chip_smoke.same_reference_f64 at the matlab anchor is the centered
    'same' window of the float64 circular map."""
    image = rng.standard_normal((20, 18, 1)).astype(np.float32)
    bank = rng.standard_normal((2, 6, 5, 1)).astype(np.float32)
    got = chip_smoke.same_reference_f64(image, bank, [0, 1], anchor=(3, 2))
    for g, k in zip(got, bank):
        full = fft_map_f64(image, k, 25, 22)
        assert np.abs(g - full[3:23, 2:20]).max() <= 1e-12 * np.abs(g).max()
