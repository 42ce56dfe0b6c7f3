"""The port's bf16 serving tier (``store_dtype='bfloat16'``) and bf16 output
maps (``out_dtype='bfloat16'``) against the JAX package.

Bars: ``BF16_TOL`` = 2e-2 for the tier (``tests/test_bf16_tier.py``: the
tier's envelope against float32 and float64 maps; JAX's default Karatsuba
form and the port's 4-product form round S and X at other values) and
``BF16_OUT_TOL`` = 5e-3 for bf16 maps against float32 maps
(``tests/test_out_dtype.py``). The fused kernels run bf16 spectra at JAX's
BF16IO (S, X, G and M rounded to bf16 before each product;
``tests/test_torch_bf16io.py`` holds them to JAX's karatsuba=False form at
5e-5); at the explicit 3×TF32 (``splits=3``), and in the MAC, the port at
bf16 is held to itself at float32 exactly: bf16 planes give the float32
result of the bf16-rounded planes.
Also here: the mismatch and dtype validation with the JAX messages,
gradients through bf16 maps, bf16 checkpoints across the two packages, and
the HOG front end of the DPM path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_fft_convolution_torch as tfc
import cuda_fft_convolution_tpu as jfc
from cuda_fft_convolution_torch.models import (
    detect_local_peaks,
    detect_peaks,
    detect_top_k,
    hog_features,
)
from cuda_fft_convolution_torch.ops import block_conv as tbc
from cuda_fft_convolution_torch.ops import spectral_mac as tmac
from cuda_fft_convolution_torch.ops import tiled as tt
from cuda_fft_convolution_tpu.models import detect_local_peaks as j_local_peaks
from cuda_fft_convolution_tpu.models import detect_peaks as j_peaks
from cuda_fft_convolution_tpu.models import detect_top_k as j_top_k
from cuda_fft_convolution_tpu.models import hog_features as j_hog
from cuda_fft_convolution_tpu.ops import tiled as jt
from cuda_fft_convolution_tpu.ops.block_conv import (
    block_conv_pallas,
    block_conv_peaks_pallas,
)
from cuda_fft_convolution_tpu.ops.conv import rfft2_padded_planes as j_rfft2
from tests.oracles import fft_conv_full_f64, fft_map_f64, rel_err

BF16_TOL = 2e-2
BF16_OUT_TOL = 5e-3


def _cpu(p):
    """The port's CPU keyword for a call made through either package."""
    return dict(device="cpu") if p is tfc else {}


def _f32(x) -> np.ndarray:
    """Any array (torch bf16 included) as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32)).to(torch.bfloat16)


def _jbf16(x) -> jnp.ndarray:
    return jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)


def _window(full, kh, kw, h, w, mode):
    if mode == "full":
        return full
    if mode == "same":
        return full[(kh - 1) // 2 : (kh - 1) // 2 + h, (kw - 1) // 2 : (kw - 1) // 2 + w]
    return full[kh - 1 : h, kw - 1 : w]


# ---------------------------------------------------------------------------
# kernels A, B, C: the plain versions at bf16
# ---------------------------------------------------------------------------


def _block_operands(rng, b, f, n, bh, bw, kh, kw, h, w):
    """Block spectra of random data with a baked 'same' window and the
    spectra of a random spatial bank (JAX transforms, float32 planes)."""
    data = rng.standard_normal((b, f, h, w)).astype(np.float32)
    d_re, d_im = jt.fft_data_blocks(
        jnp.asarray(data), bh, bw, kh, kw, origin_h=(kh - 1) // 2,
        origin_w=(kw - 1) // 2, win_h=h, win_w=w,
    )
    bank = rng.standard_normal((n, f, kh, kw)).astype(np.float32)
    k_re, k_im = j_rfft2(jnp.asarray(bank), bh, bw)
    return [np.asarray(x) for x in (d_re, d_im, k_re, k_im)]


BLOCK_CASES = [
    # the JAX tier test's geometry (test_bf16_tier.py:222-228), 'same' window
    (1, 1, 2, 20, 36, 5, 5, 60, 90),
    # F=3, odd blocks, clipped edge tiles
    (2, 3, 3, 45, 151, 10, 24, 100, 300),
]


@pytest.mark.parametrize("b,f,n,bh,bw,kh,kw,h,w", BLOCK_CASES)
def test_block_conv_bf16_matches_jax_bf16io(rng, b, f, n, bh, bw, kh, kw, h, w):
    """Port plain block_conv on bf16 planes (BF16IO) against
    block_conv_pallas on the same bf16 planes (interpret mode, BF16IO in its
    default Karatsuba form), with float32 maps and with bf16 maps: the maps'
    dtype is JAX's, the values within the tier bar."""
    ops = _block_operands(rng, b, f, n, bh, bw, kh, kw, h, w)
    geom = (bh, bw, kh, kw, h, w)
    for out_dtype, t_out in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        want = block_conv_pallas(*map(_jbf16, ops), *geom, interpret=True,
                                 out_dtype=out_dtype)
        got = tbc.block_conv(*map(_bf16, ops), *geom, t_out)
        assert got.dtype == t_out and str(want.dtype) == out_dtype
        assert tuple(got.shape) == want.shape == (b, n, h, w)
        assert rel_err(_f32(got), _f32(want)) < BF16_TOL


def test_block_conv_peaks_bf16_matches_jax_at_plants(rng):
    """bf16 spectra of data with two planted templates through the peaks
    kernel's plain version and JAX's block_conv_peaks_pallas (BF16IO): the
    cells holding a plant report the planted centre on both sides, and the
    values agree within the tier bar."""
    b, f, n, bh, bw, kh, kw, h, w = 1, 2, 2, 20, 36, 5, 5, 60, 90
    data = rng.standard_normal((b, f, h, w)).astype(np.float32)
    bank = rng.standard_normal((n, f, kh, kw)).astype(np.float32)
    plants = [(10, 20), (40, 60)]
    for t, (y0, x0) in enumerate(plants):
        data[0, :, y0 : y0 + kh, x0 : x0 + kw] += 4.0 * bank[t]
    d_re, d_im = jt.fft_data_blocks(
        jnp.asarray(data), bh, bw, kh, kw, origin_h=(kh - 1) // 2,
        origin_w=(kw - 1) // 2, win_h=h, win_w=w,
    )
    k_re, k_im = j_rfft2(jnp.asarray(bank[:, :, ::-1, ::-1].copy()), bh, bw)
    ops = [np.asarray(x) for x in (d_re, d_im, k_re, k_im)]
    geom = (bh, bw, kh, kw, h, w)
    jv, ji = block_conv_peaks_pallas(*map(_jbf16, ops), *geom, interpret=True,
                                     mbh=1, mbw=1)
    gv, gi = tbc.block_conv_peaks(*map(_bf16, ops), *geom)
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    assert rel_err(gv.numpy(), np.asarray(jv)) < BF16_TOL
    vh, vw = bh - kh + 1, bw - kw + 1
    for t, (y0, x0) in enumerate(plants):
        cy, cx = y0 + kh // 2, x0 + kw // 2
        cell = (0, t, cy // vh, cx // vw)
        assert int(gi[cell]) == int(np.asarray(ji)[cell]) == cy * w + cx


def _mac_planes(rng):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 3, 9, 7), (2, 3, 9, 7), (4, 3, 9, 7), (4, 3, 9, 7))]


@pytest.mark.parametrize("kernel", ["block_conv", "block_conv_peaks", "spectral_mac",
                                    "block_conv_bf16io"])
def test_bf16_is_f32_on_the_rounded_planes(rng, kernel):
    """Each kernel's CPU path at bf16 equals its float32 path on the
    bf16-rounded planes upcast, max abs difference 0: the MAC, and the
    fused kernels at the explicit 3×TF32 tier (``splits=3``). Their default
    tier at bf16, BF16IO, rounds S, G, X and M as well, so its maps are not
    the float32 path's, though within the tier bar of them."""
    # the tier's arguments: the explicit 3×TF32, or the default (BF16IO)
    tier = {"block_conv": (torch.float32, 3), "block_conv_peaks": (3,), "spectral_mac": (),
            "block_conv_bf16io": (torch.float32, None)}[kernel]
    if kernel == "spectral_mac":
        ops, geom, fn = _mac_planes(rng), (), tmac.spectral_mac
    else:
        ops, geom = _block_operands(rng, *BLOCK_CASES[1]), BLOCK_CASES[1][3:]
        fn = getattr(tbc, kernel.removesuffix("_bf16io"))
    planes = [x.float() for x in map(_bf16, ops)]
    at16 = fn(*map(_bf16, ops), *geom, *tier)
    at32 = fn(*planes, *geom)
    if kernel == "block_conv_bf16io":  # held to JAX's BF16IO in test_torch_bf16io.py
        assert 1e-5 < rel_err(at16.numpy(), at32.numpy()) < BF16_TOL
        return
    for g, w in zip(at16, at32):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_spectral_mac_bf16_accumulates_f32(rng):
    """The MAC at bf16 planes: float32 outputs, the einsum on the upcast
    planes, through the autograd wrapper too."""
    ops16 = [_bf16(x) for x in _mac_planes(rng)]
    got = tmac.spectral_mac_auto_planes(*ops16)
    want = tmac.spectral_mac_planes(*(x.float() for x in ops16))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


def test_fused_dispatch_admits_the_tier():
    """fused_dispatch_auto admits bf16 spectra, as JAX tiled.py:255-256
    does, under the same shared-memory rule."""
    assert tt.fused_dispatch_auto(139, torch.bfloat16)
    assert not tt.fused_dispatch_auto(2047, torch.bfloat16)
    assert not tt.fused_dispatch_auto(447, torch.float16)


# ---------------------------------------------------------------------------
# the API at the tier
# ---------------------------------------------------------------------------


@pytest.fixture
def tier_case(rng):
    data = rng.standard_normal((80, 150, 3)).astype(np.float32)
    bank = rng.standard_normal((3, 9, 13, 3)).astype(np.float32)
    return data, bank


def _oracle(data, bank, mode, fft_hw=None):
    h, w = data.shape[:2]
    if mode == "fftmap":
        return np.stack([fft_map_f64(data, k, *fft_hw) for k in bank])
    return np.stack([
        _window(fft_conv_full_f64(data, k), k.shape[0], k.shape[1], h, w, mode)
        for k in bank
    ])


@pytest.mark.parametrize("algorithm", ["direct", "tiled"])
@pytest.mark.parametrize("mode", ["same", "full", "fftmap"])
def test_fft_conv_bf16_tier_matches_jax_and_oracle(tier_case, algorithm, mode):
    data, bank = tier_case
    kw = dict(mode=mode, algorithm=algorithm, store_dtype="bfloat16")
    got = tfc.fft_conv(data, kernels=bank, **kw, device="cpu")
    want = jfc.fft_conv(data, kernels=bank, **kw)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert tuple(got.shape) == want.shape
    assert rel_err(got.numpy(), _f32(want)) < BF16_TOL
    oracle = _oracle(data, bank, mode, tuple(got.shape[-2:]))
    assert rel_err(got.numpy(), oracle) < BF16_TOL


@pytest.mark.parametrize("tiled", [False, True])
def test_conv_spectral_bf16_tier_amortized(tier_case, tiled):
    """fft_data(_tiled) and fft_kernels at the tier store bf16 planes; raw
    kernels inherit the tier of the spectra they meet; the maps match JAX's
    conv_spectral and the one-shot call."""
    data, bank = tier_case
    if tiled:  # the port's block plan on both sides (JAX's planner differs)
        lh, lw, _, _ = tt.choose_block_plan(80, 150, 9, 13)

        def make(p):
            return p.fft_data_tiled(data, 9, 13, block_h=lh, block_w=lw,
                                    trim_mode="same", store_dtype="bfloat16", **_cpu(p))
    else:
        def make(p):
            return p.fft_data(data, 9, 13, store_dtype="bfloat16", **_cpu(p))
    spec, jspec = make(tfc), make(jfc)
    assert spec.re.dtype == torch.bfloat16 and jspec.re.dtype == jnp.bfloat16
    # the transform runs in float32 and only the store rounds: the planes
    # agree with JAX's within one bf16 ulp (2^-7 of the larger value), past
    # the float32 transforms' own noise (1e-5 of the plane's largest value)
    for p, q in ((spec.re, jspec.re), (spec.im, jspec.im)):
        a, b = _f32(p), _f32(q)
        bound = 2.0**-7 * np.maximum(np.abs(a), np.abs(b)) + 1e-5 * np.abs(b).max()
        assert a.shape == b.shape and np.all(np.abs(a - b) <= bound)
    sk = tfc.fft_kernels(bank, spectral=spec, store_dtype="bfloat16")
    assert sk.re.dtype == torch.bfloat16
    maps = tfc.conv_spectral(spec, sk, mode="same")
    assert maps.dtype == torch.float32
    assert torch.equal(maps, tfc.conv_spectral(spec, bank, mode="same"))
    jsk = jfc.fft_kernels(bank, spectral=jspec, store_dtype="bfloat16",
                          **({} if tiled else dict(storage="planar")))
    want = jfc.conv_spectral(jspec, jsk, mode="same")
    assert want.dtype == jnp.float32
    assert rel_err(maps.numpy(), _f32(want)) < BF16_TOL
    one_shot = tfc.fft_conv(data, kernels=bank, mode="same", store_dtype="bfloat16",
                            algorithm="tiled" if tiled else "direct", device="cpu")
    assert torch.equal(maps, one_shot)


def test_fftmap_tiled_bf16_tier(rng):
    """mode='fftmap' through the tiled engine at the tier (the baked canvas,
    test_bf16_tier.py:392): within the tier bar of the float32 direct
    engine's raw maps, as JAX's."""
    data = rng.standard_normal((90, 80, 2)).astype(np.float32)
    bank = rng.standard_normal((4, 7, 7, 2)).astype(np.float32)
    want = tfc.fft_conv(data, kernels=bank, mode="fftmap", algorithm="direct", device="cpu")
    got = tfc.fft_conv(data, kernels=bank, mode="fftmap", algorithm="tiled",
                       store_dtype="bfloat16", device="cpu")
    jgot = jfc.fft_conv(data, kernels=bank, mode="fftmap", algorithm="tiled",
                        store_dtype="bfloat16")
    assert got.shape == want.shape == jgot.shape
    assert rel_err(got.numpy(), want.numpy()) < BF16_TOL
    assert rel_err(got.numpy(), _f32(jgot)) < BF16_TOL


@pytest.mark.parametrize("algorithm", ["direct", "tiled"])
@pytest.mark.parametrize("store_dtype", ["float32", "bfloat16"])
def test_out_dtype_bf16_maps(tier_case, algorithm, store_dtype):
    """bf16 maps on both engines and both tiers: bf16 like JAX's, within
    BF16_OUT_TOL of the same call's float32 maps, and within the bar of the
    JAX call (the output rounding alone, or the tier's)."""
    data, bank = tier_case
    kw = dict(mode="same", algorithm=algorithm, store_dtype=store_dtype)
    f32 = tfc.fft_conv(data, kernels=bank, **kw, device="cpu")
    got = tfc.fft_conv(data, kernels=bank, out_dtype="bfloat16", **kw, device="cpu")
    want = jfc.fft_conv(data, kernels=bank, out_dtype="bfloat16", **kw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert rel_err(_f32(got), f32.numpy()) < BF16_OUT_TOL
    bar = BF16_OUT_TOL if store_dtype == "float32" else BF16_TOL
    assert rel_err(_f32(got), _f32(want)) < 2 * bar
    maps = tfc.fft_conv(data, kernels=bank, out_dtype="float32", device="cpu", **kw)
    assert maps.dtype == torch.float32


def test_ragged_bank_out_dtype(rng):
    """A ragged bank returns a list whose every map carries out_dtype."""
    data = rng.standard_normal((40, 40, 1)).astype(np.float32)
    cells = [rng.standard_normal((k, k, 1)).astype(np.float32) for k in (5, 7)]
    got = tfc.fft_conv(data, kernels=cells, mode="same", out_dtype="bfloat16", device="cpu")
    want = tfc.fft_conv(data, kernels=cells, mode="same", device="cpu")
    assert isinstance(got, list) and len(got) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert rel_err(_f32(g), w.numpy()) < BF16_OUT_TOL


def _planted(rng, n=3, kh=9, kw=13, f=2, h=120, w=200):
    data = rng.standard_normal((h, w, f)).astype(np.float32)
    bank = rng.standard_normal((n, kh, kw, f)).astype(np.float32)
    corners = [(10, 20), (60, 150), (95, 70)][:n]
    for t, (y0, x0) in enumerate(corners):
        data[y0 : y0 + kh, x0 : x0 + kw] += 3.0 * bank[t]
    centres = np.array([(y0 + kh // 2, x0 + kw // 2) for y0, x0 in corners])
    return data, bank, centres


@pytest.mark.parametrize("algorithm", ["auto", "direct"])
def test_detect_heads_bf16_tier_match_jax(rng, algorithm):
    """detect_peaks, detect_top_k and detect_local_peaks at the tier find the
    planted templates where the JAX heads do, values within the tier bar;
    float32 values and int32 positions."""
    data, bank, centres = _planted(rng)
    kw = dict(algorithm=algorithm, store_dtype="bfloat16")
    vals, pos = detect_peaks(data, bank, **kw, device="cpu")
    jv, jp = j_peaks(data, bank, **kw)
    assert vals.dtype == torch.float32 and pos.dtype == torch.int32
    assert np.array_equal(pos.numpy(), centres) and np.array_equal(np.asarray(jp), centres)
    assert rel_err(vals.numpy(), _f32(jv)) < BF16_TOL
    v1, p1 = detect_top_k(data, bank, 1, **kw, device="cpu")
    jv1, jp1 = j_top_k(data, bank, 1, **kw)
    assert np.array_equal(p1[:, 0].numpy(), centres)
    assert np.array_equal(np.asarray(jp1)[:, 0], centres)
    lv, lp = detect_local_peaks(data, bank, 4, **kw, device="cpu")
    jlv, jlp = j_local_peaks(data, bank, 4, **kw)
    assert np.array_equal(lp[:, 0].numpy(), centres)
    assert np.array_equal(np.asarray(jlp)[:, 0], centres)
    assert rel_err(lv[:, 0].numpy(), _f32(jlv)[:, 0]) < BF16_TOL


def test_detect_heads_bf16_on_spectra(rng):
    """Precomputed tiled spectra at the tier with a raw bank (which takes
    their tier) or a bank of the same tier; a bank of the other tier is
    the mismatch error."""
    data, bank, centres = _planted(rng)
    sd = tfc.fft_data_tiled(data, 9, 13, trim_mode="same", store_dtype="bfloat16", device="cpu")
    _, pos = detect_peaks(sd, bank, device="cpu")
    assert np.array_equal(pos.numpy(), centres)
    sk = tfc.fft_kernels(bank, spectral=sd, correlation=True, store_dtype="bfloat16")
    _, pos_k = detect_top_k(sd, sk, 1, device="cpu")
    assert np.array_equal(pos_k[:, 0].numpy(), centres)
    sk32 = tfc.fft_kernels(bank, spectral=sd, correlation=True)
    with pytest.raises(tfc.InvalidInputError, match="store-dtype mismatch"):
        detect_peaks(sd, sk32, device="cpu")


def test_detect_local_peaks_out_dtype(rng):
    """bf16 maps through detect_local_peaks: the same hits as the float32
    maps' (planted templates), values within BF16_OUT_TOL, as JAX's."""
    data, bank, centres = _planted(rng)
    v32, p32 = detect_local_peaks(data, bank, 4, device="cpu")
    vb, pb = detect_local_peaks(data, bank, 4, out_dtype="bfloat16", device="cpu")
    jvb, jpb = j_local_peaks(data, bank, 4, out_dtype="bfloat16")
    assert vb.dtype == torch.float32
    assert np.array_equal(pb[:, 0].numpy(), centres)
    assert np.array_equal(np.asarray(jpb)[:, 0], centres)
    assert torch.equal(pb[:, 0], p32[:, 0])
    assert rel_err(vb[:, 0].numpy(), v32[:, 0].numpy()) < BF16_OUT_TOL
    assert rel_err(vb[:, 0].numpy(), _f32(jvb)[:, 0]) < BF16_OUT_TOL


def _message(call):
    with pytest.raises(ValueError) as info:
        call()
    return str(info.value)


def test_tier_validation_matches_jax(rng):
    """The mismatch error (both directions, both engines) and the dtype
    validation raise InvalidInputError with the JAX package's messages."""
    data = rng.standard_normal((32, 32, 2)).astype(np.float32)
    bank = rng.standard_normal((2, 5, 5, 2)).astype(np.float32)
    for tiled in (False, True):
        for data_t, bank_t in (("float32", "bfloat16"), ("bfloat16", "float32")):
            def pair(p):
                sd = (p.fft_data_tiled(data, 5, 5, store_dtype=data_t, **_cpu(p)) if tiled
                      else p.fft_data(data, 5, 5, store_dtype=data_t, **_cpu(p)))
                extra = {} if tiled else dict(storage="planar")
                sk = p.fft_kernels(bank, spectral=sd, store_dtype=bank_t,
                                   **(extra if p is jfc else {}))
                return sd, sk
            sd, sk = pair(tfc)
            jsd, jsk = pair(jfc)
            with pytest.raises(tfc.InvalidInputError, match="store-dtype mismatch"):
                tfc.conv_spectral(sd, sk, mode="full")
            got = _message(lambda: tfc.conv_spectral(sd, sk, mode="full"))
            want = _message(lambda: jfc.conv_spectral(jsd, jsk, mode="full"))
            assert got == want
    for call in (
        lambda p: p.fft_data(data, 5, 5, store_dtype="float16"),
        lambda p: p.fft_data_tiled(data, 5, 5, store_dtype="float16"),
        lambda p: p.fft_kernels(bank, 8, 8, store_dtype="float16"),
        lambda p: p.fft_conv(data, kernels=bank, out_dtype="float16"),
        lambda p: p.fft_conv(data, kernels=bank, store_dtype="bf16"),
    ):
        with pytest.raises(tfc.InvalidInputError):
            call(tfc)
        assert _message(lambda: call(tfc)) == _message(lambda: call(jfc))
    sd = tfc.fft_data(data, 5, 5, device="cpu")
    with pytest.raises(tfc.InvalidInputError, match="out_dtype"):
        tfc.conv_spectral(sd, bank, out_dtype="float64")
    with pytest.raises(tfc.InvalidInputError, match="store_dtype"):
        detect_peaks(data, bank, store_dtype="float16", device="cpu")
    with pytest.raises(tfc.InvalidInputError, match="out_dtype"):
        detect_local_peaks(data, bank, out_dtype="float16", device="cpu")


# ---------------------------------------------------------------------------
# gradients through bf16 maps
# ---------------------------------------------------------------------------


def test_grad_through_fused_bf16_out_matches_jax(rng):
    """The fused block-conv with bf16 maps: the cotangent arrives bf16, the
    unfused backward upcasts it; float32 gradients within 2e-2 of
    jax.grad through JAX fused_block_conv(..., 'bfloat16') (the shapes of
    test_out_dtype.py:140-165)."""
    planes = [rng.standard_normal(s).astype(np.float32)
              for s in ((1, 2, 1, 1, 16, 9),) * 2 + ((2, 1, 16, 9),) * 2]
    geom = (16, 16, 9, 9, 16, 8)

    def jloss(a, b, c, d):
        out = jt.fused_block_conv(a, b, c, d, *geom, "bfloat16")
        return jnp.sum(out.astype(jnp.float32) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, planes))
    leaves = [torch.tensor(p, requires_grad=True) for p in planes]
    out = tt.fused_block_conv(*leaves, *geom, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    out.float().square().sum().backward()
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.float32
        assert torch.isfinite(leaf.grad).all()
        assert rel_err(leaf.grad.numpy(), np.asarray(w)) < BF16_TOL


@pytest.mark.parametrize("algorithm", ["direct", "tiled"])
def test_grad_through_fft_conv_bf16_out_matches_jax(rng, algorithm):
    """d/d data of Σ maps² through fft_conv(..., out_dtype='bfloat16')
    against jax.grad of the same call, within 2e-2."""
    data = rng.standard_normal((40, 150, 2)).astype(np.float32)
    bank = rng.standard_normal((2, 7, 9, 2)).astype(np.float32)
    kw = dict(kernels=bank, mode="same", algorithm=algorithm, out_dtype="bfloat16")

    def jloss(x):
        return jnp.sum(jfc.fft_conv(x, **kw).astype(jnp.float32) ** 2)

    want = jax.grad(jloss)(jnp.asarray(data))
    x = torch.tensor(data, requires_grad=True)
    maps = tfc.fft_conv(x, **kw, device="cpu")
    assert maps.dtype == torch.bfloat16
    maps.float().square().sum().backward()
    assert x.grad.dtype == torch.float32
    assert rel_err(x.grad.numpy(), np.asarray(want)) < BF16_TOL


# ---------------------------------------------------------------------------
# checkpoints of bf16 containers across the packages
# ---------------------------------------------------------------------------


def _containers(p, data, bank):
    tiled = p.fft_data_tiled(data, 9, 13, trim_mode="same", store_dtype="bfloat16", **_cpu(p))
    direct = p.fft_data(data, 9, 13, store_dtype="bfloat16", **_cpu(p))
    extra = dict(storage="planar") if p is jfc else {}
    return {
        "TiledSpectralData": tiled,
        "SpectralData": direct,
        "SpectralKernels": p.fft_kernels(bank, spectral=tiled, store_dtype="bfloat16", **extra),
    }


@pytest.mark.parametrize("kind", ["SpectralData", "TiledSpectralData", "SpectralKernels"])
def test_checkpoint_bf16_crosses_packages(tmp_path, tier_case, kind):
    """A bf16 container saved by either package loads in the other with its
    tier (bf16 planes, equal values) and its geometry."""
    data, bank = tier_case
    jobj = _containers(jfc, data, bank)[kind]
    tobj = _containers(tfc, data, bank)[kind]
    jfc.save_spectral(str(tmp_path / "j.npz"), jobj)
    tfc.save_spectral(str(tmp_path / "t.npz"), tobj)
    with np.load(tmp_path / "t.npz") as z:
        assert str(z["store_dtype"]) == "bfloat16" and z["fft_re"].dtype == np.float32
    from_jax = tfc.load_spectral(str(tmp_path / "j.npz"), device="cpu")
    from_torch = jfc.load_spectral(str(tmp_path / "t.npz"))
    assert type(from_jax).__name__ == type(from_torch).__name__ == kind
    assert from_jax.re.dtype == torch.bfloat16 and from_torch.re.dtype == jnp.bfloat16
    for a, b in ((from_jax.re, jobj.re), (from_jax.im, jobj.im),
                 (from_torch.re, tobj.re), (from_torch.im, tobj.im)):
        assert np.array_equal(_f32(a), _f32(b))
    back = tfc.load_spectral(str(tmp_path / "t.npz"), device="cpu")
    assert torch.equal(back.re, tobj.re) and back.re.dtype == torch.bfloat16


def test_checkpoint_bf16_maps_from_a_jax_file(tmp_path, tier_case):
    """Tiled spectra and a bank saved bf16 by the JAX package serve the
    port's conv_spectral at the tier, within the tier bar of JAX's maps."""
    data, bank = tier_case
    objs = _containers(jfc, data, bank)
    for name in ("TiledSpectralData", "SpectralKernels"):
        jfc.save_spectral(str(tmp_path / f"{name}.npz"), objs[name])
    sd = tfc.load_spectral(str(tmp_path / "TiledSpectralData.npz"), device="cpu")
    sk = tfc.load_spectral(str(tmp_path / "SpectralKernels.npz"), device="cpu")
    got = tfc.conv_spectral(sd, sk, mode="same")
    want = jfc.conv_spectral(objs["TiledSpectralData"], objs["SpectralKernels"], mode="same")
    assert rel_err(got.numpy(), _f32(want)) < BF16_TOL


# ---------------------------------------------------------------------------
# HOG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 72), (67, 50), (40, 48, 3)])
@pytest.mark.parametrize("bins", [9, 31])
def test_hog_features_matches_jax(rng, shape, bins):
    """hog_features against JAX's within 1e-5 (absolute; features lie in
    [0, 1]), grayscale, a size that is no multiple of the cell, and a colour
    image; numpy and tensor inputs give the same features."""
    image = rng.standard_normal(shape).astype(np.float32)
    got = hog_features(image, cell=8, bins=bins, device="cpu")
    want = np.asarray(j_hog(jnp.asarray(image), cell=8, bins=bins))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5
    assert torch.equal(hog_features(torch.as_tensor(image), cell=8, bins=bins), got)
