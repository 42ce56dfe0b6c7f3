"""The port's model layer (``cuda_fft_convolution_torch.models``: the
pyramid, MOSSE and the filter-bank detector) against the JAX functions of
the same names, on the same numpy inputs from a seed, on the CPU. JAX's
models reach the einsum MAC here and no Pallas kernel; the port's reach
the MAC kernel's plain version (CPU tensors).

Tolerances: 1e-6 for the resize, levels and Gaussian targets (one f32
resize or exp); 1e-5 relative to the largest |value| for spectra, maps,
MOSSE planes and losses (the repo's fp32 bar); 1e-4 for gradients and for
parameters after three optimizer steps (Adam divides by √v̂, which
magnifies fp32 rounding in small gradients). Positions, levels and
detection tuples are compared exactly. Parameters are carried from JAX's
models with ``detector_from_numpy`` and ``mosse_from_numpy``: torch and
``jax.random`` draw different numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cuda_fft_convolution_torch as tfc
import cuda_fft_convolution_tpu as jfc
from cuda_fft_convolution_torch import models as tm
from cuda_fft_convolution_torch.models.pyramid import resize_bilinear
from cuda_fft_convolution_torch.ops import spectral_mac as tmac
from cuda_fft_convolution_tpu import models as jm
from tests.oracles import rel_err

TOL = 1e-5
RESIZE_TOL = 1e-6
GRAD_TOL = 1e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fields(obj) -> dict:
    """A JAX dataclass's fields as numpy arrays (static ints as they are)."""
    return {k: (v if isinstance(v, int) else np.asarray(v)) for k, v in vars(obj).items()}


# ---------------------------------------------------------------------------
# resize and pyramid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,size", [
    ((64, 53, 3), (45, 37)),  # scale 2^-0.5 (round(64·0.707), round(53·0.707))
    ((64, 53, 3), (32, 27)),  # scale 0.5
    ((24, 24, 2), (48, 48)),  # 2x up (the planted-template scenario)
])
def test_resize_matches_jax(rng, shape, size):
    img = rng.standard_normal(shape).astype(np.float32)
    got = resize_bilinear(torch.as_tensor(img), *size)
    want = jax.image.resize(jnp.asarray(img), (*size, shape[2]), method="bilinear")
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert rel_err(_np(got), want) < RESIZE_TOL


PYRAMIDS = [
    # (image shape, kernel (kh, kw), num_levels, scale)
    ((80, 64, 2), (9, 7), 3, 0.5),
    ((64, 53, 3), (8, 8), 5, 2 ** -0.5),  # stops when a level is under the kernel
    ((40, 30, 1), (5, 5), 6, 0.97),  # stops when a level no longer shrinks
]


@pytest.mark.parametrize("shape,k,levels,scale", PYRAMIDS)
def test_build_pyramid_matches_jax(rng, shape, k, levels, scale):
    img = rng.standard_normal(shape).astype(np.float32)
    got = tm.build_pyramid(img, *k, num_levels=levels, scale=scale, device="cpu")
    want = jm.build_pyramid(img, *k, num_levels=levels, scale=scale)
    assert len(got.levels) == len(want.levels) == len(got.spectra) >= 2
    assert got.scale == want.scale
    for lg, lw, sg, sw in zip(got.levels, want.levels, got.spectra, want.spectra):
        assert tuple(lg.shape) == lw.shape and lg.device.type == "cpu"
        assert rel_err(_np(lg), lw) < RESIZE_TOL
        assert (sg.fft_h, sg.fft_w, sg.data_h, sg.data_w) == (
            sw.fft_h, sw.fft_w, sw.data_h, sw.data_w)
        for pg, pw in ((sg.re, sw.re), (sg.im, sw.im)):
            assert pg.dtype == torch.float32 and tuple(pg.shape) == pw.shape
            assert rel_err(_np(pg), pw) < TOL


@pytest.fixture
def pyramid_case(rng):
    img = rng.standard_normal((80, 64, 2)).astype(np.float32)
    bank = rng.standard_normal((4, 9, 7, 2)).astype(np.float32)
    return (img, bank, tm.build_pyramid(img, 9, 7, num_levels=3, scale=0.5, device="cpu"),
            jm.build_pyramid(img, 9, 7, num_levels=3, scale=0.5))


@pytest.mark.parametrize("mode,correlation", [
    ("same", True), ("full", True), ("valid", False), ("fftmap", False),
])
def test_detect_pyramid_matches_jax(pyramid_case, mode, correlation):
    _, bank, tp, jp = pyramid_case
    got = tm.detect_pyramid(tp, bank, mode=mode, correlation=correlation)
    want = jm.detect_pyramid(jp, bank, mode=mode, correlation=correlation)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert rel_err(_np(g), w) < TOL


@pytest.mark.parametrize("mode", ["same", "full", "valid"])
def test_detect_pyramid_peaks_matches_jax(pyramid_case, mode):
    _, bank, tp, jp = pyramid_case
    got = tm.detect_pyramid_peaks(tp, bank, mode=mode)
    want = jm.detect_pyramid_peaks(jp, bank, mode=mode)
    assert tuple(got.values.shape) == (3, 4) and got.values.dtype == torch.float32
    assert rel_err(_np(got.values), want.values) < TOL
    np.testing.assert_array_equal(_np(got.positions), want.positions)
    np.testing.assert_array_equal(_np(got.best_level), want.best_level)
    np.testing.assert_array_equal(_np(got.best_position), want.best_position)
    assert rel_err(_np(got.best_value), want.best_value) < TOL
    assert got.positions.dtype == got.best_level.dtype == torch.int32
    # each level's peaks are the argmax of detect_pyramid's maps
    for lvl, maps in enumerate(tm.detect_pyramid(tp, bank, mode=mode)):
        flat = maps.reshape(maps.shape[0], -1)
        idx = flat.argmax(-1)
        assert torch.equal(got.values[lvl], flat.gather(-1, idx[:, None])[:, 0])
        assert torch.equal(got.positions[lvl, :, 0].long(), idx // maps.shape[-1])


def test_pyramid_peaks_ragged_same_matches_jax(rng):
    img = rng.standard_normal((48, 48, 1)).astype(np.float32)
    cells = [rng.standard_normal((8, 8, 1)).astype(np.float32),
             rng.standard_normal((4, 4, 1)).astype(np.float32)]
    tp = tm.build_pyramid(img, 8, 8, num_levels=2, scale=0.5, device="cpu")
    jp = jm.build_pyramid(img, 8, 8, num_levels=2, scale=0.5)
    got = tm.detect_pyramid_peaks(tp, cells)
    want = jm.detect_pyramid_peaks(jp, cells)
    assert tuple(got.values.shape) == (2, 2)
    assert rel_err(_np(got.values), want.values) < TOL
    np.testing.assert_array_equal(_np(got.positions), want.positions)
    np.testing.assert_array_equal(_np(got.best_position), want.best_position)


@pytest.mark.parametrize("case", ["valid ragged", "fftmap"])
def test_pyramid_peaks_rejections(rng, case):
    """As ``tests/test_pyramid_peaks.py``: ragged cells serve mode='same'
    only, and 'fftmap' has no global peak; both raise in both packages."""
    img = rng.standard_normal((48, 48, 1)).astype(np.float32)
    cells = [np.ones((8, 8, 1), np.float32), np.ones((4, 4, 1), np.float32)]
    kernels, mode = ((cells, "valid") if case == "valid ragged"
                     else (np.ones((1, 8, 8, 1), np.float32), "fftmap"))
    tp = tm.build_pyramid(img, 8, 8, num_levels=2, scale=0.5, device="cpu")
    jp = jm.build_pyramid(img, 8, 8, num_levels=2, scale=0.5)
    with pytest.raises(tfc.InvalidInputError):
        tm.detect_pyramid_peaks(tp, kernels, mode=mode)
    with pytest.raises(jfc.InvalidInputError):
        jm.detect_pyramid_peaks(jp, kernels, mode=mode)


def test_pyramid_finds_scaled_template(rng):
    """The planted-2x-template scenario of ``tests/test_pyramid_peaks.py``:
    the port's resize plants it, the half-resolution level finds it, and
    the join equals JAX's."""
    kern = rng.standard_normal((12, 12, 1)).astype(np.float32)
    big = np.zeros((128, 128, 1), np.float32)
    big[40:64, 60:84] = _np(resize_bilinear(torch.as_tensor(kern), 24, 24))
    tp = tm.build_pyramid(big, 12, 12, num_levels=4, scale=0.5, device="cpu")
    got = tm.detect_pyramid_peaks(tp, kern[None])
    want = jm.detect_pyramid_peaks(jm.build_pyramid(big, 12, 12, num_levels=4, scale=0.5),
                                   kern[None])
    assert int(got.best_level[0]) == int(want.best_level[0]) == 1
    y, x = (int(c) for c in got.best_position[0])
    assert abs(y - 52) <= 4 and abs(x - 72) <= 4
    np.testing.assert_array_equal(_np(got.best_position), want.best_position)
    hits = tm.top_detections(tm.detect_pyramid(tp, [kern], mode="same"), k=1)
    assert hits[0][:4] == (1, 0, int(got.positions[1, 0, 0]), int(got.positions[1, 0, 1]))


def _scores(rng, kind):
    if kind == "stacked":
        return [rng.standard_normal((3, 8, 9)).astype(np.float32) for _ in range(2)]
    if kind == "batched":
        return [rng.standard_normal((2, 3, 8, 8)).astype(np.float32) for _ in range(2)]
    return [[rng.standard_normal((10, 10)).astype(np.float32),
             rng.standard_normal((12, 14)).astype(np.float32)] for _ in range(2)]


@pytest.mark.parametrize("kind", ["stacked", "batched", "ragged"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_top_detections_matches_jax(rng, kind, as_tensor):
    scores = _scores(rng, kind)
    ported = scores
    if as_tensor:
        ported = [[torch.as_tensor(m) for m in s] if isinstance(s, list)
                  else torch.as_tensor(s) for s in scores]
    got = tm.top_detections(ported, k=4)
    assert got == jm.top_detections(scores, k=4)
    assert len(got) == 4 and all(isinstance(t[4], float) for t in got)


def test_top_detections_rejects_bad_rank():
    with pytest.raises(ValueError):
        tm.top_detections([np.zeros((4, 4), np.float32)])


# ---------------------------------------------------------------------------
# MOSSE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fft,center,sigma", [
    ((64, 64), (32, 32), 2.0), ((48, 40), (5, 37), 3.5),
])
def test_gaussian_target_matches_jax(fft, center, sigma):
    got = tm.gaussian_target(*fft, center, sigma, device="cpu")
    want = jm.gaussian_target(*fft, center, sigma)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert rel_err(_np(got), want) < RESIZE_TOL


def _mosse_inputs(rng, f, s=4, h=24, w=20, fft=(32, 32)):
    patches = rng.standard_normal((s, f, h, w)).astype(np.float32)
    targets = np.stack([np.asarray(jm.gaussian_target(*fft, (8 + i, 9 + 2 * i)))
                        for i in range(s)])
    return patches, targets, fft


def _planes_err(got, want) -> float:
    """max |Δ| over both planes / max |want| over both planes."""
    g = np.stack([_np(got.h_re), _np(got.h_im)])
    w = np.stack([np.asarray(want.h_re), np.asarray(want.h_im)])
    return rel_err(g, w)


@pytest.mark.parametrize("f", [1, 3])
def test_train_mosse_matches_jax(rng, f):
    patches, targets, fft = _mosse_inputs(rng, f)
    got = tm.train_mosse(patches, targets, *fft, device="cpu")
    want = jm.train_mosse(jnp.asarray(patches), jnp.asarray(targets), *fft)
    assert (got.fft_h, got.fft_w) == fft and tuple(got.h_re.shape) == (f, 32, 17)
    assert _planes_err(got, want) < TOL
    assert rel_err(_np(got.h_conj.real), np.real(want.h_conj)) < TOL


@pytest.mark.parametrize("f,lr", [(1, 0.125), (3, 0.5)])
def test_update_mosse_matches_jax(rng, f, lr):
    patches, targets, fft = _mosse_inputs(rng, f)
    jf = jm.train_mosse(jnp.asarray(patches), jnp.asarray(targets), *fft)
    tf = tfc.mosse_from_numpy(_fields(jf), device="cpu")
    patch = rng.standard_normal((f, 24, 20)).astype(np.float32)
    target = np.asarray(jm.gaussian_target(*fft, (11, 13)))
    got = tm.update_mosse(tf, torch.as_tensor(patch), torch.as_tensor(target), lr=lr)
    want = jm.update_mosse(jf, jnp.asarray(patch), target, lr=lr)
    assert _planes_err(got, want) < TOL
    assert _planes_err(got, jf) > 1e-3  # it moved


@pytest.mark.parametrize("batched", [False, True])
def test_respond_matches_jax(rng, batched):
    patches, targets, fft = _mosse_inputs(rng, 2)
    jf = jm.train_mosse(jnp.asarray(patches), jnp.asarray(targets), *fft)
    tf = tfc.mosse_from_numpy(_fields(jf), device="cpu")
    shape = (3, 20, 24, 2) if batched else (20, 24, 2)
    data = rng.standard_normal(shape).astype(np.float32)
    sd = tfc.fft_data(data, 13, 9, device="cpu")
    assert (sd.fft_h, sd.fft_w) == fft
    launches = tmac.spectral_mac.launches
    got = tm.respond(tf, sd)
    want = jm.respond(jf, jfc.fft_data(data, 13, 9))
    assert tmac.spectral_mac.launches == launches  # no kernel on the CPU
    assert tuple(got.shape) == want.shape == ((3, 32, 32) if batched else (32, 32))
    assert rel_err(_np(got), want) < TOL
    # respond's MAC over a bank of one filter is the JAX package's
    # split-plane sum over the channels
    d_re, d_im = (_np(t) if batched else _np(t)[None] for t in (sd.re, sd.im))
    h_re, h_im = np.asarray(jf.h_re)[None], np.asarray(jf.h_im)[None]
    want_re = np.sum(d_re * h_re - d_im * h_im, axis=1)
    want_im = np.sum(d_re * h_im + d_im * h_re, axis=1)
    got = tmac.spectral_mac(*(torch.as_tensor(a) for a in (d_re, d_im, h_re, h_im)))
    for g, w in zip(got, (want_re, want_im)):
        assert rel_err(_np(g[:, 0]), w) < TOL


def test_respond_fft_size_mismatch(rng):
    patches, targets, fft = _mosse_inputs(rng, 1)
    filt = tm.train_mosse(patches, targets, *fft, device="cpu")
    sd = tfc.fft_data(rng.standard_normal((40, 40, 1)).astype(np.float32), 5, 5,
                      device="cpu")
    with pytest.raises(tfc.InvalidInputError, match="FFT dims mismatch"):
        tm.respond(filt, sd)


def test_mosse_from_numpy_checks_the_fft_size(rng):
    patches, targets, fft = _mosse_inputs(rng, 1)
    fields = _fields(jm.train_mosse(jnp.asarray(patches), jnp.asarray(targets), *fft))
    fields["fft_w"] = 40
    with pytest.raises(tfc.InvalidInputError, match="FFT size"):
        tfc.mosse_from_numpy(fields, device="cpu")


# ---------------------------------------------------------------------------
# the filter-bank detector
# ---------------------------------------------------------------------------


def _detector_case(rng, n=3, f=2, k=(5, 4), b=2, hw=(24, 21)):
    jmodel = jm.init_detector(jax.random.key(3), n, f, *k)
    jmodel = jm.FilterBankDetector(
        kernels=jmodel.kernels,
        bias=jnp.asarray(rng.standard_normal(n).astype(np.float32)),
    )
    images = rng.standard_normal((b, f, *hw)).astype(np.float32)
    return jmodel, tfc.detector_from_numpy(_fields(jmodel), device="cpu"), images


@pytest.mark.parametrize("policy", ["fast", "pow2"])
@pytest.mark.parametrize("k", [(5, 4), (1, 1)])
def test_detect_matches_jax(rng, policy, k):
    jmodel, model, images = _detector_case(rng, k=k)
    got = tm.detect(model, images, policy=policy)
    want = jm.detect(jmodel, jnp.asarray(images), policy=policy)
    assert tuple(got.shape) == want.shape == (2, 3, 24, 21)
    assert rel_err(_np(got), want) < TOL
    assert torch.equal(model(torch.as_tensor(images), policy=policy), got)


def test_loss_and_gradients_match_jax(rng):
    jmodel, model, images = _detector_case(rng)
    targets = rng.standard_normal((2, 3, 24, 21)).astype(np.float32)
    loss = tm.loss_fn(model, images, targets)
    loss.backward()
    loss = loss.detach()
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(jmodel, jnp.asarray(images),
                                                   jnp.asarray(targets))
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    assert rel_err(_np(model.kernels.grad), jgrads.kernels) < GRAD_TOL
    assert rel_err(_np(model.bias.grad), jgrads.bias) < GRAD_TOL


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_train_steps_match_optax(rng, opt):
    """Three steps of ``train_step`` with torch's SGD / Adam against JAX's
    with optax's, from the same parameters, on realisable targets (a second
    detector's maps, as ``tests/test_models.py``)."""
    jmodel, model, images = _detector_case(rng)
    target_model = jm.init_detector(jax.random.key(4), 3, 2, 5, 4)
    targets = np.asarray(jm.detect(target_model, jnp.asarray(images)))
    lr = 3e-2
    tx = optax.sgd(lr) if opt == "sgd" else optax.adam(lr)
    optimizer = (torch.optim.SGD if opt == "sgd" else torch.optim.Adam)(
        model.parameters(), lr=lr)
    state = tx.init(jmodel)
    losses = []
    for _ in range(3):
        model, optimizer, loss = tm.train_step(model, optimizer, images, targets)
        jmodel, state, jloss = jm.train_step(jmodel, state, jnp.asarray(images),
                                             jnp.asarray(targets), tx)
        assert not loss.requires_grad
        assert abs(float(loss) - float(jloss)) <= GRAD_TOL * float(jloss)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert rel_err(_np(model.kernels), jmodel.kernels) < GRAD_TOL
    assert rel_err(_np(model.bias), jmodel.bias) < GRAD_TOL


def test_train_step_input_gradient_through_the_mac(rng):
    """Images that need a gradient get the data cotangent too: the MAC's
    backward runs both of its MACs, and ``jax.grad`` with respect to the
    images agrees."""
    jmodel, model, images = _detector_case(rng)
    x = torch.tensor(images, requires_grad=True)
    tm.loss_fn(model, x, np.zeros((2, 3, 24, 21), np.float32)).backward()
    want = jax.grad(lambda im: jm.loss_fn(jmodel, im, jnp.zeros((2, 3, 24, 21))))(
        jnp.asarray(images))
    assert rel_err(_np(x.grad), want) < GRAD_TOL


def test_init_detector_shapes_scale_and_determinism():
    make = lambda seed: tm.init_detector(  # noqa: E731
        torch.Generator().manual_seed(seed), 64, 31, 12, 12, device="cpu")
    a, b, c = make(0), make(0), make(1)
    assert isinstance(a, torch.nn.Module) and a.num_filters == 64
    assert tuple(a.kernels.shape) == (64, 31, 12, 12) and tuple(a.bias.shape) == (64,)
    assert a.kernels.dtype == a.bias.dtype == torch.float32
    assert a.kernels.requires_grad and not a.bias.any()
    assert torch.equal(a.kernels, b.kernels) and not torch.equal(a.kernels, c.kernels)
    std = float(a.kernels.std())
    assert abs(std * (31 * 12 * 12) ** 0.5 - 1.0) < 0.02
    assert {n for n, _ in a.named_parameters()} == {"kernels", "bias"}


def test_detector_from_numpy_round_trip(rng):
    jmodel, model, _ = _detector_case(rng)
    np.testing.assert_array_equal(_np(model.kernels), jmodel.kernels)
    np.testing.assert_array_equal(_np(model.bias), jmodel.bias)
    before = np.array(jmodel.kernels)
    with torch.no_grad():
        model.kernels.add_(1.0)  # a copy: the JAX arrays do not move
    np.testing.assert_array_equal(np.asarray(jmodel.kernels), before)
    with pytest.raises(tfc.InvalidInputError, match="bias"):
        tfc.detector_from_numpy({"kernels": np.zeros((2, 1, 3, 3)),
                                 "bias": np.zeros(3)}, device="cpu")


_ENTRIES = {
    "build_pyramid": lambda a: tm.build_pyramid(a, 5, 5, num_levels=2),
    "gaussian_target": lambda a: tm.gaussian_target(16, 16, (4, 4)),
    "train_mosse": lambda a: tm.train_mosse(a[None, None, :, :, 0], a[None, :, :, 0], 16, 16),
    "init_detector": lambda a: tm.init_detector(torch.Generator(), 2, 1, 3, 3),
    "detector_from_numpy": lambda a: tfc.detector_from_numpy(
        {"kernels": a[None, None, :3, :3, 0], "bias": np.zeros(1)}),
}


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
def test_numpy_input_runs_on_the_card_by_default(rng, entry):
    """An entry point given arrays and no device goes to the card; where
    there is none it raises, naming device='cpu'."""
    arr = rng.standard_normal((16, 16, 1)).astype(np.float32)
    if torch.cuda.is_available():
        out = _ENTRIES[entry](arr)
        t = out.levels[0] if entry == "build_pyramid" else getattr(out, "h_re", out)
        t = getattr(t, "kernels", t)
        assert t.device.type == "cuda"
    else:
        with pytest.raises(tfc.InvalidInputError, match="device='cpu'"):
            _ENTRIES[entry](arr)
