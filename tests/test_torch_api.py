"""The port's public API against the JAX package's and the float64 oracles:
``fft_conv`` over modes, engines, correlation, batches and ragged banks;
the amortized entry points; options of the JAX package, each now ported;
and the spectral checkpoint carried across the two packages in both
directions."""

import dataclasses

import numpy as np
import pytest
import torch

import cuda_fft_convolution_torch as tfc
import cuda_fft_convolution_tpu as jfc
from cuda_fft_convolution_torch import api as tapi
from cuda_fft_convolution_torch.ops import tiled as tt
from tests.oracles import (
    conv_same_nearest_f64,
    fft_conv_full_f64,
    fft_map_f64,
    rel_err,
)

TOL = 1e-5


@pytest.fixture
def bank_case(rng):
    data = rng.standard_normal((130, 170, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 9, 13, 2)).astype(np.float32)
    return data, bank


def _oracle(data, bank, mode, same_offset="scipy"):
    """float64 maps of each kernel in the requested window."""
    h, w = data.shape[:2]
    outs = []
    for k in bank:
        kh, kw = k.shape[:2]
        full = fft_conv_full_f64(data, k)
        if mode == "full":
            outs.append(full)
        elif mode == "same":
            oh, ow = ((kh - 1) // 2, (kw - 1) // 2) if same_offset == "scipy" else (kh // 2, kw // 2)
            outs.append(full[oh : oh + h, ow : ow + w])
        else:
            outs.append(full[kh - 1 : h, kw - 1 : w])
    return np.stack(outs)


@pytest.mark.parametrize("algorithm", ["auto", "direct", "tiled"])
@pytest.mark.parametrize("mode", ["fftmap", "full", "same", "valid"])
def test_fft_conv_matches_jax_and_oracle(bank_case, mode, algorithm):
    data, bank = bank_case
    got = tfc.fft_conv(data, kernels=bank, mode=mode, algorithm=algorithm, device="cpu")
    want = np.asarray(jfc.fft_conv(data, kernels=bank, mode=mode, algorithm=algorithm))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    assert rel_err(got.numpy(), want) < TOL
    if mode == "fftmap":
        fh, fw = got.shape[-2:]
        oracle = np.stack([fft_map_f64(data, k, fh, fw) for k in bank])
    else:
        oracle = _oracle(data, bank, mode)
    assert rel_err(got.numpy(), oracle) < TOL


def test_auto_engine_runs_the_fused_branch(bank_case, monkeypatch):
    """On the CPU the auto engine takes the fused branch, through the
    kernel's plain version; forcing use_fused_block_conv=False takes the
    unfused pipeline. Both give the same maps."""
    data, bank = bank_case
    calls = []
    real = tt.block_conv

    def counting(*a):
        calls.append(a[4:])
        return real(*a)

    monkeypatch.setattr(tt, "block_conv", counting)
    fused = tfc.fft_conv(data, kernels=bank, mode="same", device="cpu")
    assert len(calls) == 1
    tfc.set_config(use_fused_block_conv=False)
    try:
        unfused = tfc.fft_conv(data, kernels=bank, mode="same", device="cpu")
    finally:
        tfc.set_config(use_fused_block_conv=None)
    assert len(calls) == 1
    assert rel_err(fused.numpy(), unfused.numpy()) < TOL


@pytest.mark.parametrize("algorithm", ["direct", "tiled"])
@pytest.mark.parametrize("same_offset", ["scipy", "matlab"])
def test_correlation_and_same_offset_match_jax(rng, algorithm, same_offset):
    data = rng.standard_normal((120, 150, 1)).astype(np.float32)
    bank = rng.standard_normal((2, 8, 12, 1)).astype(np.float32)
    kw = dict(mode="same", algorithm=algorithm, correlation=True, same_offset=same_offset)
    got = tfc.fft_conv(data, kernels=bank, **kw, device="cpu")
    want = np.asarray(jfc.fft_conv(data, kernels=bank, **kw))
    assert rel_err(got.numpy(), want) < TOL
    flipped = bank[:, ::-1, ::-1]
    assert rel_err(got.numpy(), _oracle(data, flipped, "same", same_offset)) < TOL


@pytest.mark.parametrize("algorithm", ["direct", "tiled"])
@pytest.mark.parametrize("mode", ["full", "same", "fftmap"])
def test_batched_data_matches_jax(rng, algorithm, mode):
    data = rng.standard_normal((2, 100, 140, 3)).astype(np.float32)
    bank = rng.standard_normal((4, 7, 9, 3)).astype(np.float32)
    got = tfc.fft_conv(data, kernels=bank, mode=mode, algorithm=algorithm, device="cpu")
    want = np.asarray(jfc.fft_conv(data, kernels=bank, mode=mode, algorithm=algorithm))
    assert tuple(got.shape) == want.shape and got.shape[:2] == (2, 4)
    assert rel_err(got.numpy(), want) < TOL


@pytest.mark.parametrize("correlation", [False, True])
def test_ragged_bank_matches_jax(rng, correlation):
    data = rng.standard_normal((110, 140, 2)).astype(np.float32)
    bank = [rng.standard_normal(s + (2,)).astype(np.float32)
            for s in ((9, 13), (5, 11), (12, 4))]
    for mode in ("full", "same", "valid"):
        kw = dict(mode=mode, correlation=correlation, algorithm="tiled",
                  bucket_ragged=False)
        got = tfc.fft_conv(data, kernels=bank, **kw, device="cpu")
        want = jfc.fft_conv(data, kernels=bank, **kw)
        assert isinstance(got, list) and len(got) == 3
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            assert rel_err(g.numpy(), np.asarray(w)) < TOL


def test_ragged_bucketing_not_ported(rng):
    """Ragged bucketing (ROADMAP queue 1 item 5) is ported: a cell array
    spanning pow-2 envelopes runs each bucket at its own plan and returns
    the maps per kernel in input order, equal to the JAX package's; a cell
    array of one envelope runs unbucketed, as there."""
    data = rng.standard_normal((60, 60, 1)).astype(np.float32)
    bank = [rng.standard_normal((3, 3, 1)).astype(np.float32),
            rng.standard_normal((20, 20, 1)).astype(np.float32)]
    same_env = [rng.standard_normal((9, 13, 1)).astype(np.float32),
                rng.standard_normal((12, 10, 1)).astype(np.float32)]
    assert tapi._bucket_ragged(bank) == [[0], [1]] and tapi._bucket_ragged(same_env) is None
    for cells in (bank, same_env):
        got = tfc.fft_conv(data, kernels=cells, mode="same", device="cpu")
        want = jfc.fft_conv(data, kernels=cells, mode="same")
        assert isinstance(got, list) and len(got) == 2
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape == (60, 60)
            assert rel_err(g.numpy(), np.asarray(w)) < TOL


@pytest.mark.parametrize(
    "kwargs,item",
    [
        (dict(padding="clamp"), "queue 1 item 1"),
        (dict(kernel_layout="centered"), "queue 1 item 1"),
        (dict(store_dtype="bfloat16"), "queue 1 item 6"),
        (dict(out_dtype="bfloat16"), "queue 1 item 6"),
        (dict(use_pallas=True), "queue 2 item 1"),
    ],
)
def test_options_not_ported_raise(rng, kwargs, item):
    """Every option here is ported now, so each case checks the ported
    behaviour. Queue 1 item 1 (``padding='clamp'``, ``kernel_layout=
    'centered'``): the maps against the JAX call and the float64 oracle,
    replicated borders or the matlab-anchored window. Queue 2 item 1
    (``use_pallas=True``, the spectral-MAC kernel): the port runs the
    kernel path whatever the option says, checked against the default call
    and the JAX package. Queue 1 item 6 (the bf16 tier and bf16 maps): the
    maps' dtype and values against the JAX call (2e-2, the tier's bar) and
    the float32 call (the same bar)."""
    data = rng.standard_normal((40, 40, 1)).astype(np.float32)
    bank = rng.standard_normal((2, 5, 5, 1)).astype(np.float32)
    if item == "queue 1 item 1":
        got = tfc.fft_conv(data, kernels=bank, mode="same", device="cpu", **kwargs)
        want = jfc.fft_conv(data, kernels=bank, mode="same", **kwargs)
        assert rel_err(got.numpy(), np.asarray(want)) < TOL
        for g, k in zip(got.numpy(), bank):
            if "padding" in kwargs:
                ref = conv_same_nearest_f64(data[:, :, 0], k[:, :, 0], 2, 2)
            else:
                ref = fft_conv_full_f64(data, k)[2:42, 2:42]
            assert rel_err(g, ref) < TOL
        return
    if item == "queue 1 item 6":
        for algorithm in ("direct", "tiled"):
            kw = dict(mode="same", algorithm=algorithm, **kwargs)
            got = tfc.fft_conv(data, kernels=bank, **kw, device="cpu")
            jax_maps = jfc.fft_conv(data, kernels=bank, **kw)
            want = tfc.fft_conv(data, kernels=bank, mode="same", algorithm=algorithm, device="cpu")
            assert str(got.dtype).removeprefix("torch.") == str(jax_maps.dtype)
            got = got.float().numpy()
            assert rel_err(got, np.asarray(jax_maps, np.float32)) < 2e-2
            assert rel_err(got, want.numpy()) < 2e-2
        return
    if item == "queue 2 item 1":
        for algorithm in ("direct", "tiled"):
            got = tfc.fft_conv(data, kernels=bank, mode="same", algorithm=algorithm,
                               device="cpu", **kwargs)
            want = tfc.fft_conv(data, kernels=bank, mode="same", algorithm=algorithm, device="cpu")
            jax_maps = jfc.fft_conv(data, kernels=bank, mode="same", algorithm=algorithm,
                                    **kwargs)
            assert rel_err(got.numpy(), want.numpy()) < TOL
            assert rel_err(got.numpy(), np.asarray(jax_maps)) < TOL


def test_amortized_paths_match_one_shot(bank_case):
    data, bank = bank_case
    one_shot = tfc.fft_conv(data, kernels=bank, mode="same", device="cpu")
    tiled = tfc.fft_data_tiled(data, 9, 13, trim_mode="same", device="cpu")
    sk = tfc.fft_kernels(bank, spectral=tiled)
    assert (sk.fft_h, sk.fft_w) == (tiled.block_h, tiled.block_w)
    assert torch.equal(tfc.conv_spectral(tiled, sk, mode="same"), one_shot)
    direct = tfc.fft_data(data, 9, 13, device="cpu")
    maps = tfc.conv_spectral(direct, bank, mode="same")
    assert rel_err(maps.numpy(), one_shot.numpy()) < TOL
    # 'full' spectra serve every linear window
    full = tfc.fft_data_tiled(data, 9, 13, device="cpu")
    sk_full = tfc.fft_kernels(bank, spectral=full)
    same = tfc.conv_spectral(full, sk_full, mode="same")
    assert rel_err(same.numpy(), one_shot.numpy()) < TOL
    assert tfc.conv_spectral(full, sk_full, mode="valid").shape == (3, 122, 158)


def test_spectral_validation(bank_case):
    data, bank = bank_case
    tiled = tfc.fft_data_tiled(data, 9, 13, trim_mode="same", device="cpu")
    with pytest.raises(tfc.InvalidInputError, match="fftmap"):
        tfc.conv_spectral(tiled, bank, mode="fftmap")
    with pytest.raises(tfc.InvalidInputError, match="falls outside"):
        tfc.conv_spectral(tiled, bank, mode="full")
    with pytest.raises(tfc.InvalidInputError, match="exceed"):
        tfc.conv_spectral(tiled, np.ones((1, 15, 13, 2), np.float32), mode="same")
    direct = tfc.fft_data(data, 5, 5, device="cpu")
    with pytest.raises(tfc.InvalidInputError, match="aliased"):
        tfc.conv_spectral(direct, bank, mode="full")
    with pytest.raises(tfc.InvalidInputError, match="feature dim"):
        tfc.fft_conv(data, kernels=np.ones((1, 3, 3, 1), np.float32), device="cpu")


def test_device_argument(bank_case):
    """numpy input runs where device= says (the card by default); a tensor
    stays on its device."""
    data, bank = bank_case
    out = tfc.fft_conv(data, kernels=bank, mode="same", device="cpu")
    assert out.device.type == "cpu"
    spec = tfc.fft_data_tiled(torch.as_tensor(data), 9, 13, device="cpu")
    assert spec.re.device.type == "cpu" and spec.re.dtype == torch.float32
    assert tfc.fft_kernels(bank, spectral=spec).re.device == spec.re.device


_ENTRIES = {
    "fft_conv": lambda data, bank, **kw: tfc.fft_conv(data, kernels=bank, mode="same", **kw),
    "fft_data": lambda data, bank, **kw: tfc.fft_data(data, 9, 13, **kw).re,
    "fft_data_tiled": lambda data, bank, **kw: tfc.fft_data_tiled(data, 9, 13, **kw).re,
    "fft_kernels": lambda data, bank, **kw: tfc.fft_kernels(bank, 32, 32, **kw).re,
}


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
def test_numpy_input_runs_on_the_card_by_default(bank_case, entry):
    """A numpy input with no device goes to the card; where there is none
    the call raises, naming device='cpu', and nothing runs on the CPU
    instead."""
    data, bank = bank_case
    if torch.cuda.is_available():
        assert _ENTRIES[entry](data, bank).device.type == "cuda"
    else:
        with pytest.raises(tfc.InvalidInputError, match="device='cpu'"):
            _ENTRIES[entry](data, bank)


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
def test_cpu_device_and_cpu_tensors_run_on_the_cpu(bank_case, entry):
    """device='cpu' runs a numpy input on the CPU; a CPU tensor with no
    device stays there; both give the same result."""
    data, bank = bank_case
    on_cpu = _ENTRIES[entry](data, bank, device="cpu")
    kept = _ENTRIES[entry](torch.as_tensor(data), torch.as_tensor(bank))
    assert on_cpu.device.type == kept.device.type == "cpu"
    assert torch.equal(on_cpu, kept)


def test_load_spectral_device(tmp_path, bank_case):
    """A checkpoint restores its planes to the card unless device='cpu'
    (raising where there is no card)."""
    data, bank = bank_case
    path = str(tmp_path / "d.npz")
    tfc.save_spectral(path, tfc.fft_data_tiled(data, 9, 13, device="cpu"))
    assert tfc.load_spectral(path, device="cpu").re.device.type == "cpu"
    with np.load(path) as z:
        fields = {k: z[k] for k in z.files}
    assert tfc.from_numpy(fields, device="cpu").im.device.type == "cpu"
    if torch.cuda.is_available():
        assert tfc.load_spectral(path).re.device.type == "cuda"
        assert tfc.from_numpy(fields).re.device.type == "cuda"
        return
    with pytest.raises(tfc.InvalidInputError, match="device='cpu'"):
        tfc.load_spectral(path)
    with pytest.raises(tfc.InvalidInputError, match="device='cpu'"):
        tfc.from_numpy(fields)


def _jax_maps(spec, bank_spec, mode):
    return np.asarray(jfc.conv_spectral(spec, bank_spec, mode=mode))


def _meta(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if f.name not in ("re", "im")}


def test_checkpoint_jax_to_port(tmp_path, bank_case):
    """Block spectra and a bank's spectra saved by the JAX package load
    into the port's containers and give the same maps."""
    data, bank = bank_case
    jspec = jfc.fft_data_tiled(data, 9, 13, trim_mode="same")
    jbank = jfc.fft_kernels(bank, spectral=jspec)
    jfc.save_spectral(str(tmp_path / "d.npz"), jspec)
    jfc.save_spectral(str(tmp_path / "k.npz"), jbank)
    spec = tfc.load_spectral(str(tmp_path / "d.npz"), device="cpu")
    bank_spec = tfc.load_spectral(str(tmp_path / "k.npz"), device="cpu")
    assert isinstance(spec, tfc.TiledSpectralData)
    assert isinstance(bank_spec, tfc.SpectralKernels)
    assert (spec.block_h, spec.block_w, spec.origin_h, spec.win_w) == (
        jspec.block_h, jspec.block_w, jspec.origin_h, jspec.win_w)
    assert bank_spec.kernel_hs == (9, 9, 9) and bank_spec.flat is False
    got = tfc.conv_spectral(spec, bank_spec, mode="same")
    assert rel_err(got.numpy(), _jax_maps(jspec, jbank, "same")) < TOL
    # the same through from_numpy on the raw arrays
    with np.load(tmp_path / "d.npz") as z:
        again = tfc.from_numpy({k: z[k] for k in z.files}, device="cpu")
    assert torch.equal(again.re, spec.re) and again.win_h == spec.win_h


def test_checkpoint_port_to_jax_round_trip(tmp_path, bank_case):
    data, bank = bank_case
    for spec in (tfc.fft_data_tiled(data, 9, 13, device="cpu"),
                 tfc.fft_data(data, 9, 13, device="cpu")):
        bank_spec = tfc.fft_kernels(bank, spectral=spec)
        tfc.save_spectral(str(tmp_path / "d.npz"), spec)
        tfc.save_spectral(str(tmp_path / "k.npz"), bank_spec)
        jspec = jfc.load_spectral(str(tmp_path / "d.npz"))
        jbank = jfc.load_spectral(str(tmp_path / "k.npz"))
        assert type(jspec).__name__ == type(spec).__name__
        want = tfc.conv_spectral(spec, bank_spec, mode="full")
        assert rel_err(want.numpy(), _jax_maps(jspec, jbank, "full")) < TOL
        back = tfc.load_spectral(str(tmp_path / "d.npz"), device="cpu")
        assert torch.equal(back.re, spec.re) and torch.equal(back.im, spec.im)
        assert _meta(back) == _meta(spec)


def test_checkpoint_rejects_layouts_not_ported(tmp_path, rng):
    """bf16-tier spectra load at their tier and an unknown store dtype is
    refused. Clamp spectra (ROADMAP queue 1 item 1) load and convolve: a
    JAX clamp checkpoint gives the JAX maps, and a band the kernels' anchor
    cannot serve is the JAX package's error. A JAX flat bank (queue 1 item
    5) loads unpacked to planar planes (flat=False) and gives the JAX
    maps."""
    fields = dict(kind=np.asarray("SpectralData"), store_dtype=np.asarray("bfloat16"),
                  fft_re=np.full((1, 4, 3), 1.5, np.float32),
                  fft_im=np.zeros((1, 4, 3), np.float32),
                  fft_h=np.asarray(4), fft_w=np.asarray(4), data_h=np.asarray(2),
                  data_w=np.asarray(2))
    spec = tfc.from_numpy(fields, device="cpu")
    assert spec.re.dtype == spec.im.dtype == torch.bfloat16 and float(spec.re[0, 0, 0]) == 1.5
    with pytest.raises(tfc.InvalidInputError, match="store_dtype"):
        tfc.from_numpy({**fields, "store_dtype": np.asarray("float16")}, device="cpu")
    fields["store_dtype"] = np.asarray("float32")
    spec = tfc.from_numpy({**fields, "clamp": np.asarray(True), "band_h": np.asarray(1)},
                          device="cpu")
    assert spec.clamp is True and spec.band_h == 1 and spec.band_w == -1
    with pytest.raises(tfc.InvalidInputError, match="band mismatch on the W axis"):
        tfc.conv_spectral(spec, np.ones((1, 2, 2, 1), np.float32), mode="same")
    data = rng.standard_normal((30, 26, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 5, 4, 2)).astype(np.float32)
    jspec = jfc.fft_data(data, 5, 4, padding="clamp")
    jbank = jfc.fft_kernels(bank, spectral=jfc.fft_data(data, 5, 4), storage="flat")
    assert jbank.flat
    jfc.save_spectral(str(tmp_path / "d.npz"), jspec)
    jfc.save_spectral(str(tmp_path / "k.npz"), jbank)
    spec = tfc.load_spectral(str(tmp_path / "d.npz"), device="cpu")
    bank_spec = tfc.load_spectral(str(tmp_path / "k.npz"), device="cpu")
    assert spec.clamp and (spec.band_h, spec.band_w) == (2, 1)
    assert bank_spec.flat is False and bank_spec.re.ndim == 4
    got = tfc.conv_spectral(spec, bank_spec, mode="same")
    assert rel_err(got.numpy(), _jax_maps(jspec, jbank, "same")) < TOL
