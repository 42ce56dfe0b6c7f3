"""The port's parallel layer (``cuda_fft_convolution_torch/parallel``)
against the JAX package's sharded functions on the same numpy inputs.

One gloo world of 4 CPU ranks runs every scenario of
``tests/torch_parallel_ranks.py`` once for the module, on the meshes
(1, 4) and (2, 2), and returns the gathered ``full_tensor()`` results; the
JAX side runs ``conv_spectral_sharded``, ``detect_peaks_sharded``,
``ShardedConvStream`` and ``jit(train_step)`` under the same shardings on 4
of conftest's 8 virtual CPU devices. Bars: 1e-5 relative at float32, 2e-2
at the bf16 tier, 5e-3 for bf16 maps, equal peak positions; the DP×TP step's
loss within 1e-6 and its updated parameters within 1e-5. The validation
errors run in this process, on a gloo world of one rank."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

import cuda_fft_convolution_torch as tfc
import cuda_fft_convolution_tpu as jfc
from cuda_fft_convolution_torch.utils.errors import InvalidInputError
from cuda_fft_convolution_tpu.models import (
    FilterBankDetector,
    detect_peaks,
    detect_top_k,
    train_step,
)
from tests import torch_parallel_ranks as ranks
from tests.oracles import fft_conv_full_f64, rel_err

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
BF16_TIER_TOL = 2e-2
BF16_OUT_TOL = 5e-3
# JAX's sharded bank carried to the port: data and a 6-kernel bank of 5².
CARRIED = dict(data=(20, 20, 1), bank=(6, 5, 5, 1), seed=30)


def _jax_meshes():
    devices = jax.devices()[:4]
    return (jfc.make_mesh(data=1, kernels=4, devices=devices),
            jfc.make_mesh(data=2, kernels=2, devices=devices))


def _carried_inputs(jm1) -> dict:
    """JAX's shard_kernel_bank spectra (padding included) as the fields of
    a saved SpectralKernels, and the data they go with."""
    rng = np.random.default_rng(CARRIED["seed"])
    data = rng.standard_normal(CARRIED["data"]).astype(np.float32)
    bank = rng.standard_normal(CARRIED["bank"]).astype(np.float32)
    sk = jfc.shard_kernel_bank(
        jfc.fft_kernels(bank, spectral=jfc.fft_data(data, 5, 5), storage="planar"), jm1)
    fields = dict(kind="SpectralKernels", store_dtype="float32", fft_re=np.asarray(sk.re),
                  fft_im=np.asarray(sk.im), fft_h=sk.fft_h, fft_w=sk.fft_w,
                  kernel_hs=np.array(sk.kernel_hs), kernel_ws=np.array(sk.kernel_ws),
                  centered=sk.centered, flat=sk.flat, data=data, bank=bank)
    return {f"carried.{k}": np.asarray(v) for k, v in fields.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the gloo world of 4 once → {'<scenario>.<name>': array}."""
    tmp = tmp_path_factory.mktemp("world")
    np.savez(tmp / "in.npz", **_carried_inputs(_jax_meshes()[0]))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run(
        [sys.executable, "-m", "tests.torch_parallel_ranks", str(tmp / "in.npz"),
         str(tmp / "out.npz")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout[-3000:]}\nstderr:\n{proc.stderr[-3000:]}"
    with np.load(tmp / "out.npz") as z:
        return {k: z[k] for k in z.files}


def _scenario(world, name) -> dict:
    prefix = f"{name}."
    return {k[len(prefix):]: v for k, v in world.items() if k.startswith(prefix)}


@pytest.fixture
def world1(tmp_path):
    """A gloo world of one rank in this process → its (1, 1) mesh."""
    dist.init_process_group("gloo", init_method=(tmp_path / "store").as_uri(), rank=0,
                            world_size=1)
    try:
        yield tfc.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _close(got, want, tol=TOL):
    assert np.shape(got) == np.shape(want)
    assert rel_err(np.asarray(got, np.float32), np.asarray(want, np.float32)) < tol


# ---- conv_spectral_sharded (tests/test_parallel.py) ----


def test_kernel_sharded_bank_matches_single_device(world):
    s = _scenario(world, "direct_list")
    jm1, _ = _jax_meshes()
    want = jfc.conv_spectral_sharded(jfc.fft_data(s["data"], 5, 5), list(s["kernels"]), jm1)
    _close(s["got"], want)
    np.testing.assert_allclose(s["got"], s["single"], atol=1e-6)


def test_bank_not_divisible_by_devices(world):
    s = _scenario(world, "nondivisible_full")
    jm1, _ = _jax_meshes()
    assert len(s["got"]) == 5
    for k, o in zip(s["kernels"], s["got"]):
        assert rel_err(o, fft_conv_full_f64(s["data"], k)) < TOL
    want = jfc.conv_spectral_sharded(jfc.fft_data(s["data"], 3, 3), list(s["kernels"]), jm1,
                                     mode="full")
    _close(s["got"], want)


def test_data_by_kernel_mesh(world):
    s = _scenario(world, "data_by_kernel")
    _, jm2 = _jax_meshes()
    want = jfc.conv_spectral_sharded(jfc.fft_data(s["data"], 3, 3), list(s["kernels"]), jm2)
    _close(s["got"], want)
    np.testing.assert_allclose(s["got"], s["single"], atol=1e-6)


def test_shard_kernel_bank_placement(world):
    s = _scenario(world, "placed_bank")
    jm1, _ = _jax_meshes()
    sd = jfc.fft_data(s["data"], 3, 3)
    want = jfc.conv_spectral_sharded(
        sd, jfc.shard_kernel_bank(jfc.fft_kernels(list(s["kernels"]), spectral=sd), jm1), jm1)
    _close(s["got"], want)
    assert int(s["num_kernels"]) == 8 and int(s["local_rows"]) == 2


def test_presharded_bank_skips_replacement(world):
    """A placed bank passes shard_kernel_bank unchanged, and the sharded
    call reads its local shard where it lies, on every rank."""
    s = _scenario(world, "placed_bank")
    assert s["not_placed_again"].tolist() == [True] * 4


def test_tiled_sharded_bank(world):
    s = _scenario(world, "tiled_bank")
    jm1, _ = _jax_meshes()
    sd = jfc.fft_data_tiled(s["data"], 5, 5, block_h=32, block_w=32)
    want = jfc.conv_spectral_sharded(sd, list(s["kernels"]), jm1, mode="same")
    _close(s["got"], want)
    np.testing.assert_allclose(s["got"], s["single"], atol=1e-6)


def test_tiled_sharded_baked_window(world):
    s = _scenario(world, "tiled_bank")
    jm1, _ = _jax_meshes()
    baked = jfc.fft_data_tiled(s["data"], 5, 5, block_h=32, block_w=32, trim_mode="same")
    _close(s["baked"], jfc.conv_spectral_sharded(baked, list(s["kernels"]), jm1, mode="same"))
    # different block tilings round differently: compare at output scale
    assert np.max(np.abs(s["baked"] - s["single"])) / np.max(np.abs(s["single"])) < 1e-6


def test_tiled_sharded_batched_2d_mesh(world):
    s = _scenario(world, "tiled_batched_2d")
    _, jm2 = _jax_meshes()
    sd = jfc.fft_data_tiled(s["data"], 3, 3, block_h=16, block_w=16)
    _close(s["got"], jfc.conv_spectral_sharded(sd, list(s["kernels"]), jm2, mode="full"))
    np.testing.assert_allclose(s["got"], s["single"], atol=1e-6)


def test_sharded_chunked_under_tight_budget(world):
    s = _scenario(world, "chunked")
    assert s["chunked"].tolist() == [True] * 4
    _close(s["got"], jfc.conv_spectral(jfc.fft_data(s["data"], 5, 5), s["kernels"]))


def test_sharded_streaming_spatial_giant_bank(world):
    s = _scenario(world, "streaming")
    assert s["streamed"].tolist() == [True] * 4
    want = jfc.conv_spectral(jfc.fft_data(s["data"], 4, 4), s["kernels"], mode="same")
    _close(s["got"], want)
    np.testing.assert_allclose(s["got"], s["single"], atol=1e-6)


def test_sharded_same_offset_matlab(world):
    s = _scenario(world, "matlab_offset")
    jm1, _ = _jax_meshes()
    want = jfc.conv_spectral_sharded(jfc.fft_data(s["data"], 4, 4), s["kernels"], jm1,
                                     mode="same", same_offset="matlab")
    _close(s["got"], want)


def test_tiled_sharded_fftmap_canvas(world):
    s = _scenario(world, "tiled_fftmap")
    jm1, _ = _jax_meshes()
    want = jfc.fft_conv(s["data"], kernels=list(s["kernels"]), mode="fftmap", algorithm="direct")
    _close(s["got"], want)
    _close(s["direct"], want)
    baked = jfc.fft_data_tiled(s["data"], 5, 5, block_h=32, block_w=32, trim_mode="fftmap")
    _close(s["got"], jfc.conv_spectral_sharded(baked, list(s["kernels"]), jm1, mode="fftmap"))


def test_sharded_bank_smaller_than_the_mesh(world):
    """Two kernels over four ranks: the empty shards run zero kernels and
    the maps, on both engines, and the peaks come back whole."""
    s = _scenario(world, "small_bank")
    jm1, _ = _jax_meshes()
    sd = jfc.fft_data(s["data"], 5, 5)
    st = jfc.fft_data_tiled(s["data"], 5, 5, block_h=16, block_w=16, trim_mode="same")
    _close(s["direct"], jfc.conv_spectral_sharded(sd, s["kernels"], jm1, mode="same"))
    _close(s["tiled"], jfc.conv_spectral_sharded(st, s["kernels"], jm1, mode="same"))
    np.testing.assert_allclose(s["direct"], s["single"], atol=1e-6)
    jv, jp = jfc.detect_peaks_sharded(st, jnp.asarray(s["kernels"]), jm1)
    np.testing.assert_array_equal(s["positions"], np.asarray(jp))
    np.testing.assert_allclose(s["values"], np.asarray(jv), rtol=TOL)


def test_sharded_ragged_bank(world):
    """A ragged cell list: one 'same' map a cell, each against JAX's."""
    s = _scenario(world, "ragged")
    jm1, _ = _jax_meshes()
    cells = [s[f"cell{i}"] for i in range(len(s["sizes"]))]
    want = jfc.conv_spectral_sharded(jfc.fft_data(s["data"], 9, 9), cells, jm1, mode="same")
    assert int(s["count"]) == len(want) == 5
    for i, w in enumerate(want):
        _close(s[f"got{i}"], w)


def test_sharded_carries_jax_bank_spectra(world):
    """JAX's shard_kernel_bank spectra, padding included, loaded as numpy:
    each rank's local shard equals JAX's shard slice, and the maps agree."""
    s = _scenario(world, "carried_bank")
    assert s["shard_equal"].tolist() == [True] * 4
    jm1, _ = _jax_meshes()
    rng = np.random.default_rng(CARRIED["seed"])
    data = rng.standard_normal(CARRIED["data"]).astype(np.float32)
    bank = rng.standard_normal(CARRIED["bank"]).astype(np.float32)
    sd = jfc.fft_data(data, 5, 5)
    sk = jfc.shard_kernel_bank(jfc.fft_kernels(bank, spectral=sd, storage="planar"), jm1)
    _close(s["got"], jfc.conv_spectral_sharded(sd, sk, jm1))


def test_sharded_out_dtype(world):
    s = _scenario(world, "out_bf16")
    jm1, _ = _jax_meshes()
    assert bool(s["bf16"])
    assert rel_err(s["got"], s["f32"]) < BF16_OUT_TOL
    want = jfc.conv_spectral_sharded(jfc.fft_data(s["data"], 5, 5), list(s["kernels"]), jm1,
                                     mode="same", out_dtype="bfloat16")
    assert rel_err(s["got"], np.asarray(want, np.float32)) < BF16_OUT_TOL


# ---- detect_peaks_sharded ----


def test_detect_peaks_sharded_matches_single_device(world):
    s = _scenario(world, "peaks")
    jm1, jm2 = _jax_meshes()
    window = dict(block_h=32, block_w=32, trim_mode="same", trim_kernel_h=7, trim_kernel_w=5)
    sd = jfc.fft_data_tiled(s["data"], 7, 5, **window)
    bank = jnp.asarray(s["bank"])
    jv, jp = jfc.detect_peaks_sharded(sd, bank, jm1)
    wv, wp = detect_peaks(sd, bank, mode="same")
    np.testing.assert_array_equal(np.asarray(jp), np.asarray(wp))
    for key in ("", "placed_", "single_"):
        np.testing.assert_array_equal(s[f"{key}positions"], np.asarray(jp))
        np.testing.assert_allclose(s[f"{key}values"], np.asarray(jv), rtol=TOL)
    # top-k per kernel, each rank on its own bank shard: the port's
    # single-device detect_top_k exactly, and JAX's top value and position
    assert s["top_values"].shape == (9, 3) and s["top_positions"].shape == (9, 3, 2)
    np.testing.assert_array_equal(s["top_positions"], s["single_top_positions"])
    np.testing.assert_array_equal(s["top_values"], s["single_top_values"])
    tv, tp = jfc.detect_peaks_sharded(sd, bank, jm1, k=3)
    wv3, wp3 = detect_top_k(sd, bank, k=3, mode="same")
    np.testing.assert_array_equal(np.asarray(tp), np.asarray(wp3))
    np.testing.assert_array_equal(s["top_positions"][:, 0], np.asarray(tp)[:, 0])
    np.testing.assert_allclose(s["top_values"][:, 0], np.asarray(tv)[:, 0], rtol=TOL)
    # batched over the (2, 2) mesh
    sdb = jfc.fft_data_tiled(s["bdata"], 7, 5, **window)
    bv, bp = jfc.detect_peaks_sharded(sdb, bank, jm2)
    assert s["b_values"].shape == (2, 9) and s["b_positions"].shape == (2, 9, 2)
    np.testing.assert_array_equal(s["b_positions"], np.asarray(bp))
    np.testing.assert_array_equal(s["single_b_positions"], np.asarray(bp))
    np.testing.assert_allclose(s["b_values"], np.asarray(bv), rtol=TOL)


# ---- ShardedConvStream (tests/test_stream.py, tests/test_out_dtype.py) ----


def _jax_stream(bank, frames, **kw):
    jm1, _ = _jax_meshes()
    with jfc.ShardedConvStream(jm1, bank, frames[0].shape, **kw) as stream:
        return np.stack([np.asarray(f.result()) for f in [stream.submit(x) for x in frames]])


def test_sharded_stream_matches_single_device(world):
    s = _scenario(world, "stream_tiled")
    assert int(s["deepest"]) <= 2
    assert s["got"].shape == (4, 5, 32, 28)
    np.testing.assert_allclose(s["got"], s["single"], atol=1e-5)
    want = _jax_stream(s["bank"], list(s["frames"]), depth=2, mode="same", algorithm="tiled")
    _close(s["got"], want)


def test_sharded_stream_direct_fftmap(world):
    s = _scenario(world, "stream_direct_fftmap")
    want = jfc.conv_spectral(jfc.fft_data(s["frames"][0], 3, 3), s["bank"], mode="fftmap")
    _close(s["got"][0], want)
    _close(s["got"], _jax_stream(s["bank"], list(s["frames"]), depth=1, mode="fftmap",
                                 algorithm="direct"))


def test_sharded_stream_bf16_tier(world):
    s = _scenario(world, "stream_bf16")
    frame = s["frames"][0]
    want = jfc.conv_spectral(jfc.fft_data_tiled(frame, 5, 5, trim_mode="same"), s["bank"],
                             mode="same")
    assert rel_err(s["got"][0], np.asarray(want)) < BF16_TIER_TOL
    jax_tier = _jax_stream(s["bank"], [frame], depth=2, mode="same", store_dtype="bfloat16")
    assert rel_err(s["got"], jax_tier.astype(np.float32)) < BF16_TIER_TOL


def test_sharded_stream_tiled_fftmap(world):
    s = _scenario(world, "stream_tiled_fftmap")
    want = jfc.fft_conv(s["frames"][0], kernels=s["bank"], mode="fftmap", algorithm="direct")
    _close(s["got"][0], want)


def test_sharded_stream_out_dtype(world):
    s = _scenario(world, "stream_out_bf16")
    assert bool(s["bf16"])
    want = jfc.fft_conv(s["frames"][0], 5, 5, s["bank"], mode="same")
    assert rel_err(s["got"][0], np.asarray(want)) < BF16_OUT_TOL


def test_sharded_stream_batched_2d_mesh(world):
    """Batched frames on (2, 2): the frames' batch over the data axis."""
    s = _scenario(world, "stream_batched_2d")
    np.testing.assert_allclose(s["got"], s["single"], atol=1e-5)
    want = np.stack([np.asarray(jfc.fft_conv(f, kernels=s["bank"], mode="same",
                                             algorithm="direct")) for f in s["frames"]])
    _close(s["got"], want)


# ---- the DP×TP training step ----


def test_train_step_sharded_matches_jax_sharded_jit(world):
    """train_step_sharded on (2, 2), Adam: the losses and the updated
    parameters of JAX's jit(train_step) under the same shardings."""
    s = _scenario(world, "train")
    _, jm2 = _jax_meshes()
    tx = optax.adam(ranks.TRAIN["lr"])
    model = FilterBankDetector(kernels=jnp.asarray(s["kernels"]), bias=jnp.asarray(s["bias"]))
    opt_state = tx.init(model)
    model = jax.device_put(model, FilterBankDetector(
        kernels=NamedSharding(jm2, P("kernels", None, None, None)),
        bias=NamedSharding(jm2, P("kernels"))))
    images = jax.device_put(s["images"], NamedSharding(jm2, P("data", None, None, None)))
    targets = jax.device_put(s["targets"], NamedSharding(jm2, P("data", "kernels", None, None)))
    step = jax.jit(lambda m, o, x, y: train_step(m, o, x, y, tx))
    losses = []
    for _ in range(ranks.TRAIN["steps"]):
        model, opt_state, loss = step(model, opt_state, images, targets)
        losses.append(float(loss))
    np.testing.assert_allclose(s["losses"], losses, rtol=1e-6)
    _close(s["new_kernels"], model.kernels)
    _close(s["new_bias"], model.bias)


# ---- validation, in a gloo world of one rank ----


def test_make_mesh_validation(world1):
    with pytest.raises(ValueError, match="mesh 3x5 != 1 available devices"):
        tfc.make_mesh(data=3, kernels=5, device="cpu")
    with pytest.raises(ValueError, match="not divisible by data=3"):
        tfc.make_mesh(data=3, device="cpu")
    assert world1.shape == (1, 1) and world1.mesh_dim_names == ("data", "kernels")


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(InvalidInputError, match="init_process_group"):
        tfc.make_mesh(device="cpu")


def test_make_mesh_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(InvalidInputError, match="device='cpu'"):
        tfc.make_mesh()


@pytest.mark.parametrize("cards, match", [(0, "device='cpu'"), (1, "needs 2 cards")])
def test_dryrun_launch_puts_one_rank_on_a_card(monkeypatch, cards, match):
    """The dry run's launcher runs on the card unless asked for the CPU, one
    rank a card: with no card, or fewer cards than ranks, it raises before
    spawning anything."""
    from cuda_fft_convolution_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(InvalidInputError, match=match):
        dryrun.launch(2, ranks.fail_one_rank)


def test_tiled_sharded_rejects_oversized_kernel(world1, rng):
    data = rng.standard_normal((64, 64, 1)).astype(np.float32)
    sd = tfc.fft_data_tiled(data, 5, 5, block_h=32, block_w=32, device="cpu")
    big = rng.standard_normal((9, 9, 1)).astype(np.float32)
    with pytest.raises(ValueError):
        tfc.conv_spectral_sharded(sd, [big], world1, mode="same")


def test_sharded_fftmap_needs_the_canvas(world1, rng):
    """Raw maps on tiled spectra need the baked canvas, and the peaks head
    refuses the canvas (no global peak frame), as in JAX."""
    data = rng.standard_normal((60, 50, 2)).astype(np.float32)
    kerns = rng.standard_normal((3, 5, 5, 2)).astype(np.float32)
    plain = tfc.fft_data_tiled(data, 5, 5, block_h=32, block_w=32, device="cpu")
    with pytest.raises(InvalidInputError, match="canvas"):
        tfc.conv_spectral_sharded(plain, kerns, world1, mode="fftmap")
    canvas = tfc.fft_data_tiled(data, 5, 5, block_h=32, block_w=32, trim_mode="fftmap",
                                device="cpu")
    with pytest.raises(InvalidInputError, match="fftmap"):
        tfc.detect_peaks_sharded(canvas, kerns, world1)
    direct = tfc.fft_data(data, 5, 5, device="cpu")
    with pytest.raises(InvalidInputError, match="TiledSpectralData"):
        tfc.detect_peaks_sharded(direct, kerns, world1)


def test_sharded_stream_validation(world1, rng):
    kerns = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    with pytest.raises(ValueError):
        tfc.ShardedConvStream(world1, kerns, (16, 16, 1), depth=0)
    with pytest.raises(ValueError):
        tfc.ShardedConvStream(world1, kerns[0], (16, 16, 1))
    stream = tfc.ShardedConvStream(world1, kerns, (16, 16, 1), depth=1)
    with pytest.raises(ValueError):
        stream.submit(np.zeros((8, 16, 1), np.float32))


def test_sharded_stream_constructs_without_staging(world1, rng, monkeypatch):
    """The stream takes its geometry from a lazy plan: construction stages
    no frame (JAX's eval_shape pass) and transforms only the bank; a submit
    stages once."""
    from cuda_fft_convolution_torch import api

    calls = {"n": 0}
    real = api.fft_data_tiled

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(api, "fft_data_tiled", counting)
    kerns = rng.standard_normal((8, 3, 3, 1)).astype(np.float32)
    stream = tfc.ShardedConvStream(world1, kerns, (16, 16, 1), depth=1)
    assert calls["n"] == 0
    out = stream.submit(rng.standard_normal((16, 16, 1)).astype(np.float32)).result()
    assert calls["n"] == 1
    assert tuple(out.shape) == (8, 16, 16)
    assert isinstance(out, torch.distributed.tensor.DTensor)
