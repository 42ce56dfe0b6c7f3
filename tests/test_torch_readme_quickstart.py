"""The port README's quick-start example (README.md, "The PyTorch port"),
the same calls in the same order at CPU sizes with ``device="cpu"``, held
against the JAX package's calls of ``tests/test_readme_quickstart.py``
(the JAX README's quick start) where the JAX package has the call, and
against the port's own one-shot call where the README says two calls agree
(a plan's execute, a stream's frames). If this breaks, the port's example
is lying."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import cuda_fft_convolution_torch as fct
import cuda_fft_convolution_tpu as fc
from cuda_fft_convolution_torch import models
from cuda_fft_convolution_torch.models import detect_local_peaks, detect_peaks, detect_top_k
from cuda_fft_convolution_torch.runtime import autotune
from cuda_fft_convolution_tpu.models import detect_peaks as jax_detect_peaks
from tests.oracles import rel_err

TOL = 2e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert rel_err(got, want) <= tol


def test_port_readme_quickstart(rng, tmp_path):
    """The quick start's calls in its order: the one-shot call, the
    detection heads, the direct engine, the CPU call, the bf16 DPM path,
    clamp and centred kernels, a ragged cell array, the pipelined batch and
    the budget, a plan, the two streams, the tuner, the model layer, the
    cores, the reference-packed spectrum, the selftest and the sharded
    calls in a gloo world of one."""
    image = rng.standard_normal((64, 64, 1)).astype(np.float32)
    bank = rng.standard_normal((4, 8, 8, 1)).astype(np.float32)
    maps = fct.fft_conv(image, kernels=bank, mode="same", device="cpu")
    _close(maps, fc.fft_conv(image, kernels=bank, mode="same"))

    vals, pos = detect_peaks(image, bank, device="cpu")
    jv, jp = jax_detect_peaks(image, bank)
    _close(vals, jv)
    assert torch.equal(pos, torch.as_tensor(np.array(jp)).to(pos.dtype))
    top = detect_top_k(image, bank, k=2, device="cpu")
    local = detect_local_peaks(image, bank, device="cpu")
    assert top is not None and local is not None
    direct = fct.fft_conv(image, kernels=bank, mode="same", algorithm="direct", device="cpu")
    _close(direct, fc.fft_conv(image, kernels=bank, mode="same", algorithm="direct"))
    small = fct.fft_conv(image[:32, :32], kernels=bank[:2], mode="same", device="cpu")
    _close(small, fc.fft_conv(image[:32, :32], kernels=bank[:2], mode="same"))

    # the bf16 tier on HOG features: the DPM/HOG detector path
    frame = torch.as_tensor(rng.standard_normal((64, 64)).astype(np.float32))
    feats = models.hog_features(frame, cell=8, bins=31).to(torch.bfloat16)
    assert tuple(feats.shape) == (8, 8, 31)
    filters = torch.as_tensor(rng.standard_normal((3, 3, 3, 31)).astype(np.float32))
    spec = fct.fft_data_tiled(feats, 3, 3, trim_mode="same", store_dtype="bfloat16")
    bank_spec = fct.fft_kernels(filters, spectral=spec, store_dtype="bfloat16")
    scores = fct.conv_spectral(spec, bank_spec, mode="same", out_dtype="bfloat16")
    assert scores.dtype == torch.bfloat16 and tuple(scores.shape) == (3, 8, 8)
    jspec = fc.fft_data_tiled(feats.float().numpy(), 3, 3, trim_mode="same",
                              store_dtype="bfloat16")
    want = fc.conv_spectral(jspec, fc.fft_kernels(filters.numpy(), spectral=jspec,
                                                  store_dtype="bfloat16"), mode="same")
    _close(scores.float(), want, 2e-2)

    edges = fct.fft_conv(image, kernels=bank, mode="same", padding="clamp", device="cpu")
    _close(edges, fc.fft_conv(image, kernels=bank, mode="same", padding="clamp"))
    centred = fct.fft_conv(image, kernels=bank, mode="same", kernel_layout="centered",
                           device="cpu")
    _close(centred, fc.fft_conv(image, kernels=bank, mode="same", kernel_layout="centered"))
    cells = [rng.standard_normal((k, k, 1)).astype(np.float32) for k in (3, 5, 9)]
    per_kernel = fct.fft_conv(image, kernels=cells, mode="same", device="cpu")
    assert isinstance(per_kernel, list) and len(per_kernel) == 3
    for got, want in zip(per_kernel, fc.fft_conv(image, kernels=cells, mode="same")):
        _close(got, want)

    batch_np = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    batch = fct.fft_data(batch_np, 8, 8, device="cpu")
    piped = fct.conv_spectral_pipelined(batch, bank, chunk_size=2, mode="same")
    _close(piped, fc.conv_spectral_pipelined(fc.fft_data(batch_np, 8, 8), bank, chunk_size=2,
                                             mode="same"))
    fct.set_config(hbm_budget_bytes=16 << 30)
    fct.set_config(hbm_budget_bytes=None)

    plan = fct.make_plan(image.shape, bank.shape, algorithm="tiled", mode="same", device="cpu")
    _close(plan.execute(image, bank), maps, 1e-6)
    frames = [rng.standard_normal((64, 64, 1)).astype(np.float32) for _ in range(2)]
    with fct.ConvStream.create(image.shape, bank, depth=3, algorithm="tiled", mode="same",
                               correlation=True, head="peaks", device="cpu") as stream:
        futures = [stream.submit(f) for f in frames]
        hits = [f.result() for f in futures]
    for (hv, hp), f in zip(hits, frames):
        dv, dp = detect_peaks(f, bank, mode="same", correlation=True, device="cpu")
        _close(hv, dv, 1e-6)
        assert torch.equal(hp, dp)
    ragged = fct.RaggedConvStream(image.shape, cells, depth=3, mode="same", algorithm="tiled",
                                  device="cpu")
    per_cell = ragged.submit(image).result()
    for got, want in zip(per_cell, per_kernel):
        _close(got, want, 1e-6)
    try:
        # (the default candidates' blocks are wider than the 64² image)
        best, seconds = fct.autotune_block_geometry((64, 64, 1), 8, 8, n_kernels=2, iters=1,
                                                    candidates=[(16, 32), (24, 40)],
                                                    device="cpu")
        assert len(best) >= 2 and seconds
        fct.save_user_cache()
    finally:
        autotune._MEASURED.clear()

    pyr = models.build_pyramid(feats.float(), 3, 3, num_levels=2, device="cpu")
    det = models.detect_pyramid_peaks(pyr, filters)
    want = models.detect_pyramid_peaks(pyr, filters.numpy())
    assert torch.equal(det.best_level, want.best_level)
    model = models.init_detector(torch.Generator().manual_seed(0), 4, 31, 3, 3, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=3e-2)
    images = torch.as_tensor(rng.standard_normal((2, 31, 16, 16)).astype(np.float32))
    targets = torch.as_tensor(rng.standard_normal((2, 4, 16, 16)).astype(np.float32))
    model, opt, loss = models.train_step(model, opt, images, targets)
    assert np.isfinite(float(loss))

    stack = fct.fft_conv_stack(image.transpose(2, 0, 1), bank.transpose(0, 3, 1, 2),
                               device="cpu")
    _close(stack, fc.fft_conv_stack(image.transpose(2, 0, 1), bank.transpose(0, 3, 1, 2)))
    full = fct.direct_conv_single(image.transpose(2, 0, 1), bank[0].transpose(2, 0, 1),
                                  device="cpu")
    _close(full, fc.direct_conv_single(image.transpose(2, 0, 1), bank[0].transpose(2, 0, 1)))
    sd = fc.fft_data(image, 8, 8)
    packed = np.fft.fft2(np.pad(image, ((0, sd.fft_h - 64), (0, sd.fft_w - 64), (0, 0))),
                         axes=(0, 1))[: sd.fft_h // 2 + 1].astype(np.complex64)
    sd_ref = fct.SpectralData.from_reference_packed(packed, data_h=64, data_w=64, device="cpu")
    jsd_ref = fc.SpectralData.from_reference_packed(packed, data_h=64, data_w=64)
    _close(fct.conv_spectral(sd_ref, [bank[0]], mode="same"),
           fc.conv_spectral(jsd_ref, [bank[0]], mode="same"))
    report = fct.selftest(device="cpu")
    assert report["kernels_ok"] is None

    dist.init_process_group("gloo", init_method=(tmp_path / "store").as_uri(), rank=0,
                            world_size=1)
    try:
        mesh = fct.make_mesh(data=1, device="cpu")
        tspec = fct.fft_data_tiled(image, 8, 8, trim_mode="same", device="cpu")
        bank_sharded = fct.shard_kernel_bank(fct.fft_kernels(bank, spectral=tspec), mesh)
        sharded = fct.conv_spectral_sharded(tspec, bank_sharded, mesh, mode="same")
        _close(sharded.full_tensor(), maps)
        svals, spos = fct.detect_peaks_sharded(tspec, bank, mesh)
        tv, tp = detect_peaks(image, bank, device="cpu")
        _close(svals.full_tensor(), tv, 1e-6)
        with fct.ShardedConvStream(mesh, bank, (64, 64, 1), depth=3) as sstream:
            out = sstream.map(frames)
        assert len(out) == 2
        _close(out[0].full_tensor(), fct.fft_conv(frames[0], kernels=bank, mode="same", device="cpu"),
               1e-5)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("algorithm", ["tiled", "direct"])
def test_port_readme_matches_jax_quickstart(rng, algorithm):
    """``tests/test_readme_quickstart.py``'s calls through the port with
    ``device="cpu"``: correlation scores of a ragged list, the direct
    spectra's maps, the tiled 'same' spectra's maps and direct 'same' (the
    same math), each against the JAX call."""
    data = rng.standard_normal((128, 128, 3)).astype(np.float32)
    bank = [rng.standard_normal((16, 16, 3)).astype(np.float32) for _ in range(6)]
    scores = fct.fft_conv(data, kernels=bank, mode="same", correlation=True, device="cpu",
                          algorithm=algorithm)
    assert tuple(scores.shape) == (6, 128, 128)
    _close(scores, fc.fft_conv(data, kernels=bank, mode="same", correlation=True,
                               algorithm=algorithm))
    sd = fct.fft_data(data, 16, 16, device="cpu")
    maps = fct.conv_spectral(sd, fct.fft_kernels(bank, spectral=sd))
    jsd = fc.fft_data(data, 16, 16)
    _close(maps, fc.conv_spectral(jsd, fc.fft_kernels(bank, spectral=jsd)))
    sdt = fct.fft_data_tiled(data, 16, 16, device="cpu")
    maps_t = fct.conv_spectral(sdt, fct.fft_kernels(bank, spectral=sdt), mode="same")
    assert tuple(maps_t.shape) == (6, 128, 128)
    jsdt = fc.fft_data_tiled(data, 16, 16)
    _close(maps_t, fc.conv_spectral(jsdt, fc.fft_kernels(bank, spectral=jsdt), mode="same"))
