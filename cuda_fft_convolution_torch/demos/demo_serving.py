"""Serving patterns, the torch twin of ``examples/demo_serving.py``: how to
run the bank-convolution loop in production. The reference's serving story
is ``cudaFFTData`` then repeated ``cudaConvFFTData`` calls
(src/cudaFFTData.cu:97-150 keeps the data FFT on the GPU between calls).

  1. amortized spectra on both sides (data blocks and the kernel bank);
  2. a baked output window (``trim_mode='same'``): the engine writes 'same'
     maps directly, with no trim copy;
  3. plans (``make_plan``): a fixed geometry, stages warmed up front;
  4. pipelined dispatch: launches queue on the card, a sync every 4th;
  5. frame batching: B frames a call;
  6. ``storage='flat'`` accepted (the port stores every bank planar);
  7. precision tiers: under ``fused_precision='highest'`` the fused
     kernels run 6×TF32 syntheses, and one TF32 pass with
     ``matmul_precision='default'``; each against the default 3×TF32 maps;
  8. ``ConvStream``: bounded-depth serving over resident bank spectra, the
     bank swapped without a new plan;
  9. the bf16 serving tier, and the direct engine's raw circular maps
     (``mode='fftmap'``) served by overlap-save (``trim_mode='fftmap'``);
 10. ``ShardedConvStream``: the stream pool over a device mesh, the bank
     sharded over its kernel axis. The demo starts a world of one rank when
     no process group is running (NCCL on the card, gloo on the CPU): a
     mesh of one runs the code path of a mesh of many. (The JAX demo skips
     this step on one device.)

Times are this run's, printed beside the device.

    python -m cuda_fft_convolution_torch.demos.demo_serving [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

import cuda_fft_convolution_torch as fc
from cuda_fft_convolution_torch.demos import check, demo_device, device_label, rel, sync

H, W, F = 256, 256, 1
N, K = 16, 16


def main(argv=None, device=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = parser.parse_args([] if argv is None else argv)
    dev = demo_device(device, args)
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((8, H, W, F)).astype(np.float32)
    bank = rng.standard_normal((N, K, K, F)).astype(np.float32)
    out = {}

    # 1+2. amortized spectra, the 'same' window baked into the block tiling
    sd = fc.fft_data_tiled(frames[0], K, K, trim_mode="same", device=dev)
    sk = fc.fft_kernels(bank, spectral=sd)
    maps = fc.conv_spectral(sd, sk, mode="same")
    check(tuple(maps.shape) == (N, H, W), f"maps {tuple(maps.shape)}")

    # 3. a plan (the cufftPlanMany analogue): fixed geometry, warmed once
    plan = fc.make_plan(frames[0].shape, bank.shape, algorithm="tiled", mode="same",
                        device=dev)
    out["plan_vs_amortized"] = rel(plan.execute(frames[0], bank), maps)
    check(out["plan_vs_amortized"] < 1e-5, "plan.execute differs")

    # 4. pipelined dispatch: launches queue, a sync every 4th frame
    t0 = time.perf_counter()
    for i, frame in enumerate(frames):
        probe = fc.conv_spectral(fc.fft_data_tiled(frame, K, K, trim_mode="same", device=dev),
                                 sk, mode="same")
        if (i + 1) % 4 == 0:
            sync(dev)
    sync(dev)
    out["pipelined_ms"] = (time.perf_counter() - t0) * 1e3
    check(tuple(probe.shape) == (N, H, W), "pipelined maps")
    print(f"pipelined 8 frames: {out['pipelined_ms']:.1f} ms ({device_label(dev)})")

    # 5. frame batching: B frames a call
    sd_b = fc.fft_data_tiled(frames, K, K, trim_mode="same", device=dev)
    maps_b = fc.conv_spectral(sd_b, sk, mode="same")
    check(tuple(maps_b.shape) == (8, N, H, W), f"batched maps {tuple(maps_b.shape)}")
    out["batched_vs_single"] = rel(maps_b[0], maps)
    check(out["batched_vs_single"] < 1e-5, "batched frame 0 differs")

    # 6. storage='flat' is the JAX package's TPU lane packing; the port
    # stores the bank planar either way, so the maps are the same
    sd_d = fc.fft_data(frames[0], K, K, device=dev)
    maps_flat = fc.conv_spectral(sd_d, fc.fft_kernels(bank, spectral=sd_d, storage="flat"),
                                 mode="same")
    maps_planar = fc.conv_spectral(
        sd_d, fc.fft_kernels(bank, spectral=sd_d, storage="planar"), mode="same")
    check(torch.equal(maps_flat, maps_planar), "flat and planar banks differ")

    # 7. precision tiers: 'highest' runs the fused kernels' 6×TF32
    # syntheses, 'highest' with matmul_precision='default' one TF32 pass
    # (the TPU's single pass, ~2e-3); the same amortized call under each
    before = fc.get_config()
    try:
        fc.set_config(fused_precision="highest")
        out["highest_vs_bf16x3"] = rel(fc.conv_spectral(sd, sk, mode="same"), maps)
        check(out["highest_vs_bf16x3"] < 1e-5, "the 'highest' tier's maps differ")
        fc.set_config(matmul_precision="default")
        out["one_pass_vs_bf16x3"] = rel(fc.conv_spectral(sd, sk, mode="same"), maps)
        check(out["one_pass_vs_bf16x3"] < 2e-3, "the one-pass tier's maps are off")
    finally:
        fc.set_config(fused_precision=before.fused_precision,
                      matmul_precision=before.matmul_precision)
    check(fc.get_config() == before, "the tiers' config was not restored")

    # 8. the bounded-depth stream: plan + resident bank + pipelined dispatch
    with fc.ConvStream.create(frames[0].shape, bank, algorithm="tiled", mode="same",
                              depth=3, device=dev) as stream:
        futures = [stream.submit(f) for f in frames]  # returns at once
        check(stream.inflight <= 3, "more than depth submissions in flight")
        results = [fut.result() for fut in futures]
        out["stream_vs_amortized"] = rel(results[0], maps)
        check(out["stream_vs_amortized"] < 1e-5, "stream frame 0 differs")
        stream.update_kernels(bank[::-1].copy())  # a model update, same plan
        swapped = stream.submit(frames[0]).result()
    out["swap_vs_flipped_bank"] = rel(swapped, maps.flip(0))
    check(out["swap_vs_flipped_bank"] < 1e-5, "the swapped bank's maps differ")

    # 9. the bf16 tier: spectra stored bf16, every sum fp32; both sides opt in
    sd16 = fc.fft_data(frames[0], K, K, store_dtype="bfloat16", device=dev)
    sk16 = fc.fft_kernels(bank, spectral=sd16, store_dtype="bfloat16")
    out["bf16_tier_vs_f32"] = rel(fc.conv_spectral(sd16, sk16, mode="same"), maps)
    check(out["bf16_tier_vs_f32"] < 2e-2, "bf16 tier off")

    # 9b. raw circular maps (mode='fftmap') on the overlap-save engine
    sd_map = fc.fft_data_tiled(frames[0], K, K, trim_mode="fftmap", device=dev)
    raw = fc.conv_spectral(sd_map, bank, mode="fftmap")
    raw_direct = fc.fft_conv(frames[0], K, K, bank, mode="fftmap", algorithm="direct",
                             device=dev)
    check(raw.shape == raw_direct.shape, "fftmap shapes differ")
    out["fftmap_tiled_vs_direct"] = rel(raw, raw_direct)
    check(out["fftmap_tiled_vs_direct"] < 1e-5, "fftmap maps differ")

    # 10. multi-device serving: the stream pool x the kernel-sharded mesh
    # (src/cudaConvFFTDataStreams.cu:273-349: per-GPU stream pairs x kernel
    # round-robin), here in the world the caller runs or in one of one rank
    out["sharded_vs_stream"] = rel(sharded_frame0(dev, bank, frames), results[0])
    check(out["sharded_vs_stream"] < 1e-5, "ShardedConvStream frame 0 differs")
    print("serving demo OK")
    return out


def sharded_frame0(dev: torch.device, bank, frames) -> torch.Tensor:
    """Frame 0's maps from a ``ShardedConvStream`` over all the frames at
    depth 3, gathered; a world of one rank is started (and ended) here when
    no process group runs."""
    started = not dist.is_initialized()
    store = tempfile.TemporaryDirectory() if started else None
    if started:
        kw = {"device_id": torch.device("cuda", torch.cuda.current_device())} \
            if dev.type == "cuda" else {}
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=pathlib.Path(store.name, "store").as_uri(),
                                rank=0, world_size=1, **kw)
    try:
        mesh = fc.make_mesh(device=dev)
        with fc.ShardedConvStream(mesh, bank, frames[0].shape, depth=3, mode="same",
                                  algorithm="tiled") as stream:
            futures = [stream.submit(f) for f in frames]
            return futures[0].result().full_tensor()
    finally:
        if started:
            dist.destroy_process_group()
            store.cleanup()


if __name__ == "__main__":
    main(sys.argv[1:])
