"""The per-rank half of tests/test_torch_parallel.py (jax-free).

    python -m tests.torch_parallel_ranks IN.npz OUT.npz

spawns a gloo world of 4 ranks on the CPU through
``cuda_fft_convolution_torch.parallel.dryrun.launch``. Every rank builds the
meshes (1, 4) and (2, 2) and runs each scenario of ``SCENARIOS`` from the
same seeded numpy inputs; the outputs are gathered with ``full_tensor()``
and rank 0 writes inputs and outputs to OUT.npz as ``<scenario>.<name>``.
IN.npz carries what the JAX side made first (JAX's sharded bank spectra).
The test module holds each result against the JAX package's sharded
function on the same inputs.
"""

from __future__ import annotations

import sys
import unittest.mock

import numpy as np
import torch
import torch.distributed as dist

import cuda_fft_convolution_torch as fc
from cuda_fft_convolution_torch import api
from cuda_fft_convolution_torch.models import (
    detect_peaks,
    detect_top_k,
    detector_from_numpy,
)
from cuda_fft_convolution_torch.parallel import dryrun
from cuda_fft_convolution_torch.parallel.mesh import (
    _local_bank,
    kernel_rows,
    train_step_sharded,
)
from cuda_fft_convolution_torch.utils.checkpoint import from_numpy

CPU = dict(device="cpu")
TRAIN = dict(n=4, feat=2, size=16, k=4, batch=4, lr=1e-2, steps=2)


def _f32(*shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


def _host(x) -> np.ndarray:
    return dryrun.gather(x) if not isinstance(x, np.ndarray) else x


def _all_ranks(flag: bool) -> np.ndarray:
    """A per-rank flag gathered on every rank → (world,) bool."""
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, bool(flag))
    return np.array(flags)


def direct_list(m1, m2, extra):
    rng = np.random.default_rng(1)
    data = _f32(32, 24, 3, rng=rng)
    kerns = _f32(10, 5, 5, 3, rng=rng)
    sd = fc.fft_data(data, 5, 5, **CPU)
    got = fc.conv_spectral_sharded(sd, list(kerns), m1)
    return dict(data=data, kernels=kerns, got=_host(got),
                single=fc.conv_spectral(sd, list(kerns)).numpy())


def nondivisible_full(m1, m2, extra):
    rng = np.random.default_rng(2)
    data = _f32(16, 16, 1, rng=rng)
    kerns = _f32(5, 3, 3, 1, rng=rng)
    got = fc.conv_spectral_sharded(fc.fft_data(data, 3, 3, **CPU), list(kerns), m1, mode="full")
    return dict(data=data, kernels=kerns, got=_host(got))


def data_by_kernel(m1, m2, extra):
    rng = np.random.default_rng(3)
    data = _f32(4, 16, 16, 2, rng=rng)
    kerns = _f32(8, 3, 3, 2, rng=rng)
    sd = fc.fft_data(data, 3, 3, **CPU)
    return dict(data=data, kernels=kerns, got=_host(fc.conv_spectral_sharded(sd, list(kerns), m2)),
                single=fc.conv_spectral(sd, list(kerns)).numpy())


def placed_bank(m1, m2, extra):
    """shard_kernel_bank's bank through the sharded call, and not placed
    again: a second shard_kernel_bank returns it, and the call's local
    shard is the placed one (the same storage)."""
    rng = np.random.default_rng(4)
    data = _f32(16, 16, 1, rng=rng)
    kerns = _f32(8, 3, 3, 1, rng=rng)
    sd = fc.fft_data(data, 3, 3, **CPU)
    skd = fc.shard_kernel_bank(fc.fft_kernels(list(kerns), spectral=sd), m1)
    same = (fc.shard_kernel_bank(skd, m1) is skd
            and _local_bank(skd, m1)[0].data_ptr() == skd.re.to_local().data_ptr())
    return dict(data=data, kernels=kerns, got=_host(fc.conv_spectral_sharded(sd, skd, m1)),
                num_kernels=np.int64(skd.num_kernels), not_placed_again=_all_ranks(same),
                local_rows=np.int64(skd.re.to_local().shape[0]))


def tiled_bank(m1, m2, extra):
    rng = np.random.default_rng(5)
    data = _f32(60, 50, 2, rng=rng)
    kerns = _f32(9, 5, 5, 2, rng=rng)  # 9 over 4 ranks: 3, 3, 3 and an empty shard
    sd = fc.fft_data_tiled(data, 5, 5, block_h=32, block_w=32, **CPU)
    baked = fc.fft_data_tiled(data, 5, 5, block_h=32, block_w=32, trim_mode="same", **CPU)
    return dict(data=data, kernels=kerns,
                got=_host(fc.conv_spectral_sharded(sd, list(kerns), m1, mode="same")),
                baked=_host(fc.conv_spectral_sharded(baked, list(kerns), m1, mode="same")),
                single=fc.conv_spectral(sd, list(kerns), mode="same").numpy())


def tiled_batched_2d(m1, m2, extra):
    rng = np.random.default_rng(6)
    data = _f32(2, 40, 40, 1, rng=rng)
    kerns = _f32(4, 3, 3, 1, rng=rng)
    sd = fc.fft_data_tiled(data, 3, 3, block_h=16, block_w=16, **CPU)
    return dict(data=data, kernels=kerns,
                got=_host(fc.conv_spectral_sharded(sd, list(kerns), m2, mode="full")),
                single=fc.conv_spectral(sd, list(kerns), mode="full").numpy())


def chunked(m1, m2, extra):
    """A 120 KiB budget: below one rank's resident bank, products and maps
    in the port's plain-byte model (runtime/planner.py), above twice its
    resident spectra (no streaming) — the per-rank plan chunks the shard.
    (The JAX test's 1 MiB sits in the same place in JAX's tile-padded
    model.)"""
    rng = np.random.default_rng(7)
    data = _f32(32, 32, 2, rng=rng)
    kerns = _f32(16, 5, 5, 2, rng=rng)
    sd = fc.fft_data(data, 5, 5, **CPU)
    spy = unittest.mock.patch.object(api, "_conv_from_spectra_chunked",
                                     wraps=api._conv_from_spectra_chunked)
    fc.set_config(hbm_budget_bytes=120 << 10)
    try:
        with spy as calls:
            got = fc.conv_spectral_sharded(sd, kerns, m1)
    finally:
        fc.set_config(hbm_budget_bytes=None)
    return dict(data=data, kernels=kerns, got=_host(got), chunked=_all_ranks(calls.called))


def streaming(m1, m2, extra):
    """A raw bank whose resident per-rank spectra (30 KB in the port's
    plain-byte model) exceed half a 48 KiB budget: each rank streams its
    spatial shard. (The JAX test's 256 KiB does so in JAX's tile-padded
    model.)"""
    rng = np.random.default_rng(8)
    data = _f32(24, 24, 2, rng=rng)
    kerns = _f32(17, 4, 4, 2, rng=rng)
    sd = fc.fft_data(data, 4, 4, **CPU)
    spy = unittest.mock.patch.object(api, "_conv_from_spatial_chunked",
                                     wraps=api._conv_from_spatial_chunked)
    fc.set_config(hbm_budget_bytes=48 << 10)
    try:
        with spy as calls:
            got = fc.conv_spectral_sharded(sd, kerns, m1, mode="same")
    finally:
        fc.set_config(hbm_budget_bytes=None)
    return dict(data=data, kernels=kerns, got=_host(got), streamed=_all_ranks(calls.called),
                single=fc.conv_spectral(sd, kerns, mode="same").numpy())


def matlab_offset(m1, m2, extra):
    rng = np.random.default_rng(9)
    data = _f32(20, 20, 1, rng=rng)
    kerns = _f32(8, 4, 4, 1, rng=rng)
    sd = fc.fft_data(data, 4, 4, **CPU)
    return dict(data=data, kernels=kerns, got=_host(fc.conv_spectral_sharded(
        sd, kerns, m1, mode="same", same_offset="matlab")))


def tiled_fftmap(m1, m2, extra):
    rng = np.random.default_rng(10)
    data = _f32(60, 50, 2, rng=rng)
    kerns = _f32(9, 5, 5, 2, rng=rng)
    baked = fc.fft_data_tiled(data, 5, 5, block_h=32, block_w=32, trim_mode="fftmap", **CPU)
    return dict(data=data, kernels=kerns,
                got=_host(fc.conv_spectral_sharded(baked, list(kerns), m1, mode="fftmap")),
                direct=fc.fft_conv(data, kernels=list(kerns), mode="fftmap", algorithm="direct",
                                   **CPU).numpy())


def peaks(m1, m2, extra):
    rng = np.random.default_rng(11)
    data = _f32(70, 64, 2, rng=rng)
    bank = _f32(9, 7, 5, 2, rng=rng)
    bdata = _f32(2, 70, 64, 2, rng=rng)
    window = dict(block_h=32, block_w=32, trim_mode="same", trim_kernel_h=7, trim_kernel_w=5,
                  **CPU)
    sd = fc.fft_data_tiled(data, 7, 5, **window)
    sdb = fc.fft_data_tiled(bdata, 7, 5, **window)
    out = dict(data=data, bank=bank, bdata=bdata)
    out["values"], out["positions"] = map(_host, fc.detect_peaks_sharded(sd, bank, m1))
    skd = fc.shard_kernel_bank(fc.fft_kernels(bank, spectral=sd, correlation=True), m1)
    out["placed_values"], out["placed_positions"] = map(_host, fc.detect_peaks_sharded(sd, skd, m1))
    out["top_values"], out["top_positions"] = map(_host, fc.detect_peaks_sharded(sd, bank, m1, k=3))
    out["b_values"], out["b_positions"] = map(_host, fc.detect_peaks_sharded(sdb, bank, m2))
    for key, (v, p) in (("single", detect_peaks(sd, bank, mode="same")),
                        ("single_top", detect_top_k(sd, bank, k=3, mode="same")),
                        ("single_b", detect_peaks(sdb, bank, mode="same"))):
        out[f"{key}_values"], out[f"{key}_positions"] = v.numpy(), p.numpy()
    return out


def small_bank(m1, m2, extra):
    """Two kernels over four ranks: two shards hold only zero kernels."""
    rng = np.random.default_rng(12)
    data = _f32(40, 36, 1, rng=rng)
    bank = _f32(2, 5, 5, 1, rng=rng)
    sd = fc.fft_data(data, 5, 5, **CPU)
    st = fc.fft_data_tiled(data, 5, 5, block_h=16, block_w=16, trim_mode="same", **CPU)
    out = dict(data=data, kernels=bank,
               direct=_host(fc.conv_spectral_sharded(sd, bank, m1, mode="same")),
               tiled=_host(fc.conv_spectral_sharded(st, bank, m1, mode="same")),
               single=fc.conv_spectral(sd, bank, mode="same").numpy())
    out["values"], out["positions"] = map(_host, fc.detect_peaks_sharded(st, bank, m1))
    return out


def ragged(m1, m2, extra):
    """A ragged cell list in mode 'same': one map a kernel, each window at
    its own kernel's offset."""
    rng = np.random.default_rng(13)
    data = _f32(30, 30, 2, rng=rng)
    sizes = (4, 7, 4, 9, 5)
    cells = [_f32(s, s, 2, rng=rng) for s in sizes]
    got = fc.conv_spectral_sharded(fc.fft_data(data, 9, 9, **CPU), cells, m1, mode="same")
    out = dict(data=data, sizes=np.array(sizes), count=np.int64(len(got)))
    for i, (c, g) in enumerate(zip(cells, got)):
        out[f"cell{i}"], out[f"got{i}"] = c, _host(g)
    return out


def out_bf16(m1, m2, extra):
    rng = np.random.default_rng(14)
    data = _f32(24, 24, 2, rng=rng)
    kerns = _f32(8, 5, 5, 2, rng=rng)
    sd = fc.fft_data(data, 5, 5, **CPU)
    got = fc.conv_spectral_sharded(sd, list(kerns), m1, mode="same", out_dtype="bfloat16")
    return dict(data=data, kernels=kerns, got=_host(got),
                bf16=np.bool_(got.dtype == torch.bfloat16),
                f32=fc.conv_spectral(sd, list(kerns), mode="same").numpy())


def carried_bank(m1, m2, extra):
    """JAX's shard_kernel_bank spectra (padding included) carried across
    as numpy: each rank's local shard equals JAX's shard slice."""
    fields = {k.removeprefix("carried."): extra[k] for k in extra if k.startswith("carried.")}
    sk = from_numpy(fields, **CPU)
    skd = fc.shard_kernel_bank(sk, m1)
    start, stop, rows = kernel_rows(len(sk.kernel_hs), m1)
    r = m1.get_coordinate()[1]
    equal = all(
        np.array_equal(local.to_local().numpy(), fields[f"fft_{name}"][r * rows : (r + 1) * rows])
        for name, local in (("re", skd.re), ("im", skd.im))
    )
    sd = fc.fft_data(fields["data"], 5, 5, **CPU)
    return dict(shard_equal=_all_ranks(equal), got=_host(fc.conv_spectral_sharded(sd, skd, m1)))


def train(m1, m2, extra):
    """The DP×TP step on (2, 2) from numpy parameters, Adam, a few steps."""
    rng = np.random.default_rng(15)
    t = TRAIN
    kernels = (_f32(t["n"], t["feat"], t["k"], t["k"], rng=rng)
               / np.sqrt(t["feat"] * t["k"] ** 2)).astype(np.float32)
    bias = _f32(t["n"], rng=rng) * np.float32(0.1)
    images = _f32(t["batch"], t["feat"], t["size"], t["size"], rng=rng)
    targets = _f32(t["batch"], t["n"], t["size"], t["size"], rng=rng)
    start, stop, _ = kernel_rows(t["n"], m2)
    lb = t["batch"] // m2.size(0)
    dr = m2.get_coordinate()[0]
    model = detector_from_numpy({"kernels": kernels[start:stop], "bias": bias[start:stop]}, **CPU)
    opt = torch.optim.Adam(model.parameters(), lr=t["lr"])
    losses = []
    for _ in range(t["steps"]):
        _, _, loss = train_step_sharded(model, opt, images[dr * lb : (dr + 1) * lb],
                                        targets[dr * lb : (dr + 1) * lb, start:stop], m2)
        losses.append(float(loss))
    from torch.distributed.tensor import Replicate, Shard

    from cuda_fft_convolution_torch.parallel.mesh import _wrap

    new = {name: _host(_wrap(p.detach(), m2, (Replicate(), Shard(0)), (t["n"], *p.shape[1:])))
           for name, p in (("kernels", model.kernels), ("bias", model.bias))}
    return dict(kernels=kernels, bias=bias, images=images, targets=targets,
                losses=np.array(losses), new_kernels=new["kernels"], new_bias=new["bias"])


def _stream(mesh, bank, frames, **kw):
    """Serve ``frames`` through a ShardedConvStream; the deepest queue seen
    and each frame's gathered maps."""
    deepest, futs = 0, []
    with fc.ShardedConvStream(mesh, bank, frames[0].shape, **kw) as stream:
        for f in frames:
            futs.append(stream.submit(f))
            deepest = max(deepest, stream.inflight)
        results = [fut.result() for fut in futs]
    return deepest, np.stack([_host(r) for r in results]), results[0].dtype


def stream_tiled(m1, m2, extra):
    rng = np.random.default_rng(16)
    bank = _f32(5, 5, 5, 2, rng=rng)  # non-divisible N
    frames = _f32(4, 32, 28, 2, rng=rng)
    deepest, got, _ = _stream(m1, bank, list(frames), depth=2, mode="same", algorithm="tiled")
    single = np.stack([
        fc.conv_spectral(fc.fft_data_tiled(f, 5, 5, trim_mode="same", **CPU), bank,
                         mode="same").numpy() for f in frames])
    return dict(bank=bank, frames=frames, got=got, deepest=np.int64(deepest), single=single)


def stream_direct_fftmap(m1, m2, extra):
    rng = np.random.default_rng(17)
    bank = _f32(4, 3, 3, 1, rng=rng)
    frames = _f32(1, 20, 20, 1, rng=rng)
    _, got, _ = _stream(m1, bank, list(frames), depth=1, mode="fftmap", algorithm="direct")
    return dict(bank=bank, frames=frames, got=got)


def stream_bf16(m1, m2, extra):
    rng = np.random.default_rng(18)
    bank = _f32(6, 5, 5, 4, rng=rng)
    frames = _f32(1, 40, 36, 4, rng=rng)
    _, got, _ = _stream(m1, bank, list(frames), depth=2, mode="same", store_dtype="bfloat16")
    return dict(bank=bank, frames=frames, got=got)


def stream_tiled_fftmap(m1, m2, extra):
    rng = np.random.default_rng(19)
    bank = _f32(4, 3, 3, 1, rng=rng)
    frames = _f32(1, 40, 40, 1, rng=rng)
    _, got, _ = _stream(m1, bank, list(frames), depth=1, mode="fftmap", algorithm="tiled")
    return dict(bank=bank, frames=frames, got=got)


def stream_out_bf16(m1, m2, extra):
    rng = np.random.default_rng(20)
    bank = _f32(4, 5, 5, 1, rng=rng)
    frames = _f32(1, 24, 24, 1, rng=rng)
    _, got, dtype = _stream(m1, bank, list(frames), depth=2, mode="same", out_dtype="bfloat16")
    return dict(bank=bank, frames=frames, got=got, bf16=np.bool_(dtype == torch.bfloat16))


def stream_batched_2d(m1, m2, extra):
    """Batched frames on (2, 2): the batch over the data axis."""
    rng = np.random.default_rng(21)
    bank = _f32(3, 5, 5, 1, rng=rng)
    frames = _f32(3, 2, 24, 24, 1, rng=rng)
    _, got, _ = _stream(m2, bank, list(frames), depth=2, mode="same", algorithm="direct")
    single = np.stack([fc.fft_conv(f, kernels=bank, mode="same", algorithm="direct",
                                   **CPU).numpy() for f in frames])
    return dict(bank=bank, frames=frames, got=got, single=single)


SCENARIOS = (
    direct_list, nondivisible_full, data_by_kernel, placed_bank, tiled_bank,
    tiled_batched_2d, chunked, streaming, matlab_offset, tiled_fftmap, peaks, small_bank,
    ragged, out_bf16, carried_bank, train, stream_tiled, stream_direct_fftmap, stream_bf16,
    stream_tiled_fftmap, stream_out_bf16, stream_batched_2d,
)


def run(in_path: str, out_path: str) -> None:
    """One rank: every scenario on the two meshes; rank 0 writes OUT.npz."""
    with np.load(in_path) as z:
        extra = {k: z[k] for k in z.files}
    m1 = fc.make_mesh(data=1, device="cpu")
    m2 = fc.make_mesh(data=2, device="cpu")
    results = {}
    for scenario in SCENARIOS:
        for key, value in scenario(m1, m2, extra).items():
            results[f"{scenario.__name__}.{key}"] = value
    if dist.get_rank() == 0:
        np.savez(out_path, **results)


if __name__ == "__main__":
    dryrun.launch(4, run, sys.argv[1], sys.argv[2], device="cpu", timeout=240)


def fail_one_rank() -> None:
    """Rank 1 raises while rank 0 waits in a collective for it."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()


def hang_one_rank() -> None:
    """Rank 1 never reaches the collective rank 0 waits in."""
    if dist.get_rank() == 1:
        import time

        time.sleep(3600)
    dist.barrier()


def _arrive_late(seconds: float) -> float:
    import time

    time.sleep(seconds)
    return seconds


class LateArgument:
    """An argument that takes ``seconds`` to unpickle: a spawned rank that
    receives it starts that much later, before it joins the group."""

    def __init__(self, seconds: float):
        self.seconds = seconds

    def __reduce__(self):
        return _arrive_late, (self.seconds,)


def meet(seconds: float) -> None:
    """Every rank meets the others in one collective."""
    dist.barrier()
