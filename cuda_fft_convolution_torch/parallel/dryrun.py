"""Multi-process dry run of the parallel layer — the port of
``perf/multiproc_dryrun.py``.

    python -m cuda_fft_convolution_torch.parallel.dryrun [--world 2] [--data 1]
        [--device cuda] [--out DIR] [--timeout 300]

Spawns ``--world`` ranks (``torch.multiprocessing``, spawn), joined by a
``file://`` store in a temporary directory, each with the default process
group started and one thread. On the card (the default) each rank owns a
card of its own, in an NCCL group, so ``--world`` may not exceed the cards
there are; ``--device cpu`` runs a gloo group on the CPU. Every rank builds ``make_mesh(data, world // data)`` and runs,
at the JAX dry run's sizes, from the same seeded host inputs:

  - the DP×TP training step (``train_step_sharded``, SGD at 1e-2, each rank
    its batch shard and its shard of the bank), against the single-device
    ``train_step`` on the whole model: loss within 1e-6, kernels 1e-5;
  - ``conv_spectral_sharded`` on a non-divisible bank (2k + 1 kernels of
    3², the direct engine), against ``conv_spectral`` (1e-5);
  - ``detect_peaks_sharded`` of the same bank on baked 'same' tiled spectra,
    positions equal to ``detect_peaks``'.

Rank 0 writes the inputs and the gathered results to ``DIR/dryrun.npz``
(``--out``) and prints ``parallel dryrun OK: ...``. A rank that fails fails
the run: the others are stopped, and the parent exits 1; so does a world
still running ``--timeout`` seconds after its last rank joined the group
(the ranks' start-up has a limit of its own: ``launch``'s ``startup``).

``launch`` is the world launcher itself, for any per-rank function.
"""

from __future__ import annotations

import argparse
import datetime
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from cuda_fft_convolution_torch.utils.device import resolve_device
from cuda_fft_convolution_torch.utils.errors import validate

SEED = 0


def _rank_main(rank, world, init, device, timeout, joined, fn, args) -> None:
    """One spawned rank: its thread count, its card, the default process
    group ('nccl' on the card, 'gloo' on the CPU, with the group timeout
    ``timeout``); a report to the launcher (``joined``) once it is in the
    group; ``fn(*args)``; the group destroyed."""
    torch.set_num_threads(1)
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout), **kw,
    )
    joined.release()
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(world: int, fn, *args, device=None, timeout: float = 300.0,
           startup: float = 120.0) -> None:
    """Run ``fn(*args)`` on ``world`` spawned ranks, each with the default
    process group started (a ``file://`` store in a temporary directory):
    one NCCL rank a card on the card (``device=None``, the default, which
    needs ``world`` cards), gloo ranks with ``device='cpu'``. ``fn`` must be
    importable by name (spawn pickles it). Raises when a rank fails (the
    others are stopped), when the ranks have not all joined the group
    ``startup`` seconds after the spawn (a rank's start-up — its
    interpreter, its imports, unpickling ``fn`` and ``args`` — is not the
    world's work), or when the world still runs ``timeout`` seconds after
    the last rank joined. The group's own timeout is ``startup + timeout``,
    so that a rank waiting in a collective for a hung rank outlasts the
    launch's deadline: the launch reports the hang as a ``TimeoutError``."""
    import torch.multiprocessing as mp

    device = resolve_device(device)
    if device.type == "cuda":
        validate(
            world <= torch.cuda.device_count(),
            f"a world of {world} ranks needs {world} cards, one a rank; this "
            f"machine has {torch.cuda.device_count()} (pass device='cpu' for "
            "gloo ranks on the CPU)",
        )
    joined = mp.get_context("spawn").Semaphore(0)
    with tempfile.TemporaryDirectory() as tmp:
        init = pathlib.Path(tmp, "store").as_uri()
        ctx = mp.start_processes(
            _rank_main, args=(world, init, device, startup + timeout, joined, fn, args),
            nprocs=world, join=False, start_method="spawn",
        )
        try:
            ready = time.monotonic() + startup
            for _ in range(world):
                while not joined.acquire(timeout=0.05):
                    ctx.join(timeout=0)  # raises where a rank failed while starting
                    if time.monotonic() >= ready:
                        raise TimeoutError(
                            f"the world of {world} ranks had not joined its group after "
                            f"{startup} s")
            deadline = time.monotonic() + timeout
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"the world of {world} ranks still runs after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()


def gather(x) -> np.ndarray:
    """A ``DTensor`` gathered on every rank (a collective: every rank calls
    it) → float32 or int32 numpy."""
    full = x.full_tensor().detach().cpu()
    return full.numpy() if full.dtype == torch.int32 else full.float().numpy()


def inputs(d_ax: int, k_ax: int) -> dict:
    """The JAX dry run's inputs for a (d_ax, k_ax) mesh, from ``SEED``."""
    rng = np.random.default_rng(SEED)
    batch, feat, h, w = 2 * d_ax, 2, 16, 16
    n_filters, kh, kw = 2 * k_ax, 4, 4
    scale = 1.0 / np.sqrt(feat * kh * kw)
    return {
        "kernels": (scale * rng.standard_normal((n_filters, feat, kh, kw))).astype(np.float32),
        "bias": np.zeros(n_filters, np.float32),
        "images": rng.standard_normal((batch, feat, h, w)).astype(np.float32),
        "targets": rng.standard_normal((batch, n_filters, h, w)).astype(np.float32),
        "data": rng.standard_normal((2 * d_ax, 12, 12, feat)).astype(np.float32),
        # a non-divisible bank on purpose
        "bank": rng.standard_normal((2 * k_ax + 1, 3, 3, feat)).astype(np.float32),
    }


def _close(got, want, tol, what) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    if err > tol:
        raise AssertionError(f"{what}: rel {err:.3e} above {tol:g}")


def dryrun(data: int, out: str | None, device: str | None) -> None:
    """One rank of the dry run (module docstring)."""
    import cuda_fft_convolution_torch as fc
    from cuda_fft_convolution_torch.models import (
        detect_peaks,
        detector_from_numpy,
        train_step,
    )
    from cuda_fft_convolution_torch.parallel.mesh import kernel_rows, mesh_device, train_step_sharded

    mesh = fc.make_mesh(data=data, device=device)
    dev = mesh_device(mesh)
    d_ax, k_ax = mesh.shape
    x = inputs(d_ax, k_ax)
    n_filters = x["kernels"].shape[0]
    lb = x["images"].shape[0] // d_ax
    dr = mesh.get_coordinate()[0]
    start, stop, _ = kernel_rows(n_filters, mesh)
    rank_model = detector_from_numpy(
        {k: x[k][start:stop] for k in ("kernels", "bias")}, device=dev)
    opt = torch.optim.SGD(rank_model.parameters(), lr=1e-2)
    images = torch.as_tensor(x["images"][dr * lb : (dr + 1) * lb], device=dev)
    targets = torch.as_tensor(x["targets"][dr * lb : (dr + 1) * lb, start:stop], device=dev)
    _, _, loss = train_step_sharded(rank_model, opt, images, targets, mesh)
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    from torch.distributed.tensor import Replicate, Shard

    from cuda_fft_convolution_torch.parallel.mesh import _wrap

    new = {
        name: gather(_wrap(p.detach(), mesh, (Replicate(), Shard(0)), (n_filters, *p.shape[1:])))
        for name, p in (("kernels", rank_model.kernels), ("bias", rank_model.bias))
    }
    whole = detector_from_numpy(x, device=dev)
    _, _, want_loss = train_step(whole, torch.optim.SGD(whole.parameters(), lr=1e-2),
                                 x["images"], x["targets"])
    _close(loss, float(want_loss), 1e-6, "DP×TP loss vs the single-device step")
    _close(new["kernels"], whole.kernels.detach().cpu().numpy(), 1e-5,
           "DP×TP kernels vs the single-device step")

    sd = fc.fft_data(x["data"], 3, 3, device=dev)
    bank = torch.as_tensor(x["bank"], device=dev)
    maps = gather(fc.conv_spectral_sharded(sd, bank, mesh))
    _close(maps, fc.conv_spectral(sd, bank).cpu().numpy(), 1e-5,
           "conv_spectral_sharded vs conv_spectral")

    sdp = fc.fft_data_tiled(x["data"], 3, 3, block_h=16, block_w=16, trim_mode="same",
                            trim_kernel_h=3, trim_kernel_w=3, device=dev)
    pv, pp = (gather(t) for t in fc.detect_peaks_sharded(sdp, bank, mesh))
    wv, wp = detect_peaks(sdp, bank, mode="same")
    if not np.array_equal(pp, wp.cpu().numpy()):
        raise AssertionError("detect_peaks_sharded positions differ from detect_peaks'")
    dist.barrier()
    if dist.get_rank() == 0:
        if out is not None:
            pathlib.Path(out).mkdir(parents=True, exist_ok=True)
            np.savez(pathlib.Path(out, "dryrun.npz"), mesh=np.array(mesh.shape), **x,
                     loss=np.float32(loss), new_kernels=new["kernels"], new_bias=new["bias"],
                     maps=maps, peak_values=pv, peak_positions=pp)
        print(f"parallel dryrun OK: {dist.get_world_size()} ranks ({dist.get_backend()}, "
              f"{dev.type}), mesh {d_ax}x{k_ax}, train loss {loss:.6f}, sharded conv "
              f"{maps.shape}, sharded peaks {pp.shape}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--world", type=int, default=2, help="ranks to spawn")
    parser.add_argument("--data", type=int, default=1, help="the mesh's data-axis size")
    parser.add_argument("--device", default=None,
                        help="the card by default, one a rank; 'cpu' for gloo ranks")
    parser.add_argument("--out", default=None, help="directory for dryrun.npz (rank 0)")
    parser.add_argument("--timeout", type=float, default=300.0, help="seconds for the world")
    args = parser.parse_args(argv)
    try:
        launch(args.world, dryrun, args.data, args.out, args.device, device=args.device,
               timeout=args.timeout)
    except Exception as exc:  # a failed or hung rank: report it and fail the run
        print(f"parallel dryrun FAILED: {type(exc).__name__}: {exc}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
