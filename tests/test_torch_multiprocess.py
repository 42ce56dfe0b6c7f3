"""The port's multi-process dry run (``python -m
cuda_fft_convolution_torch.parallel.dryrun``, the twin of
``perf/multiproc_dryrun.py``) in a gloo world of two CPU ranks: its OK line,
and its results against the JAX package's single-device functions on the
same inputs. Gloo is there wherever torch is, so nothing here skips. The
launcher stops a world whose rank failed or hung, and fails the run."""

import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

import cuda_fft_convolution_tpu as jfc
from cuda_fft_convolution_tpu.models import FilterBankDetector, detect_peaks, train_step
from tests.oracles import rel_err

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5


def _run(args, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_torch_multiprocess_dryrun(tmp_path):
    proc = _run(["-m", "cuda_fft_convolution_torch.parallel.dryrun", "--world", "2",
                 "--device", "cpu", "--out", str(tmp_path)])
    assert proc.returncode == 0, (
        f"dryrun failed\nstdout:\n{proc.stdout[-2000:]}\nstderr:\n{proc.stderr[-2000:]}")
    assert "parallel dryrun OK: 2 ranks (gloo, cpu), mesh 1x2" in proc.stdout
    with np.load(tmp_path / "dryrun.npz") as z:
        r = {k: z[k] for k in z.files}
    assert r["mesh"].tolist() == [1, 2]

    # the DP×TP step against JAX's single-device step (SGD 1e-2)
    tx = optax.sgd(1e-2)
    model = FilterBankDetector(kernels=jnp.asarray(r["kernels"]), bias=jnp.asarray(r["bias"]))
    new, _, loss = jax.jit(lambda m, o, x, y: train_step(m, o, x, y, tx))(
        model, tx.init(model), r["images"], r["targets"])
    np.testing.assert_allclose(float(r["loss"]), float(loss), rtol=1e-6)
    assert rel_err(r["new_kernels"], np.asarray(new.kernels)) < TOL
    assert rel_err(r["new_bias"], np.asarray(new.bias)) < TOL

    # the sharded conv on the non-divisible bank, and the peaks head
    bank = list(r["bank"])
    assert r["bank"].shape[0] % 2 == 1
    want = jfc.conv_spectral(jfc.fft_data(r["data"], 3, 3), bank)
    assert rel_err(r["maps"], np.asarray(want)) < TOL
    sdp = jfc.fft_data_tiled(r["data"], 3, 3, block_h=16, block_w=16, trim_mode="same",
                             trim_kernel_h=3, trim_kernel_w=3)
    wv, wp = detect_peaks(sdp, jnp.asarray(r["bank"]), mode="same")
    np.testing.assert_array_equal(r["peak_positions"], np.asarray(wp))
    np.testing.assert_allclose(r["peak_values"], np.asarray(wv), rtol=TOL)


def test_launch_stops_a_failed_or_hung_world():
    """A rank that raises, while the other waits for it in a collective,
    fails the launch with a rank's error; a rank that hangs fails it at
    the timeout. Neither leaves a rank running."""
    code = (
        "from cuda_fft_convolution_torch.parallel import dryrun\n"
        "from tests import torch_parallel_ranks as r\n"
        "for fn in (r.fail_one_rank, r.hang_one_rank):\n"
        "    try:\n"
        "        dryrun.launch(2, fn, device='cpu', timeout=8)\n"
        "    except Exception as exc:\n"
        "        print(fn.__name__, type(exc).__name__, flush=True)\n"
        "    else:\n"
        "        print(fn.__name__, 'passed', flush=True)\n"
    )
    t0 = time.monotonic()
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert "fail_one_rank ProcessRaisedException" in lines
    assert "hang_one_rank TimeoutError" in lines
    assert time.monotonic() - t0 < 60


def test_launch_does_not_time_out_a_world_that_starts_slowly():
    """The launch's deadline starts once every rank has joined the group: a
    world whose ranks spend longer than the timeout starting up (each
    unpickles an argument that sleeps 6 s) runs its work within a 4 s
    timeout. The start-up's own limit still fails a world that never
    joins."""
    code = (
        "from cuda_fft_convolution_torch.parallel import dryrun\n"
        "from tests import torch_parallel_ranks as r\n"
        "dryrun.launch(2, r.meet, r.LateArgument(6.0), device='cpu', timeout=4)\n"
        "print('slow start passed', flush=True)\n"
        "try:\n"
        "    dryrun.launch(2, r.meet, r.LateArgument(30.0), device='cpu', timeout=4, startup=3)\n"
        "except TimeoutError as exc:\n"
        "    print('late world', type(exc).__name__, 'joined' in str(exc), flush=True)\n"
    )
    t0 = time.monotonic()
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert "slow start passed" in lines
    assert "late world TimeoutError True" in lines
    assert time.monotonic() - t0 < 90
