"""The six demos (``cuda_fft_convolution_torch.demos``, the torch twins of
``examples/demo*.py``) on the CPU, where the port runs each kernel's plain
version: each ``main`` passes its own checks, and ``demo``'s maps agree
with the JAX package's ``fft_conv`` on the same inputs."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_fft_convolution_tpu as jfc
from cuda_fft_convolution_torch.demos import demo
from tests.oracles import rel_err

TOL = 1e-5


def test_demo_matches_jax_fft_conv():
    out = demo.main(device="cpu")
    assert out["peak"] == out["plant_peak"]
    assert out["max_rel_err"] < TOL and out["split_drift"] < 1e-6
    want = jfc.fft_conv(out["data"], demo.KH, demo.KW, [jnp.asarray(k) for k in out["bank"]],
                        policy="multiple16", correlation=True)
    assert out["maps"].shape == (3, 80, 16)
    assert rel_err(out["maps"], np.asarray(want)) < TOL


@pytest.mark.parametrize("name,argv", [
    ("demo_bank", ["--size", "256"]),
    ("demo_detect", []),
    ("demo_dpm", []),
    ("demo_serving", []),
    ("demo_train", []),
])
def test_demo_passes_on_the_cpu(name, argv):
    out = importlib.import_module(f"cuda_fft_convolution_torch.demos.{name}").main(
        argv, device="cpu")
    assert isinstance(out, dict) and out


def test_demo_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="device='cpu'"):
        demo.main()
    assert demo.main(["--device", "cpu"])["peak"] == (39, 5)


def test_demo_serving_runs_the_sharded_stream():
    """The serving demo's step 10 on the CPU: a gloo world of one rank that
    the demo starts and ends, frame 0 of ShardedConvStream within 1e-5 of
    the ConvStream's maps."""
    import torch.distributed as dist

    from cuda_fft_convolution_torch.demos import demo_serving

    out = demo_serving.main(device="cpu")
    assert out["sharded_vs_stream"] < TOL
    assert not dist.is_initialized()
