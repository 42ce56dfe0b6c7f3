"""No run loads JAX or the JAX package: the check compares top-level
module names whole, passes for the harness and the port, and fails once
the JAX package is imported. Without a card a run prints no result."""

import os
import subprocess
import sys

from fftconv_bench import spec
from fftconv_bench.run import forbidden_modules


def test_names_are_compared_whole():
    assert forbidden_modules({"jax.numpy": 1, "torch": 1}) == ["jax"]
    assert forbidden_modules({"cuda_fft_convolution_torch.api": 1, "jaxtyping": 1,
                              "cuda_fft_convolution_tpu_extra": 1}) == []
    assert forbidden_modules({"cuda_fft_convolution_tpu.ops": 1}) == ["cuda_fft_convolution_tpu"]


def _python(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(spec.ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_the_harness_and_the_port_load_no_jax():
    r = _python("import fftconv_bench.harness, fftconv_bench.control, "
                "cuda_fft_convolution_torch.models, cuda_fft_convolution_torch.runtime.stream\n"
                "from fftconv_bench.run import forbidden_modules\n"
                "print(forbidden_modules())")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_the_check_fails_once_the_jax_package_is_imported():
    r = _python("import cuda_fft_convolution_tpu\n"
                "from fftconv_bench.run import forbidden_modules\n"
                "print(forbidden_modules())")
    assert r.returncode == 0, r.stderr
    found = eval(r.stdout.strip().splitlines()[-1])
    assert "cuda_fft_convolution_tpu" in found and "jax" in found


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "fftconv_bench.run", "--workload",
                        "headline.same", "--seed", "3000000000", "--seconds", "1",
                        "--trace", "0"], cwd=spec.ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
