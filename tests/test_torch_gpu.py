"""The port on a CUDA GPU: the fused block-conv kernel against its plain
version, and the one-shot call on the card against the same call on the
CPU. These tests need a card and skip without one; they import neither jax
nor the JAX package, so on a GPU host without jax they run as

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

import cuda_fft_convolution_torch as tfc
from cuda_fft_convolution_torch.ops import block_conv as tbc
from cuda_fft_convolution_torch.utils.errors import InvalidInputError

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,f,n,bh,bw,kh,kw,out_h,out_w",
    [
        (2, 3, 5, 45, 151, 10, 24, 100, 300),
        (1, 1, 3, 127, 447, 64, 64, 2048, 2048),  # the headline plan
        (1, 2, 2, 40, 901, 9, 101, 150, 1700),  # Wc = 451: 32-row tiles
    ],
)
def test_block_conv_kernel_matches_plain_on_gpu(cuda, b, f, n, bh, bw, kh, kw,
                                                out_h, out_w):
    rng = np.random.default_rng(7)
    vh, vw = bh - kh + 1, bw - kw + 1
    nbh, nbw, wc = -(-out_h // vh), -(-out_w // vw), bw // 2 + 1

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)

    ops = (t(b, nbh, nbw, f, bh, wc), t(b, nbh, nbw, f, bh, wc),
           t(n, f, bh, wc), t(n, f, bh, wc))
    before = tbc.block_conv.launches
    got = tbc.block_conv(*ops, bh, bw, kh, kw, out_h, out_w)
    want = tbc.block_conv_reference(*ops, bh, bw, kh, kw, out_h, out_w)
    torch.cuda.synchronize()
    assert tbc.block_conv.launches == before + 1
    assert got.is_cuda and got.shape == want.shape
    assert _rel(got, want) <= TOL
    with pytest.raises(InvalidInputError, match="float32"):
        tbc.block_conv(*(x.to(torch.bfloat16) for x in ops), bh, bw, kh, kw, out_h, out_w)
    with pytest.raises(InvalidInputError, match="contiguous"):
        tbc.block_conv(ops[0].transpose(1, 2), *ops[1:], bh, bw, kh, kw, out_h, out_w)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["same", "full", "fftmap"])
def test_fft_conv_on_gpu_matches_cpu(cuda, mode):
    rng = np.random.default_rng(3)
    data = rng.standard_normal((2, 300, 500, 2)).astype(np.float32)
    bank = rng.standard_normal((4, 17, 33, 2)).astype(np.float32)
    before = tbc.block_conv.launches
    got = tfc.fft_conv(data, kernels=bank, mode=mode, device=cuda)
    torch.cuda.synchronize()
    assert tbc.block_conv.launches == before + 1  # the main path ran the kernel
    want = tfc.fft_conv(data, kernels=bank, mode=mode)
    assert got.is_cuda and got.shape == want.shape
    assert _rel(got.cpu(), want) <= TOL
