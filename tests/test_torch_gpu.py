"""The port on a CUDA GPU: the fused block-conv, peaks and spectral-MAC
kernels against their plain versions, and the one-shot call, the direct
engine (through the MAC kernel) and ``detect_peaks`` on the card against
the same calls on the CPU. These tests need a card and skip without one; they import neither jax
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


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,f,n,bh,bw,kh,kw,out_h,out_w",
    [
        (2, 3, 5, 45, 151, 10, 24, 100, 300),
        (1, 1, 3, 127, 447, 64, 64, 2048, 2048),  # the headline plan
        (1, 2, 2, 40, 901, 9, 101, 150, 1700),  # Wc = 451: 32-row tiles, 2 row chunks
    ],
)
def test_block_conv_peaks_kernel_matches_plain_on_gpu(cuda, b, f, n, bh, bw, kh, kw,
                                                      out_h, out_w):
    """Values within TOL of the plain version relative to the largest value;
    indices equal (random spectra: no near-ties at these sizes)."""
    rng = np.random.default_rng(11)
    vh, vw = bh - kh + 1, bw - kw + 1
    nbh, nbw, wc = -(-out_h // vh), -(-out_w // vw), bw // 2 + 1

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)

    ops = (t(b, nbh, nbw, f, bh, wc), t(b, nbh, nbw, f, bh, wc),
           t(n, f, bh, wc), t(n, f, bh, wc))
    before = tbc.block_conv_peaks.launches
    got_v, got_i = tbc.block_conv_peaks(*ops, bh, bw, kh, kw, out_h, out_w)
    want_v, want_i = tbc.block_conv_peaks_reference(*ops, bh, bw, kh, kw, out_h, out_w)
    torch.cuda.synchronize()
    assert tbc.block_conv_peaks.launches == before + 1
    assert got_v.shape == want_v.shape == (b, n, nbh, nbw)
    assert got_i.dtype == torch.int32
    assert _rel(got_v, want_v) <= TOL
    assert torch.equal(got_i, want_i)
    with pytest.raises(InvalidInputError, match="float32"):
        tbc.block_conv_peaks(*(x.double() for x in ops), bh, bw, kh, kw, out_h, out_w)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [1, 3])
def test_spectral_mac_kernel_matches_einsum_on_gpu(cuda, f):
    from cuda_fft_convolution_torch.ops import spectral_mac as tmac

    rng = np.random.default_rng(5)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)

    ops = (t(2, f, 67, 35), t(2, f, 67, 35), t(7, f, 67, 35), t(7, f, 67, 35))
    before = tmac.spectral_mac.launches
    got = tmac.spectral_mac(*ops)
    want = tmac.spectral_mac_planes(*ops)
    torch.cuda.synchronize()
    assert tmac.spectral_mac.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == (2, 7, 67, 35)
        assert _rel(g, w) <= TOL
    # the direct engine runs the kernel
    data = rng.standard_normal((90, 110, f)).astype(np.float32)
    bank = rng.standard_normal((3, 9, 7, f)).astype(np.float32)
    before = tmac.spectral_mac.launches
    maps = tfc.fft_conv(data, kernels=bank, mode="same", algorithm="direct",
                        device=cuda)
    torch.cuda.synchronize()
    assert tmac.spectral_mac.launches == before + 1
    want_maps = tfc.fft_conv(data, kernels=bank, mode="same", algorithm="direct")
    assert _rel(maps.cpu(), want_maps) <= TOL


@pytest.mark.gpu
def test_detect_peaks_on_gpu_matches_cpu(cuda):
    from cuda_fft_convolution_torch.models import detect_peaks

    rng = np.random.default_rng(9)
    data = rng.standard_normal((300, 500, 2)).astype(np.float32)
    bank = rng.standard_normal((4, 17, 33, 2)).astype(np.float32)
    before = tbc.block_conv_peaks.launches
    vals, pos = detect_peaks(torch.as_tensor(data, device=cuda),
                             torch.as_tensor(bank, device=cuda))
    torch.cuda.synchronize()
    assert tbc.block_conv_peaks.launches == before + 1
    want_v, want_p = detect_peaks(data, bank)
    assert torch.equal(pos.cpu(), want_p)
    assert _rel(vals.cpu(), want_v) <= TOL
