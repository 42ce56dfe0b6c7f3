"""The float64 reference against a direct sum at a small size ('same',
fftmap, correlation, peaks), its HOG copy against the port's, and the
control's rounding."""

import math

import numpy as np
import pytest
import torch

from fftconv_bench.reference import compare
from fftconv_bench.reference.conv import canvas, conv_blocks, next_5smooth, round_fp8, round_tf32
from fftconv_bench.reference.hog import hog


def direct_full(img, k):
    """Full linear convolution by a direct sum: img (H, W, F), k (Kh, Kw, F)."""
    h, w, f = img.shape
    kh, kw, _ = k.shape
    out = np.zeros((h + kh - 1, w + kw - 1))
    for dy in range(kh):
        for dx in range(kw):
            out[dy : dy + h, dx : dx + w] += (img * k[dy, dx]).sum(-1)
    return out


@pytest.fixture
def data():
    rng = np.random.default_rng(3)
    return rng.standard_normal((2, 13, 11, 3)), rng.standard_normal((5, 4, 6, 3))


def all_maps(imgs, bank, **kw):
    blocks = list(conv_blocks(torch.tensor(imgs), torch.tensor(bank), block_bytes=1, **kw))
    assert len(blocks) == bank.shape[0]  # one filter a block at this budget
    return torch.cat([m for _, m in blocks], dim=1).numpy()


@pytest.mark.parametrize("correlation", [False, True])
def test_same(data, correlation):
    imgs, bank = data
    got = all_maps(imgs, bank, mode="same", correlation=correlation)
    kh, kw = bank.shape[1:3]
    for b in range(2):
        for n in range(5):
            k = bank[n, ::-1, ::-1] if correlation else bank[n]
            full = direct_full(imgs[b], k)
            want = full[(kh - 1) // 2 : (kh - 1) // 2 + 13, (kw - 1) // 2 : (kw - 1) // 2 + 11]
            np.testing.assert_allclose(got[b, n], want, atol=1e-12)


def test_fftmap(data):
    imgs, bank = data
    got = all_maps(imgs, bank, mode="fftmap")
    nh, nw = canvas(13, 11, 4, 6)
    assert got.shape == (2, 5, nh, nw) == (2, 5, 16, 16)
    for b in range(2):
        for n in range(5):
            want = np.zeros((nh, nw))
            want[: 13 + 3, : 11 + 5] = direct_full(imgs[b], bank[n])
            np.testing.assert_allclose(got[b, n], want, atol=1e-12)


def test_5smooth():
    assert [next_5smooth(n) for n in (1, 7, 2111, 523, 2160)] == [1, 8, 2160, 540, 2160]


def test_peaks_compare(data):
    imgs, bank = data
    blocks = list(conv_blocks(torch.tensor(imgs[:1]), torch.tensor(bank), mode="same"))
    ref = torch.cat([m for _, m in blocks], dim=1)[0]
    flat = ref.flatten(1)
    idx = flat.argmax(1)
    vals, pos = flat.amax(1), torch.stack([idx // 11, idx % 11], -1)
    exact = compare.peak_errs([(vals[None], pos[None])], blocks)[0]
    assert exact == (0.0, 0.0)
    moved = pos.clone()
    moved[2] = torch.tensor([0, 0]) if idx[2] != 0 else torch.tensor([1, 1])
    v_err, gap = compare.peak_errs([(vals[None], moved[None])], blocks)[0]
    want = float((flat[2].max() - ref[2, moved[2, 0], moved[2, 1]]) / flat[2].abs().max())
    assert v_err == 0.0 and gap == pytest.approx(want) and gap > 0
    outside = pos.clone()
    outside[0, 0] = 13
    assert math.isinf(compare.peak_errs([(vals[None], outside[None])], blocks)[0][1])


def test_map_err(data):
    imgs, bank = data
    blocks = list(conv_blocks(torch.tensor(imgs[:1]), torch.tensor(bank), mode="same"))
    ref = torch.cat([m for _, m in blocks], dim=1)[0]
    assert compare.map_err([ref], blocks) == [0.0]
    bad = ref.clone()
    bad[1, 3, 4] += 0.5 * ref[1].abs().max()
    assert compare.map_err([bad], blocks)[0] == pytest.approx(0.5)
    assert math.isinf(compare.map_err([ref[:, :5]], blocks)[0])


def test_hog_copy_matches_the_port():
    from cuda_fft_convolution_torch.models import hog_features

    g = torch.Generator().manual_seed(5)
    img = 128 + 40 * torch.randn(64, 48, generator=g)
    ours = hog(img, 8, 31)
    port = hog_features(img, cell=8, bins=31, device="cpu")
    assert ours.dtype == torch.float64 and ours.shape == port.shape == (8, 6, 31)
    assert float((ours - port.double()).abs().max()) < 1e-5


def test_control_rounding():
    x = torch.randn(10000, generator=torch.Generator().manual_seed(1))
    t = round_tf32(x)
    assert torch.all(t.view(torch.int32) & 0x1FFF == 0)
    assert float(((t - x) / x).abs().max()) <= 2.0 ** -11
    f = round_fp8(x)
    rel = ((f - x) / x).abs()
    assert float(rel[x.abs() > x.abs().max() / 64].max()) <= 2.0 ** -4
    assert float(rel.median()) > 2.0 ** -9  # coarser than bf16
