"""The port's twin of the JAX package's seeded property fuzz
(``tests/test_property_fuzz.py``): its five API scenarios, with their
seeds, through ``cuda_fft_convolution_torch`` on the CPU against the same
float64 oracles and cross-checks, and the fused-kernel scenario across the
port's four bodies (v3, and the radix-2 v4, v5, v5x) at random geometries
the JAX package's legality rules admit, against float64 numpy."""

import numpy as np
import torch

import cuda_fft_convolution_torch as fc
from cuda_fft_convolution_torch.ops import block_conv as tbc
from tests.oracles import conv_same_nearest_f64, fft_conv_full_f64, rel_err

TOL = 1e-5
CPU = dict(device="cpu")


def _np(x: torch.Tensor) -> np.ndarray:
    """A map from the port as float32 numpy."""
    return x.float().numpy()


def test_fuzz_api_vs_oracle():
    rng = np.random.default_rng(99)
    for trial in range(12):
        h = int(rng.integers(20, 160))
        w = int(rng.integers(20, 160))
        f = int(rng.integers(1, 4))
        kh = int(rng.integers(1, min(h, 14)))
        kw = int(rng.integers(1, min(w, 14)))
        data = rng.standard_normal((h, w, f)).astype(np.float32)
        kern = rng.standard_normal((kh, kw, f)).astype(np.float32)
        mode = ["full", "same", "valid"][trial % 3]
        algo = (["auto", "direct", "tiled"][trial % 3]
                if min(h, w) > 4 * max(kh, kw) else "direct")
        out = fc.fft_conv(data, kernels=[kern], mode=mode, algorithm=algo, **CPU)
        got = _np(out[0])
        ref = fft_conv_full_f64(data, kern)
        if mode == "same":
            r0, c0 = (kh - 1) // 2, (kw - 1) // 2
            ref = ref[r0 : r0 + h, c0 : c0 + w]
        elif mode == "valid":
            ref = ref[kh - 1 : h, kw - 1 : w]
        assert rel_err(got, ref) < TOL, (h, w, f, kh, kw, mode, algo)


def test_fuzz_fused_variants_random_geometry():
    """JAX's scenario (seed 7: blocks of Lh = 2M with M in {8, 16, 24} and a
    window start w0 a multiple of 8 up to M; ``radix_h_legal`` holds where
    w0 < M) through every body the plan admits — v3 and v4 there; v5 and v5x too at the
    trials whose blocks are 512 wide with kw in {1, 129}, where
    ``radix_w_legal`` holds — each against float64 numpy."""
    rng = np.random.default_rng(7)
    bodies = {"v3": {}, "v4": dict(radix_h=True), "v5": dict(radix_w=True),
              "v5x": dict(radix_w=True, xsliver=True)}
    seen = set()
    for trial in range(6):
        m = int(rng.choice([8, 16, 24]))
        lh = 2 * m
        w0 = int(rng.integers(1, m // 8 + 1)) * 8
        vh, kh = lh - w0, w0 + 1
        if trial % 2:
            kw = int(rng.choice([1, 129]))
            lw, vw = 512, 512 - kw + 1
        else:
            vw = int(rng.choice([16, 32]))
            kw = int(rng.integers(2, 7))
            lw = vw + kw - 1
        f = int(rng.integers(1, 3))
        h = int(rng.integers(2 * vh, 3 * vh))
        w = int(rng.integers(max(2 * vw, kw), 3 * vw))
        data = rng.standard_normal((h, w, f)).astype(np.float32)
        kern = rng.standard_normal((kh, kw, f)).astype(np.float32)
        sd = fc.fft_data_tiled(data, kh, kw, block_h=lh, block_w=lw, **CPU)
        sk = fc.fft_kernels([kern], spectral=sd)
        ref = fft_conv_full_f64(data, kern)[: sd.out_h, : sd.out_w]
        for body, flags in bodies.items():
            legal = body == "v3" or (tbc.radix_h_legal(lh, vh) and (
                body == "v4" or tbc.radix_w_legal(lw, kw, vw)))
            if not legal:
                continue
            got = tbc.block_conv(sd.re[None], sd.im[None], sk.re, sk.im, lh, lw, kh, kw,
                                 sd.out_h, sd.out_w, **flags)[0, 0]
            assert rel_err(got.numpy(), ref) < TOL, (lh, lw, vh, vw, kh, kw, f, body)
            seen.add(body)
    assert seen == set(bodies)


def test_fuzz_bf16_tier_vs_fp32():
    rng = np.random.default_rng(31)
    for trial in range(8):
        h = int(rng.integers(24, 140))
        w = int(rng.integers(24, 140))
        f = int(rng.integers(1, 4))
        kh = int(rng.integers(2, min(h, 12)))
        kw = int(rng.integers(2, min(w, 12)))
        data = rng.standard_normal((h, w, f)).astype(np.float32)
        kern = rng.standard_normal((kh, kw, f)).astype(np.float32)
        mode = ["full", "same", "valid"][trial % 3]
        algo = (["auto", "direct", "tiled"][trial % 3]
                if min(h, w) > 4 * max(kh, kw) else "direct")
        want = fc.fft_conv(data, kernels=[kern], mode=mode, algorithm=algo, **CPU)
        got = fc.fft_conv(data, kernels=[kern], mode=mode, algorithm=algo,
                          store_dtype="bfloat16", **CPU)
        want, got = _np(want[0]), _np(got[0])
        assert got.shape == want.shape
        assert rel_err(got, want) < 2e-2, (h, w, f, kh, kw, mode, algo)


def test_fuzz_clamp_same_vs_nearest_oracle():
    rng = np.random.default_rng(404)
    cases = [(20, 22, 2, 2, "scipy")]
    for trial in range(6):
        cases.append((
            int(rng.integers(16, 48)), int(rng.integers(16, 48)),
            int(rng.integers(2, 9)), int(rng.integers(2, 9)),
            ["scipy", "matlab"][trial % 2],
        ))
    for h, w, kh, kw, off in cases:
        data = rng.standard_normal((h, w)).astype(np.float32)
        kern = rng.standard_normal((kh, kw)).astype(np.float32)
        out = _np(fc.fft_conv(data[:, :, None], kh, kw, [kern[:, :, None]], mode="same",
                              padding="clamp", policy="fast", same_offset=off, **CPU)[0])
        dh = kh // 2 if off == "matlab" else (kh - 1) // 2
        dw = kw // 2 if off == "matlab" else (kw - 1) // 2
        ref = conv_same_nearest_f64(data, kern, dh, dw)
        assert rel_err(out, ref) < TOL, (h, w, kh, kw, off)


def test_fuzz_bank_entry_points_agree():
    rng = np.random.default_rng(1234)
    for trial in range(4):
        h = int(rng.integers(24, 80))
        w = int(rng.integers(24, 80))
        f = int(rng.integers(1, 3))
        kh = int(rng.integers(2, 8))
        kw = int(rng.integers(2, 8))
        n = int(rng.integers(3, 7))
        data = rng.standard_normal((h, w, f)).astype(np.float32)
        bank = rng.standard_normal((n, kh, kw, f)).astype(np.float32)
        sd = fc.fft_data(data, kh, kw, **CPU)
        storage = ["planar", "flat"][trial % 2]
        sk = fc.fft_kernels(bank, spectral=sd, storage=storage)
        a = fc.conv_spectral(sd, sk, mode="same").numpy()
        b = fc.conv_spectral_pipelined(sd, sk, mode="same", chunk_size=2).numpy()
        c = fc.fft_conv(data, kh, kw, bank, mode="same", algorithm="direct", **CPU).numpy()
        np.testing.assert_allclose(b, a, atol=1e-5)
        np.testing.assert_allclose(c, a, atol=1e-5)


def test_fuzz_fftmap_tiled_vs_direct():
    rng = np.random.default_rng(41)
    for trial in range(8):
        h = int(rng.integers(40, 180))
        w = int(rng.integers(40, 180))
        f = int(rng.integers(1, 4))
        kh = int(rng.integers(1, 13))
        kw = int(rng.integers(1, 13))
        n = int(rng.integers(1, 4))
        batched = trial % 3 == 2
        shape = (2, h, w, f) if batched else (h, w, f)
        data = rng.standard_normal(shape).astype(np.float32)
        bank = rng.standard_normal((n, kh, kw, f)).astype(np.float32)
        corr = trial % 2 == 1
        direct = fc.fft_conv(data, kernels=bank, mode="fftmap", algorithm="direct",
                             correlation=corr, **CPU).numpy()
        tiled = fc.fft_conv(data, kernels=bank, mode="fftmap", algorithm="tiled",
                            correlation=corr, **CPU).numpy()
        assert tiled.shape == direct.shape, (trial, tiled.shape, direct.shape)
        assert rel_err(tiled, direct) < TOL, (h, w, f, kh, kw, n, corr)
