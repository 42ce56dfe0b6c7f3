"""The MAC kernel's schedule (``csrc/spectral_mac.cu``) on the CPU: a plain
torch emulation that walks the launch as the kernel does (for a batch tile
the pixel chunk outermost and the (TB, TN) register tiles fastest, the
one-row tile in the order of the kernel before tiles; a ragged last tile's
rows clamped to the last row for loads and masked for stores; pixels past
S masked), held against the JAX package's Pallas MAC
(``spectral_mac_pallas_planes``, interpret mode) on the same seeded numpy
inputs, for every tile the kernel instantiates; and the tile rule
(``ops/spectral_mac.py mac_tile``).

Tolerance: 1e-5 relative to the largest |value| (the repo's fp32 bar). The
kernel itself runs only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_fft_convolution_torch.ops import spectral_mac as tmac
from cuda_fft_convolution_tpu.ops import spectral_mac as jmac
from tests.oracles import rel_err

TOL = 1e-5
THREADS = 256  # csrc/spectral_mac.cu kThreads

# (B, N, F, H, Wc): ragged in every direction (B = 3 and N = 13 leave
# partial tiles, S = 1000 a partial chunk for every tile), the trainer's
# launch pattern at 20 x 11 pixels (the forward (8, 3, 5) and two
# backward-like shapes whose B, N and F trade places), a batch of 4 in a
# tile of 8 (B = 4, N = 9, S = 1110), and one image (S = 2345, three
# chunks of the one-row tile).
SHAPES = [(3, 13, 5, 40, 25), (8, 5, 3, 20, 11), (5, 3, 2, 20, 11), (2, 3, 5, 20, 11),
          (4, 9, 2, 30, 37), (1, 7, 3, 67, 35)]


def emulate_schedule(dr, di, kr, ki, tb, tn):
    """The kernel's launch with tile (tb, tn), in torch: every CTA of the
    grid (a batch tile's order is chunk, image tile, filter tile; the
    one-row tile's image, chunk, filter, the order of the kernel before
    tiles), each thread's kPer pixels
    spaced THREADS apart, f ascending, the kernel's two chains an output
    (real: −Ki·Di then +Kr·Dr; imaginary: +Ki·Dr then +Kr·Di) → (B, N, H,
    Wc) planes and the number of times each output was written.

    It mirrors ``csrc/spectral_mac.cu`` (``spectral_mac_kernel``'s grid
    decode, ``pixels_per_thread``, the row clamps and the store masks) by
    hand and runs none of it: edit it with the kernel. The kernel itself is
    held to the einsum at these shapes on the card
    (``tests/test_torch_gpu.py``, ``chip_smoke.py check_mac_tiles``)."""
    b, f, h, wc = dr.shape
    n, s = kr.shape[0], h * wc
    dr, di, kr, ki = (x.reshape(x.shape[0], f, s) for x in (dr, di, kr, ki))
    per = 4 if (tb, tn) == (1, 1) else 1  # pixels a thread (pixels_per_thread)
    pix = THREADS * per
    tiles_b, tiles_n = -(-b // tb), -(-n // tn)
    chunks = -(-s // pix)
    o_re = torch.full((b, n, s), float("nan"))
    o_im = torch.full((b, n, s), float("nan"))
    writes = torch.zeros((b, n, s), dtype=torch.int32)
    thread = torch.arange(THREADS)
    for bid in range(chunks * tiles_b * tiles_n):
        n0, rest = (bid % tiles_n) * tn, bid // tiles_n
        if (tb, tn) == (1, 1):  # image, chunk, filter
            chunk, b0 = rest % chunks, rest // chunks
        else:  # chunk, image tile, filter tile
            b0, chunk = (rest % tiles_b) * tb, rest // tiles_b
        p = torch.cat([chunk * pix + q * THREADS + thread for q in range(per)])
        p = p[p < s]
        drow = [min(b0 + t, b - 1) for t in range(tb)]
        krow = [min(n0 + u, n - 1) for u in range(tn)]
        ar = torch.zeros((tb, tn, p.numel()))
        ai = torch.zeros((tb, tn, p.numel()))
        for ff in range(f):
            xr, xi = dr[drow, ff][:, None, p], di[drow, ff][:, None, p]
            yr, yi = kr[krow, ff][None, :, p], ki[krow, ff][None, :, p]
            ar = (ar - yi * xi) + yr * xr
            ai = (ai + yi * xr) + yr * xi
        for t in range(tb):
            for u in range(tn):
                if b0 + t < b and n0 + u < n:
                    o_re[b0 + t, n0 + u, p] = ar[t, u]
                    o_im[b0 + t, n0 + u, p] = ai[t, u]
                    writes[b0 + t, n0 + u, p] += 1
    return o_re.reshape(b, n, h, wc), o_im.reshape(b, n, h, wc), writes


@functools.lru_cache(maxsize=None)
def _inputs_and_jax(shape):
    b, n, f, h, wc = shape
    rng = np.random.default_rng(sum(shape))
    planes = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, f, h, wc),) * 2 + ((n, f, h, wc),) * 2]
    want = jmac.spectral_mac_pallas_planes(*map(jnp.asarray, planes), interpret=True)
    return planes, tuple(np.asarray(w) for w in want)


@pytest.mark.parametrize("tile", tmac.MAC_TILES, ids="{0[0]}x{0[1]}".format)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}N{}F{}_{}x{}".format(*s))
def test_schedule_matches_jax_pallas(shape, tile):
    """Every output is written exactly once, by the tile that owns it, and
    equals the JAX Pallas MAC within 1e-5."""
    planes, want = _inputs_and_jax(shape)
    got_re, got_im, writes = emulate_schedule(*map(torch.as_tensor, planes), *tile)
    assert bool((writes == 1).all())
    for g, w in zip((got_re, got_im), want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert rel_err(g.numpy(), w) < TOL


def test_schedule_at_the_rules_tile_equals_the_wrapper_on_cpu():
    """At the tile ``mac_tile`` picks, the emulation agrees with what the
    wrapper returns on CPU tensors (its plain version) within 1e-5."""
    for shape in SHAPES:
        planes, _ = _inputs_and_jax(shape)
        ops = list(map(torch.as_tensor, planes))
        tile = tmac.mac_tile(shape[0])
        got = emulate_schedule(*ops, *tile)[:2]
        plain = tmac.spectral_mac(*ops)
        for g, w in zip(got, plain):
            assert rel_err(g.numpy(), w.numpy()) < TOL


def test_tile_rule():
    """Every tile the rule returns is instantiated by the kernel; one image
    keeps TB = 1 (the one-row tile the kernel ran before tiles); every
    batch, the trainer's launches (8 frames, 31 channels, 64 filters:
    forward (8, 31, 64), dK (64, 8, 31), dD (8, 64, 31)), the pipelined
    direct batch (8 images) and the unfused headline (192 blocks) among
    them, takes 8 images × 4 filters."""
    for b in range(1, 70):
        tb, tn = tmac.mac_tile(b)
        assert (tb, tn) in tmac.MAC_TILES
        assert tb >= min(b, 8)
        assert (tb == 1) == (b == 1)
    assert tmac.mac_tile(1) == (1, 1)
    for b in (2, 3, 4, 5, 8, 64, 192):
        assert tmac.mac_tile(b) == (8, 4)

