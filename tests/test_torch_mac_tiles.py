"""The MAC kernel's schedule (``csrc/spectral_mac.cu``) on the CPU: a plain
torch emulation that walks the launch as the kernel does (for a batch tile
the pixel chunk outermost and the (TB, TN) register tiles fastest, the
one-row tile in the order of the kernel before tiles; a ragged last tile's
rows clamped to the last row for loads and masked for stores; pixels past
S masked; the split form's 32 pixels a CTA, its warps' channel slices and
their partial sums added in warp order), held against the JAX package's
Pallas MAC (``spectral_mac_pallas_planes``, interpret mode) on the same
seeded numpy inputs, for every form the kernel instantiates; and the rule
that picks the form (``ops/spectral_mac.py mac_tile``).

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
# The split form's shapes: MOSSE's respond (B 1, N 1, F 31, 64 x 33 bins),
# and ragged F (2, 5, 31: warps with no channel, and with 3 or 4 steps)
# and S (not a multiple of the 32 pixels a CTA).
SPLIT_SHAPES = [(1, 1, 31, 64, 33), (1, 1, 2, 7, 9), (1, 3, 5, 13, 7), (2, 2, 31, 5, 11)]
SMS = 132  # the H100's SMs
WARPS = 8  # csrc/spectral_mac.cu kWarps


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
    if (tb, tn) == tmac.MAC_SPLIT:
        return emulate_split(dr, di, kr, ki, h, wc)
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


def emulate_split(dr, di, kr, ki, h, wc):
    """The split form's launch (``spectral_mac_split_kernel``) on (B, F, S)
    planes: CTAs in the order filter, pixel chunk, image; 32 pixels a CTA,
    one a lane; warp w sums the channels f = w, w + 8, ... with the
    kernel's two chains; the warps' partial sums added in warp order →
    (B, N, H, Wc) planes and the writes of each output."""
    b, f, s = dr.shape
    n = kr.shape[0]
    chunks = -(-s // 32)
    o_re = torch.full((b, n, s), float("nan"))
    o_im = torch.full((b, n, s), float("nan"))
    writes = torch.zeros((b, n, s), dtype=torch.int32)
    for bid in range(chunks * b * n):
        ni, rest = bid % n, bid // n
        chunk, bb = rest % chunks, rest // chunks
        p = chunk * 32 + torch.arange(32)
        p = p[p < s]
        part_re, part_im = [], []
        for w in range(WARPS):
            ar, ai = torch.zeros(p.numel()), torch.zeros(p.numel())
            for ff in range(w, f, WARPS):
                xr, xi, yr, yi = dr[bb, ff, p], di[bb, ff, p], kr[ni, ff, p], ki[ni, ff, p]
                ar = (ar - yi * xi) + yr * xr
                ai = (ai + yi * xr) + yr * xi
            part_re.append(ar)
            part_im.append(ai)
        vr, vi = part_re[0], part_im[0]
        for w in range(1, WARPS):
            vr, vi = vr + part_re[w], vi + part_im[w]
        o_re[bb, ni, p], o_im[bb, ni, p] = vr, vi
        writes[bb, ni, p] += 1
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


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=lambda s: "B{}N{}F{}_{}x{}".format(*s))
def test_split_form_matches_jax_pallas(shape):
    """The split form at MOSSE's respond shape and at ragged F and S: every
    output written once, within 1e-5 of the largest |value| of the JAX
    Pallas MAC (it sums the channels in another order than the register
    tiles' chain)."""
    planes, want = _inputs_and_jax(shape)
    got_re, got_im, writes = emulate_schedule(*map(torch.as_tensor, planes), *tmac.MAC_SPLIT)
    assert bool((writes == 1).all())
    for g, w in zip((got_re, got_im), want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert rel_err(g.numpy(), w) < TOL


def test_schedule_at_the_rules_tile_equals_the_wrapper_on_cpu():
    """At the form ``mac_tile`` picks, the emulation agrees with what the
    wrapper returns on CPU tensors (its plain version) within 1e-5."""
    for shape in SHAPES + SPLIT_SHAPES:
        planes, _ = _inputs_and_jax(shape)
        ops = list(map(torch.as_tensor, planes))
        b, n, f, h, wc = shape
        tile = tmac.mac_tile(b, n, f, h * wc, SMS)
        got = emulate_schedule(*ops, *tile)[:2]
        plain = tmac.spectral_mac(*ops)
        for g, w in zip(got, plain):
            assert rel_err(g.numpy(), w.numpy()) < TOL


def test_tile_rule():
    """Every form the rule returns is instantiated by the kernel. Where the
    (1, 1) tile's grid fills the card or F is 1, one image keeps TB = 1
    (the one-row tile the kernel ran before tiles) and every batch takes 8
    images × 4 filters; with F ≥ 2, where that grid is below the card's
    SMs and below 10·F − 5 CTAs, the split form."""
    for b in range(1, 70):
        for n, f, s in ((1, 1, 64), (100, 3, 2160 * 1081), (64, 31, 540 * 271)):
            tb, tn = tmac.mac_tile(b, n, f, s, SMS)
            assert (tb, tn) in tmac.MAC_TILES
            assert (tb, tn) == ((1, 1) if b == 1 else (8, 4))
    for b, n, f, s in ((1, 1, 31, 2112), (1, 7, 3, 2345), (3, 13, 5, 1000), (1, 1, 2, 9 * 1024),
                       (1, 1, 4, 33600), (1, 1, 31, 100160), (1, 1, 31, 131 * 1024)):
        assert tmac.mac_tile(b, n, f, s, SMS) == tmac.MAC_SPLIT
    # 132 CTAs of the (1, 1) tile fill the card: the register tiles stay
    assert tmac.mac_tile(1, 1, 31, 132 * 1024, SMS) == (1, 1)
    assert tmac.mac_tile(2, 66, 2, 1024, SMS) == (8, 4)
    # a grid long beside the channels (g ≥ 10·F − 5): the register tiles
    # stay (S ≈ 100k at F ≤ 8 and S ≈ 33k at F = 2 measured slower split)
    for f, s in ((2, 15 * 1024), (2, 33600), (4, 100160), (8, 100160), (2, 131 * 1024)):
        assert tmac.mac_tile(1, 1, f, s, SMS) == (1, 1)
    assert tmac.mac_tile(8, 5, 3, 220, SMS) == (8, 4)


# The MAC shapes ``chip_smoke.py`` runs, (B, N, F, S) → the form the rule
# picks on the H100: MOSSE's respond at HOG cells takes the split form;
# MOSSE on pixels (F = 1), the direct engine's F = 1 and F = 3 calls, the
# pyramid's level 0, the trainer's three MACs (forward, dK, dD), the
# unfused headline and the sharded MACs keep their register tiles; the
# tile checks' shapes whose grids are short take the split form; across
# the split range (B = N = 1) the rule's 10·F − 5 decides.
SMOKE_RULE = {
    (1, 1, 31, 64 * 33): tmac.MAC_SPLIT,  # MOSSE respond, HOG
    (1, 1, 1, 64 * 33): (1, 1),  # MOSSE respond, pixels
    (1, 100, 1, 2160 * 1081): (1, 1),  # direct engine, F = 1
    (1, 100, 3, 2160 * 1081): (1, 1),  # direct engine, F = 3
    (1, 1024, 31, 540 * 271): (1, 1),  # pyramid level 0
    (8, 64, 31, 540 * 271): (8, 4),  # trainer forward (and sharded)
    (64, 31, 8, 540 * 271): (8, 4),  # trainer dK (and sharded)
    (8, 31, 64, 540 * 271): (8, 4),  # trainer dD
    (192, 100, 1, 127 * 224): (8, 4),  # unfused headline
    (3, 13, 5, 40 * 25): tmac.MAC_SPLIT,  # tile checks
    (8, 5, 3, 20 * 11): (8, 4),
    (1, 7, 3, 67 * 35): tmac.MAC_SPLIT,
    (5, 3, 2, 20 * 11): (8, 4),
    (2, 3, 5, 20 * 11): tmac.MAC_SPLIT,
    (1, 1, 2, 64 * 33): tmac.MAC_SPLIT,  # the split range
    (1, 1, 4, 64 * 33): tmac.MAC_SPLIT,
    (1, 1, 8, 64 * 33): tmac.MAC_SPLIT,
    (1, 1, 2, 160 * 210): (1, 1),
    (1, 1, 4, 160 * 210): tmac.MAC_SPLIT,
    (1, 1, 8, 160 * 210): tmac.MAC_SPLIT,
    (1, 1, 31, 160 * 210): tmac.MAC_SPLIT,
    (1, 1, 2, 320 * 313): (1, 1),
    (1, 1, 4, 320 * 313): (1, 1),
    (1, 1, 8, 320 * 313): (1, 1),
    (1, 1, 31, 320 * 313): tmac.MAC_SPLIT,
}


@pytest.mark.parametrize("shape", list(SMOKE_RULE), ids=lambda s: "B{}N{}F{}S{}".format(*s))
def test_tile_rule_at_the_smokes_shapes(shape):
    assert tmac.mac_tile(*shape, SMS) == SMOKE_RULE[shape]

