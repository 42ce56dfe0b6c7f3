"""The v2 body's configurations (``wstack=False``) and its plain version
against the JAX package's v2 kernel.

The v2 body takes MBH blocks of one block column and runs one H product
over their bins side by side (JAX's ``_make_kernel``,
``cuda_fft_convolution_tpu/ops/block_conv.py:269-308``). Each output
element's products are v3's, so on the card its entries launch v3's
configuration of the same form (``csrc/block_conv.cu``, "JAX's v2 body"):
one block a CTA at 64 rows, in the pair or at 32 rows, and v3's stacked
configuration where v3 stacks blocks (windows of at most 32 rows; MBH
v3's blocks a CTA). Here: the Python mirror of that rule at every tier
and form, and the plain version (which groups MBH blocks of a column, as
JAX does) against JAX's v2 kernel run in interpret mode with the same
flags, at one plan of each case — one block a CTA at 64 rows, the pair's
width at 6×TF32, short windows with a partial last group — within ``TOL``
at float32 and the BF16IO bars of ``tests/test_torch_karatsuba.py``. The CUDA entries are
held to the plain version on the card by ``tests/test_torch_gpu.py``
(``test_v2_configurations_match_plain_on_gpu``) and ``chip_smoke.py``
step 37."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_fft_convolution_torch as tfc
from cuda_fft_convolution_torch.ops import block_conv as tbc
from cuda_fft_convolution_tpu.ops.block_conv import block_conv_pallas
from tests.test_torch_bf16 import _bf16, _f32, _jbf16
from tests.test_torch_karatsuba import IO_MAX_BAR, TOL, V2_IO_RMS_BAR, _case, _rel, _rms, _torch

# (Wc, Vh) over the configurations: the DPM plan's blocks (Vh 16), Vh 1, 21
# and 32 (stacks of 4, 4, 3 and 2 blocks), narrow blocks (Wc 17 and 40), a
# stack too wide for the MAC's
# registers at BF16IO (Wc 200), the headline's (Vh 64), JAX's F=1 plan's
# (Wc 257: a pair at 6xTF32), the 1024 block's (Wc 513: a pair, and 32 rows
# in the Karatsuba form at 6xTF32, which does not fit), Wc 545 (v3's 32
# rows at 6xTF32).
WIDTHS = [(70, 16), (76, 1), (76, 21), (144, 32), (200, 16), (224, 64), (257, 192), (513, 512),
          (545, 64), (301, 60), (97, 33), (17, 16), (40, 8)]

# One plan of each case (b, f, n, bh, bw, kh, kw, out_h, out_w): one block a
# CTA at 64 rows (Vh 64, Wc 101); the pair's width (JAX's F=1 plan, Wc 257,
# N and F small; a pair at 6xTF32); short windows with a partial last group
# (the DPM plan's blocks over 13 block rows: MBH 4, groups of 4, 4, 4 and
# 1); narrow short windows (Vh 16, Wc 17 over 19 block rows: MBH 4, a last
# group of 3).
CASES = {
    "one block, 64 rows": (1, 2, 2, 80, 201, 17, 50, 128, 300),
    "the pair's width": (1, 1, 2, 256, 512, 65, 129, 200, 400),
    "short windows, a partial group": (1, 2, 2, 27, 139, 12, 12, 208, 150),
    "narrow blocks": (1, 2, 2, 27, 32, 12, 12, 300, 60),
}
SETTINGS = {
    "bf16x3": dict(fused_precision="bf16x3"),
    "highest": dict(fused_precision="highest", matmul_precision="highest"),
}


@pytest.fixture
def setting(request):
    before = tfc.get_config()
    tfc.set_config(**SETTINGS[request.param])
    yield request.param
    tfc.set_config(fused_precision=before.fused_precision,
                   matmul_precision=before.matmul_precision)


@pytest.mark.parametrize("splits", list(tbc.TIERS))
@pytest.mark.parametrize("karatsuba", [False, True])
def test_one_block_is_v3s_configuration(splits, karatsuba):
    """At every width, one block a CTA or stacked, v2 runs v3's
    configuration of the same form: its (rows, pair bins), rows, blocks a
    CTA and shared memory, and whether the kernels take it."""
    stacked = 0
    for wc, vh in WIDTHS:
        g = tbc.blocks_per_cta(wc, vh, splits)
        stacked += g > 1
        assert tbc.v2_blocks(wc, vh, splits, karatsuba) == g
        assert tbc.kernel_layout("v2", wc, vh, splits, karatsuba) == tbc.kernel_layout(
            "v3", wc, vh, splits, karatsuba)
        assert tbc.v2_rows(wc, vh, splits, karatsuba) == tbc.tile_rows(wc, vh, splits, karatsuba)
        assert tbc.v2_smem_bytes(wc, vh, splits, karatsuba) == tbc.smem_bytes(
            wc, vh, splits, karatsuba)
        assert tbc.form_taken(wc, vh, splits, False, karatsuba) == tbc.form_taken(
            wc, vh, splits, True, karatsuba)
    assert stacked >= 5


def test_the_pair_at_6xtf32():
    """JAX's F=1 plan (Wc 257, Vh 192): v2 pairs where v3 does — at 6×TF32
    in both forms, 128 bins on rank 0 — and runs 64 rows elsewhere; the
    1024 block pairs at every tier but the Karatsuba form's 6×TF32, which
    neither body takes."""
    for kara in (False, True):
        assert tbc.kernel_layout("v2", 257, 192, 6, kara) == (64, 128)
        assert tbc.v2_smem_bytes(257, 192, 6, kara) == tbc.smem_bytes(257, 192, 6, kara)
        for splits in (3, 1, tbc.BF16IO):
            assert tbc.kernel_layout("v2", 257, 192, splits, kara) == (64, 0)
        for splits in tbc.TIERS:
            taken = not (kara and splits == 6)
            assert tbc.kernel_layout("v2", 513, 512, splits, kara)[1] == (256 if taken else 0)
            assert tbc.form_taken(513, 512, splits, False, kara) == taken


def test_the_plans_mbh():
    """MBH at the plans the smoke times: one block at the headline (Wc 224,
    Vh 64), JAX's F=1 plan and the 512² plan at every tier; v3's stacks at
    the DPM plan (Wc 70, Vh 16: 4 blocks, 2 kernels) and at the F=8 plan
    (Wc 144, Vh 32: 2 blocks, 1 kernel)."""
    for splits in tbc.TIERS:
        for wc, vh in ((224, 64), (257, 192), (513, 512)):
            assert tbc.v2_blocks(wc, vh, splits) == 1
        assert (tbc.v2_blocks(70, 16, splits), tbc.kernels_per_cta(70, 16, splits)) == (4, 2)
        assert (tbc.v2_blocks(144, 32, splits), tbc.kernels_per_cta(144, 32, splits)) == (2, 1)


@pytest.mark.parametrize("setting", list(SETTINGS), indirect=True)
@pytest.mark.parametrize("karatsuba", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_v2_matches_jax_v2(rng, setting, case, karatsuba):
    """The plain version of v2 (``wstack=False``) at the setting's fp32 tier
    (3×TF32, or 6×TF32 under 'highest'; IEEE fp32 either way, grouped by
    that tier's MBH) against JAX's v2 kernel in interpret mode with the same
    form, within TOL."""
    ops, geom = _case(rng, *CASES[case])
    want = np.asarray(block_conv_pallas(*map(jnp.asarray, ops), *geom, interpret=True,
                                        wstack=False, karatsuba=karatsuba))
    got = tbc.block_conv(*_torch(ops), *geom, wstack=False, karatsuba=karatsuba)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("karatsuba", [False, True])
@pytest.mark.parametrize("case", ["one block, 64 rows", "short windows, a partial group",
                                  "narrow blocks"])
def test_plain_v2_matches_jax_v2_at_bf16io(case, karatsuba):
    """At BF16IO (bf16 planes) against JAX's v2 with the same form, seeds 0
    and 1: within IO_MAX_BAR at most and V2_IO_RMS_BAR in root mean square;
    the bf16 maps are the float32 maps rounded once."""
    for seed in (0, 1):
        ops, geom = _case(np.random.default_rng(seed), *CASES[case])
        want = _f32(block_conv_pallas(*map(_jbf16, ops), *geom, interpret=True, wstack=False,
                                      karatsuba=karatsuba))
        t16 = [_bf16(x) for x in ops]
        got = tbc.block_conv(*t16, *geom, wstack=False, karatsuba=karatsuba)
        assert _rms(got.numpy(), want) <= V2_IO_RMS_BAR, seed
        assert _rel(got.numpy(), want) <= IO_MAX_BAR, seed
        got16 = tbc.block_conv(*t16, *geom, torch.bfloat16, wstack=False, karatsuba=karatsuba)
        assert torch.equal(got16, got.to(torch.bfloat16))


@pytest.mark.parametrize("splits", [3, 6, 1])
@pytest.mark.parametrize("case", ["short windows, a partial group", "narrow blocks"])
def test_partial_group_is_each_block_v3s(rng, case, splits):
    """The short-window cases' block rows in groups of MBH (a partial last
    group at every tier): each block's maps are v3's within TOL (the
    grouped product's columns are v3's sums), at each fp32 tier's MBH."""
    ops, geom = _case(rng, *CASES[case])
    nbh, wc, vh = ops[0].shape[1], ops[0].shape[-1], geom[0] - geom[2] + 1
    mbh = tbc.v2_blocks(wc, vh, splits)
    assert nbh in (13, 19) and nbh % mbh and mbh == 4
    t = _torch(ops)
    for kara in (False, True):
        got = tbc.block_conv_reference(*t, *geom, splits=splits, wstack=False, karatsuba=kara)
        v3 = tbc.block_conv_reference(*t, *geom, splits=splits, karatsuba=kara)
        assert _rel(got.numpy(), v3.numpy()) <= TOL
