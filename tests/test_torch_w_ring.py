"""The 64-row W stage's ring (csrc/block_conv.cuh): M^T laid out chunk by
chunk for the TMA, and the shared-memory mirror, on the CPU.

- ``_kernel_mats``' M^T (and the DIF bodies' operand) for the 64-row
  configurations is one contiguous run a W-stage chunk: read back into the
  core-matrix planes (``m_core``) it is, bitwise, the layout the 32-row
  configuration and the parent kernel read, and each chunk is, bitwise,
  the P × 16 runs the parent's cp.async ring gathered for that step.
- The mirror: the ring keeps 2 chunks and its barriers sit in X's row
  padding, so the shared memory and every configuration are unchanged.
"""

import numpy as np
import pytest
import torch

from cuda_fft_convolution_torch.ops import block_conv as tbc

TIERS = list(tbc.TIERS)
PLANS = [(127, 447, 64, 64), (27, 139, 12, 12), (45, 151, 10, 24), (80, 601, 17, 50),
         (63, 287, 32, 32)]


def _old_layout(m_t, pieces, splits):
    """The parent's M^T planes, [plane][c // 8][k // 4][c % 8][k % 4],
    written out from the plain matrix."""
    cols, k = m_t.shape
    planes = [m_t] if pieces < tbc.TIERS[splits] else tbc.tf32_split(m_t, pieces)
    out = torch.zeros((pieces, cols // 8, k // 4, 8, 4))
    for p, plane in enumerate(planes):
        for c in range(0, cols, 8):
            for kk in range(0, k, 4):
                out[p, c // 8, kk // 4] = plane[c:c + 8, kk:kk + 4]
    return out


@pytest.mark.parametrize("splits", TIERS)
@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "{}x{}_{}x{}".format(*p))
def test_chunks_read_back_into_core_matrices_bitwise(plan, splits):
    bh, bw, kh, kw = plan
    _, _, mr, mi = tbc._window_mats(bh, bw, kh, kw, "cpu")
    if splits == tbc.BF16IO:
        mr, mi = tbc.bf16_round(mr), tbc.bf16_round(mi)
    (wc, vw), rows = mr.shape, 64
    bins, cols = -(-wc // 32) * 32, -(-vw // 128) * 128
    m_t = torch.zeros((cols, 2 * bins))
    m_t[:vw, :wc], m_t[:vw, bins:bins + wc] = mr.t(), mi.t()
    m_tc = tbc._kernel_mats(bh, bw, kh, kw, "cpu", splits, rows)[3]
    pieces = tbc.m_planes(rows, splits)
    assert m_tc.shape == (cols // 128, 2 * bins // 32, pieces, 16, 8, 8, 4)
    assert m_tc.is_contiguous()
    old = _old_layout(m_t, pieces, splits)
    assert torch.equal(tbc.m_core(m_tc), old)
    # step j = (pass p, chunk kc): the parent's ring gathered, for each plane
    # and 8-column group, the 8 k-cores of kc; here they are one run
    flat = m_tc.reshape(-1, pieces * 16 * 8 * 32)
    nkc = 2 * bins // 32
    for j in range(flat.shape[0]):
        p, kc = divmod(j, nkc)
        gathered = old[:, p * 16:(p + 1) * 16, kc * 8:(kc + 1) * 8].reshape(-1)
        assert torch.equal(flat[j], gathered)


def test_dif_operand_is_chunked_too():
    """The DIF bodies' W-stage operand ([epr; epi; oqr; oqi]^T) for 64 rows
    is laid out chunk by chunk as M^T is, and reads back to the 32-row
    layout bitwise."""
    for splits in (3, 1):
        m64 = tbc._radix_kernel_mats(256, 512, 65, 129, "cpu", splits, "v5", 64)[2]
        m32 = tbc._radix_kernel_mats(256, 512, 65, 129, "cpu", splits, "v5", 32)[2]
        assert m64.ndim == 7 and m32.ndim == 5
        assert torch.equal(tbc.m_core(m64), m32)


def _x_floats(wc, rows):
    return rows * (2 * (-(-wc // 32) * 32) + 4)


@pytest.mark.parametrize("splits", TIERS)
def test_ring_keeps_the_shared_memory_and_every_configuration(splits):
    """The TMA ring keeps the cp.async ring's 2 chunks and puts its 4
    mbarriers (a full and an empty one a slot, 8 B each) in X's row
    padding (16 B a row, rows 0 and 1): the shared memory of every
    configuration is X and the larger of the two stages' staging, as
    before — 181,248 B at the 3×TF32 headline, 214,016 at 6×TF32, 148,480
    at one pass and BF16IO — so no plan changes configuration."""
    want = {3: 181248, 6: 214016, 1: 148480, tbc.BF16IO: 148480}[splits]
    assert tbc.smem_bytes(224, 64, splits) == want
    chunk = tbc.m_planes(64, splits) * 128 * 32
    for wc in (17, 70, 129, 224, 256, 301, 320):
        x = _x_floats(wc, 64)
        if tbc.tile_rows(wc, 64, splits) == 64 and tbc.cluster_size(wc, 64, splits) == 1:
            stage_h = 2 * tbc.TIERS[splits] * 128 * 16 + 3 * tbc.TIERS[splits] * 64 * 16
            assert tbc.smem_bytes(wc, 64, splits) == 4 * (x + max(stage_h, 2 * chunk))
        # each of the 64 rows has 4 floats of padding past [Xr | Xi]: room
        # for a slot's two 8-byte barriers in each of rows 0 and 1
        assert x - 64 * 2 * (-(-wc // 32) * 32) == 64 * 4


def test_cpu_wrappers_count_no_cluster_launch():
    """On CPU tensors the wrappers run their plain versions and count no
    launch (the W stage runs in no thread-block cluster: none to count)."""
    rng = np.random.default_rng(5)
    geom = (27, 139, 12, 12, 40, 200)
    vh, vw = 16, 128
    nbh, nbw = -(-40 // vh), -(-200 // vw)
    ops = [torch.as_tensor(rng.standard_normal(s).astype(np.float32))
           for s in ((1, nbh, nbw, 2, 27, 70),) * 2 + ((3, 2, 27, 70),) * 2]
    tbc.reset_launches(tbc.block_conv, tbc.block_conv_peaks)
    tbc.block_conv(*ops, *geom)
    tbc.block_conv_peaks(*ops, *geom)
    assert tbc.block_conv.launches == tbc.block_conv_peaks.launches == 0
