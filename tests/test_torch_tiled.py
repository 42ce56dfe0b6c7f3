"""The port's overlap-save engine (ops/tiled.py) against the JAX package's:
block planning, block spectra, the unfused pipeline, fused-vs-unfused
dispatch and the fused block-conv's gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_fft_convolution_torch as tfc
from cuda_fft_convolution_torch.ops import tiled as tt
from cuda_fft_convolution_tpu.ops import tiled as jt
from cuda_fft_convolution_tpu.ops.conv import rfft2_padded_planes as jrfft2
from cuda_fft_convolution_tpu.runtime.autotune import lookup_tuned_geometry
from tests.oracles import rel_err

TOL = 1e-5

# (data_h, data_w, kh, kw) shapes for the planner comparisons
PLAN_SHAPES = [
    (300, 500, 17, 33), (2048, 2048, 9, 9), (1000, 1500, 5, 5),
    (2048, 2048, 33, 65), (2048, 2048, 65, 129), (700, 900, 3, 100),
    (2048, 2048, 128, 128), (300, 500, 128, 128), (100, 90, 16, 16),
    (64, 64, 8, 8), (2048, 2048, 512, 512), (2048, 2048, 64, 64),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_choose_block_plan_fft_branch_matches_jax(shape):
    assert tt.choose_block_plan(*shape, matmul_engine=False) == (
        jt.choose_block_plan(*shape, matmul_engine=False)
    )


@pytest.mark.parametrize(
    "shape", [s for s in PLAN_SHAPES if s[2:] not in ((64, 64), (512, 512))]
)
def test_choose_block_plan_dense_branch_matches_jax(shape):
    """JAX's dense-DFT branch consults its v5e geometry table first; compare
    only where the table has no entry, so both run the analytic rule."""
    assert lookup_tuned_geometry(shape[2], shape[3], 1, "float32") is None
    assert tt.choose_block_plan(*shape, matmul_engine=True) == (
        jt.choose_block_plan(*shape, matmul_engine=True)
    )


def test_choose_block_plan_headline_and_default_branch():
    # 2048² × 64²: Vh = ⌈63/8⌉·8 = 64, Vw = ⌈6·63/128⌉·128 = 384,
    # blocks (64+63, 384+63) = (127, 447); 32 × 6 block grid at 'same'.
    assert tt.choose_block_plan(2048, 2048, 64, 64) == (127, 447, 64, 64)
    assert tt.choose_block_fft(300, 500, 17, 33) == (32, 288)
    assert tt.choose_block_plan(2048, 2048, 512, 512, matmul_engine=False) is None


@pytest.mark.parametrize("k", [(3, 3), (17, 33), (64, 64)])
def test_fallback_block_fft_matches_jax(k):
    assert tt.fallback_block_fft(*k) == jt.fallback_block_fft(*k)


@pytest.mark.parametrize(
    "bh,bw,kh,kw,origin,win",
    [
        (32, 288, 17, 33, (0, 0), (None, None)),  # 'full' extent
        (45, 151, 10, 24, (4, 11), (100, 130)),  # baked 'same'
        (20, 36, 5, 7, (4, 6), (96, 124)),  # baked 'valid'
        (40, 64, 5, 7, (0, 0), (120, 150)),  # fftmap canvas
    ],
)
def test_fft_data_blocks_matches_jax(rng, bh, bw, kh, kw, origin, win):
    x = rng.standard_normal((2, 3, 100, 130)).astype(np.float32)
    got = tt.fft_data_blocks(torch.as_tensor(x), bh, bw, kh, kw, *origin, *win)
    want = jt.fft_data_blocks(jnp.asarray(x), bh, bw, kh, kw, *origin, *win)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.is_contiguous()
        assert rel_err(g.numpy(), w) < TOL


def _spectra(rng, b=2, f=3, n=4, bh=20, bw=36, kh=5, kw=7, h=60, w=80):
    """JAX block spectra of random data ('full' extent) + JAX bank spectra,
    as numpy planes, with the geometry of a conv_blocks call."""
    x = rng.standard_normal((b, f, h, w)).astype(np.float32)
    k = rng.standard_normal((n, f, kh, kw)).astype(np.float32)
    d = jt.fft_data_blocks(jnp.asarray(x), bh, bw, kh, kw)
    kk = jrfft2(jnp.asarray(k), bh, bw)
    planes = [np.array(p) for p in (*d, *kk)]
    return planes, (bh, bw, kh, kw, h + kh - 1, w + kw - 1)


def test_conv_blocks_unfused_matches_jax(rng):
    planes, geom = _spectra(rng)
    got = tt._conv_blocks_unfused(*map(torch.as_tensor, planes), *geom)
    want = jt._conv_blocks_unfused(*map(jnp.asarray, planes), *geom)
    assert tuple(got.shape) == want.shape == (2, 4, 64, 86)
    assert rel_err(got.numpy(), want) < TOL


@pytest.mark.parametrize("fused", [None, True, False])
def test_conv_blocks_both_branches_match_jax(rng, fused):
    planes, geom = _spectra(rng, b=1, f=2, n=3)
    want = jt.conv_blocks(*map(jnp.asarray, planes), *geom)
    tfc.set_config(use_fused_block_conv=fused)
    try:
        got = tt.conv_blocks(*map(torch.as_tensor, planes), *geom)
    finally:
        tfc.set_config(use_fused_block_conv=None)
    assert rel_err(got.numpy(), want) < TOL


def test_fused_dispatch_auto_is_the_kernel_legality_rule():
    # fp32 at the headline blocks and at JAX's widest block (1024), and the
    # bf16 tier's spectra, as JAX admits both; not other dtypes, nor blocks
    # too wide for the kernel's shared memory.
    assert tt.fused_dispatch_auto(447)
    assert tt.fused_dispatch_auto(1024)
    assert tt.fused_dispatch_auto(447, torch.bfloat16)
    assert not tt.fused_dispatch_auto(447, torch.float16)
    assert not tt.fused_dispatch_auto(2047)


def test_fused_block_conv_grad_matches_jax(rng):
    """The fused forward's backward is the unfused pipeline's autograd: its
    gradients match ``jax.grad`` through JAX ``_conv_blocks_unfused``."""
    planes, geom = _spectra(rng, b=1, f=2, n=3)
    out_shape = (1, 3, geom[4], geom[5])
    wgt = rng.standard_normal(out_shape).astype(np.float32)

    def jloss(*p):
        return jnp.sum(jt._conv_blocks_unfused(*p, *geom) * wgt)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, planes))
    leaves = [torch.tensor(p, requires_grad=True) for p in planes]
    (tt.fused_block_conv(*leaves, *geom) * torch.as_tensor(wgt)).sum().backward()
    for leaf, w in zip(leaves, want):
        assert rel_err(leaf.grad.numpy(), w) < TOL
    # the same gradients as autograd through the unfused pipeline directly
    ref = [torch.tensor(p, requires_grad=True) for p in planes]
    (tt._conv_blocks_unfused(*ref, *geom) * torch.as_tensor(wgt)).sum().backward()
    for leaf, r in zip(leaves, ref):
        assert torch.allclose(leaf.grad, r.grad, rtol=0, atol=1e-6 * float(r.grad.abs().max()))


def test_fused_block_conv_second_derivative_matches_jax(rng):
    """Under ``create_graph`` the fused backward keeps its graph: the
    derivative by the bank's real plane of <d loss/d data's real plane,
    tan> matches JAX's second derivative through ``_conv_blocks_unfused``."""
    planes, geom = _spectra(rng, b=1, f=2, n=3)
    wgt = rng.standard_normal((1, 3, geom[4], geom[5])).astype(np.float32)
    tan = rng.standard_normal(planes[0].shape).astype(np.float32)

    def jloss(*p):
        return jnp.sum(jt._conv_blocks_unfused(*p, *geom) * wgt)

    want = jax.grad(
        lambda *p: jnp.sum(jax.grad(jloss)(*p) * tan), argnums=2,
    )(*map(jnp.asarray, planes))
    leaves = [torch.tensor(p, requires_grad=True) for p in planes]
    loss = (tt.fused_block_conv(*leaves, *geom) * torch.as_tensor(wgt)).sum()
    (g_dr,) = torch.autograd.grad(loss, [leaves[0]], create_graph=True)
    (got,) = torch.autograd.grad((g_dr * torch.as_tensor(tan)).sum(), [leaves[2]])
    assert rel_err(got.numpy(), np.asarray(want)) < TOL


def test_fused_block_conv_grad_of_kernels_only(rng):
    """Gradients flow to whichever planes require them (a trained bank
    against fixed data spectra)."""
    planes, geom = _spectra(rng, b=1, f=1, n=2)
    d = [torch.as_tensor(p) for p in planes[:2]]
    k = [torch.tensor(p, requires_grad=True) for p in planes[2:]]
    tt.fused_block_conv(*d, *k, *geom).square().sum().backward()
    assert all(x.grad is not None and x.grad.abs().max() > 0 for x in k)
