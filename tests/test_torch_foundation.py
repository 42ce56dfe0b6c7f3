"""The port's foundation modules against their JAX twins: FFT-size policies,
errors, zero padding, the windowed inverse-DFT matrices, the torch.fft
transforms and the spectral MAC; plus the package's import contract (no
jax, no nvcc, no CUDA needed)."""

import ctypes
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_fft_convolution_torch as tfc
from cuda_fft_convolution_torch.ops import conv as tconv
from cuda_fft_convolution_torch.ops import dft as tdft
from cuda_fft_convolution_torch.ops import spectral_mac as tmac
from cuda_fft_convolution_torch.ops.padding import pad_to_fft
from cuda_fft_convolution_torch.utils import fft_size as tsize
from cuda_fft_convolution_tpu.ops import conv as jconv
from cuda_fft_convolution_tpu.ops import dft as jdft
from cuda_fft_convolution_tpu.ops import spectral_mac as jmac
from cuda_fft_convolution_tpu.utils import fft_size as jsize
from tests.oracles import rel_err

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("policy", ["multiple16", "pow2", "fast", "tpu"])
def test_compute_fft_size_matches_jax(policy):
    for h in (1, 7, 64, 100, 513, 2048):
        for k in (1, 4, 17, 64, 512):
            assert tsize.compute_fft_size(h, h + 3, k, k + 1, policy) == (
                jsize.compute_fft_size(h, h + 3, k, k + 1, policy)
            )


def test_size_helpers_match_jax():
    for n in range(1, 1200):
        assert tsize.next_fast_len(n) == jsize.next_fast_len(n)
        assert tsize.next_multiple_of_16(n) == jsize.next_multiple_of_16(n)
        assert tsize.next_pow2(n) == jsize.next_pow2(n)
        assert tsize.next_fast_len_aligned(n, 128) == jsize.next_fast_len_aligned(n, 128)
    assert [p.value for p in tsize.FftSizePolicy] == [
        p.value for p in jsize.FftSizePolicy
    ]


def test_invalid_input_error_is_value_error():
    with pytest.raises(ValueError):
        tfc.fft_conv(np.zeros((8, 8, 1), np.float32), kernels=None, device="cpu")
    with pytest.raises(tfc.InvalidInputError, match="mode must be"):
        tfc.fft_conv(np.zeros((8, 8, 1), np.float32),
                     kernels=np.zeros((1, 3, 3, 1), np.float32), mode="bogus", device="cpu")


def test_pad_to_fft_matches_jax(rng):
    x = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        pad_to_fft(_t(x), 9, 12).numpy(),
        np.asarray(jnp.pad(x, ((0, 0), (0, 0), (0, 4), (0, 5)))),
    )
    assert pad_to_fft(_t(x), 5, 7).shape == (2, 3, 5, 7)
    with pytest.raises(ValueError):
        pad_to_fft(_t(x), 4, 7)


@pytest.mark.parametrize("l", [8, 31, 64, 127, 447, 512])
def test_inverse_dft_mats_equal_jax(l):
    for port, ref in ((tdft._inv_full_mats, jdft._inv_full_mats),
                      (tdft._inv_packed_mats, jdft._inv_packed_mats)):
        for a, b in zip(port(l), ref(l)):
            assert a.dtype == np.float32
            assert np.array_equal(a, b)


@pytest.mark.parametrize("fft_h,fft_w", [(16, 32), (45, 151), (32, 47)])
def test_rfft2_irfft2_planes_match_jax(rng, fft_h, fft_w):
    x = rng.standard_normal((2, 3, 13, 29)).astype(np.float32)
    tr, ti = tconv.rfft2_padded_planes(_t(x), fft_h, fft_w)
    jr, ji = jconv.rfft2_padded_planes(jnp.asarray(x), fft_h, fft_w)
    scale = float(np.abs(np.asarray(jr)).max())
    assert tr.dtype == torch.float32 and tr.shape == jr.shape
    assert np.abs(tr.numpy() - np.asarray(jr)).max() / scale < TOL
    assert np.abs(ti.numpy() - np.asarray(ji)).max() / scale < TOL
    back = tconv.irfft2_norm_planes(tr, ti, fft_h, fft_w)
    want = jconv.irfft2_norm_planes(jr, ji, fft_h, fft_w)
    assert back.shape == (2, 3, fft_h, fft_w)  # odd widths need s=
    assert rel_err(back.numpy(), want) < TOL
    assert rel_err(back[..., :13, :29].numpy(), x) < TOL


def test_spectral_mac_matches_jax(rng):
    def planes(*shape):
        return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]

    dr, di = planes(2, 3, 9, 11)
    kr, ki = planes(5, 3, 9, 11)
    got = tmac.spectral_mac_auto_planes(_t(dr), _t(di), _t(kr), _t(ki))
    want = jmac.spectral_mac_auto_planes(*map(jnp.asarray, (dr, di, kr, ki)))
    for g, w in zip(got, want):
        assert g.shape == (2, 5, 9, 11)
        assert rel_err(g.numpy(), w) < TOL
    # ops/conv.py's single-image form: data (F, H, Wc), any bank axes
    got1 = tconv.spectral_mac_planes(_t(dr[0]), _t(di[0]), _t(kr), _t(ki))
    want1 = jconv.spectral_mac_planes(*map(jnp.asarray, (dr[0], di[0], kr, ki)))
    for g, w in zip(got1, want1):
        assert rel_err(g.numpy(), w) < TOL


def test_spectral_mac_pallas_not_ported(rng):
    """``use_pallas=True`` selects the JAX package's Pallas MAC, whose
    Hopper port ``ops/spectral_mac.py spectral_mac`` the port always runs;
    on CPU tensors it runs the plain version and matches the JAX package's
    Pallas MAC (interpret mode)."""
    planes = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, 3, 9, 11),) * 2 + ((5, 3, 9, 11),) * 2]
    before = tmac.spectral_mac.launches
    got = tmac.spectral_mac_auto_planes(*map(_t, planes), use_pallas=True)
    want = jmac.spectral_mac_auto_planes(*map(jnp.asarray, planes), use_pallas=True)
    assert tmac.spectral_mac.launches == before  # no kernel on the CPU
    for g, w in zip(got, want):
        assert g.shape == (2, 5, 9, 11)
        assert rel_err(g.numpy(), w) < TOL


def test_config_forces_engine(monkeypatch):
    from cuda_fft_convolution_torch.utils import config

    assert config.get_config().use_fused_block_conv is None
    try:
        assert tfc.set_config(use_fused_block_conv=False).use_fused_block_conv is False
        assert tfc.get_config().use_fused_block_conv is False
    finally:
        tfc.set_config(use_fused_block_conv=None)
    monkeypatch.setenv("FFTCONV_FUSED_BLOCK_CONV", "1")
    assert config.Config.from_env().use_fused_block_conv is True
    monkeypatch.setenv("FFTCONV_FUSED_BLOCK_CONV", "")
    assert config.Config.from_env().use_fused_block_conv is None


def test_port_imports_with_jax_blocked():
    """The port imports torch and never jax: import it (and run a small
    call) in a fresh interpreter where ``import jax`` fails."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "import cuda_fft_convolution_torch as fc\n"
        "import cuda_fft_convolution_torch._build\n"
        "from cuda_fft_convolution_torch.models import detect_peaks\n"
        "from cuda_fft_convolution_torch.ops.padding import (\n"
        "    pad_clamp_to_border, pad_kernel_centered)\n"
        "from cuda_fft_convolution_torch.runtime.planner import plan_bank\n"
        "from cuda_fft_convolution_torch.runtime import autotune, plan, stream\n"
        "assert autotune.lookup_tuned_geometry(64, 64, 1, device='cpu') is None\n"
        "with fc.ConvStream.create((40, 40, 1), np.ones((2, 5, 5, 1), np.float32),\n"
        "                          mode='same', algorithm='tiled', device='cpu') as s:\n"
        "    assert tuple(s.submit(np.ones((40, 40, 1), np.float32)).result().shape)\\\n"
        "        == (2, 40, 40)\n"
        "assert plan_bank(100, 1, 2160, 2160, 8).chunk_size >= 1\n"
        "clamp = fc.fft_conv(np.ones((40, 40, 1), np.float32),\n"
        "                    kernels=np.ones((2, 5, 5, 1), np.float32), mode='same',\n"
        "                    padding='clamp', kernel_layout='centered', device='cpu')\n"
        "assert abs(float(clamp.min()) - 25.0) < 1e-3\n"
        "sd = fc.fft_data(np.ones((40, 40, 1), np.float32), 5, 5, device='cpu')\n"
        "assert tuple(fc.conv_spectral_pipelined(sd, np.ones((3, 5, 5, 1), np.float32),\n"
        "    chunk_size=2, mode='same').shape) == (3, 40, 40)\n"
        "out = fc.fft_conv(np.ones((40, 40, 1), np.float32),\n"
        "                  kernels=np.ones((2, 5, 5, 1), np.float32), mode='same',\n"
        "                  device='cpu')\n"
        "assert tuple(out.shape) == (2, 40, 40)\n"
        "vals, pos = detect_peaks(np.ones((40, 40, 1), np.float32),\n"
        "                         np.ones((2, 5, 5, 1), np.float32), device='cpu')\n"
        "assert tuple(pos.shape) == (2, 2)\n"
        "from cuda_fft_convolution_torch import models\n"
        "pyr = models.build_pyramid(np.ones((40, 40, 1), np.float32), 5, 5,\n"
        "                           num_levels=2, device='cpu')\n"
        "assert models.detect_pyramid_peaks(pyr, np.ones((2, 5, 5, 1), np.float32))\\\n"
        "    .values.shape == (2, 2)\n"
        "import torch\n"
        "det = models.init_detector(torch.Generator(), 2, 1, 3, 3, device='cpu')\n"
        "opt = torch.optim.SGD(det.parameters(), lr=0.1)\n"
        "models.train_step(det, opt, np.ones((1, 1, 9, 9), np.float32),\n"
        "                  np.zeros((1, 2, 9, 9), np.float32))\n"
        "import cuda_fft_convolution_torch.utils.selftest\n"
        "import cuda_fft_convolution_torch.utils.profiling\n"
        "import cuda_fft_convolution_torch.utils.image_io\n"
        "import cuda_fft_convolution_torch.demos.demo\n"
        "maps = fc.fft_conv_stack(np.ones((1, 12, 12), np.float32),\n"
        "                         np.ones((2, 1, 3, 3), np.float32), device='cpu')\n"
        "assert tuple(maps.shape) == (2, 15, 15)\n"
        "assert fc.selftest(device='cpu')['fft_ok']\n"
        "import pathlib, tempfile\n"
        "import torch.distributed as dist\n"
        "import cuda_fft_convolution_torch.parallel\n"
        "from cuda_fft_convolution_torch.parallel import dryrun\n"
        "dist.init_process_group('gloo', rank=0, world_size=1,\n"
        "    init_method=pathlib.Path(tempfile.mkdtemp(), 'store').as_uri())\n"
        "mesh = fc.make_mesh(device='cpu')\n"
        "got = fc.conv_spectral_sharded(sd, np.ones((3, 5, 5, 1), np.float32), mesh,\n"
        "                                mode='same').full_tensor()\n"
        "assert tuple(got.shape) == (3, 40, 40)\n"
        "dist.destroy_process_group()\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
        "    'cuda_fft_convolution_tpu')) for m in sys.modules\n"
        "    if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_build_library_named_by_source_hash(tmp_path):
    """The library lands in build/ under a name hashed from the sources, so
    an edited source never loads a stale build. The radix bodies' sources
    make a library of their own, under its own name, and so do the
    Karatsuba and v2 entries' (the forms library)."""
    from cuda_fft_convolution_torch import _build

    sources = _build._sources()
    headers = ["block_conv.cuh", "block_conv_maps.cuh", "block_conv_peaks.cuh"]
    assert [s.name for s in sources] == [
        "block_conv.cu", *headers[:2], "block_conv_peaks.cu", headers[2], "block_conv_tiers.cu",
        "spectral_mac.cu",
    ]
    radix_sources = _build._sources(radix=True)
    assert [s.name for s in radix_sources] == [
        *headers, "block_conv_r4.cu", "block_conv_r5.cu", "block_conv_r5x.cu",
    ]
    path = _build._library_path(sources)
    radix_path = _build._library_path(radix_sources)
    assert path.parent == radix_path.parent == _build.BUILD_DIR
    assert path.name.startswith("libfftconv_torch_") and path.suffix == ".so"
    assert radix_path.name.startswith("libfftconv_torch_radix_") and radix_path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # an edited header renames both libraries as an edited source does
    edited = tmp_path / "block_conv.cuh"
    edited.write_bytes(sources[1].read_bytes() + b"\n")
    assert _build._library_path([sources[0], edited, *sources[2:]]) != path
    assert _build._library_path([edited, *radix_sources[1:]]) != radix_path
    # every C entry point the wrappers call has a signature: one per kernel
    # dtype mode, synthesis tier and body (the radix bodies' entries, in
    # the radix library, take three more pointers), and the configuration
    # model's six queries (packed width, window height, tier)
    v3 = {
        "fftconv_block_conv_f32", "fftconv_block_conv_f32_bf16maps",
        "fftconv_block_conv_bf16", "fftconv_block_conv_bf16_bf16maps",
        "fftconv_block_conv_f32_x6", "fftconv_block_conv_f32_bf16maps_x6",
        "fftconv_block_conv_f32_x1", "fftconv_block_conv_f32_bf16maps_x1",
        "fftconv_block_conv_bf16_io", "fftconv_block_conv_bf16_bf16maps_io",
        "fftconv_block_conv_f32_smem_bytes", "fftconv_block_conv_f32_rows",
        "fftconv_block_conv_f32_blocks", "fftconv_block_conv_f32_kernels",
        "fftconv_block_conv_f32_cluster", "fftconv_block_conv_f32_pair_bins",
        "fftconv_block_conv_peaks_f32", "fftconv_block_conv_peaks_bf16",
        "fftconv_block_conv_peaks_f32_x6", "fftconv_block_conv_peaks_f32_x1",
        "fftconv_block_conv_peaks_bf16_io",
        "fftconv_spectral_mac_f32", "fftconv_spectral_mac_bf16",
    }
    kernels = {n for n in v3 if n.startswith("fftconv_block_conv") and n.count("_") > 2
               and not n.endswith(("smem_bytes", "rows", "blocks", "kernels", "cluster",
                                   "pair_bins"))}
    assert len(kernels) == 15
    radix = {f"{n}{body}" for n in kernels for body in ("_r4", "_r5", "_r5x")}
    assert set(_build._SIGNATURES) == v3
    # the v2 body's maps entries (_v2: v3's kernels) sit beside v3's, with
    # v3's arguments
    v2 = {f"{n}_v2" for n in kernels if "_peaks_" not in n}
    assert set(_build._V2_SIGNATURES) == v2
    assert set(_build._KINDS["main"][1]) == v3 | v2
    for name in v2:
        assert _build._V2_SIGNATURES[name] == _build._SIGNATURES[name.removesuffix("_v2")]
    assert set(_build._RADIX_SIGNATURES) == radix
    for name in radix:
        v3_args = _build._SIGNATURES[name.rsplit("_", 1)[0]][0]
        assert _build._RADIX_SIGNATURES[name][0] == (
            v3_args[:8] + [ctypes.c_void_p] * 3 + v3_args[8:])
    for query in ("smem_bytes", "rows", "blocks", "kernels", "cluster", "pair_bins"):
        assert len(_build._SIGNATURES[f"fftconv_block_conv_f32_{query}"][0]) == 3
    # the forms library: the Karatsuba maps and peaks entries (_k) and the
    # v2 body's Karatsuba maps entries (_v2_k), with the v3 entries'
    # arguments, and the queries of the Karatsuba and the v2 configurations
    # (v2's take the form as a fourth)
    forms_sources = _build._sources(forms=True)
    assert [s.name for s in forms_sources] == [
        "block_conv.cuh", "block_conv_k.cu", "block_conv_k_tiers.cu", *headers[1:],
        "block_conv_peaks_k.cu",
    ]
    forms_path = _build._library_path(forms_sources)
    assert forms_path.name.startswith("libfftconv_torch_forms_")
    assert len({path, radix_path, forms_path}) == 3
    maps = {n for n in kernels if "_peaks_" not in n}
    forms = ({f"{n}{sfx}" for n in maps for sfx in ("_k", "_v2_k")}
             | {f"{n}_k" for n in kernels - maps})
    queries = {"fftconv_block_conv_k_smem_bytes", "fftconv_block_conv_k_rows",
               "fftconv_block_conv_k_cluster", "fftconv_block_conv_k_pair_bins",
               "fftconv_block_conv_v2_smem_bytes", "fftconv_block_conv_v2_rows",
               "fftconv_block_conv_v2_blocks"}
    assert set(_build._FORM_SIGNATURES) == forms | queries
    for name in forms:
        base = name.removesuffix("_k").removesuffix("_v2")
        assert _build._FORM_SIGNATURES[name] == _build._SIGNATURES[base]
    for query in queries:
        assert len(_build._FORM_SIGNATURES[query][0]) == (4 if "_v2_" in query else 3)
