"""Sharded filter-bank convolution over a device mesh.

The port of ``cuda_fft_convolution_tpu/parallel/mesh.py`` on
``torch.distributed``. The strategy is the JAX package's (the reference's
multi-GPU intent, src/cudaConvFFTDataStreams.cu):

  - **kernel axis**: the filter bank (N axis) is sharded over the ranks of
    the mesh's ``'kernels'`` dimension — the reference's round-robin of
    kernels over GPUs (src/cudaConvFFTDataStreams.cu:341-349);
  - **data axis**: the image batch (B axis) is sharded over the
    ``'data'`` dimension (data parallelism);
  - the data spectra are replicated along the kernel axis. JAX places one
    global array; here one rank owns one device, the ranks run SPMD, and
    every rank passes the same host inputs (as the JAX package's
    multi-process callers do), so each rank stages the spectra itself and
    takes its own slice: batch ``[data_rank]``, bank ``[kernel_rank]``.

Each rank then runs the port's single-device program on its
(batch shard × bank shard) block — the fused block-conv kernel on tiled
spectra, the MAC kernel and one inverse per map on direct spectra, the
peaks kernel for the detection head — with no collective. Outputs come back
as ``DTensor``s over the mesh, sharded over (data, kernels); ``full_tensor()``
gathers them (the JAX package's ``process_allgather``). Uneven banks are
split as ``torch.chunk`` splits them, ``ceil(N / k)`` kernels a rank and
the remainder (possibly none) on the last ranks: the JAX package's
pad-then-``[:, :n]``. The C entries never see a ``DTensor``: every
per-rank body works on local tensors and wraps its outputs at the end.

``make_mesh`` builds the (data, kernels) ``DeviceMesh`` over the default
process group, which the caller starts on every rank (``'nccl'`` on the
card, one rank per device; ``'gloo'`` with ``device='cpu'``).
``train_step_sharded`` is the DP×TP training step the JAX package gets from
``jit`` of ``models.train_step`` under the same shardings.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from cuda_fft_convolution_torch import api as _api
from cuda_fft_convolution_torch.ops.tiled import conv_blocks_peaks, conv_blocks_top_k
from cuda_fft_convolution_torch.runtime.planner import (
    plan_bank,
    plan_streaming,
    spectra_bytes,
)
from cuda_fft_convolution_torch.types import (
    SpectralData,
    SpectralKernels,
    TiledSpectralData,
)
from cuda_fft_convolution_torch.utils.device import as_tensor, resolve_device
from cuda_fft_convolution_torch.utils.errors import validate
from cuda_fft_convolution_torch.utils.fft_size import FftSizePolicy

DATA_AXIS = "data"
KERNEL_AXIS = "kernels"

# A bank placed by shard_kernel_bank: replicated over the data axis,
# sharded over the kernel axis.
_BANK_PLACEMENTS = (Replicate(), Shard(0))


def make_mesh(data: int = 1, kernels: int | None = None, *, device=None) -> DeviceMesh:
    """Build a (data, kernels) mesh over the ranks of the default process
    group. ``kernels=None`` → every remaining rank on the kernel axis (bank
    sharding is the primary scaling axis for this workload, as in the
    reference's kernel round-robin).

    ``device=None`` is the card: the process group must be NCCL's, one rank
    a device. ``device='cpu'`` takes a gloo group. With no card and no
    ``device='cpu'`` this raises, as every entry point of the port does."""
    dev = resolve_device(device)
    validate(
        dist.is_available() and dist.is_initialized(),
        "make_mesh needs the default process group started on every rank: "
        "torch.distributed.init_process_group('nccl' on the card, 'gloo' "
        "with device='cpu', init_method='tcp://host:port' or 'file://path', "
        "rank=..., world_size=...)",
    )
    backend = str(dist.get_backend())
    want = "nccl" if dev.type == "cuda" else "gloo"
    validate(
        want in backend,
        f"a mesh on {dev.type} needs a '{want}' process group; the default "
        f"group is '{backend}'",
    )
    n = dist.get_world_size()
    if kernels is None:
        validate(n % data == 0, f"{n} devices not divisible by data={data}")
        kernels = n // data
    validate(
        data * kernels == n,
        f"mesh {data}x{kernels} != {n} available devices",
    )
    return init_device_mesh(dev.type, (data, kernels), mesh_dim_names=(DATA_AXIS, KERNEL_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def kernel_rows(n: int, mesh: DeviceMesh) -> tuple[int, int, int]:
    """This rank's rows of an ``n``-kernel bank → ``(start, stop, rows)``:
    ``rows = ceil(n / k)`` a shard, as ``torch.chunk`` splits ``n`` over the
    ``k`` ranks of the kernel axis; the last shards may be short or empty."""
    rows = -(-n // mesh.size(1))
    start = min(n, mesh.get_coordinate()[1] * rows)
    return start, min(n, start + rows), rows


def _local_data(spectral, mesh: DeviceMesh):
    """This rank's batch shard of the data planes (the data axis) → (d_re,
    d_im, the whole batch B); unbatched spectra are a batch of one."""
    d_re, d_im = _api._batched_planes(spectral)
    b, dshards = d_re.shape[0], mesh.size(0)
    validate(b % dshards == 0, f"batch {b} not divisible by data-axis size {dshards}")
    local = b // dshards
    start = mesh.get_coordinate()[0] * local
    return d_re[start : start + local], d_im[start : start + local], b


def _contiguous_stride(shape) -> tuple:
    stride, s = [], 1
    for d in reversed(shape):
        stride.append(s)
        s *= d
    return tuple(reversed(stride))


def _wrap(local: torch.Tensor, mesh: DeviceMesh, placements, shape) -> DTensor:
    """A ``DTensor`` of global ``shape`` from this rank's shard. The shape
    is given, so no collective runs: uneven shards follow ``torch.chunk``."""
    return DTensor.from_local(
        local, mesh, placements, run_check=False, shape=torch.Size(shape),
        stride=_contiguous_stride(shape),
    )


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad the leading (bank) axis to ``rows``: zero kernels convolve to
    zero maps, trimmed after (the reference's round-robin leaves trailing
    slots idle, src/cudaConvFFTDataStreams.cu:353-360)."""
    if x.shape[0] == rows:
        return x
    pad = x.new_zeros((rows - x.shape[0], *x.shape[1:]))
    return torch.cat([x, pad])


def _placed(x, mesh: DeviceMesh, n: int) -> bool:
    """Whether ``x`` is a bank plane already placed on ``mesh`` by
    ``shard_kernel_bank`` for an ``n``-kernel bank (the JAX package's
    ``_placed``: such a bank is used as it is)."""
    return (
        isinstance(x, DTensor)
        and x.device_mesh == mesh
        and tuple(x.placements) == _BANK_PLACEMENTS
        and x.shape[0] == -(-n // mesh.size(1)) * mesh.size(1)
    )


def _local_bank(sk: SpectralKernels, mesh: DeviceMesh) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's (re, im) bank shard, ``kernel_rows`` rows zero-padded to
    a full shard: the local tensors of a bank placed on ``mesh``, else a
    slice of the whole bank (a ``DTensor`` on another mesh is gathered)."""
    n = len(sk.kernel_hs)
    if _placed(sk.re, mesh, n) and _placed(sk.im, mesh, n):
        return sk.re.to_local(), sk.im.to_local()
    start, stop, rows = kernel_rows(n, mesh)
    planes = (x.full_tensor() if isinstance(x, DTensor) else x for x in (sk.re, sk.im))
    return tuple(_pad_rows(x[start:stop], rows) for x in planes)


def _placed_bank(sk: SpectralKernels, k_re, k_im, mesh: DeviceMesh) -> SpectralKernels:
    """``sk`` with this rank's full-shard planes placed on ``mesh``."""
    shape = (k_re.shape[0] * mesh.size(1), *k_re.shape[1:])
    return dataclasses.replace(
        sk,
        re=_wrap(k_re, mesh, _BANK_PLACEMENTS, shape),
        im=_wrap(k_im, mesh, _BANK_PLACEMENTS, shape),
    )


def shard_kernel_bank(sk: SpectralKernels, mesh: DeviceMesh) -> SpectralKernels:
    """Place a kernel bank's spectra sharded over the mesh's kernel axis
    (padded to a multiple of its size). Amortizes bank placement across
    calls: ``conv_spectral_sharded``, ``detect_peaks_sharded`` and a second
    ``shard_kernel_bank`` use a placed bank's local shard as it is.

    Every rank passes the whole bank (the same host inputs everywhere); each
    keeps its own shard. The planes become ``DTensor``s of the padded global
    shape, replicated over the data axis: ``num_kernels`` is the padded
    count, ``kernel_hs``/``kernel_ws`` keep the true per-kernel sizes."""
    n = len(sk.kernel_hs)
    if _placed(sk.re, mesh, n) and _placed(sk.im, mesh, n):
        return sk
    return _placed_bank(sk, *_local_bank(sk, mesh), mesh)


def _raw_stack(kernels, feature_dim, device, fft_h: int, fft_w: int, correlation: bool):
    """A raw bank → its (N, F, Kh, Kw) stack on ``device``, the correlation
    flip applied, and the true sizes → (stack, khs, kws)."""
    kstack, khs, kws = _api._kernels_to_stack(kernels, feature_dim, device)
    _api._check_fits_fft(khs, kws, fft_h, fft_w)
    return _api._apply_correlation_flip(kstack, khs, kws, correlation), khs, kws


def _shard_spectra(kstack, khs, kws, fft_h, fft_w, store_t, mesh):
    """The spectra of this rank's rows of a flipped raw stack only (1/k of
    the bank transform), zero-padded to a full shard → (re, im)."""
    start, stop, rows = kernel_rows(kstack.shape[0], mesh)
    if stop == start:  # a shard past the bank's end holds zero kernels only
        shape = (rows, kstack.shape[1], fft_h, fft_w // 2 + 1)
        k_re = torch.zeros(shape, dtype=store_t, device=kstack.device)
        return k_re, torch.zeros_like(k_re)
    sk = _api._bank_from_stack(
        kstack[start:stop], khs[start:stop], kws[start:stop], fft_h, fft_w, False, store_t
    )
    return _pad_rows(sk.re, rows), _pad_rows(sk.im, rows)


def _shard_raw_bank(
    kernels, fft_h: int, fft_w: int, mesh: DeviceMesh, *, correlation: bool = False,
    store_dtype: str = "float32",
) -> SpectralKernels:
    """A raw bank's spectra at (fft_h, fft_w), placed on ``mesh`` as
    ``shard_kernel_bank`` places them, each rank transforming only its own
    shard (``ShardedConvStream`` builds its bank so)."""
    store_t = _api._resolve_store_dtype(store_dtype)
    kstack, khs, kws = _raw_stack(kernels, None, mesh_device(mesh), fft_h, fft_w, correlation)
    k_re, k_im = _shard_spectra(kstack, khs, kws, fft_h, fft_w, store_t, mesh)
    sk = SpectralKernels(re=k_re, im=k_im, fft_h=fft_h, fft_w=fft_w, kernel_hs=khs,
                         kernel_ws=kws)
    return _placed_bank(sk, k_re, k_im, mesh)


def _check_mesh_device(spectral, mesh: DeviceMesh) -> None:
    validate(
        spectral.re.device.type == mesh.device_type,
        f"spectra on {spectral.re.device} but the mesh is on "
        f"{mesh.device_type}: stage each rank's inputs on its own device",
    )


def _maps_out(
    local: torch.Tensor,  # (B_local, rows, H', W'), padded rows included
    spectral,
    khs: tuple,
    kws: tuple,
    mode: str,
    b: int,
    mesh: DeviceMesh,
    same_offset: str,
    centered: bool = False,
):
    """Drop this rank's padding rows, trim to ``mode``'s window and wrap →
    a ``DTensor`` sharded over (data, kernels), (B, N, h, w) or, unbatched,
    (N, h, w) over the kernel axis. A ragged bank's windows differ by
    kernel: its maps are gathered along the kernel axis first and the list
    holds one ``DTensor`` a kernel, sharded over the data axis."""
    n = len(khs)
    start, stop, _ = kernel_rows(n, mesh)
    local = local[:, : stop - start]
    batched = spectral.batched
    ragged = len(set(khs)) > 1 or len(set(kws)) > 1
    if ragged and mode != "fftmap":
        whole = _wrap(local, mesh, (Shard(0), Shard(1)), (b, n, *local.shape[2:]))
        gathered = whole.redistribute(mesh, (Shard(0), Replicate())).to_local()
        maps = _api._trim(gathered, spectral, khs, kws, mode, True,
                          same_offset=same_offset, centered=centered)
        if batched:
            return [_wrap(m, mesh, (Shard(0), Replicate()), (b, *m.shape[1:])) for m in maps]
        return [_wrap(m[0], mesh, (Replicate(), Replicate()), m.shape[1:]) for m in maps]
    maps = _api._trim(local, spectral, khs, kws, mode, True,
                      same_offset=same_offset, centered=centered)
    if batched:
        return _wrap(maps, mesh, (Shard(0), Shard(1)), (b, n, *maps.shape[2:]))
    return _wrap(maps[0], mesh, (Replicate(), Shard(0)), (n, *maps.shape[2:]))


def conv_spectral_sharded(
    spectral: SpectralData | TiledSpectralData,
    kernels,
    mesh: DeviceMesh,
    *,
    mode: str = "fftmap",
    correlation: bool = False,
    use_pallas: bool | None = None,
    same_offset: str = "scipy",
    out_dtype: str | None = None,
):
    """Bank convolution sharded over ``mesh`` — the multi-device
    ``conv_spectral``. Call it on every rank with the same inputs.

    Data spectra: each rank takes its batch shard (the data axis) of the
    spectra it staged, so they are replicated along the kernel axis. Kernel
    bank: a raw bank is transformed on each rank's shard only (the same
    maps, 1/k of the transform work); ``SpectralKernels`` are sliced, or
    used as they are when ``shard_kernel_bank`` placed them. Output maps
    come back as a ``DTensor`` sharded over (data, kernels) — (B, N, h, w),
    or (N, h, w) unbatched — and ``full_tensor()`` gathers them.

    ``TiledSpectralData`` runs the overlap-save engine (the fused block-conv
    kernel) per rank on its bank shard; ``SpectralData`` the direct engine
    (the MAC kernel and one inverse per map). Memory is planned per rank
    against its own device's budget (``runtime/planner.py``): a shard whose
    products and maps do not fit runs in chunks, and a raw giant bank whose
    resident per-rank spectra would exceed half the budget never becomes
    spectra — each rank streams its spatial shard (transform, MAC and
    inverse a chunk at a time). ``use_pallas`` is accepted with no effect,
    as in ``conv_spectral``."""
    del use_pallas
    validate(mode in _api._MODES, f"mode must be one of {_api._MODES}")
    tiled = isinstance(spectral, TiledSpectralData)
    out_t = _api._resolve_out_dtype(out_dtype)
    _api._check_clamp_mode(spectral, mode)
    _check_mesh_device(spectral, mesh)
    if tiled:
        _api._check_tiled_canvas(spectral, mode)
    kshards = mesh.size(1)
    budget = _api._device_memory_budget(spectral.re.device)
    fft_h, fft_w = (
        (spectral.block_h, spectral.block_w) if tiled else (spectral.fft_h, spectral.fft_w)
    )
    if isinstance(kernels, SpectralKernels):
        sk = kernels
        _api._check_bank(sk, spectral, correlation)
        validate(
            not sk.flat,
            "flat-layout banks are a single-device direct-engine "
            "optimization; precompute with storage='planar' for sharding",
        )
        k_re, k_im = _local_bank(sk, mesh)
    else:
        kstack, khs, kws = _raw_stack(
            kernels, spectral.feature_dim, spectral.re.device, fft_h, fft_w, correlation
        )
        n, f = int(kstack.shape[0]), int(kstack.shape[1])
        if not tiled:
            # Giant raw banks: size the RESIDENT per-rank spectra before
            # transforming anything; stream spatial shards when they exceed
            # half the per-rank budget (the rule of api.conv_spectral).
            per_rank = spectra_bytes(
                -(-n // kshards), f, fft_h, fft_w, spectral.re.element_size()
            )
            if n > kshards and per_rank > budget // 2:
                return _conv_sharded_streaming(
                    spectral, kstack, khs, kws, mesh, mode=mode,
                    same_offset=same_offset, out_t=out_t, budget=budget,
                )
        k_re, k_im = _shard_spectra(kstack, khs, kws, fft_h, fft_w, spectral.re.dtype, mesh)
        sk = SpectralKernels(re=k_re, im=k_im, fft_h=fft_h, fft_w=fft_w,
                             kernel_hs=khs, kernel_ws=kws)
    if tiled:
        _api._check_tiled_bank(sk, spectral, mode)
    else:
        _api._check_direct_bank(sk, spectral)

    d_re, d_im, b = _local_data(spectral, mesh)
    maps = _rank_maps(spectral, d_re, d_im, k_re, k_im, out_t, budget)
    return _maps_out(maps, spectral, sk.kernel_hs, sk.kernel_ws, mode, b, mesh,
                     same_offset, sk.centered)


def _rank_maps(spectral, d_re, d_im, k_re, k_im, out_t: torch.dtype, budget: int):
    """The per-rank program (the JAX package's ``_local_conv``): a batch
    shard of the data planes (B_local, ...) against a bank shard (rows, F,
    H, Wc) → maps (B_local, rows, H', W') in ``out_t``, by the
    single-device program — ``conv_blocks`` (the fused block-conv kernel)
    on tiled spectra, the MAC kernel and one inverse a map on direct ones —
    chunked when the rank's products and maps exceed ``budget`` (the
    single-device auto-chunking applied to the shard)."""
    tiled = isinstance(spectral, TiledSpectralData)
    fft_h, fft_w = (
        (spectral.block_h, spectral.block_w) if tiled else (spectral.fft_h, spectral.fft_w)
    )
    rows = k_re.shape[0]
    plan_batch = d_re.shape[0] * (d_re.shape[1] * d_re.shape[2] if tiled else 1)
    chunk = plan_bank(
        rows, spectral.feature_dim, fft_h, fft_w, batch=plan_batch,
        hbm_budget_bytes=budget, store_bytes=k_re.element_size(),
    ).chunk_size
    if tiled:
        bank = SpectralKernels(re=k_re, im=k_im, fft_h=fft_h, fft_w=fft_w,
                               kernel_hs=(spectral.max_kh,) * rows,
                               kernel_ws=(spectral.max_kw,) * rows)
        return _api._tiled_chunked_maps(spectral, d_re, d_im, bank, chunk, out_t)
    if chunk < rows:
        return _api._conv_from_spectra_chunked(d_re, d_im, k_re, k_im, fft_h, fft_w, chunk, out_t)
    return _api._conv_from_spectra(d_re, d_im, k_re, k_im, fft_h, fft_w).to(out_t)


def _conv_sharded_streaming(
    spectral: SpectralData,
    kstack: torch.Tensor,  # (N, F, Kh, Kw) spatial, correlation flip applied
    khs: tuple,
    kws: tuple,
    mesh: DeviceMesh,
    *,
    mode: str,
    same_offset: str,
    out_t: torch.dtype,
    budget: int,
):
    """``conv_spectral_sharded``'s tail for giant raw banks: each rank
    streams its spatial shard through transform, MAC and inverse in chunks
    sized by ``plan_streaming`` on its own budget — resident bank spectra
    never exist on any rank (``api._conv_from_spatial_chunked``)."""
    _api._check_not_aliased(spectral, khs, kws, mode)
    d_re, d_im, b = _local_data(spectral, mesh)
    start, stop, local_n = kernel_rows(kstack.shape[0], mesh)
    shard = kstack[start:stop]
    plan = plan_streaming(
        local_n, int(kstack.shape[1]), spectral.fft_h, spectral.fft_w,
        batch=d_re.shape[0], hbm_budget_bytes=budget,
        store_bytes=spectral.re.element_size(),
        stack_bytes=shard.numel() * shard.element_size(),
    )
    maps = _api._conv_from_spatial_chunked(
        d_re, d_im, shard, spectral.fft_h, spectral.fft_w, plan.chunk_size, out_t
    )
    return _maps_out(maps, spectral, khs, kws, mode, b, mesh, same_offset)


def detect_peaks_sharded(
    spectral: TiledSpectralData,
    kernels,
    mesh: DeviceMesh,
    *,
    correlation: bool = True,
    k: int | None = None,
):
    """Multi-device detection head: per-kernel top-1 ``(values,
    positions)`` with the bank sharded over ``mesh``'s kernel axis and the
    batch over its data axis — ``detect_peaks`` × ``conv_spectral_sharded``
    composed. Each rank reduces its bank shard's maps in the peaks kernel
    (the maps are never written at fused geometries) and keeps a (B_local,
    N_local) peak tuple: there is no collective at all.

    ``spectral`` must be a :class:`TiledSpectralData` with a baked
    'same'/'valid' window (the peaks frame; fft_data_tiled ``trim_mode=``)
    or none (→ the kernel-'full' frame). ``kernels`` is a stacked uniform
    bank (N, Kh, Kw, F) or planar :class:`SpectralKernels` at the block
    geometry (pre-shard with ``shard_kernel_bank`` to amortize placement).
    Returns ``values`` (B, N) | (N,) and ``positions`` (..., N, 2) int32 in
    the window frame as ``DTensor``s sharded over (data, kernels), equal to
    single-device ``detect_peaks``'.

    ``k`` switches the head to top-k per kernel with the semantics of
    :func:`models.detect_top_k` (``conv_blocks_top_k``): ``values``
    (..., N, k), ``positions`` (..., N, k, 2)."""
    validate(
        isinstance(spectral, TiledSpectralData),
        "detect_peaks_sharded takes TiledSpectralData (the peaks head is "
        "an overlap-save consumer; for direct spectra run "
        "conv_spectral_sharded and argmax the sharded maps)",
    )
    validate(k is None or int(k) >= 1, f"k must be >= 1; got {k}")
    validate(
        not spectral.fftmap_canvas,
        "fftmap's circular frame has no meaningful global peak position",
    )
    _check_mesh_device(spectral, mesh)
    if isinstance(kernels, SpectralKernels):
        sk = kernels
        validate(
            not sk.flat and sk.fft_h == spectral.block_h
            and sk.fft_w == spectral.block_w,
            "SpectralKernels geometry/layout does not match the tiled "
            "spectra (planar at the block FFT size required)",
        )
        validate(
            sk.re.dtype == spectral.re.dtype,
            "spectra store-dtype mismatch between data and kernel bank",
        )
        k_re, k_im = _local_bank(sk, mesh)
        khs, kws = sk.kernel_hs, sk.kernel_ws
    else:
        kstack, khs, kws = _raw_stack(
            kernels, spectral.feature_dim, spectral.re.device, spectral.block_h,
            spectral.block_w, correlation,
        )
        k_re, k_im = _shard_spectra(kstack, khs, kws, spectral.block_h, spectral.block_w,
                                    spectral.re.dtype, mesh)
    validate(
        max(khs) <= spectral.max_kh and max(kws) <= spectral.max_kw,
        "bank kernels exceed the tiled spectra's planned envelope",
    )
    d_re, d_im, b = _local_data(spectral, mesh)
    n = len(khs)
    if spectral.win_h is not None:
        out_h, out_w = spectral.out_h, spectral.out_w
    else:
        out_h = spectral.data_h + max(khs) - 1
        out_w = spectral.data_w + max(kws) - 1
    geom = (spectral.block_h, spectral.block_w, spectral.max_kh, spectral.max_kw, out_h, out_w)
    if k is None:
        vals, ys, xs = conv_blocks_peaks(d_re, d_im, k_re, k_im, *geom)
    else:
        vals, ys, xs = conv_blocks_top_k(d_re, d_im, k_re, k_im, *geom, int(k))
    start, stop, _ = kernel_rows(n, mesh)
    vals = vals[:, : stop - start]
    pos = torch.stack([ys, xs], dim=-1)[:, : stop - start].to(torch.int32)
    if spectral.batched:
        return tuple(_wrap(x, mesh, (Shard(0), Shard(1)), (b, n, *x.shape[2:]))
                     for x in (vals, pos))
    return tuple(_wrap(x[0], mesh, (Replicate(), Shard(0)), (n, *x.shape[2:]))
                 for x in (vals, pos))


def train_step_sharded(
    model,
    optimizer: torch.optim.Optimizer,
    images,
    targets,
    mesh: DeviceMesh,
    *,
    policy: FftSizePolicy | str = FftSizePolicy.FAST,
):
    """One DP×TP training step of the filter-bank detector → ``(model,
    optimizer, loss)``: the step the JAX package gets from ``jit`` of
    ``models.train_step`` with the batch sharded over the data axis and the
    bank (kernels, bias, optimizer state) over the kernel axis.

    ``model`` holds this rank's shard of the bank and the bias (carry JAX's
    parameters across with ``models.detector_from_numpy`` on the rank's
    ``kernel_rows``), ``images`` its (B_local, F, H, W) batch shard and
    ``targets`` its (B_local, N_local, H, W) block. The local loss is the
    squared error summed over the block and divided by the GLOBAL element
    count; its gradients are summed over the data axis, so each rank holds
    the gradient of the global mean loss for its shard, and the local
    ``torch.optim`` step runs on them. The returned loss (detached) is the
    global mean, summed over the whole mesh. Each rank's forward and
    backward run through the MAC kernel."""
    from cuda_fft_convolution_torch.models.filter_bank import detect

    optimizer.zero_grad()
    scores = detect(model, images, policy=policy)
    targets = as_tensor(targets, scores.device)
    validate(
        tuple(targets.shape) == tuple(scores.shape),
        f"targets {tuple(targets.shape)} != this rank's score block "
        f"{tuple(scores.shape)} (batch shard × kernel shard)",
    )
    groups = [mesh.get_group(axis) for axis in (DATA_AXIS, KERNEL_AXIS)]
    count = torch.tensor(scores.numel(), dtype=torch.int64, device=scores.device)
    for group in groups:
        dist.all_reduce(count, group=group)
    loss = ((scores - targets) ** 2).sum() / count
    loss.backward()
    for p in model.parameters():
        dist.all_reduce(p.grad, group=groups[0])
    optimizer.step()
    total = loss.detach().clone()
    for group in groups:
        dist.all_reduce(total, group=group)
    return model, optimizer, total
