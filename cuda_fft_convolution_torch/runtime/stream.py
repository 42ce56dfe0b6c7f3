"""Bounded-depth asynchronous serving streams.

The port of ``cuda_fft_convolution_tpu/runtime/stream.py``: the
reference's stream pool (src/cudaConvFFTDataStreams.cu:279-349), a pool of
cudaStreams round-robined over the work loop whose size bounds the work in
flight, as a serving loop over a resident bank.

  - ``submit(frame)`` launches the frame's planned pipeline on the device's
    current CUDA stream without waiting and returns a :class:`ConvFuture`;
  - at most ``depth`` submissions are unresolved at a time: submitting
    deeper first waits on the OLDEST one, so device memory for queued
    outputs stays bounded at ``depth`` working sets;
  - completion is a ``torch.cuda.Event`` recorded after the frame's last
    launch; ``result()`` synchronises that event. On the CPU the work is
    done when ``submit`` returns.

A frame given as a host array (numpy, or a CPU tensor) is copied to the
card through a ring of ``depth`` pinned host buffers with a non-blocking
copy: a copy from pageable memory would synchronise the stream, and every
``submit`` would then wait for the whole queue. A slot is refilled only
after the event recorded behind its last copy has completed. A frame that
is already a tensor on the card is used as it is. Every launch of a stream
goes to the current stream, so the caching allocator's stream order keeps
each tensor alive until the work that reads it has run.
"""

from __future__ import annotations

import collections
from typing import Sequence

import numpy as np
import torch

from cuda_fft_convolution_torch.runtime.plan import FftConvPlan, make_plan
from cuda_fft_convolution_torch.utils.device import as_tensor, resolve_device
from cuda_fft_convolution_torch.utils.errors import validate


class _FifoClock:
    """Shared resolution watermark for one stream's FIFO queue.

    One CUDA stream runs its work in order, so submission N's event having
    completed proves every submission ≤ N complete. Futures carry their
    sequence number and this shared clock: resolving a LATER future marks
    all earlier ones done without synchronising their own events."""

    __slots__ = ("resolved",)

    def __init__(self):
        self.resolved = -1


class ConvFuture:
    """Handle for one in-flight submission.

    ``result()`` waits until the device work is complete (the submission's
    event) and returns its output (maps, or ``(values, positions)`` under a
    head) on the stream's device. Idempotent; free when a LATER future on
    the same stream has already resolved (see :class:`_FifoClock`).
    """

    __slots__ = ("_event", "_value", "_done", "_seq", "_clock")

    def __init__(self, event, value, seq: int = 0, clock=None):
        self._event = event  # torch.cuda.Event, or None on the CPU
        self._value = value
        self._done = False
        self._seq = seq
        self._clock = clock

    def done(self) -> bool:
        """Whether this submission is known complete (resolved directly,
        or implied by a later same-stream resolution — no device poll)."""
        return self._done or (
            self._clock is not None and self._clock.resolved >= self._seq
        )

    def result(self):
        if not self._done:
            if not (
                self._clock is not None
                and self._clock.resolved >= self._seq
            ):
                if self._event is not None:
                    self._event.synchronize()
                if self._clock is not None:
                    self._clock.resolved = self._seq
            self._done = True
            self._event = None
        return self._value


class _BoundedStream:
    """The bounded-depth machinery the serving streams share: the in-flight
    deque, the FIFO clock, sequence numbers, the depth bound, the pinned
    ring of host frames, and ``map``/``flush``/the context manager.
    Subclasses own their plans and per-submit validation and call
    :meth:`_dispatch` with their frame function."""

    def _init_queue(self, depth: int, data_shape: tuple, device: torch.device) -> None:
        validate(depth >= 1, f"depth must be >= 1, got {depth}")
        self._depth = depth
        self._inflight: collections.deque[ConvFuture] = collections.deque()
        self._clock = _FifoClock()
        self._seq = 0
        self._data_shape = tuple(data_shape)
        self._device = device
        self._ring: list[torch.Tensor] = []  # pinned slots, made at first use
        self._ring_events: list = [None] * depth
        self._ring_next = 0

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def inflight(self) -> int:
        """Number of unresolved submissions currently queued."""
        self._drain_resolved()
        return len(self._inflight)

    def _drain_resolved(self) -> None:
        # Futures resolved out of band (result() called directly, or implied
        # by a later resolution) no longer hold a slot.
        while self._inflight and self._inflight[0].done():
            self._inflight.popleft()

    def _check_frame(self, frame) -> None:
        validate(
            tuple(frame.shape) == self._data_shape,
            f"frame shape {tuple(frame.shape)} != planned {self._data_shape}",
        )

    def _stage(self, frame) -> torch.Tensor:
        """The frame on the stream's device, without a host sync."""
        if self._device.type != "cuda":
            return as_tensor(frame, self._device)
        if isinstance(frame, torch.Tensor):
            if frame.is_cuda:
                return frame.to(self._device, non_blocking=True)
            host = frame
        else:
            host = torch.as_tensor(np.ascontiguousarray(frame))
        if not self._ring:
            self._ring = [
                torch.empty(self._data_shape, dtype=torch.float32, pin_memory=True)
                for _ in range(self._depth)
            ]
        i = self._ring_next
        self._ring_next = (i + 1) % self._depth
        if self._ring_events[i] is not None:
            self._ring_events[i].synchronize()  # the slot's last copy is done
        slot = self._ring[i]
        slot.copy_(host)
        staged = torch.empty(self._data_shape, dtype=torch.float32, device=self._device)
        stream = torch.cuda.current_stream(self._device)
        staged.copy_(slot, non_blocking=True)
        self._ring_events[i] = stream.record_event()
        return staged

    def _dispatch(self, frame_fn, frame) -> ConvFuture:
        # Bound BEFORE dispatching: never more than `depth` unresolved
        # working sets on the device.
        self._drain_resolved()
        while len(self._inflight) >= self._depth:
            self._inflight.popleft().result()
        out = frame_fn(self._stage(frame))
        event = None
        if self._device.type == "cuda":
            event = torch.cuda.current_stream(self._device).record_event()
        fut = ConvFuture(event, out, self._seq, self._clock)
        self._seq += 1
        self._inflight.append(fut)
        return fut

    def map(self, frames: Sequence) -> list:
        """Pipeline a whole sequence and return the resolved results in
        order. At most ``depth`` submissions are in flight."""
        futures = [self.submit(f) for f in frames]
        return [f.result() for f in futures]

    def flush(self) -> None:
        """Block until every outstanding submission has completed."""
        while self._inflight:
            self._inflight.popleft().result()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.flush()


class ConvStream(_BoundedStream):
    """Serving loop: repeated frames against one resident bank.

    Built over an :class:`FftConvPlan`, with the bank spectra computed once
    and held on the device — the reference's persistent ``cudaFFTData`` +
    repeated ``cudaConvFFTData`` serving shape (src/cudaFFTData.cu:97-150),
    with the streams variant's bounded pipelining on top.

    Use :meth:`ConvStream.create` unless you already hold a plan::

        stream = ConvStream.create(frame_shape, bank, algorithm="tiled",
                                   mode="same", depth=3)
        futures = [stream.submit(f) for f in frames]   # launched, no wait
        maps = [f.result() for f in futures]           # wait as consumed

    ``depth`` bounds the submissions in flight (device memory: ``depth``
    output working sets and, for host frames, ``depth`` pinned frame
    buffers). A ``submit`` past the bound first waits on the oldest
    future. Exiting the context manager flushes.

    ``head='peaks'|'top_k'|'local_peaks'`` (with ``head_k`` /
    ``head_window`` / ``head_threshold``) serves detections: futures
    resolve to ``(values, positions)``, and each working set shrinks from
    the maps to (N, k) values.
    """

    def __init__(self, plan: FftConvPlan, kernels, *, depth: int = 3):
        self._init_queue(depth, plan.data_shape, plan.device)
        self._plan = plan
        self.update_kernels(kernels)

    @classmethod
    def create(
        cls,
        data_shape: tuple,
        kernels,
        *,
        depth: int = 3,
        device=None,
        **plan_kwargs,
    ) -> "ConvStream":
        """Plan ``data_shape`` × ``kernels.shape`` on ``device`` (the card
        unless ``device='cpu'``) and wrap the plan. ``plan_kwargs`` go to
        :func:`make_plan` (``algorithm``, ``mode``, ``policy``,
        ``correlation``, ``store_dtype``, ``out_dtype``, ``head``…). The
        plan is lazy: a submit runs the whole frame through
        ``plan.trace_frame``, so the first submit warms its stages."""
        plan = make_plan(
            tuple(data_shape), tuple(np.shape(kernels)), lazy=True,
            device=device, **plan_kwargs,
        )
        return cls(plan, kernels, depth=depth)

    @property
    def plan(self) -> FftConvPlan:
        return self._plan

    def update_kernels(self, kernels) -> None:
        """(Re)compute and hold the resident bank spectra — the model-update
        path of a serving loop. Accepts a spatial bank of the planned shape
        or an ``(re, im)`` spectra pair from ``plan.kernel_fft``."""
        if isinstance(kernels, tuple) and len(kernels) == 2:
            want = self._plan.kfft_aval
            for name, plane in zip(("re", "im"), kernels):
                validate(
                    tuple(plane.shape) == tuple(want.shape)
                    and plane.dtype == want.dtype
                    and plane.device == self._plan.device,
                    f"spectra pair {name} plane {plane.dtype}"
                    f"{tuple(plane.shape)} on {plane.device} != planned "
                    f"{want.dtype}{tuple(want.shape)} on {self._plan.device} — "
                    "pass plan.kernel_fft output for this plan's geometry, "
                    "store dtype and device",
                )
            self._kfft = kernels
            return
        validate(
            tuple(np.shape(kernels)) == self._plan.kernel_shape,
            f"kernel shape {tuple(np.shape(kernels))} != planned "
            f"{self._plan.kernel_shape}",
        )
        self._kfft = self._plan.kernel_fft(kernels)

    def submit(self, frame) -> ConvFuture:
        """Launch one frame; returns at once unless ``depth`` submissions
        are already in flight (then waits on the oldest first)."""
        self._check_frame(frame)
        plan, kfft = self._plan, self._kfft
        return self._dispatch(lambda x: plan.trace_frame(x, kfft), frame)


class RaggedConvFuture:
    """Handle over one :class:`RaggedConvStream` submission. ``result()``
    resolves it and returns the per-kernel outputs in the ORIGINAL cell
    order — the contract of the reference's heterogeneous cell-array loop
    (src/cudaConvFFTDataStreams.cu:353-360), one map per cell in order."""

    __slots__ = ("_future", "_groups", "_n", "_batched")

    def __init__(self, future, groups, n, batched=False):
        self._future = future  # ONE ConvFuture over every group's launches
        self._groups = groups  # per-group original-cell index lists
        self._n = n
        self._batched = batched

    def done(self) -> bool:
        return self._future.done()

    def result(self) -> list:
        per_group = self._future.result()  # tuple, one entry per group
        out: list = [None] * self._n
        for stacked, idx in zip(per_group, self._groups):
            if isinstance(stacked, tuple):
                # head plans: (values, positions), kernel axis after batch
                kdim = 1 if self._batched else 0
                for pos, i in enumerate(idx):
                    out[i] = tuple(x.select(kdim, pos) for x in stacked)
                continue
            kdim = 0 if stacked.ndim == 3 else 1
            for pos, i in enumerate(idx):
                out[i] = stacked.select(kdim, pos)
        return out


class RaggedConvStream(_BoundedStream):
    """Bounded-depth serving for a HETEROGENEOUS kernel cell array — what
    the reference's streams loop does over a cell array of mixed sizes
    (src/cudaConvFFTDataStreams.cu:338-469). Kernels are grouped by exact
    spatial shape; each group gets its own lazy plan (its own FFT or block
    geometry) with its bank spectra computed once and held, and one
    ``submit`` launches every group's pipeline on the frame and records one
    event behind them all.

        stream = RaggedConvStream(frame_shape, cell_bank, depth=3)
        futures = [stream.submit(f) for f in frames]
        maps = [f.result() for f in futures]      # list, cell order

    ``depth`` bounds the submissions in flight (each holds every group's
    output). Kernels sharing a shape must share the feature dim. The groups
    are exact shapes, not ``fft_conv``'s pow-2 size buckets, so the plans
    (and the maps' rounding) can differ from ``fft_conv``'s on the same
    cells."""

    def __init__(
        self,
        data_shape: tuple,
        kernels: Sequence,
        *,
        depth: int = 3,
        device=None,
        **plan_kwargs,
    ):
        validate(
            isinstance(kernels, (list, tuple)) and len(kernels) >= 1,
            "RaggedConvStream takes a non-empty kernel cell list",
        )
        dev = resolve_device(device)
        ks = [as_tensor(k, dev) for k in kernels]
        for k in ks:
            validate(
                k.ndim == 3,
                f"each cell kernel must be (Kh, Kw, F), got {tuple(k.shape)}",
            )
        groups: dict = {}
        for i, k in enumerate(ks):
            groups.setdefault(tuple(k.shape), []).append(i)
        self._groups = list(groups.values())
        self._n = len(ks)
        self._init_queue(depth, data_shape, dev)
        self._plans = [
            make_plan(
                self._data_shape, (len(idx),) + tuple(ks[idx[0]].shape),
                lazy=True, device=dev, **plan_kwargs,
            )
            for idx in self._groups
        ]
        # resident per-group bank spectra, computed once
        self._kffts = tuple(
            plan.kernel_fft(torch.stack([ks[i] for i in idx]))
            for plan, idx in zip(self._plans, self._groups)
        )

    @property
    def num_groups(self) -> int:
        return len(self._groups)

    @property
    def plans(self) -> list:
        """Per-group plans (one FFT/block geometry per kernel shape)."""
        return list(self._plans)

    def _frame(self, x: torch.Tensor) -> tuple:
        return tuple(p.trace_frame(x, kf) for p, kf in zip(self._plans, self._kffts))

    def submit(self, frame) -> RaggedConvFuture:
        """Launch every group's pipeline on one frame; returns a future
        resolving to per-kernel maps in cell order (or per-kernel
        ``(values, positions)`` under a head, positions in each cell's own
        ``mode`` window). At most ``depth`` submissions are unresolved."""
        self._check_frame(frame)
        fut = self._dispatch(self._frame, frame)
        return RaggedConvFuture(fut, self._groups, self._n, len(self._data_shape) == 4)


class ShardedConvStream(_BoundedStream):
    """Bounded-depth serving over a device MESH — the reference's full
    streams design, a stream pool for latency hiding × a multi-GPU kernel
    round-robin for scale (src/cudaConvFFTDataStreams.cu:273-349), as two
    composed primitives: ``conv_spectral_sharded`` (the bank sharded over
    the mesh's kernel axis) under :class:`ConvStream`'s bounded-depth
    futures. Every rank builds the stream and submits the same frames.

    Construction computes this rank's shard of the bank spectra only and
    pins them on the mesh (``shard_kernel_bank``'s placement); the staging
    geometry comes from a lazy plan, so construction runs no throw-away
    transform, and a submit stages the frame (through the pinned ring for
    host frames) and runs the sharded call on the pinned bank::

        mesh = fc.make_mesh(data=1)
        stream = fc.ShardedConvStream(mesh, bank, frame_shape, depth=3)
        futures = [stream.submit(f) for f in frames]
        maps = [f.result() for f in futures]   # DTensors over (data, kernels)

    ``algorithm='tiled'`` runs the overlap-save engine on each rank with
    the 'same'/'valid' window — or the mode='fftmap' FFT canvas — baked
    into the block tiling; 'direct' runs the big-FFT engine. Stacked uniform
    banks only (ragged cells need per-size plans — bucket first). Each
    submit records one CUDA event on each rank.
    """

    def __init__(
        self,
        mesh,
        kernels,
        data_shape: tuple,
        *,
        depth: int = 3,
        mode: str = "same",
        algorithm: str = "tiled",
        correlation: bool = False,
        same_offset: str = "scipy",
        store_dtype: str = "float32",
        out_dtype: str | None = None,
    ):
        from cuda_fft_convolution_torch.parallel import mesh as _mesh

        validate(
            algorithm in ("tiled", "direct"),
            "algorithm must be 'tiled' or 'direct'",
        )
        dev = _mesh.mesh_device(mesh)
        validate(
            np.ndim(kernels) == 4,
            "ShardedConvStream takes a stacked uniform bank (N, Kh, Kw, F)",
        )
        self._init_queue(depth, data_shape, dev)
        self._mesh = mesh
        self._mode = mode
        self._same_offset = same_offset
        self._out_dtype = out_dtype
        # The lazy plan fixes the FFT or block geometry and the baked
        # window without running anything; its stages are never warmed.
        self._plan = make_plan(
            self._data_shape, tuple(np.shape(kernels)), algorithm=algorithm,
            mode=mode, correlation=correlation, same_offset=same_offset,
            store_dtype=store_dtype, out_dtype=out_dtype, lazy=True, device=dev,
        )
        self._sk = _mesh._shard_raw_bank(
            kernels, self._plan.fft_h, self._plan.fft_w, mesh,
            correlation=correlation, store_dtype=store_dtype,
        )

    @property
    def plan(self) -> FftConvPlan:
        return self._plan

    def _frame(self, x: torch.Tensor):
        from cuda_fft_convolution_torch.parallel.mesh import conv_spectral_sharded

        return conv_spectral_sharded(
            self._plan.data_spectra(x), self._sk, self._mesh, mode=self._mode,
            same_offset=self._same_offset, out_dtype=self._out_dtype,
        )

    def submit(self, frame) -> ConvFuture:
        """Launch one frame across the mesh; returns at once unless
        ``depth`` submissions are already in flight (then waits on the
        oldest first). The future resolves to the maps as a ``DTensor``
        sharded over (data, kernels)."""
        self._check_frame(frame)
        return self._dispatch(self._frame, frame)
