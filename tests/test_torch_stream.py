"""The port's serving streams against the JAX package's
(``cuda_fft_convolution_tpu/runtime/stream.py``), on the CPU at the JAX
tests' own shapes (``tests/test_stream.py``, every test that needs no
mesh): each stream's results hold the JAX stream's on the same numpy frames
within 1e-5 scale-relative, with the JAX tests' own checks — equality with
the synchronous plan, the depth bound, FIFO resolution, bank updates,
validation, the ragged cell array and the detection heads. On the CPU a
submission's work is done when ``submit`` returns; ``tests/test_torch_gpu.py``
checks the CUDA events on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_fft_convolution_torch as tfc
import cuda_fft_convolution_tpu as jfc
from tests.oracles import fft_conv_full_f64, rel_err

TOL = 1e-5
CPU = dict(device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _scaled(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_stream_matches_plan(rng):
    """submit/result ≡ plan.execute frame by frame (bitwise: the same
    stages on the same inputs), and ≡ the JAX stream."""
    kerns = rng.standard_normal((3, 5, 5, 2)).astype(np.float32)
    frames = [rng.standard_normal((24, 20, 2)).astype(np.float32) for _ in range(4)]
    stream = tfc.ConvStream.create((24, 20, 2), kerns, depth=2, **CPU)
    jstream = jfc.ConvStream.create((24, 20, 2), kerns, depth=2)
    futs = [stream.submit(f) for f in frames]
    jfuts = [jstream.submit(f) for f in frames]
    for f, fut, jfut in zip(frames, futs, jfuts):
        assert torch.equal(fut.result(), stream.plan.execute(f, kerns))
        assert _scaled(fut.result(), jfut.result()) < TOL
    stream.flush()


def test_stream_oracle_full_mode(rng):
    kerns = rng.standard_normal((2, 6, 6, 1)).astype(np.float32)
    frame = rng.standard_normal((40, 40, 1)).astype(np.float32)
    with tfc.ConvStream.create(
        (40, 40, 1), kerns, algorithm="tiled", mode="full", depth=1, **CPU
    ) as stream:
        got = _np(stream.submit(frame).result())
    assert got.shape == (2, 45, 45)
    for i in range(2):
        assert rel_err(got[i], fft_conv_full_f64(frame, kerns[i])) < TOL
    with jfc.ConvStream.create((40, 40, 1), kerns, algorithm="tiled", mode="full",
                               depth=1) as jstream:
        assert _scaled(got, jstream.submit(frame).result()) < TOL


def test_stream_depth_bound(rng):
    """Never more than `depth` unresolved futures; over-submitting resolves
    the OLDEST first — the same resolution pattern as the JAX stream."""
    kerns = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    pattern = []
    for stream in (tfc.ConvStream.create((16, 16, 1), kerns, depth=2, **CPU),
                   jfc.ConvStream.create((16, 16, 1), kerns, depth=2)):
        futs = []
        for _ in range(5):
            futs.append(stream.submit(np.zeros((16, 16, 1), np.float32)))
            assert stream.inflight <= 2
        pattern.append([f.done() for f in futs])
        stream.flush()
        assert stream.inflight == 0
        assert all(f.done() for f in futs)
    assert pattern[0] == pattern[1] == [True, True, True, False, False]


def test_stream_map_order_and_flush(rng):
    kerns = rng.standard_normal((1, 3, 3, 1)).astype(np.float32)
    frames = [np.full((12, 12, 1), i, np.float32) for i in range(1, 5)]
    with tfc.ConvStream.create((12, 12, 1), kerns, depth=3, **CPU) as stream:
        maps = stream.map(frames)
        assert stream.inflight == 0
    ksum = float(kerns.sum())
    for i, m in enumerate(maps, start=1):
        assert abs(float(m[0, 4, 4]) - ksum * i) < 1e-4 * abs(ksum * i) + 1e-5
    with jfc.ConvStream.create((12, 12, 1), kerns, depth=3) as jstream:
        for m, jm in zip(maps, jstream.map(frames)):
            assert _scaled(m, jm) < TOL


def test_stream_update_kernels(rng):
    """Model update: new bank spectra, same plan; a (re, im) spectra pair
    from plan.kernel_fft is accepted too."""
    k1 = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    k2 = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    frame = rng.standard_normal((16, 16, 1)).astype(np.float32)
    stream = tfc.ConvStream.create((16, 16, 1), k1, depth=1, **CPU)
    out1 = stream.submit(frame).result()
    stream.update_kernels(k2)
    out2 = stream.submit(frame).result()
    assert torch.equal(out2, stream.plan.execute(frame, k2))
    assert not torch.allclose(out1, out2)
    stream.update_kernels(stream.plan.kernel_fft(k1))
    assert torch.equal(stream.submit(frame).result(), out1)
    jstream = jfc.ConvStream.create((16, 16, 1), k1, depth=1)
    jstream.update_kernels(k2)
    assert _scaled(out2, jstream.submit(frame).result()) < TOL


def test_stream_validation(rng):
    kerns = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    with pytest.raises(ValueError):
        tfc.ConvStream.create((16, 16, 1), kerns, depth=0, **CPU)
    stream = tfc.ConvStream.create((16, 16, 1), kerns, depth=1, **CPU)
    with pytest.raises(ValueError):
        stream.submit(np.zeros((8, 16, 1), np.float32))
    with pytest.raises(ValueError):
        stream.update_kernels(np.zeros((2, 5, 5, 1), np.float32))


def test_stream_result_idempotent(rng):
    kerns = rng.standard_normal((1, 3, 3, 1)).astype(np.float32)
    stream = tfc.ConvStream.create((12, 12, 1), kerns, depth=1, **CPU)
    fut = stream.submit(np.ones((12, 12, 1), np.float32))
    a = fut.result()
    assert fut.result() is a
    assert fut.done()


def test_stream_update_kernels_rejects_foreign_spectra_pair(rng):
    """A (re, im) pair of another geometry or store dtype is rejected at
    update time."""
    kerns = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    stream = tfc.ConvStream.create((16, 16, 1), kerns, depth=1, **CPU)
    other = tfc.ConvStream.create((32, 32, 1), kerns, depth=1, **CPU)
    with pytest.raises(ValueError, match="planned"):
        stream.update_kernels(other.plan.kernel_fft(kerns))
    bf = tfc.ConvStream.create((16, 16, 1), kerns, depth=1, store_dtype="bfloat16", **CPU)
    with pytest.raises(ValueError, match="planned"):
        bf.update_kernels(stream.plan.kernel_fft(kerns))
    bf.update_kernels(bf.plan.kernel_fft(kerns))
    frame = rng.standard_normal((16, 16, 1)).astype(np.float32)
    got = bf.submit(frame).result()
    assert got.shape[0] == 2
    jbf = jfc.ConvStream.create((16, 16, 1), kerns, depth=1, store_dtype="bfloat16")
    assert _scaled(got, jbf.submit(frame).result()) < 2e-2


def test_plan_tiled_fftmap_matches_direct(rng):
    """Tiled plans serve mode='fftmap' by baking the FFT canvas: the raw
    maps equal the direct engine's, as the JAX plan's do."""
    kerns = rng.standard_normal((3, 6, 6, 2)).astype(np.float32)
    data = rng.standard_normal((48, 40, 2)).astype(np.float32)
    got = tfc.make_plan((48, 40, 2), (3, 6, 6, 2), algorithm="tiled", mode="fftmap",
                        **CPU).execute(data, kerns)
    want = tfc.fft_conv(data, kernels=kerns, mode="fftmap", algorithm="direct",
                        policy=tfc.FftSizePolicy.FAST, **CPU)
    assert _scaled(got, want) < TOL
    jgot = jfc.make_plan((48, 40, 2), (3, 6, 6, 2), algorithm="tiled",
                         mode="fftmap").execute(data, kerns)
    assert _scaled(got, jgot) < TOL


def test_stream_tiled_fftmap(rng):
    kerns = rng.standard_normal((2, 5, 5, 1)).astype(np.float32)
    frames = [rng.standard_normal((36, 36, 1)).astype(np.float32) for _ in range(3)]
    kw = dict(depth=2, algorithm="tiled", mode="fftmap", policy="fast")
    with tfc.ConvStream.create((36, 36, 1), kerns, **kw, **CPU) as stream:
        got = stream.map(frames)
    with jfc.ConvStream.create((36, 36, 1), kerns, **kw) as jstream:
        jgot = jstream.map(frames)
    for f, g, jg in zip(frames, got, jgot):
        want = tfc.fft_conv(f, kernels=kerns, mode="fftmap", algorithm="direct",
                            policy="fast", **CPU)
        np.testing.assert_allclose(_np(g), _np(want), atol=1e-5)
        assert _scaled(g, jg) < TOL


def test_ragged_stream_matches_fft_conv_buckets(rng):
    """Per-shape groups served through their own plans match fft_conv's
    bucketed one-shot output, in cell order, and the JAX stream."""
    cells = [
        rng.standard_normal((8, 8, 1)).astype(np.float32),
        rng.standard_normal((64, 64, 1)).astype(np.float32),
        rng.standard_normal((8, 8, 1)).astype(np.float32),
        rng.standard_normal((5, 5, 1)).astype(np.float32),
    ]
    frames = [rng.standard_normal((80, 80, 1)).astype(np.float32) for _ in range(3)]
    kw = dict(depth=2, algorithm="direct", mode="same")
    with tfc.RaggedConvStream((80, 80, 1), cells, **kw, **CPU) as stream:
        got = stream.map(frames)
        assert stream.num_groups == 3  # 8², 64², 5² shape groups
        assert len(stream.plans) == 3
    with jfc.RaggedConvStream((80, 80, 1), cells, **kw) as jstream:
        jgot = jstream.map(frames)
    for f, maps, jmaps in zip(frames, got, jgot):
        want = tfc.fft_conv(f, kernels=cells, mode="same", algorithm="direct", **CPU)
        assert isinstance(maps, list) and len(maps) == len(cells)
        for g, w, jg in zip(maps, want, jmaps):
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-4)
            assert _scaled(g, jg) < TOL


def test_ragged_stream_future_join_and_validation(rng):
    cells = [
        rng.standard_normal((4, 4, 2)).astype(np.float32),
        rng.standard_normal((16, 16, 2)).astype(np.float32),
    ]
    stream = tfc.RaggedConvStream((30, 30, 2), cells, depth=1, mode="full", **CPU)
    frame = rng.standard_normal((30, 30, 2)).astype(np.float32)
    fut = stream.submit(frame)
    maps = fut.result()
    assert fut.done()
    assert tuple(maps[0].shape) == (33, 33) and tuple(maps[1].shape) == (45, 45)
    want = tfc.fft_conv(frame, kernels=cells, mode="full", algorithm="direct", **CPU)
    jmaps = jfc.RaggedConvStream((30, 30, 2), cells, depth=1, mode="full").submit(
        frame).result()
    for g, w, jg in zip(maps, want, jmaps):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4)
        assert _scaled(g, jg) < TOL
    stream.flush()
    with pytest.raises(tfc.InvalidInputError):
        tfc.RaggedConvStream((30, 30, 2), [], depth=1, **CPU)
    with pytest.raises(tfc.InvalidInputError):
        tfc.RaggedConvStream(
            (30, 30, 2), [rng.standard_normal((4, 4)).astype(np.float32)], **CPU
        )


@pytest.mark.parametrize("algorithm", ["direct", "tiled"])
def test_plan_head_peaks_and_top_k(rng, algorithm):
    """Heads in plans: (values, positions) equal to the reduction of the
    maps plan's output and to the JAX plan's heads."""
    from cuda_fft_convolution_torch.ops.tiled import peaks_from_maps, top_k_from_maps

    kerns = rng.standard_normal((3, 5, 7, 2)).astype(np.float32)
    frame = rng.standard_normal((40, 44, 2)).astype(np.float32)
    kw = dict(algorithm=algorithm, mode="same")
    maps = tfc.make_plan((40, 44, 2), kerns.shape, **kw, **CPU).execute(frame, kerns)
    wv, wy, wx = peaks_from_maps(maps[None])
    plan = tfc.make_plan((40, 44, 2), kerns.shape, head="peaks", **kw, **CPU)
    assert plan.head == "peaks"
    vals, pos = plan.execute(frame, kerns)
    np.testing.assert_allclose(_np(vals), _np(wv[0]), rtol=1e-5)
    assert torch.equal(pos, torch.stack([wy[0], wx[0]], -1))
    jvals, jpos = jfc.make_plan((40, 44, 2), kerns.shape, head="peaks", **kw).execute(
        frame, kerns)
    assert _scaled(vals, jvals) < TOL
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    # top_k, batched
    bframe = rng.standard_normal((2, 40, 44, 2)).astype(np.float32)
    bmaps = tfc.make_plan((2, 40, 44, 2), kerns.shape, algorithm=algorithm, mode="valid",
                          **CPU).execute(bframe, kerns)
    wv, wy, wx = top_k_from_maps(bmaps, 4)
    tkw = dict(algorithm=algorithm, mode="valid", head="top_k", head_k=4)
    vals, pos = tfc.make_plan((2, 40, 44, 2), kerns.shape, **tkw, **CPU).execute(
        bframe, kerns)
    assert tuple(vals.shape) == (2, 3, 4) and tuple(pos.shape) == (2, 3, 4, 2)
    np.testing.assert_allclose(_np(vals), _np(wv), rtol=1e-5)
    assert torch.equal(pos, torch.stack([wy, wx], -1))
    jvals, jpos = jfc.make_plan((2, 40, 44, 2), kerns.shape, **tkw).execute(bframe, kerns)
    assert _scaled(vals, jvals) < TOL
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    with pytest.raises(tfc.InvalidInputError):
        tfc.make_plan((40, 44, 2), kerns.shape, mode="fftmap", head="peaks", **CPU)
    with pytest.raises(tfc.InvalidInputError):
        tfc.make_plan((40, 44, 2), kerns.shape, mode="same", head="argmax", **CPU)


def test_stream_head_serving(rng):
    """A local-peaks head recovers planted templates, equal to
    detect_local_peaks and to the JAX stream."""
    from cuda_fft_convolution_torch.models import detect_local_peaks

    templ = rng.standard_normal((2, 9, 9, 1)).astype(np.float32)
    frames = []
    spots = [(10, 12), (40, 50)]
    for _ in range(3):
        f = 0.02 * rng.standard_normal((64, 64, 1)).astype(np.float32)
        for t, (y, x) in zip(templ, spots):
            f[y:y + 9, x:x + 9] += 2.0 * t
        frames.append(f)
    kw = dict(depth=2, mode="same", correlation=True, head="local_peaks", head_k=4,
              head_window=5)
    with tfc.ConvStream.create((64, 64, 1), templ, **kw, **CPU) as stream:
        futs = [stream.submit(f) for f in frames]
    with jfc.ConvStream.create((64, 64, 1), templ, **kw) as jstream:
        jfuts = [jstream.submit(f) for f in frames]
    for f, fut, jfut in zip(frames, futs, jfuts):
        vals, pos = fut.result()
        assert tuple(vals.shape) == (2, 4) and tuple(pos.shape) == (2, 4, 2)
        want_v, want_p = detect_local_peaks(f, templ, k=4, window=5, mode="same",
                                            correlation=True, **CPU)
        np.testing.assert_allclose(_np(vals), _np(want_v), rtol=1e-4)
        assert torch.equal(pos, want_p)
        for i, (y, x) in enumerate(spots):
            assert tuple(pos[i, 0].tolist()) == (y + 4, x + 4)
        jvals, jpos = jfut.result()
        assert _scaled(vals, jvals) < TOL
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


def test_ragged_stream_head_serving(rng):
    """A ragged stream under a head: per-cell (values, positions) in cell
    order, each equal to its own detection and to the JAX stream's."""
    from cuda_fft_convolution_torch.models import detect_peaks

    cells = [
        rng.standard_normal((5, 5, 1)).astype(np.float32),
        rng.standard_normal((11, 11, 1)).astype(np.float32),
        rng.standard_normal((5, 5, 1)).astype(np.float32),
    ]
    frame = rng.standard_normal((48, 48, 1)).astype(np.float32)
    kw = dict(depth=1, mode="same", correlation=True, head="peaks")
    with tfc.RaggedConvStream((48, 48, 1), cells, **kw, **CPU) as stream:
        res = stream.submit(frame).result()
    assert len(res) == 3
    want_v, want_p = detect_peaks(frame, cells, mode="same", correlation=True, **CPU)
    jres = jfc.RaggedConvStream((48, 48, 1), cells, **kw).submit(frame).result()
    for i, ((v, p), (jv, jp)) in enumerate(zip(res, jres)):
        assert v.shape == () and tuple(p.shape) == (2,)
        np.testing.assert_allclose(_np(v), _np(want_v[i]), rtol=1e-4)
        assert torch.equal(p, want_p[i])
        np.testing.assert_allclose(_np(v), np.asarray(jv), rtol=1e-5)
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


def test_fifo_clock_marks_earlier_futures_done(rng):
    """Resolving a LATER future marks every earlier one complete without
    resolving their own completion handles: the same done() pattern as the
    JAX stream, at each step."""
    bank = rng.standard_normal((2, 4, 4, 1)).astype(np.float32)
    frame = rng.standard_normal((24, 24, 1)).astype(np.float32)
    kw = dict(depth=8, algorithm="direct", mode="same")
    patterns = []
    for stream in (tfc.ConvStream.create((24, 24, 1), bank, **kw, **CPU),
                   jfc.ConvStream.create((24, 24, 1), bank, **kw)):
        futs = [stream.submit(frame) for _ in range(5)]
        steps = [[f.done() for f in futs]]
        futs[-1].result()
        steps.append([f.done() for f in futs])
        assert all(not f._done for f in futs[:-1])  # implied, not resolved
        for f in futs[:-1]:
            assert _scaled(f.result(), futs[-1].result()) < 1e-6
        f6 = stream.submit(frame)
        steps.append([f6.done()])
        stream.flush()
        steps.append([f6.done()])
        patterns.append(steps)
    assert patterns[0] == patterns[1]
    assert patterns[0] == [[False] * 5, [True] * 5, [False], [True]]


def test_stream_needs_a_device_or_cpu(rng):
    """Without a card a stream asks for device='cpu' (the port's device
    rule): nothing moves to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the stream takes it")
    kerns = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    with pytest.raises(tfc.InvalidInputError, match="device='cpu'"):
        tfc.ConvStream.create((16, 16, 1), kerns)
    with pytest.raises(tfc.InvalidInputError, match="device='cpu'"):
        tfc.RaggedConvStream((16, 16, 1), [kerns[0]])
