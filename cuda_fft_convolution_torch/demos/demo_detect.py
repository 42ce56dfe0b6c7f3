"""Detection demo, the torch twin of ``examples/demo_detect.py``: planted
templates recovered by ``detect_peaks`` without writing the score maps,
heterogeneous serving through ``RaggedConvStream``, multi-scale detection
on a pyramid, several instances of one template by
``detect_local_peaks``, and a ragged cell array through ``detect_peaks``.

  1. plant N templates at known positions in a noisy image;
  2. ``detect_peaks`` (per-kernel top-1 over the correlation scores; on the
     card the peaks kernel keeps one value and index a block, and the maps
     are never written) must recover every planted centre exactly, equal
     to the argmax of the full ``fft_conv`` maps;
  3. the same bank as a cell list with a 9×9 cell through
     ``RaggedConvStream`` matches the one-shot ``fft_conv`` maps;
  4. a 2x-enlarged template found at the half-resolution pyramid level;
  5. one template planted five times, all found by ``detect_local_peaks``;
  6. kernels of 9², 17² and 33² in one ``detect_peaks`` call.

    python -m cuda_fft_convolution_torch.demos.demo_detect [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import cuda_fft_convolution_torch as fc
from cuda_fft_convolution_torch.demos import check, demo_device, host
from cuda_fft_convolution_torch.models import (
    build_pyramid,
    detect_local_peaks,
    detect_peaks,
    detect_pyramid_peaks,
)
from cuda_fft_convolution_torch.models.pyramid import resize_bilinear

H, W, F = 240, 320, 2
K, N = 24, 4


def main(argv=None, device=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = parser.parse_args([] if argv is None else argv)
    dev = demo_device(device, args)
    rng = np.random.default_rng(7)
    out = {}

    # templates and a noisy scene with each template planted once
    bank = rng.standard_normal((N, K, K, F)).astype(np.float32)
    scene = 0.05 * rng.standard_normal((H, W, F)).astype(np.float32)
    planted = [(40, 60), (120, 250), (200, 30), (170, 150)]  # top-left corners
    for i, (y, x) in enumerate(planted):
        scene[y : y + K, x : x + K] += 3.0 * bank[i]
    centres = [(y + K // 2, x + K // 2) for (y, x) in planted]  # 'same' peaks
    vals, pos = detect_peaks(scene, bank, mode="same", correlation=True, device=dev)
    pos = host(pos).astype(int)
    print("peaks:", pos.tolist(), " planted centres:", centres)
    for i, c in enumerate(centres):
        check(tuple(pos[i]) == c, f"template {i}: peak {tuple(pos[i])}, planted {c}")
    maps = host(fc.fft_conv(scene, kernels=bank, mode="same", correlation=True, device=dev))
    flat = maps.reshape(N, -1).argmax(-1)
    check(np.array_equal(pos, np.stack([flat // W, flat % W], -1)),
          "peaks differ from the argmax of the maps")
    out["max_score"] = float(host(vals).max())
    print(f"peak parity vs full maps OK; max score {out['max_score']:.3f}")

    # heterogeneous serving: mixed-size cells under one stream
    cells = [bank[0], rng.standard_normal((9, 9, F)).astype(np.float32), bank[1]]
    with fc.RaggedConvStream(scene.shape, cells, depth=2, mode="same", correlation=True,
                             device=dev) as stream:
        futures = [stream.submit(scene) for _ in range(3)]
        outs = [fut.result() for fut in futures]
    # the stream's plans run the direct engine (make_plan's default): held
    # to fft_conv on the same engine by np.testing.assert_allclose(atol=
    # 2e-4)'s rule, as the JAX demo holds them
    want = fc.fft_conv(scene, kernels=cells, mode="same", correlation=True,
                       algorithm="direct", device=dev)
    out["ragged_max_abs"] = max(float(np.abs(host(g) - host(r)).max())
                                for g, r in zip(outs[-1], want))
    check(all(np.allclose(host(g), host(r), rtol=1e-7, atol=2e-4)
              for g, r in zip(outs[-1], want)),
          f"ragged serving differs by {out['ragged_max_abs']}")
    print("ragged serving matches one-shot fft_conv (3 frames, 2 shapes)")

    # multi-scale: a 2x-enlarged template found at the half-resolution level
    up = host(resize_bilinear(torch.as_tensor(bank[0]), 2 * K, 2 * K)).astype(np.float32)
    big = 0.05 * rng.standard_normal((2 * H, 2 * W, F)).astype(np.float32)
    py0, px0 = 150, 400
    big[py0 : py0 + 2 * K, px0 : px0 + 2 * K] += 3.0 * up
    det = detect_pyramid_peaks(build_pyramid(big, K, K, num_levels=3, scale=0.5, device=dev),
                               bank)
    level = int(det.best_level[0])
    by, bx = (int(c) for c in det.best_position[0])
    want_c = (py0 + K, px0 + K)
    print(f"pyramid: template 0 at level {level}, base position ({by}, {bx}), planted "
          f"centre {want_c}")
    check(level == 1, f"the 2x template won at level {level}, not 1")
    check(abs(by - want_c[0]) <= 4 and abs(bx - want_c[1]) <= 4, "pyramid position off")
    out["pyramid"] = dict(level=level, position=(by, bx))

    # one template planted five times: every instance is a local peak
    multi = 0.02 * rng.standard_normal((H, W, F)).astype(np.float32)
    spots = [(30, 40), (30, 240), (180, 40), (180, 240), (100, 140)]
    for (y, x) in spots:
        multi[y : y + K, x : x + K] += 3.0 * bank[0]
    lvals, lpos = detect_local_peaks(multi, bank[:1], k=8, window=5, mode="same",
                                     correlation=True, device=dev)
    lvals, lpos = host(lvals)[0], host(lpos)[0].astype(int)
    thr = 0.5 * lvals[0]  # half the best score separates hits from noise
    got = {tuple(p) for p in lpos[lvals > thr]}
    want_spots = {(y + K // 2, x + K // 2) for (y, x) in spots}
    check(want_spots <= got, f"local peaks {sorted(got)} miss {sorted(want_spots - got)}")
    lv2, lp2 = detect_local_peaks(multi, bank[:1], k=8, window=5, threshold=float(thr),
                                  mode="same", correlation=True, device=dev)
    lv2, lp2 = host(lv2)[0], host(lp2)[0].astype(int)
    hits = int(np.isfinite(lv2).sum())
    check({tuple(p) for p in lp2[:hits]} == want_spots, "thresholded local peaks")
    out["local_peaks"] = hits
    print(f"local peaks: all {len(spots)} instances of template 0 recovered "
          f"(thresholded slots: {hits}/8, the rest -inf)")

    # a ragged cell array straight through the head
    sizes = (9, 17, 33)
    rag = [rng.standard_normal((k, k, F)).astype(np.float32) for k in sizes]
    scene = 0.02 * rng.standard_normal((H, W, F)).astype(np.float32)
    rag_at = [(40, 50), (120, 200), (170, 60)]
    for c, (y, x) in zip(rag, rag_at):
        scene[y : y + c.shape[0], x : x + c.shape[1]] += 2.0 * c
    _, rp = detect_peaks(scene, rag, mode="same", correlation=True, device=dev)
    rp = host(rp).astype(int)
    for i, (c, (y, x)) in enumerate(zip(rag, rag_at)):
        want_p = (y + (c.shape[0] - 1) // 2, x + (c.shape[1] - 1) // 2)
        check(tuple(rp[i]) == want_p, f"ragged cell {i}: {tuple(rp[i])}, planted {want_p}")
    print(f"ragged cells: {len(rag)} sizes {sizes} each found at its planted centre "
          "through one detect_peaks call")
    print("demo_detect OK")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
