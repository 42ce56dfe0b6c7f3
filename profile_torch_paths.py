#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's paths on one CUDA GPU.

    python3 profile_torch_paths.py [--seed 0] [--calls 3]

Run from the repository root on the machine ``chip_smoke.py`` runs on. It
builds the detection headline's inputs with ``chip_smoke.detection_headline``
(a 2048² image holding each of 100 64² kernels once; the call also checks
the detection heads), then runs ``torch.profiler`` over ``--calls`` calls
each of ``detect_peaks``, the maps path (``fft_conv`` + ``peaks_from_maps``),
the fused ``fft_conv`` and the direct ``fft_conv``, the fused ``fft_conv`` at
the bf16 tier, and the DPM/HOG config's calls at the tier on
``chip_smoke.dpm_inputs`` (``conv_spectral`` with float32 and with bf16
maps, and the one-shot ``detect_peaks``). For each path it prints
the device's busy time per call (the union of the GPU kernel and copy spans)
against the profiled span, their difference as the idle share, and the
kernels with the most self device time. Then the same for the DPM giant
bank's direct ``conv_spectral`` (576 filters resident at the tier), the
ragged cell array's ``fft_conv`` and its ``RaggedConvStream`` (BASELINE
configs[1]), and the headline ``ConvStream`` at depth 1 and 3 over 16 host
frames, per frame: the serving loop's idle share. Then the model layer on
``chip_smoke``'s inputs: ``detect_pyramid_peaks`` of the DPM pyramid (1024
filters, 5 levels), a ``train_step`` of the filter-bank detector (8 frames,
64 filters) and a frame of the MOSSE tracker on HOG cells.

    python3 profile_torch_paths.py --ab-parent PARENT/cuda_fft_convolution_torch/csrc

instead builds the fused maps and peaks kernels of a parent checkout's
``csrc`` (one whose C entries take the launch-order argument and this
tree's operands, ``_kernel_mats``: G^T, G and M^T's planes chunk by chunk)
beside this tree's entries and times both in turns —
parent, this tree, this tree, parent, CUDA events, median of 7, each side a
bare call of its C entry — at the headline plan (float32 at every tier:
3×TF32, 6×TF32 and one pass; bf16 spectra at BF16IO; maps and peaks), at the DPM
plan (bf16 spectra at BF16IO and at the 3×TF32 entries, maps and peaks,
and the same planes upcast to float32 at the three fp32 tiers) and at the
F=8 tier's plan (BF16IO maps and peaks), printing how far the outputs differ and each side's error
against the plain version; at JAX's
F=1 radix plan (256, 512, 65, 129) on the headline image, N=100, it times
each radix body's maps entry at 3×TF32 and BF16IO in turns. Before that it
holds every C entry the parent has (its v3, radix, forms and radix forms
libraries, each built from its sources) against this tree's on random
planes (``every_entry_bitwise``; an entry from whichever of the parent's
libraries holds it): the v3 entries and the Karatsuba and v2 ones
(``_k``, ``_v2``, ``_v2_k``) at ``chip_smoke``'s kernel-check
geometries, the radix entries in both forms at step 36's plans, failing
on any difference but where this tree pairs a radix body and the parent
ran 32-row tiles (``moved``; those print their distance from the parent);
then it times those moved entries in turns at step 36's plans on the
headline image (``wide_turns``), the paired entries of v4 and v3 of the
same tier beside each, and every v2 entry in turns at five plans
(``v2_turns``: the headline, JAX's F=1, the 512², the DPM and the F=8
plans), v3's entry of the same tier and form, the plain version and the
bounds beside each, into ``chiprun_out/v2_turns.json``.

    python3 profile_torch_paths.py --v2-plans

times this tree's v2 entries alone the same way (``chiprun_out/
v2_plans.json``).

    python3 profile_torch_paths.py --wide-split CSRC

instead splits the wide configuration's time (the v3 kernels where the
64-row X does not fit: the large-kernel plan (1023, 1024, 512, 512) of 16
kernels of 512² on the 2048² headline image) into its stages, as
``--stacked-split`` does (``WIDE_SPLIT_PATCHES``: no W stage, no H stage, no
MAC loads, no H products, no fifth passes (the parent's 32-row design) or
no remote X reads (the paired design: each rank reads its own half twice),
no epilogue stores), for the 3×TF32 f32 maps and peaks entries and the
BF16IO maps entry, CUDA events, median of 7. A parent's csrc (its 32-row
tiles) gets the operands of that layout.

    python3 profile_torch_paths.py --radix-split CSRC

splits the radix bodies' time (v4, v5, v5x) the same way at JAX's F=1
plan on the headline image (N=100) at 6×TF32, the maps entry in both
H-stage forms and the peaks entry of each (``RADIX_SPLIT_PATCHES``: no W
stage, no H stage, no MAC loads, no H products, no one-bin passes — the
32-row design's passes that hold the last bin alone —, no remote X — the
pair's W stage reading its own half twice, not the partner's —, no
Nyquist H sums, no Nyquist W term, no epilogue stores), each entry marked
with the design the csrc runs it in (``parent_paired_bodies``); a variant
that touches no code of an entry's design reads the whole kernel's time.

    python3 profile_torch_paths.py --submit-probe

instead times, on the host's clock, a headline ``ConvStream`` submit (a
2048² host frame into a queue with room, depth 3, as ``chip_smoke.py``
times it) and the copy that stages such a frame into a pinned buffer, by
``torch``'s ``copy_`` (every intra-op thread) and by numpy's one-thread
``copyto``, with 0, 2, 4 and 8 busy-looping processes beside it on the
host's cores (median and worst of 32 each; the busy processes are stopped
before it returns). ``--soak SECONDS`` then repeats the smoke's submit
trial for that long, each followed by three host canaries (a fixed Python
loop, ``torch.cuda.mem_get_info``, the staging copy), and prints the
spread, the worst median of 8 consecutive trials (the smoke's statistic),
the caching allocator's retries, and for the submits over 3.5 ms the
garbage collector's time in them and where the main thread was after 4 ms
(sampled from a second thread), then the slowest trials.

    python3 profile_torch_paths.py --bf16io-witness

instead reads where the BF16IO maps entry (bf16 spectra's default tier)
parts from its plain version, at the DPM plan (``chip_smoke.dpm_inputs``,
1024 filters) and at the headline plan (8 of 64² kernels on a 2048² image
from ``--seed``): (a) the block of the largest error, how evenly the error
covers its tile, the bins of S there nearest a bf16 rounding boundary and
the bins of X in its row whose other rounding best explains the error,
each rounded the other way in turn in the plain version, with the error
against the kernel after the flip; (b) the plain version with every
product and sum in float64 (rounded to bf16 where the tier rounds) against
the float32 one and against the kernel; (c) the plain version with a
rounding left out (of S, of X, of G and M, of all three) and the 3xTF32
entry against the BF16IO plain version, in root mean square beside
``chip_smoke.IO_RMS_TOL``. It writes the numbers to
``chiprun_out/bf16io_witness.json``.

    python3 profile_torch_paths.py --stacked-split CSRC

instead splits the stacked configuration's time into its stages: it
copies the ``csrc`` at CSRC (this tree's, or a parent's unpacked with
``git archive``) into ``build/stacked_split/<variant>``, patches each copy
so that one stage does no work (``SPLIT_PATCHES``: the W stage, the H
stage, the H stage's copies, everything of the H stage but its copies, its
products, the epilogue's stores), builds the BF16IO maps and peaks entries
of each copy (one nvcc a copy, all started together), and times the bare
entries at the DPM plan (``chip_smoke.dpm_inputs``, N = 1024) and the F=8
plan (random planes, N = 64), CUDA events, median of 7. A patched copy
computes wrong maps; only its time is read.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import sys

import chip_smoke


def busy_and_span(events) -> tuple[float, float]:
    """(union of the device spans, first start to last end), in µs."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not spans:
        return 0.0, 0.0
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0]


def report(label, fn, calls, frames=1) -> None:
    """Profile ``calls`` calls of ``fn`` (after one warm-up) and print the
    device's busy time and span per unit — a call, or a frame when each
    call serves ``frames`` frames — the idle share, and the kernels with
    the most self device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy, span = busy_and_span(
        [e for e in prof.events() if e.device_type == DeviceType.CUDA])
    if span == 0:
        raise AssertionError(f"{label}: the profiler saw no device work")
    units, unit = calls * frames, "frame" if frames > 1 else "call"
    print(f"== {label}: device busy {busy / units / 1e3:.3f} of "
          f"{span / units / 1e3:.3f} ms per {unit}, idle share "
          f"{100 * (1 - busy / span):.1f}%")
    rows = sorted(prof.key_averages(), key=lambda a: -a.self_device_time_total)
    for a in rows[:8]:
        if a.self_device_time_total > 0:
            print(f"   {a.self_device_time_total / units / 1e3:8.3f} ms  "
                  f"x{a.count / units:<5.3g} {a.key[:90]}")


def serve(stream, frames):
    """One pass of ``frames`` through ``stream``: every frame submitted,
    then a flush."""
    for f in frames:
        stream.submit(f)
    stream.flush()


def build_parent(csrc: pathlib.Path, radix: bool = True):
    """The parent's maps and peaks kernels, built from ``csrc`` into
    ``build/parent_ab`` with this tree's nvcc flags, every nvcc started
    together → (the loaded library of the v3 entries — every unit but the
    MAC's and the other libraries' —, that of the radix bodies' entries,
    that of the Karatsuba and v2 entries, that of the radix bodies'
    Karatsuba entries; the radix ones not built without ``radix``), each
    None where the parent has none)."""
    from cuda_fft_convolution_torch import _build

    out = _build.BUILD_DIR / "parent_ab"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    others = (*_build._RADIX_UNITS, *_build._FORM_UNITS, *_build._RADIX_FORM_UNITS,
              "spectral_mac.cu")
    units = {"libparent.so": tuple(u.stem for u in sorted(csrc.glob("*.cu")) if u.name not in others),
             "libparent_radix.so": tuple(u.removesuffix(".cu") for u in _build._RADIX_UNITS
                                         if radix and (csrc / u).exists()),
             "libparent_forms.so": tuple(u.removesuffix(".cu") for u in _build._FORM_UNITS
                                         if (csrc / u).exists()),
             "libparent_radix_forms.so": tuple(u.removesuffix(".cu")
                                               for u in _build._RADIX_FORM_UNITS
                                               if radix and (csrc / u).exists())}
    objs = {lib: [out / f"{name}.o" for name in names] for lib, names in units.items()}
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", str(csrc / f"{o.stem}.cu"),
                               "-o", str(o)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for lib_objs in objs.values() for o in lib_objs]
    for proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's sources:\n{log}")
    libs = []
    for name, lib_objs in objs.items():
        if not lib_objs:
            libs.append(None)
            continue
        subprocess.run([nvcc, *_build.LINK_FLAGS, "-o", str(out / name), *map(str, lib_objs)],
                       check=True)
        lib = ctypes.CDLL(str(out / name))
        # this tree's signatures, for every entry the parent has
        for entry, (argtypes, restype) in {**_build._SIGNATURES, **_build._V2_SIGNATURES,
                                           **_build._RADIX_SIGNATURES,
                                           **_build._FORM_SIGNATURES,
                                           **_build._RADIX_FORM_SIGNATURES}.items():
            if entry.startswith("fftconv_block_conv") and hasattr(lib, entry):
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = restype
        libs.append(lib)
    return tuple(libs)


def bare_entry(lib, name, ops, geom, body="v3", layout=None):
    """The C entry ``name`` (a maps or peaks entry of any tier, body and
    H-stage form: ``body`` names the body, the ``_k`` suffix the Karatsuba
    form) of ``lib`` on ``ops`` at ``geom``, with this tree's operands of
    its tier, body and form, the wrappers' launch order and no wrapper
    around it (a wrapper's host checks would show in a one-call CUDA-event
    window) → its outputs: maps (B, N, out_h, out_w), or the partial
    pyramid (vals, idxs) (B, N, nbh, row chunks, nbw). ``layout`` (rows,
    pair bins) overrides this tree's configuration of the operands
    (``kernel_layout``): (32, 0) for a parent that runs the wide blocks on
    32-row tiles. Raises where the entry refuses the launch."""
    import torch

    from cuda_fft_convolution_torch.ops import block_conv as bc

    b, nbh, nbw, f, lh, wc = ops[0].shape
    n = ops[2].shape[0]
    bh, bw, kh, kw, out_h, out_w = geom
    vh, vw = bh - kh + 1, bw - kw + 1
    dev = ops[0].device
    kara = name.endswith("_k")
    stem = name.removesuffix(bc.body_suffix(body, kara))
    splits = next((t for t, sfx in bc.TIER_SUFFIX.items() if sfx and stem.endswith(sfx)), 3)
    rows, half = layout or bc.kernel_layout(body, wc, vh, splits, kara)
    chunks = (-(-vh // rows) if body in ("v3", "v2") else sum(bc.radix_chunks(lh, vh, rows)))
    chunks *= bc.PAIR if half else 1
    mats = bc._kernel_mats(bh, bw, kh, kw, str(dev), splits, rows, half)
    m_tc, radix = bc._radix_args(ops, bh, bw, kh, kw, str(dev), splits, body, mats[3], rows)
    if "_peaks_" in name:
        outs = (torch.empty((b, n, nbh, chunks, nbw), device=dev),
                torch.empty((b, n, nbh, chunks, nbw), dtype=torch.int32, device=dev))
    else:
        dt = torch.bfloat16 if "_bf16maps" in name else torch.float32
        outs = (torch.empty((b, n, out_h, out_w), dtype=dt, device=dev),)
    err = getattr(lib, name)(
        *(t.data_ptr() for t in (*ops, *mats[:3], m_tc)), *bc._ptrs(radix),
        *(t.data_ptr() for t in outs), b, nbh, nbw, f, n, lh, wc, vh, vw, out_h, out_w,
        bc.kernel_tile(wc, vh, ops[2], splits), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} refused the launch: cudaError {err}")
    return outs


def refused_or(call):
    """``call()``, or None where its C entry refused the launch."""
    try:
        return call()
    except RuntimeError:
        return None


RADIX_AB_PLANS = [(1, 1, 3, 256, 512, 65, 129, 400, 800, "JAX F=1 plan"),
                  (1, 2, 3, 128, 512, 33, 129, 200, 800, "JAX 32² plan"),
                  (1, 1, 2, 256, 1024, 65, 129, 400, 1800, "W 1024")]


RADIX_BODY_SUFFIXES = (("v5x", "_r5x"), ("v5", "_r5"), ("v4", "_r4"))


def _entry_body(name: str) -> str:
    """The body a C entry's suffix names ('v3' for none)."""
    stem = name.removesuffix("_k")
    return next((bd for bd, sfx in (("v2", "_v2"), *RADIX_BODY_SUFFIXES) if stem.endswith(sfx)),
                "v3")


def parent_paired_bodies(csrc: pathlib.Path) -> tuple:
    """The radix bodies a csrc runs in the cluster pair where v3 pairs: all
    three in this tree's design, v4 alone in the design before it, none in
    the first pair design (its radix bodies ran 32-row tiles there)."""
    text = (csrc / "block_conv.cuh").read_text()
    if "BODY == kV3 || radix_body(BODY)" in text:
        return ("v4", "v5", "v5x")
    return ("v4",) if "BODY == kV3 || BODY == kV4" in text else ()


def moved(body: str, wc: int, vh: int, tier: int, kara: bool, parent_paired: tuple) -> bool:
    """Whether this tree pairs a radix body's entry where the parent ran
    32-row tiles (``parent_paired``: the bodies the parent pairs)."""
    from cuda_fft_convolution_torch.ops import block_conv as bc

    return (body in ("v4", "v5", "v5x") and body not in parent_paired
            and bc.kernel_layout(body, wc, vh, tier, kara)[1] > 0)


def parent_entry(parent_libs, name: str):
    """The parent's library that holds the C entry ``name`` (the unit
    lists are this tree's: an entry may sit in another library there), or
    None."""
    return next((lib for lib in parent_libs if lib is not None and hasattr(lib, name)), None)


def every_entry_bitwise(parent_libs, seed: int, parent_paired: tuple = ()) -> None:
    """Every C entry the parent has against this tree's on random planes
    from ``seed``: the v3 library's maps and peaks entries and v2's
    (``_v2``), and the forms library's (``_k``, ``_v2_k``) at
    ``chip_smoke``'s kernel-check
    geometries (every configuration: 64 rows, paired, 32 rows, stacked, 31
    row chunks), the radix library's and the radix forms library's (the
    Karatsuba form, ``_r*_k``) at step 36's three plans (each body where
    its rules take the plan). Each must be bitwise the parent's — an entry
    both sides refuse counts as equal, any other difference fails — but the
    radix entries this tree pairs where the parent ran 32-row tiles
    (``moved``: the bodies ``parent_paired`` leaves out, where
    ``kernel_layout`` pairs; the parent gets the 32-row operands), which are
    printed with their distance from the parent (largest difference
    relative to the parent's largest value; for the peaks, of the reduced
    pyramid, and the index flips)."""
    import numpy as np
    import torch

    from cuda_fft_convolution_torch import _build
    from cuda_fft_convolution_torch.ops import block_conv as bc

    rng = np.random.default_rng(seed)
    this = (_build.library(), _build.library(radix=True), _build.library(forms=True),
            _build.library(radix=True, forms=True))
    entries = [n for n, sig in {**_build._SIGNATURES, **_build._V2_SIGNATURES}.items()
               if n.startswith("fftconv_block_conv") and len(sig[0]) > 3]
    forms = [n for n, sig in _build._FORM_SIGNATURES.items()
             if n.startswith("fftconv_block_conv") and len(sig[0]) > 4]
    equal = refused = total = 0
    bad, shifted = [], []
    for geoms, libs, names in (
        (chip_smoke.CHECK_GEOMETRIES, (parent_libs[0], this[0]), entries),
        (chip_smoke.CHECK_GEOMETRIES, (parent_libs[2], this[2]), forms),
        (RADIX_AB_PLANS, (parent_libs[1], this[1]), list(_build._RADIX_SIGNATURES)),
        (RADIX_AB_PLANS, (parent_libs[3], this[3]), list(_build._RADIX_FORM_SIGNATURES)),
    ):
        if libs[0] is None:
            print(f"every entry: the parent has no library of {names[0]}..")
            continue
        for b, f, n, bh, bw, kh, kw, out_h, out_w, label in geoms:
            vh, vw = bh - kh + 1, bw - kw + 1
            nbh, nbw, wc = -(-out_h // vh), -(-out_w // vw), bw // 2 + 1

            def t(*shape):
                return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                                       device="cuda")

            ops = (t(b, nbh, nbw, f, bh, wc), t(b, nbh, nbw, f, bh, wc), t(n, f, bh, wc),
                   t(n, f, bh, wc))
            ops16 = tuple(x.to(torch.bfloat16) for x in ops)
            geom = (bh, bw, kh, kw, out_h, out_w)
            for name in names:
                body = _entry_body(name)
                kara = name.endswith("_k")
                if body in ("v5", "v5x") and not bc.radix_w_legal(bw, kw, vw):
                    continue
                planes = ops16 if "_bf16" in name.replace("_bf16maps", "") else ops
                stem = name.removesuffix(bc.body_suffix(body, kara))
                tier = next((t_ for t_, sfx in bc.TIER_SUFFIX.items() if sfx and stem.endswith(sfx)),
                            3)
                # where this tree pairs the body and the parent ran 32-row tiles
                paired = moved(body, wc, vh, tier, kara, parent_paired)
                held = (parent_entry(parent_libs, name), libs[1])
                if held[0] is None:
                    continue
                a, c = (refused_or(lambda lib=lib, lay=lay: bare_entry(lib, name, planes, geom, body,
                                                                       layout=lay))
                        for lib, lay in zip(held, ((32, 0) if paired else None, None)))
                torch.cuda.synchronize()
                total += 1
                same = (a is None and c is None) or (
                    a is not None and c is not None and all(torch.equal(x, y)
                                                            for x, y in zip(a, c)))
                if paired and a is not None and c is not None:
                    if "_peaks_" in name:  # the parent's pyramid of 32-row chunks
                        av, ai = bc._best_chunk(*a, 3)
                        cv, ci = bc._best_chunk(*c, 3)
                        dist = float((cv - av).abs().max() / av.abs().max())
                        shifted.append(f"{label}: {name} {dist:.3e} from the parent (paired), "
                                     f"index flips {int((ai != ci).sum())}")
                    else:
                        dist = float((c[0].float() - a[0].float()).abs().max()
                                     / a[0].float().abs().max())
                        shifted.append(f"{label}: {name} {dist:.3e} from the parent (paired)")
                elif same:
                    equal += 1
                    refused += a is None
                else:
                    bad.append(f"{label}: {name}")
            del ops, ops16
            torch.cuda.empty_cache()
    print(f"every entry, parent vs this tree: {equal} bitwise equal, {refused} refused by both, "
          f"{len(shifted)} entries moved into the pair, of {total} (entry, geometry) pairs")
    for line in shifted:
        print(f"  moved: {line}")
    if bad:
        raise AssertionError(f"entries that differ from the parent's: {bad}")


def wide_entries() -> list:
    """Every maps and peaks entry of the radix bodies (v4, v5, v5x) in both
    H-stage forms: the entries that run the paired configuration where v3
    does."""
    from cuda_fft_convolution_torch import _build

    return [*_build._RADIX_SIGNATURES, *_build._RADIX_FORM_SIGNATURES]


def wide_turns(parent_libs, seed: int, parent_paired: tuple = ()) -> dict:
    """The moved entries (``wide_entries`` that ``moved`` names: this tree
    pairs them, the parent ran 32-row tiles) in turns, parent / this tree /
    this tree / parent, bare C entries (the parent with its 32-row
    operands, this tree with the pair's), at ``chip_smoke.RADIX_PLANS``
    (each body where its rules take the plan) on the headline image from
    ``seed`` (N = 100: 64² kernels, 32² at the 32² plan), each side against
    the plain version, and beside them this tree's paired entries of the
    same tier, form and head at the same plan — v4's (for v5 and v5x) and
    v3's — and the plain version → {(plan, entry): (the four ms, v4's ms or
    None, v3's ms, the plain version's ms)}. An entry both sides refuse
    (the Karatsuba form at 6×TF32 on Wc 513) is printed as refused."""
    import numpy as np
    import torch

    import cuda_fft_convolution_torch as fc
    from cuda_fft_convolution_torch import _build
    from cuda_fft_convolution_torch.ops import block_conv as bc

    libs = {False: (parent_libs[1], _build.library(radix=True)),
            True: (parent_libs[3], _build.library(radix=True, forms=True))}
    v3_libs = {False: _build.library(), True: _build.library(forms=True)}
    rng = np.random.default_rng(seed)
    s, n = chip_smoke.HEADLINE["size"], chip_smoke.HEADLINE["n"]
    image = torch.as_tensor(rng.standard_normal((s, s, 1)).astype(np.float32), device="cuda")
    out = {}
    for plan in chip_smoke.RADIX_PLANS:
        k = plan["k"]
        bank = rng.standard_normal((n, k, k, 1)).astype(np.float32)
        ops, ops16, geom = chip_smoke.radix_geometry(fc, plan, image, bank)
        bh, bw, kh, kw = geom[:4]
        vh, wc = bh - kh + 1, bw // 2 + 1
        label = f"{plan['label']} {geom[:4]}"
        for name in wide_entries():
            body = _entry_body(name)
            kara = name.endswith("_k")
            if body in ("v5", "v5x") and not bc.radix_w_legal(bw, kw, bw - kw + 1):
                continue
            stem = name.removesuffix(bc.body_suffix(body, kara))
            tier = next((t_ for t_, sfx in bc.TIER_SUFFIX.items() if sfx and stem.endswith(sfx)), 3)
            planes = ops16 if "_bf16" in stem.replace("_bf16maps", "") else ops
            if not moved(body, wc, vh, tier, kara, parent_paired):
                if not bc.form_taken(wc, vh, tier, True, kara):
                    print(f"A/B {label} {name}: refused by this tree (and the parent's 32 rows)")
                continue
            par, new = libs[kara]

            def side(lib, lay, entry=name, body=body):
                return lambda: bare_entry(lib, entry, planes, geom, body, layout=lay)

            parent_call, this_call = side(par, (32, 0)), side(new, None)
            v3_call = side(v3_libs[kara], None, stem + ("_k" if kara else ""), "v3")
            v4_call = (side(new, None, stem + bc.body_suffix("v4", kara), "v4")
                       if body != "v4" else None)
            a, c = parent_call(), this_call()
            peaks = "_peaks_" in name
            flags = dict(chip_smoke.RADIX_FLAGS[body], karatsuba=kara)
            out_dtype = torch.bfloat16 if "_bf16maps" in name else torch.float32

            def plain():
                return (bc.block_conv_peaks_reference(*planes, *geom, tier, **flags) if peaks
                        else bc.block_conv_reference(*planes, *geom, out_dtype, tier, **flags))

            want = plain()
            torch.cuda.synchronize()
            if peaks:
                a, c = bc._best_chunk(*a, 3), bc._best_chunk(*c, 3)
                errs = (f"values vs plain: parent {chip_smoke.rel_err(a[0], want[0]):.3e}, this "
                        f"tree {chip_smoke.rel_err(c[0], want[0]):.3e}; indices = plain: parent "
                        f"{torch.equal(a[1], want[1])}, this tree {torch.equal(c[1], want[1])}")
            else:
                errs = (f"vs plain: parent {chip_smoke.rel_err(a[0].float(), want.float()):.3e}, "
                        f"this tree {chip_smoke.rel_err(c[0].float(), want.float()):.3e}")
            del a, c, want
            ts = [chip_smoke.cuda_ms(fn) for fn in (parent_call, this_call, this_call, parent_call)]
            mean = (ts[1] + ts[2]) / 2
            v4_ms = chip_smoke.cuda_ms(v4_call) if v4_call else None
            v3_ms = chip_smoke.cuda_ms(v3_call)
            plain_ms = chip_smoke.cuda_ms(plain, runs=3)
            out[(label, name)] = (*ts, v4_ms, v3_ms, plain_ms)
            v4_txt = f"v4 paired {v4_ms:.3f} ms ({body} / v4 {mean / v4_ms:.3f}); " if v4_ms else ""
            print(f"A/B {label} {name}: parent {ts[0]:.3f}, this tree {ts[1]:.3f}, this tree "
                  f"{ts[2]:.3f}, parent {ts[3]:.3f} ms (this tree / parent "
                  f"{(ts[1] + ts[2]) / (ts[0] + ts[3]):.3f}); {v4_txt}v3 paired {v3_ms:.3f} ms "
                  f"({body} / v3 {mean / v3_ms:.3f}); plain version {plain_ms:.3f} ms (median "
                  f"of 3; this tree / plain {mean / plain_ms:.3f}); {errs} ({chip_smoke.card()})")
            torch.cuda.empty_cache()
        del ops, ops16
        torch.cuda.empty_cache()
    return out


V2_AB_PLANS = ("headline plan", "JAX F=1 plan", "large-kernel plan", "DPM plan", "F=8 plan")


def v2_plan_ops(fc, seed: int):
    """The plans the v2 body is timed at, one at a time → (label, f32 ops,
    bf16 ops, geometry): the headline plan (127, 447, 64, 64), 100 kernels
    of 64² on a 2048² image from ``seed``; JAX's F=1 plan (256, 512, 65,
    129), the same image and 100 kernels (``chip_smoke.radix_geometry``);
    the large-kernel plan (1023, 1024, 512, 512), 16 kernels of 512²; the
    DPM plan (27, 139, 12, 12) on ``chip_smoke.dpm_inputs``' float32 HOG
    features, 1024 kernels of 12²×31; the F=8 plan (63, 287, 32, 32), 64
    kernels of 32²×8 on a 1024² image of 8 channels. The bf16 ops are the
    f32 planes rounded."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def tiled(data, bank, k, block):
        spec = fc.fft_data_tiled(data, k, k, block_h=block[0], block_w=block[1],
                                 trim_mode="same")
        sk = fc.fft_kernels(bank, spectral=spec)
        geom = (spec.block_h, spec.block_w, spec.max_kh, spec.max_kw, spec.out_h, spec.out_w)
        ops = (spec.re[None], spec.im[None], sk.re, sk.im)
        return ops, tuple(x.to(torch.bfloat16) for x in ops), geom

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device="cuda")

    s, n, k = chip_smoke.HEADLINE["size"], chip_smoke.HEADLINE["n"], chip_smoke.HEADLINE["k"]
    image = t(s, s, 1)
    yield (V2_AB_PLANS[0], *tiled(image, t(n, k, k, 1), k, (127, 447)))
    bank = rng.standard_normal((n, k, k, 1)).astype(np.float32)
    yield (V2_AB_PLANS[1], *chip_smoke.radix_geometry(fc, chip_smoke.RADIX_PLANS[0], image, bank))
    big = chip_smoke.BIGKERNEL
    yield (V2_AB_PLANS[2], *tiled(image, t(big["n"], big["k"], big["k"], 1), big["k"],
                                  big["plan"][:2]))
    del image
    feats, dbank, _ = chip_smoke.dpm_inputs(seed, "float32")
    yield (V2_AB_PLANS[3], *tiled(feats, dbank, chip_smoke.DPM["k"], (27, 139)))
    del feats, dbank
    size, f, n8, k8 = (chip_smoke.F8_TIER[x] for x in ("size", "f", "n", "k"))
    yield (V2_AB_PLANS[4], *tiled(t(size, size, f), t(n8, k8, k8, f), k8,
                                  chip_smoke.F8_TIER["plan"][:2]))


def v2_entries() -> list:
    """Every v2 maps entry, both H-stage forms (``_v2``, ``_v2_k``)."""
    from cuda_fft_convolution_torch import _build

    return [*_build._V2_SIGNATURES, *(n for n in _build._FORM_SIGNATURES if n.endswith("_v2_k"))]


def v2_turns(parent_libs, seed: int, out_json: str = "v2_turns.json") -> dict:
    """Every v2 entry (``v2_entries``: both forms, every dtype mode and
    tier) at the five plans of ``v2_plan_ops``: with ``parent_libs`` (a
    parent's libraries, ``build_parent``) in turns, parent / this tree /
    this tree / parent, each side a bare C entry (``bare_entry``, the
    parent's from the library that holds it), else this tree's entry
    alone; each side against the plain version (largest error relative to
    the largest value, and at BF16IO the root mean square); beside them
    this tree's v3 entry of the same tier, form and maps dtype, the plain
    version (median of 3) and the bounds of v3's work
    (``chip_smoke.block_conv_bound``: ``same_work_bound_ms``) and of the
    form's own products. Prints a line an entry and writes every number to
    ``chiprun_out/<out_json>`` → {(plan, entry): row}."""
    import torch

    import cuda_fft_convolution_torch as fc
    from cuda_fft_convolution_torch import _build
    from cuda_fft_convolution_torch.ops import block_conv as bc

    libs = {False: _build.library(), True: _build.library(forms=True)}
    out, rows = {}, []
    for label, ops, ops16, geom in v2_plan_ops(fc, seed):
        bh, bw, kh, kw, out_h, out_w = geom
        vh, wc = bh - kh + 1, bw // 2 + 1
        nbh = ops[0].shape[1]
        for name in v2_entries():
            kara = name.endswith("_k")
            stem = name.removesuffix(bc.body_suffix("v2", kara))
            tier = next((t_ for t_, sfx in bc.TIER_SUFFIX.items() if sfx and stem.endswith(sfx)), 3)
            planes = ops16 if "_bf16" in stem.replace("_bf16maps", "") else ops
            out_dtype = torch.bfloat16 if "_bf16maps" in stem else torch.float32
            layout = (*bc.kernel_layout("v2", wc, vh, tier, kara), bc.v2_blocks(wc, vh, tier, kara))

            def side(lib, entry=name, body="v2"):
                return lambda: bare_entry(lib, entry, planes, geom, body)[0]

            this_call = side(libs[kara])
            sides = [this_call]
            if parent_libs is not None:
                parent_call = side(parent_entry(parent_libs, name))
                sides = [parent_call, this_call]
            got = [refused_or(fn) for fn in sides]
            if all(g is None for g in got):
                print(f"v2 {label} {geom[:4]} {name}: refused by every side ({chip_smoke.card()})")
                rows.append(dict(plan=label, entry=name, refused=True))
                continue
            if any(g is None for g in got):
                raise AssertionError(f"v2 {label} {name}: refused by one side only")
            # the plain version's float32 maps (bf16 maps are held to them, as
            # chip_smoke.check_kernel holds them)
            want = bc.block_conv_reference(*planes, *geom, torch.float32, tier, wstack=False,
                                           karatsuba=kara)
            torch.cuda.synchronize()
            errs = [chip_smoke.rel_err(g.float(), want) for g in got]
            rms = ([chip_smoke.rms_rel_err(g.float(), want) for g in got]
                   if tier == bc.BF16IO and out_dtype == torch.float32 else None)
            del got, want
            torch.cuda.empty_cache()
            if parent_libs is not None:
                ts = [chip_smoke.cuda_ms(fn) for fn in (parent_call, this_call, this_call,
                                                        parent_call)]
                mine = (ts[1] + ts[2]) / 2
            else:
                ts = [chip_smoke.cuda_ms(this_call)]
                mine = ts[0]
            v3_ms = chip_smoke.cuda_ms(side(libs[kara], stem + ("_k" if kara else ""), "v3"))
            plain_ms = chip_smoke.cuda_ms(
                lambda: bc.block_conv_reference(*planes, *geom, out_dtype, tier, wstack=False,
                                                karatsuba=kara), runs=3)
            out_bytes = (2 if out_dtype == torch.bfloat16 else 4) * ops[0].shape[0] * \
                ops[2].shape[0] * out_h * out_w
            same, same_by = chip_smoke.block_conv_bound(planes, geom, out_bytes, tier, "v3")
            own, _ = chip_smoke.block_conv_bound(planes, geom, out_bytes, tier, "v3", kara)
            row = dict(plan=label, geometry=list(geom[:4]), entry=name, nbh=nbh,
                       layout=list(layout), turns_ms=ts, ms=mine, v3_ms=v3_ms, plain_ms=plain_ms,
                       same_work_bound_ms=same, bound_by=same_by, own_bound_ms=own,
                       max_rel_err_vs_plain=errs, rms_rel_err_vs_plain=rms, card=chip_smoke.card())
            rows.append(row)
            out[(label, name)] = row
            turns = (f"parent {ts[0]:.3f}, this tree {ts[1]:.3f}, this tree {ts[2]:.3f}, parent "
                     f"{ts[3]:.3f} ms (this tree / parent {(ts[1] + ts[2]) / (ts[0] + ts[3]):.3f}); "
                     if parent_libs is not None else f"{ts[0]:.3f} ms; ")
            print(f"v2 {label} {geom[:4]} {name} (rows, pair bins, MBH {layout[:2]}, "
                  f"{min(layout[2], nbh)} of {nbh} block rows): {turns}"
                  f"v3 {v3_ms:.3f} ms (v2 / v3 {mine / v3_ms:.3f}); plain {plain_ms:.3f} ms "
                  f"(v2 / plain {mine / plain_ms:.3f}); bound {same:.3f} ms ({same_by}; the "
                  f"form's own {own:.3f}); vs plain max {', '.join(f'{e:.3e}' for e in errs)}"
                  f"{f', rms ' + ', '.join(f'{e:.3e}' for e in rms) if rms else ''} "
                  f"({chip_smoke.card()})")
            torch.cuda.empty_cache()
        del ops, ops16
        torch.cuda.empty_cache()
    dest = pathlib.Path("chiprun_out")
    dest.mkdir(exist_ok=True)
    (dest / out_json).write_text(json.dumps(rows, indent=1))
    return out


def ab_parent(csrc: pathlib.Path, seed: int) -> None:
    """Time the parent's fused kernels against this tree's, in turns, at
    the headline plan and the DPM plan (module docstring)."""
    import numpy as np
    import torch

    import cuda_fft_convolution_torch as fc
    from cuda_fft_convolution_torch import _build
    from cuda_fft_convolution_torch.ops.block_conv import (
        BF16IO,
        TIER_SUFFIX,
        block_conv_peaks_reference,
        block_conv_reference,
        tier_name,
    )

    parent_libs = build_parent(csrc)
    lib = parent_libs[0]
    this = _build.library()
    paired = parent_paired_bodies(csrc)
    every_entry_bitwise(parent_libs, seed, paired)
    wide_turns(parent_libs, seed, paired)
    v2_turns(parent_libs, seed)

    def calls(ops, geom, peaks, splits=3):
        """(the parent's call, this tree's call): both bare C entries of the
        tier (``bare_entry``), the peaks' pyramid of one row chunk as (vals,
        idxs) (B, N, nbh, nbw)."""
        tag = ("bf16" if ops[0].dtype == torch.bfloat16 else "f32") + TIER_SUFFIX[splits]
        name = f"fftconv_block_conv{'_peaks' if peaks else ''}_{tag}"

        def call(side):
            out = bare_entry(side, name, ops, geom)
            return (out[0][:, :, :, 0], out[1][:, :, :, 0]) if peaks else out[0]

        return (lambda: call(lib)), (lambda: call(this))

    def turns(label, parent, new, runs=chip_smoke.RUNS):
        """parent, this tree, this tree, parent."""
        t = [chip_smoke.cuda_ms(f, runs) for f in (parent, new, new, parent)]
        names = ("parent", "this tree", "this tree", "parent")
        print(f"A/B {label}: " + ", ".join(f"{n} {x:.3f}" for n, x in zip(names, t))
              + f" ms (this tree / parent {(t[1] + t[2]) / (t[0] + t[3]):.3f}; "
              f"{chip_smoke.card()})")
        torch.cuda.empty_cache()

    def compare(label, parent, new, peaks, ops, geom):
        a, b = parent(), new()
        # the plain version of the 3xTF32 entries (bf16 spectra: the
        # explicit tier; IEEE fp32 at every fp32 tier)
        want = (block_conv_peaks_reference(*ops, *geom, 3) if peaks
                else block_conv_reference(*ops, *geom, splits=3))
        torch.cuda.synchronize()
        flips = ""
        if peaks:
            flips = f", index flips {int((a[1] != b[1]).sum())} of {a[1].numel()}"
            a, b, want = a[0], b[0], want[0]
        rel = float((a - b).abs().max() / a.abs().max())
        print(f"{label}: parent vs this tree rel {rel:.3e}{flips}, bitwise equal "
              f"{torch.equal(a, b)}; vs the plain version: parent "
              f"{chip_smoke.rel_err(a, want):.3e}, this tree {chip_smoke.rel_err(b, want):.3e}")
        del a, b, want
        torch.cuda.empty_cache()

    def io_compare(label, parent, new, peaks, ops, geom):
        """Both sides at BF16IO against the plain version at that tier:
        largest and root-mean-square error (maps), or values and equal
        indices (peaks)."""
        a, b = parent(), new()
        want = (block_conv_peaks_reference(*ops, *geom, BF16IO) if peaks
                else block_conv_reference(*ops, *geom, splits=BF16IO))
        torch.cuda.synchronize()
        if peaks:
            print(f"{label}: vs the plain version, parent {chip_smoke.rel_err(a[0], want[0]):.3e} "
                  f"(indices equal {torch.equal(a[1], want[1])}), this tree "
                  f"{chip_smoke.rel_err(b[0], want[0]):.3e} (indices equal "
                  f"{torch.equal(b[1], want[1])})")
        else:
            print(f"{label}: vs the plain version, parent {chip_smoke.rel_err(a, want):.3e} "
                  f"(rms {chip_smoke.rms_rel_err(a, want):.3e}), this tree "
                  f"{chip_smoke.rel_err(b, want):.3e} (rms {chip_smoke.rms_rel_err(b, want):.3e})")
        del a, b, want
        torch.cuda.empty_cache()

    rng = np.random.default_rng(seed)
    s, n, k = chip_smoke.HEADLINE["size"], chip_smoke.HEADLINE["n"], chip_smoke.HEADLINE["k"]
    image = torch.as_tensor(rng.standard_normal((s, s, 1)).astype(np.float32), device="cuda")
    bank = torch.as_tensor(rng.standard_normal((n, k, k, 1)).astype(np.float32), device="cuda")
    spec = fc.fft_data_tiled(image, k, k, trim_mode="same")
    sk = fc.fft_kernels(bank, spectral=spec)
    geom = (spec.block_h, spec.block_w, spec.max_kh, spec.max_kw, spec.out_h, spec.out_w)
    ops = (spec.re[None], spec.im[None], sk.re, sk.im)
    ops16 = tuple(x.to(torch.bfloat16) for x in ops)
    for peaks in (False, True):
        label = f"headline plan, f32 {'peaks' if peaks else 'maps'}"
        compare(label, *calls(ops, geom, peaks), peaks, ops, geom)
        turns(label, *calls(ops, geom, peaks))
        for splits in (6, 1):  # the other fp32 tiers
            compare(f"{label}, {tier_name(splits)}", *calls(ops, geom, peaks, splits), peaks,
                    ops, geom)
            turns(f"{label}, {tier_name(splits)}", *calls(ops, geom, peaks, splits))
        a, b = (f() for f in calls(ops16, geom, peaks, BF16IO))
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(a, b)) if peaks else torch.equal(a, b)
        print(f"{label}, BF16IO: parent vs this tree bitwise equal {same}")
        del a, b
        turns(f"{label}, BF16IO", *calls(ops16, geom, peaks, BF16IO))
    del spec, sk, ops, ops16
    torch.cuda.empty_cache()

    # the radix bodies' maps entries at JAX's F=1 plan on the headline
    # image, in turns (3xTF32 on f32 spectra, BF16IO on bf16)
    from cuda_fft_convolution_torch.ops.block_conv import RADIX_SUFFIX

    rops, rops16, rgeom = chip_smoke.radix_geometry(fc, chip_smoke.RADIX_PLANS[0], image, bank)
    radix_lib = _build.library(radix=True)
    for body in ("v4", "v5", "v5x"):
        for planes, tag in ((rops, "f32"), (rops16, "bf16_io")):
            name = f"fftconv_block_conv_{tag}{RADIX_SUFFIX[body]}"
            parent_call, this_call = (
                lambda side=side: bare_entry(side, name, planes, rgeom, body)[0]
                for side in (parent_libs[1], radix_lib))
            a, c = parent_call(), this_call()
            torch.cuda.synchronize()
            print(f"JAX F=1 plan {rgeom[:4]}, {body} {tag} maps: parent vs this tree rel "
                  f"{float((c - a).abs().max() / a.abs().max()):.3e}")
            del a, c
            turns(f"JAX F=1 plan {rgeom[:4]}, {body} {tag} maps", parent_call, this_call)
    del rops, rops16
    torch.cuda.empty_cache()

    feats, dbank, _ = chip_smoke.dpm_inputs(seed)
    k = chip_smoke.DPM["k"]
    sd = fc.fft_data_tiled(feats, k, k, trim_mode="same", store_dtype="bfloat16")
    sks = (fc.fft_kernels(dbank, spectral=sd, store_dtype="bfloat16"),
           fc.fft_kernels(dbank, spectral=sd, correlation=True, store_dtype="bfloat16"))
    geom = (sd.block_h, sd.block_w, sd.max_kh, sd.max_kw, sd.out_h, sd.out_w)
    for peaks in (False, True):
        ops = (sd.re[None], sd.im[None], sks[peaks].re, sks[peaks].im)
        label = f"DPM plan, bf16 spectra, {'peaks' if peaks else 'f32 maps'}"
        io_compare(f"{label}, BF16IO", *calls(ops, geom, peaks, BF16IO), peaks, ops, geom)
        turns(f"{label}, BF16IO", *calls(ops, geom, peaks, BF16IO))
        compare(label, *calls(ops, geom, peaks), peaks, ops, geom)
        turns(label, *calls(ops, geom, peaks))
    ops = (sd.re[None], sd.im[None], sks[0].re, sks[0].im)
    print(f"DPM plan, plain version of the maps kernel: "
          f"{chip_smoke.cuda_ms(lambda: block_conv_reference(*ops, *geom)):.3f} ms")
    ops = tuple(t.float() for t in ops)
    turns("DPM plan, the same planes upcast to f32, f32 maps", *calls(ops, geom, False), runs=3)
    for splits in (6, 1):
        turns(f"DPM plan, the same planes upcast to f32, f32 maps, {tier_name(splits)}",
              *calls(ops, geom, False, splits), runs=3)
    del sd, sks, ops
    torch.cuda.empty_cache()

    # the F=8 tier's plan (63, 287, 32, 32): stacked, bf16 spectra at BF16IO
    size, f, n, k = (chip_smoke.F8_TIER[x] for x in ("size", "f", "n", "k"))
    data = torch.as_tensor(rng.standard_normal((size, size, f)).astype(np.float32), device="cuda")
    fbank = torch.as_tensor(rng.standard_normal((n, k, k, f)).astype(np.float32), device="cuda")
    sd = fc.fft_data_tiled(data, k, k, trim_mode="same", store_dtype="bfloat16")
    skf = fc.fft_kernels(fbank, spectral=sd, store_dtype="bfloat16")
    geom = (sd.block_h, sd.block_w, sd.max_kh, sd.max_kw, sd.out_h, sd.out_w)
    ops = (sd.re[None], sd.im[None], skf.re, skf.im)
    for peaks in (False, True):
        label = f"F=8 plan {geom[:4]}, BF16IO {'peaks' if peaks else 'maps'}"
        io_compare(label, *calls(ops, geom, peaks, BF16IO), peaks, ops, geom)
        turns(label, *calls(ops, geom, peaks, BF16IO))


# The stage-split patches of the stacked configuration, by the sources
# they apply to: (file, text, replacement) a variant; a variant whose text
# is not in a copy's sources is skipped. "parent" is the cp.async design
# (one kernel a CTA, fp32-FMA H stage), "tensor-core" this tree's.
SPLIT_PATCHES = {
    "parent": {
        "no W stage": [("block_conv.cuh", "    w_stage(x_s, epi);\n    epi.finish(stage);\n  }\n}",
                        "    if (!STACKED) w_stage(x_s, epi);\n    epi.finish(stage);\n  }\n}")],
        "no H stage": [("block_conv.cuh",
                        "  for (int c0 = 0; c0 < wc_pad; c0 += kCols) {\n    // (Karatsuba",
                        "  for (int c0 = 0; c0 < 0; c0 += kCols) {\n    // (Karatsuba")],
        "no H copies": [("block_conv.cuh", "            cp_async16(dst, reinterpret_cast<const char*>(a0) + 16 * k);",
                         "            if (k < 0) cp_async16(dst, reinterpret_cast<const char*>(a0) + 16 * k);")],
        "H copies only": [("block_conv.cuh", "        if (on) {\n          const char* slot = ring",
                           "        if (on && f < 0) {\n          const char* slot = ring"),
                          ("block_conv.cuh", "      for (int uu = 0; uu < kug; ++uu) {",
                           "      for (int uu = 0; uu < 0; ++uu) {")],
        "no H products": [("block_conv.cuh", "      for (int uu = 0; uu < kug; ++uu) {",
                           "      for (int uu = 0; uu < 0; ++uu) {")],
    },
    "tensor-core": {
        "no W stage": [("block_conv.cuh", "      w_stage(x_s + k * 64 * xs, epi);",
                        "      if (k < 0) w_stage(x_s + k * 64 * xs, epi);")],
        "no H stage": [("block_conv.cuh", "    for (int uc = 0; uc < nuc; ++uc) {",
                        "    for (int uc = 0; uc < 0; ++uc) {")],
        "no H copies": [("block_conv.cuh", "      mbar_expect_tx(full(sl), bytes);\n      if (bytes)",
                         "      mbar_expect_tx(full(sl), 0);\n      if (false && bytes)")],
        "H copies only": [("block_conv.cuh",
                           "            if (2 * (32 * warp + kMacThreads * j) >= npx) break;",
                           "            if (f > 0 || 2 * (32 * warp + kMacThreads * j) >= npx) break;"),
                          ("block_conv.cuh", "        for (int task = warp; task < ntask;",
                           "        for (int task = warp; task < 0;")],
        "no H products": [("block_conv.cuh", "        for (int task = warp; task < ntask;",
                           "        for (int task = warp; task < 0;")],
    },
}
# The epilogue's stores, in every design: the maps' and the peaks' tile().
_NO_EPILOGUE = [
    ("block_conv_maps.cuh", "  __device__ void tile(const float (&acc)[MT][NT][4], int row0, int col0, int row_end) {\n",
     "  __device__ void tile(const float (&acc)[MT][NT][4], int row0, int col0, int row_end) {\n    if (row_end != -7) return;\n"),
    ("block_conv_peaks.cuh", "  __device__ void tile(const float (&acc)[MT][NT][4], int row0, int col0, int row_end) {\n",
     "  __device__ void tile(const float (&acc)[MT][NT][4], int row0, int col0, int row_end) {\n    if (row_end != -7) return;\n"),
]
_SPLIT_UNIT = """#include "block_conv_maps.cuh"
#include "block_conv_peaks.cuh"
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16_io, __nv_bfloat16, float, StoreF32, kBF16IO)
FFTCONV_PEAKS_ENTRY(fftconv_block_conv_peaks_bf16_io, __nv_bfloat16, kBF16IO)
"""


def stacked_split(csrc: pathlib.Path, seed: int) -> None:
    """Time the stacked configuration's stages (module docstring)."""
    import shutil

    import numpy as np
    import torch

    import cuda_fft_convolution_torch as fc
    from cuda_fft_convolution_torch import _build

    design = "tensor-core" if "kMacWarps" in (csrc / "block_conv.cuh").read_text() else "parent"
    variants = {"whole": [], **SPLIT_PATCHES[design], "no epilogue": _NO_EPILOGUE}
    root = _build.BUILD_DIR / "stacked_split" / design
    nvcc = _build._nvcc()
    procs = {}
    for name, patches in variants.items():
        out = root / name.replace(" ", "_")
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(csrc, out)
        ok = True
        for file, text, new in patches:
            src = (out / file).read_text()
            if src.count(text) != 1:
                print(f"split {design}, {name}: patch text found {src.count(text)} times in {file}; skipped")
                ok = False
                break
            (out / file).write_text(src.replace(text, new))
        if not ok:
            continue
        (out / "split.cu").write_text(_SPLIT_UNIT)
        procs[name] = (out, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *_build.LINK_FLAGS[2:], "-o", str(out / "libsplit.so"),
             str(out / "split.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"split {design}, {name}: nvcc failed:\n{log[-3000:]}")
            continue
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"split {design}, {name}: built; " + " | ".join(regs[-4:]))
        lib = ctypes.CDLL(str(out / "libsplit.so"))
        for entry in ("fftconv_block_conv_bf16_io", "fftconv_block_conv_peaks_bf16_io"):
            getattr(lib, entry).argtypes, getattr(lib, entry).restype = _build._SIGNATURES[entry]
        libs[name] = lib

    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"split {design}: SM clock now, most: {clocks.strip()}")
    feats, dbank, _ = chip_smoke.dpm_inputs(seed)
    k = chip_smoke.DPM["k"]
    sd = fc.fft_data_tiled(feats, k, k, trim_mode="same", store_dtype="bfloat16")
    sk = fc.fft_kernels(dbank, spectral=sd, store_dtype="bfloat16")
    cases = [("DPM maps", "fftconv_block_conv_bf16_io", (sd.re[None], sd.im[None], sk.re, sk.im),
              (sd.block_h, sd.block_w, sd.max_kh, sd.max_kw, sd.out_h, sd.out_w)),
             ("DPM peaks", "fftconv_block_conv_peaks_bf16_io",
              (sd.re[None], sd.im[None], sk.re, sk.im),
              (sd.block_h, sd.block_w, sd.max_kh, sd.max_kw, sd.out_h, sd.out_w))]
    rng = np.random.default_rng(seed)
    size, f, n, kk = (chip_smoke.F8_TIER[x] for x in ("size", "f", "n", "k"))
    data = torch.as_tensor(rng.standard_normal((size, size, f)).astype(np.float32), device="cuda")
    fbank = torch.as_tensor(rng.standard_normal((n, kk, kk, f)).astype(np.float32), device="cuda")
    fsd = fc.fft_data_tiled(data, kk, kk, trim_mode="same", store_dtype="bfloat16")
    fsk = fc.fft_kernels(fbank, spectral=fsd, store_dtype="bfloat16")
    cases.append(("F=8 maps", "fftconv_block_conv_bf16_io",
                  (fsd.re[None], fsd.im[None], fsk.re, fsk.im),
                  (fsd.block_h, fsd.block_w, fsd.max_kh, fsd.max_kw, fsd.out_h, fsd.out_w)))
    whole = {}
    for label, entry, ops, geom in cases:
        for name, lib in libs.items():
            ms = chip_smoke.cuda_ms(lambda: bare_entry(lib, entry, ops, geom))
            whole.setdefault(label, ms)
            print(f"split {design}, {label}, {name}: {ms:.3f} ms "
                  f"({ms - whole[label]:+.3f} against the whole kernel; {chip_smoke.card()})")
            torch.cuda.empty_cache()


# The stage-split patches of the wide configuration (Wc > 320: the
# large-kernel plan's 1024 block), by design: "32 rows" is the parent's
# (mma.sync, one CTA a 32-row chunk of a cell), "paired" this tree's (a
# cluster of two 64-row CTAs splitting the bins). (file, text, replacement)
# a variant, as SPLIT_PATCHES; "no fifth passes" drops the passes past the
# fourth of 128 bins and columns (the 1024 block's H bin 512 and W column
# 512 in the parent).
WIDE_SPLIT_PATCHES = {
    "32 rows": {
        "no W stage": [("block_conv.cuh", "    Epi epi(out, cell_at, geom);\n    w_stage(x_s, epi);",
                        "    Epi epi(out, cell_at, geom);\n    if (cell_at.ni < 0) w_stage(x_s, epi);")],
        "no H stage": [("block_conv.cuh", "  for (int c0 = 0; c0 < h_cols; c0 += kCols) {",
                        "  for (int c0 = 0; c0 < 0; c0 += kCols) {")],
        "no MAC loads": [("block_conv.cuh", "        const bool ok = u < lh && v < wc && s_v(q) < w;",
                          "        const bool ok = u < 0 && v < wc && s_v(q) < w;")],
        "no H products": [("block_conv.cuh",
                           "        for (int ks = 0; ks < kUK / 8; ++ks)\n#pragma unroll\n"
                           "          for (int np = 0; np < 2; ++np) {\n            // B: S rows",
                           "        for (int ks = 0; ks < 0; ++ks)\n#pragma unroll\n"
                           "          for (int np = 0; np < 2; ++np) {\n            // B: S rows")],
        "no fifth passes": [("block_conv.cuh", "  for (int c0 = 0; c0 < h_cols; c0 += kCols) {",
                             "  for (int c0 = 0; c0 < min(h_cols, 4 * kCols); c0 += kCols) {"),
                            ("block_conv.cuh", "  const int mcols = m_cols(wcols);",
                             "  const int mcols = min(m_cols(wcols), 4 * kCols);")],
    },
    "paired": {
        "no W stage": [("block_conv.cuh", "    Epi epi(out, cell_at, geom);\n    w_stage(x_s, epi);",
                        "    Epi epi(out, cell_at, geom);\n    if (cell_at.ni < 0) w_stage(x_s, epi);")],
        "no H stage": [("block_conv.cuh", "  for (int c0 = 0; c0 < hb_pad; c0 += kCols) {",
                        "  for (int c0 = 0; c0 < 0; c0 += kCols) {")],
        "no MAC loads": [("block_conv.cuh", "      const bool ok = u < lh && v < wc && s_v(q) < w;",
                          "      const bool ok = u < 0 && v < wc && s_v(q) < w;")],
        "no H products": [("block_conv.cuh", "        } else if (live) {\n          // The warpgroup's 64 rows",
                           "        } else if (live && lh < 0) {\n          // The warpgroup's 64 rows")],
        "no remote X": [("block_conv.cuh", "        const bool remote = PAIRED && src != crank;",
                         "        const bool remote = false;")],
        "no Nyquist H sums": [("block_conv.cuh", "    const bool nyq = PAIRED && c0 == 0;",
                               "    const bool nyq = false;")],
        "no Nyquist W term": [("block_conv.cuh",
                               "          if constexpr (PAIRED) add_nyq(acc, rank * 16 + g8, col);\n",
                               "")],
        "no last column": [("block_conv.cuh", ("    if (!kDif && vw > pair_cols(vw)) {",
                                               "    if (vw > pair_cols(vw)) {"),
                            "    if (vw < 0) {")],
        "32-bit MAC offsets": [("block_conv.cuh",
                                "      const long long off = ok ? static_cast<long long>(u) * wc + v + ff * plane : 0;",
                                "      const int off = ok ? u * wc + v + ff * static_cast<int>(plane) : 0;")],
    },
}
_WIDE_SPLIT_UNIT = """#include "block_conv_maps.cuh"
#include "block_conv_peaks.cuh"
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_f32, float, float, StoreF32, 3)
FFTCONV_BLOCK_CONV_ENTRY(fftconv_block_conv_bf16_io, __nv_bfloat16, float, StoreF32, kBF16IO)
FFTCONV_PEAKS_ENTRY(fftconv_block_conv_peaks_f32, float, 3)
"""


def _split_variants(kind: str, csrc: pathlib.Path, variants: dict, unit: str, entries) -> dict:
    """Copies of ``csrc`` under ``build/<kind>``, each with its variant's
    patches applied (a patch's text, or the first of its forms where it
    gives a tuple, found in the sources exactly once; a variant with a text
    not found so is skipped), each built with ``unit`` as its one translation unit
    (one nvcc a copy, all started together) → {variant: the loaded library,
    ``entries`` bound with this tree's signatures}."""
    import shutil

    from cuda_fft_convolution_torch import _build

    root = _build.BUILD_DIR / kind
    nvcc = _build._nvcc()
    procs = {}
    for name, patches in variants.items():
        out = root / name.replace(" ", "_")
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(csrc, out)
        ok = True
        for file, text, new in patches:
            src = (out / file).read_text()
            text = next((t for t in (text if isinstance(text, tuple) else (text,))
                         if src.count(t) == 1), text)
            if isinstance(text, tuple) or src.count(text) != 1:
                print(f"{kind}, {name}: patch text not found once in {file}; skipped")
                ok = False
                break
            (out / file).write_text(src.replace(text, new))
        if not ok:
            continue
        (out / "split.cu").write_text(unit)
        procs[name] = (out, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *_build.LINK_FLAGS[2:], "-o", str(out / "libsplit.so"),
             str(out / "split.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    sigs = {**_build._SIGNATURES, **_build._RADIX_SIGNATURES, **_build._RADIX_FORM_SIGNATURES}
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{kind}, {name}: nvcc failed:\n{log[-3000:]}")
            continue
        print(f"{kind}, {name}: built")
        lib = ctypes.CDLL(str(out / "libsplit.so"))
        for entry in entries:
            getattr(lib, entry).argtypes, getattr(lib, entry).restype = sigs[entry]
        libs[name] = lib
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{kind}: SM clock now, most: {clocks.strip()}")
    return libs


def wide_split(csrc: pathlib.Path, seed: int) -> None:
    """Time the wide configuration's stages at the large-kernel plan
    (module docstring)."""
    import numpy as np
    import torch

    import cuda_fft_convolution_torch as fc

    design = "paired" if "PAIRED" in (csrc / "block_conv.cuh").read_text() else "32 rows"
    variants = {"whole": [], **WIDE_SPLIT_PATCHES[design], "no epilogue": _NO_EPILOGUE}
    entries = ("fftconv_block_conv_f32", "fftconv_block_conv_bf16_io",
               "fftconv_block_conv_peaks_f32")
    libs = _split_variants(f"wide_split/{design.replace(' ', '_')}", csrc, variants,
                           _WIDE_SPLIT_UNIT, entries)
    rng = np.random.default_rng(seed)
    s, n, k = chip_smoke.HEADLINE["size"], chip_smoke.BIGKERNEL["n"], chip_smoke.BIGKERNEL["k"]
    image = torch.as_tensor(rng.standard_normal((s, s, 1)).astype(np.float32), device="cuda")
    bank = torch.as_tensor(rng.standard_normal((n, k, k, 1)).astype(np.float32), device="cuda")
    spec = fc.fft_data_tiled(image, k, k, trim_mode="same")
    sk = fc.fft_kernels(bank, spectral=spec)
    geom = (spec.block_h, spec.block_w, spec.max_kh, spec.max_kw, spec.out_h, spec.out_w)
    if geom[:4] != chip_smoke.BIGKERNEL["plan"]:
        raise AssertionError(f"large-kernel plan {geom[:4]}")
    ops = (spec.re[None], spec.im[None], sk.re, sk.im)
    ops16 = tuple(x.to(torch.bfloat16) for x in ops)
    layout = (32, 0) if design == "32 rows" else None  # a parent's 32-row operands
    whole = {}
    for label, entry, planes in (("f32 maps, 3xTF32", entries[0], ops),
                                 ("bf16 spectra maps, BF16IO", entries[1], ops16),
                                 ("f32 peaks, 3xTF32", entries[2], ops)):
        for name, lib in libs.items():
            ms = chip_smoke.cuda_ms(lambda: bare_entry(lib, entry, planes, geom, layout=layout))
            whole.setdefault(label, ms)
            print(f"wide split {design}, 512² plan {label}, {name}: {ms:.3f} ms "
                  f"({ms - whole[label]:+.3f} against the whole kernel; {chip_smoke.card()})")
            torch.cuda.empty_cache()


# The stage-split patches of the radix bodies at JAX's F=1 plan (Wc 257) at
# 6xTF32, for either design of each body: the 32-row one (mma.sync; a pair
# chunk's 3 passes of 128 bins and a single chunk's 5 of 64, over every
# bin: "no one-bin passes" drops the passes past the second of 128 bins, the
# fourth of 64, which hold bin 256 alone) and the pair (each rank's bins on
# wgmma, the last bin apart). (file, text, replacement) a patch, as
# SPLIT_PATCHES; a text given as a tuple is the first of its forms found in
# the sources (this tree's, then a parent's).
RADIX_SPLIT_PATCHES = {
    "no W stage": WIDE_SPLIT_PATCHES["paired"]["no W stage"],
    "no H stage": [("block_conv.cuh", "  for (int c0 = 0; c0 < hb_pad; c0 += pass_w) {",
                    "  for (int c0 = 0; c0 < 0; c0 += pass_w) {")],
    "no MAC loads": WIDE_SPLIT_PATCHES["paired"]["no MAC loads"],
    "no H products": [("block_conv.cuh",
                       "      if (!live) continue;\n      if constexpr (kWG) {\n        // A = S^T's",
                       "      if (!live || lh > 0) continue;\n      if constexpr (kWG) {\n"
                       "        // A = S^T's")],
    "no one-bin passes": [("block_conv.cuh", "  for (int c0 = 0; c0 < hb_pad; c0 += pass_w) {",
                           "  for (int c0 = 0; c0 < min(hb_pad, 2 * kCols); c0 += pass_w) {")],
    "no remote X": WIDE_SPLIT_PATCHES["paired"]["no remote X"],
    "no Nyquist H sums": [("block_conv.cuh",
                           ("    const bool nyq_pair = PAIRED && BODY != kV5X && c0 == 0;",
                            "    const bool nyq_pair = PAIRED && c0 == 0;"),
                           "    const bool nyq_pair = false;")],
    "no Nyquist W term": [("block_conv.cuh",
                           ("          if constexpr (PAIRED && !kDif) add_nyq(acc, l0, col);\n",
                            "          if constexpr (PAIRED) add_nyq(acc, l0, col);\n"), ""),
                          ("block_conv.cuh",
                           "          const float p = accp[mt][nt][i] + ny[i >> 1] * par;",
                           "          const float p = accp[mt][nt][i];")],
}
# (body, entry) of the split: each body's maps entry in both H-stage forms
# and its peaks entry, at 6xTF32
_RADIX_SPLIT_ENTRIES = tuple(
    (body, f"fftconv_block_conv{head}_f32_x6{sfx}{k}")
    for body, sfx in (("v4", "_r4"), ("v5", "_r5"), ("v5x", "_r5x"))
    for head, k in (("", ""), ("", "_k"), ("_peaks", "")))
_RADIX_KV = {"v4": "kV4", "v5": "kV5", "v5x": "kV5X"}
_RADIX_SPLIT_UNIT = """#include "block_conv_maps.cuh"
#include "block_conv_peaks.cuh"
""" + "".join(
    f"FFTCONV_PEAKS_RADIX_ENTRY({name}, float, 6, {_RADIX_KV[body]}, false)\n" if "_peaks" in name
    else f"FFTCONV_BLOCK_CONV_RADIX_ENTRY({name}, float, float, StoreF32, 6, {_RADIX_KV[body]}, "
         f"{'true' if name.endswith('_k') else 'false'})\n"
    for body, name in _RADIX_SPLIT_ENTRIES)


def radix_split(csrc: pathlib.Path, seed: int) -> None:
    """Time the radix bodies' stages at JAX's F=1 plan at 6xTF32 (module
    docstring)."""
    import numpy as np
    import torch

    import cuda_fft_convolution_torch as fc

    paired = parent_paired_bodies(csrc)
    variants = {"whole": [], **RADIX_SPLIT_PATCHES, "no epilogue": _NO_EPILOGUE}
    names = tuple(name for _, name in _RADIX_SPLIT_ENTRIES)
    libs = _split_variants("radix_split", csrc, variants, _RADIX_SPLIT_UNIT, names)
    rng = np.random.default_rng(seed)
    s, n, k = chip_smoke.HEADLINE["size"], chip_smoke.HEADLINE["n"], chip_smoke.HEADLINE["k"]
    image = torch.as_tensor(rng.standard_normal((s, s, 1)).astype(np.float32), device="cuda")
    bank = rng.standard_normal((n, k, k, 1)).astype(np.float32)
    ops, _, geom = chip_smoke.radix_geometry(fc, chip_smoke.RADIX_PLANS[0], image, bank)
    whole = {}
    for body, entry in _RADIX_SPLIT_ENTRIES:
        design = "paired" if body in paired else "32 rows"
        layout = None if body in paired else (32, 0)  # a parent's 32-row operands
        for name, lib in libs.items():
            ms = chip_smoke.cuda_ms(lambda: bare_entry(lib, entry, ops, geom, body, layout=layout))
            whole.setdefault(entry, ms)
            print(f"radix split, JAX F=1 plan {geom[:4]} {entry} ({design}), {name}: {ms:.3f} ms "
                  f"({ms - whole[entry]:+.3f} against the whole kernel; {chip_smoke.card()})")
            torch.cuda.empty_cache()


def submit_soak(stream, frames, pinned, host, seconds: float) -> None:
    """The ``--soak`` part of ``--submit-probe`` (module docstring)."""
    import collections
    import gc
    import statistics
    import threading
    import time
    import traceback

    import torch

    def ms(fn):
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)

    # While a submit runs: the garbage collector's time in it, and where the
    # main thread is once the submit has taken 4 ms (sampled from a thread).
    live = {"t0": None, "gc": 0.0, "gc_t": 0.0, "stack": None}
    main, done = threading.get_ident(), threading.Event()

    def on_gc(phase, info):
        if live["t0"] is None:
            return
        if phase == "start":
            live["gc_t"] = time.perf_counter()
        else:
            live["gc"] += 1e3 * (time.perf_counter() - live["gc_t"])

    def sampler():
        while not done.is_set():
            t0 = live["t0"]
            if t0 is not None and live["stack"] is None and time.perf_counter() - t0 > 4e-3:
                frames_ = traceback.extract_stack(sys._current_frames()[main])[-4:]
                live["stack"] = " < ".join(f"{pathlib.Path(f.filename).name}:{f.lineno}"
                                           for f in reversed(frames_))
            time.sleep(5e-4)

    gc.callbacks.append(on_gc)
    thread = threading.Thread(target=sampler, daemon=True)
    thread.start()
    trials = []
    end = time.perf_counter() + seconds
    try:
        while time.perf_counter() < end:
            stream.flush()
            first = stream.submit(frames[2])
            retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
            live.update(t0=time.perf_counter(), gc=0.0, stack=None)
            stream.submit(frames[3])
            submit = 1e3 * (time.perf_counter() - live["t0"])
            live["t0"] = None
            trials.append((submit, not first._event.query(), live["gc"], live["stack"],
                           ms(lambda: sum(range(100_000))), ms(torch.cuda.mem_get_info),
                           ms(lambda: pinned.copy_(host)),
                           torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries))
    finally:
        done.set()
        thread.join()
        gc.callbacks.remove(on_gc)
    stream.flush()
    col = list(zip(*trials))
    windows = [statistics.median(col[0][i:i + 8]) for i in range(len(trials) - 7)]
    slow = [t for t in trials if t[0] > 3.5]
    print(f"soak, {len(trials)} submit trials over {seconds:.0f} s: submit ms median "
          f"{statistics.median(col[0]):.3f}, 99th {sorted(col[0])[int(0.99 * len(trials))]:.3f},"
          f" worst {max(col[0]):.3f}; worst median of 8 consecutive {max(windows):.3f}; "
          f"frame ahead done at return in {col[1].count(False)}; allocator retries "
          f"{sum(col[7])}; canary medians: loop {statistics.median(col[4]):.3f}, "
          f"mem_get_info {statistics.median(col[5]):.3f}, staging copy "
          f"{statistics.median(col[6]):.3f} ms")
    print(f"  {len(slow)} submits over 3.5 ms: {sum(t[2] > 0 for t in slow)} with a garbage "
          f"collection in them ({sum(t[2] for t in slow):.1f} ms of their "
          f"{sum(t[0] for t in slow):.1f}); the main thread after 4 ms:")
    for stack, count in collections.Counter(t[3] for t in slow).most_common(8):
        print(f"    {count:5d}  {stack}")
    for i in sorted(range(len(trials)), key=lambda i: -trials[i][0])[:8]:
        t = trials[i]
        print(f"  trial {i}: submit {t[0]:.3f} ms, frame ahead running {t[1]}, gc {t[2]:.3f} "
              f"ms, loop {t[4]:.3f}, mem_get_info {t[5]:.3f}, staging copy {t[6]:.3f}")


def submit_probe(seed: int, soak: float) -> None:
    """See the module docstring (``--submit-probe``)."""
    import statistics
    import time

    import numpy as np
    import torch

    import cuda_fft_convolution_torch as fc

    s, k, n = (chip_smoke.HEADLINE[key] for key in ("size", "k", "n"))
    rng = np.random.default_rng(seed + 4)
    frames = [rng.standard_normal((s, s, 1)).astype(np.float32) for _ in range(4)]
    bank = torch.as_tensor(rng.standard_normal((n, k, k, 1)).astype(np.float32),
                           device="cuda")
    stream = fc.ConvStream.create((s, s, 1), bank, depth=3, algorithm="tiled", mode="same")
    stream.submit(frames[0]).result()
    pinned = torch.empty((s, s, 1), pin_memory=True)
    host = torch.as_tensor(frames[1])

    def submit():
        stream.flush()
        stream.submit(frames[2])
        t0 = time.perf_counter()
        stream.submit(frames[3])
        return time.perf_counter() - t0

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    probes = {
        "torch copy_": lambda: timed(lambda: pinned.copy_(host)),
        "numpy copyto": lambda: timed(lambda: np.copyto(pinned.numpy(), frames[1])),
        "ConvStream submit": submit,
    }
    print(f"device total memory: properties {torch.cuda.get_device_properties(0).total_memory}"
          f" B, cudaMemGetInfo {torch.cuda.mem_get_info()[1]} B")
    print(f"submit probe: {torch.get_num_threads()} intra-op threads, "
          f"{len(os.sched_getaffinity(0))} cores; host ms, median / worst of 32 "
          f"({chip_smoke.card()})")
    for hogs in (0, 2, 4, 8):
        procs = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
                 for _ in range(hogs)]
        try:
            time.sleep(0.5)
            line = []
            for label, fn in probes.items():
                ms = [1e3 * fn() for _ in range(32)]
                line.append(f"{label} {statistics.median(ms):.3f} / {max(ms):.3f}")
            print(f"  {hogs} busy processes: " + "; ".join(line))
        finally:
            for proc in procs:
                proc.kill()
                proc.wait()
    stream.flush()
    if soak > 0:
        submit_soak(stream, frames, pinned, host, soak)


def io_plain(ops, geom, skip=(), wide=False):
    """The BF16IO plain version (``block_conv_reference`` at BF16IO, the
    same expressions) without the roundings named in ``skip`` ('s', 'x',
    'gm') and, with ``wide``, in float64 → (float32 maps (B, N, out_h,
    out_w), S's (re, im) before its rounding)."""
    import torch

    from cuda_fft_convolution_torch.ops.block_conv import _window_mats, bf16_round

    def rnd(x, what):
        return x if what in skip else bf16_round(x)

    def mac(d, k):
        return torch.einsum("bijfuv,nfuv->bijnuv", d, k)

    bh, bw, kh, kw, out_h, out_w = geom
    dtype = torch.float64 if wide else torch.float32
    dr, di, kr, ki = (t.to(dtype) for t in ops)
    gr, gi, mr, mi = (rnd(m.to(dtype), "gm")
                      for m in _window_mats(bh, bw, kh, kw, str(dr.device)))
    s_re, s_im = mac(dr, kr) - mac(di, ki), mac(di, kr) + mac(dr, ki)
    sr, si = rnd(s_re, "s"), rnd(s_im, "s")
    x_re, x_im = rnd(gr @ sr - gi @ si, "x"), rnd(gr @ si + gi @ sr, "x")
    tile = x_re @ mr + x_im @ mi
    b, nbh, nbw, n, vh, vw = tile.shape
    maps = tile.permute(0, 3, 1, 4, 2, 5).reshape(b, n, nbh * vh, nbw * vw)
    return maps[:, :, :out_h, :out_w].float(), (s_re, s_im)


def bf16_other(v):
    """(the bf16 neighbour of ``v`` that round-to-nearest did not pick,
    |v − the midpoint of the two| in float32 ulps of v)."""
    import torch

    r = v.to(torch.bfloat16)
    bits = r.view(torch.int16).to(torch.int32)
    bits = bits + torch.where(v.abs() > r.float().abs(), 1, -1)
    other = bits.to(torch.int16).view(torch.bfloat16).float()
    _, exp = torch.frexp(v)
    ulp = torch.ldexp(torch.ones_like(v), exp - 24)
    return other, ((v - (r.float() + other) / 2).abs() / ulp)


def flip_witness(ops, geom, got, want, s, candidates=4) -> dict:
    """(a) of ``--bf16io-witness``: the block, filter and position of the
    largest |got − want|, the error's spread over its tile, and the bins
    whose bf16 rounding, turned the other way in a one-block plain version,
    would move the plain value there: of S, the ``candidates`` nearest a
    bf16 boundary; of X, in the position's row, the ``candidates`` whose
    flip (its bf16 step × the W-stage matrix at the position's column) best
    matches got − want there → each with its distance from the boundary
    and the errors after the flip."""
    import torch

    from cuda_fft_convolution_torch.ops.block_conv import _window_mats, bf16_round

    bh, bw, kh, kw, out_h, out_w = geom
    vh, vw = bh - kh + 1, bw - kw + 1
    scale = float(want.abs().max())
    diff = (got - want).abs()
    b, n, y, x = (int(t) for t in torch.unravel_index(diff.argmax(), diff.shape))
    i, j, r, c = y // vh, x // vw, y % vh, x % vw
    rows, cols = slice(i * vh, min((i + 1) * vh, out_h)), slice(j * vw, min((j + 1) * vw, out_w))
    t_got, t_want = got[b, n, rows, cols], want[b, n, rows, cols]
    t_diff = t_got - t_want
    gr, gi, mr, mi = (bf16_round(m.float())
                      for m in _window_mats(bh, bw, kh, kw, str(got.device)))

    def x_stage(sr, si):  # X before its rounding, (Vh, Wc) re and im
        return gr @ sr - gi @ si, gr @ si + gi @ sr

    def tile(xr, xi):
        return (bf16_round(xr) @ mr + bf16_round(xi) @ mi)[: t_got.shape[0], : t_got.shape[1]]

    def errs(t):  # (at the position, the tile's largest), relative to the maps' max
        return (float((t[r, c] - t_got[r, c]).abs()) / scale,
                float((t - t_got).abs().max()) / scale)

    s_rounded = [bf16_round(part[b, i, j, n]) for part in s]
    x_un = x_stage(*s_rounded)
    base = tile(*x_un)
    out = {
        "block": [b, n, i, j], "at": [y, x], "err": float(diff.max()) / scale,
        "tile_err_mean": float(t_diff.mean()) / scale,
        "tile_err_std": float(t_diff.std()) / scale,
        "one_block_plain_vs_plain": float((base - t_want).abs().max()) / scale,
        "one_block_plain_vs_kernel": errs(base),
        "s_flips": [], "x_flips": [],
    }
    others, dists = zip(*(bf16_other(part[b, i, j, n]) for part in s))
    size, width = dists[0].numel(), dists[0].shape[1]
    for k in torch.cat([d.flatten() for d in dists]).argsort()[:candidates].tolist():
        part, (u, v) = k // size, divmod(k % size, width)
        flipped = [t.clone() for t in s_rounded]
        flipped[part][u, v] = others[part][u, v]
        out["s_flips"].append({"bin": ["re", "im"][part] + f"[{u},{v}]",
                               "ulps_from_boundary": float(dists[part][u, v]),
                               "errs_after_flip": errs(tile(*x_stage(*flipped)))})
    # X in the position's row: a flip moves the value there by its step × M
    x_row = [p[r] for p in x_un]
    x_others, x_dists = zip(*(bf16_other(p) for p in x_row))
    moves = torch.cat([(o - bf16_round(p)) * m[:, c]
                       for o, p, m in zip(x_others, x_row, (mr, mi))])
    target = t_got[r, c] - base[r, c]
    for k in (moves - target).abs().argsort()[:candidates].tolist():
        part, v = divmod(k, x_row[0].numel())
        flipped = [p.clone() for p in x_un]
        flipped[part][r, v] = x_others[part][v]  # rounds to the other neighbour
        out["x_flips"].append({"bin": ["re", "im"][part] + f"[{r},{v}]",
                               "ulps_from_boundary": float(x_dists[part][v]),
                               "errs_after_flip": errs(tile(*flipped))})
    return out


def bf16io_witness(seed: int) -> dict:
    """See the module docstring (``--bf16io-witness``)."""
    import numpy as np
    import torch

    import cuda_fft_convolution_torch as fc
    from cuda_fft_convolution_torch.ops.block_conv import block_conv, block_conv_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    s, k = chip_smoke.HEADLINE["size"], chip_smoke.HEADLINE["k"]
    image = torch.as_tensor(rng.standard_normal((s, s, 1)).astype(np.float32), device="cuda")
    bank = torch.as_tensor(rng.standard_normal((8, k, k, 1)).astype(np.float32), device="cuda")
    feats, dbank, _ = chip_smoke.dpm_inputs(seed)
    cases = {
        f"DPM plan, N={dbank.shape[0]}": (feats, dbank, chip_smoke.DPM["k"]),
        f"headline plan, N={bank.shape[0]}": (image, bank, k),
    }
    report_ = {"card": chip_smoke.card()}
    for label, (data, filters, kk) in cases.items():
        spec = fc.fft_data_tiled(data, kk, kk, trim_mode="same", store_dtype="bfloat16")
        sk = fc.fft_kernels(filters, spectral=spec, store_dtype="bfloat16")
        ops = (spec.re[None], spec.im[None], sk.re, sk.im)
        geom = (spec.block_h, spec.block_w, spec.max_kh, spec.max_kw, spec.out_h, spec.out_w)
        del spec, sk
        got = block_conv(*ops, *geom)
        want, s_parts = io_plain(ops, geom)
        row = {"geometry": list(geom),
               "io_plain_equals_block_conv_reference":
                   torch.equal(want, block_conv_reference(*ops, *geom)),
               "kernel_vs_plain": {"rel": chip_smoke.rel_err(got, want),
                                   "rms": chip_smoke.rms_rel_err(got, want)},
               "flip": flip_witness(ops, geom, got, want, s_parts)}
        del s_parts
        wide, _ = io_plain(ops, geom, wide=True)
        row["float64_plain"] = {
            "vs_float32_plain": {"rel": chip_smoke.rel_err(want, wide),
                                 "rms": chip_smoke.rms_rel_err(want, wide)},
            "vs_kernel": {"rel": chip_smoke.rel_err(got, wide),
                          "rms": chip_smoke.rms_rel_err(got, wide)}}
        del wide
        row["missed_rounding_rms"] = {}
        for skip in (("s",), ("x",), ("gm",), ("s", "x", "gm")):
            planted, _ = io_plain(ops, geom, skip)
            row["missed_rounding_rms"]["+".join(skip)] = chip_smoke.rms_rel_err(planted, want)
            del planted
        row["missed_rounding_rms"]["3xTF32 entry"] = chip_smoke.rms_rel_err(
            block_conv(*ops, *geom, torch.float32, 3), want)
        row["IO_RMS_TOL"] = chip_smoke.IO_RMS_TOL
        print(f"bf16io witness [{label}] ({report_['card']}):")
        print(json.dumps(row, indent=1))
        report_[label] = row
        del ops, got, want
        torch.cuda.empty_cache()
    return report_


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--calls", type=int, default=3)
    parser.add_argument("--ab-parent", type=pathlib.Path, default=None,
                        help="a parent checkout's cuda_fft_convolution_torch/csrc")
    parser.add_argument("--submit-probe", action="store_true",
                        help="time a ConvStream submit and its staging copy beside "
                             "busy processes")
    parser.add_argument("--bf16io-witness", action="store_true",
                        help="where the BF16IO maps entry parts from its plain version")
    parser.add_argument("--stacked-split", type=pathlib.Path, default=None,
                        help="a csrc whose stacked configuration's stages to time")
    parser.add_argument("--radix-split", type=pathlib.Path, default=None,
                        help="split the radix bodies' time at JAX's F=1 plan into their "
                             "stages (this csrc or a parent's)")
    parser.add_argument("--wide-split", type=pathlib.Path, default=None,
                        help="a csrc whose wide configuration's stages to time")
    parser.add_argument("--v2-plans", action="store_true",
                        help="time this tree's v2 entries at the five plans beside v3")
    parser.add_argument("--soak", type=float, default=0.0,
                        help="with --submit-probe: repeat the submit trial this many seconds")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_paths: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import cuda_fft_convolution_torch as fc
    from cuda_fft_convolution_torch.models import detect_peaks
    from cuda_fft_convolution_torch.ops.tiled import peaks_from_maps

    chip_smoke.env_report()
    if args.ab_parent is not None:
        ab_parent(args.ab_parent.resolve(), args.seed)
        return 0
    if args.stacked_split is not None:
        stacked_split(args.stacked_split.resolve(), args.seed)
        return 0
    if args.wide_split is not None:
        wide_split(args.wide_split.resolve(), args.seed)
        return 0
    if args.radix_split is not None:
        radix_split(args.radix_split.resolve(), args.seed)
        return 0
    if args.v2_plans:
        v2_turns(None, args.seed, "v2_plans.json")
        return 0
    if args.submit_probe:
        submit_probe(args.seed, args.soak)
        return 0
    if args.bf16io_witness:
        out = pathlib.Path("chiprun_out")
        out.mkdir(exist_ok=True)
        (out / "bf16io_witness.json").write_text(json.dumps(bf16io_witness(args.seed), indent=1))
        return 0
    image, bank, _ = chip_smoke.detection_headline(fc, args.seed)
    report("detect_peaks", lambda: detect_peaks(image, bank), args.calls)
    report("maps path (fft_conv + peaks_from_maps)", lambda: peaks_from_maps(
        fc.fft_conv(image, kernels=bank, mode="same", correlation=True)[None]),
        args.calls)
    report("fft_conv, fused", lambda: fc.fft_conv(image, kernels=bank, mode="same"),
           args.calls)
    report("fft_conv, direct", lambda: fc.fft_conv(
        image, kernels=bank, mode="same", algorithm="direct"), args.calls)
    report("fft_conv, bf16 tier", lambda: fc.fft_conv(
        image, kernels=bank, mode="same", store_dtype="bfloat16"), args.calls)
    del image, bank
    feats, dbank, _ = chip_smoke.dpm_inputs(args.seed)
    k = chip_smoke.DPM["k"]
    sd = fc.fft_data_tiled(feats, k, k, trim_mode="same", store_dtype="bfloat16")
    sk = fc.fft_kernels(dbank, spectral=sd, store_dtype="bfloat16")
    report("DPM conv_spectral, bf16 tier, f32 maps",
           lambda: fc.conv_spectral(sd, sk, mode="same"), args.calls)
    report("DPM conv_spectral, bf16 tier, bf16 maps",
           lambda: fc.conv_spectral(sd, sk, mode="same", out_dtype="bfloat16"), args.calls)
    report("DPM detect_peaks from the features, bf16 tier",
           lambda: detect_peaks(feats, dbank, store_dtype="bfloat16"), args.calls)
    n = chip_smoke.DPM_DIRECT["n"]
    dsd = fc.fft_data(feats, k, k, store_dtype="bfloat16")
    dsk = fc.fft_kernels(dbank[:n].contiguous(), spectral=dsd, store_dtype="bfloat16")
    report(f"DPM direct conv_spectral fftmap, {n} filters resident, bf16 tier",
           lambda: fc.conv_spectral(dsd, dsk, mode="fftmap"), args.calls)
    del sd, sk, dsd, dsk, feats, dbank
    torch.cuda.empty_cache()

    image, cells, _, _ = chip_smoke.ragged_inputs(args.seed)
    image_d = torch.as_tensor(image, device="cuda")
    cells_d = [torch.as_tensor(c, device="cuda") for c in cells]
    report("ragged fft_conv (configs[1])",
           lambda: fc.fft_conv(image_d, kernels=cells_d, mode="same"), args.calls)
    ragged = fc.RaggedConvStream(image.shape, cells_d, depth=3, mode="same", algorithm="tiled")
    report("RaggedConvStream, tiled, depth 3, 8 host frames",
           lambda: serve(ragged, [image] * 8), args.calls, frames=8)
    del ragged, image_d, cells_d

    s, k = chip_smoke.HEADLINE["size"], chip_smoke.HEADLINE["k"]
    rng = np.random.default_rng(args.seed + 4)
    frames = [rng.standard_normal((s, s, 1)).astype(np.float32) for _ in range(16)]
    hbank = torch.as_tensor(rng.standard_normal((chip_smoke.HEADLINE["n"], k, k, 1))
                            .astype(np.float32), device="cuda")
    for depth in (1, 3):
        stream = fc.ConvStream.create((s, s, 1), hbank, depth=depth, algorithm="tiled",
                                      mode="same")
        report(f"headline ConvStream, depth {depth}, 16 host frames",
               lambda: serve(stream, frames), args.calls, frames=len(frames))
        del stream
    del frames, hbank
    torch.cuda.empty_cache()

    from cuda_fft_convolution_torch import models

    feats, dbank, _ = chip_smoke.dpm_inputs(args.seed, store="float32")
    k = chip_smoke.DPM["k"]
    pyr = models.build_pyramid(feats, k, k, num_levels=chip_smoke.PYRAMID["levels"])
    report("pyramid detect_pyramid_peaks, 1024 filters, 5 levels",
           lambda: models.detect_pyramid_peaks(pyr, dbank), args.calls)
    del pyr, feats, dbank
    torch.cuda.empty_cache()
    images, _, model, targets = chip_smoke.trainer_inputs(fc, args.seed)
    opt = torch.optim.Adam(model.parameters(), lr=chip_smoke.TRAINER["lr"])
    report(f"trainer train_step, {tuple(images.shape)}, {model.num_filters} filters",
           lambda: models.train_step(model, opt, images, targets), args.calls)
    del images, model, targets, opt
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 7)
    frames, centres = chip_smoke.mosse_scene(gen, hog=True)
    estimates, filt = chip_smoke.mosse_track(fc, frames, centres, gen)
    win = chip_smoke.MOSSE["window"]
    centred = models.gaussian_target(win, win, (win // 2, win // 2), chip_smoke.MOSSE["sigma"])
    report("MOSSE frame, HOG cells (F=31)", lambda: chip_smoke.mosse_frame(
        fc, filt, frames[-1], estimates[-1], centred), args.calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
