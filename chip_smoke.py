#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cuda_fft_convolution_torch) on one CUDA GPU.

    python3 chip_smoke.py [--seed 0] [--ab-parent PARENT/cuda_fft_convolution_torch/csrc]

Run from the repository root on a machine with an NVIDIA H100 (sm_90a),
``nvcc`` and PyTorch built for CUDA. It

  1. prints the card (nvidia-smi name and power limit), the PyTorch and CUDA
     versions, and turns TF32 off for matmuls and cuDNN;
  2. builds the CUDA kernels from ``cuda_fft_convolution_torch/csrc``
     (four libraries side by side: the v3 entries and the MAC, the radix
     bodies', the Karatsuba and v2 entries', the radix bodies' Karatsuba
     entries'), prints what ptxas reports
     (registers, shared memory, spills) and fails on a spill, and holds
     the Python configuration model (shared memory, rows, blocks and
     kernels per CTA, the cluster size and a pair's bins; the Karatsuba
     and v2 configurations too) against the kernel's over (vh, wc) pairs;
  3. holds the fused block-conv kernel against its plain PyTorch version on
     the card at a small ragged shape, the widest 64-row block, a wide
     block (the paired configuration: a cluster of two 64-row CTAs that
     split the bins), two short-window
     shapes whose blocks stack in a CTA (a partial last group; rows
     straddling blocks), the planner's largest block (1024², the longest
     contractions of the 3xTF32 syntheses), the (256, 896) plan of 129²
     kernels (a pair) and the headline plan's geometry; for each paired
     geometry it prints each tier's and form's bins and passes a CTA, the
     cluster size, row chunks and shared memory, and the paired kernels'
     registers and spills (fails on a pass of under 32 bins or columns);
  4. runs the headline call — ``fft_conv`` of a 2048² fp32 image with 100
     kernels of 64², mode 'same', on the GPU — checks that it went through
     the kernel and agrees with a float64 numpy reference on 8 kernels, and
     that the amortized path (fft_data_tiled + fft_kernels + conv_spectral)
     gives the same maps;
  5. times the fused call, the same call through the unfused torch.fft
     pipeline, and the kernel alone against its plain version, with CUDA
     events (median of 7 runs after a warm-up); the MAC
     kernel at the unfused pipeline's launch shape (every block against
     the bank, read from ``spectral_mac.launches_by_shape``) against the
     einsum;
  6. holds the peaks kernel against its plain version at the geometries of
     step 3 (values within 1e-5 relative, 5e-3 at BF16IO; indices equal
     except in near-tie cells, where the kernel's position must hold a
     plain value within tolerance of the cell max), and at the headline
     plan with N=100;
  7. runs the detection headline — ``detect_peaks`` of a 2048² noise image
     with the 100 kernels planted once each at 3× amplitude on a 10×10 grid
     — checks that it went through the peaks kernel, found every planted
     centre and agrees with the argmax of the ``fft_conv`` maps, and checks
     ``detect_top_k`` (k=1 and k=5) and ``detect_local_peaks`` against the
     same maps;
  8. runs the direct engine at the headline shape, checks that it went
     through the MAC kernel and agrees with float64 numpy on 8 maps, and
     holds the MAC kernel against the einsum at the direct shape with F=1
     and F=3 channels, and every form the MAC kernel instantiates (its
     register tiles and the split form) at ragged shapes (partial image and
     filter tiles and pixel chunks, the trainer's launch pattern, one image)
     on f32 and bf16 planes against the einsum, the register tiles bitwise
     equal to each other and the wrapper to the rule's form;
  9. times the detection call against the maps path, the peaks kernel
     against its plain version, the direct call, and the MAC kernel
     against the einsum at F=1 and F=3;
 10. the bf16 serving tier's kernel modes (steps 3 and 6 run them too: bf16
     spectra at their default tier, BF16IO, within 5e-3 of the plain
     version at that tier on the same bf16 planes and 1e-4 in root mean
     square — the two round S and X to bf16 after sums in other orders —
     and at the explicit 3xTF32 within 1e-5; bf16 maps within 5e-3 of its
     float32 maps): the MAC kernel on bf16 planes against the einsum at F=1
     and F=3 (1e-6);
 11. the headline at the tier — ``fft_conv(..., store_dtype='bfloat16')``,
     the same with ``out_dtype='bfloat16'``, and float32 spectra with bf16
     maps — against float64 numpy on 8 maps (2e-2, or 5e-3 for bf16 maps
     alone), the direct engine at the tier, and ``detect_peaks`` at the
     tier on the detection headline (every planted centre found); times
     each call beside the float32 call, and the f32-spectra bf16-maps
     kernel at the headline plan beside its plain version;
 12. the DPM/HOG detector path at full width: a 4096² image from the seed
     through ``hog_features(cell=8, bins=31)`` to (512, 512, 31) features
     cast to bf16, a bank of 1024 filters of 12×12×31, then
     ``fft_data_tiled(trim_mode='same', store_dtype='bfloat16')``,
     ``fft_kernels(store_dtype='bfloat16')`` and ``conv_spectral(mode=
     'same')`` with float32 and with bf16 maps, each against float64 numpy
     on 8 maps (2e-2); 8 filters planted in the features and found by
     ``detect_peaks`` at the tier; the stacking there (``stacked_report``:
     blocks and kernels a CTA, which must both be 2 or more, CTAs, shared
     memory, ring steps, the stacked entry's registers and spills, the
     modelled L2->shared bytes a call, the MFLOP per cell it issues on the
     CUDA cores and the tensor cores beside the useful ones, the H stage on
     the tensor cores); the kernels against their plain versions at that
     plan, and times;
 13. the clamp headline: ``fft_conv(..., padding='clamp')`` on the headline
     shape (the direct engine, the MAC kernel) at the scipy and the matlab
     anchor, against an edge-padded float64 FFT reference on 8 maps (1e-5);
 14. the centered headline: ``kernel_layout='centered'`` on the same inputs,
     against float64 (1e-5) and the corner call at the matlab offset (1e-6);
 15. the ragged cell array (BASELINE.json configs[1]): a 512² image with 4
     kernels each of 9², 17², 33² and 64², mode 'same', bucketed by pow-2
     envelope (the fused kernel once a bucket), every map against float64
     (1e-5); ``detect_peaks`` on the cell array finds each planted kernel;
 16. the DPM giant bank on the direct engine (BASELINE.json configs[4]): the
     first 576 DPM filters at the bf16 tier and a 540² FFT (a 10.45 GB bank,
     transformed in planned chunks), ``conv_spectral(mode='fftmap')`` at the
     planner's plan against float64 on 8 maps (2e-2), forced into 9 chunks
     by ``hbm_budget_bytes`` (1e-6 against the unchunked maps), and
     streamed as spatial kernels under a budget below twice the resident
     bytes (2e-2 against float64 and the resident call);
 17. the pipelined batch (BASELINE.json configs[3]): 8 headline images with
     the headline bank through ``conv_spectral_pipelined(mode='same')`` on
     tiled spectra (the fused kernel, the planner's chunks) and on direct
     spectra (the MAC kernel, chunks of 16), each against ``conv_spectral``
     on the same spectra (1e-6) and 2 maps against float64 (1e-5).

 18. plans at the headline (``runtime/plan.py``): a tiled 'same' plan whose
     ``execute`` maps equal ``fft_conv``'s bitwise and are within 1e-5 of
     float64 on 8 maps, ``execute_spectral`` and ``execute`` timed beside
     ``fft_conv``; a direct 'fftmap' plan (the MAC kernel) against float64
     circular maps; a ``head='peaks'`` plan on the detection headline that
     finds all 100 planted centres, equal to ``detect_peaks``' positions;
 19. ``ConvStream`` headline serving: 16 seeded host (numpy) frames at depth
     3 (the pinned ring), each frame's maps bitwise equal to the synchronous
     plan's for that frame, with an ``update_kernels`` swap before frame 8;
     the steady-state ms a frame at depths 1 and 3 beside 16 synchronous
     ``plan.execute`` calls (wall time between synchronizes over the
     count); the host time of a submit into a queue with room (one frame
     ahead in flight), under ``torch.cuda.set_sync_debug_mode('error')``,
     which must stay below 25% of one frame's device time (min of 7 CUDA
     event runs): more would show a hidden synchronisation; beside it, each
     trial's host copy of a frame into pinned memory alone and the
     synchronous loop's ms a frame, which tell host load (the copy slows
     too) from a stall in the stream (it does not);
 20. detection serving: ``ConvStream(head='peaks')`` on 8 detection-headline
     frames (new noise, the same plants): all 100 plants in every frame,
     equal to each frame's ``detect_peaks``; ms a frame beside it;
 21. the DPM detector loop at the tier: 8 frames of HOG features of 4096²
     images with the 8 filters planted, ``ConvStream(head='peaks',
     store_dtype='bfloat16')`` at depth 3 (the stacked kernel): the planted
     filters found in every frame; ms a frame beside the synchronous plan;
 22. ``RaggedConvStream`` on configs[1]'s cell array: four exact-shape groups
     on the tiled and the direct engine, every map within 1e-5 of float64
     and of ``fft_conv``'s buckets; with ``head='peaks'`` all 16 planted
     cells found; ms a frame beside ``fft_conv``'s ragged call;
 23. the tuner at the headline shape: ``autotune_block_geometry((2048, 2048,
     1), 64, 64, n_kernels=32)`` over ``default_candidates(64, 64)`` and the
     analytic (64, 384); a table of candidate → ms and fused flag; the
     winner registered under the card's name and returned by
     ``choose_block_plan``; ``fft_conv`` at the winner within 1e-5 of
     float64 on 8 maps, timed beside the analytic plan; the table cleared;
 24. the pyramid at DPM width (``models/pyramid.py``): the DPM features at
     float32 with 8 DPM filters planted, each enlarged 2x by
     ``resize_bilinear`` at 3x amplitude, ``build_pyramid(num_levels=5,
     scale=2^-0.5)`` (levels 512, 362, 256, 181, 128) and
     ``detect_pyramid_peaks`` with the 1024 filters: every plant found at
     level 2 within 3 cells of its centre; per level the bank's route
     (resident, chunked or streamed: ``api.direct_bank_plan``, which
     ``conv_spectral`` calls, on this card's budget) and its MAC
     launches; every level's values and positions equal to the argmax of
     ``detect_pyramid``'s maps; levels 0 and 2 within 1e-5 of
     float64 on 8 maps; the three calls timed; the MAC kernel at level 0's
     shape (the 37.2 GB bank) against the einsum over chunks of 64 filters;
 25. the MOSSE tracker (``models/mosse.py``) at Bolme et al.'s settings (a
     64² window, 8 training perturbations, sigma 2, lr 0.125), on pixels
     (F=1) and on HOG cells (F=31): a target moved along a known path over
     64 frames, each frame ``respond`` then ``update_mosse``; the peak on
     the path (within 1) on every frame, ``respond``'s MAC (the kernel on
     a bank of one; at HOG cells every launch in the split form, counted by
     ``spectral_mac.launches_by_form``) within 1e-5 of the einsum, a frame
     timed;
 26. the filter-bank detector (``models/filter_bank.py``): 8 frames of the
     DPM features (centred, shifted, noised) and 64 filters of 12²x31
     carried from numpy by ``detector_from_numpy``; ``detect`` within 1e-5
     of float64 on 8 maps; 8 ``train_step``s with Adam (lr 3e-2) against a
     second detector's maps: the loss falls, each step launches the MAC
     once at the forward's shape and once at dK's (the counts by launch
     shape), the first step's gradients within 1e-4 of the einsum's
     autograd on the card; a backward with the images' gradient too
     launches once at dD's shape as well; a step, its forward and its
     backward timed; the MAC kernel at the forward, dK and dD shapes
     against the einsum.

 27. the cores of ``ops/conv.py`` at the headline: ``fft_conv_stack`` of the
     channel-leading 2048² image with the 100 kernels of 64² at the FAST
     FFT size (2160²): (100, 2160, 2160) maps, one MAC-kernel launch a call
     at (B, F, N, H, Wc) = (1, 1, 100, 2160, 1081), 8 maps within 1e-5 of
     float64 circular maps and within 1e-6 of ``fft_conv(mode='fftmap',
     algorithm='direct')``; ``fft_conv_single`` with kernel 0 within 1e-6
     of map 0; ``direct_conv_single``, called with cuDNN's TF32 on, within
     1e-5 of float64 on its 2111² output and on 64 random channels of 128²
     with a 3×3 kernel, where cuDNN rounds to TF32 when allowed (it runs
     with TF32 off; the same ``conv2d`` with TF32 left on is printed
     beside it), the setting restored; each timed;
 28. the complex MAC wrappers ``spectral_mac_pallas`` and
     ``spectral_mac_auto`` on the complex headline spectra (direct shape,
     F=1): one kernel launch each, within 1e-6 of ``spectral_mac_einsum``;
     ``SpectralData.from_reference_packed`` on the headline image's
     spectrum in the reference's H-packed layout (float64 numpy):
     ``conv_spectral(mode='same')`` within 1e-5 of the ``fft_data`` path;
     ``from_packed`` (complex and planes) and ``from_complex`` give
     ``fft_data``'s planes bitwise;
 29. ``selftest()`` on the card: every C entry (the four maps entries and
     the two peaks entries in the 64-row, paired, 32-row and stacked
     configurations, the two MAC entries at every tile) within its bar of
     its plain version, the peaks' indices equal;
 30. ``utils.profiling.benchmark`` of the headline ``fft_conv`` beside this
     run's CUDA-event time (only 0 < min ≤ median is checked);
 31. the six demos (``cuda_fft_convolution_torch.demos``) at their default
     sizes on the card, each passing its own checks;
 32. the parallel layer (``parallel/``) in a world of one NCCL rank,
     ``make_mesh(data=1, kernels=1)``: ``conv_spectral_sharded`` on the
     headline tiled spectra with a bank from ``shard_kernel_bank`` (placed
     a second time: the same bank back, its local shard where it lay),
     ``full_tensor()`` equal to ``conv_spectral``'s maps bitwise; the
     per-rank program run for each of 3 kernel shards of the headline bank
     in turn (34 + 34 + 32, zero-padded), concatenated within 1e-6 of the
     unsharded maps (whether bitwise printed); the direct engine bitwise,
     the MAC kernel launched once at (1, 1, 100, 2160, 1081); the DPM giant
     bank streamed under step 16's forced budget, bitwise equal to the
     single-device streamed maps; ``detect_peaks_sharded`` on the detection
     headline (all 100 plants, = ``detect_peaks``; k=5 = ``detect_top_k``);
     ``ShardedConvStream`` over step 19's 16 host frames at depth 3, each
     frame bitwise equal to ``ConvStream``'s, ms a frame beside it, and a
     submit into a queue with room under sync debug mode 'error' below 25%
     of a frame's device time; ``train_step_sharded`` at the trainer's width
     (8x31x512², 64 filters, Adam) against ``train_step`` on the same
     parameters: the loss within 1e-6, the kernels within 1e-5, its MAC
     launches by shape, and the MAC kernel on the step's forward and dK
     operands against the einsum (its own two JSON rows).

 33. the two BASELINE paths no earlier step runs at full size: the maps and
     peaks kernels in every dtype mode against their plain versions at the
     large-kernel plan (1023, 1024, 512, 512) (an odd Lh, the 1023-long H
     contraction, Wc 513 in the paired configuration) with N=3 and a
     clipped window, and at the F=8 tier's plan (63, 287, 32, 32) (stacked)
     with F=8, N=5; ``fft_conv`` of the headline image with 16 kernels of
     512², 'same' (BASELINE.json configs[2]): every maps launch at that
     plan, 8 maps within 1e-5 of float64, the direct route within 1e-5
     too, the call, its amortized form and the direct call timed; 1024²×8
     with 64 kernels of 32²×8 at the bf16 tier: every launch at its plan,
     8 maps within 2e-2 of float64, the call and its amortized form timed,
     its stacking (``stacked_report``); ``detect_peaks`` on each (the peaks kernel at each
     plan, launched on the main path and timed beside its plain version);
     then the port's bench (``python -m
     cuda_fft_convolution_torch.bench``) at full size in this process: its
     JSON line, every row present and positive, its accuracy row within
     1e-5, its wall time.
 34. the fused kernels' precision tiers (``ops/block_conv.py
     fused_splits``): every 6xTF32 and one-pass entry (f32 maps, bf16
     maps, peaks) against its plain version at the geometries of step 3
     and the two plans of step 33 — 6xTF32 within 5e-7 of the plain version
     run in float64 and within 1e-5 of its float32 run (printed beside the
     float32 plain version's own error), one pass within 2e-3 — and
     ``fused_precision='highest'`` with ``matmul_precision='high'`` bitwise
     equal to the default tier; then under 'highest' (6xTF32) and under
     'highest' with ``matmul_precision='default'`` (one pass), each a main
     path: the headline ``fft_conv`` (f32 and bf16 maps) against float64
     on 8 maps (6xTF32: at most 1.25x the error of the plain version's maps
     on the same spectra, printed beside it), ``detect_peaks`` on the
     detection headline (all 100 plants, = the argmax of the tier's maps),
     and the 16 x 512² large-kernel call (every launch at its plan) against
     float64, each call timed; each tier's kernels timed beside the default
     tier's, with their bounds (the tier's TF32 passes at 495 TFLOP/s). The
     config is restored in a ``finally``.
 35. the bf16 tier's single pass, BF16IO (``ops/block_conv.py BF16IO``, the
     default of bf16 spectra): the headline ``fft_conv`` at the tier against
     float64 (2e-2) and its bf16 maps against its f32 maps (5e-3), the
     ``_io`` maps kernels (f32 and bf16 maps) on the headline's bf16
     spectra against their plain version, the control (``io_control``);
     ``detect_peaks`` on the detection headline at the tier (all
     100 plants, = the argmax of the tier's maps, the peaks kernel's row),
     the bf16-maps and peaks entries bitwise against the f32-maps entry
     (``check_io_bitwise``, also at the DPM and F=8 plans and in steps 3
     and 33); at the DPM plan the 3xTF32 twins (``block_conv_bf16``,
     ``_bf16maps``, ``block_conv_peaks_bf16``, launched by explicit
     ops-level calls with ``splits=3``, JAX's explicit
     ``precision=BF16X3`` on bf16 planes; no route of the package takes
     them) and ``detect_peaks`` at the tier
     (the 8 plants, = the argmax of the tier's maps); the twins at the F=8
     plan; the 16 x 512² large-kernel call at the tier (paired
     configuration) against float64 (2e-2) and its kernel; then each _io
     entry's ms beside its twin's and its bound (one bf16 pass at 989
     TFLOP/s, or the bytes).
 36. the radix-2 bodies (JAX's v4, v5, v5x; ``ops/block_conv.py
     radix_h``, ``radix_w``, ``xsliver``) at three of JAX's one-block
     plans, reached through the tuner's table (``RADIX_PLANS``): (256,
     512, 65, 129), JAX's fp32 and bf16 F=1 plan, 64 rows; (128, 512, 33,
     129), its 32² plan; (256, 1024, 65, 129), Wc 513 (every radix body
     runs the cluster pair there, as v3 does, and at 6xTF32 on Wc 257)
     — each on
     the headline image with 100 kernels (64², or 32² at the 32² plan): v3
     and every radix entry in both H-stage forms (the 4-product entries and
     the Karatsuba ones, ``_r4_k``, ``_r5_k``, ``_r5x_k``: f32 and bf16
     maps, peaks) at every tier against its plain version with the same
     flags (the bars of steps 3, 6, 34 and 35; 6xTF32 also against the
     plain version in float64, the BF16IO control), its maps against
     float64 on 8 maps (1e-5 at fp32, 2e-3 at one pass, 2e-2 at bf16
     spectra), the refusal where the kernels do not take a form (the
     Karatsuba form at 6xTF32 on Wc 513), and every 4-product entry's
     time (and every v4 Karatsuba entry's), with the configuration it runs
     (the pair, 64 or 32 rows) and its plain version's time, beside the
     bound of the body's own products (``synthesis_flop`` with the body,
     the JSON rows' ``bound_ms``) and the bound of v3's work, the same
     work whatever body runs it (``same_work_bound_ms``); then the main
     path at JAX's F=1 plan: ``fft_conv`` (f32 and bf16 maps) and
     ``detect_peaks`` at
     every tier with the plan tuned (v4, which ``radix_h_legal`` selects)
     and registered (``register_radix_w_plan``: v5, and v5x with
     ``sliver='xla'``), against float64 and the 100 plants, each radix
     entry's row there (the bf16 spectra's 3xTF32 entries and v4's BF16IO
     peaks entry, which JAX's float32-only auto rule keeps off the route,
     launched by explicit ops-level calls), each Karatsuba radix entry's
     row there (an ops-level call: no route passes ``karatsuba``), each
     body's maps entry 4-product / Karatsuba / Karatsuba / 4-product in
     turns at 3xTF32 and BF16IO; and the headline ``fft_conv`` at the v5
     plan against the analytic plan, in turns, the v5 maps against
     float64. The tuner's table and the plan registry are restored
     afterwards; the step's host seconds;
 37. the other H-stage forms (``ops/block_conv.py karatsuba``,
     ``wstack``): the Karatsuba H stage in v3 (maps and peaks, entries
     ``_k``) and the v2 body (maps, ``_v2`` and ``_v2_k``) at the headline
     plan (N=100), JAX's F=1 plan (256, 512, 65, 129) on the same image and
     bank, the DPM plan (float32 HOG features, 1024 filters; bf16
     spectra the same planes rounded), the 512² plan and the F=8 plan:
     every entry at every tier against its plain version with the same
     flags (the bars of steps 3, 6, 34 and 35), the f32 maps at the fp32
     tiers against float64 on 8 maps, 6xTF32 against the plain version
     in float64 beside v3's (held to 5e-7 at the headline plan and, as
     step 34 holds v3's, on step 3's and step 33's random planes; a
     reading at the real-data DPM, 512² and F=8 plans), the refusal where
     the kernels do not take a form (``form_taken``: the Karatsuba stage
     at 6xTF32 on the 1024 blocks, whose shared memory does not fit);
     v2's configuration at each plan (v3's of the same form: rows, pair
     bins, blocks a CTA — MBH; one plan must run MBH >= 2); every entry's row
     at the headline plan (launched by an
     explicit ops-level call: no route passes either flag), its bound
     counting the Karatsuba form's 3 of 4 H products (``synthesis_flop``)
     beside v3's 4-product work (``same_work_bound_ms``); the headline
     maps entry in turns, 4-product / Karatsuba / Karatsuba / 4-product;
     and each form's maps kernel ms beside v3's at every plan and tier.

At every MAC row (the direct shape's F=1 and F=3, f32 and bf16, the
unfused headline's and the model layer's shapes) it prints the form the
rule (``mac_tile``: a register tile, or the split form where the (1, 1)
tile's grid leaves SMs idle, as at MOSSE's respond) picked and the time of
every instantiated form; the row's kernel and one-complex-einsum times are
windows of 10 calls back to back (the one-call window beside them), and
each is also read as device time from a CUDA graph of 10 calls replayed.
With ``--ab-parent`` it builds that checkout's ``spectral_mac.cu`` (the
parent commit's, unpacked with ``git archive``) and times it against this
tree's at each MAC row in turns, parent, this tree, this tree, parent (bare
C entries, each at its own rule's form, CUDA events, median of 7 windows
of 10 calls, and of one call), the outputs compared: bitwise where both
rules pick the same form, within 1e-5 of the plain version where the
parent ran the (1, 1) tile and this tree the split form (it sums in
another order); at such a row the wrapper and the complex einsum are timed
in the same turns. It also builds the parent's fused kernels and times, in
the same turns, every entry the paired configuration took over from the
parent's 32-row tiles (the radix maps and peaks entries of both H-stage
forms that this tree pairs and the parent did not, at step 36's plans),
each side against the plain version, the paired entries of v4 (beside
v5's and v5x's) and v3 timed beside each (``wide_ab``).

Steps 13–37 print each check, each time (CUDA events, median of 7, unless
said otherwise) beside the card's name and power limit, the kernel launches
of each call, the planner's plans and each phase's peak allocation; the
smoke fails if its peak allocation reaches 60 GiB.

It prints one JSON line describing every kernel mode (the float32 and bf16
entries of the three kernels, and the MAC's shapes of steps 24–26 as
``spectral_mac_f32:<shape>``, whose launches are the main path's at that
launch shape, ``spectral_mac.launches_by_shape``, and step 32's sharded
training step's own forward and dK rows, ``spectral_mac_f32:<shape>_sharded``
on that step's operands, and step 33's maps-kernel rows at the large-kernel
and F=8 plans, ``block_conv_f32:large_kernel`` and ``block_conv_bf16_io:f8_tier``,
whose launches are the main-path call's at that plan,
``block_conv.launches_by_shape``, and the peaks kernel's there,
``block_conv_peaks_f32:large_kernel`` and ``block_conv_peaks_bf16_io:f8_tier``,
and step 34's tier entries, ``block_conv_f32_x6``, ``block_conv_f32_x1``,
their ``_bf16maps`` and ``block_conv_peaks_f32_x6`` / ``_x1`` modes and
the maps entries at the large-kernel plan, and the BF16IO entries
``block_conv_bf16_io``, ``block_conv_bf16_bf16maps_io`` and
``block_conv_peaks_bf16_io`` (at the DPM plan, from step 12; at the F=8
plan from step 33, ``:f8_tier``; at the headline and large-kernel plans
from step 35, ``:headline``, ``:large_kernel``), whose 3xTF32 twins are
the ``block_conv_bf16`` rows (step 35; their launches are explicit
ops-level calls, and their ``called_by`` key says so — every other row's
says "main path"): launches on the main path, error, time,
plain time, the bound worked out from the shapes — the larger of the
operations at the peak rate of the units that run them and the bytes at
3.35 TB/s; ``block_conv_bound`` and ``mac_bound`` say which; a radix
body's rows count its own products, and their ``same_work_bound_ms`` v3's,
as do step 37's Karatsuba and v2 rows, launched by explicit ops-level
calls — and the time of the one PyTorch call that computes the same
function, where there is one: none for the fused kernels),
then, as its last line,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import functools
import itertools
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np

TOL = 1e-5  # max |x − ref| / max |ref|: the repo's fp32 bar
BF16_TOL = 2e-2  # the bf16 tier against float64 (tests/test_bf16_tier.py)
BF16_OUT_TOL = 5e-3  # bf16 maps against float32 maps (tests/test_out_dtype.py)
MAC_BF16_TOL = 1e-6  # MAC kernel vs einsum on bf16 planes: exact products
HEADLINE = dict(size=2048, n=100, k=64)
# The detection headline: the headline shape, each kernel planted once at
# 3x amplitude, top-left corners on a grid x grid lattice.
DETECT = dict(HEADLINE, grid=10, stride=200, offset=100, amplitude=3.0)
# The DPM/HOG detector config (BASELINE.json configs[4], bench.py:358-462):
# a 4096² image → HOG (cell 8, 31 bins) → 512²×31 bf16 features, 1024
# filters of 12×12×31, 'same' maps; `plants` filters are planted in the
# features at `amplitude` for the detection check.
DPM = dict(image=4096, cell=8, bins=31, n=1024, k=12, plants=8, amplitude=0.1)
RUNS = 7
# The fused kernels' synthesis tiers' bars (ops/block_conv.py
# fused_splits) against the plain version (step 34): 6xTF32 within 5e-7 of
# the plain maps, one pass within 2e-3; the 'highest' headline's float64
# error at most 1.25x the plain version's.
X6_TOL = 5e-7
X1_TOL = 2e-3
X6_F64_RATIO = 1.25
# The BF16IO tier (bf16 spectra's default) against its plain version: the
# two round S and X to bf16 after fp32 sums taken in other orders, so a
# value at a rounding boundary (bf16 products are exact, so exact ties are
# common) lands one bf16 step (2^-8) the other way. On the H100 the largest
# error read 5.6e-5 to 3.7e-4 on random planes and at the headline, 2.0e-3
# at the DPM plan: one X value there, at an exact tie in the plain
# version's X, row 6 and W bin 0 of its block, rounded the other way by the
# kernel; flipped in the plain version it leaves 1.3e-7
# (``profile_torch_paths.py --bf16io-witness``), and the plain version
# summed in float64 reads the same 2.0e-3 from the float32 one. The
# largest error is held to IO_TOL, the envelope of one bf16 rounding (the
# bf16 maps' bar); the root mean square, which such rare steps hardly move
# (1e-5 to 4e-5 there) but a product that missed its rounding would
# (1.6e-3 to 3.9e-3 in the witness), to IO_RMS_TOL. Each run shows the RMS
# bar's power (``io_control``: the 3xTF32 entry, which rounds neither S nor
# X, fails it), and the bf16-maps and peaks entries are held bitwise to
# the f32-maps entry (``check_io_bitwise``), which carries both bars.
IO_TOL = 5e-3
IO_RMS_TOL = 1e-4
# The bf16 spectra's 3xTF32 entries (JAX's explicit precision=BF16X3): no
# route of the package takes them, so their rows' launches are explicit
# ops-level calls with splits=3 (step 35).
OPS_LEVEL_MODES = ("block_conv_bf16", "block_conv_bf16_bf16maps", "block_conv_peaks_bf16")
# Step 36's rows whose launches are explicit ops-level calls (the bf16
# spectra's 3xTF32 radix entries, and v4's BF16IO peaks entry, which JAX's
# float32-only auto rule keeps off the route) → their ``called_by``.
OPS_LEVEL_ROWS: dict = {}


def env_report() -> None:
    import torch

    print(card())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")


def build_kernels() -> None:
    """Build the kernels, print what ptxas reports (and fail on a spill),
    and hold the Python configuration mirror (shared memory, rows, blocks
    per CTA) against the kernel's C entries over (vh, wc) pairs."""
    from cuda_fft_convolution_torch import _build
    from cuda_fft_convolution_torch.ops.block_conv import (
        TIERS,
        blocks_per_cta,
        cluster_size,
        kernel_layout,
        kernels_per_cta,
        pair_bins,
        smem_bytes,
        tier_name,
        tile_rows,
        v2_blocks,
        v2_rows,
        v2_smem_bytes,
    )

    t0 = time.perf_counter()

    def build(**kind):
        lib = _build.library(**kind)
        return lib, time.perf_counter() - t0

    # the four libraries' sources, every nvcc started together
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        radix_build = pool.submit(build, radix=True)
        forms_build = pool.submit(build, forms=True)
        radix_forms_build = pool.submit(build, radix=True, forms=True)
        lib, core_s = build()
        radix_s = radix_build.result()[1]
        forms_lib, forms_s = forms_build.result()
        radix_forms_s = radix_forms_build.result()[1]
    print(f"build: {max(core_s, radix_s, forms_s, radix_forms_s):.1f} s (side by side: the "
          f"library {core_s:.1f} s, the radix bodies' library {radix_s:.1f} s, the Karatsuba "
          f"entries' library {forms_s:.1f} s, the radix bodies' Karatsuba entries' "
          f"library {radix_forms_s:.1f} s)")
    spills = []
    for line in _build.build_log().splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill", "error")):
            print(f"  ptxas: {line.strip()}")
        if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            spills.append(line.strip())
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")
    if not _build.build_log():
        print("  (the libraries were built before this process: no ptxas report)")
    pairs = 0
    for splits in TIERS:
        for wc in (17, 70, 76, 96, 97, 128, 129, 160, 161, 168, 169, 224, 256, 257, 320, 321,
                   384, 385, 451, 513, 577, 609, 641, 769):
            for vh in (1, 2, 3, 7, 8, 13, 16, 17, 21, 31, 32, 33, 64, 100):
                got = (lib.fftconv_block_conv_f32_smem_bytes(wc, vh, splits),
                       lib.fftconv_block_conv_f32_rows(wc, vh, splits),
                       lib.fftconv_block_conv_f32_blocks(wc, vh, splits),
                       lib.fftconv_block_conv_f32_kernels(wc, vh, splits),
                       lib.fftconv_block_conv_f32_cluster(wc, vh, splits),
                       lib.fftconv_block_conv_f32_pair_bins(wc, vh, splits))
                want = (smem_bytes(wc, vh, splits), tile_rows(wc, vh, splits),
                        blocks_per_cta(wc, vh, splits), kernels_per_cta(wc, vh, splits),
                        cluster_size(wc, vh, splits), pair_bins(wc, vh, splits))
                if got != want:
                    raise AssertionError(
                        f"configuration model differs from the kernel at Wc={wc}, Vh={vh}, "
                        f"{tier_name(splits)}: kernel (smem, rows, blocks, kernels, cluster, pair "
                        f"bins) {got}, "
                        f"Python {want}")
                # the Karatsuba configurations, and v2's with either form
                got = (forms_lib.fftconv_block_conv_k_smem_bytes(wc, vh, splits),
                       forms_lib.fftconv_block_conv_k_rows(wc, vh, splits),
                       forms_lib.fftconv_block_conv_k_cluster(wc, vh, splits),
                       forms_lib.fftconv_block_conv_k_pair_bins(wc, vh, splits),
                       *((forms_lib.fftconv_block_conv_v2_smem_bytes(wc, vh, splits, kara),
                          forms_lib.fftconv_block_conv_v2_rows(wc, vh, splits, kara),
                          forms_lib.fftconv_block_conv_v2_blocks(wc, vh, splits, kara))
                         for kara in (0, 1)))
                want = (smem_bytes(wc, vh, splits, True), tile_rows(wc, vh, splits, True),
                        cluster_size(wc, vh, splits, True), pair_bins(wc, vh, splits, True),
                        *((v2_smem_bytes(wc, vh, splits, kara), v2_rows(wc, vh, splits, kara),
                           v2_blocks(wc, vh, splits, kara)) for kara in (False, True)))
                if got != want:
                    raise AssertionError(
                        f"the Karatsuba or v2 configuration model differs from the kernel at "
                        f"Wc={wc}, Vh={vh}, {tier_name(splits)}: kernel {got}, Python {want}")
                # v2's operands' layout: its rows and the pair bins of v3's
                # form (the kernels it launches)
                for kara in (False, True):
                    c_half = (forms_lib.fftconv_block_conv_k_pair_bins(wc, vh, splits) if kara
                              else lib.fftconv_block_conv_f32_pair_bins(wc, vh, splits))
                    c_layout = (got[4 + kara][1], c_half)  # v2's rows, v3's pair bins
                    if kernel_layout("v2", wc, vh, splits, kara) != c_layout:
                        raise AssertionError(
                            f"v2's layout differs from the kernel's at Wc={wc}, Vh={vh}, "
                            f"{tier_name(splits)}, karatsuba={kara}: kernel {c_layout}, Python "
                            f"{kernel_layout('v2', wc, vh, splits, kara)}")
                pairs += 1
    if lib.fftconv_block_conv_f32_smem_bytes(224, 64, 2) != -1:
        raise AssertionError("the configuration queries take a tier outside (0, 1, 3, 6)")
    for splits in TIERS:
        print(f"  {tier_name(splits)}, Karatsuba: headline {smem_bytes(224, 64, splits, True)} B, "
              f"{tile_rows(224, 64, splits, True)} rows; 1024 block "
              f"{smem_bytes(513, 961, splits, True)} B; v2 (rows, MBH): headline "
              f"{(v2_rows(224, 64, splits), v2_blocks(224, 64, splits))}, DPM "
              f"{(v2_rows(70, 16, splits), v2_blocks(70, 16, splits))}, F=8 "
              f"{(v2_rows(144, 32, splits), v2_blocks(144, 32, splits))}")
        print(f"  {tier_name(splits)}: headline (Wc 224, Vh 64) {smem_bytes(224, 64, splits)} B, "
              f"{tile_rows(224, 64, splits)} rows; 1024 block (Wc 513) "
              f"{smem_bytes(513, 961, splits)} B, {tile_rows(513, 961, splits)} rows; DPM "
              f"(Wc 70, Vh 16) {smem_bytes(70, 16, splits)} B, "
              f"{blocks_per_cta(70, 16, splits)} blocks x {kernels_per_cta(70, 16, splits)} "
              f"kernels a CTA; F=8 (Wc 144, Vh 32) {smem_bytes(144, 32, splits)} B, "
              f"{blocks_per_cta(144, 32, splits)} x {kernels_per_cta(144, 32, splits)}")
    print(f"  configuration model = kernel at {pairs} (vh, wc, tier) triples")


# The H100 SXM's published peaks: fp32 on the CUDA cores, dense TF32 and
# bf16 on the tensor cores; its HBM rate is the port's entry for CARD
# (utils/profiling.py HBM_BYTES_PER_S).
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
CARD = "H100 80GB HBM3"


def bound(op_seconds: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take (ms): the larger of the
    operations' time at their units' peak (``op_seconds``) and the bytes at
    the HBM rate → (ms, 'operations' or 'bytes')."""
    from cuda_fft_convolution_torch.utils.profiling import HBM_BYTES_PER_S

    t_op, t_b = op_seconds * 1e3, nbytes / HBM_BYTES_PER_S[CARD] * 1e3
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def mac_flop(f, lh, wc) -> int:
    """Useful operations of one cell's MAC over F (a complex multiply-add,
    8)."""
    return 8 * f * lh * wc


def synthesis_flop(lh, wc, vh, vw, body="v3", karatsuba=False) -> int:
    """Operations of one cell's syntheses in ``body`` (a real multiply-add,
    2): the H stage — v3 and v2 a complex (Vh x Lh)(Lh x Wc) product (the
    Karatsuba form: 3 of its 4 real products), the radix bodies two (M x M)
    (M x Wc) sub-transforms (M = Lh/2; the kernels' pair and single chunks
    sum to the same) — and the W stage — v3/v2/v4 a real (Vh x 2Wc)(2Wc x
    Vw) product, v5/v5x the DIF halves, 4 real (Vh x W/4)(W/4 x Tn)
    products, Tn = min(Vw, W/2); the radix combines, the Karatsuba adds
    and the Nyquist term (a rank-1 update) left out."""
    h = 8 * (vh if body in ("v3", "v2") else lh // 2) * lh * wc
    if karatsuba:
        h = h * 3 // 4
    if body in ("v3", "v2", "v4"):
        return h + 4 * vh * wc * vw
    l2 = wc - 1
    return h + 8 * vh * (l2 // 2) * min(vw, l2)


def cell_flop(f, lh, wc, vh, vw, body="v3", karatsuba=False) -> int:
    """Useful fp32 operations of one fused block-conv cell in ``body``."""
    return mac_flop(f, lh, wc) + synthesis_flop(lh, wc, vh, vw, body, karatsuba)


def block_conv_bound(ops, geom, out_bytes, splits=3, body="v3",
                     karatsuba=False) -> tuple[float, str]:
    """bound() of a fused block-conv call in ``body``. Operations: every
    cell's MAC and the body's syntheses (``cell_flop``) on the tensor cores
    — for fp32 spectra as ``splits`` TF32 passes at the dense TF32 peak (3,
    6 or 1: the tier's products); for bf16 spectra as one bf16 pass with
    fp32 accumulation at the bf16 peak, as the TPU kernel runs its bf16
    tier (cuda_fft_convolution_tpu/ops/block_conv.py:645-647, 686-690).
    Bytes: the four spectra planes read once and ``out_bytes`` written. A
    radix body's bound counts its own products, fewer than v3's, and so
    does the Karatsuba form's; with ``body='v3'`` and the 4-product form
    it is the bound of v3's work, the same whatever body runs it
    (``same_work_bound_ms``)."""
    b, nbh, nbw, f, lh, wc = ops[0].shape
    n = ops[2].shape[0]
    bh, bw, kh, kw = geom[:4]
    cells = b * nbh * nbw * n
    flop = cell_flop(f, lh, wc, bh - kh + 1, bw - kw + 1, body, karatsuba)
    if str(ops[0].dtype) == "torch.bfloat16":
        op_seconds = cells * flop / PEAK_BF16
    else:
        op_seconds = cells * splits * flop / PEAK_TF32
    nbytes = sum(t.numel() * t.element_size() for t in ops) + out_bytes
    return bound(op_seconds, nbytes)


def stacked_ptxas(spectra="13__nv_bfloat16", splits=0) -> tuple:
    """(registers, spill bytes) ptxas reported for the stacked maps
    kernel's instantiation on ``spectra`` (the mangled type: bf16 or 'f')
    at tier ``splits`` with float32 maps and the 4-product H stage, from
    this process's build log; (None, None) where the library was built
    before it."""
    import re

    from cuda_fft_convolution_torch import _build

    want = (f"block_conv_kernelI{spectra}Li64ELb1ELi{splits}ELi0ENS_9StoreMapsIfLb1EEELb0ELb0EEEv")
    entry = regs = spill = None
    for line in _build.build_log().splitlines():
        if "Compiling entry" in line:
            entry = line
        elif entry and want in entry:
            if "spill" in line:
                spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs = int(m.group(1))
                entry = None
    return regs, spill


def paired_ptxas() -> list:
    """(kernel, registers, spill bytes) ptxas reported for each
    instantiation of the paired configuration (template argument PAIRED,
    the last: ``...Lb1EEEv`` after the H-stage form's flag) in this
    process's build log; empty where the libraries were built before it."""
    import re

    from cuda_fft_convolution_torch import _build

    out, entry, spill = [], None, 0
    for line in _build.build_log().splitlines():
        if "Compiling entry" in line:
            m = re.search(r"(block_conv_kernelI\S*Lb[01]ELb1EEEv)", line)
            entry, spill = (m.group(1) if m else None), 0
        elif entry:
            if "spill" in line:
                spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.append((entry, int(m.group(1)), spill))
                entry = None
    return out


def stacked_model(ops, geom, splits=None) -> dict:
    """The stacked configuration at a geometry and tier (None: the
    spectra's default), from the kernel's loop counts (block_conv.cuh): g
    blocks and T kernels a CTA, CTAs, shared memory and ring steps; the
    modelled L2→shared bytes of a call (each plane's u-chunk span, 16 rows
    x Wc at BF16IO and 8 at the other tiers, copied whole from the 16-byte
    chunk that holds its start, for every CTA that reads it); the
    operations issued per cell on the CUDA cores (the MAC, exactly its
    useful work) and on the tensor cores (the H stage's mma tiles: 16-row
    m-tiles x 8-bin n-tiles x the u-chunks' rows, 4 real products; the W
    stage: 64 rows / g over the bins
    padded to 32, twice, x the 64-column warpgroup tiles; both x the tier's
    products) beside the useful ones; where the H stage runs."""
    from cuda_fft_convolution_torch.ops import block_conv as bc

    b, nbh, nbw, f, lh, wc = ops[0].shape
    n = ops[2].shape[0]
    bh, bw, kh, kw = geom[:4]
    vh, vw = bh - kh + 1, bw - kw + 1
    tier = resolved(ops[0], splits)
    g, t = bc.blocks_per_cta(wc, vh, tier), bc.kernels_per_cta(wc, vh, tier)
    ktile = bc.kernel_tile(wc, vh, ops[2], tier)
    nblk = nbh * nbw
    groups = -(-nblk // g)
    tiles = [min(ktile, n - s0) for s0 in range(0, n, ktile)]
    kctas = sum(-(-x // t) for x in tiles)  # CTAs over the kernels, an image
    s = ops[0].element_size()
    plane = lh * wc
    u = 16 if tier == bc.BF16IO else 8  # spectrum rows a u-chunk
    u0 = np.arange(0, lh, u)
    rows = np.minimum(u, lh - u0)

    def span_bytes(base, count):
        """Bytes copied for ``count`` (block or kernel) planes at ``base``:
        every channel and u-chunk's span."""
        idx = np.arange(count)[:, None, None] * f + np.arange(f)[None, :, None]
        start = base + (idx * plane + u0[None, None, :] * wc) * s
        end = start + rows[None, None, :] * wc * s
        return int((((end + 15) // 16) * 16 - (start // 16) * 16).sum())

    d_bytes = sum(span_bytes(t_.data_ptr() % 16, b * nblk) for t_ in ops[:2])
    k_bytes = sum(span_bytes(t_.data_ptr() % 16, n) for t_ in ops[2:])
    l2 = d_bytes * kctas + k_bytes * b * groups
    def step(size):  # a ring step's bytes, spectra of ``size`` bytes
        return 2 * (g + t) * 16 * ((u * wc * size + 15 - size) // 16 + 1)

    # the ring's bytes are sized for the tier's spectra (bf16 at BF16IO,
    # else fp32); bf16 spectra at the other tiers fill them with more steps
    sized = 2 if tier == bc.BF16IO else 4
    steps = min(8, bc._stack(wc, g, t, tier)[0] * step(sized) // step(s))
    products = 1 if tier == bc.BF16IO else tier
    nuc, mtiles, sb = -(-lh // u), -(-vh // 16), -(-wc // 8) * 8
    h = nuc * mtiles * 16 * u * sb * 2 * 4
    bins = -(-wc // 32) * 32
    w = 64 * 2 * bins * -(-vw // 64) * 64 * 2 / g
    return dict(g=g, t=t, ctas=b * groups * kctas, smem=bc.smem_bytes(wc, vh, tier),
                steps=steps, l2_gb=l2 / 1e9, fma_mflop=mac_flop(f, lh, wc) / 1e6,
                tc_mflop=products * (h + w) / 1e6,
                useful_mflop=cell_flop(f, lh, wc, vh, vw) / 1e6,
                h_stage="tensor cores (mma.sync: m16n8k16 bf16 at BF16IO, m16n8k8 on the tier's "
                        "TF32 pieces otherwise)")


def stacked_report(label, ops, geom, splits=None) -> dict:
    """Print ``stacked_model`` at a geometry, with the stacked kernel's
    registers and spills (``stacked_ptxas``), and return the model."""
    m = stacked_model(ops, geom, splits)
    tier = resolved(ops[0], splits)
    regs, spill = stacked_ptxas("13__nv_bfloat16" if str(ops[0].dtype) == "torch.bfloat16"
                                else "f", tier)
    print(f"{label}: stacked {m['g']} blocks x {m['t']} kernels a CTA, {m['ctas']} CTAs, "
          f"{m['smem']} B of shared memory, {m['steps']} ring steps, {regs} registers and "
          f"{spill} bytes of spills (the {tier_label(ops[0], splits)} maps entry); modelled "
          f"L2->shared copies {m['l2_gb']:.2f} GB a call; per cell {m['fma_mflop']:.3f} MFLOP "
          f"on the CUDA cores (the MAC) and {m['tc_mflop']:.3f} on the tensor cores for "
          f"{m['useful_mflop']:.3f} useful; the H stage on the {m['h_stage']}")
    return m


def paired_model(wc, vh, vw, splits=3, karatsuba=False) -> dict:
    """The paired configuration at packed width ``wc``, window (vh, vw),
    tier and H-stage form, from the kernel's loop counts (block_conv.cuh):
    rank 0's and rank 1's bins and H passes of 128 bins (and the fewest
    bins any of them runs), their W passes of 128 columns (and the fewest
    columns), whether a last column runs alone, the row chunks and the
    shared memory; {} where the v3 kernels do not pair there."""
    from cuda_fft_convolution_torch.ops import block_conv as bc

    half = bc.pair_bins(wc, vh, splits, karatsuba)
    if not half:
        return {}
    bins = (half, wc - 1 - half)
    cols = bc.pair_columns(vw)
    passes = -(-cols // 128)
    w = ((passes + 1) // 2, passes // 2)
    widths = [min(128, c - 128 * p) for c in bins for p in range(-(-c // 128))]
    widths += [min(128, cols - 128 * p) for p in range(passes)]
    return dict(cluster=bc.cluster_size(wc, vh, splits, karatsuba), rows=bc.tile_rows(
        wc, vh, splits, karatsuba), bins=bins, h_passes=tuple(-(-c // 128) for c in bins),
        w_passes=w, last_alone=cols < vw, fewest=min(widths),
        row_chunks=bc.row_chunks(wc, vh, splits, karatsuba),
        smem=bc.smem_bytes(wc, vh, splits, karatsuba))


def paired_report(label, wc, vh, vw) -> None:
    """Print ``paired_model`` at every tier and form that pairs, with the
    paired kernels' registers and spills from this process's build
    (``paired_ptxas``); fail on a pass under 32 bins or columns."""
    from cuda_fft_convolution_torch.ops.block_conv import TIERS, tier_name

    regs, paired = paired_ptxas(), False
    for splits in TIERS:
        for kara in (False, True):
            m = paired_model(wc, vh, vw, splits, kara)
            if not m:
                continue
            paired = True
            print(f"{label} (Wc {wc}, Vh {vh}, Vw {vw}), {tier_name(splits)}"
                  f"{', Karatsuba' if kara else ''}: a cluster of {m['cluster']} CTAs of "
                  f"{m['rows']} rows, bins {m['bins'][0]} / {m['bins'][1]} (H passes "
                  f"{m['h_passes'][0]} / {m['h_passes'][1]}), W passes {m['w_passes'][0]} / "
                  f"{m['w_passes'][1]}{', a last column alone' if m['last_alone'] else ''}, "
                  f"the narrowest pass {m['fewest']} bins or columns, {m['row_chunks']} row "
                  f"chunks, {m['smem']} B of shared memory")
            if m["fewest"] < 32:
                raise AssertionError(f"{label}: a pass of {m['fewest']} bins or columns")
    if paired and regs:
        print(f"{label}: the paired kernels ({len(regs)} instantiations): registers "
              f"{min(r for _, r, _ in regs)}..{max(r for _, r, _ in regs)}, spill bytes "
              f"{sum(sp for _, _, sp in regs)} ({card()})")


def resolved(d_re, splits) -> int:
    """The synthesis tier a kernel call on spectra ``d_re`` runs at
    ``splits`` (None: the config's)."""
    from cuda_fft_convolution_torch.ops.block_conv import _resolve_splits

    return _resolve_splits(splits, d_re.dtype)


def tier_label(d_re, splits) -> str:
    """``resolved``'s tier by name."""
    from cuda_fft_convolution_torch.ops.block_conv import tier_name

    return tier_name(resolved(d_re, splits))


def tier_tol(d_re, splits) -> float:
    """A kernel's bar against its plain version at the tier ``splits``
    (None: the config's) runs on spectra ``d_re``."""
    from cuda_fft_convolution_torch.ops.block_conv import BF16IO

    return {1: X1_TOL, BF16IO: IO_TOL}.get(resolved(d_re, splits), TOL)


def radix_body(radix) -> str:
    """The body ('v3', 'v4', 'v5', 'v5x', 'v2') a wrapper's flags select."""
    from cuda_fft_convolution_torch.ops.block_conv import _body

    r = radix or {}
    return _body(bool(r.get("radix_h")), r.get("radix_w", False), r.get("xsliver", False),
                 r.get("wstack", True))


def body_label(radix) -> str:
    """', v4' (v5, v5x, v2) for a body's flags, ', karatsuba' for the
    Karatsuba H stage; '' for v3's 4-product form."""
    body = radix_body(radix)
    return ("" if body == "v3" else f", {body}") + (
        ", karatsuba" if (radix or {}).get("karatsuba") else "")


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def rms_rel_err(got, want) -> float:
    """Root mean square error relative to the root mean square of ``want``."""
    return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def check_kernel(d_re, d_im, k_re, k_im, geom, label, out_dtype=None, tol=TOL,
                 splits=None, radix=None) -> float:
    """Kernel against its plain version's float32 maps on the same CUDA
    inputs → max abs error. Raises above ``tol`` (relative to max |plain|).
    ``out_dtype=torch.bfloat16`` runs the bf16-maps entry; ``splits`` the
    synthesis tier (None: the config's); ``radix`` the body's flags (step
    36; None: v3)."""
    import torch

    from cuda_fft_convolution_torch.ops.block_conv import block_conv, block_conv_reference

    out_dtype = out_dtype or torch.float32
    radix = radix or {}
    got = block_conv(d_re, d_im, k_re, k_im, *geom, out_dtype, splits, **radix)
    want = block_conv_reference(d_re, d_im, k_re, k_im, *geom, splits=splits, **radix)
    torch.cuda.synchronize()
    if got.dtype != out_dtype:
        raise AssertionError(f"kernel maps are {got.dtype}, not {out_dtype} ({label})")
    got = got.float()
    err = rel_err(got, want)
    abs_err = float((got - want).abs().max())
    tier = tier_label(d_re, splits)
    rms = ""
    if tier == "bf16io" and out_dtype == torch.float32:
        rms_err = rms_rel_err(got, want)
        rms = f", rms rel {rms_err:.3e} (bar {IO_RMS_TOL:g})"
        if rms_err > IO_RMS_TOL:
            raise AssertionError(f"kernel's rms error {rms_err} over {IO_RMS_TOL} ({label})")
    print(f"kernel vs plain [{label}] {str(d_re.dtype)[6:]} spectra, {str(out_dtype)[6:]} "
          f"maps {tier}{body_label(radix)} {tuple(got.shape)}: max abs {abs_err:.3e}, rel "
          f"{err:.3e} (bar {tol:g}){rms}")
    if not (err <= tol and torch.isfinite(got).all()):
        raise AssertionError(f"kernel disagrees with its plain version ({label}): {err}")
    return abs_err


def check_kernel_modes(d_re, d_im, k_re, k_im, geom, label) -> dict:
    """The maps kernel in its four dtype modes and the peaks kernel in its
    two on the same planes (bf16 modes: the planes rounded to bf16), bf16
    spectra at their default tier BF16IO and at the explicit 3xTF32 →
    {mode: max abs error}."""
    import torch

    bf16 = torch.bfloat16
    ops = (d_re, d_im, k_re, k_im)
    ops16 = tuple(x.to(bf16) for x in ops)
    errs = {
        "block_conv_f32": check_kernel(*ops, geom, label),
        "block_conv_f32_bf16maps": check_kernel(*ops, geom, label, bf16, BF16_OUT_TOL),
        "block_conv_bf16_io": check_kernel(*ops16, geom, label, tol=IO_TOL),
        "block_conv_bf16_bf16maps_io": check_kernel(*ops16, geom, label, bf16, BF16_OUT_TOL),
        "block_conv_bf16": check_kernel(*ops16, geom, label, splits=3),
        "block_conv_bf16_bf16maps": check_kernel(*ops16, geom, label, bf16, BF16_OUT_TOL, 3),
        "block_conv_peaks_f32": check_peaks(*ops, geom, label),
        "block_conv_peaks_bf16_io": check_peaks(*ops16, geom, label, IO_TOL),
        "block_conv_peaks_bf16": check_peaks(*ops16, geom, label, splits=3),
    }
    check_io_bitwise(ops16, geom, label, ops16)
    return errs


def check_io_bitwise(ops, geom, label, peaks_ops) -> None:
    """The BF16IO entries against the f32-maps entry on the same bf16
    spectra, bitwise: the bf16 maps are its maps rounded once, and the peaks
    kernel's pairs on ``peaks_ops`` are ``cell_peaks`` of its maps of
    ``peaks_ops``. So the two rest on its check against the plain version
    (IO_TOL, and IO_RMS_TOL, which bf16 maps' own rounding would swamp)."""
    import torch

    from cuda_fft_convolution_torch.ops.block_conv import (
        block_conv,
        block_conv_peaks,
        cell_peaks,
    )

    maps = block_conv(*ops, *geom)
    same_maps = torch.equal(block_conv(*ops, *geom, torch.bfloat16), maps.to(torch.bfloat16))
    del maps
    bh, bw, kh, kw = geom[:4]
    vals, idxs = block_conv_peaks(*peaks_ops, *geom)
    cell_v, cell_i = cell_peaks(block_conv(*peaks_ops, *geom), *peaks_ops[0].shape[1:3],
                                bh - kh + 1, bw - kw + 1)
    same_peaks = torch.equal(vals, cell_v) and torch.equal(idxs, cell_i)
    print(f"bf16io entries against the f32-maps entry [{label}]: bf16 maps = its maps rounded "
          f"{same_maps}; peaks = its maps' cell peaks {same_peaks} (bitwise)")
    if not (same_maps and same_peaks):
        raise AssertionError(f"bf16io entries differ from the f32-maps entry's maps ({label})")


def io_control(ops, geom, label, radix=None) -> None:
    """The BF16IO check's control: the 3xTF32 entry (of the body ``radix``,
    None: v3) on the same bf16 spectra, which rounds neither S nor X, held
    against the BF16IO plain version. Fails unless it lies beyond
    IO_RMS_TOL, i.e. unless the bar tells a kernel that misses the tier's
    roundings from one that rounds."""
    import torch

    from cuda_fft_convolution_torch.ops.block_conv import block_conv, block_conv_reference

    radix = radix or {}
    want = block_conv_reference(*ops, *geom, **radix)
    got = block_conv(*ops, *geom, torch.float32, 3, **radix)
    rms, err = rms_rel_err(got, want), rel_err(got, want)
    print(f"control [{label}{body_label(radix)}]: the 3xTF32 entry against the bf16io plain "
          f"version: rms rel "
          f"{rms:.3e} ({rms / IO_RMS_TOL:.1f}x IO_RMS_TOL), rel {err:.3e}")
    if rms <= IO_RMS_TOL:
        raise AssertionError(f"IO_RMS_TOL does not tell 3xTF32 from bf16io ({label}): {rms}")


def check_random_geometries(rng, geometries, check=None) -> None:
    """``check`` (default ``check_kernel_modes``; called as ``check(d_re,
    d_im, k_re, k_im, geom, label)``) on random planes from ``rng`` at each
    (B, F, N, bh, bw, kh, kw, out_h, out_w, label) of ``geometries``."""
    import torch

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device="cuda")

    for b, f, n, bh, bw, kh, kw, out_h, out_w, label in geometries:
        vh, vw = bh - kh + 1, bw - kw + 1
        nbh, nbw, wc = -(-out_h // vh), -(-out_w // vw), bw // 2 + 1
        d = (t(b, nbh, nbw, f, bh, wc), t(b, nbh, nbw, f, bh, wc))
        k = (t(n, f, bh, wc), t(n, f, bh, wc))
        (check or check_kernel_modes)(*d, *k, (bh, bw, kh, kw, out_h, out_w), label)
        del d, k
        torch.cuda.empty_cache()


# Step 3's random-plane geometries: a small ragged shape (B=2, F=3, N=5, odd
# blocks, out_h/out_w not multiples of the valid window: clipped edge
# tiles); the widest block of the 64-row configuration (Wc = 301, bins
# padded to 320; a pair at 6xTF32); a block wide enough (Wc = 451) for the
# paired configuration (256 / 194 bins a CTA), one row chunk of Vh 32; then
# short windows, whose blocks stack in a CTA: the DPM plan's blocks (Vh 16,
# Wc 70, F 31) with 15 blocks an image (a last group of 3 of 4) and clipped
# edges, and Vh 21 (3 blocks, thread tiles straddling two); the planner's
# largest block (Wc 513, Vh 961: a pair of 256 bins a CTA, 16 row chunks,
# the longest contractions the split-TF32 syntheses see); and the (256,
# 896) plan of 129² kernels (Wc 513, Vh 256, Vw 896 = 7 passes of 128).
CHECK_GEOMETRIES = (
    (2, 3, 5, 45, 151, 10, 24, 100, 300, "small ragged"),
    (1, 2, 3, 80, 601, 17, 50, 200, 1100, "Wc 301, the widest 64-row tiles"),
    (1, 2, 2, 40, 901, 9, 101, 150, 1700, "wide block, a pair"),
    (2, 31, 3, 27, 139, 12, 12, 70, 300, "short window, stacked, partial group"),
    (1, 3, 4, 45, 151, 25, 24, 100, 300, "Vh 21, stacked, straddling rows"),
    (1, 1, 2, 1024, 1024, 64, 64, 1500, 1200, "1024 block, 16 row chunks of a pair"),
    (1, 1, 3, 384, 1024, 129, 129, 700, 1500, "(256, 896) plan of 129² kernels, a pair"),
)


def check_kernel_shapes(fc, rng) -> None:
    import torch

    check_random_geometries(rng, CHECK_GEOMETRIES)
    for _, _, _, bh, bw, kh, kw, _, _, label in CHECK_GEOMETRIES:
        paired_report(label, bw // 2 + 1, bh - kh + 1, bw - kw + 1)

    # The headline plan's geometry, real spectra, a few kernels.
    s, kk = HEADLINE["size"], HEADLINE["k"]
    image = rng.standard_normal((s, s, 1)).astype(np.float32)
    bank = rng.standard_normal((4, kk, kk, 1)).astype(np.float32)
    spec = fc.fft_data_tiled(image, kk, kk, device="cuda", trim_mode="same")
    assert (spec.block_h, spec.block_w, spec.max_kh, spec.max_kw) == (127, 447, 64, 64)
    sk = fc.fft_kernels(bank, spectral=spec)
    check_kernel_modes(
        spec.re[None], spec.im[None], sk.re, sk.im,
        (127, 447, 64, 64, spec.out_h, spec.out_w), "headline plan, N=4",
    )
    torch.cuda.synchronize()


def check_peaks(d_re, d_im, k_re, k_im, geom, label, tol=TOL, splits=None,
                radix=None) -> float:
    """Peaks kernel at synthesis tier ``splits`` (None: the config's) and
    the body of the flags ``radix`` (None: v3, where the wrapper's default
    would take v4 at a plan ``radix_h_legal`` admits) against its plain
    version on the same CUDA inputs → max abs error of the values. Values must agree within ``tol`` relative to the largest
    |value|; indices must be equal, except in a near-tie cell (its plain
    maps hold a second value within that tolerance of the cell max), where
    the kernel's position must lie in the cell and hold a plain value
    within the tolerance of the max."""
    import torch

    from cuda_fft_convolution_torch.ops.block_conv import (
        block_conv_peaks,
        block_conv_peaks_reference,
        block_conv_reference,
        cell_view,
    )

    bh, bw, kh, kw, out_h, out_w = geom
    vh, vw = bh - kh + 1, bw - kw + 1
    nbh, nbw = d_re.shape[1], d_re.shape[2]
    radix = radix or {"radix_h": False}
    got_v, got_i = block_conv_peaks(d_re, d_im, k_re, k_im, *geom, splits, **radix)
    want_v, want_i = block_conv_peaks_reference(d_re, d_im, k_re, k_im, *geom, splits, **radix)
    maps = block_conv_reference(d_re, d_im, k_re, k_im, *geom, splits=splits, **radix)
    torch.cuda.synchronize()
    if not (got_v.shape == want_v.shape and got_i.dtype == torch.int32
            and torch.isfinite(got_v).all() and torch.isfinite(want_v).all()):
        raise AssertionError(f"peaks kernel output malformed ({label})")
    scale = float(want_v.abs().max())
    atol = tol * scale
    abs_err = float((got_v - want_v).abs().max())
    if abs_err > atol:
        raise AssertionError(f"peaks kernel values disagree ({label}): {abs_err / scale}")
    b, n = maps.shape[:2]
    near = (cell_view(maps, nbh, nbw, vh, vw) >= want_v[..., None] - atol).sum(-1) >= 2
    flips = got_i != want_i
    if flips.any():
        gi = got_i[flips].long()
        gy, gx = gi // out_w, gi % out_w
        ci = flips.nonzero()
        inside = (gy < out_h) & (gx < out_w) & (gy // vh == ci[:, 2]) & (gx // vw == ci[:, 3])
        at = maps.reshape(b, n, -1)[ci[:, 0], ci[:, 1], gi.clamp(max=out_h * out_w - 1)]
        ok = near[flips] & inside & (at >= want_v[flips] - atol)
        if not ok.all():
            raise AssertionError(
                f"peaks kernel indices disagree outside near-tie cells ({label}): "
                f"{int((~ok).sum())} cells")
    tier = f" {tier_label(d_re, splits)}{body_label(radix)}"
    print(f"peaks kernel vs plain [{label}] {str(d_re.dtype)[6:]} spectra{tier} "
          f"{tuple(got_v.shape)} cells: values max abs "
          f"{abs_err:.3e}, rel {abs_err / scale:.3e}; near-tie cells {int(near.sum())}, "
          f"index flips {int(flips.sum())}")
    return abs_err


def detection_headline(fc, seed):
    """The detection headline on the card: ``detect_peaks`` of a 2048²
    noise image holding each of 100 64² kernels once at 3× amplitude, on a
    10×10 grid of stride 200. Checks the positions against the planted
    centres and the ``fft_conv`` maps, and the top-k and local-peak heads
    against the same maps → (image, bank on the card, launch counts of the
    ``detect_peaks`` run by kernel mode)."""
    import torch

    from cuda_fft_convolution_torch.models import (
        detect_local_peaks,
        detect_peaks,
        detect_top_k,
    )
    from cuda_fft_convolution_torch.ops.block_conv import cell_peaks
    from cuda_fft_convolution_torch.ops.tiled import (
        choose_block_plan,
        local_peaks_from_maps,
        peaks_from_maps,
        top_k_ordered,
    )

    s, n, k = DETECT["size"], DETECT["n"], DETECT["k"]
    rng = np.random.default_rng(seed)
    bank = rng.standard_normal((n, k, k, 1)).astype(np.float32)
    image = detection_frame(rng, bank)
    image_d = torch.as_tensor(image, device="cuda")
    bank_d = torch.as_tensor(bank, device="cuda")

    launches = collections.Counter()
    vals, pos = main_path(
        "detection headline, detect_peaks",
        lambda: detect_peaks(image_d, bank_d, mode="same", correlation=True),
        "block_conv_peaks_f32", launches,
    )
    print(f"detection headline: detect_peaks values {tuple(vals.shape)} positions "
          f"{tuple(pos.shape)} on {vals.device}")
    centres = detection_centres()
    if not torch.equal(pos.cpu(), centres):
        bad = int((pos.cpu() != centres).any(-1).sum())
        raise AssertionError(f"detect_peaks missed {bad} of the {n} planted centres")

    maps = fc.fft_conv(image_d, kernels=bank_d, mode="same", correlation=True)
    mv, my, mx = peaks_from_maps(maps[None])
    if not torch.equal(pos, torch.stack([my[0], mx[0]], -1)):
        raise AssertionError("detect_peaks positions differ from the argmax of the maps")
    v_err = float(((vals - mv[0]).abs() / mv[0].abs()).max())
    print(f"detect_peaks: all {n} planted centres found, = argmax of the fft_conv "
          f"maps; values max rel err {v_err:.3e}")
    if v_err > TOL:
        raise AssertionError(f"detect_peaks values differ from the maps' maxima: {v_err}")

    v1, p1 = detect_top_k(image_d, bank_d, k=1, mode="same", correlation=True)
    if not (torch.equal(p1[:, 0], pos) and torch.equal(v1[:, 0], vals)):
        raise AssertionError("detect_top_k(k=1) differs from detect_peaks")
    # k=5: the top 5 one-block cell maxima of the same maps.
    lh, lw, pkh, pkw = choose_block_plan(s, s, k, k)
    vh, vw = lh - pkh + 1, lw - pkw + 1
    cv, ci = cell_peaks(maps[None], -(-s // vh), -(-s // vw), vh, vw)
    want_v, order = top_k_ordered(cv.reshape(1, n, -1), 5)
    want_i = ci.reshape(1, n, -1).gather(-1, order)[0]
    want_p = torch.stack([want_i // s, want_i % s], -1)
    v5, p5 = detect_top_k(image_d, bank_d, k=5, mode="same", correlation=True)
    atol = TOL * float(want_v.abs().max())
    v5_err = float((v5 - want_v[0]).abs().max())
    # positions may swap only between values within the tolerance
    gap = (want_v[0, :, :-1] - want_v[0, :, 1:]) <= atol
    tie = torch.zeros_like(want_v[0], dtype=torch.bool)
    tie[:, :-1] |= gap
    tie[:, 1:] |= gap
    same = (p5 == want_p).all(-1) | tie
    print(f"detect_top_k(k=5) vs the top 5 cell maxima of the maps ({vh}x{vw} cells): "
          f"values max abs {v5_err:.3e}; near-tie slots {int(tie.sum())}")
    if v5_err > atol or not same.all():
        raise AssertionError("detect_top_k(k=5) differs from the maps' cell maxima")

    lv, lp = detect_local_peaks(image_d, bank_d, k=16, mode="same", correlation=True)
    wv, wy, wx = local_peaks_from_maps(maps[None], 16)
    if not (torch.equal(lv, wv[0]) and torch.equal(lp, torch.stack([wy[0], wx[0]], -1))):
        raise AssertionError("detect_local_peaks differs from the maps' local maxima")
    print(f"detect_local_peaks(k=16) = local maxima of the same maps; "
          f"{int(torch.isfinite(lv).sum())} hits")
    del maps
    torch.cuda.empty_cache()
    return image_d, bank_d, launches


def detection_frame(rng, bank) -> np.ndarray:
    """A (2048, 2048, 1) noise frame from ``rng`` holding each kernel of
    the detection headline's ``bank`` once at 3× amplitude, top-left
    corners on the 10×10 grid of stride 200."""
    s, k, g = DETECT["size"], DETECT["k"], DETECT["grid"]
    image = rng.standard_normal((s, s, 1)).astype(np.float32)
    at = [DETECT["offset"] + DETECT["stride"] * i for i in range(g)]
    plants = [(y0, x0) for y0 in at for x0 in at]
    assert len(plants) == len(bank)
    for t, (y0, x0) in enumerate(plants):
        image[y0 : y0 + k, x0 : x0 + k, 0] += DETECT["amplitude"] * bank[t, :, :, 0]
    return image


def detection_centres():
    """(100, 2) int32 centres of the detection headline's planted kernels in
    the 'same' frame."""
    import torch

    k = DETECT["k"]
    at = [DETECT["offset"] + DETECT["stride"] * i for i in range(DETECT["grid"])]
    return torch.tensor([(y0 + k // 2, x0 + k // 2) for y0 in at for x0 in at],
                        dtype=torch.int32)


def _wrappers():
    from cuda_fft_convolution_torch.ops.block_conv import block_conv, block_conv_peaks
    from cuda_fft_convolution_torch.ops.spectral_mac import spectral_mac

    return block_conv, block_conv_peaks, spectral_mac


def main_path(label, fn, mode, path_launches, shapes=None):
    """Run one main-path call: every kernel launch count set to 0 just
    before it and read just after. Fails unless kernel mode ``mode`` was
    launched; adds the counts by mode to ``path_launches`` and, given a
    Counter ``shapes``, the MAC kernel's counts by (mode, B, F, N, H, Wc)
    to it."""
    import torch

    from cuda_fft_convolution_torch.ops.block_conv import reset_launches

    torch.cuda.synchronize()
    reset_launches(*_wrappers())
    out = fn()
    torch.cuda.synchronize()
    counts = collections.Counter()
    for w in _wrappers():
        counts.update(w.launches_by_mode)
    print(f"{label}: kernel launches {dict(counts)}")
    if counts[mode] < 1:
        raise AssertionError(f"{label} did not launch the {mode} kernel")
    path_launches.update(counts)
    if shapes is not None:
        shapes.update(_wrappers()[2].launches_by_shape)
    return out


def mac_shape(ops) -> tuple:
    """The ``spectral_mac.launches_by_shape`` key of a MAC kernel call on
    float32 planes ``ops``."""
    b, f, h, wc = ops[0].shape
    return ("spectral_mac_f32", b, f, ops[2].shape[0], h, wc)


def max_rel_err_f64(maps, idx, want) -> float:
    """Max over maps[idx] of max |map − want| / max |want| (float64)."""
    got = maps[idx].double().cpu().numpy()
    return max(float(np.abs(g - w_).max() / np.abs(w_).max()) for g, w_ in zip(got, want))


def check_mac(ops, tol=TOL) -> float:
    """MAC kernel against the einsum on the same CUDA planes → max abs
    error. Raises above ``tol`` (relative to max |einsum|)."""
    import torch

    from cuda_fft_convolution_torch.ops.spectral_mac import (
        spectral_mac,
        spectral_mac_planes,
    )

    got = spectral_mac(*ops)
    want = spectral_mac_planes(*ops)
    torch.cuda.synchronize()
    err = max(rel_err(g, w_) for g, w_ in zip(got, want))
    abs_err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
    print(f"MAC kernel vs einsum at {tuple(ops[0].shape)} x {tuple(ops[2].shape)} "
          f"{str(ops[0].dtype)[6:]}: max abs {abs_err:.3e}, rel {err:.3e}")
    if err > tol:
        raise AssertionError(f"MAC kernel disagrees with the einsum: {err}")
    return abs_err


# (B, N, F, H, Wc) for the MAC kernel's tiles, as tests/test_torch_gpu.py:
# ragged in every direction (partial image and filter tiles, S = 1000 a
# partial chunk), the trainer's launch pattern at 20 x 11, and one image.
MAC_SHAPES = [(3, 13, 5, 40, 25), (8, 5, 3, 20, 11), (5, 3, 2, 20, 11), (2, 3, 5, 20, 11),
              (1, 7, 3, 67, 35)]


def check_mac_tiles(gen) -> None:
    """Every form the MAC kernel instantiates (bare C entry) at each of
    ``MAC_SHAPES``, on float32 and bf16 planes, against the einsum (1e-5;
    1e-6 at bf16), the register tiles bitwise equal to each other (each
    output's arithmetic is the same; the split form sums in another order),
    and the wrapper bitwise equal to the rule's form."""
    import torch

    from cuda_fft_convolution_torch._build import library
    from cuda_fft_convolution_torch.ops.spectral_mac import (
        MAC_SPLIT,
        MAC_TILES,
        spectral_mac,
        spectral_mac_planes,
    )

    lib = library()
    for b, n, f, h, wc in MAC_SHAPES:
        ops = tuple(torch.randn((m, f, h, wc), generator=gen, device="cuda")
                    for m in (b, b, n, n))
        rule = mac_rule(ops)
        for planes, tol in ((ops, TOL), (tuple(x.to(torch.bfloat16) for x in ops),
                                         MAC_BF16_TOL)):
            want = spectral_mac_planes(*planes)
            first, worst, outs = None, 0.0, {}
            for tile in MAC_TILES:
                got = outs[tile] = mac_entry(lib, planes, tile)
                err = max(rel_err(g, w) for g, w in zip(got, want))
                worst = max(worst, err)
                if err > tol:
                    raise AssertionError(f"MAC form {tile} at {(b, n, f, h, wc)}: {err}")
                if tile == MAC_SPLIT:
                    continue
                if first is None:
                    first = got
                if not all(torch.equal(g, w) for g, w in zip(got, first)):
                    raise AssertionError(f"MAC tile {tile} at {(b, n, f, h, wc)} differs "
                                         "from the first tile's outputs")
            if not all(torch.equal(g, w) for g, w in zip(spectral_mac(*planes), outs[rule])):
                raise AssertionError(f"spectral_mac at {(b, n, f, h, wc)} differs from "
                                     f"the C entry's outputs at the rule's form {rule}")
            print(f"MAC kernel, every form {list(MAC_TILES)} at (B, N, F, H, Wc) "
                  f"{(b, n, f, h, wc)}, {str(planes[0].dtype)[6:]}: max rel {worst:.3e} vs "
                  f"the einsum, the register tiles bitwise equal, the split form within "
                  f"{tol:g}; the rule's form {rule}, the wrapper bitwise equal to it")


# The parent commit's MAC library for the A/B turns (``--ab-parent``), and
# the A/B readings by row: label -> (parent, this tree, this tree, parent) ms.
PARENT = {}
AB_ROWS = {}
# The MAC shapes across the split form's range (B = N = 1): (H, Wc), from
# MOSSE's respond (3 CTAs of the (1, 1) tile) to 98 CTAs, and the channel
# counts timed at each.
SPLIT_RANGE_HW = ((64, 33), (160, 210), (320, 313))
SPLIT_RANGE_F = (2, 4, 8, 31)
AB_REPS = 10  # MAC calls a CUDA-event window in the tile times and the A/B


def wide_ab(csrc: pathlib.Path, seed: int) -> None:
    """``--ab-parent``'s turns of the entries the paired configuration took
    over from the parent's 32-row tiles: the parent's fused libraries built
    from ``csrc`` beside this tree's, every radix maps and peaks entry of
    both H-stage forms that this tree pairs and the parent did not, at step
    36's plans (6xTF32 at Wc 257, every tier at Wc 513), parent / this tree
    / this tree / parent, the paired entries of v4 (beside v5's and v5x's)
    and v3 beside each (``profile_torch_paths.wide_turns``)."""
    import profile_torch_paths

    profile_torch_paths.wide_turns(profile_torch_paths.build_parent(csrc), seed,
                                   profile_torch_paths.parent_paired_bodies(csrc))


def build_parent_mac(csrc: pathlib.Path) -> None:
    """Build the parent commit's ``spectral_mac.cu`` from ``csrc`` with this
    tree's nvcc flags into ``build/parent_mac`` and load it into
    ``PARENT['lib']``, with this tree's signature (the tile arguments,
    which the parent's MAC entries take)."""
    import ctypes

    from cuda_fft_convolution_torch import _build

    out = _build.BUILD_DIR / "parent_mac"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    obj, lib_path = out / "spectral_mac.o", out / "libparent_mac.so"
    for cmd in ([nvcc, *_build.NVCC_FLAGS, "-c", str(csrc / "spectral_mac.cu"), "-o", str(obj)],
                [nvcc, *_build.LINK_FLAGS, "-o", str(lib_path), str(obj)]):
        run = subprocess.run(cmd, capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"building the parent's MAC failed:\n{run.stdout}{run.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for tag in ("f32", "bf16"):
        fn = getattr(lib, f"fftconv_spectral_mac_{tag}")
        fn.argtypes, fn.restype = _build._SIGNATURES[f"fftconv_spectral_mac_{tag}"]
    PARENT["lib"] = lib
    print(f"A/B: the parent's MAC kernel built from {csrc}")


def mac_rule(ops) -> tuple:
    """The form ``mac_tile`` picks for the MAC of ``ops`` on this card."""
    from cuda_fft_convolution_torch.ops.spectral_mac import mac_tile, sm_count

    b, f, h, wc = ops[0].shape
    return mac_tile(b, ops[2].shape[0], f, h * wc, sm_count(ops[0].device))


def parent_mac_rule(ops) -> tuple:
    """The parent commit's rule: (1, 1) at B = 1, else (8, 4)."""
    return (1, 1) if ops[0].shape[0] == 1 else (8, 4)


def mac_entry(lib, ops, tile=None):
    """A bare call of ``lib``'s MAC C entry for the planes' dtype in form
    ``tile`` (None: ``mac_tile``'s), with no wrapper around it (its host
    checks would show in a short CUDA-event window) → (re, im)."""
    import torch

    b, f, h, wc = ops[0].shape
    n = ops[2].shape[0]
    o_re = torch.empty((b, n, h, wc), device=ops[0].device)
    o_im = torch.empty_like(o_re)
    tag = "bf16" if ops[0].dtype == torch.bfloat16 else "f32"
    err = getattr(lib, f"fftconv_spectral_mac_{tag}")(
        *(t.data_ptr() for t in (*ops, o_re, o_im)), b, f, n, h * wc,
        *(tile or mac_rule(ops)), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"MAC C entry failed (tile {tile}): cudaError {err}")
    return o_re, o_im


def mac_tiles_and_ab(label, ops) -> None:
    """At one MAC row's shape: the time of every instantiated form (bare C
    entry; median of 7 windows of ``AB_REPS`` calls, and device time from
    CUDA graphs where the output is small), the rule's form marked; then, with ``--ab-parent``, the parent's kernel at the parent's
    rule against this tree's at this tree's in turns (parent, this tree,
    this tree, parent; bare C entries, timed the same way, in one-call
    windows and, where the output is small, as device time from CUDA
    graphs), their outputs compared: bitwise where the two rules pick one
    form, else (the split form where the parent ran the (1, 1) tile) each
    within 1e-5 of the plain version; there this tree's wrapper and one
    complex einsum are timed in turns the same three ways too."""
    import torch

    from cuda_fft_convolution_torch._build import library
    from cuda_fft_convolution_torch.ops.spectral_mac import (
        MAC_TILES,
        spectral_mac,
        spectral_mac_planes,
    )

    lib = library()
    rule = mac_rule(ops)
    b, f, h, w = ops[0].shape
    small = b * ops[2].shape[0] * h * w * 8 <= GRAPH_OUT_LIMIT
    sweep = {t: (cuda_ms(lambda t=t: mac_entry(lib, ops, t), reps=AB_REPS),
                 graph_ms(lambda t=t: mac_entry(lib, ops, t)) if small else None)
             for t in MAC_TILES}
    print(f"MAC forms, {label}: " + ", ".join(
        f"{t}{'*' if t == rule else ''} {ms:.4f}" + (f" (device {dev:.4f})" if dev else "")
        for t, (ms, dev) in sweep.items())
        + f" ms in windows of {AB_REPS} calls (* the rule's; device: CUDA graphs; {card()})")
    if "lib" not in PARENT:
        return
    old = parent_mac_rule(ops)
    parent = functools.partial(mac_entry, PARENT["lib"], ops, old)
    new = functools.partial(mac_entry, lib, ops, rule)
    a, c = parent(), new()
    torch.cuda.synchronize()
    equal = all(torch.equal(x, y) for x, y in zip(a, c))
    err = max(rel_err(y, x) for x, y in zip(a, c))
    if old == rule:
        held = f"outputs bitwise equal {equal}, rel {err:.3e}"
        if not equal:
            raise AssertionError(f"A/B {label}: the rule is the parent's ({rule}) but the "
                                 f"outputs differ: {err}")
    else:
        want = spectral_mac_planes(*ops)
        errs = [max(rel_err(x, w) for x, w in zip(out, want)) for out in (a, c)]
        held = (f"the parent's {old} and this tree's {rule}: not bitwise (another order), "
                f"{errs[0]:.3e} and {errs[1]:.3e} from the plain version, rel {err:.3e}")
        if max(errs) > TOL:
            raise AssertionError(f"A/B {label}: {held}")
        del want
    del a, c
    # (a, b, their names): the parent's C entry against this tree's; where
    # the form changed, also this tree's wrapper against one complex einsum
    turns = [(parent, new, ("parent", "this tree"))]
    if old != rule:
        d = torch.complex(ops[0].float(), ops[1].float())
        k = torch.complex(ops[2].float(), ops[3].float())
        turns.append((functools.partial(spectral_mac, *ops),
                      lambda: torch.einsum("bfhw,nfhw->bnhw", d, k),
                      ("this tree's wrapper", "one complex einsum")))
    for p, n, (pn, nn) in turns:
        for how in (f"windows of {AB_REPS} calls", "one-call windows",
                    f"device time, CUDA graphs of {AB_REPS} calls")[:3 if small else 2]:
            if how.startswith("device"):
                t = [graph_ms(fn) for fn in (p, n, n, p)]
            else:
                t = [cuda_ms(fn, reps=AB_REPS if how.startswith("windows") else 1)
                     for fn in (p, n, n, p)]
            if pn == "parent" and how.startswith("windows"):
                AB_ROWS[label] = t
            print(f"A/B {label}, {how}: {pn} {t[0]:.4f}, {nn} {t[1]:.4f}, {nn} {t[2]:.4f}, "
                  f"{pn} {t[3]:.4f} ms ({nn} / {pn} {(t[1] + t[2]) / (t[0] + t[3]):.3f}; {card()})")
    print(f"A/B {label}: {held}")
    torch.cuda.empty_cache()


def mac_bound(ops) -> tuple[float, str]:
    """bound() of a MAC call: 8 operations per (b, n, f, h, w) complex
    multiply-add; the planes read once and the two float32 output planes
    written."""
    b, f, h, w = ops[0].shape
    n = ops[2].shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in ops) + 2 * b * n * h * w * 4
    return bound(8 * b * n * f * h * w / PEAK_FP32, nbytes)


def complex_einsum_ms(ops, reps=AB_REPS) -> tuple:
    """The one PyTorch call that computes the MAC: ``torch.einsum`` on the
    complex64 spectra (built from the planes, bf16 upcast, before the
    timing); a yardstick the port never calls → its ms in windows of
    ``reps`` calls back to back, in one-call windows, and as device time
    (``graph_ms``)."""
    import torch

    d = torch.complex(ops[0].float(), ops[1].float())
    k = torch.complex(ops[2].float(), ops[3].float())

    def fn():
        return torch.einsum("bfhw,nfhw->bnhw", d, k)

    out_bytes = d.numel() // d.shape[1] * k.shape[0] * 8  # (B, N, H, Wc) complex64
    times = cuda_ms(fn, reps=reps), cuda_ms(fn), graph_ms(fn, reps, out_bytes=out_bytes)
    del d, k
    return times


GRAPH_OUT_LIMIT = 64 << 20  # output bytes a call, at most, for graph_ms


def graph_ms(fn, reps=AB_REPS, runs=RUNS, out_bytes=0) -> float | None:
    """Device milliseconds of one ``fn()``: ``reps`` calls captured in a
    CUDA graph, the graph replayed between CUDA events (median of ``runs``
    replays, over ``reps``), so that no host work between launches shows.
    None (not measured) where a call's output passes GRAPH_OUT_LIMIT: the
    graph's pool would hold ``reps`` of them, and at such sizes the host's
    work hides behind the device's anyway."""
    import torch

    if out_bytes > GRAPH_OUT_LIMIT:
        return None
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, runs) / reps
    del graph
    return ms


def same_reference_f64(image, bank, idx, anchor=None) -> np.ndarray:
    """float64 numpy 'same' maps of a one-channel (H, W, 1) image for
    bank[idx], zero padding, the window at ``anchor`` (default the scipy
    offset ((Kh−1)//2, (Kw−1)//2); (Kh//2, Kw//2) is the matlab offset and
    a centered kernel's window)."""
    h, w = image.shape[:2]
    kh, kw = bank.shape[1:3]
    oh, ow = anchor or ((kh - 1) // 2, (kw - 1) // 2)
    ph, pw = h + kh - 1, w + kw - 1
    spec = np.fft.rfft2(image[..., 0].astype(np.float64), s=(ph, pw))
    out = []
    for i in idx:
        full = np.fft.irfft2(
            spec * np.fft.rfft2(bank[i, ..., 0].astype(np.float64), s=(ph, pw)),
            s=(ph, pw),
        )
        out.append(full[oh : oh + h, ow : ow + w])
    return np.stack(out)


def clamp_same_reference_f64(image, bank, idx, anchor) -> np.ndarray:
    """float64 numpy 'same' maps with replicated borders (padding='clamp')
    of a one-channel (H, W, 1) image for bank[idx], window anchored at
    ``anchor`` = (dh, dw): the image edge-padded by (K−1−d, d) on each axis
    (``np.pad(mode='edge')``), then its 'valid' linear convolution by a
    float64 FFT. Equal to the tap loop ``tests/oracles.py
    conv_same_nearest_f64`` (tests/test_torch_padding.py), and fast at the
    headline's width."""
    h, w = image.shape[:2]
    kh, kw = bank.shape[1:3]
    dh, dw = anchor
    padded = np.pad(image[..., 0].astype(np.float64),
                    ((kh - 1 - dh, dh), (kw - 1 - dw, dw)), mode="edge")
    ph, pw = h + 2 * (kh - 1), w + 2 * (kw - 1)
    spec = np.fft.rfft2(padded, s=(ph, pw))
    out = []
    for i in idx:
        full = np.fft.irfft2(
            spec * np.fft.rfft2(bank[i, ..., 0].astype(np.float64), s=(ph, pw)),
            s=(ph, pw),
        )
        out.append(full[kh - 1 : kh - 1 + h, kw - 1 : kw - 1 + w])
    return np.stack(out)


def tier_headline(fc, image_d, bank_d, idx, want, path_launches) -> dict:
    """The headline at the bf16 tier: ``fft_conv`` with bf16 spectra, with
    bf16 spectra and bf16 maps, and with float32 spectra and bf16 maps, each
    against float64 numpy on maps ``idx`` (``want``); the direct engine at
    the tier; then times of each call beside the float32 call, in one run →
    {label: ms}."""
    import torch

    s, n = HEADLINE["size"], HEADLINE["n"]
    calls = {
        "f32": (dict(), None, None),
        "bf16 spectra": (dict(store_dtype="bfloat16"), "block_conv_bf16_io", BF16_TOL),
        "bf16 spectra, bf16 maps": (dict(store_dtype="bfloat16", out_dtype="bfloat16"),
                                    "block_conv_bf16_bf16maps_io", BF16_TOL),
        "f32 spectra, bf16 maps": (dict(out_dtype="bfloat16"),
                                   "block_conv_f32_bf16maps", BF16_OUT_TOL),
        "direct, f32": (dict(algorithm="direct"), None, None),
        "direct, bf16 spectra": (dict(algorithm="direct", store_dtype="bfloat16"),
                                 "spectral_mac_bf16", BF16_TOL),
    }
    for label, (kw, mode, bar) in calls.items():
        if mode is None:
            continue
        maps = main_path(
            f"headline fft_conv, {label}",
            lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same", **kw), mode,
            path_launches,
        )
        dtype = torch.bfloat16 if kw.get("out_dtype") else torch.float32
        if not (maps.dtype == dtype and tuple(maps.shape) == (n, s, s)
                and torch.isfinite(maps).all()):
            raise AssertionError(f"headline maps ({label}): {maps.dtype} {tuple(maps.shape)}")
        err = max_rel_err_f64(maps, idx, want)
        print(f"headline fft_conv, {label}: {str(dtype)[6:]} maps vs float64 numpy on "
              f"kernels {idx}: max rel err {err:.3e} (bar {bar:g})")
        if err > bar:
            raise AssertionError(f"headline error ({label}) {err} above {bar}")
        del maps
    torch.cuda.empty_cache()
    times = {}
    for label, (kw, _, _) in calls.items():
        times[label] = cuda_ms(lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same", **kw))
        print(f"headline fft_conv, {label}: {times[label]:.3f} ms")
    return times


def dpm_inputs(seed, store="bfloat16"):
    """The DPM/HOG config's inputs on the card: HOG features of a 4096²
    image from ``seed`` cast to ``store`` (bf16 unless asked), (512, 512,
    31), and the float32 bank (1024, 12, 12, 31) → (features, bank, hog
    ms)."""
    import torch

    from cuda_fft_convolution_torch.models import hog_features

    rng = np.random.default_rng(seed)
    side, cell, bins = DPM["image"], DPM["cell"], DPM["bins"]
    image = torch.as_tensor(rng.standard_normal((side, side)).astype(np.float32), device="cuda")
    feats = hog_features(image, cell=cell, bins=bins)
    torch.cuda.synchronize()
    shape = (side // cell, side // cell, bins)
    if not (tuple(feats.shape) == shape and torch.isfinite(feats).all()
            and float(feats.min()) >= 0 and float(feats.max()) <= 1):
        raise AssertionError(f"HOG features malformed: {tuple(feats.shape)}")
    hog_ms = cuda_ms(lambda: hog_features(image, cell=cell, bins=bins))
    print(f"DPM: hog_features of a {side}² image: {tuple(feats.shape)}, {hog_ms:.3f} ms")
    bank = rng.standard_normal((DPM["n"], DPM["k"], DPM["k"], bins)).astype(np.float32)
    return feats.to(getattr(torch, store)), torch.as_tensor(bank, device="cuda"), hog_ms


def dpm_reference_f64(feats, bank, idx) -> np.ndarray:
    """float64 numpy 'same' maps (scipy offset, channels summed) of
    (H, W, F) ``feats`` with ``bank[idx]``."""
    h, w, _ = feats.shape
    k = bank.shape[1]
    ph, pw = h + k - 1, w + k - 1
    spec = np.fft.rfft2(feats.transpose(2, 0, 1), s=(ph, pw))
    out = []
    for i in idx:
        ks = np.fft.rfft2(bank[i].transpose(2, 0, 1).astype(np.float64), s=(ph, pw))
        full = np.fft.irfft2((spec * ks).sum(0), s=(ph, pw))
        o = (k - 1) // 2
        out.append(full[o : o + h, o : o + w])
    return np.stack(out)


def dpm_plant_sites() -> tuple[list, list]:
    """The indices of the `plants` DPM filters that are planted and the
    top-left (row, col) of each plant in the 512² feature frame."""
    n = DPM["n"]
    planted = [t * (n // DPM["plants"]) + 7 for t in range(DPM["plants"])]
    corners = [(y0, x0) for y0 in (100, 350) for x0 in (60, 180, 300, 420)]
    return planted, corners


def dpm_planted(feats, bank):
    """``feats`` (bf16, on the card) with `plants` of the DPM filters added
    at `amplitude` → (bf16 features, the filters' indices, (plants, 2)
    int32 centres in the 'same' frame, on the card)."""
    import torch

    k = DPM["k"]
    planted, corners = dpm_plant_sites()
    out = feats.float()
    for t, (y0, x0) in zip(planted, corners):
        out[y0 : y0 + k, x0 : x0 + k] += DPM["amplitude"] * bank[t]
    centres = torch.tensor([(y0 + k // 2, x0 + k // 2) for y0, x0 in corners],
                           dtype=torch.int32, device=feats.device)
    return out.to(torch.bfloat16), planted, centres


def dpm_path(fc, seed, path_launches) -> tuple[dict, dict]:
    """The DPM/HOG detector config at full width on the card (module
    docstring, step 12) → ({label: ms}, {kernel mode: (max abs err, ms,
    plain ms)} at the DPM plan)."""
    import torch

    from cuda_fft_convolution_torch.models import detect_peaks
    from cuda_fft_convolution_torch.ops.block_conv import (
        block_conv,
        block_conv_peaks,
        block_conv_peaks_reference,
        block_conv_reference,
    )

    bf16 = torch.bfloat16
    feats, bank, hog_ms = dpm_inputs(seed)
    k, n = DPM["k"], DPM["n"]
    times = {"hog_features": hog_ms}
    sd = fc.fft_data_tiled(feats, k, k, trim_mode="same", store_dtype="bfloat16")
    sk = fc.fft_kernels(bank, spectral=sd, store_dtype="bfloat16")
    plan = (sd.block_h, sd.block_w, sd.max_kh, sd.max_kw)
    if plan != (27, 139, 12, 12) or sd.re.dtype != bf16 or sk.re.dtype != bf16:
        raise AssertionError(f"DPM spectra: plan {plan}, {sd.re.dtype}, {sk.re.dtype}")
    vh, wc = sd.block_h - k + 1, sd.block_w // 2 + 1
    geom = (*plan, sd.out_h, sd.out_w)
    ops = (sd.re[None], sd.im[None], sk.re, sk.im)
    print(f"DPM: plan {plan}, {sd.re.shape[0]}x{sd.re.shape[1]} blocks, Vh={vh}, Wc={wc}; "
          f"bank spectra {2 * sk.re.numel() * sk.re.element_size() / 1e6:.1f} MB bf16")
    m = stacked_report("DPM plan", ops, geom)
    if m["g"] < 2 or m["t"] < 2:
        raise AssertionError(f"the DPM plan must stack blocks and kernels: {m['g']} x {m['t']}")

    idx = list(range(0, n, n // 8))[:8]
    want = dpm_reference_f64(feats.double().cpu().numpy(), bank.cpu().numpy(), idx)
    maps32 = None
    for label, out_dtype, mode in (("f32 maps", None, "block_conv_bf16_io"),
                                   ("bf16 maps", "bfloat16", "block_conv_bf16_bf16maps_io")):
        maps = main_path(f"DPM conv_spectral, {label}",
                         lambda: fc.conv_spectral(sd, sk, mode="same", out_dtype=out_dtype),
                         mode, path_launches)
        dtype = bf16 if out_dtype else torch.float32
        if not (maps.dtype == dtype and tuple(maps.shape) == (n, 512, 512)
                and torch.isfinite(maps).all()):
            raise AssertionError(f"DPM maps ({label}): {maps.dtype} {tuple(maps.shape)}")
        err = max_rel_err_f64(maps, idx, want)
        print(f"DPM conv_spectral, {label} ({maps.numel() * maps.element_size() / 1e9:.2f} GB): "
              f"vs float64 numpy on filters {idx}: max rel err {err:.3e} (bar {BF16_TOL:g})")
        if err > BF16_TOL:
            raise AssertionError(f"DPM error ({label}) {err} above {BF16_TOL}")
        if maps32 is None:
            maps32 = maps
        else:
            diff = rel_err(maps.float(), maps32)
            print(f"DPM bf16 maps vs f32 maps: rel {diff:.3e} (bar {BF16_OUT_TOL:g})")
            if diff > BF16_OUT_TOL:
                raise AssertionError(f"DPM bf16 maps differ from the f32 maps: {diff}")
        del maps
    del maps32
    torch.cuda.empty_cache()

    # 8 filters planted in the features, found by detect_peaks at the tier
    feats_p, planted, centres = dpm_planted(feats, bank)
    vals, pos = main_path(
        "DPM detect_peaks at the tier",
        lambda: detect_peaks(feats_p, bank, mode="same", correlation=True,
                             store_dtype="bfloat16"),
        "block_conv_peaks_bf16_io", path_launches)
    found = (pos[planted] == centres).all(-1)
    print(f"DPM detect_peaks: {tuple(vals.shape)} peaks; planted filters {planted} found at "
          f"their centres: {int(found.sum())} of {len(planted)}")
    if not found.all():
        raise AssertionError(f"DPM detect_peaks missed {int((~found).sum())} planted centres")

    # the kernels at the DPM plan against their plain versions
    label = f"DPM plan, N={n}"
    kernels = {
        "block_conv_bf16_io": check_kernel(*ops, geom, label, tol=IO_TOL),
        "block_conv_bf16_bf16maps_io": check_kernel(*ops, geom, label, bf16, BF16_OUT_TOL),
    }
    sdp = fc.fft_data_tiled(feats_p, k, k, trim_mode="same", store_dtype="bfloat16")
    skc = fc.fft_kernels(bank, spectral=sdp, correlation=True, store_dtype="bfloat16")
    pops = (sdp.re[None], sdp.im[None], skc.re, skc.im)
    kernels["block_conv_peaks_bf16_io"] = check_peaks(*pops, geom, label, IO_TOL)
    check_io_bitwise(ops, geom, label, pops)
    io_control(ops, geom, label)
    torch.cuda.empty_cache()
    ms = {
        "block_conv_bf16_io": (lambda: block_conv(*ops, *geom),
                               lambda: block_conv_reference(*ops, *geom)),
        "block_conv_bf16_bf16maps_io": (lambda: block_conv(*ops, *geom, bf16),
                                        lambda: block_conv_reference(*ops, *geom, bf16)),
        "block_conv_peaks_bf16_io": (lambda: block_conv_peaks(*pops, *geom),
                                     lambda: block_conv_peaks_reference(*pops, *geom)),
    }
    maps_bytes = n * sd.out_h * sd.out_w
    bounds = {
        "block_conv_bf16_io": block_conv_bound(ops, geom, 4 * maps_bytes),
        "block_conv_bf16_bf16maps_io": block_conv_bound(ops, geom, 2 * maps_bytes),
        "block_conv_peaks_bf16_io": block_conv_bound(pops, geom, 8 * pops[0].shape[1]
                                                     * pops[0].shape[2] * n),
    }
    for mode, (kern, plain) in ms.items():
        kernels[mode] = (kernels[mode], cuda_ms(kern), cuda_ms(plain), *bounds[mode], None)
        torch.cuda.empty_cache()
        print(f"{mode} alone at the DPM plan: {kernels[mode][1]:.3f} ms; "
              f"plain version: {kernels[mode][2]:.3f} ms; bound {kernels[mode][3]:.3f} ms "
              f"({kernels[mode][4]})")
    ops32 = tuple(x.float() for x in ops)
    f32_ms = cuda_ms(lambda: block_conv(*ops32, *geom))
    print(f"block_conv_f32 alone at the DPM plan (the same planes upcast): {f32_ms:.3f} ms")
    times["kernel f32 at the DPM plan"] = f32_ms
    del ops32
    for label, fn in (
        ("conv_spectral, f32 maps", lambda: fc.conv_spectral(sd, sk, mode="same")),
        ("conv_spectral, bf16 maps",
         lambda: fc.conv_spectral(sd, sk, mode="same", out_dtype="bfloat16")),
        ("detect_peaks", lambda: detect_peaks(sdp, skc, mode="same")),
        ("one-shot detect_peaks from the features",
         lambda: detect_peaks(feats_p, bank, mode="same", correlation=True,
                              store_dtype="bfloat16")),
    ):
        times[label] = cuda_ms(fn)
        torch.cuda.empty_cache()
        print(f"DPM {label}: {times[label]:.3f} ms")
    return times, kernels


# ---- the rest of the API at full width: clamp, centered, ragged bucketing,
# ---- memory-planned direct banks, the pipelined batch

# The ragged cell array (BASELINE.json configs[1]; demoCudaConvolutionFFT.m:
# 41-43): a 512² image, `per_size` kernels of each size, planted once each
# at `amplitude` on a grid for the detection check.
RAGGED = dict(size=512, sizes=(9, 17, 33, 64), per_size=4, stride=120, offset=20,
              amplitude=3.0)
# The DPM giant bank on the direct engine (BASELINE.json configs[4],
# bench.py:376-420): the first `n` of the DPM filters against the DPM
# features, at the bf16 tier, a 540² FFT; forced runs at about `chunks`
# chunks and a streaming budget of `stream_share` of the resident bytes.
DPM_DIRECT = dict(n=576, fft=(540, 540), chunks=9, stream_share=1.5)
# The pipelined batch (BASELINE.json configs[3]): `batch` images of the
# headline's size with the headline bank; `chunk` kernels a direct chunk.
PIPELINED = dict(batch=8, chunk=16)
# The smoke's peak allocation must stay below this (the phases free their
# tensors in turn); PHASE_PEAKS collects the peaks phase by phase.
PEAK_LIMIT = 60 << 30
PHASE_PEAKS: list[int] = []


@functools.cache
def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    from cuda_fft_convolution_torch.utils.profiling import card_label

    return card_label()


def timed(label, fn, times) -> float:
    """``cuda_ms(fn)`` recorded under ``label`` and printed beside the card."""
    import torch

    times[label] = cuda_ms(fn)
    torch.cuda.empty_cache()
    print(f"{label}: {times[label]:.3f} ms (median of {RUNS}; {card()})")
    return times[label]


def phase_peak(label) -> None:
    """Print the peak allocation since the last reset, keep it in
    PHASE_PEAKS, and reset the count."""
    import torch

    torch.cuda.synchronize()
    PHASE_PEAKS.append(torch.cuda.max_memory_allocated())
    print(f"{label}: peak memory allocated {PHASE_PEAKS[-1] / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()


def planner_table() -> None:
    """The planner's decisions on this card's budget at the real shapes:
    the bank transform (``plan_transform``), the convolution against
    resident spectra (``plan_bank``) and, for raw banks whose spectra
    would take over half the budget, the streaming plan."""
    import torch

    from cuda_fft_convolution_torch import api
    from cuda_fft_convolution_torch.runtime import planner

    budget = api._device_memory_budget(torch.device("cuda"))
    print(f"planner on this card: budget {budget / 1e9:.2f} GB "
          f"(hbm_fraction x {torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB)")
    for label, n, f, fft, batch, sb, k in (
        ("headline direct, 100 x 64², f32", 100, 1, (2160, 2160), 1, 4, 64),
        ("pipelined direct, 8 images", 100, 1, (2160, 2160), 8, 4, 64),
        ("pipelined tiled, 8 images (192 blocks each)", 100, 1, (127, 447), 8 * 192, 4, 64),
        ("DPM direct, 576 filters, bf16", 576, 31, (540, 540), 1, 2, 12),
        ("DPM direct, 1024 filters, bf16", 1024, 31, (540, 540), 1, 2, 12),
        ("DPM direct, 1024 filters, f32", 1024, 31, (540, 540), 1, 4, 12),
        ("DPM direct, 4096 filters, f32", 4096, 31, (540, 540), 1, 4, 12),
    ):
        stack = n * f * k * k * 4
        t = planner.plan_transform(n, f, *fft, budget, sb, stack)
        p = planner.plan_bank(n, f, *fft, batch, budget, sb)
        line = (f"  {label}: bank {planner.spectra_bytes(n, f, *fft, sb) / 1e9:.2f} GB; "
                f"transform chunk {t.chunk_size} of {n}; plan_bank chunk {p.chunk_size} "
                f"(peak {p.peak_bytes / 1e9:.2f} GB)")
        if batch == 1 and planner.spectra_bytes(n, f, *fft, sb) > budget // 2:
            st = planner.plan_streaming(n, f, *fft, 1, budget, sb, stack)
            line += f"; raw banks stream, chunk {st.chunk_size} (peak {st.peak_bytes / 1e9:.2f} GB)"
        print(line)


def clamp_centered_phases(fc, image, bank, image_d, bank_d, path_launches, times) -> None:
    """The headline shape through the direct engine: padding='clamp' at both
    anchors against the edge-padded float64 reference, then centered
    kernels against float64 and against the corner call at the matlab
    offset (the same maps for zero padding)."""
    import torch

    s, n, k = HEADLINE["size"], HEADLINE["n"], HEADLINE["k"]
    idx = list(range(0, n, n // 8))[:8]
    calls = {
        "clamp": (dict(padding="clamp"), ((k - 1) // 2, (k - 1) // 2)),
        "clamp, matlab offset": (dict(padding="clamp", same_offset="matlab"), (k // 2, k // 2)),
    }
    for label, (kw, anchor) in calls.items():
        maps = main_path(f"clamp headline fft_conv, {label}",
                         lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same", **kw),
                         "spectral_mac_f32", path_launches)
        if not (tuple(maps.shape) == (n, s, s) and torch.isfinite(maps).all()):
            raise AssertionError(f"clamp headline maps ({label}): {tuple(maps.shape)}")
        err = max_rel_err_f64(maps, idx, clamp_same_reference_f64(image, bank, idx, anchor))
        print(f"clamp headline fft_conv, {label}: vs edge-padded float64 numpy on kernels "
              f"{idx}: max rel err {err:.3e} (bar {TOL:g})")
        if err > TOL:
            raise AssertionError(f"clamp headline error ({label}) {err} above {TOL}")
        del maps
        torch.cuda.empty_cache()
        timed(f"clamp headline fft_conv, {label}",
              lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same", **kw), times)
    phase_peak("clamp headline")

    cent = main_path("centered headline fft_conv",
                     lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same",
                                         kernel_layout="centered"),
                     "spectral_mac_f32", path_launches)
    if not (tuple(cent.shape) == (n, s, s) and torch.isfinite(cent).all()):
        raise AssertionError(f"centered headline maps: {tuple(cent.shape)}")
    err = max_rel_err_f64(cent, idx, same_reference_f64(image, bank, idx, (k // 2, k // 2)))
    corner = fc.fft_conv(image_d, kernels=bank_d, mode="same", same_offset="matlab",
                         algorithm="direct")
    diff = rel_err(cent, corner)
    print(f"centered headline fft_conv: vs float64 numpy on kernels {idx}: max rel err "
          f"{err:.3e} (bar {TOL:g}); vs the corner call at the matlab offset: rel {diff:.3e} "
          f"(bar 1e-6)")
    if err > TOL or diff > 1e-6:
        raise AssertionError(f"centered headline: {err} vs float64, {diff} vs corner")
    del cent, corner
    torch.cuda.empty_cache()
    timed("centered headline fft_conv",
          lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same", kernel_layout="centered"),
          times)
    phase_peak("centered headline")


def ragged_inputs(seed):
    """BASELINE configs[1]'s cell array from ``seed + 1``: a 512² noise
    image with each of the 16 cells (four each of 9², 17², 33², 64²)
    planted once → (image, cells, sizes, (16, 2) int32 centres in the
    'same' frame)."""
    import torch

    rng = np.random.default_rng(seed + 1)
    side = RAGGED["size"]
    sizes = [k for k in RAGGED["sizes"] for _ in range(RAGGED["per_size"])]
    cells = [rng.standard_normal((k, k, 1)).astype(np.float32) for k in sizes]
    image = rng.standard_normal((side, side, 1)).astype(np.float32)
    at = [RAGGED["offset"] + RAGGED["stride"] * i for i in range(4)]
    corners = [(y0, x0) for y0 in at for x0 in at]
    for c, (y0, x0) in zip(cells, corners):
        k = c.shape[0]
        image[y0 : y0 + k, x0 : x0 + k, 0] += RAGGED["amplitude"] * c[:, :, 0]
    centres = torch.tensor([(y0 + c.shape[0] // 2, x0 + c.shape[0] // 2)
                            for c, (y0, x0) in zip(cells, corners)], dtype=torch.int32)
    return image, cells, sizes, centres


def ragged_phase(fc, seed, path_launches, times) -> None:
    """BASELINE configs[1]: a 512² image with a cell array of four sizes;
    fft_conv buckets it by pow-2 envelope, each bucket through the fused
    kernel at its own plan; every map against float64; then detect_peaks
    on the same cell array with each kernel planted once."""
    import torch

    from cuda_fft_convolution_torch import api
    from cuda_fft_convolution_torch.models import detect_peaks
    from cuda_fft_convolution_torch.ops.block_conv import block_conv
    from cuda_fft_convolution_torch.ops.tiled import choose_block_plan

    side = RAGGED["size"]
    image, cells, sizes, centres = ragged_inputs(seed)
    image_d = torch.as_tensor(image, device="cuda")
    cells_d = [torch.as_tensor(c, device="cuda") for c in cells]
    buckets = api._bucket_ragged(cells)
    plans = [choose_block_plan(side, side, max(sizes[i] for i in b), max(sizes[i] for i in b))
             for b in buckets]
    print(f"ragged cell array: kernels {sorted(set(sizes))} x{RAGGED['per_size']} on a "
          f"{side}² image: buckets {[[sizes[i] for i in b] for b in buckets]}, plans {plans}")
    before = block_conv.launches
    maps = main_path("ragged fft_conv", lambda: fc.fft_conv(image_d, kernels=cells_d, mode="same"),
                     "block_conv_f32", path_launches)
    if block_conv.launches - before != len(buckets) or None in plans:
        raise AssertionError(f"ragged fft_conv launched the fused kernel "
                             f"{block_conv.launches - before} times for {len(buckets)} buckets")
    err = 0.0
    for i, m in enumerate(maps):
        if not (tuple(m.shape) == (side, side) and torch.isfinite(m).all()):
            raise AssertionError(f"ragged map {i}: {tuple(m.shape)}")
        want = same_reference_f64(image, cells[i][None], [0])
        err = max(err, max_rel_err_f64(m[None], [0], want))
    print(f"ragged fft_conv: {len(maps)} maps in input order, each vs float64 numpy: max rel "
          f"err {err:.3e} (bar {TOL:g}); the fused kernel launched once a bucket")
    if err > TOL:
        raise AssertionError(f"ragged error {err} above {TOL}")
    del maps
    vals, pos = main_path("ragged detect_peaks",
                          lambda: detect_peaks(image_d, cells_d, mode="same", correlation=True),
                          "block_conv_f32", path_launches)
    if not torch.equal(pos.cpu(), centres):
        bad = int((pos.cpu() != centres).any(-1).sum())
        raise AssertionError(f"ragged detect_peaks missed {bad} of {len(cells)} planted centres")
    print(f"ragged detect_peaks: all {len(cells)} planted centres found")
    timed("ragged fft_conv", lambda: fc.fft_conv(image_d, kernels=cells_d, mode="same"), times)
    timed("ragged detect_peaks", lambda: detect_peaks(image_d, cells_d, mode="same"), times)
    phase_peak("ragged cell array")


def budget_for_chunk(chunk, *args, **kwargs) -> int:
    """The least budget (bytes) at which ``plan_bank(*args, **kwargs)``
    plans ``chunk`` kernels a chunk."""
    from cuda_fft_convolution_torch.runtime.planner import plan_bank

    lo, hi = 0, 1 << 44
    while lo < hi:
        mid = (lo + hi) // 2
        if plan_bank(*args, hbm_budget_bytes=mid, **kwargs).chunk_size >= chunk:
            hi = mid
        else:
            lo = mid + 1
    return lo


def dpm_fftmap_reference_f64(feats, bank, idx, fft) -> np.ndarray:
    """float64 numpy circular (fftmap) maps of (H, W, F) ``feats`` with
    ``bank[idx]`` at FFT size ``fft``, channels summed."""
    spec = np.fft.rfft2(feats.transpose(2, 0, 1), s=fft)
    return np.stack([
        np.fft.irfft2((spec * np.fft.rfft2(bank[i].transpose(2, 0, 1).astype(np.float64),
                                           s=fft)).sum(0), s=fft)
        for i in idx
    ])


def dpm_direct_phase(fc, seed, path_launches, times) -> None:
    """BASELINE configs[4]'s direct half: the DPM giant bank (the first 576
    of the DPM filters, 12²×31, bf16 tier, 540² FFT) on the direct engine:
    at the planner's own plan, forced into about 9 chunks, and streamed as
    spatial kernels under a budget below twice the resident bytes."""
    import torch

    from cuda_fft_convolution_torch import api
    from cuda_fft_convolution_torch.runtime import planner

    feats, bank, _ = dpm_inputs(seed)
    n, k = DPM_DIRECT["n"], DPM["k"]
    bank = bank[:n].contiguous()
    sd = fc.fft_data(feats, k, k, store_dtype="bfloat16")
    f, fft = sd.feature_dim, (sd.fft_h, sd.fft_w)
    if fft != DPM_DIRECT["fft"] or sd.re.dtype != torch.bfloat16:
        raise AssertionError(f"DPM direct spectra: {fft} {sd.re.dtype}")
    budget = api._device_memory_budget(sd.re.device)
    tplan = planner.plan_transform(n, f, *fft, budget, 2, bank.numel() * 4)
    sk = fc.fft_kernels(bank, spectral=sd, store_dtype="bfloat16")
    resident = 2 * sk.re.numel() * sk.re.element_size()
    print(f"DPM direct: {n} filters {k}²×{f} at a {fft[0]}² FFT, bf16 bank spectra "
          f"{resident / 1e9:.2f} GB; device budget {budget / 1e9:.2f} GB; bank transform in "
          f"chunks of {tplan.chunk_size} (modelled peak {tplan.peak_bytes / 1e9:.2f} GB)")
    phase_peak("DPM direct, bank transform")
    plan = planner.plan_bank(n, f, *fft, 1, budget, 2)
    print(f"DPM direct plan_bank: chunk_size {plan.chunk_size}, peak_bytes {plan.peak_bytes} "
          f"({plan.peak_bytes / 1e9:.2f} GB)")
    idx = list(range(0, n, n // 8))[:8]
    want = dpm_fftmap_reference_f64(feats.double().cpu().numpy(), bank.cpu().numpy(), idx, fft)
    whole = main_path("DPM direct conv_spectral", lambda: fc.conv_spectral(sd, sk, mode="fftmap"),
                      "spectral_mac_bf16", path_launches)
    if not (tuple(whole.shape) == (n, *fft) and torch.isfinite(whole).all()):
        raise AssertionError(f"DPM direct maps: {tuple(whole.shape)}")
    err = max_rel_err_f64(whole, idx, want)
    print(f"DPM direct conv_spectral: vs float64 numpy on filters {idx}: max rel err "
          f"{err:.3e} (bar {BF16_TOL:g})")
    if err > BF16_TOL:
        raise AssertionError(f"DPM direct error {err} above {BF16_TOL}")
    phase_peak("DPM direct, planner's plan")

    chunk = -(-n // DPM_DIRECT["chunks"])
    forced = budget_for_chunk(chunk, n, f, *fft, 1, store_bytes=2)
    fc.set_config(hbm_budget_bytes=forced)
    try:
        fplan = planner.plan_bank(n, f, *fft, 1, forced, 2)
        chunked = main_path(f"DPM direct conv_spectral, budget {forced / 1e9:.2f} GB",
                            lambda: fc.conv_spectral(sd, sk, mode="fftmap"),
                            "spectral_mac_bf16", path_launches)
        diff = rel_err(chunked, whole)
        print(f"DPM direct chunked: chunk_size {fplan.chunk_size}, "
              f"{-(-n // fplan.chunk_size)} chunks, peak_bytes {fplan.peak_bytes / 1e9:.2f} GB; "
              f"vs the unchunked maps: rel {diff:.3e} (bar 1e-6)")
        if diff > 1e-6:
            raise AssertionError(f"DPM chunked maps differ from the unchunked maps: {diff}")
        del chunked
        phase_peak("DPM direct, chunked")
        timed("DPM direct conv_spectral, chunked",
              lambda: fc.conv_spectral(sd, sk, mode="fftmap"), times)
    finally:
        fc.set_config(hbm_budget_bytes=None)
    timed("DPM direct conv_spectral, planner's plan",
          lambda: fc.conv_spectral(sd, sk, mode="fftmap"), times)
    timed("DPM direct fft_kernels (bank transform)",
          lambda: fc.fft_kernels(bank, spectral=sd, store_dtype="bfloat16"), times)
    del sk
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    stream_budget = int(DPM_DIRECT["stream_share"] * resident)
    fc.set_config(hbm_budget_bytes=stream_budget)
    try:
        splan = planner.plan_streaming(n, f, *fft, 1, stream_budget, 2, bank.numel() * 4)
        streamed = main_path(f"DPM direct streaming, budget {stream_budget / 1e9:.2f} GB",
                             lambda: fc.conv_spectral(sd, bank, mode="fftmap"),
                             "spectral_mac_f32", path_launches)
        err = max_rel_err_f64(streamed, idx, want)
        diff = rel_err(streamed, whole)
        print(f"DPM direct streaming: chunk_size {splan.chunk_size}, "
              f"{-(-n // splan.chunk_size)} chunks, peak_bytes {splan.peak_bytes / 1e9:.2f} GB; "
              f"vs float64: max rel err {err:.3e}; vs the resident call: rel {diff:.3e} "
              f"(bar {BF16_TOL:g})")
        if err > BF16_TOL or diff > BF16_TOL:
            raise AssertionError(f"DPM streaming: {err} vs float64, {diff} vs resident")
        del streamed
        phase_peak("DPM direct, streaming")
        timed("DPM direct conv_spectral, streaming",
              lambda: fc.conv_spectral(sd, bank, mode="fftmap"), times)
    finally:
        fc.set_config(hbm_budget_bytes=None)
    del whole, sd, feats, bank
    torch.cuda.empty_cache()


def max_rel_diff(got, want) -> float:
    """max |got − want| / max |want| over (B, N, H, W) maps, one image at a
    time (no full-size temporaries)."""
    num = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return num / max(float(w.abs().max()) for w in want)


def pipelined_phase(fc, seed, bank, bank_d, path_launches, times) -> None:
    """BASELINE configs[3]: a batch of 8 headline-size images with the
    headline bank through conv_spectral_pipelined, on tiled spectra (the
    fused kernel, chunks from the planner) and on direct spectra (the MAC
    kernel, chunks of 16), each against conv_spectral on the same spectra
    and 2 maps of 2 images against float64."""
    import torch

    from cuda_fft_convolution_torch import api
    from cuda_fft_convolution_torch.runtime import planner

    s, n, k = HEADLINE["size"], HEADLINE["n"], HEADLINE["k"]
    b = PIPELINED["batch"]
    rng = np.random.default_rng(seed + 2)
    images = rng.standard_normal((b, s, s, 1)).astype(np.float32)
    images_d = torch.as_tensor(images, device="cuda")
    checks = [(0, 0), (b - 1, n - 1)]
    wants = [same_reference_f64(images[i], bank, [j])[0] for i, j in checks]

    def f64_err(maps):
        return max(float(np.abs(maps[i, j].double().cpu().numpy() - w).max() / np.abs(w).max())
                   for (i, j), w in zip(checks, wants))

    for engine in ("tiled", "direct"):
        if engine == "tiled":
            spec = fc.fft_data_tiled(images_d, k, k, trim_mode="same")
            fft = (spec.block_h, spec.block_w)
            batch = b * api.np_prod_blocks(spec)
            chunk, mode = None, "block_conv_f32"
        else:
            spec = fc.fft_data(images_d, k, k)
            fft, batch = (spec.fft_h, spec.fft_w), b
            chunk, mode = PIPELINED["chunk"], "spectral_mac_f32"
        sk = fc.fft_kernels(bank_d, spectral=spec)
        plan = planner.plan_bank(n, 1, *fft, batch, api._device_memory_budget(images_d.device))
        print(f"pipelined batch, {engine}: {b} images {s}², {n} kernels {k}², FFT {fft}; "
              f"plan_bank chunk_size {plan.chunk_size}, peak_bytes {plan.peak_bytes / 1e9:.2f} "
              f"GB; chunk_size {chunk or plan.chunk_size}")
        whole = fc.conv_spectral(spec, sk, mode="same")
        if engine == "direct":
            whole = whole.contiguous()  # a 'same' view of the fftmap canvas
        torch.cuda.empty_cache()
        got = main_path(f"pipelined batch, {engine}",
                        lambda: fc.conv_spectral_pipelined(spec, sk, chunk_size=chunk,
                                                           mode="same"),
                        mode, path_launches)
        if not (tuple(got.shape) == (b, n, s, s) and all(torch.isfinite(g).all() for g in got)):
            raise AssertionError(f"pipelined maps ({engine}): {tuple(got.shape)}")
        diff = max_rel_diff(got, whole)
        err = f64_err(got)
        print(f"pipelined batch, {engine} ({got.numel() * 4 / 1e9:.1f} GB of maps): vs "
              f"conv_spectral on the same spectra: rel {diff:.3e} (bar 1e-6); maps {checks} "
              f"vs float64 numpy: max rel err {err:.3e} (bar {TOL:g})")
        if diff > 1e-6 or err > TOL:
            raise AssertionError(f"pipelined {engine}: {diff} vs conv_spectral, {err} vs f64")
        del got, whole
        torch.cuda.empty_cache()
        phase_peak(f"pipelined batch, {engine}")
        timed(f"pipelined batch, {engine}, conv_spectral_pipelined",
              lambda: fc.conv_spectral_pipelined(spec, sk, chunk_size=chunk, mode="same"), times)
        timed(f"pipelined batch, {engine}, conv_spectral",
              lambda: fc.conv_spectral(spec, sk, mode="same"), times)
        del spec, sk
        torch.cuda.empty_cache()
    del images_d
    torch.cuda.empty_cache()


# ---- the serving runtime at full width: plans, streams, the tuner

# ConvStream serving: `frames` host frames of the headline's size, the bank
# swapped by update_kernels before frame `swap`; steady state at each of
# `depths`; a submit into a queue with room must take under `submit_share`
# of one frame's device time (median of `trials`). Detection and DPM
# serving run `short` frames.
STREAM = dict(frames=16, swap=8, depths=(1, 3), submit_share=0.25, trials=8, short=8)
# The tuner at the headline shape: a bank of `n_kernels`, the default
# candidates plus the analytic plan's valid window.
TUNE = dict(n_kernels=32, analytic=(64, 384))


def wall_ms(fn, count, runs=3) -> float:
    """Median over ``runs`` of the host wall time of ``fn()`` between two
    ``synchronize``s, divided by ``count`` (ms)."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0) / count)
    return statistics.median(times)


def stream_ms(stream, frames) -> float:
    """Steady-state ms a frame of ``stream`` over ``frames`` (warmed by one
    frame first): every frame submitted, then a flush."""
    stream.submit(frames[0]).result()

    def serve():
        for f in frames:
            stream.submit(f)
        stream.flush()

    return wall_ms(serve, len(frames))


def plan_phase(fc, image, bank, image_d, bank_d, idx, want, seed, path_launches, times):
    """Plans at the headline: a tiled 'same' plan (maps = fft_conv's, and
    against float64), ``execute_spectral`` timed beside ``fft_conv``; a
    direct 'fftmap' plan through the MAC kernel against float64; a
    head='peaks' plan on the detection headline (every planted centre,
    = ``detect_peaks``) → the detection bank on the card."""
    import torch

    from cuda_fft_convolution_torch.models import detect_peaks

    s, n, k = HEADLINE["size"], HEADLINE["n"], HEADLINE["k"]
    plan = fc.make_plan((s, s, 1), (n, k, k, 1), algorithm="tiled", mode="same")
    print(f"headline tiled plan: blocks ({plan.fft_h}, {plan.fft_w}), bank spectra "
          f"{plan.kfft_aval.shape} {plan.kfft_aval.dtype}, on {plan.device}")
    maps = main_path("headline tiled plan, execute", lambda: plan.execute(image_d, bank_d),
                     "block_conv_f32", path_launches)
    equal = torch.equal(maps, fc.fft_conv(image_d, kernels=bank_d, mode="same"))
    err = max_rel_err_f64(maps, idx, want)
    print(f"headline tiled plan: maps bitwise equal to fft_conv's: {equal}; vs float64 numpy "
          f"on kernels {idx}: max rel err {err:.3e} (bar {TOL:g})")
    if not equal or err > TOL:
        raise AssertionError(f"tiled plan: equal to fft_conv {equal}, {err} vs float64")
    del maps
    dfft, kfft = plan.data_fft(image_d), plan.kernel_fft(bank_d)
    timed("headline tiled plan, execute_spectral", lambda: plan.execute_spectral(dfft, kfft),
          times)
    timed("headline tiled plan, execute", lambda: plan.execute(image_d, bank_d), times)
    timed("headline fft_conv, beside the plan",
          lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same"), times)
    del plan, dfft, kfft

    dplan = fc.make_plan((s, s, 1), (n, k, k, 1), algorithm="direct", mode="fftmap")
    fft = (dplan.fft_h, dplan.fft_w)
    maps = main_path("headline direct fftmap plan, execute",
                     lambda: dplan.execute(image_d, bank_d), "spectral_mac_f32", path_launches)
    if not (tuple(maps.shape) == (n, *fft) and torch.isfinite(maps).all()):
        raise AssertionError(f"direct fftmap plan maps: {tuple(maps.shape)}")
    err = max_rel_err_f64(maps, idx, dpm_fftmap_reference_f64(image.astype(np.float64), bank,
                                                               idx, fft))
    print(f"headline direct fftmap plan: maps {tuple(maps.shape)} vs float64 numpy circular "
          f"maps at {fft}: max rel err {err:.3e} (bar {TOL:g})")
    if err > TOL:
        raise AssertionError(f"direct fftmap plan error {err} above {TOL}")
    del maps
    dfft, kfft = dplan.data_fft(image_d), dplan.kernel_fft(bank_d)
    timed("headline direct fftmap plan, execute_spectral",
          lambda: dplan.execute_spectral(dfft, kfft), times)
    del dplan, dfft, kfft
    torch.cuda.empty_cache()

    rng = np.random.default_rng(seed)  # the detection headline's inputs
    det_bank = rng.standard_normal((n, k, k, 1)).astype(np.float32)
    det_image_d = torch.as_tensor(detection_frame(rng, det_bank), device="cuda")
    det_bank_d = torch.as_tensor(det_bank, device="cuda")
    pplan = fc.make_plan((s, s, 1), (n, k, k, 1), algorithm="tiled", mode="same",
                         correlation=True, head="peaks")
    vals, pos = main_path("detection headline, head='peaks' plan",
                          lambda: pplan.execute(det_image_d, det_bank_d), "block_conv_f32",
                          path_launches)
    _, want_pos = detect_peaks(det_image_d, det_bank_d, mode="same", correlation=True)
    centres = detection_centres()
    print(f"head='peaks' plan: values {tuple(vals.shape)}, positions {tuple(pos.shape)}; "
          f"planted centres found {int((pos.cpu() == centres).all(-1).sum())} of {n}; = "
          f"detect_peaks' positions: {torch.equal(pos, want_pos)}")
    if not (torch.equal(pos.cpu(), centres) and torch.equal(pos, want_pos)):
        raise AssertionError("the head='peaks' plan missed planted centres or differs from "
                             "detect_peaks")
    del pplan
    torch.cuda.empty_cache()
    phase_peak("plans at the headline")
    return det_bank, det_bank_d


def headline_stream_phase(fc, seed, bank_d, path_launches, times) -> None:
    """ConvStream at the headline: host numpy frames through the pinned
    ring at depth 3, each frame's maps bitwise equal to the synchronous
    plan's, the bank swapped mid-stream; the steady state at depths 1 and
    3 beside synchronous ``plan.execute`` calls; a submit's host time into
    a queue with room, under torch's sync debug mode, against one frame's
    device time."""
    import torch

    s, n, k = HEADLINE["size"], HEADLINE["n"], HEADLINE["k"]
    count, swap = STREAM["frames"], STREAM["swap"]
    rng = np.random.default_rng(seed + 4)
    frames = [rng.standard_normal((s, s, 1)).astype(np.float32) for _ in range(count)]
    bank2_d = torch.as_tensor(rng.standard_normal((n, k, k, 1)).astype(np.float32),
                              device="cuda")
    banks = [bank_d if i < swap else bank2_d for i in range(count)]
    kw = dict(algorithm="tiled", mode="same")
    stream = fc.ConvStream.create((s, s, 1), bank_d, depth=3, **kw)
    plan = stream.plan

    def serve_and_check():
        pending, equal = collections.deque(), []
        for i, f in enumerate(frames):
            if i == swap:
                stream.update_kernels(bank2_d)
            pending.append((i, stream.submit(f)))
            if len(pending) == stream.depth:
                j, fut = pending.popleft()
                equal.append(torch.equal(fut.result(), plan.execute(frames[j], banks[j])))
        while pending:
            j, fut = pending.popleft()
            equal.append(torch.equal(fut.result(), plan.execute(frames[j], banks[j])))
        return equal

    equal = main_path(f"ConvStream headline, depth 3, {count} host frames, bank swapped at "
                      f"frame {swap}", serve_and_check, "block_conv_f32", path_launches)
    print(f"ConvStream headline: frames bitwise equal to the synchronous plan: "
          f"{sum(equal)} of {count}")
    if not all(equal):
        raise AssertionError(f"stream maps differ from the plan's on frames "
                             f"{[i for i, e in enumerate(equal) if not e]}")
    stream.update_kernels(bank_d)
    phase_peak("ConvStream headline, depth 3")

    def synchronous():
        for f in frames:
            plan.execute(f, bank_d)
            torch.cuda.synchronize()

    sync_ms = wall_ms(synchronous, count)
    times["headline, synchronous plan.execute per frame"] = sync_ms
    line = f"headline serving, ms a frame over {count} host frames: synchronous plan.execute " \
           f"{sync_ms:.3f}"
    for depth in STREAM["depths"]:
        st = stream if depth == stream.depth else fc.ConvStream.create(
            (s, s, 1), bank_d, depth=depth, **kw)
        times[f"headline ConvStream depth {depth} per frame"] = stream_ms(st, frames)
        line += f"; ConvStream depth {depth} {times[f'headline ConvStream depth {depth} per frame']:.3f}"
        del st
    print(f"{line} ({card()})")

    frame_d = torch.as_tensor(frames[0], device="cuda")
    kfft = plan.kernel_fft(bank_d)
    # the least of RUNS event-timed runs: a late launch from a busy host only adds
    frame_ms = min(cuda_ms(lambda: plan.execute_spectral(plan.data_fft(frame_d), kfft), 1)
                   for _ in range(RUNS))
    times["headline frame on the device"] = frame_ms
    print(f"headline frame on the device (data_fft + execute_spectral): {frame_ms:.3f} ms "
          f"(least of {RUNS}; {card()})")
    # the control: the submit's host copy alone (a frame into pinned memory,
    # as the ring stages it), timed before each trial; a submit that slows
    # with it is host load, one that slows alone stalls in the stream
    pinned = torch.empty((s, s, 1), dtype=torch.float32, pin_memory=True)
    host, control, busy = [], [], 0
    for t in range(STREAM["trials"]):
        stream.flush()
        t0 = time.perf_counter()
        pinned.copy_(torch.as_tensor(frames[(t + 1) % count]))
        control.append(1e3 * (time.perf_counter() - t0))
        first = stream.submit(frames[t % count])
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            stream.submit(frames[(t + 1) % count])
            host.append(1e3 * (time.perf_counter() - t0))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        busy += not first._event.query()
    stream.flush()
    host_ms, control_ms = statistics.median(host), statistics.median(control)
    times["headline ConvStream submit, host"] = host_ms
    times["headline ConvStream submit, host copy alone"] = control_ms
    print(f"ConvStream submit into a queue with room: host {host_ms:.3f} ms (median of "
          f"{len(host)}; no synchronising call under sync debug mode 'error'; the frame ahead "
          f"still running at {busy} of {len(host)} returns) = "
          f"{100 * host_ms / frame_ms:.1f}% of one frame's device time {frame_ms:.3f} ms "
          f"(bar {100 * STREAM['submit_share']:.0f}%; {card()}); its host copy alone "
          f"{control_ms:.3f} ms (median; per trial, submit/copy ms: "
          f"{', '.join(f'{h:.3f}/{c:.3f}' for h, c in zip(host, control))}); the synchronous "
          f"loop {sync_ms:.3f} ms a frame")
    if host_ms >= STREAM["submit_share"] * frame_ms:
        raise AssertionError(f"a submit takes {host_ms:.3f} ms of host time against a "
                             f"{frame_ms:.3f} ms frame (its host copy alone {control_ms:.3f} "
                             f"ms, the synchronous loop {sync_ms:.3f} ms a frame): a hidden "
                             f"synchronisation if the copy alone stays fast, host load if not")
    del stream, plan, frame_d, kfft, bank2_d, pinned
    torch.cuda.empty_cache()
    phase_peak("ConvStream headline, timing")


def detection_stream_phase(fc, seed, det_bank, det_bank_d, path_launches, times) -> None:
    """ConvStream(head='peaks') on `short` detection-headline frames (new
    noise, the same plants): every planted centre in every frame, = the
    frame's ``detect_peaks`` positions; ms a frame beside ``detect_peaks``."""
    import torch

    from cuda_fft_convolution_torch.models import detect_peaks

    s, n, k = HEADLINE["size"], HEADLINE["n"], HEADLINE["k"]
    rng = np.random.default_rng(seed + 5)
    frames = [detection_frame(rng, det_bank) for _ in range(STREAM["short"])]
    stream = fc.ConvStream.create((s, s, 1), det_bank_d, depth=3, algorithm="tiled",
                                  mode="same", correlation=True, head="peaks")
    res = main_path(f"ConvStream detection serving, head='peaks', {len(frames)} frames",
                    lambda: [fut.result() for fut in [stream.submit(f) for f in frames]],
                    "block_conv_f32", path_launches)
    centres = detection_centres()
    found = [int((pos.cpu() == centres).all(-1).sum()) for _, pos in res]
    same = [torch.equal(pos, detect_peaks(torch.as_tensor(f, device="cuda"), det_bank_d,
                                          mode="same", correlation=True)[1])
            for f, (_, pos) in zip(frames, res)]
    print(f"ConvStream detection serving: planted centres found a frame {found} of {n}; = "
          f"detect_peaks' positions: {sum(same)} of {len(frames)} frames")
    if min(found) < n or not all(same):
        raise AssertionError("detection serving missed planted centres")
    times["detection ConvStream depth 3 per frame"] = stream_ms(stream, frames)
    frames_d = [torch.as_tensor(f, device="cuda") for f in frames[:2]]
    timed("detect_peaks per frame, beside the stream",
          lambda: detect_peaks(frames_d[0], det_bank_d, mode="same", correlation=True), times)
    print(f"detection ConvStream depth 3: {times['detection ConvStream depth 3 per frame']:.3f} "
          f"ms a frame over {len(frames)} host frames ({card()})")
    del stream, frames_d
    torch.cuda.empty_cache()
    phase_peak("ConvStream detection serving")


def dpm_stream_phase(fc, seed, path_launches, times) -> None:
    """The DPM detector loop at the tier: `short` frames of HOG features of
    4096² images from the seed with the 8 DPM filters planted, through
    ConvStream(head='peaks', store_dtype='bfloat16') at depth 3 (the
    stacked kernel's path): the planted filters found in every frame; ms a
    frame beside the synchronous plan."""
    import torch

    from cuda_fft_convolution_torch.models import hog_features

    feats, bank, _ = dpm_inputs(seed)
    del feats
    side, cell, bins, k = DPM["image"], DPM["cell"], DPM["bins"], DPM["k"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    frames = []
    for _ in range(STREAM["short"]):
        image = torch.randn((side, side), generator=gen, device="cuda")
        frame, planted, centres = dpm_planted(
            hog_features(image, cell=cell, bins=bins).to(torch.bfloat16), bank)
        frames.append(frame)
    shape = tuple(frames[0].shape)
    stream = fc.ConvStream.create(shape, bank, depth=3, algorithm="tiled", mode="same",
                                  correlation=True, head="peaks", store_dtype="bfloat16")
    print(f"DPM ConvStream: frames {shape} bf16, bank {tuple(bank.shape)}, blocks "
          f"({stream.plan.fft_h}, {stream.plan.fft_w}), bank spectra "
          f"{stream.plan.kfft_aval.dtype}")
    res = main_path(f"DPM ConvStream, head='peaks', bf16 tier, {len(frames)} frames",
                    lambda: [fut.result() for fut in [stream.submit(f) for f in frames]],
                    "block_conv_bf16_io", path_launches)
    found = [int((pos[planted] == centres).all(-1).sum()) for _, pos in res]
    print(f"DPM ConvStream: planted filters found a frame {found} of {len(planted)}")
    if min(found) < len(planted):
        raise AssertionError("DPM serving missed planted filters")
    times["DPM ConvStream depth 3 per frame"] = stream_ms(stream, frames)
    plan = stream.plan
    kfft = plan.kernel_fft(bank)

    def synchronous():
        for f in frames:
            plan.execute_spectral(plan.data_fft(f), kfft)
            torch.cuda.synchronize()

    times["DPM synchronous plan per frame"] = wall_ms(synchronous, len(frames))
    print(f"DPM serving, ms a frame: ConvStream depth 3 "
          f"{times['DPM ConvStream depth 3 per frame']:.3f}; synchronous plan "
          f"(data_fft + execute_spectral) {times['DPM synchronous plan per frame']:.3f} "
          f"({card()})")
    del stream, plan, kfft, frames, bank
    torch.cuda.empty_cache()
    phase_peak("DPM ConvStream")


def ragged_stream_phase(fc, seed, path_launches, times) -> None:
    """RaggedConvStream on BASELINE configs[1]'s cell array: four exact-
    shape groups, each with its own plan, on the tiled and the direct
    engine; every map against float64 (1e-5) and fft_conv's ragged call;
    under head='peaks' every planted cell found; ms a frame beside
    fft_conv's ragged call."""
    import torch

    side = RAGGED["size"]
    image, cells, sizes, centres = ragged_inputs(seed)
    rng = np.random.default_rng(seed + 7)
    frames = [image] + [rng.standard_normal(image.shape).astype(np.float32)
                        for _ in range(STREAM["short"] - 1)]
    image_d = torch.as_tensor(image, device="cuda")
    cells_d = [torch.as_tensor(c, device="cuda") for c in cells]
    wants = [same_reference_f64(image, c[None], [0]) for c in cells]
    one_shot = fc.fft_conv(image_d, kernels=cells_d, mode="same")
    for algorithm, mode in (("tiled", "block_conv_f32"), ("direct", "spectral_mac_f32")):
        stream = fc.RaggedConvStream((side, side, 1), cells_d, depth=3, mode="same",
                                     algorithm=algorithm)
        maps = main_path(f"RaggedConvStream, {algorithm}", lambda: stream.submit(image).result(),
                         mode, path_launches)
        err = max(max_rel_err_f64(m[None], [0], w) for m, w in zip(maps, wants))
        diff = max(rel_err(m, o) for m, o in zip(maps, one_shot))
        print(f"RaggedConvStream, {algorithm}: {stream.num_groups} groups "
              f"{[(p.fft_h, p.fft_w) for p in stream.plans]}, {len(maps)} maps in cell order: "
              f"vs float64 max rel err {err:.3e}, vs fft_conv's buckets {diff:.3e} "
              f"(bar {TOL:g})")
        if stream.num_groups != len(RAGGED["sizes"]) or err > TOL or diff > TOL:
            raise AssertionError(f"ragged stream ({algorithm}): {stream.num_groups} groups, "
                                 f"{err} vs float64, {diff} vs fft_conv")
        del maps
        times[f"RaggedConvStream {algorithm} per frame"] = stream_ms(stream, frames)
        del stream
    peaks = fc.RaggedConvStream((side, side, 1), cells_d, depth=3, mode="same",
                                algorithm="tiled", correlation=True, head="peaks")
    res = main_path("RaggedConvStream, tiled, head='peaks'", lambda: peaks.submit(image).result(),
                    "block_conv_f32", path_launches)
    pos = torch.stack([p for _, p in res]).cpu()
    print(f"RaggedConvStream head='peaks': planted cells found "
          f"{int((pos == centres).all(-1).sum())} of {len(cells)}")
    if not torch.equal(pos, centres):
        raise AssertionError("the ragged head='peaks' stream missed planted cells")
    timed("ragged fft_conv, beside the streams",
          lambda: fc.fft_conv(image_d, kernels=cells_d, mode="same"), times)
    print(f"ragged serving, ms a frame over {len(frames)} host frames: RaggedConvStream tiled "
          f"{times['RaggedConvStream tiled per frame']:.3f}, direct "
          f"{times['RaggedConvStream direct per frame']:.3f}; fft_conv's ragged call "
          f"{times['ragged fft_conv, beside the streams']:.3f} ({card()})")
    del peaks, one_shot
    torch.cuda.empty_cache()
    phase_peak("RaggedConvStream")


def tuner_phase(fc, image_d, bank_d, idx, want, path_launches, times) -> None:
    """The tuner at the headline shape over default_candidates(64, 64) and
    the analytic window: a table of candidate → ms and fused flag; the
    winner registered under the card's name and returned by
    choose_block_plan; fft_conv at the winner against float64 and timed
    beside the analytic plan; the table cleared."""
    import torch

    from cuda_fft_convolution_torch.ops.tiled import choose_block_plan, fused_dispatch_auto
    from cuda_fft_convolution_torch.runtime import autotune

    s, n, k = HEADLINE["size"], HEADLINE["n"], HEADLINE["k"]
    analytic = choose_block_plan(s, s, k, k)
    cands = autotune.default_candidates(k, k) + [TUNE["analytic"]]
    try:
        t0 = time.perf_counter()
        best, timings = autotune.autotune_block_geometry(
            (s, s, 1), k, k, n_kernels=TUNE["n_kernels"], candidates=cands)
        print(f"autotune_block_geometry({(s, s, 1)}, {k}, {k}, n_kernels="
              f"{TUNE['n_kernels']}): {len(timings)} of {len(cands)} candidates in "
              f"{time.perf_counter() - t0:.1f} s ({card()})")
        for c in cands:
            vh, vw, bh, bw = autotune._blocks(c, k, k)
            ms = f"{1e3 * timings[c]:.3f} ms" if c in timings else "declined"
            print(f"  {str(c):22s} blocks ({bh}, {bw}): {ms}, fused "
                  f"{fused_dispatch_auto(bw, torch.float32, vh)}{'  <- best' if c == best else ''}")
        keys = list(autotune._MEASURED)
        vh, vw, bh, bw = autotune._blocks(best, k, k)
        tuned = choose_block_plan(s, s, k, k)
        print(f"registered under {[key[0] for key in keys]}; choose_block_plan now {tuned} "
              f"(analytic {analytic})")
        if [key[0] for key in keys] != [torch.cuda.get_device_name(0)] or \
                tuned != (bh, bw, bh - vh + 1, bw - vw + 1):
            raise AssertionError(f"tuner registration: keys {keys}, plan {tuned}")
        fused = fused_dispatch_auto(bw, torch.float32, vh)
        maps = main_path("headline fft_conv at the tuned plan",
                         lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same"),
                         "block_conv_f32" if fused else "spectral_mac_f32", path_launches)
        err = max_rel_err_f64(maps, idx, want)
        print(f"headline fft_conv at the tuned plan: vs float64 numpy on kernels {idx}: max "
              f"rel err {err:.3e} (bar {TOL:g})")
        if err > TOL:
            raise AssertionError(f"tuned plan error {err} above {TOL}")
        del maps
        timed("headline fft_conv, tuned plan",
              lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same"), times)
    finally:
        autotune._MEASURED.clear()
    if choose_block_plan(s, s, k, k) != analytic:
        raise AssertionError("the cleared table still changes the headline plan")
    timed("headline fft_conv, analytic plan",
          lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same"), times)
    phase_peak("tuner")


# The model layer at full width (steps 24–26).
# Pyramid: the DPM inputs at float32, 5 levels at scale 2^-0.5 (512, 362,
# 256, 181, 128), 8 DPM filters planted 2x enlarged at 3x amplitude, so
# each is found at level 2 (scale 0.5), within `near` cells of its centre.
PYRAMID = dict(levels=5, scale=2 ** -0.5, plant_level=2, amplitude=3.0, near=3,
               checked_levels=(0, 2))
# MOSSE at Bolme et al. (CVPR 2010)'s settings: a 64² window, 8 training
# perturbations (shifts up to `shift`), sigma 2, learning rate 0.125; a
# pixel variant (F = 1, `frame`² frames, a `target`² target) and a HOG
# variant (F = 31 cells of a `hog_image`² image, a `hog_target`² target).
MOSSE = dict(window=64, frames=64, perturbations=8, shift=4, sigma=2.0, lr=0.125,
             frame=256, target=24, hog_image=1024, hog_target=192)
# The trainer: 8 frames of the DPM features (centred, shifted and noised),
# 64 filters of 12²x31 (one DPM class model: six components of a root and
# eight parts, rounded up), 8 Adam steps at 3e-2.
TRAINER = dict(frames=8, n=64, steps=8, lr=3e-2, noise=0.05, grad_tol=1e-4)
# Filters a plain or library MAC call takes where one call over the whole
# bank would not fit beside it (the pyramid's 37 GB level-0 bank).
MAC_CHUNK = 64


def mac_row(ops, label, chunk=None) -> tuple:
    """The MAC kernel on ``ops`` against the einsum, each plane within 1e-5
    of max |einsum|, then its time, the einsum's and one complex einsum's
    → (max abs err, ms, plain ms, bound ms, bound by, library ms). With
    ``chunk``, the einsum and the complex einsum run over chunks of that
    many filters and their times are summed (one call over the bank would
    not fit beside it)."""
    import torch

    from cuda_fft_convolution_torch.ops.spectral_mac import spectral_mac, spectral_mac_planes

    n = ops[2].shape[0]
    parts = [(s, min(s + (chunk or n), n)) for s in range(0, n, chunk or n)]

    def sub(s, e):
        return ops[0], ops[1], ops[2][s:e], ops[3][s:e]

    got = spectral_mac(*ops)
    diff, peak = [0.0, 0.0], [0.0, 0.0]
    for s, e in parts:
        for p, (g, w) in enumerate(zip(got, spectral_mac_planes(*sub(s, e)))):
            diff[p] = max(diff[p], float((g[:, s:e] - w).abs().max()))
            peak[p] = max(peak[p], float(w.abs().max()))
    del got
    err = max(d / m for d, m in zip(diff, peak))
    print(f"MAC kernel vs einsum, {label}: {tuple(ops[0].shape)} x {tuple(ops[2].shape)}: "
          f"max abs {max(diff):.3e}, rel {err:.3e}"
          + (f" (einsum over {len(parts)} chunks of {chunk})" if chunk else ""))
    if err > TOL:
        raise AssertionError(f"MAC kernel disagrees with the einsum ({label}): {err}")
    # the wrapper in windows of AB_REPS calls back to back (one-call windows
    # and a CUDA graph's device time beside it)
    b, f, h, w = ops[0].shape
    out_bytes = b * ops[2].shape[0] * h * w * 8
    ms = cuda_ms(lambda: spectral_mac(*ops), reps=AB_REPS)
    one_call = cuda_ms(lambda: spectral_mac(*ops))
    device = graph_ms(lambda: spectral_mac(*ops), out_bytes=out_bytes)
    mac_tiles_and_ab(label, ops)
    plain = sum(cuda_ms(lambda: spectral_mac_planes(*sub(s, e)), runs=3) for s, e in parts)
    lib_times = [complex_einsum_ms(sub(s, e), 1 if chunk else AB_REPS) for s, e in parts]
    library, lib_one = (sum(t[i] for t in lib_times) for i in range(2))
    lib_device = None if None in (t[2] for t in lib_times) else sum(t[2] for t in lib_times)
    bound_ms, bound_by = mac_bound(ops)
    torch.cuda.empty_cache()
    def dev(t):
        return "not measured" if t is None else f"{t:.4f}"

    print(f"MAC kernel, {label}, form {mac_rule(ops)}: {ms:.4f} ms (windows of {AB_REPS} calls; "
          f"one-call windows {one_call:.4f}, device time (CUDA graph) {dev(device)}); einsum "
          f"{plain:.3f} ms; one complex einsum {library:.4f} ms (one-call {lib_one:.4f}, device "
          f"{dev(lib_device)}); bound {bound_ms:.4f} ms ({bound_by}; "
          f"{100 * bound_ms / ms:.1f}% of it; {card()})")
    return max(diff), ms, plain, bound_ms, bound_by, library


def direct_route(sd, bank) -> tuple[str, int]:
    """The route ``conv_spectral`` takes for the raw corner ``bank`` against
    direct spectra ``sd`` on this card's budget (``api.direct_bank_plan``,
    the function it calls) → ('resident', 'chunked' or 'streamed', kernels
    a MAC)."""
    from cuda_fft_convolution_torch import api

    n = bank.shape[0]
    route, plan = api.direct_bank_plan(sd, n, raw_corner=True,
                                       stack_bytes=bank.numel() * bank.element_size())
    return route, min(plan.chunk_size, n)


def pyramid_phase(fc, seed, path_launches, times, rows, row_launches) -> None:
    """The pyramid at DPM width (module docstring, step 24)."""
    import torch

    from cuda_fft_convolution_torch.models import (
        build_pyramid,
        detect_peaks,
        detect_pyramid,
        detect_pyramid_peaks,
    )
    from cuda_fft_convolution_torch.models.pyramid import resize_bilinear

    feats, bank, _ = dpm_inputs(seed, store="float32")
    n, k = DPM["n"], DPM["k"]
    planted, corners = dpm_plant_sites()
    up = 2 * k
    for t, (y0, x0) in zip(planted, corners):
        feats[y0 : y0 + up, x0 : x0 + up] += PYRAMID["amplitude"] * resize_bilinear(
            bank[t], up, up)

    def build():
        return build_pyramid(feats, k, k, num_levels=PYRAMID["levels"], scale=PYRAMID["scale"])

    pyr = build()
    sizes = [tuple(lv.shape) for lv in pyr.levels]
    ffts = [(sd.fft_h, sd.fft_w) for sd in pyr.spectra]
    print(f"pyramid: levels {sizes}, FFT sizes {ffts}, bank {tuple(bank.shape)}")
    if [s[0] for s in sizes] != [512, 362, 256, 181, 128] or any(
            lv.dtype != torch.float32 or not lv.is_cuda for lv in pyr.levels):
        raise AssertionError(f"pyramid levels {sizes}")
    det = main_path("pyramid detect_pyramid_peaks", lambda: detect_pyramid_peaks(pyr, bank),
                    "spectral_mac_f32", path_launches)
    level_launches, level0_shapes = [], collections.Counter()
    for i, sd in enumerate(pyr.spectra):
        route, chunk = direct_route(sd, bank)
        counts = collections.Counter()
        main_path(f"pyramid level {i}, detect_peaks on its spectra",
                  lambda: detect_peaks(sd, bank), "spectral_mac_f32", counts,
                  level0_shapes if i == 0 else None)
        level_launches.append(counts["spectral_mac_f32"])
        print(f"  level {i} ({sd.data_h}², FFT {sd.fft_h}x{sd.fft_w}): bank {route}, "
              f"{chunk} filters a MAC, {level_launches[-1]} MAC launches")
        if level_launches[-1] != -(-n // chunk):
            raise AssertionError(f"level {i}: {level_launches[-1]} MAC launches, "
                                 f"the {route} plan makes {-(-n // chunk)}")
    best_level, best_pos = det.best_level.cpu(), det.best_position.cpu()
    for t, (y0, x0) in zip(planted, corners):
        lvl, (y, x) = int(best_level[t]), (int(c) for c in best_pos[t])
        dist = max(abs(y - (y0 + (up - 1) / 2)), abs(x - (x0 + (up - 1) / 2)))
        if lvl != PYRAMID["plant_level"] or dist > PYRAMID["near"]:
            raise AssertionError(f"planted filter {t}: level {lvl} at ({y}, {x}), plant at "
                                 f"({y0}, {x0}) size {up}")
    print(f"pyramid: all {len(planted)} plants found at level {PYRAMID['plant_level']} "
          f"within {PYRAMID['near']} cells of their centres; best values "
          f"{[round(float(det.best_value[t]), 1) for t in planted]}")

    level_maps = main_path("pyramid detect_pyramid", lambda: detect_pyramid(pyr, bank),
                           "spectral_mac_f32", path_launches)
    idx = list(range(0, n, n // 8))
    flipped = bank.flip(1, 2).cpu().numpy()
    for i, maps in enumerate(level_maps):
        flat = maps.reshape(n, -1)
        best = flat.argmax(-1)
        pos = torch.stack([best // maps.shape[-1], best % maps.shape[-1]], -1).int()
        if not (torch.equal(det.values[i], flat.gather(-1, best[:, None])[:, 0])
                and torch.equal(det.positions[i], pos)):
            raise AssertionError(f"level {i}: peaks differ from the argmax of the maps")
        if i in PYRAMID["checked_levels"]:
            want = dpm_reference_f64(pyr.levels[i].double().cpu().numpy(), flipped, idx)
            err = max_rel_err_f64(maps, idx, want)
            print(f"pyramid level {i} maps vs float64 numpy on filters {idx}: max rel err "
                  f"{err:.3e}")
            if err > TOL:
                raise AssertionError(f"pyramid level {i} error {err} above {TOL}")
    print("pyramid: every level's values and positions = the argmax of its maps")
    del level_maps, maps, flat
    torch.cuda.empty_cache()
    phase_peak("pyramid")
    timed("pyramid build_pyramid", build, times)
    timed("pyramid detect_pyramid_peaks", lambda: detect_pyramid_peaks(pyr, bank), times)
    timed("pyramid detect_pyramid", lambda: detect_pyramid(pyr, bank), times)

    sd0 = pyr.spectra[0]
    route, chunk = direct_route(sd0, bank)
    sk = fc.fft_kernels(bank[:chunk], spectral=sd0, correlation=True)
    ops = (sd0.re[None], sd0.im[None], sk.re, sk.im)
    name = "spectral_mac_f32:pyramid_level0"
    rows[name] = mac_row(ops, f"pyramid level 0 ({route} bank)",
                         chunk=MAC_CHUNK if chunk > MAC_CHUNK else None)
    # the level-0 run's launches at this shape (every chunk but a short last)
    row_launches[name] = level0_shapes[mac_shape(ops)]
    if row_launches[name] != n // chunk:
        raise AssertionError(f"level 0: {dict(level0_shapes)} MAC launches by shape, "
                             f"{n // chunk} expected at {mac_shape(ops)}")
    del sk, ops, pyr, feats, bank
    torch.cuda.empty_cache()
    phase_peak("pyramid, level-0 MAC")


def hann(size, device):
    import torch

    w = torch.hann_window(size, periodic=False, device=device)
    return w[:, None] * w[None, :]


def mosse_scene(gen, hog: bool) -> tuple[list, list]:
    """`frames` frames of a target moving along a known path over a
    static background, from ``gen`` → (frames, the target's centre each
    frame). Pixels (F = 1): a `target`² white-noise patch on a smooth
    `frame`² background, with per-frame noise, frames (H, W, 1). HOG
    (F = 31): a smooth `hog_target`² texture on a noise `hog_image`²
    image, moved in whole cells, frames its ``hog_features`` (cells)."""
    import math

    import torch

    from cuda_fft_convolution_torch.models import hog_features

    dev = gen.device
    frames, centres = [], []
    if hog:
        cell = DPM["cell"]
        side, size = MOSSE["hog_image"], MOSSE["hog_target"]
        back = torch.randn((side, side), generator=gen, device=dev)
        target = 3.0 * torch.nn.functional.interpolate(
            torch.randn((1, 1, size // cell, size // cell), generator=gen, device=dev),
            size=(size, size), mode="bilinear", align_corners=False)[0, 0]
        half = size // cell // 2
    else:
        side, size = MOSSE["frame"], MOSSE["target"]
        back = torch.nn.functional.avg_pool2d(
            torch.randn((1, 1, side, side), generator=gen, device=dev), 5, 1, 2)[0, 0]
        target = torch.randn((size, size), generator=gen, device=dev)
        half = size // 2
    for t in range(MOSSE["frames"]):
        phase = 2 * math.pi * t / MOSSE["frames"]
        if hog:
            y, x = 40 + round(10 * math.sin(phase)), 30 + round(0.6 * t)
            img = back.clone()
            img[y * cell : y * cell + size, x * cell : x * cell + size] = target
            frames.append(hog_features(img, cell=cell, bins=DPM["bins"]))
        else:
            y, x = 100 + round(30 * math.sin(phase)), 60 + 2 * t
            img = back.clone()
            img[y : y + size, x : x + size] = target
            img += 0.05 * torch.randn((side, side), generator=gen, device=dev)
            frames.append(img[..., None])
        centres.append((y + half, x + half))
    return frames, centres


def mosse_window(frame, centre, window):
    """The (window, window, F) patch of ``frame`` centred at ``centre``,
    normalised (zero mean, unit std) and Hann-weighted (Bolme et al.'s
    preprocessing); raises if it leaves the frame."""
    cy, cx = centre
    r0, c0 = cy - window // 2, cx - window // 2
    if r0 < 0 or c0 < 0 or r0 + window > frame.shape[0] or c0 + window > frame.shape[1]:
        raise AssertionError(f"MOSSE window at {centre} leaves the {tuple(frame.shape)} frame")
    w = frame[r0 : r0 + window, c0 : c0 + window]
    w = (w - w.mean((0, 1))) / (w.std() + 1e-5)
    return w * hann(window, frame.device)[..., None]


def mosse_track(fc, frames, centres, gen):
    """Train on the first frame (`perturbations` shifted windows, Gaussian
    targets at the shifted centres), then ``mosse_frame`` on every other
    frame from the last estimate → (estimates, the filter)."""
    import torch

    from cuda_fft_convolution_torch.models import gaussian_target, train_mosse

    win, sigma, dev = MOSSE["window"], MOSSE["sigma"], frames[0].device
    half = win // 2
    shifts = torch.randint(-MOSSE["shift"], MOSSE["shift"] + 1,
                           (MOSSE["perturbations"], 2), generator=gen, device=dev).tolist()
    cy, cx = centres[0]
    patches = torch.stack([mosse_window(frames[0], (cy + dy, cx + dx), win).permute(2, 0, 1)
                           for dy, dx in shifts])
    targets = torch.stack([gaussian_target(win, win, (half - dy, half - dx), sigma, device=dev)
                           for dy, dx in shifts])
    filt = train_mosse(patches, targets, win, win)
    centred = gaussian_target(win, win, (half, half), sigma, device=dev)
    estimates = [tuple(centres[0])]
    for frame in frames[1:]:
        est, filt = mosse_frame(fc, filt, frame, estimates[-1], centred)
        estimates.append(est)
    return estimates, filt


def mosse_frame(fc, filt, frame, est, target):
    """One tracker frame: ``respond`` on the window at the last estimate
    ``est``, the new estimate at its peak (read on the host), and
    ``update_mosse`` on the window there toward ``target`` → (the new
    estimate, the updated filter)."""
    from cuda_fft_convolution_torch.models import respond, update_mosse

    win = MOSSE["window"]
    peak = int(respond(filt, fc.fft_data(mosse_window(frame, est, win), 1, 1)).argmax())
    est = (est[0] - win // 2 + peak // win, est[1] - win // 2 + peak % win)
    return est, update_mosse(filt, mosse_window(frame, est, win).permute(2, 0, 1), target,
                             lr=MOSSE["lr"])


def mosse_phase(fc, seed, path_launches, times, rows, row_launches) -> None:
    """The MOSSE tracker (module docstring, step 25)."""
    import torch

    from cuda_fft_convolution_torch.models import gaussian_target

    for hog in (False, True):
        label = "MOSSE, HOG (F=31)" if hog else "MOSSE, pixels (F=1)"
        gen = torch.Generator(device="cuda").manual_seed(seed + 7)
        frames, centres = mosse_scene(gen, hog)
        counts, shapes = collections.Counter(), collections.Counter()
        estimates, filt = main_path(f"{label}, {len(frames)} frames",
                                    lambda: mosse_track(fc, frames, centres, gen),
                                    "spectral_mac_f32", counts, shapes)
        path_launches.update(counts)
        off = [max(abs(e[0] - c[0]), abs(e[1] - c[1])) for e, c in zip(estimates, centres)]
        print(f"{label}: window {MOSSE['window']}², frames {tuple(frames[0].shape)}; the peak's "
              f"distance from the path: max {max(off)}, per frame {off}")
        if max(off) > 1 or counts["spectral_mac_f32"] != len(frames) - 1:
            raise AssertionError(f"{label}: off the path by {max(off)}, "
                                 f"{counts['spectral_mac_f32']} MAC launches")
        # the main path's MAC launches by form: respond's at HOG cells take
        # the split form (3 CTAs of the (1, 1) tile would leave 129 SMs idle)
        from cuda_fft_convolution_torch.ops.spectral_mac import MAC_SPLIT, spectral_mac

        forms = dict(spectral_mac.launches_by_form)
        print(f"{label}: MAC launches by form {forms}")
        if forms != {MAC_SPLIT if hog else (1, 1): len(frames) - 1}:
            raise AssertionError(f"{label}: MAC launches by form {forms}")
        win = MOSSE["window"]
        sd = fc.fft_data(mosse_window(frames[-1], estimates[-1], win), 1, 1)
        # respond's MAC, the kernel over a bank of one, against the einsum
        ops = (sd.re[None], sd.im[None], filt.h_re[None], filt.h_im[None])
        if hog:
            name = "spectral_mac_f32:mosse_respond_hog"
            rows[name] = mac_row(ops, f"{label} respond")
            row_launches[name] = shapes[mac_shape(ops)]
            if row_launches[name] != len(frames) - 1:
                raise AssertionError(f"{label}: {dict(shapes)} MAC launches by shape")
        else:
            check_mac(ops)
        centred = gaussian_target(win, win, (win // 2, win // 2), MOSSE["sigma"],
                                  device="cuda")
        timed(f"{label}, a frame (window, fft_data, respond, argmax, update_mosse)",
              lambda: mosse_frame(fc, filt, frames[-1], estimates[-1], centred), times)
    phase_peak("MOSSE")


def trainer_reference_f64(images, kernels, bias, pairs) -> np.ndarray:
    """float64 numpy 'same' correlation maps plus bias of the (B, F, H, W)
    ``images`` with the (N, F, Kh, Kw) ``kernels`` for (b, n) ``pairs``."""
    out = []
    for b, n in pairs:
        feats = images[b].double().cpu().numpy().transpose(1, 2, 0)
        kern = kernels[n].flip(1, 2).double().cpu().numpy().transpose(1, 2, 0)
        out.append(dpm_reference_f64(feats, kern[None], [0])[0] + float(bias[n]))
    return np.stack(out)


def trainer_inputs(fc, seed):
    """The trainer's inputs on the card: `frames` frames (B, 31, 512, 512)
    of the DPM features, the starting parameters as numpy fields, the model
    carried from them, and a second detector's maps as realisable targets
    → (images, fields, model, targets)."""
    import torch

    from cuda_fft_convolution_torch.models import detect

    feats, _, _ = dpm_inputs(seed, store="float32")
    # Centred per channel (the mean subtraction of whitened-HOG detectors):
    # on raw HOG, whose channels share a positive mean, Adam's first step
    # moves every response by lr·Σ|x| and the loss rose 10⁴x at lr 3e-2.
    feats -= feats.mean((0, 1))
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    b, n, k, f = TRAINER["frames"], TRAINER["n"], DPM["k"], DPM["bins"]
    images = torch.stack([
        torch.roll(feats, (7 * i, 11 * i), (0, 1))
        + TRAINER["noise"] * torch.randn(feats.shape, generator=gen, device="cuda")
        for i in range(b)
    ]).permute(0, 3, 1, 2).contiguous()
    del feats
    rng = np.random.default_rng(seed + 9)
    scale = 1 / np.sqrt(f * k * k)
    init = {"kernels": (scale * rng.standard_normal((n, f, k, k))).astype(np.float32),
            "bias": np.zeros(n, np.float32)}
    target_model = fc.detector_from_numpy({
        "kernels": (scale * rng.standard_normal((n, f, k, k))).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(n)).astype(np.float32)}, device="cuda")
    with torch.no_grad():
        targets = detect(target_model, images)
    return images, init, fc.detector_from_numpy(init, device="cuda"), targets


def trainer_phase(fc, seed, path_launches, times, rows, row_launches) -> None:
    """The filter-bank detector, forward and training (module docstring,
    step 26)."""
    import unittest.mock

    import torch

    from cuda_fft_convolution_torch.models import detect, filter_bank, loss_fn, train_step
    from cuda_fft_convolution_torch.ops.conv import rfft2_padded_planes
    from cuda_fft_convolution_torch.ops.spectral_mac import spectral_mac_planes

    images, init, model, targets = trainer_inputs(fc, seed)
    b, n, k, f = TRAINER["frames"], TRAINER["n"], DPM["k"], DPM["bins"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    fft = fc.compute_fft_size(512, 512, k, k)
    # The MAC kernel's launch shapes (B, F, N) of the forward and of the
    # backward's two cotangents (ops/spectral_mac.py _SpectralMac):
    # dK = MAC(gᵀ, conj(D)ᵀ), dD = MAC(g, conj(K)ᵀ).
    fwd, dk, dd = (("spectral_mac_f32", *m, fft[0], fft[1] // 2 + 1)
                   for m in ((b, f, n), (n, b, f), (b, n, f)))
    shapes = collections.Counter()  # over this phase's main-path runs

    def run(label, fn, want):
        """``main_path`` of ``fn``; fails unless its MAC launches by shape
        are ``want``."""
        got = collections.Counter()
        out = main_path(label, fn, "spectral_mac_f32", path_launches, got)
        if got != collections.Counter(want):
            raise AssertionError(f"{label}: MAC launches by shape {dict(got)}, not {want}")
        shapes.update(got)
        return out

    with torch.no_grad():
        maps = run("trainer detect (forward)", lambda: detect(model, images), [fwd])
    if not (tuple(maps.shape) == (b, n, 512, 512) and torch.isfinite(maps).all()):
        raise AssertionError(f"detector maps {tuple(maps.shape)}")
    pairs = [(i, (8 * i + 3) % n) for i in range(b)]
    want = trainer_reference_f64(images, model.kernels.detach(), model.bias.detach(), pairs)
    err = max_rel_err_f64(maps[tuple(zip(*pairs))], list(range(len(pairs))), want)
    print(f"trainer: images {tuple(images.shape)}, bank {tuple(model.kernels.shape)}; detect "
          f"vs float64 numpy on (image, filter) {pairs}: max rel err {err:.3e}")
    if err > TOL:
        raise AssertionError(f"detect error {err} above {TOL}")
    del maps

    opt = torch.optim.Adam(model.parameters(), lr=TRAINER["lr"])
    losses = []
    for step in range(TRAINER["steps"]):
        # forward and dK: the images need no gradient
        _, _, loss = run(f"train_step {step}",
                         lambda: train_step(model, opt, images, targets), [fwd, dk])
        losses.append(float(loss))
        if step == 0:
            grads = model.kernels.grad.clone(), model.bias.grad.clone()
    print(f"trainer: Adam lr {TRAINER['lr']}, losses {[f'{x:.5f}' for x in losses]}; each step "
          f"launched the MAC once at the forward's shape {fwd[1:4]} and once at dK's "
          f"{dk[1:4]} (B, F, N; the images need no gradient)")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    plain = fc.detector_from_numpy(init, device="cuda")
    before = dict(_wrappers()[2].launches_by_mode)
    with unittest.mock.patch.object(filter_bank, "spectral_mac_auto_planes",
                                    spectral_mac_planes):
        loss_fn(plain, images, targets).backward()
    torch.cuda.synchronize()
    if dict(_wrappers()[2].launches_by_mode) != before:
        raise AssertionError("the einsum-backward run launched the MAC kernel")
    gerr = max(rel_err(grads[0], plain.kernels.grad), rel_err(grads[1], plain.bias.grad))
    print(f"trainer: first step's gradients vs the einsum's autograd on the card: rel "
          f"{gerr:.3e} (bar {TRAINER['grad_tol']:g})")
    if gerr > TRAINER["grad_tol"]:
        raise AssertionError(f"gradients {gerr} above {TRAINER['grad_tol']}")
    del plain, grads
    x = images.clone().requires_grad_(True)
    run("trainer loss backward with the images' gradient too",
        lambda: loss_fn(model, x, targets).backward(), [fwd, dd, dk])
    if not torch.isfinite(x.grad).all():
        raise AssertionError("the images' gradient is not finite")
    del x
    torch.cuda.empty_cache()
    phase_peak("trainer")

    timed("trainer train_step", lambda: train_step(model, opt, images, targets), times)
    timed("trainer forward (loss_fn)", lambda: loss_fn(model, images, targets), times)
    loss = loss_fn(model, images, targets)
    timed("trainer backward", lambda: loss.backward(retain_graph=True), times)
    del loss
    opt.zero_grad()
    phase_peak("trainer, timing")

    with torch.no_grad():
        d = rfft2_padded_planes(images, *fft)
        kp = rfft2_padded_planes(model.kernels.flip(-2, -1), *fft)
    g = tuple(torch.randn((b, n, fft[0], fft[1] // 2 + 1), generator=gen, device="cuda")
              for _ in range(2))

    def t(x):
        return x.transpose(0, 1).contiguous()

    # The forward's and the backward's operands, g random planes from the
    # seed; each row's launches are this phase's main-path launches at its
    # shape.
    for name, ops in (
        ("train_forward", (*d, *kp)),
        ("train_dK", (t(g[0]), t(g[1]), t(d[0]), t(d[1]).neg())),
        ("input_grad_dD", (*g, t(kp[0]), t(kp[1]).neg())),
    ):
        rows[f"spectral_mac_f32:{name}"] = mac_row(ops, f"trainer {name}")
        row_launches[f"spectral_mac_f32:{name}"] = shapes[mac_shape(ops)]
        del ops
    print(f"trainer: MAC launches by shape over the phase's main-path runs {dict(shapes)}")
    del d, kp, g, images, targets, model, opt
    torch.cuda.empty_cache()
    phase_peak("trainer, MAC rows")


# The ops/conv cores at the headline: the FFT size of the FAST policy for
# 2048 + 64 − 1, the maps checked against float64, and the MAC kernel's
# launch shape (mode, B, F, N, H, Wc) of one fft_conv_stack call.
CORES = dict(fft=2160, maps=8, direct_out=2111, tf32_shape=(64, 128, 3))


def circular_f64(image, kernel, fft) -> np.ndarray:
    """float64 numpy circular convolution of one-channel (H, W, 1) arrays at
    (fft, fft) — the 'full' linear maps zero-extended when fft ≥ H + K − 1."""
    return np.fft.irfft2(np.fft.rfft2(image[..., 0].astype(np.float64), s=(fft, fft))
                         * np.fft.rfft2(kernel[..., 0].astype(np.float64), s=(fft, fft)),
                         s=(fft, fft))


def direct_conv_check(fc, data, kernel, want, label) -> None:
    """``direct_conv_single(data, kernel)`` called with cuDNN's TF32 on, as
    PyTorch ships it (the smoke turns it off): within 1e-5 of the float64
    maps ``want`` (the call runs with TF32 off) and the setting restored;
    the same ``conv2d`` with TF32 left on is printed beside it."""
    import torch

    def f64_err(maps) -> float:
        return float(np.abs(maps.double().cpu().numpy() - want).max() / np.abs(want).max())

    k = kernel.shape[-1]
    torch.backends.cudnn.allow_tf32 = True
    try:
        direct = fc.direct_conv_single(data, kernel)
        torch.cuda.synchronize()
        restored = torch.backends.cudnn.allow_tf32
        tf32_err = f64_err(torch.nn.functional.conv2d(
            data[None], kernel[None].flip(-2, -1), padding=k - 1)[0, 0])
    finally:
        torch.backends.cudnn.allow_tf32 = False
    err = f64_err(direct)
    print(f"direct_conv_single [{label}] {tuple(direct.shape)}, called with cuDNN TF32 on "
          f"(restored to {restored}), vs float64: max rel err {err:.3e}; the same conv2d "
          f"with TF32 left on: {tf32_err:.3e}")
    if tuple(direct.shape) != want.shape or err > TOL or restored is not True:
        raise AssertionError(f"direct_conv_single [{label}] {tuple(direct.shape)}: error "
                             f"{err}, allow_tf32 after the call {restored}")


def cores_phase(fc, seed, image, bank, image_d, bank_d, path_launches, times) -> None:
    """The cores of ``ops/conv.py`` at the headline (module docstring, step
    27): ``fft_conv_stack`` of the channel-leading image with the bank
    against float64 and ``fft_conv(mode='fftmap', algorithm='direct')``,
    one MAC launch a call at its shape; ``fft_conv_single`` against map 0;
    ``direct_conv_single`` (cuDNN, TF32 off) against float64; each timed."""
    import torch

    fft, n = CORES["fft"], HEADLINE["n"]
    data = image_d.permute(2, 0, 1)  # (1, H, W)
    kernels = bank_d.permute(0, 3, 1, 2)  # (N, 1, Kh, Kw)
    shape = ("spectral_mac_f32", 1, 1, n, fft, fft // 2 + 1)
    shapes = collections.Counter()
    maps = main_path("cores fft_conv_stack", lambda: fc.fft_conv_stack(data, kernels),
                     "spectral_mac_f32", path_launches, shapes)
    if dict(shapes) != {shape: 1}:
        raise AssertionError(f"fft_conv_stack: MAC launches by shape {dict(shapes)}, "
                             f"not one at {shape}")
    if not (tuple(maps.shape) == (n, fft, fft) and torch.isfinite(maps).all()):
        raise AssertionError(f"fft_conv_stack maps {tuple(maps.shape)}")
    idx = list(range(0, n, n // CORES["maps"]))[:CORES["maps"]]
    want = [circular_f64(image, bank[i], fft) for i in idx]
    err = max_rel_err_f64(maps, idx, want)
    print(f"fft_conv_stack {tuple(data.shape)} x {tuple(kernels.shape)} -> "
          f"{tuple(maps.shape)}: one MAC launch at {shape[1:]}; vs float64 numpy on "
          f"kernels {idx}: max rel err {err:.3e}")
    if err > TOL:
        raise AssertionError(f"fft_conv_stack error {err} above {TOL}")
    ref = fc.fft_conv(image_d, kernels=bank_d, mode="fftmap", algorithm="direct")
    diff = rel_err(maps, ref)
    print(f"fft_conv_stack vs fft_conv(mode='fftmap', algorithm='direct'): rel {diff:.3e}")
    if diff > 1e-6:
        raise AssertionError(f"fft_conv_stack differs from fft_conv's direct maps: {diff}")
    del ref
    single = main_path("cores fft_conv_single",
                       lambda: fc.fft_conv_single(data, kernels[0]),
                       "spectral_mac_f32", path_launches)
    diff = rel_err(single, maps[0])
    print(f"fft_conv_single(kernel 0) {tuple(single.shape)} vs map 0: rel {diff:.3e}")
    if diff > 1e-6:
        raise AssertionError(f"fft_conv_single differs from fft_conv_stack: {diff}")
    del maps, single
    torch.cuda.empty_cache()
    out = CORES["direct_out"]
    direct_conv_check(fc, data, kernels[0], want[0][:out, :out], "headline, kernel 0")
    # many channels and a small kernel, where cuDNN's fp32 algorithms do
    # round to TF32 when allowed (at 64² kernels it picks others)
    f, size, k = CORES["tf32_shape"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    x = torch.randn((f, size, size), generator=gen, device="cuda")
    w = torch.randn((f, k, k), generator=gen, device="cuda")
    full = size + k - 1
    ref = np.fft.irfft2((np.fft.rfft2(x.double().cpu().numpy(), s=(full, full))
                         * np.fft.rfft2(w.double().cpu().numpy(), s=(full, full))).sum(0),
                        s=(full, full))
    direct_conv_check(fc, x, w, ref, f"F={f}, {size}², {k}x{k} kernel")
    del x, w, want
    phase_peak("cores at the headline")
    timed("cores fft_conv_stack", lambda: fc.fft_conv_stack(data, kernels), times)
    timed("cores fft_conv_single", lambda: fc.fft_conv_single(data, kernels[0]), times)
    timed("cores direct_conv_single", lambda: fc.direct_conv_single(data, kernels[0]), times)
    phase_peak("cores, timing")


def interop_phase(fc, image, bank_d, path_launches, times) -> None:
    """The complex MAC wrappers and ``SpectralData`` interop at the headline
    (module docstring, step 28)."""
    import torch

    from cuda_fft_convolution_torch.ops.spectral_mac import (
        spectral_mac_auto,
        spectral_mac_einsum,
        spectral_mac_pallas,
    )

    s, k = HEADLINE["size"], HEADLINE["k"]
    sd = fc.fft_data(image, k, k, device="cuda")
    fft = sd.fft_h
    sk = fc.fft_kernels(bank_d, spectral=sd)
    d, kc = sd.fft[None], sk.fft
    want = spectral_mac_einsum(d, kc)
    shape = ("spectral_mac_f32", 1, 1, HEADLINE["n"], fft, fft // 2 + 1)
    for name, fn in (("spectral_mac_pallas", spectral_mac_pallas),
                     ("spectral_mac_auto", spectral_mac_auto)):
        shapes = collections.Counter()
        got = main_path(f"complex {name}", lambda fn=fn: fn(d, kc), "spectral_mac_f32",
                        path_launches, shapes)
        diff = max(rel_err(got.real, want.real), rel_err(got.imag, want.imag))
        print(f"{name} on complex spectra {tuple(d.shape)} x {tuple(kc.shape)}: "
              f"launches by shape {dict(shapes)}; vs spectral_mac_einsum: rel {diff:.3e}")
        if dict(shapes) != {shape: 1} or got.dtype != torch.complex64 or diff > 1e-6:
            raise AssertionError(f"{name}: launches {dict(shapes)}, {got.dtype}, diff {diff}")
        del got
    timed("complex spectral_mac_auto (MAC kernel)", lambda: spectral_mac_auto(d, kc), times)
    timed("complex spectral_mac_einsum", lambda: spectral_mac_einsum(d, kc), times)
    del d, kc, want

    # the reference's H-packed layout, built with float64 numpy
    padded = np.zeros((fft, fft, 1))
    padded[:s, :s] = image
    packed = np.fft.fft2(padded, axes=(0, 1))[: fft // 2 + 1].astype(np.complex64)
    t0 = time.perf_counter()
    sd_ref = fc.SpectralData.from_reference_packed(packed, s, s, device="cuda")
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    got = fc.conv_spectral(sd_ref, sk, mode="same")
    ref = fc.conv_spectral(sd, sk, mode="same")
    diff = rel_err(got, ref)
    print(f"from_reference_packed {packed.shape} (host complex64 from float64 fft2) in "
          f"{load_ms:.1f} ms host clock: conv_spectral(mode='same') vs the fft_data path: "
          f"rel {diff:.3e}")
    if (sd_ref.fft_h, sd_ref.fft_w) != (sd.fft_h, sd.fft_w) or diff > TOL:
        raise AssertionError(f"from_reference_packed: {(sd_ref.fft_h, sd_ref.fft_w)}, {diff}")
    del got, ref, sd_ref, packed
    for name, built in (
        ("from_packed (complex)", fc.SpectralData.from_packed(sd.fft, s, s)),
        ("from_packed (planes)", fc.SpectralData.from_packed((sd.re, sd.im), s, s)),
        ("from_complex", fc.SpectralData.from_complex(sd.fft, fft, fft, s, s)),
    ):
        same = (torch.equal(built.re, sd.re) and torch.equal(built.im, sd.im)
                and (built.fft_h, built.fft_w) == (sd.fft_h, sd.fft_w))
        print(f"{name}: planes bitwise equal to fft_data's {same}")
        if not same:
            raise AssertionError(f"{name} planes differ from fft_data's")
    del sd, sk
    torch.cuda.empty_cache()
    phase_peak("complex wrappers and interop")


def selftest_phase(fc) -> None:
    """``selftest()`` on the card (module docstring, step 29): every C entry
    of the three kernels within its bar of its plain version."""
    import importlib

    from cuda_fft_convolution_torch.ops.spectral_mac import MAC_TILES

    # the module (``utils.selftest`` is also the function's name there)
    st = importlib.import_module("cuda_fft_convolution_torch.utils.selftest")
    rep = fc.selftest()
    print(f"selftest: backend {rep['backend']}, {rep['device_kind']}, {rep['device_count']} "
          f"device(s), {rep['hbm_bytes_limit']} B, fft_ok {rep['fft_ok']}, kernels_ok "
          f"{rep['kernels_ok']}")
    for name, err in rep["kernels"].items():
        print(f"  selftest {name}: max rel err {err:.3e}")
    # per configuration: 4 maps and 2 peaks entries at 3xTF32, 2 maps and 1
    # peaks entry at each of the 6xTF32, one-pass and BF16IO tiers
    entries = len(st.CONFIGS) * 15 + 2 * len(MAC_TILES)
    if not (rep["fft_ok"] and rep["kernels_ok"] is True and len(rep["kernels"]) == entries):
        raise AssertionError(f"selftest failed: {rep}")


def profiling_phase(fc, image_d, bank_d, fused_ms) -> None:
    """``utils.profiling.benchmark`` on the headline call beside the smoke's
    own CUDA-event time (module docstring, step 30)."""
    from cuda_fft_convolution_torch.utils.profiling import benchmark

    stats = benchmark(lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same"), iters=RUNS)
    print(f"profiling.benchmark(headline fft_conv): median {stats['median_s'] * 1e3:.3f} ms, "
          f"min {stats['min_s'] * 1e3:.3f}, mean {stats['mean_s'] * 1e3:.3f} over "
          f"{stats['iters']} calls; the smoke's cuda_ms {fused_ms:.3f} ms ({card()})")
    if not 0 < stats["min_s"] <= stats["median_s"]:
        raise AssertionError(f"benchmark stats not sane: {stats}")


DEMOS = ("demo", "demo_bank", "demo_detect", "demo_dpm", "demo_serving", "demo_train")


def demos_phase(times) -> None:
    """The six demos on the card at their default sizes (module docstring,
    step 31); each raises on a failed check."""
    import importlib

    import torch

    for name in DEMOS:
        module = importlib.import_module(f"cuda_fft_convolution_torch.demos.{name}")
        t0 = time.perf_counter()
        module.main([])
        torch.cuda.synchronize()
        times[f"demo {name} (host clock)"] = (time.perf_counter() - t0) * 1e3
        print(f"demos.{name}: passed in {times[f'demo {name} (host clock)']:.0f} ms "
              f"({card()})")
    torch.cuda.empty_cache()
    phase_peak("demos")


# The parallel layer on the card (step 32): a world of one NCCL rank; the
# per-rank program run for each of `shards` kernel shards of the headline
# bank in turn (34 + 34 + 32, zero-padded); the train step at TRAINER's
# width with Adam at its lr.
PARALLEL = dict(shards=3, per_rank_tol=1e-6)


def nccl_world_of_one():
    """Start a world of one NCCL rank on card 0 (a ``file://`` store in a
    temporary directory under build/) → the directory, to clean up after
    ``destroy_process_group``."""
    import tempfile

    import torch
    import torch.distributed as dist

    root = pathlib.Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    store = tempfile.TemporaryDirectory(dir=root)
    dist.init_process_group("nccl", init_method=pathlib.Path(store.name, "store").as_uri(),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    return store


def parallel_phase(fc, seed, image_d, bank_d, path_launches, times, rows,
                   row_launches) -> None:
    """The parallel layer on the card (module docstring, step 32); the
    sharded step's MAC shapes get rows of their own, ``<shape>_sharded``,
    with that step's launches."""
    import torch
    import torch.distributed as dist

    from cuda_fft_convolution_torch import api
    from cuda_fft_convolution_torch.models import (
        detect_peaks,
        detect_top_k,
        detector_from_numpy,
        train_step,
    )
    from cuda_fft_convolution_torch.ops.block_conv import reset_launches
    from cuda_fft_convolution_torch.ops.conv import rfft2_padded_planes
    from cuda_fft_convolution_torch.parallel import mesh as pmesh
    from cuda_fft_convolution_torch.runtime import planner

    s, n, k = HEADLINE["size"], HEADLINE["n"], HEADLINE["k"]
    t0 = time.perf_counter()
    store = nccl_world_of_one()
    try:
        mesh = fc.make_mesh(data=1, kernels=1)
        print(f"parallel: a world of one NCCL rank ({dist.get_backend()}), mesh {mesh}; "
              f"started in {time.perf_counter() - t0:.1f} s (host clock)")

        # the headline tiled call on a placed bank, placed a second time
        spec = fc.fft_data_tiled(image_d, k, k, trim_mode="same")
        sk = fc.fft_kernels(bank_d, spectral=spec)
        placed = fc.shard_kernel_bank(sk, mesh)
        again = fc.shard_kernel_bank(placed, mesh)
        if not (again is placed and pmesh._local_bank(placed, mesh)[0].data_ptr()
                == placed.re.to_local().data_ptr()):
            raise AssertionError("shard_kernel_bank placed a placed bank again")
        want = fc.conv_spectral(spec, sk, mode="same")
        got = main_path("sharded headline tiled conv_spectral_sharded",
                        lambda: fc.conv_spectral_sharded(spec, placed, mesh, mode="same"),
                        "block_conv_f32", path_launches)
        equal = torch.equal(got.full_tensor(), want)
        print(f"sharded headline tiled: {tuple(got.shape)} {type(got).__name__} over "
              f"{got.placements}; = conv_spectral's maps bitwise: {equal}")
        if not equal:
            raise AssertionError("sharded tiled maps differ from conv_spectral's")
        timed("sharded headline tiled conv_spectral_sharded",
              lambda: fc.conv_spectral_sharded(spec, placed, mesh, mode="same"), times)
        timed("headline tiled conv_spectral, beside it",
              lambda: fc.conv_spectral(spec, sk, mode="same"), times)

        # the per-rank program over 3 uneven shards of the headline bank
        d_re, d_im = api._batched_planes(spec)
        budget = api._device_memory_budget(d_re.device)
        per_shard = -(-n // PARALLEL["shards"])
        parts = []
        for r in range(PARALLEL["shards"]):
            start, stop = min(n, r * per_shard), min(n, (r + 1) * per_shard)
            k_re, k_im = (pmesh._pad_rows(x[start:stop], per_shard) for x in (sk.re, sk.im))
            parts.append(pmesh._rank_maps(spec, d_re, d_im, k_re, k_im, torch.float32,
                                          budget)[:, : stop - start])
        joined = torch.cat(parts, 1)[0]
        diff = rel_err(joined, want)
        print(f"per-rank program over {PARALLEL['shards']} kernel shards "
              f"{[p.shape[1] for p in parts]} (zero-padded to {per_shard}): vs the unsharded maps "
              f"rel {diff:.3e} (bar {PARALLEL['per_rank_tol']:g}); bitwise: "
              f"{torch.equal(joined, want)}")
        if diff > PARALLEL["per_rank_tol"]:
            raise AssertionError(f"per-rank shards differ from the unsharded maps: {diff}")
        del spec, sk, placed, again, want, got, parts, joined, d_re, d_im
        torch.cuda.empty_cache()

        # the direct engine through the MAC kernel
        dspec = fc.fft_data(image_d, k, k)
        shapes = collections.Counter()
        got = main_path("sharded headline direct conv_spectral_sharded",
                        lambda: fc.conv_spectral_sharded(dspec, bank_d, mesh, mode="same"),
                        "spectral_mac_f32", path_launches, shapes)
        mac_at = ("spectral_mac_f32", 1, 1, n, dspec.fft_h, dspec.fft_w // 2 + 1)
        equal = torch.equal(got.full_tensor(), fc.conv_spectral(dspec, bank_d, mode="same"))
        print(f"sharded headline direct: = conv_spectral's maps bitwise: {equal}; MAC "
              f"launches by shape {dict(shapes)}")
        if not equal or shapes[mac_at] != 1:
            raise AssertionError(f"sharded direct: equal {equal}, MAC at {dict(shapes)}")
        del dspec, got
        torch.cuda.empty_cache()

        # the DPM giant bank streamed under a forced budget (step 16's)
        feats, dpm_bank, _ = dpm_inputs(seed)
        dpm_bank = dpm_bank[: DPM_DIRECT["n"]].contiguous()
        sd = fc.fft_data(feats, DPM["k"], DPM["k"], store_dtype="bfloat16")
        resident = planner.spectra_bytes(DPM_DIRECT["n"], sd.feature_dim, sd.fft_h, sd.fft_w, 2)
        budget = int(DPM_DIRECT["stream_share"] * resident)
        fc.set_config(hbm_budget_bytes=budget)
        try:
            want = fc.conv_spectral(sd, dpm_bank, mode="fftmap")
            got = main_path(f"sharded DPM giant bank streamed, budget {budget / 1e9:.2f} GB",
                            lambda: fc.conv_spectral_sharded(sd, dpm_bank, mesh, mode="fftmap"),
                            "spectral_mac_f32", path_launches)
            equal = torch.equal(got.full_tensor(), want)
            print(f"sharded DPM giant bank streamed: = the single-device streamed maps "
                  f"bitwise: {equal}")
            if not equal:
                raise AssertionError("sharded streamed DPM maps differ")
            del want, got
            timed("sharded DPM giant bank streamed",
                  lambda: fc.conv_spectral_sharded(sd, dpm_bank, mesh, mode="fftmap"), times)
        finally:
            fc.set_config(hbm_budget_bytes=None)
        del feats, dpm_bank, sd
        torch.cuda.empty_cache()

        # detection: the detection headline's inputs (plan_phase draws them so)
        rng = np.random.default_rng(seed)
        det_bank = rng.standard_normal((n, k, k, 1)).astype(np.float32)
        det_image_d = torch.as_tensor(detection_frame(rng, det_bank), device="cuda")
        det_bank_d = torch.as_tensor(det_bank, device="cuda")
        sdt = fc.fft_data_tiled(det_image_d, k, k, trim_mode="same")
        vals, pos = main_path("sharded detection headline detect_peaks_sharded",
                              lambda: fc.detect_peaks_sharded(sdt, det_bank_d, mesh),
                              "block_conv_peaks_f32", path_launches)
        wv, wp = detect_peaks(sdt, det_bank_d, mode="same")
        found = int((pos.full_tensor().cpu() == detection_centres()).all(-1).sum())
        equal = torch.equal(pos.full_tensor(), wp) and torch.equal(vals.full_tensor(), wv)
        v5, p5 = main_path("sharded detection headline detect_peaks_sharded k=5",
                           lambda: fc.detect_peaks_sharded(sdt, det_bank_d, mesh, k=5),
                           "block_conv_peaks_f32", path_launches)
        tv, tp = detect_top_k(sdt, det_bank_d, k=5, mode="same")
        equal5 = torch.equal(p5.full_tensor(), tp) and torch.equal(v5.full_tensor(), tv)
        print(f"detect_peaks_sharded: planted centres found {found} of {n}; = detect_peaks "
              f"bitwise: {equal}; k=5 = detect_top_k bitwise: {equal5}")
        if found != n or not equal or not equal5:
            raise AssertionError("sharded detection differs or missed plants")
        timed("sharded detection headline detect_peaks_sharded",
              lambda: fc.detect_peaks_sharded(sdt, det_bank_d, mesh), times)
        del det_image_d, det_bank_d, sdt
        torch.cuda.empty_cache()
        phase_peak("parallel layer, calls")

        # ShardedConvStream over step 19's host frames at depth 3
        count = STREAM["frames"]
        rng = np.random.default_rng(seed + 4)
        frames = [rng.standard_normal((s, s, 1)).astype(np.float32) for _ in range(count)]
        kw = dict(depth=3, mode="same", algorithm="tiled")
        sstream = fc.ShardedConvStream(mesh, bank_d, (s, s, 1), **kw)
        cstream = fc.ConvStream.create((s, s, 1), bank_d, **kw)

        def serve_and_check():
            pending, equal = collections.deque(), []
            for i, f in enumerate(frames):
                pending.append((i, sstream.submit(f)))
                if len(pending) == sstream.depth or i == count - 1:
                    while pending:
                        j, fut = pending.popleft()
                        equal.append(torch.equal(fut.result().to_local(),
                                                 cstream.submit(frames[j]).result()))
            return equal

        equal = main_path(f"ShardedConvStream headline, depth 3, {count} host frames",
                          serve_and_check, "block_conv_f32", path_launches)
        print(f"ShardedConvStream: frames bitwise equal to ConvStream's: {sum(equal)} of {count}")
        if not all(equal):
            raise AssertionError("ShardedConvStream frames differ from ConvStream's")
        times["headline ShardedConvStream depth 3 per frame"] = stream_ms(sstream, frames)
        times["headline ConvStream depth 3 per frame, beside it"] = stream_ms(cstream, frames)
        print(f"headline serving, ms a frame over {count} host frames: ShardedConvStream "
              f"depth 3 {times['headline ShardedConvStream depth 3 per frame']:.3f}; ConvStream "
              f"depth 3 {times['headline ConvStream depth 3 per frame, beside it']:.3f} "
              f"({card()})")
        # one submit's launches and allocations: the bank is not placed or
        # transformed again, so the sharded submit allocates as ConvStream's
        per_submit = {}
        for name, st in (("ShardedConvStream", sstream), ("ConvStream", cstream)):
            st.submit(frames[0]).result()
            torch.cuda.synchronize()
            reset_launches(*_wrappers())
            before = torch.cuda.memory_stats()
            st.submit(frames[1]).result()
            after = torch.cuda.memory_stats()
            counts = collections.Counter()
            for w in _wrappers():
                counts.update(w.launches_by_mode)
            per_submit[name] = (dict(counts), *(
                after[key] - before[key]
                for key in ("allocation.all.allocated", "allocated_bytes.all.allocated")))
        print(f"one submit (launches, allocations, bytes allocated): {per_submit}")
        (s_launch, s_count, s_bytes), (c_launch, c_count, c_bytes) = per_submit.values()
        if s_launch != {"block_conv_f32": 1} or s_bytes > c_bytes + (1 << 20):
            raise AssertionError(f"a sharded submit does more than ConvStream's: {per_submit}")
        frame_d = torch.as_tensor(frames[0], device="cuda")
        placed = fc.shard_kernel_bank(fc.fft_kernels(bank_d, fft_h=sstream.plan.fft_h,
                                                     fft_w=sstream.plan.fft_w), mesh)
        frame_ms = min(cuda_ms(lambda: fc.conv_spectral_sharded(
            sstream.plan.data_spectra(frame_d), placed, mesh, mode="same"), 1)
            for _ in range(RUNS))
        host = {name: [] for name in per_submit}
        # the controls, as step 19's: the host copy of a frame into pinned
        # memory alone, timed before each trial, and the caching
        # allocator's device allocations and retries over the timed submits
        pinned = torch.empty(frames[0].shape, dtype=torch.float32, pin_memory=True)
        control, counts = [], collections.Counter()
        keys = ("num_device_alloc", "num_device_free", "num_alloc_retries")
        for t in range(STREAM["trials"]):
            t1 = time.perf_counter()
            pinned.copy_(torch.as_tensor(frames[(t + 1) % count]))
            control.append(1e3 * (time.perf_counter() - t1))
            for name, st in (("ShardedConvStream", sstream), ("ConvStream", cstream)):
                st.flush()
                st.submit(frames[t % count])
                before = torch.cuda.memory_stats()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    t1 = time.perf_counter()
                    st.submit(frames[(t + 1) % count])
                    host[name].append(1e3 * (time.perf_counter() - t1))
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                after = torch.cuda.memory_stats()
                counts.update({k: after.get(k, 0) - before.get(k, 0) for k in keys})
                st.flush()
        del pinned
        host_ms = statistics.median(host["ShardedConvStream"])
        plain_ms = statistics.median(host["ConvStream"])
        times["headline ShardedConvStream submit, host"] = host_ms
        times["headline ConvStream submit, host, beside it"] = plain_ms
        print(f"ShardedConvStream submit into a queue with room: host {host_ms:.3f} ms (median "
              f"of {len(host['ConvStream'])}, turns with ConvStream's {plain_ms:.3f} ms; no "
              f"synchronising call under sync debug mode 'error') = "
              f"{100 * host_ms / frame_ms:.1f}% of one frame's device time {frame_ms:.3f} ms "
              f"(bar {100 * STREAM['submit_share']:.0f}%; {card()}); per trial, sharded / "
              f"ConvStream / the host copy alone ms: " + ", ".join(
                  f"{a:.3f}/{b:.3f}/{c:.3f}" for a, b, c in
                  zip(host["ShardedConvStream"], host["ConvStream"], control))
              + f"; over the {2 * len(control)} timed submits the allocator's {dict(counts)}")
        if host_ms >= STREAM["submit_share"] * frame_ms:
            raise AssertionError(f"a sharded submit takes {host_ms:.3f} ms against a "
                                 f"{frame_ms:.3f} ms frame")
        del sstream, cstream, frame_d, placed, frames
        torch.cuda.empty_cache()
        phase_peak("parallel layer, ShardedConvStream")

        # the DP×TP step at the trainer's width against train_step
        images, init, single, targets = trainer_inputs(fc, seed)
        sharded = detector_from_numpy(init, device="cuda")
        _, _, want = train_step(single, torch.optim.Adam(single.parameters(), lr=TRAINER["lr"]),
                                images, targets)
        opt = torch.optim.Adam(sharded.parameters(), lr=TRAINER["lr"])
        shapes = collections.Counter()
        _, _, got = main_path("train_step_sharded at the trainer's width",
                              lambda: pmesh.train_step_sharded(sharded, opt, images, targets,
                                                               mesh),
                              "spectral_mac_f32", path_launches, shapes)
        loss_err = abs(float(got) - float(want)) / abs(float(want))
        k_err = rel_err(sharded.kernels.detach(), single.kernels.detach())
        print(f"train_step_sharded vs train_step (Adam lr {TRAINER['lr']}): loss rel "
              f"{loss_err:.3e} (bar 1e-6), kernels rel {k_err:.3e} (bar 1e-5); MAC launches a "
              f"step by shape {dict(shapes)}")
        if loss_err > 1e-6 or k_err > TOL:
            raise AssertionError(f"sharded step: loss {loss_err}, kernels {k_err}")
        # the forward's and dK's launch shapes (B, F, N), as trainer_phase names them
        b, f, nf = images.shape[0], images.shape[1], sharded.num_filters
        fft = fc.compute_fft_size(*images.shape[2:], DPM["k"], DPM["k"])
        rows_at = {name: ("spectral_mac_f32", *m, fft[0], fft[1] // 2 + 1)
                   for name, m in (("train_forward", (b, f, nf)), ("train_dK", (nf, b, f)))}
        if shapes != collections.Counter(rows_at.values()):
            raise AssertionError(f"sharded step: MAC launches {dict(shapes)}, not {rows_at}")
        timed("train_step_sharded at the trainer's width",
              lambda: pmesh.train_step_sharded(sharded, opt, images, targets, mesh), times)
        # The step's forward and dK operands, as trainer_phase builds its
        # rows (g random planes from the seed); each row's launches are this
        # step's main-path launches at its shape.
        with torch.no_grad():
            d = rfft2_padded_planes(images, *fft)
            kp = rfft2_padded_planes(sharded.kernels.flip(-2, -1), *fft)
        gen = torch.Generator(device="cuda").manual_seed(seed + 11)
        g = tuple(torch.randn((b, nf, fft[0], fft[1] // 2 + 1), generator=gen, device="cuda")
                  for _ in range(2))

        def t(x):
            return x.transpose(0, 1).contiguous()

        for name, ops in (("train_forward", (*d, *kp)),
                          ("train_dK", (t(g[0]), t(g[1]), t(d[0]), t(d[1]).neg()))):
            rows[f"spectral_mac_f32:{name}_sharded"] = mac_row(ops, f"sharded step {name}")
            row_launches[f"spectral_mac_f32:{name}_sharded"] = shapes[rows_at[name]]
            del ops
        del images, single, sharded, targets, opt, d, kp, g
        torch.cuda.empty_cache()
        phase_peak("parallel layer, train step")
    finally:
        dist.destroy_process_group()
        store.cleanup()
    print(f"parallel layer phase: {time.perf_counter() - t0:.1f} s (host clock; {card()})")


# Step 33. The large-kernel regime (BASELINE.json configs[2], bench.py:
# 613-655): the headline image with `n` kernels of `k`², 'same', which the
# planner tiles at `plan` (an odd Lh of 1023, Wc 513: the paired
# configuration). The F=8 tier (bench.py:591-611): a `size`² image of `f`
# channels, `n` kernels of `k`²×`f`, bf16 spectra, planned at `plan` (the
# stacked configuration). Each maps against float64 on 8 maps.
BIGKERNEL = dict(n=16, k=512, plan=(1023, 1024, 512, 512))
F8_TIER = dict(size=1024, f=8, n=64, k=32, plan=(63, 287, 32, 32))
# Step 33's random-plane geometries: the two plans, N=3 and N=5 with
# clipped windows.
PLAN_GEOMETRIES = (
    (1, 1, 3, *BIGKERNEL["plan"], 1500, 1200, "large-kernel plan, Lh 1023, Wc 513"),
    (1, F8_TIER["f"], 5, *F8_TIER["plan"], 200, 700, "F=8 tier plan"),
)


def plan_launches(mode, plan) -> int:
    """Maps-kernel launches in mode ``mode`` at block plan ``plan`` since
    the last ``main_path`` reset them (``block_conv.launches_by_shape``);
    fails unless every maps launch of that run was at the plan."""
    from cuda_fft_convolution_torch.ops.block_conv import block_conv

    at_plan = block_conv.launches_by_shape[(mode, *plan)]
    if at_plan < 1 or at_plan != block_conv.launches:
        raise AssertionError(f"maps kernel launches by plan {dict(block_conv.launches_by_shape)}: "
                             f"not all in {mode} at {plan}")
    return at_plan


def kernel_row(ops, geom, label, splits=None, out_dtype=None, radix=None) -> tuple:
    """The maps kernel on ``ops`` at ``geom``, synthesis tier ``splits``
    (None: the config's), maps ``out_dtype`` and body ``radix`` (None: v3),
    against its plain version, timed → its JSON row (max abs error, ms,
    plain ms, bound, bound by, library ms; for a radix body also the bound
    of v3's work). The bound counts the body's own products
    (``block_conv_bound``)."""
    import torch

    from cuda_fft_convolution_torch.ops.block_conv import block_conv, block_conv_reference

    out_dtype = out_dtype or torch.float32
    bf16 = out_dtype == torch.bfloat16
    tol = tier_tol(ops[0], splits)
    radix = radix or {}
    abs_err = check_kernel(*ops, geom, label, out_dtype, max(tol, BF16_OUT_TOL) if bf16 else tol,
                           splits, radix)
    out_bytes = (2 if bf16 else 4) * ops[0].shape[0] * ops[2].shape[0] * geom[4] * geom[5]
    row = (abs_err, cuda_ms(lambda: block_conv(*ops, *geom, out_dtype, splits, **radix)),
           cuda_ms(lambda: block_conv_reference(*ops, *geom, out_dtype, splits, **radix)),
           *bounds(ops, geom, out_bytes, splits, radix))
    tier = f", {tier_label(ops[0], splits)}{body_label(radix)}"
    print(f"maps kernel alone [{label}{tier}{', bf16 maps' if bf16 else ''}]: {row[1]:.3f} ms; "
          f"plain version {row[2]:.3f} ms; {bound_text(row)} ({card()})")
    return row


def bounds(ops, geom, out_bytes, splits, radix) -> tuple:
    """A fused kernel row's bound, bound by and library ms (None: no one
    PyTorch call computes the fused function), and for another body or
    form than v3's 4-product one the bound of v3's work after them."""
    body = radix_body(radix)
    kara = bool((radix or {}).get("karatsuba"))
    tier = resolved(ops[0], splits)
    row = (*block_conv_bound(ops, geom, out_bytes, tier, body, kara), None)
    if body == "v3" and not kara:
        return row
    return (*row, block_conv_bound(ops, geom, out_bytes, tier)[0])


def bound_text(row) -> str:
    """The bound and its share of the row's time (and, for a radix body,
    the same-work bound's)."""
    text = f"bound {row[3]:.3f} ms ({row[4]}), {100 * row[3] / row[1]:.1f}% of it"
    if len(row) > 6:
        text += f"; bound of v3's 4-product work {row[6]:.3f} ms, {100 * row[6] / row[1]:.1f}%"
    return text


def peaks_row(ops, geom, label, splits=None, radix=None) -> tuple:
    """The peaks kernel on ``ops`` at ``geom``, tier ``splits`` and body
    ``radix`` (None: v3) against its plain version, timed → its JSON row
    (as ``kernel_row``'s; the bytes written are 8 a cell)."""
    from cuda_fft_convolution_torch.ops.block_conv import (
        block_conv_peaks,
        block_conv_peaks_reference,
    )

    radix = radix or {"radix_h": False}
    abs_err = check_peaks(*ops, geom, label, tier_tol(ops[0], splits), splits, radix)
    b, nbh, nbw = ops[0].shape[:3]
    row = (abs_err, cuda_ms(lambda: block_conv_peaks(*ops, *geom, splits, **radix)),
           cuda_ms(lambda: block_conv_peaks_reference(*ops, *geom, splits, **radix)),
           *bounds(ops, geom, 8 * b * nbh * nbw * ops[2].shape[0], splits, radix))
    tier = f", {tier_label(ops[0], splits)}{body_label(radix)}"
    print(f"peaks kernel alone [{label}{tier}]: {row[1]:.3f} ms; plain version {row[2]:.3f} ms; "
          f"{bound_text(row)} ({card()})")
    return row


def detect_row(label, name, fn, mode, plan_ops, geom, path_launches, rows, row_launches,
               maps_fn):
    """``detect_peaks`` at a plan on the main path (``fn``): its positions
    = the argmax of ``maps_fn()``'s maps; the peaks kernel's row ``name``
    (launches: this run's in ``mode``) on ``plan_ops`` → the positions."""
    import torch

    from cuda_fft_convolution_torch.ops.tiled import peaks_from_maps

    before = path_launches[mode]
    vals, pos = main_path(f"{label} detect_peaks", fn, mode, path_launches)
    maps = maps_fn()
    _, my, mx = peaks_from_maps(maps[None])
    if not torch.equal(pos, torch.stack([my[0], mx[0]], -1)):
        raise AssertionError(f"{label} detect_peaks differs from the argmax of its maps")
    print(f"{label} detect_peaks: {tuple(pos.shape)} positions = argmax of the maps")
    del maps
    torch.cuda.empty_cache()
    row_launches[name] = path_launches[mode] - before
    rows[name] = peaks_row(plan_ops, geom, f"{label} plan")
    return pos


def bigkernel_phase(fc, seed, image, image_d, path_launches, times, rows, row_launches):
    """The large-kernel regime (module docstring, step 33): the plan, the
    maps against float64 through the tiled and the direct route, times,
    the maps kernel's row at the plan, ``detect_peaks`` and the peaks
    kernel's row → (the bank on the card, the kernels checked, their
    float64 maps) for step 34."""
    import torch

    from cuda_fft_convolution_torch.models import detect_peaks
    from cuda_fft_convolution_torch.ops.tiled import choose_block_plan

    s, n, k, plan = HEADLINE["size"], BIGKERNEL["n"], BIGKERNEL["k"], BIGKERNEL["plan"]
    bank = np.random.default_rng(seed).standard_normal((n, k, k, 1)).astype(np.float32)
    bank_d = torch.as_tensor(bank, device="cuda")
    got_plan = choose_block_plan(s, s, k, k, device=image_d.device)
    print(f"large-kernel regime: {n} kernels of {k}² on the {s}² image; plan {got_plan}")
    if got_plan != plan:
        raise AssertionError(f"large-kernel plan {got_plan}, not {plan}")
    idx = list(range(0, n, n // 8))[:8]
    want = same_reference_f64(image, bank, idx)
    for label, kw, mode in (("auto (tiled)", {}, "block_conv_f32"),
                            ("direct", dict(algorithm="direct"), "spectral_mac_f32")):
        maps = main_path(f"large-kernel fft_conv, {label}", lambda: fc.fft_conv(
            image_d, kernels=bank_d, mode="same", **kw), mode, path_launches)
        if mode == "block_conv_f32":
            row_launches["block_conv_f32:large_kernel"] = plan_launches(mode, plan)
        if not (tuple(maps.shape) == (n, s, s) and torch.isfinite(maps).all()):
            raise AssertionError(f"large-kernel maps ({label}) malformed: {tuple(maps.shape)}")
        err = max_rel_err_f64(maps, idx, want)
        print(f"large-kernel fft_conv, {label}, vs float64 numpy on kernels {idx}: "
              f"max rel err {err:.3e} (bar {TOL:g})")
        if err > TOL:
            raise AssertionError(f"large-kernel error ({label}) {err} above {TOL}")
        del maps
    torch.cuda.empty_cache()
    spec = fc.fft_data_tiled(image_d, k, k, trim_mode="same")
    sk = fc.fft_kernels(bank_d, spectral=spec)
    auto = timed("large-kernel fft_conv, auto (tiled)",
                 lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same"), times)
    timed("large-kernel conv_spectral, amortized tiled",
          lambda: fc.conv_spectral(spec, sk, mode="same"), times)
    direct = timed("large-kernel fft_conv, direct",
                   lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same",
                                       algorithm="direct"), times)
    print(f"large-kernel route: direct / auto (tiled) = {direct / auto:.3f}")
    geom = (spec.block_h, spec.block_w, spec.max_kh, spec.max_kw, spec.out_h, spec.out_w)
    ops = (spec.re[None], spec.im[None], sk.re, sk.im)
    paired_report("large-kernel plan", geom[1] // 2 + 1, geom[0] - geom[2] + 1,
                  geom[1] - geom[3] + 1)
    rows["block_conv_f32:large_kernel"] = kernel_row(ops, geom, f"large-kernel plan, N={n}")
    detect_row("large-kernel", "block_conv_peaks_f32:large_kernel",
               lambda: detect_peaks(image_d, bank_d, mode="same"), "block_conv_peaks_f32",
               ops, geom, path_launches, rows, row_launches,
               lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same", correlation=True))
    del spec, sk, ops
    torch.cuda.empty_cache()
    return bank_d, idx, want


def f8_tier_phase(fc, seed, path_launches, times, rows, row_launches):
    """The F=8 tier (module docstring, step 33): the plan, 8 maps against
    float64 at the tier's bar, times, and the maps kernel's row at the
    plan with its stacking."""
    import torch

    from cuda_fft_convolution_torch.ops.tiled import choose_block_plan

    from cuda_fft_convolution_torch.models import detect_peaks

    size, f, n, k, plan = (F8_TIER[x] for x in ("size", "f", "n", "k", "plan"))
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((size, size, f)).astype(np.float32)
    bank = rng.standard_normal((n, k, k, f)).astype(np.float32)
    data_d, bank_d = torch.as_tensor(data, device="cuda"), torch.as_tensor(bank, device="cuda")
    got_plan = choose_block_plan(size, size, k, k, feature_dim=f, store_dtype="bfloat16",
                                 device=data_d.device)
    print(f"F=8 tier: {size}²x{f} image, {n} kernels of {k}²x{f}, bf16; plan {got_plan}")
    if got_plan != plan:
        raise AssertionError(f"F=8 tier plan {got_plan}, not {plan}")
    maps = main_path("F=8 tier fft_conv", lambda: fc.fft_conv(
        data_d, kernels=bank_d, mode="same", store_dtype="bfloat16"), "block_conv_bf16_io",
        path_launches)
    row_launches["block_conv_bf16_io:f8_tier"] = plan_launches("block_conv_bf16_io", plan)
    if not (tuple(maps.shape) == (n, size, size) and torch.isfinite(maps).all()):
        raise AssertionError(f"F=8 tier maps malformed: {tuple(maps.shape)}")
    idx = list(range(0, n, n // 8))[:8]
    err = max_rel_err_f64(maps, idx, dpm_reference_f64(data.astype(np.float64), bank, idx))
    print(f"F=8 tier fft_conv vs float64 numpy on kernels {idx}: max rel err {err:.3e} "
          f"(bar {BF16_TOL:g})")
    if err > BF16_TOL:
        raise AssertionError(f"F=8 tier error {err} above {BF16_TOL}")
    del maps
    torch.cuda.empty_cache()
    spec = fc.fft_data_tiled(data_d, k, k, trim_mode="same", store_dtype="bfloat16")
    sk = fc.fft_kernels(bank_d, spectral=spec, store_dtype="bfloat16")
    timed("F=8 tier fft_conv", lambda: fc.fft_conv(
        data_d, kernels=bank_d, mode="same", store_dtype="bfloat16"), times)
    timed("F=8 tier conv_spectral, amortized",
          lambda: fc.conv_spectral(spec, sk, mode="same"), times)
    geom = (spec.block_h, spec.block_w, spec.max_kh, spec.max_kw, spec.out_h, spec.out_w)
    ops = (spec.re[None], spec.im[None], sk.re, sk.im)
    stacked_report("F=8 tier plan", ops, geom)
    rows["block_conv_bf16_io:f8_tier"] = kernel_row(ops, geom, f"F=8 tier plan, N={n}")
    detect_row("F=8 tier", "block_conv_peaks_bf16_io:f8_tier",
               lambda: detect_peaks(data_d, bank_d, mode="same", store_dtype="bfloat16"),
               "block_conv_peaks_bf16_io", ops, geom, path_launches, rows, row_launches,
               lambda: fc.fft_conv(data_d, kernels=bank_d, mode="same", correlation=True,
                                   store_dtype="bfloat16"))
    check_io_bitwise(ops, geom, f"F=8 tier plan, N={n}", ops)
    del spec, sk, ops, data_d, bank_d
    torch.cuda.empty_cache()


# Step 34. The fused kernels' precision tiers: the config of each tier
# besides the default 3xTF32 (ops/block_conv.py fused_splits).
TIER_CONFIG = {6: dict(fused_precision="highest", matmul_precision="highest"),
               1: dict(fused_precision="highest", matmul_precision="default")}
TIER_NAME = {6: "6xTF32 ('highest')", 1: "one pass ('highest', matmul 'default')"}


@contextlib.contextmanager
def tier_config(fc, **fields):
    """The config with ``fields`` set, restored afterwards whatever
    happens."""
    before = fc.get_config()
    fc.set_config(**fields)
    try:
        yield
    finally:
        fc.set_config(**{f: getattr(before, f) for f in fields})


def check_tier_modes(d_re, d_im, k_re, k_im, geom, label) -> None:
    """Every entry of the 6xTF32 and one-pass tiers against the plain
    version on the same planes (module docstring, step 34); 6xTF32 against
    the plain version in float64 too; 'highest' with matmul 'high' = the
    default tier, bitwise."""
    import torch

    import cuda_fft_convolution_torch as fc
    from cuda_fft_convolution_torch.ops.block_conv import block_conv, block_conv_reference

    ops = (d_re, d_im, k_re, k_im)
    for splits, tol in ((6, TOL), (1, X1_TOL)):
        check_kernel(*ops, geom, label, tol=tol, splits=splits)
        check_kernel(*ops, geom, label, torch.bfloat16, max(tol, BF16_OUT_TOL), splits)
        check_peaks(*ops, geom, label, tol, splits)
    want64 = block_conv_reference(*(x.double() for x in ops), *geom, torch.float64)
    plain = rel_err(block_conv_reference(*ops, *geom).double(), want64)
    x6 = rel_err(block_conv(*ops, *geom, torch.float32, 6).double(), want64)
    default = block_conv(*ops, *geom, torch.float32, 3)
    x3 = rel_err(default.double(), want64)
    print(f"against the plain version in float64 [{label}]: 6xTF32 {x6:.3e} (bar "
          f"{X6_TOL:g}), 3xTF32 {x3:.3e}, the float32 plain version {plain:.3e}")
    if x6 > X6_TOL:
        raise AssertionError(f"6xTF32 {x6} from the float64 plain version ({label})")
    with tier_config(fc, fused_precision="highest", matmul_precision="high"):
        high = block_conv(*ops, *geom)
    torch.cuda.synchronize()
    if not torch.equal(high, default):
        raise AssertionError(f"'highest' with matmul 'high' is not the 3xTF32 entry ({label})")
    print(f"fused_precision='highest' with matmul_precision='high' = the default tier, "
          f"bitwise [{label}]")


def tiers_phase(fc, seed, rng, image_d, bank_d, idx, want, big, path_launches, times, rows,
                row_launches) -> None:
    """The precision tiers (module docstring, step 34). ``big``: step 33's
    large-kernel (bank on the card, kernels checked, their float64 maps)."""
    import torch

    from cuda_fft_convolution_torch.models import detect_peaks
    from cuda_fft_convolution_torch.ops.block_conv import TIER_SUFFIX, block_conv_reference
    from cuda_fft_convolution_torch.ops.tiled import peaks_from_maps

    t0 = time.perf_counter()
    check_random_geometries(rng, (
        *CHECK_GEOMETRIES, (1, 1, 4, 127, 447, 64, 64, 2048, 2048, "headline plan, N=4"),
        *PLAN_GEOMETRIES), check_tier_modes)
    k = HEADLINE["k"]
    spec = fc.fft_data_tiled(image_d, k, k, trim_mode="same")
    sk = fc.fft_kernels(bank_d, spectral=spec)
    geom = (spec.block_h, spec.block_w, spec.max_kh, spec.max_kw, spec.out_h, spec.out_w)
    ops = (spec.re[None], spec.im[None], sk.re, sk.im)
    plain_err = max_rel_err_f64(block_conv_reference(*ops, *geom)[0], idx, want)
    print(f"headline, the plain version's maps on the same spectra vs float64 on kernels {idx}: "
          f"max rel err {plain_err:.3e}")
    det_rng = np.random.default_rng(seed)
    det_bank = det_rng.standard_normal((DETECT["n"], k, k, 1)).astype(np.float32)
    det_image_d = torch.as_tensor(detection_frame(det_rng, det_bank), device="cuda")
    det_bank_d = torch.as_tensor(det_bank, device="cuda")
    big_bank_d, big_idx, big_want = big
    for splits in (6, 1):
        sfx, name = TIER_SUFFIX[splits], TIER_NAME[splits]
        bar = TOL if splits == 6 else X1_TOL
        with tier_config(fc, **TIER_CONFIG[splits]):
            maps = main_path(f"headline fft_conv, {name}", lambda: fc.fft_conv(
                image_d, kernels=bank_d, mode="same"), f"block_conv_f32{sfx}", path_launches)
            size = HEADLINE["size"]
            if not (tuple(maps.shape) == (HEADLINE["n"], size, size) and torch.isfinite(maps).all()):
                raise AssertionError(f"headline maps at {name} malformed: {tuple(maps.shape)}")
            err = max_rel_err_f64(maps, idx, want)
            print(f"headline fft_conv at {name} vs float64 on kernels {idx}: max rel err "
                  f"{err:.3e}; the plain version's {plain_err:.3e} (ratio {err / plain_err:.3f})")
            if err > bar or (splits == 6 and err > X6_F64_RATIO * plain_err):
                raise AssertionError(f"headline at {name}: {err} against float64")
            del maps
            timed(f"headline fft_conv, {name}",
                  lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same"), times)
            maps16 = main_path(f"headline fft_conv, bf16 maps, {name}", lambda: fc.fft_conv(
                image_d, kernels=bank_d, mode="same", out_dtype="bfloat16"),
                f"block_conv_f32_bf16maps{sfx}", path_launches)
            err16 = max_rel_err_f64(maps16.float(), idx, want)
            print(f"headline fft_conv, bf16 maps, at {name} vs float64: max rel err {err16:.3e} "
                  f"(bar {BF16_OUT_TOL:g})")
            if err16 > BF16_OUT_TOL:
                raise AssertionError(f"headline bf16 maps at {name}: {err16}")
            del maps16
            torch.cuda.empty_cache()
            vals, pos = main_path(f"detection headline detect_peaks, {name}", lambda: detect_peaks(
                det_image_d, det_bank_d, mode="same", correlation=True),
                f"block_conv_peaks_f32{sfx}", path_launches)
            if not torch.equal(pos.cpu(), detection_centres()):
                bad = int((pos.cpu() != detection_centres()).any(-1).sum())
                raise AssertionError(f"detect_peaks at {name} missed {bad} planted centres")
            dmaps = fc.fft_conv(det_image_d, kernels=det_bank_d, mode="same", correlation=True)
            _, my, mx = peaks_from_maps(dmaps[None])
            if not torch.equal(pos, torch.stack([my[0], mx[0]], -1)):
                raise AssertionError(f"detect_peaks at {name} differs from the argmax of its maps")
            print(f"detect_peaks at {name}: all {DETECT['n']} planted centres found, = argmax "
                  f"of the tier's fft_conv maps")
            del dmaps
            timed(f"detection headline detect_peaks, {name}",
                  lambda: detect_peaks(det_image_d, det_bank_d, mode="same"), times)
            mode = f"block_conv_f32{sfx}"
            bmaps = main_path(f"large-kernel fft_conv, {name}", lambda: fc.fft_conv(
                image_d, kernels=big_bank_d, mode="same"), mode, path_launches)
            row_launches[f"{mode}:large_kernel"] = plan_launches(mode, BIGKERNEL["plan"])
            berr = max_rel_err_f64(bmaps, big_idx, big_want)
            print(f"large-kernel fft_conv at {name} vs float64 on kernels {big_idx}: max rel err "
                  f"{berr:.3e} (bar {bar:g})")
            if berr > bar:
                raise AssertionError(f"large-kernel call at {name}: {berr} against float64")
            del bmaps
            timed(f"large-kernel fft_conv, {name}",
                  lambda: fc.fft_conv(image_d, kernels=big_bank_d, mode="same"), times)
        label = f"headline plan, N={HEADLINE['n']}"
        rows[f"block_conv_f32{sfx}"] = kernel_row(ops, geom, label, splits)
        rows[f"block_conv_f32_bf16maps{sfx}"] = kernel_row(ops, geom, label, splits, torch.bfloat16)
        big_spec = fc.fft_data_tiled(image_d, BIGKERNEL["k"], BIGKERNEL["k"], trim_mode="same")
        big_sk = fc.fft_kernels(big_bank_d, spectral=big_spec)
        big_geom = (big_spec.block_h, big_spec.block_w, big_spec.max_kh, big_spec.max_kw,
                    big_spec.out_h, big_spec.out_w)
        big_ops = (big_spec.re[None], big_spec.im[None], big_sk.re, big_sk.im)
        rows[f"block_conv_f32{sfx}:large_kernel"] = kernel_row(
            big_ops, big_geom, f"large-kernel plan, N={BIGKERNEL['n']}", splits)
        del big_spec, big_sk, big_ops
        torch.cuda.empty_cache()
    dspec = fc.fft_data_tiled(det_image_d, k, k, trim_mode="same")
    dsk = fc.fft_kernels(det_bank_d, spectral=dspec, correlation=True)
    pops = (dspec.re[None], dspec.im[None], dsk.re, dsk.im)
    for splits in (6, 1):
        rows[f"block_conv_peaks_f32{TIER_SUFFIX[splits]}"] = peaks_row(
            pops, geom, f"headline plan, N={DETECT['n']}", splits)
    print(f"tiers at the headline plan, maps kernel ms (bound): 3xTF32 "
          f"{rows['block_conv_f32'][1]:.3f} ({rows['block_conv_f32'][3]:.3f}), 6xTF32 "
          f"{rows['block_conv_f32_x6'][1]:.3f} ({rows['block_conv_f32_x6'][3]:.3f}), one pass "
          f"{rows['block_conv_f32_x1'][1]:.3f} ({rows['block_conv_f32_x1'][3]:.3f}); large-kernel "
          f"plan: {rows['block_conv_f32:large_kernel'][1]:.3f}, "
          f"{rows['block_conv_f32_x6:large_kernel'][1]:.3f}, "
          f"{rows['block_conv_f32_x1:large_kernel'][1]:.3f} ({card()})")
    del spec, sk, ops, dspec, dsk, pops, det_image_d, det_bank_d
    torch.cuda.empty_cache()
    times["step 34 (host s)"] = time.perf_counter() - t0
    print(f"precision tiers phase: {times['step 34 (host s)']:.1f} s (host clock)")


# Step 35. The bf16 tier's single pass (BF16IO): each _io entry at the
# headline, DPM, F=8 and large-kernel plans against its plain version, timed
# beside its 3xTF32 twin (the explicit splits=3, JAX's precision=BF16X3 on
# bf16 planes) and its bound.


def tier_plan(image_d, k) -> tuple:
    """The planner's block plan for ``image_d`` and k² kernels at the bf16
    tier."""
    from cuda_fft_convolution_torch.ops.tiled import choose_block_plan

    h, w, f = image_d.shape
    return choose_block_plan(h, w, k, k, feature_dim=f, store_dtype="bfloat16",
                             device=image_d.device)


def tier_spectra(fc, data, bank, k, correlation=False):
    """Tiled 'same' spectra of ``data`` and ``bank`` (k² kernels) at the
    bf16 tier → (kernel operands, geometry)."""
    spec = fc.fft_data_tiled(data, k, k, trim_mode="same", store_dtype="bfloat16")
    sk = fc.fft_kernels(bank, spectral=spec, correlation=correlation, store_dtype="bfloat16")
    geom = (spec.block_h, spec.block_w, spec.max_kh, spec.max_kw, spec.out_h, spec.out_w)
    return (spec.re[None], spec.im[None], sk.re, sk.im), geom


def twin_rows(ops, geom, label, name, twins, path_launches, rows, row_launches,
              peaks_ops=None) -> None:
    """The 3xTF32 twins of the _io entries on bf16 ``ops`` (``peaks_ops``
    for the peaks kernel): each launched by an explicit ops-level call with
    splits=3 (no route of the package takes it for bf16 spectra), counted
    as ``main_path`` counts, and its row ``<mode><name>`` (launches: that
    call's), as ``kernel_row``/``peaks_row``; ``twins`` the maps dtypes (and
    'peaks') to run."""
    import torch

    from cuda_fft_convolution_torch.ops.block_conv import block_conv, block_conv_peaks

    for twin in twins:
        if twin == "peaks":
            mode = "block_conv_peaks_bf16"
            fn = lambda: block_conv_peaks(*peaks_ops, *geom, 3)  # noqa: E731
        else:
            mode = f"block_conv_bf16{'_bf16maps' if twin == torch.bfloat16 else ''}"
            fn = lambda: block_conv(*ops, *geom, twin, 3)  # noqa: E731
        before = path_launches[mode]
        main_path(f"{label}, ops-level call, bf16 spectra at explicit splits=3 ({mode})", fn,
                  mode, path_launches)
        row_launches[mode + name] = path_launches[mode] - before
        rows[mode + name] = (peaks_row(peaks_ops, geom, label, 3) if twin == "peaks"
                             else kernel_row(ops, geom, label, 3, twin))


def bf16io_phase(fc, seed, image_d, bank_d, idx, want, big, path_launches, times, rows,
                 row_launches) -> None:
    """The bf16 tier's single pass (module docstring, step 35). ``big``:
    step 33's large-kernel (bank on the card, kernels checked, their
    float64 maps)."""
    import torch

    from cuda_fft_convolution_torch.models import detect_peaks
    from cuda_fft_convolution_torch.ops.block_conv import BF16IO, cluster_size, tile_rows
    from cuda_fft_convolution_torch.ops.tiled import peaks_from_maps

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    k, n, size = HEADLINE["k"], HEADLINE["n"], HEADLINE["size"]
    # the headline at the tier: fft_conv (f32 and bf16 maps) and the kernel
    maps = main_path("headline fft_conv at bf16io", lambda: fc.fft_conv(
        image_d, kernels=bank_d, mode="same", store_dtype="bfloat16"), "block_conv_bf16_io",
        path_launches)
    plan = tier_plan(image_d, k)
    row_launches["block_conv_bf16_io:headline"] = plan_launches("block_conv_bf16_io", plan)
    print(f"headline at bf16io: plan {plan}")
    maps16 = main_path("headline fft_conv at bf16io, bf16 maps", lambda: fc.fft_conv(
        image_d, kernels=bank_d, mode="same", store_dtype="bfloat16", out_dtype="bfloat16"),
        "block_conv_bf16_bf16maps_io", path_launches)
    row_launches["block_conv_bf16_bf16maps_io:headline"] = plan_launches(
        "block_conv_bf16_bf16maps_io", plan)
    err, err16 = max_rel_err_f64(maps, idx, want), rel_err(maps16.float(), maps)
    print(f"headline fft_conv at bf16io vs float64 on kernels {idx}: max rel err {err:.3e} "
          f"(bar {BF16_TOL:g}); bf16 maps vs f32 maps {err16:.3e} (bar {BF16_OUT_TOL:g})")
    if not (tuple(maps.shape) == (n, size, size) and torch.isfinite(maps).all()
            and err <= BF16_TOL and err16 <= BF16_OUT_TOL):
        raise AssertionError(f"headline at bf16io: {err}, bf16 maps {err16}")
    del maps, maps16
    torch.cuda.empty_cache()
    ops, geom = tier_spectra(fc, image_d, bank_d, k)
    label = f"headline plan, N={n}"
    rows["block_conv_bf16_io:headline"] = kernel_row(ops, geom, label)
    rows["block_conv_bf16_bf16maps_io:headline"] = kernel_row(ops, geom, label, None, bf16)
    twin = {"headline": kernel_row(ops, geom, label, 3)}
    io_control(ops, geom, label)
    # detection at the tier: every plant, = the argmax of the tier's maps
    det_rng = np.random.default_rng(seed)
    det_bank = det_rng.standard_normal((DETECT["n"], k, k, 1)).astype(np.float32)
    det_image_d = torch.as_tensor(detection_frame(det_rng, det_bank), device="cuda")
    det_bank_d = torch.as_tensor(det_bank, device="cuda")
    pops, _ = tier_spectra(fc, det_image_d, det_bank_d, k, correlation=True)
    pos = detect_row(
        "detection headline at bf16io", "block_conv_peaks_bf16_io:headline",
        lambda: detect_peaks(det_image_d, det_bank_d, mode="same", correlation=True,
                             store_dtype="bfloat16"),
        "block_conv_peaks_bf16_io", pops, geom, path_launches, rows, row_launches,
        lambda: fc.fft_conv(det_image_d, kernels=det_bank_d, mode="same", correlation=True,
                            store_dtype="bfloat16"))
    if not torch.equal(pos.cpu(), detection_centres()):
        raise AssertionError("detect_peaks at bf16io missed planted centres")
    print(f"detect_peaks at bf16io: all {DETECT['n']} planted centres found")
    twin["headline peaks"] = peaks_row(pops, geom, label, 3)
    check_io_bitwise(ops, geom, label, pops)
    del ops, pops, det_image_d, det_bank_d
    torch.cuda.empty_cache()

    # the DPM plan: the 3xTF32 twins' rows; the plants = the tier's argmax
    feats, bank, _ = dpm_inputs(seed)
    feats_p, planted, centres = dpm_planted(feats, bank)
    ops, geom = tier_spectra(fc, feats, bank, DPM["k"])
    pops, _ = tier_spectra(fc, feats_p, bank, DPM["k"], correlation=True)
    label = f"DPM plan, N={DPM['n']}"
    twin_rows(ops, geom, label, "", (torch.float32, bf16, "peaks"), path_launches, rows,
              row_launches, pops)
    _, pos = main_path("DPM detect_peaks at bf16io", lambda: detect_peaks(
        feats_p, bank, mode="same", correlation=True, store_dtype="bfloat16"),
        "block_conv_peaks_bf16_io", path_launches)
    dmaps = fc.fft_conv(feats_p, kernels=bank, mode="same", correlation=True,
                        store_dtype="bfloat16")
    _, my, mx = peaks_from_maps(dmaps[None])
    del dmaps
    if not (torch.equal(pos, torch.stack([my[0], mx[0]], -1))
            and (pos[planted] == centres).all()):
        raise AssertionError("DPM detect_peaks at bf16io: not the argmax of the tier's maps, "
                             "or a plant missed")
    print(f"DPM detect_peaks at bf16io: = the argmax of the tier's maps; all "
          f"{len(planted)} planted filters found")
    del ops, pops, feats, feats_p, bank
    torch.cuda.empty_cache()

    # the F=8 plan: the twins' rows at its plan
    size8, f8, n8, k8 = (F8_TIER[x] for x in ("size", "f", "n", "k"))
    rng = np.random.default_rng(seed)
    data8 = torch.as_tensor(rng.standard_normal((size8, size8, f8)).astype(np.float32),
                            device="cuda")
    bank8 = torch.as_tensor(rng.standard_normal((n8, k8, k8, f8)).astype(np.float32),
                            device="cuda")
    ops, geom = tier_spectra(fc, data8, bank8, k8)
    twin_rows(ops, geom, f"F=8 tier plan, N={n8}", ":f8_tier", (torch.float32, "peaks"),
              path_launches, rows, row_launches, ops)
    del ops, data8, bank8

    # the large-kernel plan (paired) at the tier
    big_bank_d, big_idx, big_want = big
    bk = BIGKERNEL["k"]
    bmaps = main_path("large-kernel fft_conv at bf16io", lambda: fc.fft_conv(
        image_d, kernels=big_bank_d, mode="same", store_dtype="bfloat16"),
        "block_conv_bf16_io", path_launches)
    plan = tier_plan(image_d, bk)
    row_launches["block_conv_bf16_io:large_kernel"] = plan_launches("block_conv_bf16_io", plan)
    wc_, vh_ = plan[1] // 2 + 1, plan[0] - plan[2] + 1
    print(f"large-kernel at bf16io: plan {plan}, {tile_rows(wc_, vh_, BF16IO)}-row tiles, "
          f"clusters of {cluster_size(wc_, vh_, BF16IO)} CTAs")
    berr = max_rel_err_f64(bmaps, big_idx, big_want)
    print(f"large-kernel fft_conv at bf16io vs float64 on kernels {big_idx}: max rel err "
          f"{berr:.3e} (bar {BF16_TOL:g})")
    if berr > BF16_TOL:
        raise AssertionError(f"large-kernel call at bf16io: {berr} against float64")
    del bmaps
    torch.cuda.empty_cache()
    ops, geom = tier_spectra(fc, image_d, big_bank_d, bk)
    label = f"large-kernel plan, N={BIGKERNEL['n']}"
    rows["block_conv_bf16_io:large_kernel"] = kernel_row(ops, geom, label)
    twin["large_kernel"] = kernel_row(ops, geom, label, 3)
    del ops
    torch.cuda.empty_cache()

    print(f"bf16io against its 3xTF32 twin, kernel ms (bound ms) ({card()}):")
    for name, io, x3 in (
        ("headline maps", rows["block_conv_bf16_io:headline"], twin["headline"]),
        ("headline peaks", rows["block_conv_peaks_bf16_io:headline"], twin["headline peaks"]),
        ("DPM maps", rows["block_conv_bf16_io"], rows["block_conv_bf16"]),
        ("DPM bf16 maps", rows["block_conv_bf16_bf16maps_io"], rows["block_conv_bf16_bf16maps"]),
        ("DPM peaks", rows["block_conv_peaks_bf16_io"], rows["block_conv_peaks_bf16"]),
        ("F=8 maps", rows["block_conv_bf16_io:f8_tier"], rows["block_conv_bf16:f8_tier"]),
        ("F=8 peaks", rows["block_conv_peaks_bf16_io:f8_tier"],
         rows["block_conv_peaks_bf16:f8_tier"]),
        ("large-kernel maps", rows["block_conv_bf16_io:large_kernel"], twin["large_kernel"]),
    ):
        print(f"  {name}: bf16io {io[1]:.3f}, 3xTF32 {x3[1]:.3f} ({io[1] / x3[1]:.3f}x); "
              f"bound {io[3]:.3f} ({io[4]})")
    times["step 35 (host s)"] = time.perf_counter() - t0
    print(f"bf16io phase: {times['step 35 (host s)']:.1f} s (host clock)")


# ---- step 36: the radix-2 bodies (JAX's v4, v5, v5x) ----
# JAX's one-block radix plans, reached through the tuner's table (valid
# window and blocks under the kernel envelope k²): its fp32 and bf16 F=1
# plan (256, 512, 65, 129) in the 64-row configuration (at 6xTF32 every
# radix body the cluster pair), its 32² plan (128, 512, 33, 129), and W =
# 1024 (Wc 513: every radix body the pair, as v3).
RADIX_PLANS = (
    dict(label="JAX F=1 plan", k=64, valid=(192, 384), block=(256, 512)),
    dict(label="JAX 32² plan", k=32, valid=(96, 384), block=(128, 512)),
    dict(label="W 1024", k=64, valid=(192, 896), block=(256, 1024)),
)
RADIX_FLAGS = {"v3": {}, "v4": dict(radix_h=True), "v5": dict(radix_w=True),
               "v5x": dict(radix_w=True, xsliver=True)}
# (spectra, tier, bar against the plain version, bar against float64)
RADIX_TIERS = (("f32", 3, TOL, TOL), ("f32", 6, TOL, TOL), ("f32", 1, X1_TOL, X1_TOL),
               ("bf16", 0, IO_TOL, BF16_TOL), ("bf16", 3, TOL, BF16_TOL))
# The JAX bodies the radix rows replace (cuda_fft_convolution_tpu/ops/block_conv.py),
# and for the Karatsuba entries (_k) the Karatsuba form of each body's csub.
RADIX_REPLACES = {("block_conv", "_r4"): 173, ("block_conv", "_r5"): 1251,
                  ("block_conv", "_r5x"): 1163, ("block_conv_peaks", "_r4"): 1764,
                  ("block_conv_peaks", "_r5"): 1456, ("block_conv_peaks", "_r5x"): 1606,
                  ("block_conv", "_r4_k"): 207, ("block_conv", "_r5_k"): 1320,
                  ("block_conv", "_r5x_k"): 1204, ("block_conv_peaks", "_r4_k"): 1794,
                  ("block_conv_peaks", "_r5_k"): 1509, ("block_conv_peaks", "_r5x_k"): 1648}


@contextlib.contextmanager
def radix_registries():
    """The tuner's geometry table and the radix-w plan registry, restored
    afterwards whatever happens."""
    from cuda_fft_convolution_torch.ops import block_conv as bc
    from cuda_fft_convolution_torch.runtime import autotune

    tables = [autotune._MEASURED, bc._RADIX_W_TABLE, bc._RADIX_W_TABLE_PEAKS,
              bc._RADIX_W_XSLIVER, bc._RADIX_W_XSLIVER_PEAKS]
    saved = [t.copy() for t in tables]
    try:
        yield
    finally:
        for t, v in zip(tables, saved):
            t.clear()
            t.update(v)


def register_radix_plan(fc, plan, body=None) -> None:
    """The tuner's entry for ``plan`` (RADIX_PLANS) at both tiers, and, for
    v5/v5x, its radix-w registration for both heads and both tiers."""
    from cuda_fft_convolution_torch.ops.block_conv import register_radix_w_plan

    bh, bw = plan["block"]
    for store in ("float32", "bfloat16"):
        fc.register_tuned_geometry(plan["k"], plan["k"], *plan["valid"], fused=True,
                                   block_h=bh, block_w=bw, store_dtype=store)
    if body in ("v5", "v5x"):
        kw = bw - plan["valid"][1] + 1
        for spec, head in itertools.product((4, 2), ("conv", "peaks")):
            register_radix_w_plan(bh, bw, kw, spec, head=head,
                                  sliver="xla" if body == "v5x" else "kernel")


def radix_geometry(fc, plan, image_d, bank):
    """Spectra of the headline image and ``bank`` (k² kernels, 'same' maps)
    at ``plan`` → (f32 ops, bf16 ops, geometry)."""
    import torch

    k = plan["k"]
    with radix_registries():
        register_radix_plan(fc, plan)
        spec = fc.fft_data_tiled(image_d, k, k, trim_mode="same")
    sk = fc.fft_kernels(torch.as_tensor(bank, device="cuda"), spectral=spec)
    geom = (spec.block_h, spec.block_w, spec.max_kh, spec.max_kw, spec.out_h, spec.out_w)
    bh, bw = plan["block"]
    if geom[:4] != (bh, bw, bh - plan["valid"][0] + 1, bw - plan["valid"][1] + 1):
        raise AssertionError(f"{plan['label']}: the tuned plan gave {geom[:4]}")
    ops = (spec.re[None], spec.im[None], sk.re, sk.im)
    return ops, tuple(x.to(torch.bfloat16) for x in ops), geom


def radix_checks(ops, ops16, geom, label, want, idx, table, karatsuba_rows=False) -> None:
    """Every body at ``geom`` (step 36), the radix bodies in both H-stage
    forms (4-product and Karatsuba, the ``_k`` entries): each entry — f32
    and bf16 maps, peaks — at every tier against its plain version with the
    same flags (``check_kernel``, ``check_peaks``, the smoke's bars), its
    f32 maps against float64 on ``idx`` (``want``), 6xTF32 against the
    plain version in float64, the BF16IO control; where the kernels do not
    take a form at a tier (``form_taken``) the call must raise and launch
    nothing. The Karatsuba entries' maps and peaks are checked here against
    their plain versions but for the bf16 maps (their f32 maps rounded
    once), and not at all with ``karatsuba_rows``, where their JSON rows
    check every entry (``kernel_row``, ``peaks_row``), and timed there.
    The 4-product entries and v4's Karatsuba ones are timed here, a line of
    ``table`` each: (label, tier, head, body, the configuration
    ``kernel_layout`` gives — the pair, 64 or 32 rows —, ms, the plain
    version's ms (median of 3), bound ms, bound by — the bound of the
    body's own products, ``block_conv_bound`` — the bound of v3's work, the
    body's synthesis products and v3's, ``synthesis_flop``)."""
    import torch

    from cuda_fft_convolution_torch.ops.block_conv import (
        block_conv,
        block_conv_peaks,
        block_conv_peaks_reference,
        block_conv_reference,
        form_taken,
        kernel_layout,
        radix_w_legal,
    )

    from cuda_fft_convolution_torch.utils.errors import InvalidInputError

    bh, bw, kh, kw, out_h, out_w = geom
    b, nbh, nbw = ops[0].shape[:3]
    n = ops[2].shape[0]
    cells = b * nbh * nbw * n
    vflop = {(body, kara): cells * synthesis_flop(bh, bw // 2 + 1, bh - kh + 1, bw - kw + 1,
                                                  body, kara)
             for body in RADIX_FLAGS for kara in (False, True)}
    out_bytes = {"maps": 4 * b * n * out_h * out_w, "bf16 maps": 2 * b * n * out_h * out_w,
                 "peaks": 8 * cells}
    bodies = [x for x in RADIX_FLAGS if x in ("v3", "v4") or radix_w_legal(bw, kw, bw - kw + 1)]
    forms = [(body, False) for body in bodies] + [(body, True) for body in bodies if body != "v3"]
    for body, kara in forms:
        flags = dict(RADIX_FLAGS[body], karatsuba=True) if kara else RADIX_FLAGS[body]
        pflags = flags if body != "v3" else {"radix_h": False}
        name = f"{body}{' karatsuba' if kara else ''}"

        def taken(tier):
            return form_taken(bw // 2 + 1, bh - kh + 1, tier, karatsuba=kara)

        for tag, splits, tol, f64_tol in RADIX_TIERS:
            planes = ops if tag == "f32" else ops16
            tier = tier_label(planes[0], splits)
            if not taken(resolved(planes[0], splits)):
                before = (block_conv.launches, block_conv_peaks.launches)
                for call in (lambda: block_conv(*planes, *geom, torch.float32, splits, **flags),
                             lambda: block_conv_peaks(*planes, *geom, splits, **pflags)):
                    try:
                        call()
                    except InvalidInputError as e:
                        print(f"radix [{label}] {name} {tag} {tier}: refused, {e}")
                    else:
                        raise AssertionError(f"{label} {name} {tier}: ran where no kernel takes it")
                if (block_conv.launches, block_conv_peaks.launches) != before:
                    raise AssertionError(f"{label} {name} {tier}: a refused call launched")
                continue
            if not (kara and karatsuba_rows):
                check_kernel(*planes, geom, label, torch.float32, tol, splits, flags)
                if not kara:
                    check_kernel(*planes, geom, label, torch.bfloat16, max(tol, BF16_OUT_TOL),
                                 splits, flags)
                check_peaks(*planes, geom, label, tol, splits, pflags)
            tier_s = resolved(planes[0], splits)
            rows, half = kernel_layout(body, bw // 2 + 1, bh - kh + 1, tier_s, kara)
            config = f"pair, {half} bins a rank" if half else f"{rows} rows"
            maps = block_conv(*planes, *geom, torch.float32, splits, **flags)[0]
            err = max_rel_err_f64(maps, idx, want)
            del maps
            print(f"radix [{label}] {name} {tag} {tier} ({config}) maps vs float64 on maps "
                  f"{idx}: {err:.3e} (bar {f64_tol:g})")
            if err > f64_tol:
                raise AssertionError(f"{label} {name} {tier}: {err} from float64")
            if kara and body != "v4":
                continue
            for head, fn, plain in (
                ("maps", lambda: block_conv(*planes, *geom, torch.float32, splits, **flags),
                 lambda: block_conv_reference(*planes, *geom, torch.float32, splits, **flags)),
                ("bf16 maps", lambda: block_conv(*planes, *geom, torch.bfloat16, splits, **flags),
                 lambda: block_conv_reference(*planes, *geom, torch.bfloat16, splits, **flags)),
                ("peaks", lambda: block_conv_peaks(*planes, *geom, splits, **pflags),
                 lambda: block_conv_peaks_reference(*planes, *geom, splits, **pflags)),
            ):
                bound_ms, by = block_conv_bound(planes, geom, out_bytes[head], tier_s, body, kara)
                same_ms = block_conv_bound(planes, geom, out_bytes[head], tier_s)[0]
                table.append((label, f"{tag} {tier}", head, name, config, cuda_ms(fn),
                              cuda_ms(plain, runs=3), bound_ms, by, same_ms, vflop[(body, kara)],
                              vflop[("v3", False)]))
            torch.cuda.empty_cache()
        if taken(6):
            x6 = rel_err(block_conv(*ops, *geom, torch.float32, 6, **flags).double(),
                         block_conv_reference(*(x.double() for x in ops), *geom, torch.float64,
                                              **flags))
            print(f"radix [{label}] {name} 6xTF32 vs its plain version in float64: {x6:.3e} "
                  f"(bar {X6_TOL:g})")
            if x6 > X6_TOL:
                raise AssertionError(f"{label} {name}: 6xTF32 {x6} from the float64 plain version")
        io_control(ops16, geom, label, flags)
        torch.cuda.empty_cache()


def radix_phase(fc, seed, image, image_d, bank, bank_d, idx, want, path_launches, times,
                rows, row_launches) -> None:
    """The radix-2 bodies (module docstring, step 36). ``bank``, ``want``:
    the headline's 100 kernels of 64² and their float64 maps on ``idx``."""
    import torch

    from cuda_fft_convolution_torch.models import detect_peaks
    from cuda_fft_convolution_torch.ops import block_conv as bc
    from cuda_fft_convolution_torch.ops.tiled import choose_block_plan

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 36)
    table = []
    first = None
    for plan in RADIX_PLANS:
        if plan["k"] == HEADLINE["k"]:
            pbank, pwant = bank, want
        else:
            pbank = rng.standard_normal((HEADLINE["n"], plan["k"], plan["k"], 1)).astype(
                np.float32)
            pwant = same_reference_f64(image, pbank, idx)
        ops, ops16, geom = radix_geometry(fc, plan, image_d, pbank)
        first = first or (ops, ops16, geom)
        radix_checks(ops, ops16, geom, f"{plan['label']} {geom[:4]}", pwant, idx, table,
                     karatsuba_rows=plan is RADIX_PLANS[0])
        del ops, ops16
        torch.cuda.empty_cache()
    # each body's kernel times at each plan, beside the bound of its own
    # products, the same-work bound (v3's synthesis_flop at the tier) and
    # the body's synthesis products
    print(f"radix bodies at JAX's plans, ms ({card()}):")
    for (label, tier, head, body, config, ms, plain_ms, bound_ms, by, same_ms, flop,
         v3_flop) in table:
        print(f"  {label} {tier} {head} {body} ({config}): {ms:.3f} ms; plain version "
              f"{plain_ms:.3f} ms; bound {bound_ms:.3f} ms ({by}), "
              f"{100 * bound_ms / ms:.1f}%; bound of v3's work {same_ms:.3f} ms, "
              f"{100 * same_ms / ms:.1f}%; synthesis products {flop / 1e12:.3f} TFLOP, "
              f"{flop / v3_flop:.3f} of v3's")
    print(f"radix kernel checks and times: {time.perf_counter() - t0:.1f} s (host clock)")

    # the main path at JAX's F=1 plan: fft_conv and detect_peaks through
    # the route (the tuner's table; v4 from radix_h_legal, v5/v5x from the
    # registry), every tier, both heads; the headline at the v5 plan
    # against the analytic plan; each main path held to float64 / the plants
    plan = RADIX_PLANS[0]
    ops, ops16, geom = first
    s, n, k = HEADLINE["size"], HEADLINE["n"], HEADLINE["k"]
    det_rng = np.random.default_rng(seed)  # the detection headline's
    det_bank = det_rng.standard_normal((n, k, k, 1)).astype(np.float32)
    det_image = torch.as_tensor(detection_frame(det_rng, det_bank), device="cuda")
    det_bank = torch.as_tensor(det_bank, device="cuda")
    want_main = want
    centres = detection_centres()
    tiers = (("3xTF32", {}, "", TOL), ("6xTF32", dict(fused_precision="highest",
                                                        matmul_precision="highest"), "_x6", TOL),
             ("1xTF32", dict(fused_precision="highest", matmul_precision="default"), "_x1",
              X1_TOL))
    for body in ("v4", "v5", "v5x"):
        suffix = bc.RADIX_SUFFIX[body]
        with radix_registries():
            register_radix_plan(fc, plan, body)
            for tier, cfg, tsuf, tol in tiers:
                with tier_config(fc, **cfg) if cfg else contextlib.nullcontext():
                    maps = main_path(
                        f"fft_conv at JAX's plan, {body}, {tier}",
                        lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same"),
                        f"block_conv_f32{tsuf}{suffix}", path_launches)
                    err = max_rel_err_f64(maps, idx, want_main)
                    del maps
                    main_path(f"fft_conv at JAX's plan, {body}, {tier}, bf16 maps",
                              lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same",
                                                  out_dtype="bfloat16"),
                              f"block_conv_f32_bf16maps{tsuf}{suffix}", path_launches)
                    _, pos = main_path(
                        f"detect_peaks at JAX's plan, {body}, {tier}",
                        lambda: detect_peaks(det_image, det_bank, mode="same",
                                             correlation=True),
                        f"block_conv_peaks_f32{tsuf}{suffix}", path_launches)
                print(f"fft_conv at JAX's plan, {body}, {tier}: vs float64 on maps {idx} "
                      f"{err:.3e} (bar {tol:g}); detect_peaks finds the {n} plants "
                      f"{torch.equal(pos.cpu(), centres)}")
                if err > tol or not torch.equal(pos.cpu(), centres):
                    raise AssertionError(f"the {body} main path at {tier} fails its checks")
            maps = main_path(f"fft_conv at JAX's plan, {body}, bf16 tier",
                             lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same",
                                                 store_dtype="bfloat16"),
                             f"block_conv_bf16_io{suffix}", path_launches)
            err = max_rel_err_f64(maps, idx, want_main)
            del maps
            main_path(f"fft_conv at JAX's plan, {body}, bf16 tier, bf16 maps",
                      lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same",
                                          store_dtype="bfloat16", out_dtype="bfloat16"),
                      f"block_conv_bf16_bf16maps_io{suffix}", path_launches)
            peaks_mode = f"block_conv_peaks_bf16_io{suffix}"
            if body == "v4":  # JAX's auto-v4 is float32-only for the peaks head
                fn = lambda: bc.block_conv_peaks(*ops16, *geom, radix_h=True)  # noqa: E731
            else:
                fn = lambda: detect_peaks(det_image, det_bank, mode="same",  # noqa: E731
                                          correlation=True, store_dtype="bfloat16")
            out = main_path(f"peaks at JAX's plan, {body}, bf16 tier", fn, peaks_mode,
                            path_launches)
            found = body == "v4" or torch.equal(out[1].cpu(), centres)
            print(f"bf16 tier at JAX's plan, {body}: vs float64 {err:.3e} (bar {BF16_TOL:g}); "
                  f"plants found {found}")
            if err > BF16_TOL or not found:
                raise AssertionError(f"the {body} main path at the bf16 tier fails its checks")
        # the rows at JAX's plan: launches from the runs above
        for tag, splits, _, _ in RADIX_TIERS:
            planes = ops if tag == "f32" else ops16
            tsuf = bc.TIER_SUFFIX[splits]
            flags = RADIX_FLAGS[body]
            label = "JAX F=1 plan"
            ops_level = tag == "bf16" and (splits == 3 or body == "v4")
            for out_dtype, msuf in ((torch.float32, ""), (torch.bfloat16, "_bf16maps")):
                mode = f"block_conv_{tag}{msuf}{tsuf}{suffix}"
                if tag == "bf16" and splits == 3:
                    before = path_launches[mode]
                    main_path(f"{label}, ops-level call, splits=3 ({mode})",
                              lambda: bc.block_conv(*planes, *geom, out_dtype, 3, **flags),
                              mode, path_launches)
                    row_launches[mode] = path_launches[mode] - before
                rows[mode] = kernel_row(planes, geom, label, splits, out_dtype, flags)
            mode = f"block_conv_peaks_{tag}{tsuf}{suffix}"
            if tag == "bf16" and splits == 3:
                before = path_launches[mode]
                main_path(f"{label}, ops-level call, splits=3 ({mode})",
                          lambda: bc.block_conv_peaks(*planes, *geom, 3, **flags),
                          mode, path_launches)
                row_launches[mode] = path_launches[mode] - before
            rows[mode] = peaks_row(planes, geom, label, splits, flags)
            if ops_level:
                why = "splits=3" if splits == 3 else "radix_h=True"
                OPS_LEVEL_ROWS[mode] = f"ops-level call, {why}"
                if splits == 3:
                    for m in (f"block_conv_bf16{suffix}", f"block_conv_bf16_bf16maps{suffix}"):
                        OPS_LEVEL_ROWS[m] = "ops-level call, splits=3"
            torch.cuda.empty_cache()
        # the Karatsuba entries' rows at JAX's plan: no route passes
        # karatsuba, so each is launched once by an ops-level call, then
        # checked and timed (kernel_row, peaks_row)
        kflags = dict(RADIX_FLAGS[body], karatsuba=True)
        ksuffix = bc.body_suffix(body, True)
        for tag, splits, _, _ in RADIX_TIERS:
            planes = ops if tag == "f32" else ops16
            tsuf = bc.TIER_SUFFIX[splits]
            for out_dtype, msuf in ((torch.float32, ""), (torch.bfloat16, "_bf16maps"),
                                    ("peaks", "")):
                peaks = out_dtype == "peaks"
                mode = (f"block_conv_peaks_{tag}{tsuf}{ksuffix}" if peaks
                        else f"block_conv_{tag}{msuf}{tsuf}{ksuffix}")
                fn = ((lambda: bc.block_conv_peaks(*planes, *geom, splits, **kflags)) if peaks
                      else (lambda: bc.block_conv(*planes, *geom, out_dtype, splits, **kflags)))
                before = path_launches[mode]
                main_path(f"JAX F=1 plan, ops-level call, karatsuba=True ({mode})", fn, mode,
                          path_launches)
                row_launches[mode] = path_launches[mode] - before
                OPS_LEVEL_ROWS[mode] = "ops-level call, karatsuba=True"
                rows[mode] = (peaks_row(planes, geom, "JAX F=1 plan", splits, kflags) if peaks
                              else kernel_row(planes, geom, "JAX F=1 plan", splits, out_dtype,
                                              kflags))
            torch.cuda.empty_cache()
        # the maps entry in either form at JAX's plan in turns (4-product /
        # Karatsuba / Karatsuba / 4-product), 3xTF32 and BF16IO
        for planes, splits in ((ops, 3), (ops16, bc.BF16IO)):
            def form(kara, planes=planes, splits=splits):
                return lambda: bc.block_conv(*planes, *geom, torch.float32, splits,
                                             karatsuba=kara, **RADIX_FLAGS[body])

            four, kara = form(False), form(True)
            turns = [cuda_ms(four), cuda_ms(kara), cuda_ms(kara), cuda_ms(four)]
            tier = bc.tier_name(splits)
            times[f"JAX F=1 plan maps kernel {body} {tier}, 4-product / karatsuba (ms)"] = (
                (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2)
            print(f"JAX F=1 plan maps kernel {body} {tier} in turns, 4-product / Karatsuba / "
                  f"Karatsuba / 4-product: {turns[0]:.3f} / {turns[1]:.3f} / {turns[2]:.3f} / "
                  f"{turns[3]:.3f} ms ({(turns[1] + turns[2]) / (turns[0] + turns[3]):.3f}x; "
                  f"{card()})")

    # the headline at the v5 plan against the analytic plan, in turns
    def headline():
        return fc.fft_conv(image_d, kernels=bank_d, mode="same")

    analytic = cuda_ms(headline)
    with radix_registries():
        register_radix_plan(fc, plan, "v5")
        maps = main_path("headline fft_conv at JAX's v5 plan", headline,
                         "block_conv_f32_r5", path_launches)
        err = max_rel_err_f64(maps, idx, want_main)
        del maps
        v5_ms = [cuda_ms(headline), cuda_ms(headline)]
    analytic2 = cuda_ms(headline)
    times["headline fft_conv, analytic plan (ms)"] = (analytic + analytic2) / 2
    times["headline fft_conv, JAX's v5 plan (ms)"] = sum(v5_ms) / 2
    print(f"headline fft_conv, analytic plan (127, 447) / JAX's v5 plan {geom[:4]}, in turns: "
          f"{analytic:.3f} / {v5_ms[0]:.3f} / {v5_ms[1]:.3f} / {analytic2:.3f} ms; the v5 "
          f"maps vs float64 on maps {idx} {err:.3e} ({card()})")
    if err > TOL:
        raise AssertionError(f"the headline at the v5 plan: {err} from float64")
    if choose_block_plan(s, s, k, k)[:2] != (127, 447):
        raise AssertionError("the tuner's table was not restored")
    times["step 36 (host s)"] = time.perf_counter() - t0
    print(f"radix phase: {times['step 36 (host s)']:.1f} s (host clock)")


# ---- step 37: the other H-stage forms: Karatsuba (v3, maps and peaks), v2 ----
# The flags of each form's entries (ops/block_conv.py body_suffix), and the
# JAX code each replaces (cuda_fft_convolution_tpu/ops/block_conv.py: v3's
# Karatsuba form, the v2 body and its Karatsuba form, the peaks kernel's
# Karatsuba form) in the C file that holds it.
FORMS = {"_k": dict(karatsuba=True), "_v2": dict(wstack=False),
         "_v2_k": dict(wstack=False, karatsuba=True)}
FORM_REPLACES = {("block_conv", "_k"): 153, ("block_conv", "_v2"): 269,
                 ("block_conv", "_v2_k"): 290, ("block_conv_peaks", "_k"): 1737}
FORM_SOURCES = {("block_conv", "_k"): "block_conv_k.cu", ("block_conv", "_v2"): "block_conv.cu",
                ("block_conv", "_v2_k"): "block_conv_k.cu",
                ("block_conv_peaks", "_k"): "block_conv_peaks_k.cu"}
# (spectra, tier, bar against the plain version)
FORM_TIERS = (("f32", 3, TOL), ("f32", 6, TOL), ("f32", 1, X1_TOL), ("bf16", 0, IO_TOL),
              ("bf16", 3, TOL))


def form_fits(ops, geom, splits, flags) -> bool:
    """Whether a form's kernels take ``geom`` at tier ``splits``
    (``form_taken``: its shared memory fits)."""
    from cuda_fft_convolution_torch.ops.block_conv import form_taken

    return form_taken(ops[0].shape[-1], geom[0] - geom[2] + 1, splits, **flags)


def form_x6(ops, geom, flags) -> float:
    """A form's 6xTF32 maps against its plain version run in float64."""
    import torch

    from cuda_fft_convolution_torch.ops.block_conv import block_conv, block_conv_reference

    return rel_err(block_conv(*ops, *geom, torch.float32, 6, **flags).double(),
                   block_conv_reference(*(x.double() for x in ops), *geom, torch.float64,
                                        **flags))


def form_x6_check(d_re, d_im, k_re, k_im, geom, label) -> None:
    """Each Karatsuba and v2 form's 6xTF32 entry against its plain version
    in float64 (X6_TOL) on random planes (step 37), where step 34 holds
    v3's; a form the kernels do not take is skipped."""
    ops = (d_re, d_im, k_re, k_im)
    for suffix, flags in FORMS.items():
        if not form_fits(ops, geom, 6, flags):
            continue
        x6 = form_x6(ops, geom, flags)
        print(f"forms [{label}] {suffix} 6xTF32 vs its plain version in float64: {x6:.3e} "
              f"(bar {X6_TOL:g})")
        if x6 > X6_TOL:
            raise AssertionError(f"{label} {suffix}: 6xTF32 {x6} from the float64 plain version")


def form_checks(ops, ops16, geom, label, idx, want, plain=True, x6_bar=False) -> None:
    """Every Karatsuba and v2 entry at ``geom`` (step 37): maps (f32, bf16
    maps) and the Karatsuba peaks at every tier against the plain version
    with the same flags (``check_kernel``, ``check_peaks``: the smoke's
    bars; not with ``plain=False``, where the entries' rows check them),
    the f32 maps at the fp32 tiers against float64 on maps ``idx``
    (``want``), 6xTF32 against the plain version run in float64 beside
    v3's 4-product entry (held to X6_TOL with ``x6_bar``, else a reading);
    where the kernels do not take a form, the call must raise and launch
    nothing."""
    import torch

    from cuda_fft_convolution_torch.ops.block_conv import block_conv
    from cuda_fft_convolution_torch.utils.errors import InvalidInputError

    v3_x6 = form_x6(ops, geom, {})
    print(f"forms [{label}] v3 (4-product) 6xTF32 vs its plain version in float64: "
          f"{v3_x6:.3e}")

    for suffix, flags in FORMS.items():
        for tag, splits, tol in FORM_TIERS:
            planes = ops if tag == "f32" else ops16
            tier = tier_label(planes[0], splits)
            if not form_fits(planes, geom, splits, flags):
                before = block_conv.launches
                try:
                    block_conv(*planes, *geom, torch.float32, splits, **flags)
                except InvalidInputError as e:
                    print(f"forms [{label}] {suffix} {tier}: refused, {e}")
                else:
                    raise AssertionError(f"{label} {suffix} {tier}: ran where no kernel takes it")
                if block_conv.launches != before:
                    raise AssertionError(f"{label} {suffix} {tier}: a refused call launched")
                continue
            if plain:
                check_kernel(*planes, geom, label, torch.float32, tol, splits, flags)
                check_kernel(*planes, geom, label, torch.bfloat16, max(tol, BF16_OUT_TOL), splits,
                             flags)
                if suffix == "_k":
                    check_peaks(*planes, geom, label, tol, splits, {"radix_h": False, **flags})
            if tag == "f32":
                maps = block_conv(*planes, *geom, torch.float32, splits, **flags)[0]
                err = max_rel_err_f64(maps, idx, want)
                del maps
                bar = X1_TOL if splits == 1 else TOL
                print(f"forms [{label}] {suffix} {tier} maps vs float64 on maps {idx}: {err:.3e} "
                      f"(bar {bar:g})")
                if err > bar:
                    raise AssertionError(f"{label} {suffix} {tier}: {err} from float64")
            if tag == "f32" and splits == 6:
                x6 = form_x6(ops, geom, flags)
                print(f"forms [{label}] {suffix} 6xTF32 vs its plain version in float64: "
                      f"{x6:.3e} ({x6 / v3_x6:.2f}x v3's{f'; bar {X6_TOL:g}' if x6_bar else ''})")
                if x6_bar and x6 > X6_TOL:
                    raise AssertionError(f"{label} {suffix}: 6xTF32 {x6} from the float64 plain "
                                         f"version")
            torch.cuda.empty_cache()


def forms_table(ops, ops16, geom, label, table) -> None:
    """Kernel ms of each form beside v3's 4-product form at ``geom`` (f32
    maps at every tier of ``FORM_TIERS``: 3xTF32, 6xTF32 and one pass on
    f32 spectra, BF16IO and 3xTF32 on bf16) → ``table`` lines (label, tier,
    form, ms, bound ms, bound by); a form the kernels do not take is left
    out."""
    import torch

    from cuda_fft_convolution_torch.ops.block_conv import block_conv

    out_bytes = 4 * ops[0].shape[0] * ops[2].shape[0] * geom[4] * geom[5]
    for tag, tier, _ in FORM_TIERS:
        planes = ops if tag == "f32" else ops16
        for suffix, flags in {"": {}, **FORMS}.items():
            if not form_fits(planes, geom, tier, flags):
                continue
            kara = flags.get("karatsuba", False)
            bound_ms, by = block_conv_bound(planes, geom, out_bytes, tier, radix_body(flags), kara)
            ms = cuda_ms(lambda: block_conv(*planes, *geom, torch.float32, tier, **flags))
            table.append((label, tier_label(planes[0], tier), suffix or "v3", ms, bound_ms, by))
        torch.cuda.empty_cache()


def forms_phase(fc, seed, image, image_d, bank_d, idx, want, big, path_launches, times, rows,
                row_launches) -> None:
    """The Karatsuba H stage and the v2 body (module docstring, step 37).
    ``big``: step 33's large-kernel (bank on the card, kernels checked,
    their float64 maps)."""
    import torch

    from cuda_fft_convolution_torch.ops import block_conv as bc

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    table = []
    check_random_geometries(np.random.default_rng(seed + 37), (*CHECK_GEOMETRIES,
                                                                 *PLAN_GEOMETRIES), form_x6_check)

    def plan_ops(data, bank, k, block):
        spec = fc.fft_data_tiled(data, k, k, block_h=block[0], block_w=block[1],
                                 trim_mode="same")
        sk = fc.fft_kernels(bank, spectral=spec)
        geom = (spec.block_h, spec.block_w, spec.max_kh, spec.max_kw, spec.out_h, spec.out_w)
        ops = (spec.re[None], spec.im[None], sk.re, sk.im)
        return ops, tuple(x.to(bf16) for x in ops), geom

    def mbh_line(label, ops, geom):
        wc, vh, nbh = ops[0].shape[-1], geom[0] - geom[2] + 1, ops[0].shape[1]
        got = {(bc.tier_name(t), kara): (*bc.kernel_layout("v2", wc, vh, t, kara),
                                          min(bc.v2_blocks(wc, vh, t, kara), nbh))
               for t in (3, 6, 1, bc.BF16IO) for kara in (False, True)}
        print(f"v2 at the {label} {geom[:4]} (Vh {vh}, Wc {wc}, {nbh} block rows): (rows, pair "
              f"bins, MBH: v3's configuration of the same form) by (tier, karatsuba) "
              f"{got}")
        return max(m[2] for m in got.values())

    # the headline plan, N=100: every entry checked and timed (its JSON row,
    # launched once by an ops-level call); the 4-product and Karatsuba maps
    # entries in turns
    k = HEADLINE["k"]
    ops, ops16, geom = plan_ops(image_d, bank_d, k, (127, 447))
    label = f"headline plan, N={HEADLINE['n']}"
    mbh = {"headline": mbh_line("headline plan", ops, geom)}
    form_checks(ops, ops16, geom, label, idx, want, plain=False, x6_bar=True)
    for suffix, flags in FORMS.items():
        why = ", ".join(f"{key}={val}" for key, val in flags.items())
        for tag, splits, _ in FORM_TIERS:
            planes = ops if tag == "f32" else ops16
            tsuf = bc.TIER_SUFFIX[splits]
            heads = [(torch.float32, ""), (bf16, "_bf16maps")] + ([("peaks", "")]
                                                                  if suffix == "_k" else [])
            for out_dtype, msuf in heads:
                peaks = out_dtype == "peaks"
                mode = (f"block_conv_peaks_{tag}{tsuf}{suffix}" if peaks
                        else f"block_conv_{tag}{msuf}{tsuf}{suffix}")
                pflags = {"radix_h": False, **flags}
                fn = ((lambda: bc.block_conv_peaks(*planes, *geom, splits, **pflags)) if peaks
                      else (lambda: bc.block_conv(*planes, *geom, out_dtype, splits, **flags)))
                before = path_launches[mode]
                main_path(f"{label}, ops-level call, {why} ({mode})", fn, mode, path_launches)
                row_launches[mode] = path_launches[mode] - before
                OPS_LEVEL_ROWS[mode] = f"ops-level call, {why}"
                rows[mode] = (peaks_row(planes, geom, label, splits, pflags) if peaks
                              else kernel_row(planes, geom, label, splits, out_dtype, flags))
            torch.cuda.empty_cache()
    four, kara = (lambda: bc.block_conv(*ops, *geom)), (
        lambda: bc.block_conv(*ops, *geom, karatsuba=True))
    turns = [cuda_ms(four), cuda_ms(kara), cuda_ms(kara), cuda_ms(four)]
    times["headline maps kernel, 4-product / karatsuba (ms)"] = (
        (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2)
    print(f"headline plan maps kernel in turns, 4-product / Karatsuba / Karatsuba / 4-product: "
          f"{turns[0]:.3f} / {turns[1]:.3f} / {turns[2]:.3f} / {turns[3]:.3f} ms "
          f"({(turns[1] + turns[2]) / (turns[0] + turns[3]):.3f}x; {card()})")
    forms_table(ops, ops16, geom, "headline plan", table)
    del ops, ops16
    torch.cuda.empty_cache()

    # JAX's F=1 plan (256, 512, 65, 129) on the headline image and bank:
    # v2 at one block a CTA in v3's configurations (64 rows, and the pair
    # at 6xTF32), every entry checked, maps against float64
    ops, ops16, geom = radix_geometry(fc, RADIX_PLANS[0], image_d, bank_d)
    label = f"JAX F=1 plan, N={HEADLINE['n']}"
    mbh["JAX F=1"] = mbh_line("JAX F=1 plan", ops, geom)
    form_checks(ops, ops16, geom, label, idx, want)
    forms_table(ops, ops16, geom, "JAX F=1 plan", table)
    del ops, ops16
    torch.cuda.empty_cache()

    # the DPM plan (float32 HOG features; bf16 spectra the same planes
    # rounded), the 512² plan and the F=8 plan: every entry checked, maps
    # against float64, each form timed beside v3
    feats, dbank, _ = dpm_inputs(seed, "float32")
    didx = list(range(0, DPM["n"], DPM["n"] // 8))[:8]
    dwant = dpm_reference_f64(feats.cpu().numpy().astype(np.float64), dbank.cpu().numpy(), didx)
    ops, ops16, geom = plan_ops(feats, dbank, DPM["k"], (27, 139))
    label = f"DPM plan, N={DPM['n']}"
    mbh["DPM"] = mbh_line("DPM plan", ops, geom)
    form_checks(ops, ops16, geom, label, didx, dwant)
    forms_table(ops, ops16, geom, "DPM plan", table)
    del ops, ops16, feats, dbank
    torch.cuda.empty_cache()

    big_bank_d, big_idx, big_want = big
    ops, ops16, geom = plan_ops(image_d, big_bank_d, BIGKERNEL["k"], BIGKERNEL["plan"][:2])
    label = f"large-kernel plan, N={BIGKERNEL['n']}"
    mbh["512²"] = mbh_line("large-kernel plan", ops, geom)
    form_checks(ops, ops16, geom, label, big_idx, big_want)
    forms_table(ops, ops16, geom, "large-kernel plan", table)
    del ops, ops16
    torch.cuda.empty_cache()

    size8, f8, n8, k8 = (F8_TIER[x] for x in ("size", "f", "n", "k"))
    rng = np.random.default_rng(seed)
    data8 = rng.standard_normal((size8, size8, f8)).astype(np.float32)
    bank8 = rng.standard_normal((n8, k8, k8, f8)).astype(np.float32)
    idx8 = list(range(0, n8, n8 // 8))[:8]
    want8 = dpm_reference_f64(data8.astype(np.float64), bank8, idx8)
    ops, ops16, geom = plan_ops(torch.as_tensor(data8, device="cuda"),
                                torch.as_tensor(bank8, device="cuda"), k8, F8_TIER["plan"][:2])
    label = f"F=8 tier plan, N={n8}"
    mbh["F=8"] = mbh_line("F=8 tier plan", ops, geom)
    form_checks(ops, ops16, geom, label, idx8, want8)
    forms_table(ops, ops16, geom, "F=8 tier plan", table)
    del ops, ops16
    torch.cuda.empty_cache()

    print(f"the H-stage forms, maps kernel ms beside v3's 4-product form ({card()}):")
    v3_ms = {(lab, tier): ms for lab, tier, form, ms, _, _ in table if form == "v3"}
    for lab, tier, form, ms, bound_ms, by in table:
        print(f"  {lab} {tier} {form}: {ms:.3f} ms ({ms / v3_ms[(lab, tier)]:.3f}x v3); bound "
              f"{bound_ms:.3f} ms ({by}), {100 * bound_ms / ms:.1f}%")
    print(f"v2's most blocks a CTA by plan: {mbh}")
    if max(mbh.values()) < 2:
        raise AssertionError(f"no plan runs v2 with two blocks a CTA or more: {mbh}")
    times["step 37 (host s)"] = time.perf_counter() - t0
    print(f"forms phase: {times['step 37 (host s)']:.1f} s (host clock)")


def bench_phase() -> None:
    """The port's bench at full size (module docstring, step 33): its JSON
    line printed, every row present and positive, its accuracy row within
    TOL."""
    from cuda_fft_convolution_torch import bench

    t0 = time.perf_counter()
    result = bench.main([])
    detail = result["detail"]
    bad = [r for r in bench.ROWS if not (detail[r] is not None and detail[r] > 0)]
    if bad:
        raise AssertionError(f"bench rows null or not positive: {bad}")
    if not detail["max_rel_err_vs_f64_fft"] <= TOL:
        raise AssertionError(f"bench accuracy {detail['max_rel_err_vs_f64_fft']} above {TOL}")
    print(f"bench: {len(bench.ROWS)} rows, max rel err vs float64 "
          f"{detail['max_rel_err_vs_f64_fft']:.3e}; {time.perf_counter() - t0:.1f} s "
          f"(host clock; {card()})")


def cuda_ms(fn, runs=RUNS, reps=1) -> float:
    """Median milliseconds of ``fn()`` between CUDA events, after a warm-up;
    each of the ``runs`` windows holds ``reps`` calls back to back (their
    mean), so that the host's time between launches does not show."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


SOURCES = {
    "block_conv": ("cuda_fft_convolution_torch/csrc/block_conv.cu",
                   "cuda_fft_convolution_tpu/ops/block_conv.py:618"),
    "block_conv_peaks": ("cuda_fft_convolution_torch/csrc/block_conv_peaks.cu",
                         "cuda_fft_convolution_tpu/ops/block_conv.py:1833"),
    "spectral_mac": ("cuda_fft_convolution_torch/csrc/spectral_mac.cu",
                     "cuda_fft_convolution_tpu/ops/spectral_mac.py:206"),
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ab-parent", type=pathlib.Path, default=None,
                        help="a parent checkout's cuda_fft_convolution_torch/csrc: time its "
                             "MAC kernel against this tree's at every MAC row, and its fused "
                             "kernels' 32-row entries against the pairs that replaced them")
    args = parser.parse_args(argv)
    started = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import cuda_fft_convolution_torch as fc
    from cuda_fft_convolution_torch.models import detect_peaks
    from cuda_fft_convolution_torch.ops.block_conv import (
        block_conv,
        block_conv_peaks,
        block_conv_peaks_reference,
        block_conv_reference,
    )
    from cuda_fft_convolution_torch.ops.spectral_mac import (
        spectral_mac,
        spectral_mac_planes,
    )
    from cuda_fft_convolution_torch.ops.tiled import peaks_from_maps

    env_report()
    build_kernels()
    if args.ab_parent is not None:
        build_parent_mac(args.ab_parent.resolve())
        wide_ab(args.ab_parent.resolve(), args.seed)
    rng = np.random.default_rng(args.seed)
    check_kernel_shapes(fc, rng)
    # kernel mode → launches in the main-path runs, and its JSON fields
    path_launches = collections.Counter()
    rows = {}
    bf16 = torch.bfloat16

    # ---- the headline call ----
    s, n, k = HEADLINE["size"], HEADLINE["n"], HEADLINE["k"]
    image = rng.standard_normal((s, s, 1)).astype(np.float32)
    bank = rng.standard_normal((n, k, k, 1)).astype(np.float32)
    maps = main_path(
        "headline fft_conv",
        lambda: fc.fft_conv(image, kernels=bank, mode="same", device="cuda"),
        "block_conv_f32", path_launches,
    )
    print(f"headline fft_conv: shape {tuple(maps.shape)} on {maps.device}")
    if not (maps.is_cuda and tuple(maps.shape) == (n, s, s)):
        raise AssertionError(f"headline maps: {maps.device} {tuple(maps.shape)}")
    if not torch.isfinite(maps).all():
        raise AssertionError("headline maps are not finite")
    idx = list(range(0, n, n // 8))[:8]
    want = same_reference_f64(image, bank, idx)
    err = max_rel_err_f64(maps, idx, want)
    print(f"headline vs float64 numpy on kernels {idx}: max rel err {err:.3e}")
    if err > TOL:
        raise AssertionError(f"headline error {err} above {TOL}")

    spec = fc.fft_data_tiled(image, k, k, device="cuda", trim_mode="same")
    sk = fc.fft_kernels(bank, spectral=spec)
    amortized = fc.conv_spectral(spec, sk, mode="same")
    torch.cuda.synchronize()
    diff = rel_err(amortized, maps)
    print(f"amortized path vs one-shot: rel diff {diff:.3e}")
    if diff > 1e-6:
        raise AssertionError(f"amortized maps differ from the one-shot call: {diff}")
    del maps, amortized
    torch.cuda.empty_cache()

    # ---- times ----
    image_d = torch.as_tensor(image, device="cuda")
    bank_d = torch.as_tensor(bank, device="cuda")
    fused_ms = cuda_ms(lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same"))
    unfused_shapes = collections.Counter()
    fc.set_config(use_fused_block_conv=False)
    try:
        main_path("headline fft_conv, unfused",
                  lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same"),
                  "spectral_mac_f32", path_launches, unfused_shapes)
        unfused_ms = cuda_ms(lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same"))
    finally:
        fc.set_config(use_fused_block_conv=None)
    print(f"headline fft_conv, fused: {fused_ms:.3f} ms")
    print(f"headline fft_conv, unfused torch.fft pipeline: {unfused_ms:.3f} ms")

    geom = (spec.block_h, spec.block_w, spec.max_kh, spec.max_kw, spec.out_h, spec.out_w)
    ops = (spec.re[None], spec.im[None], sk.re, sk.im)
    abs_err = check_kernel(*ops, geom, f"headline plan, N={n}")
    kernel_ms = cuda_ms(lambda: block_conv(*ops, *geom))
    plain_ms = cuda_ms(lambda: block_conv_reference(*ops, *geom))
    maps_elems = n * spec.out_h * spec.out_w
    rows["block_conv_f32"] = (abs_err, kernel_ms, plain_ms,
                              *block_conv_bound(ops, geom, 4 * maps_elems), None)
    cells = spec.re.shape[0] * spec.re.shape[1] * n
    print(f"kernel alone at the headline plan: {kernel_ms:.3f} ms "
          f"({cells} cells); plain version: {plain_ms:.3f} ms; bound "
          f"{rows['block_conv_f32'][3]:.3f} ms ({rows['block_conv_f32'][4]})")
    flop = cells * synthesis_flop(spec.block_h, spec.block_w // 2 + 1,
                                  spec.block_h - spec.max_kh + 1, spec.block_w - spec.max_kw + 1)
    print(f"kernel synthesis rate: {flop / kernel_ms / 1e9:.2f} TFLOP/s useful "
          f"({flop / 1e12:.3f} TFLOP, 4-mult complex H stage), "
          f"{3 * flop / kernel_ms / 1e9:.2f} TFLOP/s on the tensor cores as 3xTF32; "
          f"{100 * rows['block_conv_f32'][3] / kernel_ms:.1f}% of the bound")
    # bf16 maps at the headline plan, N=100 (bf16 spectra: step 35)
    label = f"headline plan, N={n}"
    rows["block_conv_f32_bf16maps"] = (
        check_kernel(*ops, geom, label, bf16, BF16_OUT_TOL),
        cuda_ms(lambda: block_conv(*ops, *geom, bf16)),
        cuda_ms(lambda: block_conv_reference(*ops, *geom, bf16)),
        *block_conv_bound(ops, geom, 2 * maps_elems), None,
    )
    print(f"block_conv_f32_bf16maps alone at the headline plan: "
          f"{rows['block_conv_f32_bf16maps'][1]:.3f} ms; plain version: "
          f"{rows['block_conv_f32_bf16maps'][2]:.3f} ms")
    # the unfused pipeline's MAC: every block of the image (B) against the bank
    uops = tuple(x.reshape(-1, *x.shape[-3:]) for x in (spec.re, spec.im)) + (sk.re, sk.im)
    rows["spectral_mac_f32:unfused_headline"] = mac_row(uops, "unfused headline")
    row_launches = {"spectral_mac_f32:unfused_headline": unfused_shapes[mac_shape(uops)]}
    if list(unfused_shapes) != [mac_shape(uops)]:
        raise AssertionError(f"unfused headline: MAC launches by shape {dict(unfused_shapes)}, "
                             f"not at {mac_shape(uops)}")
    del spec, sk, ops, uops
    torch.cuda.empty_cache()

    # ---- the headline at the bf16 tier ----
    tier_ms = tier_headline(fc, image_d, bank_d, idx, want, path_launches)

    # ---- the detection headline, at float32 and at the tier ----
    det_image, det_bank, det_launches = detection_headline(fc, args.seed)
    path_launches.update(det_launches)
    vals16, pos16 = main_path(
        "detection headline at the tier",
        lambda: detect_peaks(det_image, det_bank, mode="same", correlation=True,
                             store_dtype="bfloat16"),
        "block_conv_peaks_bf16_io", path_launches,
    )
    if not (vals16.dtype == torch.float32 and torch.equal(pos16.cpu(), detection_centres())):
        bad = int((pos16.cpu() != detection_centres()).any(-1).sum())
        raise AssertionError(f"detect_peaks at the tier missed {bad} of the {n} planted centres")
    print(f"detect_peaks at the tier: all {n} planted centres found")

    # ---- the direct engine through the MAC kernel ----
    direct = main_path(
        "direct fft_conv",
        lambda: fc.fft_conv(image_d, kernels=bank_d, mode="same", algorithm="direct"),
        "spectral_mac_f32", path_launches,
    )
    if not (tuple(direct.shape) == (n, s, s) and torch.isfinite(direct).all()):
        raise AssertionError("direct maps malformed")
    err = max_rel_err_f64(direct, idx, want)
    print(f"direct fft_conv vs float64 numpy on kernels {idx}: max rel err {err:.3e}")
    if err > TOL:
        raise AssertionError(f"direct error {err} above {TOL}")
    del direct
    dspec = fc.fft_data(image_d, k, k)
    dsk = fc.fft_kernels(bank_d, spectral=dspec)
    mac_ops = (dspec.re[None], dspec.im[None], dsk.re, dsk.im)
    mac_abs = check_mac(mac_ops)
    mac16_ops = tuple(x.to(bf16) for x in mac_ops)
    mac16_abs = check_mac(mac16_ops, MAC_BF16_TOL)
    # F=3: the same pixels, three channels of random spectra
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    h, wc = dspec.re.shape[-2:]
    mac3_ops = tuple(torch.randn((m, 3, h, wc), generator=gen, device="cuda")
                     for m in (1, 1, n, n))
    check_mac(mac3_ops)
    check_mac(tuple(x.to(bf16) for x in mac3_ops), MAC_BF16_TOL)
    check_mac_tiles(gen)
    del dspec, dsk
    torch.cuda.empty_cache()

    # ---- times of the detection and MAC paths ----
    detect_ms = cuda_ms(lambda: detect_peaks(det_image, det_bank))
    detect16_ms = cuda_ms(lambda: detect_peaks(det_image, det_bank, store_dtype="bfloat16"))
    maps_path_ms = cuda_ms(lambda: peaks_from_maps(
        fc.fft_conv(det_image, kernels=det_bank, mode="same", correlation=True)[None]))
    print(f"detect_peaks call: {detect_ms:.3f} ms; at the bf16 tier: {detect16_ms:.3f} ms; "
          f"maps path (fft_conv + peaks_from_maps): {maps_path_ms:.3f} ms")
    dspec_t = fc.fft_data_tiled(det_image, k, k, trim_mode="same")
    dsk_t = fc.fft_kernels(det_bank, spectral=dspec_t, correlation=True)
    geom = (dspec_t.block_h, dspec_t.block_w, dspec_t.max_kh, dspec_t.max_kw,
            dspec_t.out_h, dspec_t.out_w)
    pops = (dspec_t.re[None], dspec_t.im[None], dsk_t.re, dsk_t.im)
    peaks_err = check_peaks(*pops, geom, f"headline plan, N={n}")
    peaks_ms = cuda_ms(lambda: block_conv_peaks(*pops, *geom))
    peaks_plain_ms = cuda_ms(lambda: block_conv_peaks_reference(*pops, *geom))
    rows["block_conv_peaks_f32"] = (peaks_err, peaks_ms, peaks_plain_ms,
                                    *block_conv_bound(pops, geom, 8 * pops[0].shape[1]
                                                      * pops[0].shape[2] * n), None)
    print(f"peaks kernel alone at the headline plan: {peaks_ms:.3f} ms; plain version: "
          f"{peaks_plain_ms:.3f} ms (bf16 spectra: step 35)")
    del dspec_t, dsk_t, pops
    torch.cuda.empty_cache()
    direct_ms = tier_ms["direct, f32"]
    print(f"direct fft_conv (MAC kernel): {direct_ms:.3f} ms")
    mac_ms = cuda_ms(lambda: spectral_mac(*mac_ops), reps=AB_REPS)
    einsum_ms = cuda_ms(lambda: spectral_mac_planes(*mac_ops))
    rows["spectral_mac_f32"] = (mac_abs, mac_ms, einsum_ms, *mac_bound(mac_ops),
                                complex_einsum_ms(mac_ops)[0])
    print(f"MAC kernel alone at the direct shape, F=1: {mac_ms:.3f} ms; "
          f"einsum: {einsum_ms:.3f} ms; one complex einsum: {rows['spectral_mac_f32'][5]:.3f} ms")
    rows["spectral_mac_bf16"] = (mac16_abs,
                                 cuda_ms(lambda: spectral_mac(*mac16_ops), reps=AB_REPS),
                                 cuda_ms(lambda: spectral_mac_planes(*mac16_ops)),
                                 *mac_bound(mac16_ops), complex_einsum_ms(mac16_ops)[0])
    print(f"MAC kernel alone at the direct shape, F=1, bf16 planes: "
          f"{rows['spectral_mac_bf16'][1]:.3f} ms; einsum: {rows['spectral_mac_bf16'][2]:.3f} ms")
    mac3_ms = cuda_ms(lambda: spectral_mac(*mac3_ops))
    einsum3_ms = cuda_ms(lambda: spectral_mac_planes(*mac3_ops))
    bound3_ms, bound3_by = mac_bound(mac3_ops)
    print(f"MAC kernel alone at the direct shape, F=3: {mac3_ms:.3f} ms; "
          f"einsum: {einsum3_ms:.3f} ms; one complex einsum: "
          f"{complex_einsum_ms(mac3_ops)[0]:.3f} ms; bound {bound3_ms:.3f} ms ({bound3_by})")
    for label, ops in (("direct shape F=1", mac_ops), ("direct shape F=1 bf16", mac16_ops),
                       ("direct shape F=3", mac3_ops), ("direct shape F=3 bf16",
                                                         tuple(x.to(bf16) for x in mac3_ops))):
        mac_tiles_and_ab(label, ops)
    # the split form's range: one image, one filter, 3 to 98 CTAs of the
    # (1, 1) tile (under the card's 132 SMs), few to many channels: every
    # form timed, the rule's marked
    for hw, f in itertools.product(SPLIT_RANGE_HW, SPLIT_RANGE_F):
        ops = tuple(torch.randn((1, f, *hw), generator=gen, device="cuda") for _ in range(4))
        mac_tiles_and_ab(f"split range, F={f}, S={hw[0] * hw[1]}", ops)
    del mac_ops, mac16_ops, mac3_ops, ops, det_image, det_bank
    torch.cuda.empty_cache()

    # ---- the DPM/HOG detector path at full width ----
    dpm_ms, dpm_kernels = dpm_path(fc, args.seed, path_launches)
    rows.update(dpm_kernels)
    phase_peak("headline, detection and DPM/HOG phases")

    # ---- the rest of the API at full width ----
    api_ms = {}
    planner_table()
    clamp_centered_phases(fc, image, bank, image_d, bank_d, path_launches, api_ms)
    ragged_phase(fc, args.seed, path_launches, api_ms)
    dpm_direct_phase(fc, args.seed, path_launches, api_ms)
    pipelined_phase(fc, args.seed, bank, bank_d, path_launches, api_ms)
    phase_peak("pipelined batch, timing")

    # ---- the serving runtime at full width ----
    det_bank, det_bank_d = plan_phase(fc, image, bank, image_d, bank_d, idx, want, args.seed,
                                      path_launches, api_ms)
    headline_stream_phase(fc, args.seed, bank_d, path_launches, api_ms)
    detection_stream_phase(fc, args.seed, det_bank, det_bank_d, path_launches, api_ms)
    del det_bank_d
    dpm_stream_phase(fc, args.seed, path_launches, api_ms)
    ragged_stream_phase(fc, args.seed, path_launches, api_ms)
    tuner_phase(fc, image_d, bank_d, idx, want, path_launches, api_ms)

    # ---- the model layer at full width ----
    # (row_launches: the MAC shapes' rows, the unfused headline's and the
    # model layer's, and their launches)
    pyramid_phase(fc, args.seed, path_launches, api_ms, rows, row_launches)
    mosse_phase(fc, args.seed, path_launches, api_ms, rows, row_launches)
    trainer_phase(fc, args.seed, path_launches, api_ms, rows, row_launches)

    # ---- the public surface: the cores, interop, selftest, profiling, demos ----
    cores_phase(fc, args.seed, image, bank, image_d, bank_d, path_launches, api_ms)
    interop_phase(fc, image, bank_d, path_launches, api_ms)
    selftest_phase(fc)
    profiling_phase(fc, image_d, bank_d, fused_ms)
    demos_phase(api_ms)

    # ---- the parallel layer in a world of one NCCL rank ----
    parallel_phase(fc, args.seed, image_d, bank_d, path_launches, api_ms, rows, row_launches)

    # ---- step 33: the large-kernel regime, the F=8 tier, the bench ----
    t0 = time.perf_counter()
    check_random_geometries(rng, PLAN_GEOMETRIES)
    big = bigkernel_phase(fc, args.seed, image, image_d, path_launches, api_ms, rows,
                          row_launches)
    f8_tier_phase(fc, args.seed, path_launches, api_ms, rows, row_launches)
    phase_peak("large-kernel regime and F=8 tier")
    print(f"large-kernel and F=8 phases: {time.perf_counter() - t0:.1f} s (host clock)")
    bench_phase()
    phase_peak("bench")

    # ---- step 34: the precision tiers ----
    tiers_phase(fc, args.seed, rng, image_d, bank_d, idx, want, big, path_launches, api_ms,
                rows, row_launches)
    phase_peak("precision tiers")

    # ---- step 35: the bf16 tier's single pass ----
    bf16io_phase(fc, args.seed, image_d, bank_d, idx, want, big, path_launches, api_ms, rows,
                 row_launches)
    phase_peak("bf16io tier")

    # ---- step 36: the radix-2 bodies ----
    radix_phase(fc, args.seed, image, image_d, bank, bank_d, idx, want, path_launches, api_ms,
                rows, row_launches)
    phase_peak("radix bodies")

    # ---- step 37: the Karatsuba H stage and the v2 body ----
    forms_phase(fc, args.seed, image, image_d, bank_d, idx, want, big, path_launches, api_ms,
                rows, row_launches)
    del big
    phase_peak("H-stage forms")
    print(f"smoke wall time: {time.perf_counter() - started:.1f} s")
    print(f"peak memory allocated over the smoke: {max(PHASE_PEAKS) / 2**30:.2f} GiB "
          f"(limit {PEAK_LIMIT / 2**30:.0f} GiB)")
    if max(PHASE_PEAKS) >= PEAK_LIMIT:
        raise AssertionError(f"peak allocation {max(PHASE_PEAKS)} B over {PEAK_LIMIT} B")

    if AB_ROWS:
        print(f"A/B of the MAC kernel, parent / this tree, ms ({card()}):")
        for label, t in AB_ROWS.items():
            print(f"  {label}: parent {t[0]:.3f} / {t[3]:.3f}, this tree {t[1]:.3f} / "
                  f"{t[2]:.3f}: {(t[1] + t[2]) / (t[0] + t[3]):.3f}")
    kernels = []
    # A row is a kernel's C entry (its dtype mode), or "entry:shape" for a
    # MAC shape of the model layer, with its own launches.
    launches = {name: row_launches.get(name, path_launches[name]) for name in rows}
    for name, (err, ms, plain, bound_ms, bound_by, library_ms, *same_work) in rows.items():
        entry = name.split(":")[0]
        body = re.search(r"_r(4|5x|5)(_k)?$", entry)
        form = None if body else re.search(r"_(v2_k|v2|k)$", entry)
        mode = re.sub(r"_(x[16]|io)$", "", re.sub(r"(_r4|_r5x|_r5|_v2)?(_k)?$", "", entry))
        wrapper = mode.removesuffix("_bf16maps").rsplit("_", 1)[0]
        source, replaces = SOURCES[wrapper]
        if body:  # a radix body's entries (either form) and the JAX code they replace
            source = f"cuda_fft_convolution_torch/csrc/block_conv{body.group(0)}.cu"
            replaces = (f"cuda_fft_convolution_tpu/ops/block_conv.py:"
                        f"{RADIX_REPLACES[(wrapper, body.group(0))]}")
        if form:  # the Karatsuba and v2 entries and the JAX form they replace
            source = f"cuda_fft_convolution_torch/csrc/{FORM_SOURCES[(wrapper, form.group(0))]}"
            replaces = (f"cuda_fft_convolution_tpu/ops/block_conv.py:"
                        f"{FORM_REPLACES[(wrapper, form.group(0))]}")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_kind": "compute" if bound_by == "operations" else "bytes",
            "library_ms": library_ms,
            "called_by": ("ops-level call, splits=3" if name.split(":")[0] in OPS_LEVEL_MODES
                          else OPS_LEVEL_ROWS.get(name, "main path")),
        })
        if same_work:  # another body's or form's row: the bound of v3's work beside its own
            kernels[-1]["same_work_bound_ms"] = same_work[0]
    missing = [m for m in rows if launches[m] < 1]
    if missing:
        raise AssertionError(f"kernel modes the main path never launched: {missing}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
