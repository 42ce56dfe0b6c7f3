// Fused overlap-save block convolution for Hopper (sm_90a): the transform
// stages shared by the maps kernel (block_conv.cu) and the peaks kernel
// (block_conv_peaks.cu), which replace the JAX package's block_conv_pallas
// and block_conv_peaks_pallas (their v3 function). The two differ only in
// their epilogue, a template argument of the one kernel below, so they
// cannot drift apart. The spectra D and K are fp32 or bf16 (the serving
// tier, store_dtype='bfloat16'), a second template argument: a bf16 load is
// converted to fp32 in registers, and everything after it is fp32 whatever
// the spectra type.
//
// For each cell (image b, block (i, j), kernel n) the kernel computes
//
//   S    = sum_f K[n, f] * D[b, i, j, f]         complex, (Lh, Wc)
//   X    = G . S                                 G = windowed inverse DFT
//                                                along H, (Vh, Lh) complex
//   tile = Xr . Mr + Xi . Mi                     M = windowed packed inverse
//                                                DFT along W, (Wc, Vw) real
//
// and hands each thread's share of the tile to the epilogue. G and M are the
// JAX package's _inv_full_mats and _inv_packed_mats windows (ops/dft.py),
// prepared once per geometry by ops/block_conv.py _kernel_mats, exact fp32
// and zero-padded to the tiles the kernel reads: G as (Vh, Lh) (also as
// G^T (Lh, Vh), which no configuration reads since the stacked H stage
// moved to the tensor cores; the entries keep the argument), and M as the
// TF32 planes of M^T (its pieces at the tier, below), (Vw, 2 Wc) =
// [Mr ; Mi]^T, in core matrices (the K-major layout wgmma reads from
// shared memory).
//
// Precision. Every synthesis product of every configuration is a
// tensor-core product at one of
// four tiers, the template argument SPLITS, which replace the JAX kernel's
// precisions (ops/block_conv.py fused_splits). Three are split-TF32: each
// fp32
// operand x is split into TF32 pieces, hi = TF32(x), then TF32 of what is
// left (split_n), with TF32() rounding as cvt.rna.tf32.f32 does (to
// nearest, ties away from zero), and a . b runs as the products of the
// pieces whose terms are not negligible:
//   - 3xTF32 (SPLITS = 3, the default, 'bf16x3'): hi and lo, the products
//     a_lo b_hi + a_hi b_lo + a_hi b_hi (lo.lo, ~2^-22 relative, dropped);
//   - 6xTF32 (SPLITS = 6, 'highest', the TPU's fp32-exact 6-pass HIGHEST):
//     hi, mid and lo, the six products whose terms reach 2^-22 (the three
//     dropped are <= 2^-33);
//   - one pass (SPLITS = 1, 'highest' with matmul_precision 'default', the
//     TPU's single pass): hi . hi, ~5e-4 against float64.
// The fourth, kBF16IO (bf16 spectra: the JAX kernel's BF16IO), is laid out
// as one pass but rounds each operand to bf16 (to nearest, even; bf16r)
// where the others take TF32 pieces; see "bf16 spectra" below.
// wgmma.m64n64k8 runs both stages of the 64-row configuration (the
// headline) and the stacked configuration's W stage, mma.sync.m16n8k8 both
// stages of the 32-row configuration (wgmma takes 64 rows). The tensor
// cores' fp32 accumulation truncates, which over a long contraction adds up
// (past the 1e-5 bar at the 1024 block), so the products are summed on the
// tensor cores only over a short stretch of the contraction (a chunk of kUK
// spectrum rows in the H stage, 8 in the 32-row one; a chunk of kKC rows
// of [Mr ; Mi] in the W stage) and those partial sums are added in IEEE
// fp32 (add4). At 6xTF32 each sum that takes part in the truncation is
// also kept small: its small terms are summed before, or apart from, the
// main term hi . hi (the 64-row H stage runs every small term of a chunk
// first; the W stages sum them in a tile of their own, tc), so a stretch
// truncates about once per k-step at the main term's scale, as one fp32
// product would round: on the H100, 6xTF32 lands 2.4-4.3e-7 from float64
// over chip_smoke.py step 34's nine geometries (the block sizes the
// planner makes), closer than the float32 plain version (2.8-9.5e-7, the
// most at the 1023-long contractions), and 3xTF32 ~1e-6 from the plain
// version (step 3). The channel
// MAC (S) stays IEEE fp32 FMAs. The stacked configuration's H stage sums a
// u-chunk of spectrum rows on the tensor cores (8 rows on mma.sync.m16n8k8
// on the tier's TF32 pieces; at kBF16IO 16 on one bf16 m16n8k16 product)
// and adds it to X in IEEE fp32 (below).
//
// The tiers' planes. The operands wgmma reads from shared memory are held
// as planes of their pieces: S^T, G (and -Gi) and the M^T ring, 2 planes
// each at 3xTF32, 3 at 6xTF32, 1 at one pass; the 32-row configuration's
// fragments, read by ldmatrix, have the same planes but for M^T at 6xTF32,
// which streams as it is (one plane) and is split in registers, so that
// the 1024 block's X fits beside it. X's fragments are split in registers
// (wgmma's A operand, and mma.sync's). Shared memory at the headline:
// 181,248 B at 3xTF32, 214,016 at 6xTF32, 148,480 at one pass and at
// kBF16IO.

// bf16 spectra. The JAX kernel's BF16IO mode feeds bf16 operands to
// single-pass MXU dots with f32 accumulation: it rounds S (the MAC's
// output), G, X (the H stage's output) and M to bf16 right before each
// product. SPLITS = kBF16IO does the same: D and K load as bf16 and widen
// to fp32, the MAC stays fp32 FMAs (as JAX's), S is rounded as it is staged
// for the H stage, X as its fragments are formed for the W stage, and G and
// M arrive rounded (ops/block_conv.py _kernel_mats). A bf16 value is exact
// in TF32, so a TF32 mma/wgmma on bf16-valued operands forms the exact
// products and sums them in fp32, as the single-pass bf16 dot does; the
// stacked configuration's H stage runs bf16 mma.sync products on them
// (exact products, fp32 sums). bf16
// spectra at SPLITS = 3 (the explicit 3xTF32 entries) keep S, X, G and M in
// fp32, split as above: the fp32 kernel's result on the bf16-rounded
// spectra. Either way bf16 halves the bytes of D and K streamed per cell.
//
// What bounds it. At the 2048^2 x 100 x 64^2 headline plan (blocks 127 x 447,
// valid window 64 x 384, Wc = 224, 192 blocks) one cell is ~37 MFLOP as
// computed here (4-multiply complex products): the H stage (a complex
// (Vh x Lh)(Lh x Wc) product, 40%) and the W stage (a real (Vh x 2Wc)
// (2Wc x Vw) product, 60%); the MAC is <1%. Over 192 x 100 cells that is
// ~0.71 TFLOP against 1.68 GB of output maps and ~67 MB of spectra: bound by
// arithmetic, not by device-memory bytes. As 3xTF32 the syntheses are 3 x
// 0.71 TFLOP of tensor-core work, 4.3 ms at the H100's 495 TFLOP/s dense
// TF32 peak (8.6 ms as 6xTF32, 1.4 ms as one pass), against 10.5 ms for the
// same work as fp32 FMAs at 67 TFLOP/s.
// Each CTA alternates between its MAC, staging and barriers and its
// products (one CTA per SM leaves nothing to overlap them), so the kernel
// is far from that bound (PERF.md).
//
// Design. One CTA (256 threads, 8 warps) owns ROWS window rows of one cell;
// the rows of the tile are independent, so a cell taller than ROWS splits
// across CTAs by rows (row chunks), each recomputing its S columns from D
// and K (F complex MACs per element). For mma.sync the warps tile ROWS x
// 128 as 2 x 4 warps of ROWS/2 rows x 32 columns: ROWS/32 x 4 mma.m16n8k8
// tiles each, their fragments read from shared memory with ldmatrix; for
// wgmma the CTA's two warpgroups take 64 rows x 64 columns each.
//   1. H stage, in column passes of kCols packed bins: S is computed on the
//      fly in (kUK x kCols) chunks from D and K (fp32 FMAs, 8 elements a
//      thread, a warp's 32 lanes on 8 bins x 4 spectrum rows) and staged in
//      shared memory as S^T, the tier's planes of Sr and Si (pieces), beside
//      the matching (ROWS x kUK) chunk of G, split as it is staged. The
//      complex product runs as real products over the chunk's spectrum
//      rows: Xr += Gr Sr - Gi Si, Xi += Gi Sr + Gr Si. 64 rows: S^T and G
//      (and -Gi, so that Xr too is a sum) are staged as core matrices and
//      wgmma reads both from shared memory (A = G, B = S^T); each
//      warpgroup keeps its 64 x 64 tile of X in registers across the
//      chunks. 32 rows: the fragments are read with ldmatrix for mma.sync,
//      X as two ROWS/2 x 32 tiles a warp (Gi Si summed apart and
//      subtracted). The next chunk's D, K (channel 0) and G are loaded into
//      registers before the products, so those loads are in flight during
//      them. Finished
//      passes land in shared memory as X, rows x [Xr | Xi] over the bins
//      padded to kKB: a cell's whole S (127 x 224 x 8 B = 227 KB) cannot
//      stay resident, X for 64 rows (113 KB at Wc 224) can.
//   2. W stage, in column passes of kCols output columns: M^T's planes
//      stream from global memory (shared by every CTA, they stay in
//      L2) through a ring of kM shared-memory chunks of kKC rows of
//      [Mr ; Mi]. 64 rows: each chunk one contiguous run of M^T
//      (ops/block_conv.py _core_matrices lays it out chunk by chunk), one
//      TMA bulk copy issued by thread 0, completing on a "full" mbarrier a
//      slot; a slot is freed by an "empty" mbarrier at which every warp
//      arrives once its products are done with it, and thread 0 refills it
//      then, a step ahead of the products (no __syncthreads a step, no copy
//      work in the other threads). The barriers live in X's row padding,
//      which nothing reads during the W stage. 32 rows: the ring filled with
//      cp.async kM - 1 chunks ahead of the products. (Measured on the H100
//      at the headline, PERF.md: the cp.async ring's copies cost 1.8 of
//      13.5 ms at 3xTF32 even two chunks ahead, the copy work in every
//      thread rather than the bytes; the TMA ring reads 0.95x the cp.async
//      ring's time at 3xTF32, 0.89x at 6xTF32; more slots (3, 4) were no
//      faster, and thread-block clusters of 2 and 4 CTAs multicasting each
//      chunk slower than none: L2 does not hold the stage.)
//      64 rows: each warpgroup reads its X fragments (wgmma's A operand, in
//      registers) and splits them, one k-step at a time (the pieces of X
//      for 64 rows would not fit beside X), and runs the k-step's products
//      against the chunk's planes in place (B, by descriptor); 32
//      rows: each warp does the same with mma.sync, B fragments by
//      ldmatrix. Each keeps its accumulator tile across the chunks of a
//      pass and hands it to the epilogue after the pass.
// The 32-row configuration's S^T and G rows are padded to 20 floats, X's
// rows to 2 x bins + 4, and the 64-row S^T and G and every M^T are held in
// core matrices (8 columns x 4 rows, 128 contiguous bytes), so that the
// fragment reads and the S^T stores are free of bank conflicts. The
// one-block configurations: 64 rows (the headline) and, where that X does
// not fit in shared memory (Wc > 320 at 3xTF32), the paired configuration
// below or, where the pair does not fit either, 32 rows (6xTF32 past Wc
// 513, the Karatsuba form at one pass and kBF16IO past Wc 705). Blocks run
// in
// parallel and in no order, unlike the TPU grid that kept the kernel index
// innermost so a data block stayed in VMEM across the bank; here the kernel
// index is the fastest-varying launch index, so the CTAs resident at one
// time share a data block (and the whole bank) in L2.
//
// Wide blocks: the paired configuration (PAIRED; v3 and the radix bodies
// in both H-stage forms, at every tier, where the 64-row X does not fit;
// the radix bodies' pair below). A thread-block
// cluster of kPair = 2 CTAs takes 64 window rows of one cell (row chunks of 64), and
// each CTA owns part of the bins 0 .. wc - 2: rank 0 the first pair_half
// (half of them rounded up to kKB, or kKB more where that leaves rank 1 no
// pass under kKB bins), rank 1 the rest; each CTA's X holds its bins, padded
// to pair_half (132,096 B at the 1024 block). So a cell's S is built once a
// row chunk of 64 rows, not once a chunk of 32 (the 32-row configuration
// built the 1024 block's S 16 times a cell), and the H stage runs on wgmma
// (the 64-row stage above) over two passes of 128 bins at the 1024 block,
// not five of mma.sync.
//   - The last bin (the Nyquist bin of an even block) gets no pass of its
//     own (at Wc = 4 128 + 1 a fifth pass of each stage ran for one bin):
//     its X column G S[:, wc - 1] is summed in fp32 FMAs beside the products
//     in the first pass, the last kUK threads forming its S a chunk (S
//     rounded as the staged S is), every thread four spectrum rows of a
//     row's G from its staging loads, the row's four threads added at the
//     pass's end, in the form's factorisation (Karatsuba: t1, t2, t3), into
//     the sliver past the staging area; the W stage adds it to each tile as a
//     rank-1 term, Xn (rounded at kBF16IO as X is) times the last row of [Mr ;
//     Mi] (exact, or rounded at kBF16IO: m_tc's sliver), in fp32.
//   - W stage: each rank computes half of the output columns' passes (rank
//     0 the first half, rounded up) over the whole contraction, rank 0's [Xr
//     | Xi] then rank 1's (M^T laid out in that order, ops/block_conv.py
//     _pair_m), on the 64-row TMA ring: a chunk of this rank's X by ldmatrix,
//     one of its partner's by four 32-bit ld.shared::cluster a fragment
//     (mapa, after a barrier.cluster that follows both H stages). A last
//     output column alone past whole passes (vw = 128 q + 1) gets no pass
//     either: each rank sums its half of the column's dot in float64 (exact
//     products, a sum that does not round) after its H stage, and rank 1
//     adds both and the last bin's term and rounds once. A last barrier.cluster
//     keeps each CTA until its partner has read its shared memory.
//   - The peaks epilogue writes an entry a CTA: the pyramid's row chunks are
//     rc kPair + rank, reduced by the wrapper (ops/block_conv.py
//     _best_chunk).
//   - Shared memory: X, the 64-row staging area and a sliver of kPairSliver
//     floats: 198,656 B at 3xTF32 at the 1024 block, 231,424 at 6xTF32,
//     165,888 at one pass and kBF16IO (the Karatsuba form's at 6xTF32 does
//     not fit there, as the 32-row one did not). Launched with
//     cudaLaunchKernelEx, cluster dimension 2, the pair's CTAs fastest in the
//     grid, then the kernel index.
// Precision: the same short stretches on the tensor cores; the last bin's X
// is an fp32 sum of 1,023 terms at the 1024 block, the last column's a
// float64 one.
//
// Short windows (Vh <= 32): block-stacked CTAs. A 64-row CTA holding one
// block of Vh = 16 rows (the DPM plan) leaves 48 rows idle, and a cell's
// MAC (F = 31 channels) is most of its work. So a third configuration takes
// g = min(64 / Vh, 4) blocks of one image and T kernels (kernels_per_cta:
// 2 where their X fit, else 1), stacks the blocks' window rows at offsets
// t * Vh of each kernel's 64-row X, as the JAX kernel's _make_kernel_v3
// stacks MBH blocks' H-stage outputs, and stages each block's D once for
// its T kernels (the L2 -> shared bytes of D fall by T):
//   - The copies (the last warp, the producer): a ring of steps, a step one
//     channel of a u-chunk for every plane (re and im of g blocks' D and T
//     kernels' K). A u-chunk is one mma k-step of spectrum rows (16 at
//     kBF16IO, 8 at the TF32 tiers: stack_rows); of one channel it is one
//     contiguous span of the planes (rows x Wc elements), so each is one
//     cp.async.bulk from the 16-byte chunk that holds its start (the reader
//     adds the start's offset); a lane a plane, completing on the slot's
//     full mbarrier, each lane arriving with its bytes. The MAC's warps
//     arrive at the slot's empty mbarrier when done with it, and the
//     producer refills it then: no __syncthreads a step.
//   - The MAC (the other 7 warps): a thread owns pixel pairs of the
//     u-chunk's rows x Wc positions, flattened as the spans hold them (no
//     idle lanes at Wc 70), and for each sums the g x T cells' S in
//     registers over the channels, in channel order (the parent's FMAs): a
//     step's g values of D and T of K a pixel are loaded together for g T
//     complex MACs (a register tile over (block, kernel), as the spectral
//     MAC's), the tile's shape a template instance (g 2..4, T 1..2) so that
//     nothing in it branches. Where every span starts on an element pair
//     (even Wc, pair-aligned planes: the DPM plan), a pair is one load.
//   - H stage (tensor cores, all 8 warps), kernel by kernel: its cells' S
//     goes to shared memory ([u][bin]), then X[r, c] += G[r, u] S[u, c]
//     over the u-chunk, one mma.sync k-step a (block, 16-row m-tile, 8-bin
//     n-tile) task: at kBF16IO m16n8k16 bf16 products of S rounded here and
//     G (rounded by _kernel_mats), at the TF32 tiers m16n8k8 on the tier's
//     pieces (the 4-product form: Xr = Gr Sr + (-Gi) Si and Xi = Gr Si + Gi
//     Sr, each one tensor-core sum; Karatsuba: t1, t2, t3 and Xr += t1 -
//     t2, Xi += t3 - (t1 + t2) a chunk). Each chunk's tile is added to X in
//     IEEE fp32. A warp's G fragments of a chunk are loaded before its MAC.
//   - W stage: the wgmma stage above, over each kernel's 64 stacked rows in
//     turn (M streams once a kernel, for its g blocks).
//   - The epilogue maps stacked row R to block R / Vh, window row R % Vh;
//     a last group with fewer than g blocks leaves its rows unwritten, as a
//     last CTA with fewer than T kernels leaves its cells.
// T kernels' X, one kernel's S and a ring of 2 steps must fit beside the W
// stage's buffers, and a u-chunk's pixels the MAC's registers (kMacAcc
// sums a thread: stack_max_wc); elsewhere (Vh > 32, or wider) the
// configurations above run. At the DPM plan (Wc 70, F = 31, kBF16IO) a CTA
// takes 4 blocks x 2 kernels: 218,560 B, 3 ring steps of 27 KB, 255
// registers. Launch order: tiles of `ktile` kernels (ops/block_conv.py
// kernel_tile sizes a tile's spectra to stay in L2, a whole number of CTAs'
// kernels), a CTA's kernels fastest inside a tile, then the block group.
// (Measured on the H100, PERF.md: the parent's design — one kernel a CTA,
// cp.async copies from every thread, an fp32-FMA H stage — put 21.6 of 24.0
// ms at DPM in its H stage; this one takes 9.7 ms in all. Copies by 16-byte
// cp.async from the producer warp in place of bulk copies, and 8-row
// u-chunks at kBF16IO, measured slower: PERF.md.)
//
// Radix-2 bodies (the template argument BODY: the JAX kernel's v4, v5 and
// v5x beside v3; ops/block_conv.py radix_h_legal, radix_w_legal). They run
// in the one-block 64- and 32-row configurations (not stacked), and in the
// pair where v3 runs it, and change two stages:
//   - v4's H stage. Lh = 2M; x[v] = E[v mod M] +- t[v mod M] O[v mod M]
//     with E = U S_even, O = U S_odd (U[v', j] = exp(2 pi i v' j / M) / Lh,
//     t[v'] = exp(i pi v' / M)), the window's rows v = w0 + r, w0 = Lh - Vh.
//     A row v' in [w0, M) gives two window rows (v' and v' + M) from one
//     row each of E and O: a pair chunk takes ROWS / 2 such v' and fills
//     its ROWS rows of X with half the products of the direct rows. The
//     rows whose partner falls outside the window (v = v' + M, v' < w0)
//     take E - t O alone, ROWS a single chunk, computed as the JAX kernel
//     computes every row (E and O from U and the rounded S rows, the
//     twiddle applied in fp32; G's rows, t folded into U and rounded with
//     it, would part from it by a bf16 rounding at kBF16IO): its two halves
//     of ROWS / 2 v' take half the warps each (64 rows: a warpgroup) over
//     passes of kCols / 2 bins, so that a thread holds what it holds in a
//     pair chunk (two halves on the same warps, in turn or in registers,
//     spilled). A block's row chunks are the pair chunks, then the single
//     chunks, and the products sum to the JAX kernel's 2 M^2 per bin. The S rows are staged even-then-odd (S^T's
//     k = (u % 2) 8 + u / 2 in a 16-row chunk: its 8 even rows are E's
//     k-step, its 8 odd rows O's), so no gather runs over the spectra; the
//     products run transposed, E^T = S_even^T U^T, so that a half's NV =
//     ROWS / 2 rows of U are the N of the product (64 rows: wgmma.m64n32k8
//     with A = S^T (the warpgroup's 64 bins) and B = U from shared memory;
//     32 rows: mma.sync with 16 bins a warp), and the combine, in fp32 with
//     t from the operand table (RadixOps::tw), writes X's local rows k
//     (x[v']) and NV + k (x[v' + M]) of a pair, or k and NV + k (x[v' + M]
//     of either half) of a single chunk. KARA runs JAX's csub in its
//     Karatsuba form: the planes Sr + Si and Ur + Ui (the operand table's
//     third plane) are staged beside the others (Ur + Ui in place of -Ui at
//     64 rows), three products for E and three for O, their loop not
//     unrolled at 64 rows (as v3's).
//   - The H stage in the pair (PAIRED, where v3 runs it; every radix
//     body): each rank runs the 64-row
//     stage above over its own bins of 0 .. wc - 2 (at Wc 257 one pass of
//     128 bins a pair chunk and two of 64 a single chunk, where the 32-row
//     code ran 3 and 5 over every bin), so S is built once a chunk over a
//     rank's bins. The last bin gets no pass: in the rank's first pass the
//     last kUK threads form its S a chunk, as v3's pair does (rounded as the
//     staged S is; in the sliver), and thread k < the chunk's v' sums its
//     v''s E and O (re and im) from U as staged (the sum of its pieces) in
//     fp32 FMAs, four sums in X's row padding (which the H stage does not
//     write); after the pass E +- t O goes to the sliver, in the 4-product
//     form whatever the H stage's (as v5's Nyquist term). (Measured, PERF.md:
//     these sums cost 2-4 ms of 40 at JAX's F=1 plan; a cp.async prefetch
//     of the bin's values and a split of the sums over every warp did not
//     make them cheaper.) v4's W stage, the
//     last bin's rank-1 term, a last column alone and the peaks entries are
//     the pair's; the epilogue masks each chunk's rows (row_end). v5 sums
//     the last bin the same way from the unrounded S (the JAX kernel's VPU
//     term: its sliver value is nyq), v5x not at all (its H stage skips the
//     Nyquist bin); the DIF pair's W stage is below.
//   - v5's W stage (DIF). With W = 2 (Wc - 1), the W/2 even bins give P =
//     half the W/2-point packed synthesis, the odd bins the twiddle-folded Q
//     (ops/block_conv.py _dif_w_mats: one (Tn x W) operand [epr; epi; oqr;
//     oqi]^T, Tn = min(Vw, W/2)), and x[t'] = P + Q, x[t' + W/2] = P - Q: a
//     pass of 128 t'-columns sums P over X's even bins and Q over its odd
//     ones (a contraction of W/4 bins a half, re and im), then hands the
//     epilogue column t' - t0 (P +- Q) and t' - t0 + W/2 (P - Q). X's bins
//     are stored permuted by the H stage, [even | odd | Nyquist], so each
//     half is a contiguous stretch. The Nyquist bin enters P as a rank-1
//     term nyq[r] (-1)^t / W: v5 reads nyq from X's Nyquist bin, which the
//     H stage overwrites with the JAX kernel's VPU term (U times the Nyquist
//     bin's unrounded S in fp32 FMAs, 4-product, beside the products; the
//     tensor cores' value would round S at kBF16IO); v5x from RadixOps::slv, synthesised outside
//     the kernel (ops/block_conv.py _xsliver), rounded to bf16 at kBF16IO
//     as the JAX kernel's BF16IO dot rounds it, and its H stage skips the
//     Nyquist bin (W/2 bins: one pass fewer at W = 512).
//   - v5's and v5x's W stage in the pair (PAIRED, where v3 runs it: at
//     6xTF32 on Wc 257, at every tier on Wc 513). The ranks split the W/2
//     bins below the Nyquist bin evenly (pair_half is W/4 on every plan
//     radix_w_legal admits; the launch refuses another split), each rank's
//     X stored [even | odd] within its bins (xcol, xq), so a W-stage chunk
//     of kKC rows of [epr; epi; oqr; oqi] lies in one rank's X: the
//     contraction keeps the one-block order (even re, even im, odd re, odd
//     im, each segment's bins rank 0's, then rank 1's; x_at), and
//     the 64-row operand serves as it is. Each rank takes half of the
//     t'-passes (1 / 1 at Tn 256, 2 / 2 at Tn 512), P over both ranks' even
//     chunks and Q over their odd ones, the partner's through
//     ld.shared::cluster as v3's pair reads it; the Nyquist term enters P
//     as above (v5: the sliver's value of each row; 1 / W from RadixOps,
//     set at launch), and the epilogue gets P +- Q at t' - t0 and P - Q at
//     t' - t0 + W/2, so a rank's columns are two stretches (the peaks
//     kernel's entry a rank reduces both; ties go to the smaller flat
//     index). No last column alone: the passes run over t'-columns.
//     Registers: the chunk's row segments and cell are decoded anew from
//     the block index after the H stage, in 32-bit arithmetic (held
//     through it, or decoded with a 64-bit division, whose subroutine
//     call needs registers, they spilled the 6xTF32 entries; PERF.md).
// Precision: the same short stretches (8 spectrum rows of E or O a chunk;
// kKC rows of a half a W-stage chunk) summed on the tensor cores and added
// in IEEE fp32, and the same tiers, as above.
//
// An epilogue is a class template on STACKED (the block-stacked
// configuration or not) with
//   using Out = ...;                            the kernel's output argument
//   __device__ Epi(Out, const Cell&, const OutGeom&);
//   template <int MT, int NT>
//   __device__ void tile(const float (&acc)[MT][NT][4], int row0, int col0, int row_end);
//   __device__ void finish(float* scratch);
// tile() receives a thread's W-stage accumulators in the mma.m16n8k8
// layout (wgmma's: MT = 1, NT = 8; mma.sync's: MT = ROWS / 32, NT = 4):
// acc[mt][nt][i] is row row0 + 16 mt + 8 (i / 2), column
// col0 + 8 nt + i % 2 (window rows of the cell, or, stacked, rows of the
// stack: row R is window row R % vh of the group's block R / vh; window
// columns); rows may pass what exists, or row_end (a radix chunk's rows
// that another chunk owns), and columns vw: the epilogue masks them.
// finish() runs once, by every thread, after the last pass, with the
// staging area free for its use (>= 64 x 16 x 2 floats).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 128;  // columns per pass (packed bins, output columns)
constexpr int kUK = 16;     // spectrum rows per H-stage chunk
constexpr int kKB = 32;     // X's packed bins pad to it
constexpr int kKC = 32;     // rows of [Mr ; Mi] per W-stage chunk (it divides 2 kKB)
constexpr int kMaxSmem = 232448;  // Hopper's per-block shared-memory limit
constexpr int kGS = kUK + 4;      // row stride (floats) of the 32-row S^T and G staging
// M^T is held in core matrices: 8 output columns x 4 rows of [Mr ; Mi]
// (128 contiguous bytes), [column / 8][row / 4][8][4], as wgmma reads a
// K-major operand from shared memory and ldmatrix reads B fragments.
constexpr int kCore = 32;                            // floats of a core matrix
constexpr int kMPlane = (kCols / 8) * (kKC / 4) * kCore;  // one plane of a chunk

// The synthesis tiers (SPLITS, the tensor-core products a product of two
// fp32 operands runs as): 3 (3xTF32, the default), 6 (6xTF32) or 1 (one
// TF32 pass); each operand is split into the TF32 pieces of pieces_of().
// kBF16IO is one product of operands rounded to bf16 (one piece).
constexpr int kBF16IO = 0;
__host__ __device__ constexpr int pieces_of(int splits) { return splits == 6 ? 3 : splits == 3 ? 2 : 1; }
__host__ __device__ constexpr int products_of(int splits) { return splits == kBF16IO ? 1 : splits; }
__host__ __device__ constexpr bool valid_splits(int splits) {
  return splits == kBF16IO || splits == 1 || splits == 3 || splits == 6;
}
// Planes of M^T a W-stage chunk holds: its TF32 pieces, except in the
// 32-row configuration at 6xTF32, which stages M^T as it is (one plane)
// and splits its fragments in registers (three planes beside the 1024
// block's X would not fit).
__host__ __device__ constexpr int m_planes(int rows, int splits) {
  return rows == 32 && splits == 6 ? 1 : pieces_of(splits);
}
// The staging area (floats) of a configuration of ROWS rows: the H stage's
// S^T (the pieces of re and im: kCols x kUK each, or kCols x kGS at 32 rows)
// and G chunk (the pieces of re and im, and of -im at 64 rows: ROWS x kUK
// each, or ROWS x kGS), or the W stage's ring of kM chunks of M^T's planes
// (kCols output columns x kKC rows of [Mr ; Mi]), copied kM - 1 chunks
// ahead, whichever is larger. The Karatsuba H stage (KARA) stages a third
// S^T plane, Sr + Si, and in place of -Gi the plane Gr + Gi (a third G plane
// at 32 rows).
constexpr int kM = 2;
__host__ __device__ constexpr int s_planes(bool kara) { return kara ? 3 : 2; }
__host__ __device__ constexpr int stage_h(int rows, int splits, bool kara = false) {
  return rows == 64 ? s_planes(kara) * pieces_of(splits) * kCols * kUK + 3 * pieces_of(splits) * rows * kUK
                    : s_planes(kara) * pieces_of(splits) * (kCols + rows) * kGS;
}
__host__ __device__ constexpr int stage_w(int rows, int splits) { return kM * m_planes(rows, splits) * kMPlane; }
__host__ __device__ constexpr int stage_all(int rows, int splits, bool kara = false) {
  return stage_h(rows, splits, kara) > stage_w(rows, splits) ? stage_h(rows, splits, kara)
                                                             : stage_w(rows, splits);
}

// The paired configuration: the CTAs of its cluster, and the floats past its
// staging area (a sliver: the Nyquist bin's X of each of the 64 rows, re and
// im, then the last column's partial sum of each row, a double; during the
// H stage the Nyquist bin's S of a chunk).
constexpr int kPair = 2;
constexpr int kPairSliver = 64 * 4;
// The block-stacked configuration: g blocks x T kernels of one image a CTA.
constexpr int kStackG = 4;       // blocks a stacked CTA takes, at most
constexpr int kStackT = 2;       // kernels a stacked CTA takes, at most
constexpr int kMacWarps = kThreads / 32 - 1;  // the MAC's warps; the last one copies
constexpr int kMacThreads = 32 * kMacWarps;
constexpr int kMacAcc = 96;      // S accumulators a MAC thread holds, at most
constexpr int kMinStages = 2;    // steps of the MAC ring: at least,
constexpr int kMaxStages = 8;    // and at most
constexpr int kStackBars = 2 * kMaxStages;  // the ring's full and empty barriers
// Spectrum rows of a u-chunk: one mma k-step, 16 bf16 values at kBF16IO
// (m16n8k16), 8 TF32 ones at the other tiers (m16n8k8).
__host__ __device__ constexpr int stack_rows(int splits) { return splits == kBF16IO ? 16 : 8; }
// Pixel pairs a MAC thread sums for g blocks x t kernels (a pair, g t
// complex sums, re and im, for two pixels: 4 g t floats).
__host__ __device__ constexpr int mac_pairs(int g, int t) { return kMacAcc / (4 * g * t); }
template <int ROWS, int SPLITS>
struct Stage {
  static_assert(valid_splits(SPLITS), "1, 3 or 6 tensor-core products, or kBF16IO");
  static constexpr int kP = pieces_of(SPLITS);       // TF32 pieces of an operand
  static constexpr int kMP = m_planes(ROWS, SPLITS);  // M^T planes in the ring
  static constexpr int kW = stage_w(ROWS, SPLITS);
  static constexpr int kPerS = kUK * kCols / kThreads;     // S elements a thread sums
  static_assert(kPerS == 8 && kUK == 16, "8 warps x 8 elements tile 16 rows x 128 bins");
  static constexpr int kPerG = 2 * ROWS * kUK / 4 / kThreads;  // float4s of G a thread stages
  // Karatsuba: a thread stages the re and im float4 of one (row, 4 spectrum
  // rows) position of the G chunk, and their sum; kGPos positions.
  static constexpr int kGPos = ROWS * kUK / 4;
  static_assert(kGPos <= kThreads, "one G position a thread at most");
};
static_assert(kCols == 4 * 32, "4 warps of 32 columns span a pass");
static_assert(2 * (kStackG + kStackT) <= 32, "one copy a producer lane a step");
// Rows of 16-byte multiples whose 8-row groups cover all 32 banks once:
// ldmatrix reads them without bank conflicts.
static_assert(kGS % 32 == 20, "conflict-free fragment loads");
static_assert((2 * kKB) % kKC == 0, "W-stage chunks tile [Xr | Xi]");

// The bodies (BODY): v3, the radix-2 v4 (H stage), v5 (H and DIF W
// stages, in-kernel Nyquist term) and v5x (the Nyquist term an operand).
// JAX's v2 body (_make_kernel, block_conv_pallas under wstack=False: MBH
// blocks of one block column, one H product G [S_1 | ... | S_MBH]) has no
// body here: each output element's products are v3's, and its entries
// (_v2, _v2_k) launch v3's configuration of the same form (block_conv.cu).
constexpr int kV3 = 0, kV4 = 1, kV5 = 2, kV5X = 3;
__host__ __device__ constexpr bool dif_body(int body) { return body == kV5 || body == kV5X; }
__host__ __device__ constexpr bool radix_body(int body) { return body == kV4 || dif_body(body); }
// The radix bodies' operands (ops/block_conv.py _radix_kernel_mats): U (3,
// u_rows(M), g_cols(M)) = re, im, re + im (the Karatsuba form's plane); the
// twiddle (2, M) = cos, sin; v5x's sliver (B, N, nbh, nbw, Vh), the Nyquist
// bin's windowed H synthesis; and the DIF stage's 1 / W, which
// launch_block_conv sets (a division in the kernel calls a subroutine whose
// registers spilled the DIF pair's peaks entry at 6xTF32).
struct RadixOps {
  const float* u_pad;
  const float* tw;
  const float* slv;
  float inv_w;
};
__host__ __device__ inline int u_rows(int m) { return (m + 63) / 64 * 64; }
// A block's radix row chunks in the configuration of `rows` rows: pair
// chunks (rows / 2 v' in [w0, M) each), then single chunks (rows window
// rows of [M - w0, M) each).
__host__ __device__ inline int pair_chunks(int lh, int vh, int rows) {
  return (lh / 2 - (lh - vh) + rows / 2 - 1) / (rows / 2);
}
__host__ __device__ inline int single_chunks(int lh, int vh, int rows) {
  return (lh - vh + rows - 1) / rows;
}
// The window rows of radix row chunk rc's local rows: [0, rows / 2) from a,
// [rows / 2, rows) from b, each below ea and eb. A pair chunk's are x[v']
// and x[v' + M] for v' = w0 + rc rows / 2 + k (rows k and rows / 2 + k),
// a single chunk's window rows r0.. of [M - w0, M).
struct Segs {
  int a, b, ea, eb;
};
__host__ __device__ inline Segs radix_segs(int rc, int lh, int vh, int rows) {
  const int m = lh / 2, w0 = lh - vh, npc = pair_chunks(lh, vh, rows);
  if (rc < npc) return Segs{rc * (rows / 2), rc * (rows / 2) + m, m - w0, vh};
  const int r0 = m - w0 + (rc - npc) * rows;
  return Segs{r0, r0 + rows / 2, m, m};
}
// The plans the radix bodies take: an even Lh whose window starts in the
// first half period (0 < w0 < M), and for the DIF W stage W/4 a whole
// number of W-stage chunks.
inline bool radix_h_ok(int lh, int vh) { return lh % 2 == 0 && lh - vh > 0 && lh - vh < lh / 2; }
inline bool radix_w_ok(int wc) { return wc > 1 && (wc - 1) % (2 * kKC) == 0; }

// A spectra element as fp32: the identity for fp32, a widening for bf16.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
// Two adjacent spectra elements, from an address aligned to the pair.
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---- split TF32 products on the tensor cores ----
// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; the same bits for every finite x), with two integer
// operations: the conversion instruction runs at a fraction of their rate,
// and the W stage splits 16 values a warp per k-step.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x = p[0] + ... + p[P - 1], each TF32: p[0] = TF32(x), p[1] = TF32(x -
// p[0]), p[2] = TF32(x - p[0] - p[1]); two pieces hold x to ~2^-22
// relative, three to ~2^-33 (fp32 exactly, but for the last rounding).
template <int P>
__device__ __forceinline__ void split_n(float x, uint32_t (&p)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    p[k] = tf32(x);
    if (k + 1 < P) x -= __uint_as_float(p[k]);
  }
}
// x rounded to bf16 (to nearest, ties to even: the rule of
// __float2bfloat16_rn and of torch's cast, for every finite x), as the bits
// of an fp32 (and TF32) value.
__device__ __forceinline__ uint32_t bf16r(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
}
// The operand pieces of tier SPLITS: split_n's TF32 pieces, or at kBF16IO
// the bf16 rounding.
template <int SPLITS, int P>
__device__ __forceinline__ void pieces(float x, uint32_t (&p)[P]) {
  if constexpr (SPLITS == kBF16IO) {
    static_assert(P == 1, "kBF16IO: one piece");
    p[0] = bf16r(x);
  } else {
    split_n(x, p);
  }
}
// The products of a SPLITS-product tier, as (piece of a, piece of b): the
// pairs whose pieces sum below pieces_of(SPLITS), the smallest terms first
// (by i + j, then i, descending); the last is the main term hi . hi. A
// tier runs the last products_of(SPLITS) of the list: 6xTF32 all of them
// (the pairs whose terms are below 2^-33 relative are dropped), 3xTF32
// a_lo b_hi, a_hi b_lo, a_hi b_hi, one pass (and kBF16IO) the main term.
__host__ __device__ constexpr int prod_a(int q) { return q == 0 ? 2 : q == 1 || q == 3 ? 1 : 0; }
__host__ __device__ constexpr int prod_b(int q) { return q == 2 ? 2 : q == 1 || q == 4 ? 1 : 0; }
// The first product of a tier, and of its main term.
__host__ __device__ constexpr int first_product(int splits) { return 6 - products_of(splits); }
constexpr int kMainProduct = 5;
// d += a b: a 16 x 8 A fragment, an 8 x 8 B fragment, fp32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// t += a b over the products q in [Q0, Q1) of the list, summed on the
// tensor cores, a and b given as their TF32 pieces.
template <int Q0, int Q1, int P>
__device__ __forceinline__ void mma_terms(float (&t)[4], const uint32_t (&a)[P][4], const uint32_t (&b)[P][2]) {
#pragma unroll
  for (int q = Q0; q < Q1; ++q) mma(t, a[prod_a(q)], b[prod_b(q)]);
}
// t += a b as the SPLITS products of the tier.
template <int SPLITS, int P>
__device__ __forceinline__ void mma_n(float (&t)[4], const uint32_t (&a)[P][4], const uint32_t (&b)[P][2]) {
  mma_terms<first_product(SPLITS), 6>(t, a, b);
}
// t += a0 b0 + a1 b1 as the tier's products; 6xTF32 sums both terms'
// small products before their main terms.
template <int SPLITS, int P>
__device__ __forceinline__ void mma_n2(float (&t)[4], const uint32_t (&a0)[P][4], const uint32_t (&b0)[P][2],
                                       const uint32_t (&a1)[P][4], const uint32_t (&b1)[P][2]) {
  if constexpr (SPLITS == 6) {
    mma_terms<0, kMainProduct>(t, a0, b0);
    mma_terms<0, kMainProduct>(t, a1, b1);
    mma_terms<kMainProduct, 6>(t, a0, b0);
    mma_terms<kMainProduct, 6>(t, a1, b1);
  } else {
    mma_n<SPLITS>(t, a0, b0);
    mma_n<SPLITS>(t, a1, b1);
  }
}
// d += t with IEEE fp32 adds: a stretch of the contraction is summed on the
// tensor cores into a fresh tile t and added to the running sum here (see
// Precision).
__device__ __forceinline__ void add4(float (&d)[4], const float (&t)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}
// Four 8 x 8 b16 matrices from shared memory, here each 8 rows x 4 fp32
// words: lane l gives the address of row l % 8 of matrix l / 8, and
// register j of the thread (g = lane / 4, t = lane % 4) receives word t of
// row g of matrix j. With the lane offsets below, that is an mma.m16n8k8
// A fragment of a row-major tile (a_lane), or the B fragments of two
// n-tiles of a tile stored n-major, [n][k] (b_lane): registers 0, 1 for
// the first n-tile, 2, 3 for the second.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ int a_lane(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 4;
}
__device__ __forceinline__ int b_lane(int lane, int ld) {
  return ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 4;
}
// The B fragments of two n-tiles from M^T's core matrices: lane l reads
// row l % 8 of core (n-group (l / 16), k-core (l / 8) % 2), relative to the
// first n-group and k-core of the pair.
__device__ __forceinline__ int core_lane(int lane) {
  return ((lane >> 4) * (kKC / 4) + ((lane >> 3) & 1)) * kCore + (lane & 7) * 4;
}

// ---- wgmma (the 64-row configurations' W stage) ----
// A shared-memory matrix descriptor without swizzling: core matrices of 8
// rows x 16 bytes; lbo = bytes between core matrices along K, sbo = bytes
// between 8-row groups along N.
__device__ __forceinline__ uint64_t smem_desc(const float* p, int lbo, int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32;
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// d += A B for the warpgroup with A (64 x 8, K-major) and B (8 x 64,
// K-major) both TF32 in shared memory, at descriptors da and db.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}
// The same at N = 32 (the radix H stage: B = 32 rows of U).
__device__ __forceinline__ void wgmma_tf32_ss32(float (&d)[4][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}
// Wait until at most N of this warpgroup's wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// d as a value the compiler cannot know before this point, so that what
// is computed from it is computed here and not held in registers from an
// earlier computation of the same value.
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}
// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma reads or writes (its accumulators d, its A fragment a)
// across the wgmma, or giving them to other values before it is waited for.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}
// d += A B for the warpgroup: A, 64 x 8 TF32 in registers (each warp's 16
// rows as an mma.m16n8k8 A fragment); B, 8 x 64 TF32 (K-major) at desc; d,
// 64 x 64 fp32, each warp's 16 rows as 8 n-tiles of mma.m16n8k8 C
// fragments.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// Packed bins X holds (padded to the W stage's chunks), and its row stride.
__host__ __device__ inline int padded_bins(int wc) { return (wc + kKB - 1) / kKB * kKB; }
__host__ __device__ inline int x_stride(int wc) { return 2 * padded_bins(wc) + 4; }
// The padded shapes of the operand planes _kernel_mats makes: G (Vh, Lh)
// to whole 64-row chunks and kUK-row chunks; M^T's rows to whole passes.
__host__ __device__ inline int g_rows(int vh) { return (vh + 63) / 64 * 64; }
__host__ __device__ inline int g_cols(int lh) { return (lh + kUK - 1) / kUK * kUK; }
__host__ __device__ inline int m_cols(int vw) { return (vw + kCols - 1) / kCols * kCols; }

// Shared memory of the one-block configuration of `rows` rows at the tier
// (kara: with the Karatsuba H stage's planes).
inline long long tile_smem_bytes(int rows, int wc, int splits, bool kara = false) {
  return 4LL * (static_cast<long long>(rows) * x_stride(wc) + stage_all(rows, splits, kara));
}

// Blocks a stacked CTA would take at window height vh (1: not stacked).
inline int group_of(int vh) {
  if (vh > 32) return 1;
  return 64 / vh < kStackG ? 64 / vh : kStackG;
}

// The stacked H stage's S: for the g (block) cells of one kernel, re and
// im, the u-chunk's rows x the bins padded to whole mma n-tiles (floats).
__host__ __device__ inline int stack_bins(int wc) { return (wc + 7) / 8 * 8; }
__host__ __device__ inline int s_floats(int wc, int g, int splits) {
  return g * 2 * stack_rows(splits) * stack_bins(wc);
}
// The widest bins a u-chunk's pixels fit in the MAC's registers.
__host__ __device__ inline int stack_max_wc(int g, int t, int splits) {
  return mac_pairs(g, t) * 2 * kMacThreads / stack_rows(splits);
}

// Bytes a ring slot gives one plane's span (a u-chunk of one channel:
// stack_rows x wc elements of `size` bytes, contiguous in the planes): the
// 16-byte chunks that hold it wherever it starts in a chunk (a bulk copy
// moves whole 16-byte chunks from a 16-byte-aligned address).
__host__ __device__ inline int span_bytes(int wc, int rows, int size) {
  return 16 * ((rows * wc * size + 15 - size) / 16 + 1);
}

// A ring step is one channel of every plane: re and im of g blocks' D and
// of t kernels' K.
__host__ __device__ inline int step_planes(int g, int t) { return 2 * (g + t); }

struct Ring {
  int stages;
  long long bytes;
};

// The ring of spectra of `size` bytes in `left` bytes: as many steps as
// fit, at most kMaxStages; {0, 0} below kMinStages.
inline Ring ring_in(long long left, int wc, int g, int t, int splits, int size) {
  const long long step =
      static_cast<long long>(step_planes(g, t)) * span_bytes(wc, stack_rows(splits), size);
  long long n = left < 0 ? 0 : left / step;
  if (n > kMaxStages) n = kMaxStages;
  return n >= kMinStages ? Ring{static_cast<int>(n), n * step} : Ring{0, 0};
}

// The stack's shared memory: X of its t kernels (64 rows each), then the
// staging area, S and the ring after it or the W stage's buffers,
// whichever is larger, then the ring's barriers. The ring is sized for the
// tier's spectra (bf16 at kBF16IO, else fp32); bf16 spectra at the other
// tiers fill the same bytes with more steps.
inline long long stacked_x_bytes(int wc, int t) { return 4LL * t * 64 * x_stride(wc); }

inline Ring stacked_ring_sized(int wc, int g, int t, int splits) {
  return ring_in(kMaxSmem - stacked_x_bytes(wc, t) - 4LL * s_floats(wc, g, splits) - 8LL * kStackBars, wc,
                 g, t, splits, splits == kBF16IO ? 2 : 4);
}

template <class TS>
Ring stacked_ring(int wc, int g, int t, int splits) {
  return ring_in(stacked_ring_sized(wc, g, t, splits).bytes, wc, g, t, splits, sizeof(TS));
}

inline long long stacked_smem_bytes(int wc, int g, int t, int splits) {
  const long long h = 4LL * s_floats(wc, g, splits) + stacked_ring_sized(wc, g, t, splits).bytes;
  const long long w = 4LL * stage_w(64, splits);
  return stacked_x_bytes(wc, t) + (h > w ? h : w) + 8LL * kStackBars;
}

inline bool stack_fits(int wc, int g, int t, int splits) {
  return wc <= stack_max_wc(g, t, splits) && stacked_ring_sized(wc, g, t, splits).stages >= kMinStages &&
         stacked_smem_bytes(wc, g, t, splits) <= kMaxSmem;
}

// The configuration a geometry runs at a tier: g > 1 blocks stacked in 64
// rows where the window is at most 32 rows and that fits with one kernel
// a CTA (then as many kernels, up to kStackT, as fit); else 64 rows where
// its X fits, else 32. The tier's planes change what fits: at 6xTF32 the
// 64-row configuration takes bins up to 256 (320 at 3xTF32); so do the
// Karatsuba H stage's (kara), whose stacked configuration stages nothing
// more (its products form Sr + Si and Gr + Gi as they read S and G).
inline bool wide(int wc, int splits, bool kara = false) {
  return tile_smem_bytes(64, wc, splits, kara) > kMaxSmem;
}

inline int blocks_per_cta(int wc, int vh, int splits) {
  const int g = group_of(vh);
  return g > 1 && stack_fits(wc, g, 1, splits) ? g : 1;
}

inline int kernels_per_cta(int wc, int vh, int splits) {
  const int g = blocks_per_cta(wc, vh, splits);
  if (g == 1) return 1;
  int t = kStackT;
  while (t > 1 && !stack_fits(wc, g, t, splits)) --t;
  return t;
}

// The paired configuration (v3 and the radix bodies, both H-stage forms,
// where the 64-row X does not fit; see "Wide blocks" above): rank 0's bins,
// half of the wc -
// 1 bins below the Nyquist bin rounded up to kKB, or kKB more where that leaves
// rank 1 no pass under kKB bins and still fits (pass_ok); 0 where the pair
// does not fit.
__host__ __device__ inline bool pass_ok(int bins) { return bins % kCols == 0 || bins % kCols >= kKB; }
__host__ __device__ inline long long pair_smem_bytes(int half, int splits, bool kara) {
  return 4LL * (64LL * (2 * half + 4) + stage_all(64, splits, kara) + kPairSliver);
}
__host__ __device__ inline int pair_half(int wc, int splits, bool kara) {
  const int nb = wc - 1;
  const int h0 = ((nb + 1) / 2 + kKB - 1) / kKB * kKB;
  for (int h = h0; h <= h0 + kKB; h += kKB)
    if (h < nb && pass_ok(nb - h) && pair_smem_bytes(h, splits, kara) <= kMaxSmem) return h;
  return h0 < nb && pair_smem_bytes(h0, splits, kara) <= kMaxSmem ? h0 : 0;
}
// The output columns the paired configuration's passes cover: a last column
// alone past whole passes (vw = 128 q + 1) is a dot of its own.
__host__ __device__ inline int pair_cols(int vw) { return vw % kCols == 1 ? vw - 1 : vw; }

// Rank 0's bins where v3 and the radix bodies run the paired configuration
// at (wc, vh), else 0.
inline int pair_bins(int wc, int vh, int splits, bool kara = false) {
  return blocks_per_cta(wc, vh, splits) > 1 || !wide(wc, splits, kara) ? 0 : pair_half(wc, splits, kara);
}

inline int cluster_of(int wc, int vh, int splits, bool kara = false) {
  return pair_bins(wc, vh, splits, kara) ? kPair : 1;
}

inline int tile_rows(int wc, int vh, int splits, bool kara = false) {
  return blocks_per_cta(wc, vh, splits) > 1 || !wide(wc, splits, kara) || pair_bins(wc, vh, splits, kara) ? 64
                                                                                                           : 32;
}

inline long long smem_bytes(int wc, int vh, int splits, bool kara = false) {
  const int g = blocks_per_cta(wc, vh, splits);
  if (g > 1) return stacked_smem_bytes(wc, g, kernels_per_cta(wc, vh, splits), splits);
  const int half = pair_bins(wc, vh, splits, kara);
  if (half) return pair_smem_bytes(half, splits, kara);
  return tile_smem_bytes(wide(wc, splits, kara) ? 32 : 64, wc, splits, kara);
}

// The CTA's place: image bb, block (bi, bj), row chunk rc, kernel ni; a
// stacked CTA holds `count` blocks from (bi, bj) on in row-major block
// order (count is 1 otherwise).
struct Cell {
  long long bb;
  int bi, bj, rc, ni, count;
};

// What an epilogue needs of the launch geometry.
struct OutGeom {
  int n, nbh, nbw, row_chunks, vh, vw, out_h, out_w;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// ---- the 64-row W stage's ring: mbarriers and TMA bulk copies ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// The CTA's dynamic shared memory, bytes.
__device__ __forceinline__ uint32_t dyn_smem_bytes() {
  uint32_t r;
  asm("mov.u32 %0, %%dynamic_smem_size;\n" : "=r"(r));
  return r;
}
// The barriers and copies below take shared-memory addresses (smem_u32).
__device__ __forceinline__ void mbar_init(uint32_t b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(b), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_inval(uint32_t b) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(b) : "memory");
}
// This thread's arrival at b, which then expects `bytes` more of copies.
__device__ __forceinline__ void mbar_expect_tx(uint32_t b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(b) : "memory");
}
// Wait until the phase of b with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t b, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(b),
      "r"(parity)
      : "memory");
}
// `bytes` from global src to shared dst by the TMA, completing on b.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// ---- the paired configuration's cluster: distributed shared memory ----
// The address in the cluster's shared window of shared address a in the
// shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
// 32 bits at a cluster shared address (volatile: never moved across a
// cluster barrier).
__device__ __forceinline__ uint32_t ld_cluster(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared::cluster.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ double ld_cluster_f64(uint32_t a) {
  double v;
  asm volatile("ld.shared::cluster.f64 %0, [%1];\n" : "=d"(v) : "r"(a));
  return v;
}
// Every thread of the cluster's CTAs: this thread's shared-memory writes
// before it are visible to the cluster's threads after their wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// d += a b: a 16 x 16 A fragment and a 16 x 8 B fragment of bf16 values
// (a register holds two: the lower half the first), fp32 accumulators; the
// layouts are mma.m16n8k16's (g = lane / 4, t = lane % 4): a[0] row g,
// columns 2 t, 2 t + 1; a[1] row g + 8; a[2], a[3] the same at columns
// 2 t + 8, 2 t + 9; b[0] rows 2 t, 2 t + 1 of column g, b[1] rows 2 t + 8,
// 2 t + 9.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// x and y rounded to bf16 (bf16r) and packed, x in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  return (bf16r(x) >> 16) | (bf16r(y) & 0xFFFF0000u);
}

template <class TS, int ROWS, bool STACKED, int SPLITS, int BODY, class Epi, bool KARA, bool PAIRED>
__global__ void __launch_bounds__(kThreads, 1) block_conv_kernel(
    const TS* __restrict__ d_re, const TS* __restrict__ d_im,
    const TS* __restrict__ k_re, const TS* __restrict__ k_im,
    const float* __restrict__ gt_re, const float* __restrict__ gt_im,
    const float* __restrict__ g_pad, const float* __restrict__ m_tc, RadixOps rx,
    typename Epi::Out out, int nbh, int nbw, int f, int n, int lh, int wc,
    int vh, int vw, int out_h, int out_w, int row_chunks,
    int group, int kpc, int stages, int ktile) {
  constexpr int MT = ROWS / 32;  // 16-row mma tiles of a warp
  constexpr int RW = ROWS / 2;   // rows of a warp
  using St = Stage<ROWS, SPLITS>;
  constexpr int P = St::kP;      // TF32 pieces of an operand
  // 6xTF32 sums its small terms apart from the main term (see Precision).
  constexpr bool kApart = SPLITS == 6;
  constexpr bool kDif = dif_body(BODY);
  static_assert(!PAIRED || ((BODY == kV3 || radix_body(BODY)) && ROWS == 64 && !STACKED),
                "the pair is v3's and the radix bodies', of 64-row CTAs");
  extern __shared__ __align__(16) float smem[];
  // PAIRED: this CTA's rank in its cluster, and its X's bins (pair_half):
  // rank 0 holds bins 0 .. half - 1, rank 1 half .. wc - 2, each padded to
  // half; the Nyquist bin wc - 1 is the sliver's.
  const int crank = PAIRED ? static_cast<int>(blockIdx.x % kPair) : 0;
  const int wc_pad = PAIRED ? pair_half(wc, SPLITS, KARA) : padded_bins(wc);
  const int xs = 2 * wc_pad + 4;
  float* x_s = smem;                   // [ROWS][xs]  X: Xr at bins 0.., Xi at wc_pad..
  float* stage = x_s + (STACKED ? kpc : 1) * ROWS * xs;  // staging, reused by both stages
  float* sliver = stage + stage_all(ROWS, SPLITS, KARA);  // PAIRED: [Xn re 64][Xn im 64][partial sums 64 doubles]
  // The DIF stage's half period W/2 and quarter; its H stage stores X's
  // bins permuted, [even | odd | Nyquist] (xcol), and v5x's stops at W/2.
  // PAIRED: each rank's W/4 bins [even | odd] (xq: where its odd bins
  // start), the Nyquist bin apart in the sliver.
  const int l2 = wc - 1, l4 = l2 / 2;
  const int hb_pad = BODY == kV5X && !PAIRED ? l2 : wc_pad;
  const int xq = PAIRED ? wc_pad / 2 : l4;
  auto xcol = [&](int v) { return kDif && (PAIRED || v < l2) ? (v & 1) * xq + (v >> 1) : v; };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;  // fragment row (A, C) / column (B)
  const int t4 = lane & 3;   // fragment column (A) / row (B)
  const int wm = warp >> 2;  // the warp's rows wm * RW ..
  const int wn = warp & 3;   // and columns wn * 32 .. of a pass

  Cell cell_at;
  int kernels_at = 1;  // the stacked CTA's kernels (cell_at.ni on)
  int r0 = 0;
  // The window rows of X's local rows and the rows the chunk owns: a radix
  // chunk's (radix_segs); the others' are r0.. in order, masked by the
  // epilogue alone.
  Segs sg{0, RW, INT_MAX, INT_MAX};
  if constexpr (!STACKED) {
  // S^T: the pieces of re, then of im (then, Karatsuba, of re + im); G
  // chunk: the same planes, then the pieces of -Gi at 64 rows (Karatsuba:
  // of Gr + Gi at 64 and 32 rows) (plane c * P + k: component c, piece k).
  // 64 rows: [plane][bins or rows / 8][kUK / 4][8][4] (core matrices, read
  // by wgmma); 32 rows: [plane][bins or rows][kGS].
  constexpr bool kWG = ROWS == 64;
  constexpr int kSP = kWG ? kCols * kUK : kCols * kGS;  // floats of an S^T plane
  constexpr int kGP = kWG ? ROWS * kUK : ROWS * kGS;    // floats of a G plane
  float* s_st = stage;
  float* g_st = s_st + s_planes(KARA) * P * kSP;

  // Kernel index fastest, then the row chunk, then the cell (b, i, j).
  long long bid = PAIRED ? blockIdx.x / kPair : blockIdx.x;
  const int ni = static_cast<int>(bid % n);
  bid /= n;
  const int rc = static_cast<int>(bid % row_chunks);
  const long long cell = bid / row_chunks;
  const int bj = static_cast<int>(cell % nbw);
  const int bi = static_cast<int>((cell / nbw) % nbh);
  const long long bb = cell / (static_cast<long long>(nbw) * nbh);
  r0 = rc * ROWS;
  // (a pair's ranks write a pyramid entry each: chunk rc kPair + rank)
  cell_at = Cell{bb, bi, bj, PAIRED ? rc * kPair + crank : rc, ni, 1};
  // A radix body's chunk (radix_segs): a pair chunk (rc < its count)
  // holds x[v'] at local rows k and x[v' + M] at RW + k for v' = p0 + k; a
  // single chunk x[v' + M] for v' = (rc - npc) ROWS + k at local row k.
  const int m_h = lh / 2, w0 = lh - vh;
  const int npc = radix_body(BODY) ? pair_chunks(lh, vh, ROWS) : 0;
  const bool pair = radix_body(BODY) && rc < npc;
  const int p0 = w0 + rc * RW;
  if constexpr (radix_body(BODY)) sg = radix_segs(rc, lh, vh, ROWS);

  const long long plane = static_cast<long long>(lh) * wc;
  const long long dcell = (bb * nbh + bi) * nbw + bj;  // the block's cell
  const TS* dr_c = d_re + dcell * f * plane;
  const TS* di_c = d_im + dcell * f * plane;
  const TS* kr_c = k_re + static_cast<long long>(ni) * f * plane;
  const TS* ki_c = k_im + static_cast<long long>(ni) * f * plane;
  const int gr_n = g_rows(vh), gc_n = g_cols(lh);

  // This thread's S elements of a chunk: element q is spectrum row
  // s_u(q) and bin s_v(q) of the chunk; a warp's 32 lanes hold 8 bins x 4
  // rows, so their S^T stores hit 32 distinct banks.
  auto s_u = [&](int q) { return 4 * ((q * 8 + warp) >> 4) + (lane >> 3); };
  auto s_v = [&](int q) { return 8 * ((q * 8 + warp) & 15) + (lane & 7); };
  // Channel ff of this thread's S elements of the chunk at (u0, c0): D and K
  // (zeros at the columns past a pass of `w` bins, a radix single chunk's).
  float dk[St::kPerS][4];
  auto load_dk = [&](int c0, int u0, int ff, int w) {
#pragma unroll
    for (int q = 0; q < St::kPerS; ++q) {
      const int u = u0 + s_u(q);
      const int v = c0 + s_v(q);
      const bool ok = u < lh && v < wc && s_v(q) < w;
      const long long off = ok ? static_cast<long long>(u) * wc + v + ff * plane : 0;
      dk[q][0] = ok ? to_f32(dr_c[off]) : 0.f;
      dk[q][1] = ok ? to_f32(di_c[off]) : 0.f;
      dk[q][2] = ok ? to_f32(kr_c[off]) : 0.f;
      dk[q][3] = ok ? to_f32(ki_c[off]) : 0.f;
    }
  };
  // S = sum_f K D at (u0, c0) into sv, over a pass of `w` bins: channel 0
  // was prefetched into dk, the rest load here.
  auto mac = [&](int c0, int u0, float (&sv)[St::kPerS][2], int w) {
#pragma unroll
    for (int q = 0; q < St::kPerS; ++q) {
      sv[q][0] = fmaf(dk[q][2], dk[q][0], -dk[q][3] * dk[q][1]);
      sv[q][1] = fmaf(dk[q][2], dk[q][1], dk[q][3] * dk[q][0]);
    }
    for (int ff = 1; ff < f; ++ff) {
      load_dk(c0, u0, ff, w);
#pragma unroll
      for (int q = 0; q < St::kPerS; ++q) {
        sv[q][0] = fmaf(dk[q][2], dk[q][0], fmaf(-dk[q][3], dk[q][1], sv[q][0]));
        sv[q][1] = fmaf(dk[q][2], dk[q][1], fmaf(dk[q][3], dk[q][0], sv[q][1]));
      }
    }
  };

  // Stage sv as S^T's planes (the tier's pieces of re, then of im, then,
  // Karatsuba, of re + im: summed in fp32 and rounded once, as the other
  // planes) at k = u, or, for the radix H stage, with the chunk's even rows
  // at k 0..7 and its odd rows at 8..15.
  auto stage_s = [&](const float (&sv)[St::kPerS][2], bool even_odd) {
#pragma unroll
    for (int q = 0; q < St::kPerS; ++q) {
      const int v = s_v(q), u = s_u(q);
      const int k = even_odd ? (u & 1) * 8 + (u >> 1) : u;
      float* p = s_st + (kWG ? ((v >> 3) * (kUK / 4) + (k >> 2)) * kCore + (v & 7) * 4 + (k & 3)
                             : v * kGS + k);  // S^T[v][k]
#pragma unroll
      for (int c = 0; c < s_planes(KARA); ++c) {
        uint32_t pc[P];
        pieces<SPLITS>(c < 2 ? sv[q][c] : sv[q][0] + sv[q][1], pc);
#pragma unroll
        for (int k2 = 0; k2 < P; ++k2) p[(c * P + k2) * kSP] = __uint_as_float(pc[k2]);
      }
    }
  };
  // PAIRED: this rank's bins of the spectra, pbin0 .. pbin0 + pbins - 1
  // (X's local bins 0.., zeros past pbins), and the Nyquist bin's S, which
  // the last kUK threads form a chunk in the rank's first pass (a
  // spectrum row each, its channels in order as the MAC's) and park in the
  // sliver (s_nq).
  const int pbin0 = crank * wc_pad;
  const int pbins = PAIRED && crank ? wc - 1 - wc_pad : wc_pad;
  float* s_nq = sliver + 2 * ROWS;  // v3: (re, im, re + im) a spectrum row; v4: (re, im)
  float nq[4];  // channel 0 of D and K at the Nyquist bin (re, im; re, im): the last kUK threads'
  const int nq_u = tid - (kThreads - kUK);  // this thread's spectrum row of a chunk (< 0: none)
  auto nq_load = [&](int u0, int ff, float (&d)[4]) {
    const int u = u0 + nq_u;
    const bool ok = nq_u >= 0 && u < lh;
    const long long off = ok ? static_cast<long long>(u) * wc + wc - 1 + ff * plane : 0;
    d[0] = ok ? to_f32(dr_c[off]) : 0.f;
    d[1] = ok ? to_f32(di_c[off]) : 0.f;
    d[2] = ok ? to_f32(kr_c[off]) : 0.f;
    d[3] = ok ? to_f32(ki_c[off]) : 0.f;
  };
  // The Nyquist bin's S at this thread's row of the chunk at u0: channel 0
  // was prefetched into nq, the rest load here.
  auto nq_mac = [&](int u0, float (&snq)[2]) {
    snq[0] = fmaf(nq[2], nq[0], -nq[3] * nq[1]);
    snq[1] = fmaf(nq[2], nq[1], nq[3] * nq[0]);
    for (int ff = 1; ff < f; ++ff) {
      nq_load(u0, ff, nq);
      snq[0] = fmaf(nq[2], nq[0], fmaf(-nq[3], nq[1], snq[0]));
      snq[1] = fmaf(nq[2], nq[1], fmaf(nq[3], nq[0], snq[1]));
    }
  };
  if constexpr (radix_body(BODY)) {
  // ---- radix-2 H stage (v4): E = U S_even and O = U S_odd at NV = ROWS / 2
  // v' a half, summed over the spectrum rows, then combined in fp32 with
  // the twiddle t, as the JAX kernel computes every window row. A pair
  // chunk (one half, v' = p0..) gives x[v'] = E + t O at local row k and
  // x[v' + M] = E - t O at NV + k; its warps split a pass's kCols bins. A
  // single chunk (two halves, v' = v0.. and v0 + NV..) gives x[v' + M] = E
  // - t O alone, at local row h NV + k of half h; each half takes half of
  // the warps (64 rows: a warpgroup), over passes of kCols / 2 bins, so that
  // a thread holds what it holds in a pair chunk. KARA: the three products
  // of csub, t1 = Sr Ur, t2 = Si Ui, t3 = (Sr + Si)(Ur + Ui), for E and O. ----
  constexpr int NV = RW;
  constexpr int kUP = kGP;  // floats of a U plane: ROWS rows, as G's
  // U's planes: re, im, then -im (64 rows: Er is a sum) or, Karatsuba,
  // re + im; each as the tier's pieces. The operand table holds re, im and
  // re + im (RadixOps::u_pad); kUL of them are read, kUQ float4s a thread
  // (2 only for a single chunk of the Karatsuba form at 64 rows).
  constexpr int kUC = kWG || KARA ? 3 : 2;
  constexpr int kUL = KARA ? 3 : 2;
  constexpr int kUQ = (2 * kUL * ROWS + kThreads - 1) / kThreads;
  float* u_st = g_st;
  const int ur_n = u_rows(m_h), uc_n = g_cols(m_h);
  const int nu = pair ? NV : 2 * NV;                // the chunk's v'
  const int v0 = pair ? p0 : (rc - npc) * ROWS;     // and the first of them
  const int half = pair ? 0 : warp >> 2;            // this warp's half
  // This thread's U values of a chunk (columns j0 = u0 / 2..): item e =
  // tid + q kThreads is (plane, row, half of 4 columns), 4 floats.
  float4 uv[kUQ];
#pragma unroll
  for (int q = 0; q < kUQ; ++q) uv[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  auto u_item = [&](int q, int& pl, int& row, int& h) {
    const int e = tid + q * kThreads;
    pl = e / (2 * nu);
    row = (e >> 1) % nu;
    h = e & 1;
    return e < 2 * kUL * nu;
  };
  auto load_u = [&](int j0) {
#pragma unroll
    for (int q = 0; q < kUQ; ++q) {
      int pl, row, h;
      if (u_item(q, pl, row, h) && v0 + row < m_h)
        uv[q] = *reinterpret_cast<const float4*>(rx.u_pad + (static_cast<long long>(pl) * ur_n + v0 + row) * uc_n +
                                                 j0 + 4 * h);
    }
  };
  // The twiddle at v' (zero past M: rows no chunk owns).
  auto tw_at = [&](int vp, float& twr, float& twi) {
    twr = vp < m_h ? rx.tw[vp] : 0.f;
    twi = vp < m_h ? rx.tw[m_h + vp] : 0.f;
  };
  // v5's Nyquist term as the JAX kernel's VPU matvecs compute it: the
  // Nyquist bin's S unrounded, U as staged (the sum of its pieces), fp32
  // products and sums, the 4-product form whatever the H stage's. X's row
  // padding (4 floats a row, which the W stage does not read) holds it:
  // each chunk parks its Nyquist S there (row j: E's re, im, then O's, of
  // spectrum rows 2 j, 2 j + 1), thread k < nu sums its v''s Re E, Re O and
  // Im O in rows 8.. (ny: 3 floats a v', kept out of the registers the
  // products need), and after the pass X's Nyquist bin gets E +- t O.
  float* ny_s = x_s + 2 * wc_pad;
  auto ny = [&](int m) -> float& {
    const int e = 3 * tid + m;
    return ny_s[(8 + (e >> 2)) * xs + (e & 3)];
  };
  const int pass_w = pair ? kCols : kCols / 2;  // a pass's bins
  for (int c0 = 0; c0 < hb_pad; c0 += pass_w) {
    // E and O (re, im) at this warp's bins x its half's v' (E^T, O^T): 64
    // rows, the warpgroup's 64 bins x 32 v' (wgmma m64n32); 32 rows, the
    // warp's 16 bins x 16 v' (two mma.sync n-tiles).
    constexpr int XN = kWG ? 4 : 2;
    float er[XN][4], ei[XN][4], or_[XN][4], oi[XN][4];
#pragma unroll
    for (int b = 0; b < XN; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) er[b][c] = ei[b][c] = or_[b][c] = oi[b][c] = 0.f;
    // the tile's first bin (and its first column in the staged S^T)
    const int col0 = kWG ? (pair ? (warp >> 2) * 64 : 0) : (pair ? warp : warp & 3) * 16;
    const int bin0 = c0 + col0;
    const bool live = bin0 < hb_pad;
    const bool nyq_pass = BODY == kV5 && !PAIRED && c0 <= l2 && l2 < c0 + pass_w;
    // the pass's first bin in the spectra and its bins there (PAIRED: this
    // rank's), and whether it sums the Nyquist bin's E and O (PAIRED: the
    // rank's first pass; v5x's H stage skips that bin)
    const int cg = PAIRED ? pbin0 + c0 : c0;
    const int cw = PAIRED ? min(pass_w, pbins - c0) : pass_w;
    const bool nyq_pair = PAIRED && BODY != kV5X && c0 == 0;
    load_dk(cg, 0, 0, cw);
    load_u(0);
    for (int u0 = 0; u0 < lh; u0 += kUK) {
      float sv[St::kPerS][2];
      mac(cg, u0, sv, cw);
      float snq[2] = {0.f, 0.f};  // the Nyquist bin's S at this thread's row
      if (nyq_pair && nq_u >= 0) {
        // (channel 0 loaded here, not ahead: held through the products, it
        // spilled the Karatsuba form's registers at 6xTF32)
        nq_load(u0, 0, nq);
        nq_mac(u0, snq);
      }
      __syncthreads();  // the previous chunk's products are done with staging
      stage_s(sv, true);
      if (nyq_pair && nq_u >= 0) {
        // v4: rounded as the staged S is; v5: unrounded, as the JAX
        // kernel's VPU term takes it. s_nq's float4 j holds spectrum rows
        // 2 j (E's) and 2 j + 1 (O's), re and im
        constexpr bool kRound = SPLITS == kBF16IO && BODY == kV4;
        s_nq[2 * nq_u] = kRound ? __uint_as_float(bf16r(snq[0])) : snq[0];
        s_nq[2 * nq_u + 1] = kRound ? __uint_as_float(bf16r(snq[1])) : snq[1];
      }
#pragma unroll
      for (int q = 0; q < kUQ; ++q) {
        int pl, row, h;
        if (!u_item(q, pl, row, h)) continue;
        const float x[4] = {uv[q].x, uv[q].y, uv[q].z, uv[q].w};
        uint32_t pc[4][P];
#pragma unroll
        for (int i = 0; i < 4; ++i) pieces<SPLITS>(x[i], pc[i]);
        float* pu = u_st + pl * P * kUP +
                    (kWG ? ((row >> 3) * (kUK / 4) + h) * kCore + (row & 7) * 4 : row * kGS + 4 * h);
#pragma unroll
        for (int k2 = 0; k2 < P; ++k2) {
          *reinterpret_cast<uint4*>(pu + k2 * kUP) = make_uint4(pc[0][k2], pc[1][k2], pc[2][k2], pc[3][k2]);
          if (kWG && !KARA && pl == 1)  // -Ui, for Er = Sr Ur + Si (-Ui)
            *reinterpret_cast<uint4*>(pu + (P + k2) * kUP) =
                make_uint4(pc[0][k2] ^ 0x80000000u, pc[1][k2] ^ 0x80000000u, pc[2][k2] ^ 0x80000000u,
                           pc[3][k2] ^ 0x80000000u);
        }
      }
      if (nyq_pass) {
#pragma unroll
        for (int q = 0; q < St::kPerS; ++q)
          if (c0 + s_v(q) == l2) {
            const int u = s_u(q);
            *reinterpret_cast<float2*>(ny_s + (u >> 1) * xs + 2 * (u & 1)) = make_float2(sv[q][0], sv[q][1]);
          }
      }
      if (kWG) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (u0 + kUK < lh) {  // in flight during the products
        load_dk(cg, u0 + kUK, 0, cw);
        load_u((u0 + kUK) / 2);
      }
      if (nyq_pair && tid < nu) {
        // v' = v0 + tid: E and O (re, im) at the Nyquist bin, U as staged
        // (the sum of its pieces), the 4-product form; the sums in X's row
        // padding of local row tid
        float* a_s = x_s + tid * xs + 2 * wc_pad;
        float a[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) a[m] = u0 == 0 ? 0.f : a_s[m];
#pragma unroll 1
        for (int j = 0; j < kUK / 2; ++j) {
          const float* pu = u_st + ((tid >> 3) * (kUK / 4) + (j >> 2)) * kCore + (tid & 7) * 4 + (j & 3);
          float ur = 0.f, ui = 0.f;
#pragma unroll
          for (int k2 = 0; k2 < P; ++k2) {
            ur += pu[k2 * kUP];
            ui += pu[(P + k2) * kUP];
          }
          const float4 s = *reinterpret_cast<const float4*>(s_nq + 4 * j);  // Se re, im; So re, im
          a[0] = fmaf(-ui, s.y, fmaf(ur, s.x, a[0]));
          a[1] = fmaf(ui, s.x, fmaf(ur, s.y, a[1]));
          a[2] = fmaf(-ui, s.w, fmaf(ur, s.z, a[2]));
          a[3] = fmaf(ui, s.z, fmaf(ur, s.w, a[3]));
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) a_s[m] = a[m];
      }
      if (nyq_pass && tid < nu) {
        float a[3];
#pragma unroll
        for (int m = 0; m < 3; ++m) a[m] = u0 == 0 ? 0.f : ny(m);
#pragma unroll 1  // unrolled, its loads ran ahead and spilled the products' registers
        for (int j = 0; j < kUK / 2; ++j) {
          // U at (v0 + tid, u0 / 2 + j): the sum of its staged pieces (its
          // bf16 value at kBF16IO, fp32 within 2^-22 at 3xTF32)
          const float* pu = u_st + (kWG ? ((tid >> 3) * (kUK / 4) + (j >> 2)) * kCore + (tid & 7) * 4 + (j & 3)
                                        : tid * kGS + j);
          float ur = 0.f, ui = 0.f;
#pragma unroll
          for (int k2 = 0; k2 < P; ++k2) {
            ur += pu[k2 * kUP];
            ui += pu[(P + k2) * kUP];
          }
          const float4 s = *reinterpret_cast<const float4*>(ny_s + j * xs);  // Se re, im; So re, im
          a[0] = fmaf(-ui, s.y, fmaf(ur, s.x, a[0]));
          a[1] = fmaf(-ui, s.w, fmaf(ur, s.z, a[1]));
          a[2] = fmaf(ui, s.z, fmaf(ur, s.w, a[2]));
        }
#pragma unroll
        for (int m = 0; m < 3; ++m) ny(m) = a[m];
      }
      if (!live) continue;
      if constexpr (kWG) {
        // A = S^T's planes at the warpgroup's 64 bins (k-step 0: the even
        // rows, 1: the odd), B = U's planes at its half's NV rows; summed
        // on the tensor cores per chunk, then added in IEEE fp32.
        const float* sw = s_st + (col0 >> 3) * (kUK / 4) * kCore;
        auto sa = [&](int pl, int ks) {
          return smem_desc(sw + pl * kSP + 2 * ks * kCore, 4 * kCore, 4 * (kUK / 4) * kCore);
        };
        auto ub = [&](int pl) {
          return smem_desc(u_st + pl * kUP + half * NV * kUK, 4 * kCore, 4 * (kUK / 4) * kCore);
        };
        constexpr int kQ0 = first_product(SPLITS);
        constexpr int kPhases = kApart ? 2 : 1;
        if constexpr (KARA) {
          // component c: t = S^T plane set c times U plane set c, for E and
          // for O, folded into them with the signs of (t1, t2, t3): Re +=
          // t1 - t2, Im += t3 - t1 - t2. Not unrolled (see v3's).
#pragma unroll 1
          for (int c = 0; c < 3; ++c) {
            float te[4][4], to[4][4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) te[j][i] = to[j][i] = 0.f;
            fence_regs(te);
            fence_regs(to);
            wgmma_fence();
#pragma unroll
            for (int ph = 0; ph < kPhases; ++ph) {
              const int qa = ph == 0 ? kQ0 : kMainProduct;
              const int qb = kApart && ph == 0 ? kMainProduct : 6;
#pragma unroll
              for (int q = qa; q < qb; ++q) {
                wgmma_tf32_ss32(te, sa(c * P + prod_a(q), 0), ub(c * P + prod_b(q)));
                wgmma_tf32_ss32(to, sa(c * P + prod_a(q), 1), ub(c * P + prod_b(q)));
              }
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(te);
            fence_regs(to);
            const float sr = c == 0 ? 1.f : c == 1 ? -1.f : 0.f;
            const float si = c == 2 ? 1.f : -1.f;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                er[j][i] = fmaf(sr, te[j][i], er[j][i]);
                ei[j][i] = fmaf(si, te[j][i], ei[j][i]);
                or_[j][i] = fmaf(sr, to[j][i], or_[j][i]);
                oi[j][i] = fmaf(si, to[j][i], oi[j][i]);
              }
          }
        } else {
          float te[2][4][4], to[2][4][4];  // [re, im] of E, O
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) te[c][j][i] = to[c][j][i] = 0.f;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            fence_regs(te[c]);
            fence_regs(to[c]);
          }
          wgmma_fence();
#pragma unroll
          for (int ph = 0; ph < kPhases; ++ph) {
            const int qa = ph == 0 ? kQ0 : kMainProduct;
            const int qb = kApart && ph == 0 ? kMainProduct : 6;
#pragma unroll
            for (int q = qa; q < qb; ++q) {
              // planes: S^T re 0.., im P..; U re 0.., im P.., -im 2P..
              wgmma_tf32_ss32(te[0], sa(prod_a(q), 0), ub(prod_b(q)));              // Sr Ur
              wgmma_tf32_ss32(te[0], sa(P + prod_a(q), 0), ub(2 * P + prod_b(q)));  // Si (-Ui)
              wgmma_tf32_ss32(te[1], sa(prod_a(q), 0), ub(P + prod_b(q)));          // Sr Ui
              wgmma_tf32_ss32(te[1], sa(P + prod_a(q), 0), ub(prod_b(q)));          // Si Ur
              wgmma_tf32_ss32(to[0], sa(prod_a(q), 1), ub(prod_b(q)));
              wgmma_tf32_ss32(to[0], sa(P + prod_a(q), 1), ub(2 * P + prod_b(q)));
              wgmma_tf32_ss32(to[1], sa(prod_a(q), 1), ub(P + prod_b(q)));
              wgmma_tf32_ss32(to[1], sa(P + prod_a(q), 1), ub(prod_b(q)));
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            fence_regs(te[c]);
            fence_regs(to[c]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            add4(er[j], te[0][j]);
            add4(ei[j], te[1][j]);
            add4(or_[j], to[0][j]);
            add4(oi[j], to[1][j]);
          }
        }
      } else {
        // A = S^T's fragments at the warp's 16 bins, B = U's at its half's
        // 16 v' (two n-tiles); each k-step's products summed on the tensor
        // cores.
        constexpr int kC = KARA ? 3 : 2;
        uint32_t ub2[2][kC][P][2];  // [n-tile][component][piece]
#pragma unroll
        for (int pl = 0; pl < kC * P; ++pl) {
          uint32_t r[4];
          ldsm4(r, u_st + pl * kUP + half * NV * kGS + b_lane(lane, kGS));
          ub2[0][pl / P][pl % P][0] = r[0];
          ub2[0][pl / P][pl % P][1] = r[1];
          ub2[1][pl / P][pl % P][0] = r[2];
          ub2[1][pl / P][pl % P][1] = r[3];
        }
        auto kstep = [&](int ks, float (&xr)[XN][4], float (&xi)[XN][4]) {
          uint32_t sa2[kC][P][4];
#pragma unroll
          for (int pl = 0; pl < kC * P; ++pl)
            ldsm4(sa2[pl / P][pl % P], s_st + pl * kSP + col0 * kGS + ks * 8 + a_lane(lane, kGS));
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if constexpr (KARA) {
              float t1[4] = {0.f, 0.f, 0.f, 0.f}, t2[4] = {0.f, 0.f, 0.f, 0.f};
              float t3[4] = {0.f, 0.f, 0.f, 0.f};
              mma_n<SPLITS>(t1, sa2[0], ub2[j][0]);
              mma_n<SPLITS>(t2, sa2[1], ub2[j][1]);
              mma_n<SPLITS>(t3, sa2[2], ub2[j][2]);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                xr[j][i] += t1[i] - t2[i];
                xi[j][i] += t3[i] - (t1[i] + t2[i]);
              }
            } else {
              float tr[4] = {0.f, 0.f, 0.f, 0.f}, ts[4] = {0.f, 0.f, 0.f, 0.f};
              float ti[4] = {0.f, 0.f, 0.f, 0.f};
              mma_n<SPLITS>(tr, sa2[0], ub2[j][0]);                       // Sr Ur
              mma_n<SPLITS>(ts, sa2[1], ub2[j][1]);                       // Si Ui
              mma_n2<SPLITS>(ti, sa2[0], ub2[j][1], sa2[1], ub2[j][0]);  // Sr Ui + Si Ur
#pragma unroll
              for (int i = 0; i < 4; ++i) xr[j][i] += tr[i] - ts[i];
              add4(xi[j], ti);
            }
          }
        };
        kstep(0, er, ei);
        kstep(1, or_, oi);
      }
    }
    // The combine: a pair's x[v'] = E + t O at local row k and x[v' + M] =
    // E - t O at NV + k; a single chunk's x[v' + M] at half NV + k. Bins at
    // or past hb_pad are not stored (bins past wc hold zeros, S was zero
    // there).
    if (live) {
      const int row_b = bin0 + (kWG ? (warp & 3) * 16 : 0) + g8;  // this thread's bins: row_b, row_b + 8
      const int vh0 = v0 + half * NV;  // the half's first v'
#pragma unroll
      for (int j = 0; j < XN; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int bin = row_b + 8 * (i >> 1);
          const int k = 8 * j + 2 * t4 + (i & 1);
          if (bin >= hb_pad) continue;
          float twr, twi;
          tw_at(vh0 + k, twr, twi);
          const float t_r = twr * or_[j][i] - twi * oi[j][i];
          const float t_i = twr * oi[j][i] + twi * or_[j][i];
          if (pair) {
            float* pa = x_s + k * xs + xcol(bin);
            pa[0] = er[j][i] + t_r;
            pa[wc_pad] = ei[j][i] + t_i;
          }
          float* pb = x_s + ((pair ? 1 : half) * NV + k) * xs + xcol(bin);
          pb[0] = er[j][i] - t_r;
          pb[wc_pad] = ei[j][i] - t_i;
        }
    }
    if (nyq_pass) {
      __syncthreads();  // the combine is done with X's Nyquist bin
      if (tid < nu) {
        float twr, twi;
        tw_at(v0 + tid, twr, twi);
        const float t_r = twr * ny(1) - twi * ny(2);
        if (pair) {
          x_s[tid * xs + l2] = ny(0) + t_r;
          x_s[(NV + tid) * xs + l2] = ny(0) - t_r;
        } else {
          x_s[tid * xs + l2] = ny(0) - t_r;
        }
      }
    }
    if (nyq_pair && tid < nu) {
      // the Nyquist bin's x at the local rows of v' = v0 + tid (a pair's
      // tid and NV + tid, a single chunk's tid), re then im, in the sliver
      const float* a = x_s + tid * xs + 2 * wc_pad;
      float twr, twi;
      tw_at(v0 + tid, twr, twi);
      const float t_r = twr * a[2] - twi * a[3];
      const float t_i = twr * a[3] + twi * a[2];
      sliver[tid] = pair ? a[0] + t_r : a[0] - t_r;
      sliver[ROWS + tid] = pair ? a[1] + t_i : a[1] - t_i;
      if (pair) {
        sliver[NV + tid] = a[0] - t_r;
        sliver[ROWS + NV + tid] = a[1] - t_i;
      }
    }
  }
  } else {
  // ---- H stage: X[r, v] = sum_u G[r0 + r, u] S[u, v] ----
  // PAIRED: the Nyquist bin's X of each row, summed in fp32 in pass 0
  // beside the products (the sliver's S a chunk, G from this thread's
  // staging loads, gv): the 4-product form's re and im, or the Karatsuba
  // form's t1, t2, t3 (x_nq), four spectrum rows a thread, the row's four
  // threads added after the stage.
  float x_nq[3] = {0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < hb_pad; c0 += kCols) {
    // X's accumulators: 64 rows, a warpgroup's 64 x 64 tile (wgmma); 32
    // rows, a warp's 16 x 32 tile (mma.sync).
    constexpr int XM = kWG ? 1 : MT, XN = kWG ? 8 : 4;
    float xr[XM][XN][4], xi[XM][XN][4];
#pragma unroll
    for (int a = 0; a < XM; ++a)
#pragma unroll
      for (int b = 0; b < XN; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) xr[a][b][c] = xi[a][b][c] = 0.f;
    // The warp's 32 bins are either all below wc_pad or all past it
    // (mma.sync); the warpgroup's 64 bins start below it or are all past
    // it (wgmma).
    const bool live = kWG ? c0 + (warp >> 2) * 64 < hb_pad : c0 + wn * 32 < hb_pad;

    // G (re, im) for rows r0.., spectrum rows u0.. (zero-padded past vh
    // and lh), loaded a chunk ahead and split as it is staged. Karatsuba: a thread's
    // re and im at one position (tid < kGPos), and their sum staged beside.
    float4 gv[KARA ? 2 : St::kPerG];
    auto load_g = [&](int u0) {
      if constexpr (KARA) {
        const int row = tid / 4;
        if (tid < St::kGPos) {
#pragma unroll
          for (int pl = 0; pl < 2; ++pl)
            gv[pl] = *reinterpret_cast<const float4*>(
                g_pad + (static_cast<long long>(pl) * gr_n + r0 + row) * gc_n + u0 + 4 * (tid % 4));
        }
      } else {
#pragma unroll
        for (int q = 0; q < St::kPerG; ++q) {
          const int e = tid + q * kThreads;
          const int pl = e / (ROWS * 4);
          const int row = (e / 4) % ROWS;
          gv[q] = *reinterpret_cast<const float4*>(
              g_pad + (static_cast<long long>(pl) * gr_n + r0 + row) * gc_n + u0 + 4 * (e % 4));
        }
      }
    };
    // the pass's first bin in the spectra and its bins there (PAIRED: this
    // rank's)
    const int cg = PAIRED ? pbin0 + c0 : c0;
    const int cw = PAIRED ? min(kCols, pbins - c0) : kCols;
    const bool nyq = PAIRED && c0 == 0;  // the pass that sums the Nyquist bin's X
    load_dk(cg, 0, 0, cw);
    load_g(0);
    if (nyq) nq_load(0, 0, nq);
    for (int u0 = 0; u0 < lh; u0 += kUK) {
      float sv[St::kPerS][2];
      mac(cg, u0, sv, cw);
      float snq[2] = {0.f, 0.f};  // the Nyquist bin's S at this thread's row
      if (PAIRED && nyq && nq_u >= 0) nq_mac(u0, snq);
      __syncthreads();  // the previous chunk's products are done with staging
      stage_s(sv, false);
      if (nyq && nq_u >= 0) {
        // S rounded as the staged S is (kBF16IO; the Karatsuba sum before
        // its one rounding)
        float* p = s_nq + 3 * nq_u;
        if constexpr (SPLITS == kBF16IO) {
          p[0] = __uint_as_float(bf16r(snq[0]));
          p[1] = __uint_as_float(bf16r(snq[1]));
          p[2] = __uint_as_float(bf16r(snq[0] + snq[1]));
        } else {
          p[0] = snq[0];
          p[1] = snq[1];
          p[2] = snq[0] + snq[1];
        }
      }
      if constexpr (KARA) {
        if (tid < St::kGPos) {
          const int row = tid / 4;
          const float x[3][4] = {{gv[0].x, gv[0].y, gv[0].z, gv[0].w},
                                 {gv[1].x, gv[1].y, gv[1].z, gv[1].w},
                                 {gv[0].x + gv[1].x, gv[0].y + gv[1].y, gv[0].z + gv[1].z,
                                  gv[0].w + gv[1].w}};
#pragma unroll
          for (int pl = 0; pl < 3; ++pl) {
            uint32_t pc[4][P];
#pragma unroll
            for (int i = 0; i < 4; ++i) pieces<SPLITS>(x[pl][i], pc[i]);
            float* pg = g_st + pl * P * kGP +
                        (kWG ? ((row >> 3) * (kUK / 4) + (tid % 4)) * kCore + (row & 7) * 4
                             : row * kGS + 4 * (tid % 4));
#pragma unroll
            for (int k = 0; k < P; ++k)
              *reinterpret_cast<uint4*>(pg + k * kGP) = make_uint4(pc[0][k], pc[1][k], pc[2][k], pc[3][k]);
          }
        }
      } else {
#pragma unroll
      for (int q = 0; q < St::kPerG; ++q) {
        const int e = tid + q * kThreads;
        const int pl = e / (ROWS * 4);
        const int row = (e / 4) % ROWS;
        const float x[4] = {gv[q].x, gv[q].y, gv[q].z, gv[q].w};
        uint32_t pc[4][P];
#pragma unroll
        for (int i = 0; i < 4; ++i) pieces<SPLITS>(x[i], pc[i]);
        float* pg = g_st + pl * P * kGP +
                    (kWG ? ((row >> 3) * (kUK / 4) + (e % 4)) * kCore + (row & 7) * 4 : row * kGS + 4 * (e % 4));
#pragma unroll
        for (int k = 0; k < P; ++k) {
          *reinterpret_cast<uint4*>(pg + k * kGP) = make_uint4(pc[0][k], pc[1][k], pc[2][k], pc[3][k]);
          if (kWG && pl == 1)  // -Gi, for Xr = Gr Sr + (-Gi) Si
            *reinterpret_cast<uint4*>(pg + (P + k) * kGP) =
                make_uint4(pc[0][k] ^ 0x80000000u, pc[1][k] ^ 0x80000000u, pc[2][k] ^ 0x80000000u,
                           pc[3][k] ^ 0x80000000u);
        }
      }
      }
      // this thread's stores are visible to the tensor cores' reads
      if (kWG) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if constexpr (PAIRED) {
        if (nyq) {
        // the Nyquist bin's X at row tid / 4 over spectrum rows 4 (tid % 4)..
        // of the chunk: G from gv (re, im; exact, or rounded at kBF16IO)
        const float gr[4] = {gv[0].x, gv[0].y, gv[0].z, gv[0].w};
        const float gi[4] = {gv[1].x, gv[1].y, gv[1].z, gv[1].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* p = s_nq + 3 * (4 * (tid & 3) + i);
          if constexpr (KARA) {
            const float g3 = SPLITS == kBF16IO ? __uint_as_float(bf16r(gr[i] + gi[i])) : gr[i] + gi[i];
            x_nq[0] = fmaf(gr[i], p[0], x_nq[0]);
            x_nq[1] = fmaf(gi[i], p[1], x_nq[1]);
            x_nq[2] = fmaf(g3, p[2], x_nq[2]);
          } else {
            x_nq[0] = fmaf(gr[i], p[0], fmaf(-gi[i], p[1], x_nq[0]));
            x_nq[1] = fmaf(gr[i], p[1], fmaf(gi[i], p[0], x_nq[1]));
          }
        }
        }
      }
      if (u0 + kUK < lh) {  // in flight during the products
        load_dk(cg, u0 + kUK, 0, cw);
        load_g(u0 + kUK);
        if (nyq) nq_load(u0 + kUK, 0, nq);
      }
      if constexpr (kWG) {
        if constexpr (KARA) {
          if (!live) continue;
          // Karatsuba: t1 = Gr Sr, t2 = Gi Si and t3 = (Gr + Gi)(Sr + Si),
          // each summed on the tensor cores into the one tile t and folded
          // into X in IEEE fp32 before the next (Xr += t1 - t2, Xi += t3 -
          // t1 - t2): three products for the 4-product form's four. The
          // products' loop is not unrolled: unrolled (with two tiles, or
          // one), the 3- and 6xTF32 entries spilled.
          const float* sw = s_st + (warp >> 2) * 8 * (kUK / 4) * kCore;
          float t[8][4];
          constexpr int kQ0 = first_product(SPLITS);
          constexpr int kPhases = kApart ? 2 : 1;
          // t = the products of A plane set c and B plane set c (component
          // c: planes c P..), in the tier's phases
#pragma unroll 1
          for (int c = 0; c < 3; ++c) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) t[j][i] = 0.f;
            fence_regs(t);
            // the component's first planes; a piece and k-step lie a fixed
            // number of 16-byte units past them
            const uint64_t a0 = smem_desc(g_st + c * P * kGP, 4 * kCore, 4 * (kUK / 4) * kCore);
            const uint64_t b0 = smem_desc(sw + c * P * kSP, 4 * kCore, 4 * (kUK / 4) * kCore);
            wgmma_fence();
#pragma unroll
            for (int ph = 0; ph < kPhases; ++ph) {
              const int q0 = ph == 0 ? kQ0 : kMainProduct;
              const int q1 = kApart && ph == 0 ? kMainProduct : 6;
#pragma unroll
              for (int ks = 0; ks < kUK / 8; ++ks)
#pragma unroll
                for (int q = q0; q < q1; ++q)
                  wgmma_tf32_ss(t, a0 + ((prod_a(q) * kGP + 2 * ks * kCore) >> 2),
                                b0 + ((prod_b(q) * kSP + 2 * ks * kCore) >> 2));
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(t);
            // t1: Xr += t, Xi -= t; t2: both -= t; t3: Xi += t (x + s t
            // with s = +-1 or 0 is the IEEE sum or difference)
            const float sr = c == 0 ? 1.f : c == 1 ? -1.f : 0.f;
            const float si = c == 2 ? 1.f : -1.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                xr[0][j][i] = fmaf(sr, t[j][i], xr[0][j][i]);
                xi[0][j][i] = fmaf(si, t[j][i], xi[0][j][i]);
              }
          }
        } else if (live) {
          // The warpgroup's 64 rows x 64 bins: A = G's planes, B = S^T's,
          // both read by wgmma from shared memory. The chunk's products are
          // summed on the tensor cores, then added to X in IEEE fp32.
          const float* sw = s_st + (warp >> 2) * 8 * (kUK / 4) * kCore;
          float tr[8][4], ti[8][4];
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) tr[j][i] = ti[j][i] = 0.f;
          fence_regs(tr);
          fence_regs(ti);
          wgmma_fence();
          // Phases of the chunk's products: 6xTF32 runs every small term
          // of the chunk first, then the main terms, so that the small
          // terms are summed while t is small; the other tiers run one
          // phase, each k-step's products in turn.
          constexpr int kQ0 = first_product(SPLITS);
          constexpr int kPhases = kApart ? 2 : 1;
#pragma unroll
          for (int ph = 0; ph < kPhases; ++ph) {
            const int q0 = ph == 0 ? kQ0 : kMainProduct;
            const int q1 = kApart && ph == 0 ? kMainProduct : 6;
#pragma unroll
            for (int ks = 0; ks < kUK / 8; ++ks) {
              auto ga = [&](int pl) {
                return smem_desc(g_st + pl * kGP + 2 * ks * kCore, 4 * kCore, 4 * (kUK / 4) * kCore);
              };
              auto sb = [&](int pl) {
                return smem_desc(sw + pl * kSP + 2 * ks * kCore, 4 * kCore, 4 * (kUK / 4) * kCore);
              };
              // planes: G re 0.., im P.., -im 2P..; S^T re 0.., im P..
#pragma unroll
              for (int q = q0; q < q1; ++q) wgmma_tf32_ss(tr, ga(prod_a(q)), sb(prod_b(q)));  // Gr Sr
#pragma unroll
              for (int q = q0; q < q1; ++q) wgmma_tf32_ss(tr, ga(2 * P + prod_a(q)), sb(P + prod_b(q)));  // -Gi Si
#pragma unroll
              for (int q = q0; q < q1; ++q) wgmma_tf32_ss(ti, ga(P + prod_a(q)), sb(prod_b(q)));  // Gi Sr
#pragma unroll
              for (int q = q0; q < q1; ++q) wgmma_tf32_ss(ti, ga(prod_a(q)), sb(P + prod_b(q)));  // Gr Si
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(tr);
          fence_regs(ti);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            add4(xr[0][j], tr[j]);
            add4(xi[0][j], ti[j]);
          }
        }
      } else if constexpr (KARA) {
        if (!live) continue;
        // Karatsuba on mma.sync: per k-step t1 = Gr Sr, t2 = Gi Si, t3 =
        // (Gr + Gi)(Sr + Si); Xr += t1 - t2, Xi += t3 - (t1 + t2).
#pragma unroll 1
        for (int ks = 0; ks < kUK / 8; ++ks)
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t sb[2][3][P][2];  // [n-tile][component][piece]
#pragma unroll
            for (int pl = 0; pl < 3 * P; ++pl) {
              uint32_t r[4];
              ldsm4(r, s_st + pl * kSP + (wn * 32 + np * 16) * kGS + ks * 8 + b_lane(lane, kGS));
              sb[0][pl / P][pl % P][0] = r[0];
              sb[0][pl / P][pl % P][1] = r[1];
              sb[1][pl / P][pl % P][0] = r[2];
              sb[1][pl / P][pl % P][1] = r[3];
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              uint32_t ga[3][P][4];
#pragma unroll
              for (int pl = 0; pl < 3 * P; ++pl)
                ldsm4(ga[pl / P][pl % P], g_st + pl * kGP + (wm * RW + mt * 16) * kGS + ks * 8 + a_lane(lane, kGS));
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                float t1[4] = {0.f, 0.f, 0.f, 0.f}, t2[4] = {0.f, 0.f, 0.f, 0.f};
                float t3[4] = {0.f, 0.f, 0.f, 0.f};
                mma_n<SPLITS>(t1, ga[0], sb[j][0]);
                mma_n<SPLITS>(t2, ga[1], sb[j][1]);
                mma_n<SPLITS>(t3, ga[2], sb[j][2]);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  xr[mt][2 * np + j][i] += t1[i] - t2[i];
                  xi[mt][2 * np + j][i] += t3[i] - (t1[i] + t2[i]);
                }
              }
            }
          }
      } else if (live) {
#pragma unroll 1
        for (int ks = 0; ks < kUK / 8; ++ks)
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            // B: S rows ks*8.. for the warp's n-tiles 2 np, 2 np + 1,
            // [n-tile][component][piece]; planes: the pieces of re, then im.
            uint32_t sb[2][2][P][2];
#pragma unroll
            for (int pl = 0; pl < 2 * P; ++pl) {
              uint32_t r[4];
              ldsm4(r, s_st + pl * kSP + (wn * 32 + np * 16) * kGS + ks * 8 + b_lane(lane, kGS));
              sb[0][pl / P][pl % P][0] = r[0];
              sb[0][pl / P][pl % P][1] = r[1];
              sb[1][pl / P][pl % P][0] = r[2];
              sb[1][pl / P][pl % P][1] = r[3];
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              // A: G rows of this m-tile, the same planes.
              uint32_t ga[2][P][4];
#pragma unroll
              for (int pl = 0; pl < 2 * P; ++pl)
                ldsm4(ga[pl / P][pl % P], g_st + pl * kGP + (wm * RW + mt * 16) * kGS + ks * 8 + a_lane(lane, kGS));
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                // This k-step's products are summed on the tensor cores,
                // then added to X in IEEE fp32 (Gi Si subtracted there).
                float tr[4] = {0.f, 0.f, 0.f, 0.f}, ts[4] = {0.f, 0.f, 0.f, 0.f};
                float ti[4] = {0.f, 0.f, 0.f, 0.f};
                mma_n<SPLITS>(tr, ga[0], sb[j][0]);  // Gr Sr
                mma_n<SPLITS>(ts, ga[1], sb[j][1]);  // Gi Si
                mma_n2<SPLITS>(ti, ga[1], sb[j][0], ga[0], sb[j][1]);  // Gi Sr + Gr Si
#pragma unroll
                for (int i = 0; i < 4; ++i) xr[mt][2 * np + j][i] += tr[i] - ts[i];
                add4(xi[mt][2 * np + j], ti);
              }
            }
          }
      }
    }
    if constexpr (PAIRED) {
      if (nyq) {
        // The Nyquist bin's X of row tid / 4: its four threads' sums added,
        // in the sliver (the Karatsuba form: Xr = t1 - t2, Xi = t3 - t1 - t2).
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          x_nq[m] += __shfl_xor_sync(0xffffffffu, x_nq[m], 1);
          x_nq[m] += __shfl_xor_sync(0xffffffffu, x_nq[m], 2);
        }
        if ((tid & 3) == 0) {
          sliver[tid >> 2] = KARA ? x_nq[0] - x_nq[1] : x_nq[0];
          sliver[ROWS + (tid >> 2)] = KARA ? x_nq[2] - x_nq[0] - x_nq[1] : x_nq[1];
        }
      }
    }
    // Bins past wc hold zeros (S was zero there), which pads X for the W
    // stage's chunks. The DIF bodies store the bins permuted (xcol): a
    // pair of adjacent bins lands in the even and the odd half.
    if constexpr (kWG) {
      const int rank = warp & 3;
#pragma unroll
      for (int j = 0; j < XN; ++j) {
        const int v = c0 + (warp >> 2) * 64 + j * 8;  // the n-tile's bins: all below wc_pad, or none
        if (live && v < hb_pad) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* p = x_s + (rank * 16 + 8 * h + g8) * xs;
            const int b2 = v + 2 * t4;
            *reinterpret_cast<float2*>(p + b2) = make_float2(xr[0][j][2 * h], xr[0][j][2 * h + 1]);
            *reinterpret_cast<float2*>(p + b2 + wc_pad) = make_float2(xi[0][j][2 * h], xi[0][j][2 * h + 1]);
          }
        }
      }
    } else if (live) {
#pragma unroll
      for (int mt = 0; mt < XM; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* p = x_s + (wm * RW + mt * 16 + 8 * h + g8) * xs;
            const int b2 = c0 + wn * 32 + nt * 8 + 2 * t4;
            *reinterpret_cast<float2*>(p + b2) = make_float2(xr[mt][nt][2 * h], xr[mt][nt][2 * h + 1]);
            *reinterpret_cast<float2*>(p + b2 + wc_pad) = make_float2(xi[mt][nt][2 * h], xi[mt][nt][2 * h + 1]);
          }
    }
  }
  }
  if constexpr (PAIRED) {
    __syncthreads();  // X and the sliver are written
    // A last column alone (vw = 128 q + 1; not in the DIF stage, whose
    // passes run over t'-columns): its dot over this rank's X in float64
    // (exact products, a sum that does not round), four threads a row over
    // interleaved columns, in the sliver for rank 1 to finish.
    if (!kDif && vw > pair_cols(vw)) {
      const int mcols = m_cols(pair_cols(vw));
      const float* ml = m_tc + static_cast<long long>(St::kMP) * mcols * (4 * wc_pad) + 2 * mcols +
                        crank * 2 * wc_pad;
      const float* xrow = x_s + (tid >> 2) * xs;
      double sum = 0.0;
      for (int k = tid & 3; k < 2 * wc_pad; k += 4) {
        const float x = SPLITS == kBF16IO ? __uint_as_float(bf16r(xrow[k])) : xrow[k];
        sum = fma(static_cast<double>(x), static_cast<double>(ml[k]), sum);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if ((tid & 3) == 0) reinterpret_cast<double*>(sliver + 2 * ROWS)[tid >> 2] = sum;
    }
    // both ranks' X, Nyquist X and partial sums are written: each reads its
    // partner's from here on
    cluster_arrive();
    cluster_wait();
  }
  } else {
  static_assert(ROWS == 64, "the stacked configuration is 64 rows");
  // ---- stacked H stage: `group` blocks x `kpc` kernels of one image ----
  // X of kernel k at x_s + k * 64 * xs (stacked row t * vh + r: window row
  // r of block t); S of one kernel's cell (block t) at s_st + t * 2 * U *
  // sb, re then im, [u][bin]; the ring after S; its barriers past the
  // staging area (full(s) at bars + 8 s, empty(s) 8 kMaxStages bytes on).
  constexpr int U = stack_rows(SPLITS);  // spectrum rows of a u-chunk
  const int g = group;
  const int sb = stack_bins(wc);
  float* s_st = stage;
  char* ring = reinterpret_cast<char*>(stage + s_floats(wc, g, SPLITS));
  const uint32_t bars = smem_u32(smem) + dyn_smem_bytes() - 8 * kStackBars;
  auto full = [&](int sl) { return bars + 8 * sl; };
  auto empty = [&](int sl) { return bars + 8 * (kMaxStages + sl); };

  const int nblk = nbh * nbw;
  const int groups = (nblk + g - 1) / g;
  // Launch order: tiles of `ktile` kernels; in a tile the CTA's kernels (kpc
  // consecutive ones) run fastest, then the block group, so the CTAs
  // resident at one time share a few groups' data and the tile's kernel
  // spectra, which stay in L2 while every group passes them. Tiles, then
  // images, run outermost; CTAs past n return at once.
  const int kp = (ktile + kpc - 1) / kpc;  // CTAs a tile's kernels take
  const int ntiles = (n + ktile - 1) / ktile;
  const long long per_tile = static_cast<long long>(groups) * kp;
  const int inner = static_cast<int>(blockIdx.x % per_tile);
  const long long outer = blockIdx.x / per_tile;
  const int tile = static_cast<int>(outer % ntiles);
  const int ni0 = tile * ktile + (inner % kp) * kpc;
  const int tile_end = min((tile + 1) * ktile, n);
  const int nk = min(kpc, tile_end - ni0);  // this CTA's kernels
  const int grp = inner / kp;
  const long long bb = outer / ntiles;
  if (nk <= 0) return;
  const int blk0 = grp * g;
  const int count = nblk - blk0 < g ? nblk - blk0 : g;
  cell_at = Cell{bb, blk0 / nbw, blk0 % nbw, 0, ni0, count};
  kernels_at = nk;

  const long long plane = static_cast<long long>(lh) * wc;
  const long long cell0 = bb * nblk + blk0;
  // The planes of a ring step, sp = 2 t + c (block t's D, c = 0 re, 1 im)
  // or 2 g + 2 k + c (kernel k's K), and whether this CTA reads them.
  auto plane_base = [&](int sp) -> const TS* {
    if (sp < 2 * g) return ((sp & 1) ? d_im : d_re) + (cell0 + (sp >> 1)) * f * plane;
    const int k = (sp - 2 * g) >> 1;
    return ((sp & 1) ? k_im : k_re) + (static_cast<long long>(ni0) + k) * f * plane;
  };
  auto plane_on = [&](int sp) { return sp < 2 * g ? (sp >> 1) < count : ((sp - 2 * g) >> 1) < nk; };
  const int nsp = step_planes(g, kpc);
  const int span = span_bytes(wc, U, sizeof(TS));
  const int step_bytes = nsp * span;
  const int nuc = (lh + U - 1) / U;
  const int total = nuc * f;  // ring steps: (u-chunk, channel), channels fastest
  const long long plane_bytes = plane * static_cast<long long>(sizeof(TS));

  // X and S start at zero (S's bins past wc stay so; the W stage reads X's
  // padded bins), and the ring's barriers are set up.
  for (int e = tid; e < kpc * 64 * xs; e += kThreads) x_s[e] = 0.f;
  for (int e = tid; e < s_floats(wc, g, SPLITS); e += kThreads) s_st[e] = 0.f;
  if (tid == 0) {
    for (int sl = 0; sl < stages; ++sl) {
      mbar_init(full(sl), 32);
      mbar_init(empty(sl), kMacWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The producer (the last warp): lane sp copies plane sp's span of each
  // step into its slot, one bulk copy from the 16-byte chunk that holds
  // the span's start; every lane arrives at the slot's full barrier with
  // the bytes it copies. A slot is refilled once the MAC's warps have all
  // arrived at its empty barrier.
  int issued = 0;
  auto produce_until = [&](int jend) {
    for (; issued < min(jend, total); ++issued) {
      const int sl = issued % stages;
      if (issued >= stages) mbar_wait(empty(sl), (issued / stages - 1) & 1);
      const int uc = issued / f, ff = issued % f;
      const int rows = min(U, lh - uc * U);
      uint32_t bytes = 0;
      unsigned long long a0 = 0;
      if (lane < nsp && plane_on(lane)) {
        const unsigned long long src = reinterpret_cast<unsigned long long>(
            plane_base(lane) + ff * plane + static_cast<long long>(uc) * U * wc);
        a0 = src & ~15ull;
        bytes = static_cast<uint32_t>(((src + rows * wc * sizeof(TS) + 15) & ~15ull) - a0);
      }
      mbar_expect_tx(full(sl), bytes);
      if (bytes)
        bulk_copy(smem_u32(ring) + sl * step_bytes + lane * span, reinterpret_cast<const void*>(a0), bytes,
                  full(sl));
    }
  };

  // A MAC thread's pixels: pairs 2 q, 2 q + 1 of the u-chunk's U x wc
  // positions (flattened, as the planes hold them), q = tid + 224 j. Where
  // every span starts on an element pair (even wc, pair-aligned planes: the
  // DPM plan), a pair is one load.
  const bool pairs =
      wc % 2 == 0 &&
      ((reinterpret_cast<uintptr_t>(d_re) | reinterpret_cast<uintptr_t>(d_im) |
        reinterpret_cast<uintptr_t>(k_re) | reinterpret_cast<uintptr_t>(k_im)) %
       (2 * sizeof(TS))) == 0;
  const bool mac_warp = warp < kMacWarps;
  const int mtiles = (vh + 15) / 16;
  const int ntiles_s = sb / 8;
  constexpr int NQ = U / 4;  // G values a fragment row holds per m-tile half

  // The H stage for G blocks x T kernels (the CTA's g x kpc, compile-time,
  // so that a step's loads all issue before its FMAs and S's sums stay in
  // registers), u-chunk by u-chunk: the MAC's warps sum S = sum_f K D for
  // their pixels and the cells (t, k), in channel order, while the
  // producer fills the ring; then kernel by kernel, S goes to s_st (zeros
  // where the spans held nothing) and every warp adds G S to X.
  auto h_stage = [&](auto gt, auto tt) {
    constexpr int G = decltype(gt)::value, T = decltype(tt)::value;
    constexpr int PAIRS = mac_pairs(G, T);
    for (int uc = 0; uc < nuc; ++uc) {
      const int u0 = uc * U;
      const int npx = min(U, lh - u0) * wc;  // positions the spans hold
      // This warp's G fragments of the u-chunk: m-tile mt's rows g and g + 8
      // (h), columns t, t + 4 at the TF32 tiers (m16n8k8), 2 t, 2 t + 1,
      // 2 t + 8, 2 t + 9 at kBF16IO (m16n8k16); loaded before the MAC so
      // that their latency hides behind it.
      float gv[2][2][2][NQ];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const int col = U == 16 ? 2 * t4 + (q & 1) + 8 * (q >> 1) : t4 + 4 * q;
            const bool in = mt < mtiles;
            const long long o = static_cast<long long>(in ? mt * 16 + g8 + 8 * h : 0) * g_cols(lh) + u0 + col;
            gv[mt][0][h][q] = in ? g_pad[o] : 0.f;
            gv[mt][1][h][q] = in ? g_pad[static_cast<long long>(g_rows(vh)) * g_cols(lh) + o] : 0.f;
          }
      float acc[PAIRS][2][G][T][2];
#pragma unroll
      for (int j = 0; j < PAIRS; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int t = 0; t < G; ++t)
#pragma unroll
            for (int k = 0; k < T; ++k) acc[j][h][t][k][0] = acc[j][h][t][k][1] = 0.f;
      if (mac_warp) {
        // each plane's offset in its chunks at channel 0: D's (block t, c)
        // at dlo[2 t + c], K's (kernel k, c) at klo[2 k + c]
        auto lo_of = [&](int sp) {
          return static_cast<unsigned>(reinterpret_cast<uintptr_t>(
                     plane_base(sp) + static_cast<long long>(u0) * wc)) & 15u;
        };
        unsigned dlo[2 * G], klo[2 * T];
#pragma unroll
        for (int i = 0; i < 2 * G; ++i) dlo[i] = lo_of(i);
#pragma unroll
        for (int i = 0; i < 2 * T; ++i) klo[i] = lo_of(2 * G + i);
        for (int ff = 0; ff < f; ++ff) {
          const int j_step = uc * f + ff;
          const int sl = j_step % stages;
          mbar_wait(full(sl), (j_step / stages) & 1);  // this step's spans landed
          const char* slot = ring + sl * step_bytes;
          const unsigned dj = static_cast<unsigned>(ff * plane_bytes);
          // plane sp's values at pixels p, p + 1 (positions past the spans'
          // rows read what the slot holds there; S drops them)
          auto pair = [&](int sp, unsigned l, int p) -> float2 {
            const TS* q = reinterpret_cast<const TS*>(slot + sp * span + ((l + dj) & 15u)) + p;
            return pairs ? load2(q) : make_float2(to_f32(q[0]), to_f32(q[1]));
          };
#pragma unroll
          for (int j = 0; j < PAIRS; ++j) {
            if (2 * (32 * warp + kMacThreads * j) >= npx) break;  // the same for the warp
            const int p = min(2 * (tid + kMacThreads * j), U * wc - 2);
            float2 kr[T], ki[T], dr[G], di[G];
#pragma unroll
            for (int k = 0; k < T; ++k) {
              kr[k] = pair(2 * G + 2 * k, klo[2 * k], p);
              ki[k] = pair(2 * G + 2 * k + 1, klo[2 * k + 1], p);
            }
#pragma unroll
            for (int t = 0; t < G; ++t) {
              dr[t] = pair(2 * t, dlo[2 * t], p);
              di[t] = pair(2 * t + 1, dlo[2 * t + 1], p);
            }
#pragma unroll
            for (int t = 0; t < G; ++t)
#pragma unroll
              for (int k = 0; k < T; ++k) {
                float(&a)[2] = acc[j][0][t][k];
                float(&c)[2] = acc[j][1][t][k];
                a[0] = fmaf(kr[k].x, dr[t].x, fmaf(-ki[k].x, di[t].x, a[0]));
                a[1] = fmaf(kr[k].x, di[t].x, fmaf(ki[k].x, dr[t].x, a[1]));
                c[0] = fmaf(kr[k].y, dr[t].y, fmaf(-ki[k].y, di[t].y, c[0]));
                c[1] = fmaf(kr[k].y, di[t].y, fmaf(ki[k].y, dr[t].y, c[1]));
              }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty(sl));  // this warp is done with the slot
        }
      } else {
        // the steps of this u-chunk and the next chunk's first ring's worth
        produce_until((uc + 1) * f + stages);
      }
#pragma unroll
      for (int k = 0; k < T; ++k) {
        if (k >= nk) break;  // the same for the CTA
        if (mac_warp) {
          // S of kernel k (blocks past count: spans not copied, not stored)
#pragma unroll
          for (int j = 0; j < PAIRS; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int px = 2 * (tid + kMacThreads * j) + h;
              if (px >= U * wc) continue;
              const int at = (px / wc) * sb + px % wc;
              const bool in = px < npx;
#pragma unroll
              for (int t = 0; t < G; ++t)
                if (t < count) {
                  float* sc = s_st + t * 2 * U * sb;
                  sc[at] = in ? acc[j][h][t][k][0] : 0.f;
                  sc[U * sb + at] = in ? acc[j][h][t][k][1] : 0.f;
                }
            }
        }
        __syncthreads();  // S of kernel k is staged
        // X[t, k] += G S[t] over this u-chunk on the tensor cores, one mma
        // k-step, summed in a fresh tile and added to X in IEEE fp32: tasks
        // (block, 16-row m-tile, 8-bin n-tile), the warps in turn. kBF16IO:
        // bf16 products of S rounded here and G (rounded by _kernel_mats);
        // the TF32 tiers: the tier's pieces of both.
        const int ntask = count * mtiles * ntiles_s;
        for (int task = warp; task < ntask; task += kThreads / 32) {
          const int nt = task % ntiles_s;
          const int mt = (task / ntiles_s) % mtiles;
          const int t = task / (ntiles_s * mtiles);
          const float* sr_c = s_st + t * 2 * U * sb + nt * 8 + g8;
          const float* si_c = sr_c + U * sb;
          float ga[2][2][NQ];  // this m-tile's G: [re, im][row half][column]
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int q = 0; q < NQ; ++q) ga[c][h][q] = mt ? gv[1][c][h][q] : gv[0][c][h][q];
          float tr[4] = {0.f, 0.f, 0.f, 0.f}, ti[4] = {0.f, 0.f, 0.f, 0.f};
          if constexpr (SPLITS == kBF16IO) {
            // A (m16n8k16): a[0] row g, columns 2 t, 2 t + 1; a[1] row g + 8;
            // a[2], a[3] the same at columns 2 t + 8, 2 t + 9. B: rows 2 t,
            // 2 t + 1 (b[0]) and 2 t + 8, 2 t + 9 (b[1]) of column g.
            uint32_t ar[4], ai[4], br[2], bi[2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int h = i & 1, q = 2 * (i >> 1);
              ar[i] = pack_bf16(ga[0][h][q], ga[0][h][q + 1]);
              ai[i] = pack_bf16(ga[1][h][q], ga[1][h][q + 1]);
            }
            float s_r[4], s_i[4];  // S at rows 2 t, 2 t + 1, 2 t + 8, 2 t + 9
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int u = 2 * t4 + (i & 1) + 8 * (i >> 1);
              s_r[i] = sr_c[u * sb];
              s_i[i] = si_c[u * sb];
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              br[i] = pack_bf16(s_r[2 * i], s_r[2 * i + 1]);
              bi[i] = pack_bf16(s_i[2 * i], s_i[2 * i + 1]);
            }
            if constexpr (KARA) {
              float t1[4] = {0.f, 0.f, 0.f, 0.f}, t2[4] = {0.f, 0.f, 0.f, 0.f};
              uint32_t a3[4], b3[2];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int h = i & 1, q = 2 * (i >> 1);
                a3[i] = pack_bf16(ga[0][h][q] + ga[1][h][q], ga[0][h][q + 1] + ga[1][h][q + 1]);
              }
#pragma unroll
              for (int i = 0; i < 2; ++i)
                b3[i] = pack_bf16(s_r[2 * i] + s_i[2 * i], s_r[2 * i + 1] + s_i[2 * i + 1]);
              mma_bf16(t1, ar, br);
              mma_bf16(t2, ai, bi);
              mma_bf16(ti, a3, b3);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                tr[i] = t1[i] - t2[i];
                ti[i] = ti[i] - (t1[i] + t2[i]);
              }
            } else {
              uint32_t an[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) an[i] = ai[i] ^ 0x80008000u;  // -Gi
              mma_bf16(tr, ar, br);
              mma_bf16(tr, an, bi);
              mma_bf16(ti, ar, bi);
              mma_bf16(ti, ai, br);
            }
          } else {
            // A (m16n8k8): a[0] (row g, col t), a[1] (row g + 8, col t), a[2]
            // (g, t + 4), a[3] (g + 8, t + 4); B: rows t, t + 4 of column g.
            float gr[4], gi[4], sr[2], si[2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              gr[i] = ga[0][i & 1][i >> 1];
              gi[i] = ga[1][i & 1][i >> 1];
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              sr[i] = sr_c[(t4 + 4 * i) * sb];
              si[i] = si_c[(t4 + 4 * i) * sb];
            }
            uint32_t pgr[P][4], pgi[P][4], psr[P][2], psi[P][2];
            auto split4 = [&](const float (&x)[4], uint32_t (&px)[P][4]) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                uint32_t pc[P];
                split_n(x[i], pc);
#pragma unroll
                for (int q = 0; q < P; ++q) px[q][i] = pc[q];
              }
            };
            auto split2 = [&](const float (&x)[2], uint32_t (&px)[P][2]) {
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                uint32_t pc[P];
                split_n(x[i], pc);
#pragma unroll
                for (int q = 0; q < P; ++q) px[q][i] = pc[q];
              }
            };
            split4(gr, pgr);
            split4(gi, pgi);
            split2(sr, psr);
            split2(si, psi);
            if constexpr (KARA) {
              float t1[4] = {0.f, 0.f, 0.f, 0.f}, t2[4] = {0.f, 0.f, 0.f, 0.f};
              float g3[4], s3[2];
#pragma unroll
              for (int i = 0; i < 4; ++i) g3[i] = gr[i] + gi[i];
#pragma unroll
              for (int i = 0; i < 2; ++i) s3[i] = sr[i] + si[i];
              uint32_t pg3[P][4], ps3[P][2];
              split4(g3, pg3);
              split2(s3, ps3);
              mma_n<SPLITS>(t1, pgr, psr);
              mma_n<SPLITS>(t2, pgi, psi);
              mma_n<SPLITS>(ti, pg3, ps3);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                tr[i] = t1[i] - t2[i];
                ti[i] = ti[i] - (t1[i] + t2[i]);
              }
            } else {
              uint32_t pgn[P][4];
#pragma unroll
              for (int q = 0; q < P; ++q)
#pragma unroll
                for (int i = 0; i < 4; ++i) pgn[q][i] = pgi[q][i] ^ 0x80000000u;  // -Gi
              mma_n2<SPLITS>(tr, pgr, psr, pgn, psi);
              mma_n2<SPLITS>(ti, pgr, psi, pgi, psr);
            }
          }
          // X += the tile: rows g, g + 8 of the m-tile (window rows below
          // vh), bins 2 t, 2 t + 1 of the n-tile
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = mt * 16 + g8 + 8 * h;
            if (r >= vh) continue;
            float* xp = x_s + (static_cast<long long>(k) * 64 + t * vh + r) * xs + nt * 8 + 2 * t4;
            float2 vr = *reinterpret_cast<float2*>(xp), vi = *reinterpret_cast<float2*>(xp + wc_pad);
            vr.x += tr[2 * h];
            vr.y += tr[2 * h + 1];
            vi.x += ti[2 * h];
            vi.y += ti[2 * h + 1];
            *reinterpret_cast<float2*>(xp) = vr;
            *reinterpret_cast<float2*>(xp + wc_pad) = vi;
          }
        }
        __syncthreads();  // S is free again; X holds kernel k's chunk
      }
    }
  };
  using std::integral_constant;
  if (g == 4) {
    if (kpc == 2) h_stage(integral_constant<int, 4>{}, integral_constant<int, 2>{});
    else h_stage(integral_constant<int, 4>{}, integral_constant<int, 1>{});
  } else if (g == 3) {
    if (kpc == 2) h_stage(integral_constant<int, 3>{}, integral_constant<int, 2>{});
    else h_stage(integral_constant<int, 3>{}, integral_constant<int, 1>{});
  } else {
    if (kpc == 2) h_stage(integral_constant<int, 2>{}, integral_constant<int, 2>{});
    else h_stage(integral_constant<int, 2>{}, integral_constant<int, 1>{});
  }
  if (tid == 0)
    for (int sl = 0; sl < stages; ++sl) {
      mbar_inval(full(sl));
      mbar_inval(empty(sl));
    }
  }

  // ---- W stage: tile[r, c] = sum_k X[r, k] [Mr ; Mi][k, c] ----
  // The (pass, chunk) steps run as one sequence: chunk kc of pass p holds
  // rows kc * kKC.. of [Mr ; Mi] for output columns p * kCols.., M^T's
  // planes (St::kMP of them) in core matrices, in ring slot (step % kM),
  // copied kM - 1 steps ahead. The DIF bodies: rows of [epr; epi; oqr;
  // oqi] for t'-columns, the first half of a pass's chunks summing P over
  // X's even bins (re, then im), the second Q over its odd bins.
  // PAIRED: the contraction runs over both ranks' X, [Xr | Xi] of rank 0
  // then of rank 1 (DIF: the one-block order, each segment's bins rank 0's
  // then rank 1's: the 64-row operand as it is), and the passes over
  // pair_cols(vw) columns (DIF: its t'-columns); rank 0 takes the first
  // half of the passes (rounded up), rank 1 the rest: this rank's p_beg
  // ...
  const int kw2 = kDif ? 2 * l2 : (PAIRED ? kPair : 1) * 2 * wc_pad;
  const int nkc = kw2 / kKC;
  // chunks of a DIF segment (else of a CTA's X), and of them one CTA's
  const int seg_c = (kDif ? l4 : 2 * wc_pad) / kKC;
  const int own_c = kDif && PAIRED ? seg_c / kPair : seg_c;
  const int wcols = kDif ? min(vw, l2) : PAIRED ? pair_cols(vw) : vw;  // the columns the products run over
  const int mcols = m_cols(wcols);
  const int all_p = mcols / kCols;
  const int p_beg = PAIRED && crank ? (all_p + 1) / 2 : 0;
  const int steps = (PAIRED ? (crank ? all_p - p_beg : (all_p + 1) / 2) : all_p) * nkc;
  // X's column of chunk kc's first row of [Mr ; Mi] (or of [epr; ..]), in
  // the X of rank src (PAIRED: of the chunks of a DIF segment, or of the
  // whole contraction, rank 0's own_c come first; else this CTA's). DIF:
  // segment kc / seg_c is even re, even im, odd re, odd im. (One division
  // a step: this runs in the W stage's loop.)
  static_assert(kPair == 2, "a chunk is rank 0's or rank 1's");
  auto x_at = [&](int kc, int& src) {
    int i = kc, base = 0;
    if constexpr (kDif) {
      const int seg = kc / seg_c;
      i = kc - seg * seg_c;
      base = (seg & 1) * wc_pad + (seg >> 1) * xq;
    }
    src = PAIRED && i >= own_c ? 1 : 0;
    return base + (i - src * own_c) * kKC;
  };
  // A radix body's pair decodes its cell and row chunk anew from the block
  // index here, in 32-bit arithmetic (a 64-bit division calls a
  // subroutine), so that none of them is held in registers through the H
  // stage (held, they spilled the DIF pair's 6xTF32 entries; the one-block
  // configurations keep them, as they ran faster so).
  if constexpr (PAIRED && radix_body(BODY)) {
    unsigned bidx = static_cast<unsigned>(opaque(blockIdx.x)) / kPair;
    const int ni = static_cast<int>(bidx % n);
    bidx /= n;
    const int rc = static_cast<int>(bidx % row_chunks);
    bidx /= row_chunks;
    const int bj = static_cast<int>(bidx % nbw);
    bidx /= nbw;
    cell_at = Cell{bidx / nbh, static_cast<int>(bidx % nbh), bj, rc * kPair + crank, ni, 1};
    sg = radix_segs(rc, lh, vh, ROWS);
  }
  auto win_row = [&](int l) { return l < RW ? sg.a + l : sg.b + l - RW; };
  auto win_end = [&](int l) { return l < RW ? sg.ea : sg.eb; };
  // DIF: P += nyq[r] (-1)^(t0 + k) / W, then the epilogue's two tiles,
  // column k: P + Q (t0 + k < W/2) or P - Q, and column k + W/2: P - Q.
  // The Nyquist values of local rows l and l + 8: X's Nyquist bin (v5), or
  // v5x's sliver at their window rows.
  const int t0 = kDif ? 2 * l2 - vw : 0;  // kw - 1
  const float inv_w = rx.inv_w;
  const float* slv_c = nullptr;
  if constexpr (BODY == kV5X && !STACKED)
    slv_c = rx.slv + (((cell_at.bb * n + cell_at.ni) * nbh + cell_at.bi) * static_cast<long long>(nbw) +
                      cell_at.bj) * vh;
  auto nyq_of = [&](int l) -> float {
    if constexpr (BODY == kV5) {
      return PAIRED ? sliver[l] : x_s[l * xs + l2];
    } else {
      const int r = win_row(l);
      const float v = r < vh && r < win_end(l) ? slv_c[r] : 0.f;
      return SPLITS == kBF16IO ? __uint_as_float(bf16r(v)) : v;
    }
  };
  auto dif_combine = [&](auto& accp, auto& accq, int l0, int col) {
    // accp/accq: [MT][NT][4] at local rows l0 + 16 mt + 8 (i / 2), columns
    // col + 8 nt + i % 2 (k's parity is i's)
    constexpr int kMT = sizeof(accp) / sizeof(accp[0]);
    constexpr int kNT = sizeof(accp[0]) / sizeof(accp[0][0]);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float ny[2] = {nyq_of(l0 + 16 * mt), nyq_of(l0 + 16 * mt + 8)};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = col + 8 * nt + (i & 1);
          const float par = ((t0 + i) & 1) ? -inv_w : inv_w;
          const float p = accp[mt][nt][i] + ny[i >> 1] * par;
          const float q = accq[mt][nt][i];
          accp[mt][nt][i] = t0 + k < l2 ? p + q : p - q;
          accq[mt][nt][i] = p - q;
        }
    }
  };
  constexpr int kMChunk = St::kMP * kMPlane;
  float* m_st = stage;  // [kM][St::kMP][kCols / 8][kKC / 4][8][4]
  auto issue_m = [&](int it) {
    if (it < steps) {
      const int p = it / nkc;
      const int kc = it % nkc;
      float* dst = m_st + (it % kM) * kMChunk;
#pragma unroll
      for (int q = 0; q < kMChunk / 4 / kThreads; ++q) {
        const int e = tid + q * kThreads;  // (plane, n-group, k-core, row)
        const int r = e & 7;
        const int kcr = (e >> 3) % (kKC / 4);
        const int ng = (e / (2 * kKC)) % (kCols / 8);
        const int pl = e / (kMPlane / 4);
        cp_async16(dst + ((pl * (kCols / 8) + ng) * (kKC / 4) + kcr) * kCore + 4 * r,
                   m_tc + ((static_cast<long long>(pl) * (mcols / 8) + p * (kCols / 8) + ng) * (kw2 / 4) +
                           kc * (kKC / 4) + kcr) * kCore + 4 * r);
      }
    }
    cp_async_commit();  // an empty group past the last step keeps the count
  };
  // The W stage of the X at xw, its tiles to epi.
  // PAIRED: the Nyquist bin's rank-1 term added to a pass's tile at local
  // rows l, l + 8 (acc[0][j][2 h + e]: column col + 8 j + e): Xn (rounded
  // at kBF16IO as X is) times its row of [Mr ; Mi] from m_tc's sliver, in
  // fp32.
  const float* m_sl = m_tc + static_cast<long long>(St::kMP) * mcols * kw2;  // Mr, Mi rows; the last column
  auto x_nyq = [&](int l, int c) {
    const float x = sliver[c * ROWS + l];
    return SPLITS == kBF16IO ? __uint_as_float(bf16r(x)) : x;
  };
  auto add_nyq = [&](float (&a)[1][8][4], int l, int col) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float xr = x_nyq(l + 8 * h, 0), xi = x_nyq(l + 8 * h, 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col + 8 * j + e;
          a[0][j][2 * h + e] = fmaf(xi, m_sl[mcols + c], fmaf(xr, m_sl[c], a[0][j][2 * h + e]));
        }
    }
  };
  auto w_stage = [&](const float* xw, Epi& epi) {
  __syncthreads();  // X is written; the H stage is done with the staging area
  if constexpr (ROWS == 64) {
    // The ring: step j's chunk (chunk j of m_tc, kMChunk floats) in slot
    // j % kM; full(s) completes when a fill's bytes have landed (its phase
    // parity: (j / kM) % 2), empty(s) (8 bytes past it) when every warp is
    // done with it. The barriers sit in X's row padding (row s: full, then
    // empty), set up anew each W stage.
    const uint32_t bar0 = smem_u32(x_s + 2 * wc_pad);  // full(0); full(s) + 8: empty(s)
    auto full = [&](int sl) { return bar0 + 4 * sl * xs; };
    if (tid == 0) {
      for (int sl = 0; sl < kM; ++sl) {
        mbar_init(full(sl), 1);
        mbar_init(full(sl) + 8, kThreads / 32);
      }
      // the barriers set up before the copies' complete_tx reaches them
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // the H stage's writes to the staging area come before the copies into it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the barriers are set up
    // Thread 0 fills slot sl with step j's chunk.
    auto fill = [&](int j, int sl) {
      mbar_expect_tx(full(sl), kMChunk * 4);
      bulk_copy(smem_u32(m_st) + 4 * sl * kMChunk,
                m_tc + (static_cast<long long>(p_beg) * nkc + j) * kMChunk, kMChunk * 4, full(sl));
    };
    if (tid == 0)
      for (int j = 0; j < kM && j < steps; ++j) fill(j, j);
    // wgmma: each warpgroup (warps 4 wg..) takes all 64 rows and 64 of a
    // pass's columns; warp `rank` of it holds rows 16 rank.. .
    const int wg = warp >> 2;
    const int rank = warp & 3;
    // PAIRED: the partner's X, read through distributed shared memory
    const uint32_t x_peer = PAIRED ? mapa(smem_u32(xw), crank ^ 1) : 0;
    float acc[1][8][4], accq[1][8][4];  // (DIF: P, Q)
    for (int it = 0; it < steps; ++it) {
      const int p = p_beg + it / nkc;
      const int kc = it % nkc;
      if (kc == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[0][j][i] = accq[0][j][i] = 0.f;
      }
      // refill the last step's slot, once every warp is done with it, with
      // step it - 1 + kM's chunk (the empty barrier's phase: step it - 1's)
      const int slot = it % kM;
      if (tid == 0 && it > 0 && it - 1 + kM < steps) {
        mbar_wait(full((it - 1) % kM) + 8, ((it - 1) / kM) & 1);
        fill(it - 1 + kM, (it - 1) % kM);
      }
      mbar_wait(full(slot), (it / kM) & 1);  // this step's chunk landed
      __syncwarp();  // the warp converged again for wgmma
      if (p * kCols + wg * 64 < wcols) {
        const float* mb = m_st + slot * kMChunk + wg * 8 * (kKC / 4) * kCore;
        // The chunk's products are summed on the tensor cores into t (at
        // 6xTF32 its small terms into tc, apart), then added to the pass's
        // sums in IEEE fp32.
        float t[8][4], tc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) t[j][i] = tc[j][i] = 0.f;
        fence_regs(t);
        if constexpr (kApart) fence_regs(tc);
        // A: X at this warp's 16 rows, split here into its pieces,
        // double-buffered: the next k-step's fragments are split while
        // this k-step's products run, into the buffer whose products are
        // done (wait<1>); the fences keep the compiler from giving a
        // buffer's registers to other values while the tensor cores may
        // still read them.
        uint32_t xp[2][P][4];
        // PAIRED: chunk kc lies in the X of rank src, the partner's read
        // with four 32-bit loads a fragment (ldmatrix reads this CTA's)
        int src;
        const int xc = x_at(kc, src);
        const bool remote = PAIRED && src != crank;
        auto frag = [&](int ks, int bf) {
          uint32_t xa[4];
          if (remote) {
            const uint32_t a = x_peer + 4 * ((rank * 16 + g8) * xs + xc + ks * 8 + t4);
            xa[0] = ld_cluster(a);
            xa[1] = ld_cluster(a + 32 * xs);
            xa[2] = ld_cluster(a + 16);
            xa[3] = ld_cluster(a + 32 * xs + 16);
          } else {
            ldsm4(xa, xw + rank * 16 * xs + xc + ks * 8 + a_lane(lane, xs));
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t pc[P];
            pieces<SPLITS>(__uint_as_float(xa[i]), pc);
#pragma unroll
            for (int k = 0; k < P; ++k) xp[bf][k][i] = pc[k];
          }
        };
        frag(0, 0);
#pragma unroll
        for (int ks = 0; ks < kKC / 8; ++ks) {
          const int bf = ks & 1;
          // plane k of M^T's pieces: k planes past the first
          const uint64_t d0 = smem_desc(mb + 2 * ks * kCore, 4 * kCore, 4 * (kKC / 4) * kCore);
          constexpr uint64_t kPlaneDesc = kMPlane * 4 >> 4;
          wgmma_fence();
#pragma unroll
          for (int q = first_product(SPLITS); q < 6; ++q) {
            if (kApart && q < kMainProduct)
              wgmma_tf32(tc, xp[bf][prod_a(q)], d0 + prod_b(q) * kPlaneDesc);
            else
              wgmma_tf32(t, xp[bf][prod_a(q)], d0 + prod_b(q) * kPlaneDesc);
          }
          wgmma_commit();
          if (ks + 1 < kKC / 8) {
            wgmma_wait<1>();
#pragma unroll
            for (int k = 0; k < P; ++k) fence_regs(xp[bf ^ 1][k]);
            frag(ks + 1, bf ^ 1);
          }
        }
        wgmma_wait<0>();
        fence_regs(t);
        if constexpr (kApart) fence_regs(tc);
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int k = 0; k < P; ++k) fence_regs(xp[b][k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if constexpr (kApart) add4(t[j], tc[j]);
          if (kDif && kc >= nkc / 2)
            add4(accq[0][j], t[j]);
          else
            add4(acc[0][j], t[j]);
        }
      }
      // this warp is done with the slot: an arrival at its empty barrier
      __syncwarp();
      if (lane == 0) mbar_arrive(full(slot) + 8);
      if (kc == nkc - 1) {
        const int col = p * kCols + wg * 64 + 2 * t4;
        if constexpr (!radix_body(BODY)) {
          if constexpr (PAIRED) add_nyq(acc, rank * 16 + g8, col);
          epi.tile(acc, r0 + rank * 16 + g8, col, INT_MAX);
        } else {
          const int l0 = rank * 16 + g8;
          if constexpr (kDif) {
            dif_combine(acc, accq, l0, col);
            if (p * kCols + wg * 64 + l2 < vw) epi.tile(accq, win_row(l0), col + l2, win_end(l0));
          }
          if constexpr (PAIRED && !kDif) add_nyq(acc, l0, col);
          epi.tile(acc, win_row(l0), col, win_end(l0));
        }
      }
    }
    // every warp past its last wait before the barriers go
    __syncthreads();
    if (tid == 0)
      for (int sl = 0; sl < kM; ++sl) {
        mbar_inval(full(sl));
        mbar_inval(full(sl) + 8);
      }
    // the copies' writes to the staging area come before its next generic use
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  } else {
    for (int it = 0; it < kM - 1; ++it) issue_m(it);
    // mma.sync (32 rows): 2 x 4 warps of 16 rows x 32 columns.
    float acc[MT][4][4], accq[MT][4][4];  // (DIF: P, Q)
    for (int it = 0; it < steps; ++it) {
      const int p = it / nkc;
      const int kc = it % nkc;
      if (kc == 0) {
#pragma unroll
        for (int a = 0; a < MT; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][b][c] = accq[a][b][c] = 0.f;
      }
      cp_async_wait<kM - 2>();
      __syncthreads();  // this step's chunk landed; the last step's slot is free
      issue_m(it + kM - 1);
      if (p * kCols + wn * 32 < wcols) {
        const float* mb = m_st + (it % kM) * kMChunk + wn * 4 * (kKC / 4) * kCore + core_lane(lane);
        int src;
        const float* xb = xw + wm * RW * xs + x_at(kc, src) + a_lane(lane, xs);
        // t: the chunk's sums on the tensor cores (at 6xTF32 the small
        // terms in tc, apart)
        float t[MT][4][4], tc[MT][4][4];
#pragma unroll
        for (int a = 0; a < MT; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
#pragma unroll
            for (int c = 0; c < 4; ++c) t[a][b][c] = tc[a][b][c] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kKC / 8; ++ks) {
          // B: M's planes at the warp's 4 n-tiles, [n-tile][piece]: its
          // pieces, or M^T itself (one plane), split here.
          uint32_t mp[4][P][2];
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const float* pm = mb + (2 * np * (kKC / 4) + 2 * ks) * kCore;
#pragma unroll
            for (int k = 0; k < St::kMP; ++k) {
              uint32_t r[4];
              ldsm4(r, pm + k * kMPlane);
              mp[2 * np][k][0] = r[0];
              mp[2 * np][k][1] = r[1];
              mp[2 * np + 1][k][0] = r[2];
              mp[2 * np + 1][k][1] = r[3];
            }
          }
          if constexpr (St::kMP < P) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                uint32_t pc[P];
                split_n(__uint_as_float(mp[nt][0][h]), pc);
#pragma unroll
                for (int k = 0; k < P; ++k) mp[nt][k][h] = pc[k];
              }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            // A: X at this m-tile's rows, split here (X is fp32 in shared memory).
            uint32_t xa[4], xp[P][4];
            ldsm4(xa, xb + mt * 16 * xs + ks * 8);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              uint32_t pc[P];
              pieces<SPLITS>(__uint_as_float(xa[i]), pc);
#pragma unroll
              for (int k = 0; k < P; ++k) xp[k][i] = pc[k];
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              if constexpr (kApart) {
                mma_terms<0, kMainProduct>(tc[mt][nt], xp, mp[nt]);
                mma_terms<kMainProduct, 6>(t[mt][nt], xp, mp[nt]);
              } else {
                mma_n<SPLITS>(t[mt][nt], xp, mp[nt]);
              }
            }
          }
        }
#pragma unroll
        for (int a = 0; a < MT; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            if constexpr (kApart) add4(t[a][b], tc[a][b]);
            if (kDif && kc >= nkc / 2)
              add4(accq[a][b], t[a][b]);
            else
              add4(acc[a][b], t[a][b]);
          }
      }
      if (kc == nkc - 1) {
        const int col = p * kCols + wn * 32 + 2 * t4;
        if constexpr (!radix_body(BODY)) {
          epi.tile(acc, r0 + wm * RW + g8, col, INT_MAX);
        } else {
          const int l0 = wm * RW + g8;
          if constexpr (kDif) {
            dif_combine(acc, accq, l0, col);
            if (p * kCols + wn * 32 + l2 < vw) epi.tile(accq, win_row(l0), col + l2, win_end(l0));
          }
          epi.tile(acc, win_row(l0), col, win_end(l0));
        }
      }
    }
  }
  };
  // PAIRED: the last column alone, by warp 0 of rank 1 (whose passes are no
  // more than rank 0's): both ranks' partial sums (float64) and the Nyquist
  // bin's term, rounded once; then the pair's last barrier, so that neither
  // CTA leaves while its partner may read its shared memory.
  auto pair_last = [&](auto& epi) {  // (generic: instantiated only where a pair calls it)
    if (!kDif && crank == 1 && vw > wcols && warp == 0) {
      const double* part = reinterpret_cast<const double*>(sliver + 2 * ROWS);
      const uint32_t peer = mapa(smem_u32(part), 0);
      const int l = 16 * (lane >> 3) + (lane & 7);
      float a[1][1][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = l + 8 * h;
        const double v = ld_cluster_f64(peer + 8 * row) + part[row] +
                         static_cast<double>(x_nyq(row, 0)) * m_sl[2 * mcols + kw2] +
                         static_cast<double>(x_nyq(row, 1)) * m_sl[2 * mcols + kw2 + 1];
        a[0][0][2 * h] = static_cast<float>(v);
        a[0][0][2 * h + 1] = 0.f;
      }
      // (rows l and l + 8 of one radix chunk's half: the same segment)
      if constexpr (radix_body(BODY))
        epi.tile(a, win_row(l), vw - 1, win_end(l));
      else
        epi.tile(a, r0 + l, vw - 1, INT_MAX);
    }
    cluster_arrive();
    cluster_wait();
  };
  const OutGeom geom{n, nbh, nbw, PAIRED ? row_chunks * kPair : row_chunks, vh, vw, out_h, out_w};
  if constexpr (STACKED) {
    // kernel by kernel: its X's 64 stacked rows, its tiles to its epilogue
    for (int k = 0; k < kernels_at; ++k) {
      Epi epi(out, Cell{cell_at.bb, cell_at.bi, cell_at.bj, 0, cell_at.ni + k, cell_at.count}, geom);
      w_stage(x_s + k * 64 * xs, epi);
      epi.finish(stage);
    }
  } else {
    Epi epi(out, cell_at, geom);
    w_stage(x_s, epi);
    if constexpr (PAIRED) pair_last(epi);
    epi.finish(stage);
  }
}

template <class TS, int ROWS, bool STACKED, int SPLITS, int BODY, class Epi, bool KARA, bool PAIRED = false>
int launch(const TS* d_re, const TS* d_im, const TS* k_re, const TS* k_im,
           const float* gt_re, const float* gt_im, const float* g_pad,
           const float* m_tc, RadixOps rx, typename Epi::Out out, int b, int nbh, int nbw,
           int f, int n, int lh, int wc, int vh, int vw, int out_h, int out_w,
           int ktile, cudaStream_t stream) {
  const int group = STACKED ? blocks_per_cta(wc, vh, SPLITS) : 1;
  // stacked: `kpc` kernels a CTA (kernels_per_cta)
  const int kpc = STACKED ? kernels_per_cta(wc, vh, SPLITS) : 1;
  const long long smem = STACKED  ? stacked_smem_bytes(wc, group, kpc, SPLITS)
                         : PAIRED ? pair_smem_bytes(pair_half(wc, SPLITS, KARA), SPLITS, KARA)
                                  : tile_smem_bytes(ROWS, wc, SPLITS, KARA);
  const int row_chunks = STACKED               ? 1
                         : !radix_body(BODY) ? (vh + ROWS - 1) / ROWS
                                             : pair_chunks(lh, vh, ROWS) + single_chunks(lh, vh, ROWS);
  const Ring ring = STACKED ? stacked_ring<TS>(wc, group, kpc, SPLITS) : Ring{0, 0};
  // stacked: b images x tiles of ktile kernels x block groups x the tile's
  // CTAs of kpc kernels; the others: b images x blocks x row chunks x
  // kernels; paired: the same x the pair's two CTAs (fastest: a cluster is
  // two consecutive CTAs)
  const long long grid =
      STACKED ? static_cast<long long>(b) * ((n + ktile - 1) / ktile) * ((ktile + kpc - 1) / kpc) *
                    ((static_cast<long long>(nbh) * nbw + group - 1) / group)
              : static_cast<long long>(b) * nbh * nbw * row_chunks * n * (PAIRED ? kPair : 1);
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = block_conv_kernel<TS, ROWS, STACKED, SPLITS, BODY, Epi, KARA, PAIRED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (PAIRED) {
    // a thread-block cluster of kPair CTAs
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(grid));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kPair;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, d_re, d_im, k_re, k_im, gt_re, gt_im, g_pad, m_tc, rx, out, nbh,
                             nbw, f, n, lh, wc, vh, vw, out_h, out_w, row_chunks, group, kpc, ring.stages,
                             ktile);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    kernel<<<static_cast<unsigned>(grid), kThreads, static_cast<size_t>(smem), stream>>>(
        d_re, d_im, k_re, k_im, gt_re, gt_im, g_pad, m_tc, rx, out, nbh, nbw, f, n,
        lh, wc, vh, vw, out_h, out_w, row_chunks, group, kpc, ring.stages, ktile);
  }
  return static_cast<int>(cudaGetLastError());
}

// Checks the geometry and launches the configuration for (wc, vh) at the
// tier SPLITS and body BODY on `stream`; does not synchronise. gt_re,
// gt_im: G^T (Lh, Vh), exact (no configuration reads it); g_pad: G (2, g_rows(vh), g_cols(lh)) = re,
// im, exact; m_tc: the m_planes(rows, SPLITS) planes of M^T (m_cols(vw),
// 2 padded_bins(wc)) in core matrices, rows = tile_rows(wc, vh, SPLITS,
// KARA), row c holding column c of [Mr ; Mi] (Mi from k =
// padded_bins(wc) on): its TF32 pieces, or M^T exact where the
// configuration stages one plane; zeros wherever the padding reaches. At
// kBF16IO G^T, G and M^T (one plane) are rounded to bf16 instead of exact.
// The paired configuration (pair_bins > 0: v3 and v4) takes
// ops/block_conv.py _pair_m's operand in m_tc instead. The DIF bodies take
// in m_tc the planes of [epr; epi; oqr; oqi]^T (m_cols(min(vw, W/2)), W)
// instead (in the pair as for 64 rows), and the radix bodies the operands
// of RadixOps (v5x: slv; the others may pass null there; inv_w is set
// here); they run only where the one-block configurations and the pair do
// (blocks_per_cta = 1) on the plans radix_h_ok (and, DIF, radix_w_ok, and
// in the pair an even split) admit. KARA runs the Karatsuba H stage
// (every body). `ktile` (1..n), the kernels a launch tile of the
// stacked configuration holds, is its launch order (n: the kernel index
// fastest); the others run the kernel index fastest. Epi is the epilogue
// class template. Returns cudaGetLastError() after the launch (0 =
// launched), or the error that stopped it (cudaErrorInvalidValue for a
// geometry or operand it does not take).
template <class TS, template <bool> class Epi, int SPLITS = 3, int BODY = kV3, bool KARA = false>
int launch_block_conv(const TS* d_re, const TS* d_im, const TS* k_re,
                      const TS* k_im, const float* gt_re, const float* gt_im,
                      const float* g_pad, const float* m_tc, RadixOps rx,
                      typename Epi<false>::Out out, int b, int nbh, int nbw,
                      int f, int n, int lh, int wc, int vh, int vw, int out_h,
                      int out_w, int ktile, void* stream) {
  const long long need = smem_bytes(wc, vh, SPLITS, KARA);
  if (b <= 0 || nbh <= 0 || nbw <= 0 || f <= 0 || n <= 0 || lh <= 0 ||
      wc <= 0 || vh <= 0 || vw <= 0 || out_h <= 0 || out_w <= 0 ||
      ktile < 1 || ktile > n || need > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rx.inv_w = static_cast<float>(1.0 / (2.0 * (wc - 1)));  // the DIF stage's 1 / W
  if constexpr (BODY == kV3) {
    if (blocks_per_cta(wc, vh, SPLITS) > 1)
      return launch<TS, 64, true, SPLITS, BODY, Epi<true>, KARA>(d_re, d_im, k_re, k_im, gt_re, gt_im,
                                                                 g_pad, m_tc, rx, out, b, nbh, nbw, f, n,
                                                                 lh, wc, vh, vw, out_h, out_w, ktile, s);
  } else {
    if (blocks_per_cta(wc, vh, SPLITS) > 1 || !radix_h_ok(lh, vh) || !rx.u_pad || !rx.tw ||
        (dif_body(BODY) && !radix_w_ok(wc)) || (BODY == kV5X && !rx.slv))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (const int half = pair_bins(wc, vh, SPLITS, KARA)) {
    // the DIF pair: the ranks split the W/2 bins evenly, in whole W-stage
    // chunks of each parity (radix_w_legal's plans, W a multiple of 512)
    if (dif_body(BODY) && (2 * half != wc - 1 || half % (2 * kKC)))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<TS, 64, false, SPLITS, BODY, Epi<false>, KARA, true>(d_re, d_im, k_re, k_im, gt_re, gt_im,
                                                                       g_pad, m_tc, rx, out, b, nbh, nbw, f,
                                                                       n, lh, wc, vh, vw, out_h, out_w, ktile,
                                                                       s);
  }
  if (wide(wc, SPLITS, KARA))
    return launch<TS, 32, false, SPLITS, BODY, Epi<false>, KARA>(d_re, d_im, k_re, k_im, gt_re, gt_im,
                                                                 g_pad, m_tc, rx, out, b, nbh, nbw, f, n,
                                                                 lh, wc, vh, vw, out_h, out_w, ktile, s);
  if constexpr (dif_body(BODY) && SPLITS == 6) {
    // The 64-row configuration takes bins up to 256 at 6xTF32, the DIF
    // stage W = 2 (Wc - 1) a multiple of 512 (radix_w_legal): no plan
    // reaches it (Wc 257 is the pair's there), and it is not built.
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return launch<TS, 64, false, SPLITS, BODY, Epi<false>, KARA>(d_re, d_im, k_re, k_im, gt_re, gt_im,
                                                                 g_pad, m_tc, rx, out, b, nbh, nbw, f,
                                                                 n, lh, wc, vh, vw, out_h, out_w, ktile, s);
  }
}

}  // namespace
