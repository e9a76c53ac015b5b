// QuantEase coordinate-descent kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/quantease_cd.py:
//   * qe_block_sweep_kernel  <- quantease_block_sweep_pallas (_sweep_kernel):
//     the sequential CD sweep over the B columns of one column block, in
//     column panels.
//   * qe_block_corr_kernel + qe_block_sweep_kernel, launched in turn for each
//     column block  <- quantease_fused_iteration_pallas (_fused_iter_kernel):
//     one whole CD iteration of the fused engine.  The Python wrapper
//     (kernels/quantease_cd.py) walks the blocks in order on one stream.
//   * qe_block_corr_kernel<kOutlier> + qe_block_sweep_kernel per column block,
//     then qe_suffix_resid_kernel once  <- quantease_outlier_iteration_t_pallas
//     (_outlier_iter_kernel): one outlier-aware CD iteration (Algorithm 3).
//     The correction also subtracts the Ĥ step's dĤ_prev (β0 = base − dĤ +
//     Σ̃ᵀ·Δ) and reads this iteration's rows as δŴ − dĤ_prev; the suffix
//     kernel then forms the exact residual R = base_out + (Σ̃ ⊙ M)ᵀ·δŴ.
//
// Layout.  Every per-row operand is carried transposed, (G, p_pad, q) with q
// contiguous, so the rows a warp sweeps are contiguous in every column.
//
// What bounds them.
//   * The correction product (per block: corr = Σ̃ᵀ[blk, :] @ Δ, a B x q x
//     p_pad fp32 GEMM) carries 2·q·p_pad² FLOP per iteration and is bound by
//     fp32 operations: 67 TFLOP/s on the CUDA cores (TF32 or the tensor
//     cores would break parity with the fp32 reference).  Splitting the
//     iteration per block lets every block's product use the whole card and
//     read the Σ̃ᵀ slab (B x p_pad) once from memory, where one CTA per
//     q-tile looping over all blocks would stream all of Σ̃ (256 MB at
//     p = 8192) once per CTA.  One main loop (sgemm_mainloop) serves the
//     correction and the suffix product; what it does about each limit:
//       - Shared-memory rate.  An SM delivers 32 floats of shared memory
//         per clock to its 128 FP32 lanes, so an SGEMM must read at most
//         0.25 floats per FMA.  Each thread holds an 8 x 8 accumulator
//         (2·BM threads per BM x 128 CTA tile; warps of 32 x 64, lanes
//         4 x 8; a thread's rows are 4 apart and its columns two runs of 4,
//         32 apart): per k it reads 8 A and 8 B floats for 64 FMAs, exactly
//         that 0.25, against 0.5 for the 4 x 4 tile this loop replaced.  At
//         that ratio the loop runs the FMA and shared-memory pipes at the
//         same rate, so the pair, not either alone, caps it; a larger tile
//         per thread (8 x 16) is the lever past it.
//       - Bank conflicts.  A stays [row][k] in shared memory, as a copy
//         lands it (Σ̃ᵀ rows are k-contiguous and cp.async cannot
//         transpose); a thread reads several consecutive k of each of its
//         rows at once (the compiler widens the pairs to 16-byte reads), and
//         rows padded to 20 floats (24 bf16) put the 4 rows a warp reads in
//         4 different bank groups.  B is [k][q] as in memory; 8 lanes read
//         128 contiguous bytes.
//       - Latency.  A ring of 4 stages of 16 k, filled by 16-byte cp.async
//         3 steps ahead of the compute, with one barrier per step.  At 16 k
//         a stage is 18 KB (26 KB with the staged dĤ), so two 256-thread
//         CTAs share an SM (16 warps to hide shared-memory latency), within
//         128 registers a thread; chip_smoke.py prints the compiler's
//         register and spill counts.
//       - Idle SMs.  The planner (kernels/quantease_cd.py: plan_corr)
//         counts waves of the CTAs an SM holds at the tile and splits k
//         where a block's tiles leave the last wave mostly idle; the partial
//         sums go through qe_corr_reduce_kernel in split order, so a repeat
//         is bit-identical.
//     Blocks of fewer than 128 rows take the 64-row instance of the loop.
//   * The rolling Δ of the fused engine (rows < col0 from this iteration,
//     rows >= col0 from the previous one) is read from two global buffers:
//     each k row of a stage picks its source in the copy, so a k-step that
//     straddles col0 (B not a multiple of 16) needs no masked path.  The
//     outlier-aware correction needs δŴ − dĤ_prev below col0: it stages the
//     dĤ_prev tile beside Δ there and subtracts it in shared memory, once
//     per element, in the thread that copied it (bf16 mode rounds Δ in the
//     same pass).  The alternative, a sweep that also writes δŴ − dĤ_prev
//     to a buffer of its own (one more B x q store per block), keeps the
//     copy plain; chip_smoke.py times both sides of that trade, and on the
//     H100 the plain-Δ correction plus a stand-in store came out 1-2 %
//     faster in device time.  The staged tile is kept: the other way needs
//     the sweep kernel to write a second output (or a launch per block to
//     form it) and a p_pad x q buffer, for that 1-2 %.
//   * The sweep (kernel 1) is a dependent chain over the B columns: column
//     i's β = β0[i] + Σ_{j<i} Σ̃_blk[j, i]·Δ[j] needs every earlier column's
//     Δ, so it is parallel only over rows.  Its least traffic is 6·B·q +
//     B² floats per group (0.023 ms at G=4, q=3072, B=256) and its FMAs
//     B²/2 per row; what bounds it is the chain: B columns, each one
//     division, a rounding and a handful of dependent adds long.  Four
//     things keep a sweep from that, and the design does this about each:
//       - The long dot on the chain (column i dots i terms).  Columns go in
//         panels of P = 16 (panels of 32 measured 9-58 % slower on the H100
//         at every path shape and spilled 124 bytes, so they were dropped).  Inside a panel each row's thread adds a
//         column's Δ into the β of the panel's later columns as soon as it
//         is known, in registers (sweep_panel), so one FMA links a column to
//         the next; after the panel all 256 threads add its terms into the
//         later columns' sums in shared memory, 4 x 4 register tiles off the
//         chain (panel_update).  The total FMA count is unchanged, and each
//         β is still one FMA chain over ascending j, so every plan gives
//         bit-identical results.
//       - Global memory on the chain.  The chain reads shared memory only:
//         panel p + 1's β0, Ŵ_old, s, z and Σ̃ᵀ triangle arrive by 16-byte
//         cp.async (4-byte where a row is not 16-byte aligned: q not a
//         multiple of 4, unaligned out= views) into a double buffer while
//         panel p runs, the later columns' Σ̃ᵀ tile while its chain runs;
//         Ŵ_new and Δ leave a panel at a time as coalesced stores from
//         shared memory.
//       - Σ̃ re-read for every few rows.  A CTA sweeps R rows (32 or 64) with
//         256 threads and stages each Σ̃_blkᵀ element it needs once (the
//         lower triangle, a panel tile at a time), for all its rows.
//       - Too few rows to fill the card (3,072 at G = 1: 96 CTAs of 32 rows
//         for 132 SMs).  CTAs of 16 rows would give every SM one, but each
//         stages the same Σ̃ᵀ tiles for half the rows, and on the H100 they
//         measured 8-14 % slower there, so they were dropped: the planner
//         (kernels/quantease_cd.py: plan_sweep) takes 32 rows, and 64 where
//         that saves a round of resident CTAs.
//     Staging 8 or 32 Σ̃ᵀ rows per 8-row warp measured slower on the H100
//     (an earlier version): the footprint per warp cut the warps an SM held.
//     Here one staged tile serves all a CTA's rows.
//   * The exact residual of the outlier-aware iteration is a block-upper-
//     triangular product, nb(nb+1)/2 block pairs of 2·B²·q FLOP: about half
//     the correction's, and as fp32-bound.  The TPU kernel adds each block's
//     share as it goes, with R resident in VMEM; here δŴ is complete after
//     the last block, so one launch over the whole card computes R on the
//     same main loop, skipping the k-steps left of the block diagonal and
//     dispatching the tiles with the longest k ranges first.
//
// Rounding matches the reference: β / s is an IEEE division (no reciprocal),
// rintf rounds half to even like jnp.round, the clip comes after adding z,
// s is clamped to >= 1e-12, fp32 accumulation throughout.  With bf16
// correction operands only Σ̃ᵀ and Δ of the product are rounded to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlock = 256;      // the wrapper's MAX_BLOCK
constexpr int kSweepThreads = 256;  // threads of a sweep CTA (the wrapper's SWEEP_THREADS)
constexpr int kSigPad = 4;          // floats of padding per staged Σ̃ᵀ row
constexpr int kSweepMinCtas = 3;    // per SM: caps a sweep thread at 80 registers

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The reference's snap, rounding step by step (no contraction into FMAs).
__device__ __forceinline__ float qe_snap(float beta, float s, float z, float top) {
  s = fmaxf(s, 1e-12f);
  float c = rintf(__fdiv_rn(beta, s)) + z;
  c = fminf(fmaxf(c, 0.0f), top);
  return __fmul_rn(c - z, s);
}

// ---------------------------------------------------------------------------
// Kernel 1: the block sweep, in column panels.
// ---------------------------------------------------------------------------

// Shared memory of a sweep CTA, in floats (every piece a multiple of 4, so
// each starts 16-byte aligned):
//   acc   [bsz][R]       per column k and row, Σ̃_blk[j, k]·Δ[j] summed over the
//                        columns j of the earlier panels; a swept column's
//                        slot then holds its Ŵ_new
//   ring  [2][4][P][R]   β0, Ŵ_old, s, z of a panel, double-buffered
//   dbuf  [P][R]         the panel's Δ
//   tri   [2][P][P + 4]  Σ̃ᵀ rows of the panel's columns at the panel's
//                        columns (its lower triangle is read), double-buffered
//   later [bsz − P][P + 4]  Σ̃ᵀ rows of the later columns at the panel's columns
template <int P, int R>
constexpr int sweep_smem_floats(int bsz) {
  return bsz * R + 8 * P * R + P * R + 2 * P * (P + kSigPad) +
         (bsz > P ? bsz - P : 0) * (P + kSigPad);
}

// Copies a tile of n_rows x W floats (W a multiple of 4) of a row-major
// global matrix into shared memory by cp.async, issued by the n_thr threads
// ct = 0 .. n_thr − 1: element (i, j) goes from src[i·src_ld + j] to
// dst[i·dst_ld + j] when i < n_i and j < n_j, and is 0 otherwise, so nothing
// outside the operand is read.  A whole 16-byte chunk goes by one 16-byte
// copy when vec (src and src_ld 16-byte aligned), any other by 4-byte copies.
template <int W>
__device__ __forceinline__ void stage_tile(float* dst, int dst_ld, const float* src,
                                           long long src_ld, int n_rows, int n_i, int n_j,
                                           bool vec, int ct, int n_thr) {
  constexpr int kChunks = W / 4;
  for (int e = ct; e < n_rows * kChunks; e += n_thr) {
    const int i = e / kChunks, j = (e % kChunks) * 4;
    float* d = dst + i * dst_ld + j;
    if (i >= n_i || j >= n_j) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float* s = src + i * src_ld + j;
    if (vec && j + 4 <= n_j) {
      cp_async16(d, s);
      continue;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (j + t < n_j)
        cp_async4(d + t, s + t);
      else
        d[t] = 0.f;
    }
  }
}

// The sweep of one panel's columns c0 .. c0 + P − 1 for this thread's row
// (thread tid < R owns row r0 + tid).  β of column c0 + k enters as acc (the
// earlier panels' sum) and takes the panel's own terms eagerly: as soon as
// Δ of column c0 + j is known, it is added into the β of every later column
// of the panel, held in registers.  So the chain from one column to the
// next is one FMA, the snap and a subtraction; each β is still the
// reference's sum β0 + Σ_{j<i} Σ̃_blk[j, i]·Δ[j], accumulated in ascending j.
// The loop only loads from shared memory (Ŵ_new and Δ are kept in registers
// and stored after it), so every operand load can be issued ahead of the
// chain; it compiles to 80 registers with no spill at P = 16.
template <int P, int R>
__device__ __forceinline__ void sweep_panel(float* acc, const float* st, const float* tr,
                                            float* dbuf, int c0, int bsz, int n_levels,
                                            int quantize) {
  constexpr int kLd = P + kSigPad;
  const int tid = threadIdx.x;
  const float top = (float)(n_levels - 1);
  float bet[P], nv[P];
#pragma unroll
  for (int k = 0; k < P; ++k) bet[k] = c0 + k < bsz ? acc[(c0 + k) * R + tid] : 0.f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float beta = __fadd_rn(st[j * R + tid], bet[j]);
    nv[j] = quantize ? qe_snap(beta, st[(2 * P + j) * R + tid], st[(3 * P + j) * R + tid], top)
                     : beta;
    bet[j] = __fsub_rn(st[(P + j) * R + tid], nv[j]);  // Δ of column c0 + j
#pragma unroll
    for (int k = j + 1; k < P; ++k) bet[k] = fmaf(tr[k * kLd + j], bet[j], bet[k]);
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    dbuf[j * R + tid] = bet[j];
    if (c0 + j < bsz) acc[(c0 + j) * R + tid] = nv[j];
  }
}

// The panel update: acc[k] += Σ_{j in panel} Σ̃_blk[j, k]·Δ[j] for every later
// column k and row, by all the CTA's threads, off the column chain.  A
// thread holds a 4 x 4 tile (4 columns k, kKS apart, by 4 consecutive rows)
// and adds the panel's terms in ascending j, so each acc element is one FMA
// chain in j whatever the panel width.  The 4 columns of one thread sit in
// kKS consecutive staged rows across the warp (padded to P + 4 floats: no
// bank conflict); the 4 rows are one 16-byte read of Δ, shared by the warp.
template <int P, int R>
__device__ __forceinline__ void panel_update(float* acc, const float* dbuf, const float* later,
                                             int kbeg, int bsz) {
  constexpr int kLd = P + kSigPad;
  constexpr int kRG = R / 4;                  // groups of 4 rows
  constexpr int kKS = kSweepThreads / kRG;    // column slots
  const int rg = threadIdx.x % kRG, ks = threadIdx.x / kRG;
  for (int kb = kbeg + ks; kb < bsz; kb += 4 * kKS) {
    float a[4][4];
    bool ok[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = kb + m * kKS;
      ok[m] = k < bsz;
      const float4 v = ok[m] ? *reinterpret_cast<const float4*>(acc + k * R + 4 * rg)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      a[m][0] = v.x;
      a[m][1] = v.y;
      a[m][2] = v.z;
      a[m][3] = v.w;
    }
#pragma unroll
    for (int jc = 0; jc < P; jc += 4) {
      float dl[4][4], sv[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 v = *reinterpret_cast<const float4*>(dbuf + (jc + jj) * R + 4 * rg);
        dl[jj][0] = v.x;
        dl[jj][1] = v.y;
        dl[jj][2] = v.z;
        dl[jj][3] = v.w;
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 v = ok[m] ? *reinterpret_cast<const float4*>(
                                     later + (kb + m * kKS - kbeg) * kLd + jc)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        sv[m][0] = v.x;
        sv[m][1] = v.y;
        sv[m][2] = v.z;
        sv[m][3] = v.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int t = 0; t < 4; ++t) a[m][t] = fmaf(sv[m][jj], dl[jj][t], a[m][t]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (ok[m])
        *reinterpret_cast<float4*>(acc + (kb + m * kKS) * R + 4 * rg) =
            make_float4(a[m][0], a[m][1], a[m][2], a[m][3]);
  }
}

// One CTA sweeps R rows (r0 .. r0 + R − 1) of group g through all bsz
// columns, panel by panel.  The warps that hold the R chain threads issue
// no copies: a warp that issues its share of a panel's copies (~24 KB at
// B = 256) stalls for as long as the SM's L2 bandwidth takes to move them,
// so the chain would wait behind them (on the H100 that layout measured
// 16-30 % slower at the six path shapes; PERF.md).  Per panel p (columns
// c0 = p·P ..):
//   S0  panel p's operands and Σ̃ᵀ triangle have landed; acc holds every
//       earlier panel's terms.  The other warps start the copies of panel
//       p's later Σ̃ᵀ tile and of panel p + 1's operands and triangle, while
//   the R chain threads sweep the panel's columns (sweep_panel);
//   S1  the later tile has landed; every thread stores the panel's Ŵ_new and
//       Δ (coalesced, from shared memory) and adds the panel's terms to the
//       later columns (panel_update).
// Per-row operands: element (column i, row r) of group g at g·gs + i·q + r;
// Σ̃ᵀ: row i = Σ̃_blk[:, i] at g·sig_gs + i·sig_ld.  vec: the row operands
// and outputs allow 16-byte accesses (q, gs and every base a multiple of 4
// floats); svec: Σ̃ᵀ does (sig_ld, sig_gs, base).
template <int P, int R>
__global__ void __launch_bounds__(kSweepThreads, kSweepMinCtas)
qe_block_sweep_kernel(const float* __restrict__ beta0, const float* __restrict__ sig,
                      const float* __restrict__ w_old, const float* __restrict__ scale,
                      const float* __restrict__ zero, float* __restrict__ w_new,
                      float* __restrict__ delta, int q, int bsz, long long gs, long long sig_gs,
                      int sig_ld, int n_levels, int quantize, int vec, int svec) {
  static_assert(P % 4 == 0 && R % 4 == 0 && kSweepThreads % (R / 4) == 0 && R <= kSweepThreads,
                "sweep tile");
  constexpr int kLd = P + kSigPad;
  extern __shared__ float4 sweep_smem[];  // 16-byte aligned
  float* acc = reinterpret_cast<float*>(sweep_smem);
  float* ring = acc + bsz * R;
  float* dbuf = ring + 8 * P * R;
  float* tri = dbuf + P * R;
  float* later = tri + 2 * P * kLd;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * R;
  const long long go = (long long)blockIdx.y * gs + r0;
  const float* sg = sig + (long long)blockIdx.y * sig_gs;
  const int n_panels = (bsz + P - 1) / P;
  constexpr int kChainWarps = (R + 31) / 32;
  constexpr int kCopiers = kSweepThreads - 32 * kChainWarps;
  const int ct = tid - 32 * kChainWarps;  // this thread's place among the copiers

  auto stage_panel = [&](int p, int c, int n) {  // panel p's row operands and Σ̃ᵀ triangle
    const int c0 = p * P;
    float* st = ring + (p & 1) * 4 * P * R;
    const long long o = go + (long long)c0 * q;
    stage_tile<R>(st, R, beta0 + o, q, P, bsz - c0, q - r0, vec, c, n);
    stage_tile<R>(st + P * R, R, w_old + o, q, P, bsz - c0, q - r0, vec, c, n);
    if (quantize) {
      stage_tile<R>(st + 2 * P * R, R, scale + o, q, P, bsz - c0, q - r0, vec, c, n);
      stage_tile<R>(st + 3 * P * R, R, zero + o, q, P, bsz - c0, q - r0, vec, c, n);
    }
    stage_tile<P>(tri + (p & 1) * P * kLd, kLd, sg + (long long)c0 * sig_ld + c0, sig_ld, P,
                  bsz - c0, bsz - c0, svec, c, n);
  };

  for (int e = tid; e < bsz * R; e += kSweepThreads) acc[e] = 0.f;
  stage_panel(0, tid, kSweepThreads);  // nothing to overlap yet: every thread copies
  cp_async_commit();
  for (int p = 0; p < n_panels; ++p) {
    const int c0 = p * P;
    const int n_later = bsz - c0 - P;
    cp_async_wait<0>();
    __syncthreads();  // S0
    if (ct >= 0) {
      if (n_later > 0)
        stage_tile<P>(later, kLd, sg + (long long)(c0 + P) * sig_ld + c0, sig_ld, n_later,
                      n_later, bsz - c0, svec, ct, kCopiers);
      cp_async_commit();
      if (p + 1 < n_panels) stage_panel(p + 1, ct, kCopiers);
      cp_async_commit();
    } else if (tid < R) {
      sweep_panel<P, R>(acc, ring + (p & 1) * 4 * P * R, tri + (p & 1) * P * kLd, dbuf, c0, bsz,
                        n_levels, quantize);
    }
    cp_async_wait<1>();
    __syncthreads();  // S1
    for (int e = tid; e < 2 * P * (R / 4); e += kSweepThreads) {
      const bool is_d = e >= P * (R / 4);
      const int f = is_d ? e - P * (R / 4) : e;
      const int j = f / (R / 4), rc = (f % (R / 4)) * 4;
      if (c0 + j >= bsz || r0 + rc >= q) continue;
      const float* src = is_d ? dbuf + j * R + rc : acc + (c0 + j) * R + rc;
      float* dst = (is_d ? delta : w_new) + go + (long long)(c0 + j) * q + rc;
      if (vec && r0 + rc + 4 <= q) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      } else {
        for (int t = 0; t < 4 && r0 + rc + t < q; ++t) dst[t] = src[t];
      }
    }
    if (n_later > 0) panel_update<P, R>(acc, dbuf, later, c0 + P, bsz);
  }
}

template <typename ST>
__device__ __forceinline__ float round_operand(float v) { return v; }
template <>
__device__ __forceinline__ float round_operand<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename ST>
__device__ __forceinline__ ST st_zero() { return ST(0.f); }
template <>
__device__ __forceinline__ __nv_bfloat16 st_zero<__nv_bfloat16>() { return __float2bfloat16_rn(0.f); }

// ---------------------------------------------------------------------------
// The correction and suffix SGEMM: one main loop, a 128- and a 64-row tile.
// ---------------------------------------------------------------------------

constexpr int kCols = 128;  // output columns (of q) per CTA
constexpr int kStep = 16;   // k-step: the depth of one shared-memory stage
constexpr int kStages = 4;  // stages of the cp.async ring
constexpr int kMinCtas = 2;  // per SM: caps registers at 128 a thread for the 128-row tile

// Per type of the Σ̃ᵀ operand: elements per 16-byte copy, and the padded
// row length (elements) of the A stage, stored [row][k].  The padding puts
// the four rows a warp reads at once (lanes 0-7, 8-15, ... one row each) in
// four different bank groups: 20 floats (80 B) or 24 bf16 (48 B) per row.
template <typename ST>
struct AOp;
template <>
struct AOp<float> {
  static constexpr int kPer = 4;
  static constexpr int kLd = kStep + 4;
};
template <>
struct AOp<__nv_bfloat16> {
  static constexpr int kPer = 8;
  static constexpr int kLd = kStep + 8;
};

// Shared-memory layout of one stage: A [BM][kLd], B [kStep][kCols] fp32 and,
// for the outlier-aware correction, dĤ_prev [kStep][kCols] beside it.
template <int BM, typename ST, bool kDh>
struct Ring {
  static constexpr int kThreads = 2 * BM;
  static constexpr int kABytes = BM * AOp<ST>::kLd * (int)sizeof(ST);
  static constexpr int kBBytes = kStep * kCols * 4;
  static constexpr int kStageBytes = kABytes + kBBytes * (kDh ? 2 : 1);
  static constexpr int kBytes = kStages * kStageBytes;
};

// Two consecutive k of one A row, as fp32 (bf16: a shift and a mask).
__device__ __forceinline__ void a_pair(const float* p, float& lo, float& hi) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  lo = v.x;
  hi = v.y;
}
__device__ __forceinline__ void a_pair(const __nv_bfloat16* p, float& lo, float& hi) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// This thread's place in a BM x 128 tile of 2·BM threads: warps of 32 rows
// x 64 columns (BM/32 down, 2 across), lanes 4 x 8.  Its 8 x 8 outputs are
// rows ra + 4i (i < 8) and columns cb + j, cb + 32 + j (j < 4).
struct Lane {
  int ra, cb;
  __device__ __forceinline__ Lane() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    ra = (warp >> 1) * 32 + (lane >> 3);
    cb = (warp & 1) * 64 + (lane & 7) * 4;
  }
  __device__ __forceinline__ int col(int j) const { return cb + (j & 3) + (j >> 2) * 32; }
};

// The SGEMM main loop of the correction and suffix kernels, for one BM x 128
// output tile:
//   acc[i][j] = Σ_{k_begin <= k < k_end} A(row0 + ra + 4i, k) · B(k, r0 + col(j))
// in ascending k, fp32 FMA on the CUDA cores, where
//   A(c, k) = a[c·lda + k] for c < n_rows and k >= kmin(c), else 0, with
//             kmin(c) = (c / mask_bsz)·mask_bsz if mask_bsz > 0 (the suffix
//             mask) and 0 otherwise;
//   B(k, r) = (k < col0 ? bnew : bprev)[k·q + r] for r < q, else 0; with kDh,
//             dh[k·q + r] is subtracted below col0; with bf16 A, B is rounded
//             to bf16.
// Each k-step's A and B tiles go global -> shared by 16-byte cp.async into a
// ring of kStages stages, kStages − 1 steps ahead of the compute, with one
// barrier per step.  a_vec / b_vec say that the operands' rows allow 16-byte
// copies (aligned base, row length a multiple of 16 bytes); a chunk that is
// not whole (a ragged edge, a masked or out-of-range element) is loaded by
// masked scalar loads into the same stage instead, so nothing past an
// operand is read.  The dĤ subtraction and the bf16 rounding of B are done
// once per element in shared memory, by the thread that copied it, after
// its copies land and before the step's barrier.
template <int BM, typename ST, bool kDh>
__device__ __forceinline__ void sgemm_mainloop(
    const ST* __restrict__ a, int lda, int n_rows, int row0, int mask_bsz,
    const float* __restrict__ bprev, const float* __restrict__ bnew, const float* __restrict__ dh,
    int col0, int r0, int q, int k_begin, int k_end, bool a_vec, bool b_vec, char* smem,
    float (&acc)[8][8]) {
  using R = Ring<BM, ST, kDh>;
  constexpr int kThreads = R::kThreads;
  constexpr int kPer = AOp<ST>::kPer, kLd = AOp<ST>::kLd;
  constexpr int kARow = kStep / kPer;               // 16-byte chunks per A row
  constexpr int kAIter = BM * kARow / kThreads;     // A chunks per thread
  constexpr int kBRow = kCols / 4;                  // 16-byte chunks per B row
  constexpr int kBIter = kStep * kBRow / kThreads;  // B chunks per thread
  constexpr bool kRound = sizeof(ST) == 2;
  static_assert(kAIter >= 1 && kBIter >= 1 && BM % 32 == 0, "tile");
  const int tid = threadIdx.x;
  auto a_st = [&](int s) { return reinterpret_cast<ST*>(smem + s * R::kStageBytes); };
  auto b_st = [&](int s) {
    return reinterpret_cast<float*>(smem + s * R::kStageBytes + R::kABytes);
  };
  auto d_st = [&](int s) {
    return reinterpret_cast<float*>(smem + s * R::kStageBytes + R::kABytes + R::kBBytes);
  };

  auto load = [&](int s, int k0) {
    ST* as = a_st(s);
#pragma unroll
    for (int l = 0; l < kAIter; ++l) {
      const int e = tid + l * kThreads;
      const int row = e / kARow, kc = (e % kARow) * kPer;
      const int c = row0 + row, k = k0 + kc;
      const int kmin = mask_bsz > 0 ? c / mask_bsz * mask_bsz : 0;
      ST* dst = as + row * kLd + kc;
      const ST* src = a + (long long)c * lda + k;
      if (a_vec && c < n_rows && k >= kmin && k + kPer <= k_end) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int t = 0; t < kPer; ++t)
          dst[t] = (c < n_rows && k + t >= kmin && k + t < k_end) ? src[t] : st_zero<ST>();
      }
    }
    float* bs = b_st(s);
#pragma unroll
    for (int l = 0; l < kBIter; ++l) {
      const int e = tid + l * kThreads;
      const int kr = e / kBRow, rc = (e % kBRow) * 4;
      const int k = k0 + kr, r = r0 + rc;
      const bool lower = k < col0;
      const long long o = (long long)k * q + r;
      const float* src = (lower ? bnew : bprev) + o;
      float* dst = bs + kr * kCols + rc;
      float* ddst = kDh ? d_st(s) + kr * kCols + rc : nullptr;
      if (b_vec && k < k_end && r + 4 <= q) {
        cp_async16(dst, src);
        if (kDh && lower) cp_async16(ddst, dh + o);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const bool ok = k < k_end && r + t < q;
          dst[t] = ok ? src[t] : 0.f;
          if (kDh && lower) ddst[t] = ok ? dh[o + t] : 0.f;
        }
      }
    }
  };

  auto fixup = [&](int s, int k0) {
    float* bs = b_st(s);
#pragma unroll
    for (int l = 0; l < kBIter; ++l) {
      const int e = tid + l * kThreads;
      const int kr = e / kBRow, rc = (e % kBRow) * 4;
      const bool sub = kDh && k0 + kr < col0;
      if (!sub && !kRound) continue;
      float4* p = reinterpret_cast<float4*>(bs + kr * kCols + rc);
      float4 v = *p;
      if (sub) {
        const float4 d = *reinterpret_cast<const float4*>(d_st(s) + kr * kCols + rc);
        v.x -= d.x;
        v.y -= d.y;
        v.z -= d.z;
        v.w -= d.w;
      }
      v.x = round_operand<ST>(v.x);
      v.y = round_operand<ST>(v.y);
      v.z = round_operand<ST>(v.z);
      v.w = round_operand<ST>(v.w);
      *p = v;
    }
  };

  const Lane ln;
  auto compute = [&](int s) {
    const ST* as = a_st(s) + ln.ra * kLd;
    const float* bs = b_st(s) + ln.cb;
#pragma unroll
    for (int kk = 0; kk < kStep; kk += 2) {
      float a0[8], a1[8], b0[8], b1[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a_pair(as + 4 * i * kLd + kk, a0[i], a1[i]);
      ld4(bs + kk * kCols, b0);
      ld4(bs + kk * kCols + 32, b0 + 4);
      ld4(bs + (kk + 1) * kCols, b1);
      ld4(bs + (kk + 1) * kCols + 32, b1 + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a0[i], b0[j], acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a1[i], b1[j], acc[i][j]);
    }
  };

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int n_steps = k_end > k_begin ? (k_end - k_begin + kStep - 1) / kStep : 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load(s, k_begin + s * kStep);
    cp_async_commit();
  }
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step t have landed
    if (kDh || kRound) fixup(t % kStages, k_begin + t * kStep);
    __syncthreads();  // step t is visible; every thread is done with step t − 1
    const int nt = t + kStages - 1;
    if (nt < n_steps) load(nt % kStages, k_begin + nt * kStep);  // into step t − 1's stage
    cp_async_commit();
    compute(t % kStages);
  }
  cp_async_wait<0>();
}

// dst[0..3] = v[0..3] (+ add[0..3]) (− sub[0..3]), for the n > 0 columns left
// before q; 16-byte accesses when vec (all rows 16-byte aligned) and n >= 4.
__device__ __forceinline__ void store4(float* dst, const float* add, const float* sub,
                                       const float* v, int n, bool vec) {
  if (vec && n >= 4) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (add) o = *reinterpret_cast<const float4*>(add);
    if (sub) {
      const float4 d = *reinterpret_cast<const float4*>(sub);
      o.x -= d.x;
      o.y -= d.y;
      o.z -= d.z;
      o.w -= d.w;
    }
    o.x += v[0];
    o.y += v[1];
    o.z += v[2];
    o.w += v[3];
    *reinterpret_cast<float4*>(dst) = o;
    return;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= n) break;
    float o = add ? add[t] : 0.f;
    if (sub) o -= sub[t];
    dst[t] = o + v[t];
  }
}

// The rolling-Δ correction of the block starting at col0:
//   base_out[g, col0 + c, r] = base[g, col0 + c, r] (− dh[g, col0 + c, r])
//       + Σ_k Σ̃ᵀ[g, col0 + c, k] · Δ[g, k, r],
//   Δ[k] = k < col0 ? dnew[k] (− dh[k]) : dprev[k].
// kOutlier adds the −dh terms of the outlier-aware iteration: dnew then holds
// this iteration's pure δŴ, and the value published to later blocks,
// δŴ − dĤ_prev, is formed in shared memory from a staged dĤ tile.
// Grid: (q tiles, row tiles of the block, G·splits); blockIdx.z = g·splits + s
// covers k in [s·k_chunk, (s+1)·k_chunk).  With one split the tile writes
// base_out itself; with more it writes its partial sum to part[g, s, c, r]
// and qe_corr_reduce_kernel finishes.
template <int BM, typename ST, bool kOutlier>
__global__ void __launch_bounds__(2 * BM, kMinCtas)
qe_block_corr_kernel(const ST* __restrict__ sig, const float* __restrict__ dprev,
                     const float* __restrict__ dnew, const float* __restrict__ dh,
                     const float* __restrict__ base, float* __restrict__ base_out,
                     float* __restrict__ part, int p_pad, int q, int col0, int bsz, int splits,
                     int k_chunk, int a_vec, int b_vec) {
  extern __shared__ float4 ring[];  // 16-byte aligned
  char* smem = reinterpret_cast<char*>(ring);
  const int g = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int row0 = blockIdx.y * BM;
  const int r0 = blockIdx.x * kCols;
  const long long gp = (long long)g * p_pad;
  const int k_begin = split * k_chunk;
  float acc[8][8];
  sgemm_mainloop<BM, ST, kOutlier>(sig + (gp + col0) * p_pad, p_pad, bsz, row0, 0, dprev + gp * q,
                                   dnew + gp * q, kOutlier ? dh + gp * q : nullptr, col0, r0, q,
                                   k_begin, min(p_pad, k_begin + k_chunk), a_vec, b_vec, smem, acc);
  const Lane ln;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = row0 + ln.ra + 4 * i;
    if (c >= bsz) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + ln.col(4 * h);
      if (r >= q) continue;
      if (splits > 1) {
        store4(part + ((long long)blockIdx.z * bsz + c) * q + r, nullptr, nullptr, &acc[i][4 * h],
               q - r, b_vec);
      } else {
        const long long o = (gp + col0 + c) * q + r;
        store4(base_out + o, base + o, kOutlier ? dh + o : nullptr, &acc[i][4 * h], q - r, b_vec);
      }
    }
  }
}

// Split-K epilogue: base_out = base (− dh) + Σ_s part[g, s] in split order.
template <bool kOutlier>
__global__ void __launch_bounds__(256)
qe_corr_reduce_kernel(const float* __restrict__ part, const float* __restrict__ dh,
                      const float* __restrict__ base, float* __restrict__ base_out, int G,
                      int p_pad, int q, int col0, int bsz, int splits) {
  const long long n = (long long)bsz * q;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * G) return;
  const long long g = i / n, e = i % n;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(g * splits + s) * n + e];
  const long long o = (g * p_pad + col0) * q + e;
  base_out[o] = (kOutlier ? base[o] - dh[o] : base[o]) + acc;
}

// The exact residual of the outlier-aware iteration, after its last block:
//   r[g, c, r] = base_out[g, c, r] + Σ_{k ≥ blk(c)·bsz} Σ̃ᵀ[g, c, k] · δŴ[g, k, r]
// a block-upper-triangular product (Σ̃ ⊙ block-suffix mask) on the same main
// loop.  A tile starts its k loop at the first block any of its rows reads
// (rounded down to the k-step), so the tiles left of the block diagonal are
// never loaded; rows whose own block starts later are masked in the A load.
// The 1-D grid is ordered row tile slowest, so the tiles with the longest k
// ranges (row tile 0) are dispatched first and the short ones fill the tail.
template <int BM, typename ST>
__global__ void __launch_bounds__(2 * BM, kMinCtas)
qe_suffix_resid_kernel(const ST* __restrict__ sig, const float* __restrict__ dpure,
                       const float* __restrict__ base_out, float* __restrict__ r_out, int G,
                       int p_pad, int q, int bsz, int a_vec, int b_vec) {
  extern __shared__ float4 ring[];  // 16-byte aligned
  char* smem = reinterpret_cast<char*>(ring);
  const int n_ct = (q + kCols - 1) / kCols;
  const int ct = blockIdx.x % n_ct;
  const int rest = blockIdx.x / n_ct;
  const int g = rest % G;
  const int row0 = rest / G * BM;
  const int r0 = ct * kCols;
  const long long gp = (long long)g * p_pad;
  const float* dg = dpure + gp * q;
  float acc[8][8];
  sgemm_mainloop<BM, ST, false>(sig + gp * p_pad, p_pad, p_pad, row0, bsz, dg, dg, nullptr, 0,
                                r0, q, row0 / bsz * bsz / kStep * kStep, p_pad, a_vec, b_vec,
                                smem, acc);
  const Lane ln;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = row0 + ln.ra + 4 * i;
    if (c >= p_pad) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + ln.col(4 * h);
      if (r >= q) continue;
      const long long o = (gp + c) * q + r;
      store4(r_out + o, base_out + o, nullptr, &acc[i][4 * h], q - r, b_vec);
    }
  }
}

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

// The sweep's plans: (panel columns, rows per CTA); the wrapper's
// SWEEP_PANEL x SWEEP_ROWS.
#define QE_SWEEP_PLANS(X) X(16, 32) X(16, 64)

template <int P, int R>
cudaError_t sweep_tile(cudaStream_t st, const float* beta0, const float* sig, const float* w_old,
                       const float* scale, const float* zero, float* w_new, float* delta, int G,
                       int q, int bsz, long long gs, long long sig_gs, int sig_ld, int n_levels,
                       int quantize, int vec, int svec) {
  auto kern = qe_block_sweep_kernel<P, R>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         4 * sweep_smem_floats<P, R>(kMaxBlock));
  if (err != cudaSuccess) return err;
  dim3 grid((q + R - 1) / R, G);
  kern<<<grid, kSweepThreads, 4 * sweep_smem_floats<P, R>(bsz), st>>>(
      beta0, sig, w_old, scale, zero, w_new, delta, q, bsz, gs, sig_gs, sig_ld, n_levels,
      quantize, vec, svec);
  return cudaGetLastError();
}

template <int P, int R>
int sweep_occupancy(int bsz) {
  auto kern = qe_block_sweep_kernel<P, R>;
  const int smem = 4 * sweep_smem_floats<P, R>(bsz);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         4 * sweep_smem_floats<P, R>(kMaxBlock));
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kSweepThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

template <int BM, typename ST, bool kOutlier>
cudaError_t corr_tile(dim3 grid, cudaStream_t st, const void* sig, const float* dprev,
                      const float* dnew, const float* dh, const float* base, float* base_out,
                      float* part, int p_pad, int q, int col0, int bsz, int splits, int k_chunk,
                      int a_vec, int b_vec) {
  auto kern = qe_block_corr_kernel<BM, ST, kOutlier>;
  constexpr int smem = Ring<BM, ST, kOutlier>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, 2 * BM, smem, st>>>((const ST*)sig, dprev, dnew, dh, base, base_out, part, p_pad,
                                   q, col0, bsz, splits, k_chunk, a_vec, b_vec);
  return cudaGetLastError();
}

template <int BM, typename ST, bool kOutlier>
int corr_occupancy() {
  auto kern = qe_block_corr_kernel<BM, ST, kOutlier>;
  constexpr int smem = Ring<BM, ST, kOutlier>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, 2 * BM, smem);
  return err == cudaSuccess ? n : -(int)err;
}

template <int BM, typename ST>
cudaError_t suffix_tile(cudaStream_t st, const void* sig, const float* dpure,
                        const float* base_out, float* r, int G, int p_pad, int q, int bsz,
                        int a_vec, int b_vec) {
  auto kern = qe_suffix_resid_kernel<BM, ST>;
  constexpr int smem = Ring<BM, ST, false>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long n = (long long)((q + kCols - 1) / kCols) * G * ((p_pad + BM - 1) / BM);
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)n, 2 * BM, smem, st>>>((const ST*)sig, dpure, base_out, r, G, p_pad, q, bsz,
                                         a_vec, b_vec);
  return cudaGetLastError();
}

// The k range of each split: ceil(ceil(p_pad / kStep) / splits) k-steps,
// the last one short; 0 if a split would be empty.
int split_chunk(int p_pad, int splits) {
  const int steps = (p_pad + kStep - 1) / kStep;
  const int chunk = (steps + splits - 1) / splits * kStep;
  return (long long)(splits - 1) * chunk < p_pad ? chunk : 0;
}

bool a_rows_vec(const void* sig, int sig_bf16, int p_pad) {
  return aligned16(sig) && p_pad % (sig_bf16 ? AOp<__nv_bfloat16>::kPer : AOp<float>::kPer) == 0;
}

template <bool kOutlier>
int launch_corr(const void* sig, int sig_bf16, const float* dprev, const float* dnew,
                const float* dh, const float* base, float* base_out, float* part, int tile_rows,
                int splits, int G, int p_pad, int q, int col0, int bsz, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || q <= 0 || bsz <= 0) return 0;
  if ((tile_rows != 64 && tile_rows != 128) || splits < 1 || (splits > 1 && part == nullptr) ||
      (long long)G * splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int k_chunk = split_chunk(p_pad, splits);
  if (k_chunk == 0) return (int)cudaErrorInvalidValue;
  const int a_vec = a_rows_vec(sig, sig_bf16, p_pad);
  const int b_vec = q % 4 == 0 && aligned16(dprev) && aligned16(dnew) && aligned16(dh) &&
                    aligned16(base) && aligned16(base_out) && aligned16(part);
  dim3 grid((q + kCols - 1) / kCols, (bsz + tile_rows - 1) / tile_rows, G * splits);
  cudaStream_t st = (cudaStream_t)stream;
#define QE_CORR(BM, ST)                                                                      \
  corr_tile<BM, ST, kOutlier>(grid, st, sig, dprev, dnew, dh, base, base_out, part, p_pad, q, \
                              col0, bsz, splits, k_chunk, a_vec, b_vec)
  if (tile_rows == 128)
    err = sig_bf16 ? QE_CORR(128, __nv_bfloat16) : QE_CORR(128, float);
  else
    err = sig_bf16 ? QE_CORR(64, __nv_bfloat16) : QE_CORR(64, float);
#undef QE_CORR
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = (long long)G * bsz * q;
  qe_corr_reduce_kernel<kOutlier><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      part, dh, base, base_out, G, p_pad, q, col0, bsz, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel 1 over G groups, on panels of `panel` columns and CTAs of `rows`
// rows (16; 32 or 64).  Returns the CUDA error of the launch.
int qe_block_sweep(const float* beta0, const float* sig, const float* w_old,
                   const float* scale, const float* zero, float* w_new, float* delta,
                   int G, int q, int bsz, long long gs, long long sig_gs, int sig_ld,
                   int n_levels, int quantize, int panel, int rows, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || q <= 0 || bsz <= 0) return 0;
  if (bsz > kMaxBlock || G > 65535) return (int)cudaErrorInvalidValue;
  const int vec = q % 4 == 0 && gs % 4 == 0 && aligned16(beta0) && aligned16(w_old) &&
                  aligned16(scale) && aligned16(zero) && aligned16(w_new) && aligned16(delta);
  const int svec = sig_ld % 4 == 0 && sig_gs % 4 == 0 && aligned16(sig);
  cudaStream_t st = (cudaStream_t)stream;
#define QE_SWEEP(P, R)                                                                         \
  if (panel == P && rows == R)                                                                 \
    return (int)sweep_tile<P, R>(st, beta0, sig, w_old, scale, zero, w_new, delta, G, q, bsz, gs, \
                                 sig_gs, sig_ld, n_levels, quantize, vec, svec);
  QE_SWEEP_PLANS(QE_SWEEP)
#undef QE_SWEEP
  return (int)cudaErrorInvalidValue;
}

// CTAs of the sweep kernel at a plan resident per SM for a block of bsz
// columns (its registers and shared memory against the SM's); negative:
// minus the CUDA error.
int qe_sweep_ctas_per_sm(int panel, int rows, int bsz, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  if (bsz <= 0 || bsz > kMaxBlock) return -(int)cudaErrorInvalidValue;
#define QE_SWEEP(P, R) \
  if (panel == P && rows == R) return sweep_occupancy<P, R>(bsz);
  QE_SWEEP_PLANS(QE_SWEEP)
#undef QE_SWEEP
  return -(int)cudaErrorInvalidValue;
}

// Full-width rolling-Δ correction for the block starting at col0, on a tile
// of tile_rows (64 or 128) rows with k split `splits` ways.  sig_bf16
// selects bf16 Σ̃ᵀ operands (Δ is then rounded to bf16 too).  part:
// splits·G·bsz·q floats of scratch when splits > 1 (else unused).
int qe_block_corr(const void* sig, int sig_bf16, const float* dprev, const float* dnew,
                  const float* base, float* base_out, float* part, int tile_rows, int splits,
                  int G, int p_pad, int q, int col0, int bsz, void* stream, int device) {
  return launch_corr<false>(sig, sig_bf16, dprev, dnew, nullptr, base, base_out, part,
                            tile_rows, splits, G, p_pad, q, col0, bsz, stream, device);
}

// The outlier-aware iteration's correction: β0 = base − dh + Σ̃ᵀ[blk, :]·Δ,
// Δ = dpure − dh below col0 and dprev from col0 on.
int qe_outlier_corr(const void* sig, int sig_bf16, const float* dprev, const float* dpure,
                    const float* dh, const float* base, float* base_out, float* part,
                    int tile_rows, int splits, int G, int p_pad, int q, int col0, int bsz,
                    void* stream, int device) {
  return launch_corr<true>(sig, sig_bf16, dprev, dpure, dh, base, base_out, part, tile_rows,
                           splits, G, p_pad, q, col0, bsz, stream, device);
}

// The exact residual r = base_out + (Σ̃ ⊙ M)ᵀ·δŴ over all p_pad rows, on
// tiles of tile_rows rows.
int qe_suffix_resid(const void* sig, int sig_bf16, const float* dpure, const float* base_out,
                    float* r, int tile_rows, int G, int p_pad, int q, int bsz, void* stream,
                    int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || q <= 0 || bsz <= 0 || p_pad <= 0) return 0;
  if (tile_rows != 64 && tile_rows != 128) return (int)cudaErrorInvalidValue;
  const int a_vec = a_rows_vec(sig, sig_bf16, p_pad);
  const int b_vec = q % 4 == 0 && aligned16(dpure) && aligned16(base_out) && aligned16(r);
  cudaStream_t st = (cudaStream_t)stream;
#define QE_SUFFIX(BM, ST) suffix_tile<BM, ST>(st, sig, dpure, base_out, r, G, p_pad, q, bsz, a_vec, b_vec)
  if (tile_rows == 128)
    err = sig_bf16 ? QE_SUFFIX(128, __nv_bfloat16) : QE_SUFFIX(128, float);
  else
    err = sig_bf16 ? QE_SUFFIX(64, __nv_bfloat16) : QE_SUFFIX(64, float);
#undef QE_SUFFIX
  return (int)err;
}

// CTAs of the correction kernel resident per SM at a tile (its registers
// and shared memory against the SM's); negative: minus the CUDA error.
int qe_corr_ctas_per_sm(int tile_rows, int sig_bf16, int outlier, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  if (tile_rows != 64 && tile_rows != 128) return -(int)cudaErrorInvalidValue;
#define QE_OCC(BM)                                                                           \
  (sig_bf16 ? (outlier ? corr_occupancy<BM, __nv_bfloat16, true>()                           \
                       : corr_occupancy<BM, __nv_bfloat16, false>())                         \
            : (outlier ? corr_occupancy<BM, float, true>() : corr_occupancy<BM, float, false>()))
  const int n = tile_rows == 128 ? QE_OCC(128) : QE_OCC(64);
#undef QE_OCC
  return n;
}

}  // extern "C"
