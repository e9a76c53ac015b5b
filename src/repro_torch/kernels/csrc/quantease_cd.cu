// QuantEase coordinate-descent kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/quantease_cd.py:
//   * qe_block_sweep_kernel  <- quantease_block_sweep_pallas (_sweep_kernel):
//     the sequential CD sweep over the B columns of one column block.
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
//     fp32 operations (67 TFLOP/s outside the tensor cores; TF32 would break
//     parity with the fp32 reference).  It is tiled 64 x 64 with a 16-deep
//     k-tile in shared memory, a 4 x 4 register micro-tile, and the next
//     k-tile loaded into registers during the current one.  Splitting the
//     iteration per block lets every block's product use the whole card
//     (q/64 x B/64 CTAs per layer) and read the Σ̃ᵀ slab (B x p_pad) once
//     from memory, where one CTA per q-tile looping over all blocks would
//     stream all of Σ̃ (256 MB at p = 8192) once per CTA.  Where that leaves
//     fewer than two tiles per SM (one layer, q = 3072: 96 tiles at B = 128)
//     the wrapper splits k, and a second small kernel adds the partial sums
//     in a fixed order.
//   * The sweep is a dependent chain over the B columns: parallel only over
//     rows.  Per row it costs B²/2 FMAs per block and is latency-bound, so
//     the design shortens the chain and keeps global memory off it: four
//     lanes share each row's dot (8 rows per warp, one warp per CTA, so q/8
//     warps per group), and the next column's operands and Σ̃_blkᵀ row are
//     loaded while the current column computes.  The rows' Δ for the block
//     lives in shared memory ([B][8] floats); Σ̃_blkᵀ's rows are staged one
//     per column into a double buffer, since the fp32 diagonal block
//     (256 KB at B = 256) exceeds the 227 KB a block may use.  Staging 8 or
//     32 columns at once with cp.async measured slower on the H100: the
//     larger shared-memory footprint fits fewer warps per SM.
//   * The exact residual of the outlier-aware iteration is a block-upper-
//     triangular product, nb(nb+1)/2 block pairs of 2·B²·q FLOP: about half
//     the correction's, and as fp32-bound.  The TPU kernel adds each block's
//     share as it goes, with R resident in VMEM; here δŴ is complete after
//     the last block, so one launch over the whole card computes R with the
//     same SGEMM tile, skipping the k-tiles left of the block diagonal.
//   * The rolling Δ of the fused engine (rows < col0 from this iteration,
//     rows >= col0 from the previous one) is read from two global buffers,
//     so it needs no copy and no shared memory; at p_pad x q fp32 it is far
//     beyond shared memory, and it stays in the 50 MB L2 per block.
//
// Rounding matches the reference: β / s is an IEEE division (no reciprocal),
// rintf rounds half to even like jnp.round, the clip comes after adding z,
// s is clamped to >= 1e-12, fp32 accumulation throughout.  With bf16
// correction operands only Σ̃ᵀ and Δ of the product are rounded to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanesPerRow = 4;                    // lanes sharing one row's dot
constexpr int kSweepRows = 32 / kLanesPerRow;      // rows per sweep CTA (one warp)
constexpr int kMaxBlock = 256;                     // the wrapper's MAX_BLOCK
constexpr int kPrefetch = kMaxBlock / 32;          // Σ̃ᵀ row entries per lane

__device__ __forceinline__ float qe_snap(float beta, float s, float z, float top) {
  s = fmaxf(s, 1e-12f);
  float c = rintf(__fdiv_rn(beta, s)) + z;
  c = fminf(fmaxf(c, 0.0f), top);
  return (c - z) * s;
}

// The intra-block sweep of one warp's 8 rows, 4 lanes per row.  All per-row
// operands share one layout: element (column i, row r) of group g sits at
// g*gs + i*q + r.  For column i the 4 lanes of a row split the dot
// Σ̃_blk[:, i] · Δ over j < i (j ≡ lane mod 4) and combine it with two
// butterfly shuffles, so all four hold the same β.  While they do, the warp
// already loads column i + 1's row operands and Σ̃_blkᵀ row i + 1 into
// registers, and the row is parked in the other half of a double buffer
// after the dot: no global load is issued on the column-to-column chain.
__device__ void qe_sweep_rows(const float* __restrict__ beta0,
                              const float* __restrict__ sig,  // row i = Σ̃_blk[:, i]
                              int sig_ld,
                              const float* __restrict__ w_old,
                              const float* __restrict__ scale,
                              const float* __restrict__ zero,
                              float* __restrict__ w_new,
                              float* __restrict__ delta,
                              long long row_off, int q, int bsz, bool live,
                              int n_levels, int quantize,
                              float* dsm,    // [bsz][kSweepRows] shared: this warp's Δ
                              float* srow) {  // [2][bsz] shared: Σ̃ᵀ rows, double-buffered
  const int lane = threadIdx.x;
  const int row = lane / kLanesPerRow, sub = lane % kLanesPerRow;
  const float top = (float)(n_levels - 1);
  float b0 = 0.f, s = 1.f, z = 0.f, wo = 0.f;
  if (live) {
    b0 = beta0[row_off];
    wo = w_old[row_off];
    if (quantize) {
      s = scale[row_off];
      z = zero[row_off];
    }
  }
  for (int i = 0; i < bsz; ++i) {
    // Loads for column i + 1, in flight during column i's dot.
    const long long nxt = row_off + (long long)(i + 1) * q;
    const bool more = i + 1 < bsz;
    float nb0 = 0.f, ns = 1.f, nz = 0.f, nwo = 0.f;
    if (live && more) {
      nb0 = beta0[nxt];
      nwo = w_old[nxt];
      if (quantize) {
        ns = scale[nxt];
        nz = zero[nxt];
      }
    }
    float pre[kPrefetch];
#pragma unroll
    for (int t = 0; t < kPrefetch; ++t) {
      const int j = lane + 32 * t;
      pre[t] = (more && j <= i) ? sig[(long long)(i + 1) * sig_ld + j] : 0.f;
    }
    // β = β0 + Σ̃_blk[:, i] · Δ over the columns already swept (j < i).
    const float* cur = srow + (i & 1) * bsz;
    float a0 = 0.f, a1 = 0.f;
    int j = sub;
    for (; j + kLanesPerRow < i; j += 2 * kLanesPerRow) {
      a0 = fmaf(cur[j], dsm[j * kSweepRows + row], a0);
      a1 = fmaf(cur[j + kLanesPerRow], dsm[(j + kLanesPerRow) * kSweepRows + row], a1);
    }
    if (j < i) a0 = fmaf(cur[j], dsm[j * kSweepRows + row], a0);
    float acc = a0 + a1;
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    const float beta = b0 + acc;
    const float nv = quantize ? qe_snap(beta, s, z, top) : beta;
    const float d = live ? wo - nv : 0.f;
    if (sub == 0) {
      dsm[i * kSweepRows + row] = d;
      if (live) {
        const long long off = row_off + (long long)i * q;
        w_new[off] = nv;
        delta[off] = d;
      }
    }
    float* nrow = srow + ((i + 1) & 1) * bsz;
#pragma unroll
    for (int t = 0; t < kPrefetch; ++t) {
      const int jj = lane + 32 * t;
      if (jj <= i && jj < bsz) nrow[jj] = pre[t];
    }
    b0 = nb0;
    wo = nwo;
    s = ns;
    z = nz;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(32)
qe_block_sweep_kernel(const float* __restrict__ beta0, const float* __restrict__ sig,
                      const float* __restrict__ w_old, const float* __restrict__ scale,
                      const float* __restrict__ zero, float* __restrict__ w_new,
                      float* __restrict__ delta, int q, int bsz, long long gs,
                      long long sig_gs, int sig_ld, int n_levels, int quantize) {
  extern __shared__ float smem[];
  float* dsm = smem;
  float* srow = smem + bsz * kSweepRows;
  const int g = blockIdx.y;
  const int r = blockIdx.x * kSweepRows + threadIdx.x / kLanesPerRow;
  const bool live = r < q;
  qe_sweep_rows(beta0, sig + (long long)g * sig_gs, sig_ld, w_old, scale, zero, w_new,
                delta, (long long)g * gs + (live ? r : 0), q, bsz, live, n_levels,
                quantize, dsm, srow);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename ST>
__device__ __forceinline__ float round_operand(float v) { return v; }
template <>
__device__ __forceinline__ float round_operand<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kTile = 64;   // output tile: 64 rows of the p axis x 64 of the q axis
constexpr int kDepth = 16;  // k-tile
constexpr int kPad = 4;     // shared-memory row padding (keeps 16-byte alignment)

// The SGEMM main loop shared by the correction and suffix kernels:
// acc[i][j] += Σ_k A(ty*4 + i, k) · B(k, tx*4 + j) over k in [k_begin, k_end)
// for one 64 x 64 output tile (256 threads, a 4 x 4 register micro-tile).
// load_a(c, k) gives row c (0..63) of the tile's A at global k; load_b(k, r)
// gives B's row k at tile column r (0..63); both return 0 outside the
// operand.  The next k-tile is loaded into registers while the current one
// computes (one shared buffer, two barriers per step).
template <typename LoadA, typename LoadB>
__device__ __forceinline__ void tile_sgemm(LoadA load_a, LoadB load_b, int k_begin, int k_end,
                                           float (&acc)[4][4]) {
  __shared__ __align__(16) float As[kDepth][kTile + kPad];  // [k][c]
  __shared__ __align__(16) float Bs[kDepth][kTile + kPad];  // [k][r]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float ra[4], rb[4];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int e = tid + l * 256;
      ra[l] = load_a(e >> 4, k0 + (e & 15));
      rb[l] = load_b(k0 + (e >> 6), e & 63);
    }
  };
  if (k_begin < k_end) load_tile(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kDepth) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int e = tid + l * 256;
      As[e & 15][e >> 4] = ra[l];
      Bs[e >> 6][e & 63] = rb[l];
    }
    __syncthreads();
    if (k0 + kDepth < k_end) load_tile(k0 + kDepth);
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The rolling-Δ correction of the block starting at col0:
//   base_out[g, col0 + c, r] = base[g, col0 + c, r] (− dh[g, col0 + c, r])
//       + Σ_k Σ̃ᵀ[g, col0 + c, k] · Δ[g, k, r],
//   Δ[k] = k < col0 ? dnew[k] (− dh[k]) : dprev[k].
// kOutlier adds the −dh terms of the outlier-aware iteration: dnew then holds
// this iteration's pure δŴ, and the value published to later blocks,
// δŴ − dĤ_prev, is formed in the load (no buffer of its own).
// Split-K: blockIdx.z = g·splits + s covers k in [s·k_chunk, (s+1)·k_chunk).
// With one split the tile writes base_out itself; with more it writes its
// partial sum to part[g, s, c, r] and qe_corr_reduce_kernel finishes.
template <typename ST, bool kOutlier>
__global__ void __launch_bounds__(256)
qe_block_corr_kernel(const ST* __restrict__ sig, const float* __restrict__ dprev,
                     const float* __restrict__ dnew, const float* __restrict__ dh,
                     const float* __restrict__ base, float* __restrict__ base_out,
                     float* __restrict__ part, int p_pad, int q, int col0, int bsz,
                     int splits, int k_chunk) {
  const int g = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int c0 = blockIdx.y * kTile;
  const int r0 = blockIdx.x * kTile;
  const long long gp = (long long)g * p_pad;
  const ST* sg = sig + (gp + col0) * p_pad;
  const float* dp = dprev + gp * q;
  const float* dn = dnew + gp * q;
  const float* dhg = kOutlier ? dh + gp * q : nullptr;
  const int k_begin = split * k_chunk;
  float acc[4][4];
  tile_sgemm(
      [&](int c, int k) {
        c += c0;
        return (c < bsz && k < p_pad) ? to_f32(sg[(long long)c * p_pad + k]) : 0.f;
      },
      [&](int k, int r) {
        r += r0;
        float d = 0.f;
        if (k < p_pad && r < q) {
          const long long o = (long long)k * q + r;
          if (k >= col0) d = dp[o];
          else d = kOutlier ? dn[o] - dhg[o] : dn[o];
        }
        return round_operand<ST>(d);
      },
      k_begin, min(p_pad, k_begin + k_chunk), acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= bsz) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + tx * 4 + j;
      if (r >= q) continue;
      if (splits > 1) {
        part[((long long)blockIdx.z * bsz + c) * q + r] = acc[i][j];
      } else {
        const long long o = (gp + col0 + c) * q + r;
        base_out[o] = (kOutlier ? base[o] - dh[o] : base[o]) + acc[i][j];
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
// a block-upper-triangular product (Σ̃ ⊙ block-suffix mask).  A tile of 64
// rows starts its k loop at the first block any of its rows reads, so the
// tiles left of the block diagonal are never loaded; within that range rows
// whose own block starts later mask their A entries (bsz < 64 only).
template <typename ST>
__global__ void __launch_bounds__(256)
qe_suffix_resid_kernel(const ST* __restrict__ sig, const float* __restrict__ dpure,
                       const float* __restrict__ base_out, float* __restrict__ r_out,
                       int p_pad, int q, int bsz) {
  const int g = blockIdx.z;
  const int c0 = blockIdx.y * kTile;
  const int r0 = blockIdx.x * kTile;
  const long long gp = (long long)g * p_pad;
  const ST* sg = sig + gp * p_pad;
  const float* dg = dpure + gp * q;
  float acc[4][4];
  tile_sgemm(
      [&](int c, int k) {
        c += c0;
        return (c < p_pad && k < p_pad && k >= (c / bsz) * bsz)
                   ? to_f32(sg[(long long)c * p_pad + k]) : 0.f;
      },
      [&](int k, int r) {
        r += r0;
        return (k < p_pad && r < q) ? round_operand<ST>(dg[(long long)k * q + r]) : 0.f;
      },
      (c0 / bsz) * bsz, p_pad, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= p_pad) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + tx * 4 + j;
      if (r >= q) continue;
      const long long o = (gp + c) * q + r;
      r_out[o] = base_out[o] + acc[i][j];
    }
  }
}

template <bool kOutlier>
int launch_corr(const void* sig, int sig_bf16, const float* dprev, const float* dnew,
                const float* dh, const float* base, float* base_out, float* part, int splits,
                int G, int p_pad, int q, int col0, int bsz, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || q <= 0 || bsz <= 0) return 0;
  if (splits < 1 || (splits > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  const int k_chunk = ((p_pad + splits - 1) / splits + kDepth - 1) / kDepth * kDepth;
  dim3 grid((q + kTile - 1) / kTile, (bsz + kTile - 1) / kTile, G * splits);
  cudaStream_t st = (cudaStream_t)stream;
  if (sig_bf16) {
    qe_block_corr_kernel<__nv_bfloat16, kOutlier><<<grid, 256, 0, st>>>(
        (const __nv_bfloat16*)sig, dprev, dnew, dh, base, base_out, part, p_pad, q, col0, bsz,
        splits, k_chunk);
  } else {
    qe_block_corr_kernel<float, kOutlier><<<grid, 256, 0, st>>>(
        (const float*)sig, dprev, dnew, dh, base, base_out, part, p_pad, q, col0, bsz, splits,
        k_chunk);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = (long long)G * bsz * q;
  qe_corr_reduce_kernel<kOutlier><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      part, dh, base, base_out, G, p_pad, q, col0, bsz, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Intra-block sweep over G groups.  Returns the CUDA error of the launch.
int qe_block_sweep(const float* beta0, const float* sig, const float* w_old,
                   const float* scale, const float* zero, float* w_new, float* delta,
                   int G, int q, int bsz, long long gs, long long sig_gs, int sig_ld,
                   int n_levels, int quantize, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || q <= 0 || bsz <= 0) return 0;
  if (bsz > kMaxBlock) return (int)cudaErrorInvalidValue;
  // 10 KB at B = 256 (Δ of 8 rows, two Σ̃ᵀ rows): many warps fit on an SM.
  const size_t smem = (size_t)bsz * (kSweepRows + 2) * sizeof(float);
  dim3 grid((q + kSweepRows - 1) / kSweepRows, G);
  qe_block_sweep_kernel<<<grid, 32, smem, (cudaStream_t)stream>>>(
      beta0, sig, w_old, scale, zero, w_new, delta, q, bsz, gs, sig_gs, sig_ld, n_levels,
      quantize);
  return (int)cudaGetLastError();
}

// Full-width rolling-Δ correction for the block starting at col0.
// sig_bf16 selects bf16 Σ̃ᵀ operands (Δ is then rounded to bf16 too).
// part: splits·G·bsz·q floats of scratch when splits > 1 (else unused).
int qe_block_corr(const void* sig, int sig_bf16, const float* dprev, const float* dnew,
                  const float* base, float* base_out, float* part, int splits, int G,
                  int p_pad, int q, int col0, int bsz, void* stream, int device) {
  return launch_corr<false>(sig, sig_bf16, dprev, dnew, nullptr, base, base_out, part, splits,
                            G, p_pad, q, col0, bsz, stream, device);
}

// The outlier-aware iteration's correction: β0 = base − dh + Σ̃ᵀ[blk, :]·Δ,
// Δ = dpure − dh below col0 and dprev from col0 on.
int qe_outlier_corr(const void* sig, int sig_bf16, const float* dprev, const float* dpure,
                    const float* dh, const float* base, float* base_out, float* part,
                    int splits, int G, int p_pad, int q, int col0, int bsz, void* stream,
                    int device) {
  return launch_corr<true>(sig, sig_bf16, dprev, dpure, dh, base, base_out, part, splits, G,
                           p_pad, q, col0, bsz, stream, device);
}

// The exact residual r = base_out + (Σ̃ ⊙ M)ᵀ·δŴ over all p_pad rows.
int qe_suffix_resid(const void* sig, int sig_bf16, const float* dpure, const float* base_out,
                    float* r, int G, int p_pad, int q, int bsz, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || q <= 0 || bsz <= 0 || p_pad <= 0) return 0;
  dim3 grid((q + kTile - 1) / kTile, (p_pad + kTile - 1) / kTile, G);
  if (sig_bf16) {
    qe_suffix_resid_kernel<__nv_bfloat16><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)sig, dpure, base_out, r, p_pad, q, bsz);
  } else {
    qe_suffix_resid_kernel<float><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)sig, dpure, base_out, r, p_pad, q, bsz);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
