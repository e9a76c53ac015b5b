// QuantEase coordinate-descent kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/quantease_cd.py:
//   * qe_block_sweep_kernel  <- quantease_block_sweep_pallas (_sweep_kernel):
//     the sequential CD sweep over the B columns of one column block.
//   * qe_block_corr_kernel + qe_block_sweep_kernel, launched in turn for each
//     column block  <- quantease_fused_iteration_pallas (_fused_iter_kernel):
//     one whole CD iteration of the fused engine.  The Python wrapper
//     (kernels/quantease_cd.py) walks the blocks in order on one stream.
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
//     stream all of Σ̃ (256 MB at p = 8192) once per CTA.
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

constexpr int kTile = 64;   // output tile: 64 block columns x 64 rows
constexpr int kDepth = 16;  // k-tile
constexpr int kPad = 4;     // shared-memory row padding (keeps 16-byte alignment)

// base_out[g, col0 + c, r] = base[g, col0 + c, r]
//     + Σ_k Σ̃ᵀ[g, col0 + c, k] · Δ[g, k, r],   Δ[k] = k < col0 ? dnew[k] : dprev[k]
template <typename ST>
__global__ void __launch_bounds__(256)
qe_block_corr_kernel(const ST* __restrict__ sig, const float* __restrict__ dprev,
                     const float* __restrict__ dnew, const float* __restrict__ base,
                     float* __restrict__ base_out, int p_pad, int q, int col0, int bsz) {
  __shared__ __align__(16) float As[kDepth][kTile + kPad];  // [k][c]
  __shared__ __align__(16) float Bs[kDepth][kTile + kPad];  // [k][r]
  const int g = blockIdx.z;
  const int c0 = blockIdx.y * kTile;
  const int r0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long gp = (long long)g * p_pad;
  const ST* sg = sig + (gp + col0) * p_pad;
  const float* dp = dprev + gp * q;
  const float* dn = dnew + gp * q;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // Tiles of the next k-step are loaded into registers while the current
  // one computes (one shared buffer, two barriers per step).
  float ra[4], rb[4];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int e = tid + l * 256;
      const int c = c0 + (e >> 4), k = k0 + (e & 15);
      ra[l] = (c < bsz && k < p_pad) ? to_f32(sg[(long long)c * p_pad + k]) : 0.f;
      const int kg = k0 + (e >> 6), r = r0 + (e & 63);
      float d = 0.f;
      if (kg < p_pad && r < q) d = (kg < col0 ? dn : dp)[(long long)kg * q + r];
      rb[l] = round_operand<ST>(d);
    }
  };
  load_tile(0);
  for (int k0 = 0; k0 < p_pad; k0 += kDepth) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int e = tid + l * 256;
      As[e & 15][e >> 4] = ra[l];
      Bs[e >> 6][e & 63] = rb[l];
    }
    __syncthreads();
    if (k0 + kDepth < p_pad) load_tile(k0 + kDepth);
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= bsz) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + tx * 4 + j;
      if (r >= q) continue;
      const long long o = (gp + col0 + c) * q + r;
      base_out[o] = base[o] + acc[i][j];
    }
  }
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
int qe_block_corr(const void* sig, int sig_bf16, const float* dprev, const float* dnew,
                  const float* base, float* base_out, int G, int p_pad, int q, int col0,
                  int bsz, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || q <= 0 || bsz <= 0) return 0;
  dim3 grid((q + kTile - 1) / kTile, (bsz + kTile - 1) / kTile, G);
  if (sig_bf16) {
    qe_block_corr_kernel<__nv_bfloat16><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)sig, dprev, dnew, base, base_out, p_pad, q, col0, bsz);
  } else {
    qe_block_corr_kernel<float><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)sig, dprev, dnew, base, base_out, p_pad, q, col0, bsz);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
