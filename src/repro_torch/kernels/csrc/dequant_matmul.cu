// Dequantizing GEMM for Hopper (sm_90a): y = x @ ((codes - z) * s)ᵀ.
//
// Replaces the Pallas TPU kernel dequant_matmul_pallas
// (src/repro/kernels/dequant_matmul.py:103, _dequant_matmul_kernel).
//
// Operands: x (m, p) bf16 or fp32; codes (q, p) uint8 or packed4 (q, p/2) in
// the linear layout (byte b holds column 2b in its low nibble and 2b + 1 in
// its high nibble); scale/zero (q, n_groups) fp32 with column c in group
// c / gsz, so a ragged last group needs nothing special.  y (m, q) in bf16 or
// fp32, accumulated in fp32.  Three variants, chosen by the caller
// (kernels/dequant_matmul.py:plan_dequant_matmul) and passed in explicitly:
//
// * tc_large (bf16 x, m > 64): a 128 x 128 output tile per CTA, k-step 64
//   (half the barriers per k of a 32-deep step), 8 warps of
//   mma.sync.m16n8k16 (bf16 in, fp32 sum) on 64 x 32 warp tiles.  x tiles go
//   to double-buffered shared memory with cp.async; codes are read with
//   16-byte vector loads one k-step ahead, turned into bf16 (c - z) in
//   registers and stored in the operand layout; both are read with ldmatrix.
//   Rows are padded by 8 bf16 (to 144 bytes), so the eight rows an ldmatrix
//   phase reads fall on distinct banks.  Where the tiles do not fill the
//   card (the 128-token prefill chunk) the k range is split.  What bounds
//   it at m = 2048: bf16 tensor-core operations (2·m·q·p FLOP at 989
//   TFLOP/s; the ridge is ~295 FLOP per byte).
// * tc_small (bf16 x, m <= 64): A and B swapped, so output channels are the
//   MMA's 16-row side and tokens its 8-wide side; a warp owns 16 channels
//   and up to 64 tokens, a CTA 4 warps.  Both operands go from 16-byte loads
//   straight to registers with no shared memory and no shuffles: the dot
//   product does not care in which order k is visited, so lane j of a quad
//   takes 32 consecutive k of its channel row (16 packed bytes) and feeds
//   MMA step s the real k 32j + 4s .. 32j + 4s + 3; the A fragment wants
//   two adjacent k per register, which is one packed byte, and the token's
//   x row supplies the same four k as the B fragment.  The k range is split
//   into slices of 128-multiples so that the grid holds >= 2 CTAs per SM;
//   each slice writes fp32 partials, already scaled, to a workspace, and
//   dequant_matmul_reduce_kernel sums them in slice order (no atomics: a
//   repeat is bit-identical).  What bounds it at m <= 64: bytes (the packed
//   codes, q·p/2 of them, at 3.35 TB/s).  A group must not straddle the
//   128-k super-step, so grouped grids reach it only with gsz % 128 == 0.
// * simt (fp32 x, or a group size that is not a multiple of 16): the first
//   port of the kernel: a 64 x 64 fp32 tile per CTA with a 4 x 4
//   register micro-tile (fp32 operations, 67 TFLOP/s outside the tensor
//   cores).
//
// Why the tensor-core sum is exact up to the order of the sum.  The
// variants compute y[r, n] = Σ_g s[n, g] · Σ_{k ∈ g} x[r, k] · (c[n, k] − z[n, g]).
// Precondition (checked once on the host when an artifact is loaded,
// serve/qparams.py and interop.py): every zero point is an integer in
// [0, 2^bits − 1], as every grid of the port and of the reference is
// (quant/grid.py: round(−wmin/scale) with wmin <= 0 and scale >= (wmax −
// wmin)/n, or 2^(bits−1)).  Then c − z is an integer with |c − z| <= 255,
// which bf16 holds exactly; a bf16 x times it is exact in fp32, so the MMA
// adds exact products.  The MMA's own fp32 sum truncates, so the group's
// accumulator is flushed into an IEEE fp32 total at every group boundary and
// every 128 k (total += s[n, g] · acc); for a per-channel grid that is the
// same s at every flush.  Against the plain version only the order of the
// sum and where s is rounded differ.
//
// The threshold: tc_small takes m <= 64 (kernels/dequant_matmul.py:
// SMALL_M_MAX), where one CTA holds every token and the codes are read once.
// chip_smoke.py phase 3 times both tiles per decoder layer of Phi-3-mini at
// m = 64 and at m = 128 (a prefill chunk); at 128 tc_small re-reads the
// codes for each 64 tokens and tc_large is the faster, so the chunk takes
// tc_large (the times are in PERF.md).

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kDepth = 32;
constexpr int kPad = 4;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename XT, typename OT, bool PACKED4>
__global__ void __launch_bounds__(256)
dequant_matmul_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
                      const float* __restrict__ scale, const float* __restrict__ zero,
                      OT* __restrict__ y, int m, int q, int p, int n_groups, int gsz) {
  __shared__ __align__(16) float Xs[kDepth][kTile + kPad];  // [k][row of x]
  __shared__ __align__(16) float Ws[kDepth][kTile + kPad];  // [k][output channel]
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int code_ld = PACKED4 ? p / 2 : p;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p; k0 += kDepth) {
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int e = tid + l * 256;
      const int rr = e >> 5, kk = e & 31;
      const int col = k0 + kk;
      const int row = m0 + rr;
      Xs[kk][rr] = (row < m && col < p) ? load_f32(x + (long long)row * p + col) : 0.f;
      const int ch = n0 + rr;
      float w = 0.f;
      if (ch < q && col < p) {
        int c;
        if (PACKED4) {
          const uint8_t byte = codes[(long long)ch * code_ld + (col >> 1)];
          c = (col & 1) ? (byte >> 4) : (byte & 0xF);
        } else {
          c = codes[(long long)ch * code_ld + col];
        }
        const int grp = col / gsz;
        const long long gi = (long long)ch * n_groups + grp;
        w = ((float)c - zero[gi]) * scale[gi];
      }
      Ws[kk][rr] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
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
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = n0 + tx * 4 + j;
      if (ch < q) store_out(y + (long long)row * q + ch, acc[i][j]);
    }
  }
}


// ---------------------------------------------------------------------------
// Tensor-core variants (bf16 x): mma.sync.m16n8k16, bf16 operands, fp32 sums.
// ---------------------------------------------------------------------------

constexpr int kFlush = 128;         // the MMA sum goes into the IEEE total at least this often
constexpr int kSplitQuantum = 128;  // split-K slices are multiples of this (tc_small's super-step)

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global → shared; src_bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Eight packed 4-bit codes (one word, k ascending from its low nibble) →
// four bf16 pairs c − z, in k order.  0x4300 | c is the bf16 of 128 + c, and
// zz holds 128 + z twice, so the subtraction is exact.
__device__ __forceinline__ void codes4_to_bf16(uint32_t w, uint32_t zz, uint32_t* o) {
  const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
  const uint32_t e = __byte_perm(lo, hi, 0x5140), f = __byte_perm(lo, hi, 0x7362);
  o[0] = bf2_sub(__byte_perm(e, 0x43434343u, 0x4140), zz);
  o[1] = bf2_sub(__byte_perm(e, 0x43434343u, 0x4342), zz);
  o[2] = bf2_sub(__byte_perm(f, 0x43434343u, 0x4140), zz);
  o[3] = bf2_sub(__byte_perm(f, 0x43434343u, 0x4342), zz);
}

// Four uint8 codes (one word) → two bf16 pairs c − z, in k order.
__device__ __forceinline__ void codes8_to_bf16(uint32_t w, float z, uint32_t* o) {
  o[0] = pack_bf2((float)(w & 0xFFu) - z, (float)((w >> 8) & 0xFFu) - z);
  o[1] = pack_bf2((float)((w >> 16) & 0xFFu) - z, (float)(w >> 24) - z);
}

__device__ __forceinline__ uint32_t zero_pair(float z) { return pack_bf2(128.f + z, 128.f + z); }

// n_codes codes of one row from column k (k < p), zero past p, into words
// (4 codes per word, low byte first).  Packed4 rows hold two codes a byte.
template <bool PACKED4, int N_CODES>
__device__ __forceinline__ void load_codes_row(const uint8_t* __restrict__ row, int k, int p,
                                               bool vec, uint32_t* w) {
  constexpr int kWords = PACKED4 ? N_CODES / 8 : N_CODES / 4;
#pragma unroll
  for (int i = 0; i < kWords; ++i) w[i] = 0u;
  if (vec && k + N_CODES <= p) {
    const uint8_t* src = row + (PACKED4 ? k / 2 : k);
    if constexpr (kWords == 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
      w[0] = v.x, w[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < kWords; i += 4) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + i / 4);
        w[i] = v.x, w[i + 1] = v.y, w[i + 2] = v.z, w[i + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int b = 0; b < kWords * 4; ++b) {
      const int kk = k + (PACKED4 ? 2 * b : b);  // packed4: p is even, so kk < p covers kk + 1
      if (kk < p) w[b >> 2] |= (uint32_t)row[PACKED4 ? kk >> 1 : kk] << (8 * (b & 3));
    }
  }
}

template <typename OT>
__device__ __forceinline__ void store_pair(OT* o, int ch, int q, float v0, float v1) {
  if (ch < q) store_out(o, v0);
  if (ch + 1 < q) store_out(o + 1, v1);
}

// --- tc_large --------------------------------------------------------------

constexpr int kLM = 128, kLN = 128, kLK = 64, kLStride = kLK + 8, kLThreads = 256;
constexpr int kLCodes = kLK / 2;  // codes a thread converts per k-step (half a channel row)
constexpr int kLSmem = 2 * (kLM + kLN) * kLStride * 2;  // double-buffered x and c − z tiles

template <bool PACKED4, typename OT>
__global__ void __launch_bounds__(kLThreads, 1)
dequant_matmul_tc_large_kernel(const __nv_bfloat16* __restrict__ x,
                               const uint8_t* __restrict__ codes,
                               const float* __restrict__ scale, const float* __restrict__ zero,
                               OT* __restrict__ y, float* __restrict__ part, int m, int q, int p,
                               int n_groups, int gsz, int kps, bool vec_x, bool vec_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto Xs = reinterpret_cast<__nv_bfloat16 (*)[kLM][kLStride]>(smem_raw);  // [buf][row of x][k]
  auto Ws = reinterpret_cast<__nv_bfloat16 (*)[kLN][kLStride]>(           // [buf][channel][k], c − z
      smem_raw + 2 * kLM * kLStride * sizeof(__nv_bfloat16));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 rows x 32 channels
  const int m0 = blockIdx.y * kLM, n0 = blockIdx.x * kLN;
  const int k_lo = blockIdx.z * kps, k_hi = min(p, k_lo + kps);
  const int ld = PACKED4 ? p / 2 : p;
  // This thread converts 16 codes of channel wch, half whalf of each k-step.
  const int wrow = tid >> 1, whalf = tid & 1, wch = n0 + wrow;

  float acc[4][4][4], tot[4][4][4], sc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = tot[i][j][r] = 0.f;
  int grp = -1;

  constexpr int kWords = PACKED4 ? kLCodes / 8 : kLCodes / 4;
  uint32_t cr[kWords];
  float zc[kLCodes / 16];  // a zero point per 16 codes: a group holds whole 16s
  auto load_codes = [&](int k0) {
    const int k = k0 + whalf * kLCodes;
    if (wch < q && k < p) {
      load_codes_row<PACKED4, kLCodes>(codes + (long long)wch * ld, k, p, vec_c, cr);
#pragma unroll
      for (int h = 0; h < kLCodes / 16; ++h)
        zc[h] = zero[(long long)wch * n_groups + min((k + 16 * h) / gsz, n_groups - 1)];
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) cr[i] = 0u;
#pragma unroll
      for (int h = 0; h < kLCodes / 16; ++h) zc[h] = 0.f;
    }
  };
  auto store_codes = [&](int buf) {
    uint32_t o[kLCodes / 2];  // bf16 pairs
    if constexpr (PACKED4) {  // a word holds 8 codes
#pragma unroll
      for (int i = 0; i < kWords; ++i) codes4_to_bf16(cr[i], zero_pair(zc[i / 2]), o + 4 * i);
    } else {  // a word holds 4 codes
#pragma unroll
      for (int i = 0; i < kWords; ++i) codes8_to_bf16(cr[i], zc[i / 4], o + 2 * i);
    }
    uint4* dst = reinterpret_cast<uint4*>(&Ws[buf][wrow][whalf * kLCodes]);
#pragma unroll
    for (int i = 0; i < kLCodes / 8; ++i)
      dst[i] = make_uint4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
  };
  auto load_x = [&](int buf, int k0) {
#pragma unroll
    for (int l = 0; l < kLM * kLK / 8 / kLThreads; ++l) {
      const int c = tid + l * kLThreads, row = c / (kLK / 8), col = c % (kLK / 8) * 8;
      const int gr = m0 + row, gk = k0 + col;
      __nv_bfloat16* dst = &Xs[buf][row][col];
      if (vec_x) {
        const bool in = gr < m && gk < p;  // p % 8 == 0: a chunk is all in or all out
        cp_async16(smem_u32(dst), in ? x + (long long)gr * p + gk : x, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gr < m && gk + e < p) ? x[(long long)gr * p + gk + e] : __float2bfloat16_rn(0.f);
      }
    }
  };
  auto flush = [&](int k_last) {
    const int g = min(k_last / gsz, n_groups - 1);
    if (g != grp) {
      grp = g;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = n0 + wn * 32 + j * 8 + (lane & 3) * 2 + e;
          sc[j][e] = ch < q ? scale[(long long)ch * n_groups + g] : 0.f;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          tot[i][j][r] = fmaf(sc[j][r & 1], acc[i][j][r], tot[i][j][r]);
          acc[i][j][r] = 0.f;
        }
  };

  const int n_k = k_hi > k_lo ? (k_hi - k_lo + kLK - 1) / kLK : 0;
  if (n_k > 0) {
    load_x(0, k_lo);
    cp_async_commit();
    load_codes(k_lo);
    store_codes(0);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1, k0 = k_lo + kt * kLK;
    const bool more = kt + 1 < n_k;
    if (more) {  // the next k-step's loads fly while this one computes
      load_x(cur ^ 1, k0 + kLK);
      cp_async_commit();
      load_codes(k0 + kLK);
    }
#pragma unroll
    for (int kk = 0; kk < kLK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], smem_u32(&Xs[cur][wm * 64 + i * 16 + (lane & 15)][kk + (lane >> 4) * 8]));
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(&Ws[cur][wn * 32 + jj * 16 + (lane & 7) + ((lane >> 4) << 3)]
                                       [kk + ((lane >> 3) & 1) * 8]));
        b[2 * jj][0] = r[0], b[2 * jj][1] = r[1], b[2 * jj + 1][0] = r[2], b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
      const int k_end = k0 + kk + 16;  // uniform over the CTA
      if (k_end % gsz == 0 || k_end % kFlush == 0 || k_end >= k_hi) flush(k_end - 1);
    }
    if (more) {
      store_codes(cur ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + i * 16 + (lane >> 2) + h * 8;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = n0 + wn * 32 + j * 8 + (lane & 3) * 2;
        if (part)
          store_pair(part + ((long long)blockIdx.z * m + row) * q + ch, ch, q, tot[i][j][2 * h],
                     tot[i][j][2 * h + 1]);
        else
          store_pair(y + (long long)row * q + ch, ch, q, tot[i][j][2 * h], tot[i][j][2 * h + 1]);
      }
    }
}

// --- tc_small (swap AB, split K) --------------------------------------------

constexpr int kSWarps = 4, kSThreads = kSWarps * 32, kSChannels = kSWarps * 16, kSStep = 128;

template <int NT, bool PACKED4, typename OT>
__global__ void __launch_bounds__(kSThreads)
dequant_matmul_tc_small_kernel(const __nv_bfloat16* __restrict__ x,
                               const uint8_t* __restrict__ codes,
                               const float* __restrict__ scale, const float* __restrict__ zero,
                               OT* __restrict__ y, float* __restrict__ part, int m, int q, int p,
                               int n_groups, int gsz, int kps, bool vec_x, bool vec_c) {
  constexpr int CW = PACKED4 ? 4 : 8;  // code words per channel row per lane per super-step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r8 = lane >> 2, j4 = lane & 3;
  const int ch0 = blockIdx.x * kSChannels + warp * 16 + r8, ch1 = ch0 + 8;
  const int t0 = blockIdx.z * NT * 8;
  const int k_lo = blockIdx.y * kps, k_hi = min(p, k_lo + kps);
  const int ld = PACKED4 ? p / 2 : p;

  float acc[NT][4], tot[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = tot[n][r] = 0.f;

  uint32_t cw[2][CW], nw[2][CW];
  auto load = [&](int kb, uint32_t (&w)[2][CW]) {
    const int k = kb + 32 * j4;  // this lane's 32 consecutive k
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ch = r ? ch1 : ch0;
      if (ch < q && k < p) {
        load_codes_row<PACKED4, 32>(codes + (long long)ch * ld, k, p, vec_c, w[r]);
      } else {
#pragma unroll
        for (int i = 0; i < CW; ++i) w[r][i] = 0u;
      }
    }
  };

  int grp = -1;
  float s[2] = {0.f, 0.f}, zf[2] = {0.f, 0.f};
  uint32_t zz[2] = {0u, 0u};
  if (k_lo < k_hi) load(k_lo, cw);
  for (int kb = k_lo; kb < k_hi; kb += kSStep) {
    const bool more = kb + kSStep < k_hi;
    if (more) load(kb + kSStep, nw);
    const int g = min(kb / gsz, n_groups - 1);  // gsz % 128 == 0: one group per super-step
    if (g != grp) {
      grp = g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ch = r ? ch1 : ch0;
        s[r] = ch < q ? scale[(long long)ch * n_groups + g] : 0.f;
        zf[r] = ch < q ? zero[(long long)ch * n_groups + g] : 0.f;
        zz[r] = zero_pair(zf[r]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // k 32·j4 + 8i .. + 7: MMA steps 2i and 2i + 1
      const int k = kb + 32 * j4 + 8 * i;
      uint32_t xb[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int t = t0 + n * 8 + r8;
        const __nv_bfloat16* src = x + (long long)t * p + k;
        if (t < m && vec_x && k + 8 <= p) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
          xb[n][0] = v.x, xb[n][1] = v.y, xb[n][2] = v.z, xb[n][3] = v.w;
        } else {
          float f[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = (t < m && k + e < p) ? __bfloat162float(src[e]) : 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) xb[n][e] = pack_bf2(f[2 * e], f[2 * e + 1]);
        }
      }
      uint32_t a0[4], a1[4];  // channel rows ch0, ch1: pairs (k, k+1) .. (k+6, k+7)
      if constexpr (PACKED4) {
        codes4_to_bf16(cw[0][i], zz[0], a0);
        codes4_to_bf16(cw[1][i], zz[1], a1);
      } else {
        codes8_to_bf16(cw[0][2 * i], zf[0], a0);
        codes8_to_bf16(cw[0][2 * i + 1], zf[0], a0 + 2);
        codes8_to_bf16(cw[1][2 * i], zf[1], a1);
        codes8_to_bf16(cw[1][2 * i + 1], zf[1], a1 + 2);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t a[4] = {a0[2 * h], a1[2 * h], a0[2 * h + 1], a1[2 * h + 1]};
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_bf16(acc[n], a, xb[n][2 * h], xb[n][2 * h + 1]);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        tot[n][r] = fmaf(s[r >> 1], acc[n][r], tot[n][r]);
        acc[n][r] = 0.f;
      }
    if (more) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < CW; ++i) cw[r][i] = nw[r][i];
    }
  }

  // C fragment: rows = channels (ch0 for r 0-1, ch1 for r 2-3), columns =
  // tokens 2·j4 and 2·j4 + 1 of each 8-token tile.
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = t0 + n * 8 + 2 * j4 + (r & 1), ch = (r >> 1) ? ch1 : ch0;
      if (t >= m || ch >= q) continue;
      if (part)
        part[((long long)blockIdx.y * m + t) * q + ch] = tot[n][r];
      else
        store_out(y + (long long)t * q + ch, tot[n][r]);
    }
}

// y = Σ_s part[s] in slice order, in the output dtype.
template <typename OT>
__global__ void __launch_bounds__(256)
dequant_matmul_reduce_kernel(const float* __restrict__ part, OT* __restrict__ y, long long n,
                             int split) {
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    float acc = 0.f;
    for (int s = 0; s < split; ++s) acc += part[(long long)s * n + i];
    store_out(y + i, acc);
  }
}

template <int NT, typename OT>
void launch_small(dim3 grid, bool packed4, const __nv_bfloat16* x, const uint8_t* codes,
                  const float* scale, const float* zero, OT* y, float* part, int m, int q, int p,
                  int n_groups, int gsz, int kps, bool vec_x, bool vec_c, cudaStream_t s) {
  if (packed4)
    dequant_matmul_tc_small_kernel<NT, true, OT><<<grid, kSThreads, 0, s>>>(
        x, codes, scale, zero, y, part, m, q, p, n_groups, gsz, kps, vec_x, vec_c);
  else
    dequant_matmul_tc_small_kernel<NT, false, OT><<<grid, kSThreads, 0, s>>>(
        x, codes, scale, zero, y, part, m, q, p, n_groups, gsz, kps, vec_x, vec_c);
}

template <typename OT>
cudaError_t launch_tc(int variant, const __nv_bfloat16* x, const uint8_t* codes, bool packed4,
                      const float* scale, const float* zero, OT* y, float* workspace, int m,
                      int q, int p, int n_groups, int gsz, int split, cudaStream_t s) {
  const int steps = (p + kSplitQuantum - 1) / kSplitQuantum;
  const int kps = (steps + split - 1) / split * kSplitQuantum;
  const int ld = packed4 ? p / 2 : p;
  const bool vec_x = p % 8 == 0 && (uintptr_t)x % 16 == 0;
  const bool vec_c = ld % 16 == 0 && (uintptr_t)codes % 16 == 0;
  float* part = split > 1 ? workspace : nullptr;
  if (variant == 1) {
    dim3 grid((q + kLN - 1) / kLN, (m + kLM - 1) / kLM, split);
    auto kernel = packed4 ? dequant_matmul_tc_large_kernel<true, OT>
                          : dequant_matmul_tc_large_kernel<false, OT>;
    if (kLSmem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kLSmem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<grid, kLThreads, kLSmem, s>>>(x, codes, scale, zero, y, part, m, q, p, n_groups, gsz,
                                           kps, vec_x, vec_c);
  } else {
    const int nt = m <= 8 ? 1 : m <= 16 ? 2 : m <= 32 ? 4 : 8;
    dim3 grid((q + kSChannels - 1) / kSChannels, split, (m + 8 * nt - 1) / (8 * nt));
    switch (nt) {
      case 1: launch_small<1>(grid, packed4, x, codes, scale, zero, y, part, m, q, p, n_groups, gsz, kps, vec_x, vec_c, s); break;
      case 2: launch_small<2>(grid, packed4, x, codes, scale, zero, y, part, m, q, p, n_groups, gsz, kps, vec_x, vec_c, s); break;
      case 4: launch_small<4>(grid, packed4, x, codes, scale, zero, y, part, m, q, p, n_groups, gsz, kps, vec_x, vec_c, s); break;
      default: launch_small<8>(grid, packed4, x, codes, scale, zero, y, part, m, q, p, n_groups, gsz, kps, vec_x, vec_c, s); break;
    }
  }
  if (split > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long n = (long long)m * q;
    const int blocks = (int)std::min<long long>((n + 255) / 256, 4096);
    dequant_matmul_reduce_kernel<OT><<<blocks, 256, 0, s>>>(workspace, y, n, split);
  }
  return cudaGetLastError();
}

template <typename XT, typename OT>
void launch(const void* x, const uint8_t* codes, int packed4, const float* scale,
            const float* zero, void* y, int m, int q, int p, int n_groups, int gsz,
            cudaStream_t stream) {
  dim3 grid((q + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  if (packed4) {
    dequant_matmul_kernel<XT, OT, true><<<grid, 256, 0, stream>>>(
        (const XT*)x, codes, scale, zero, (OT*)y, m, q, p, n_groups, gsz);
  } else {
    dequant_matmul_kernel<XT, OT, false><<<grid, 256, 0, stream>>>(
        (const XT*)x, codes, scale, zero, (OT*)y, m, q, p, n_groups, gsz);
  }
}

}  // namespace

// variant: 0 = simt, 1 = tc_large, 2 = tc_small (kernels/dequant_matmul.py
// names them); split > 1 needs a workspace of split·m·q fp32.  Returns a CUDA
// error code, cudaErrorInvalidValue for a variant that does not take these
// operands.
extern "C" int dequant_matmul(const void* x, int x_bf16, const uint8_t* codes, int packed4,
                              const float* scale, const float* zero, void* y, int y_bf16,
                              int m, int q, int p, int n_groups, int gsz, int variant, int split,
                              float* workspace, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (gsz <= 0 || split < 1 || (split > 1 && workspace == nullptr)) return (int)cudaErrorInvalidValue;
  if (m <= 0 || q <= 0 || p <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0) {
    if (split != 1) return (int)cudaErrorInvalidValue;
    if (x_bf16 && y_bf16) {
      launch<__nv_bfloat16, __nv_bfloat16>(x, codes, packed4, scale, zero, y, m, q, p, n_groups, gsz, s);
    } else if (x_bf16) {
      launch<__nv_bfloat16, float>(x, codes, packed4, scale, zero, y, m, q, p, n_groups, gsz, s);
    } else if (y_bf16) {
      launch<float, __nv_bfloat16>(x, codes, packed4, scale, zero, y, m, q, p, n_groups, gsz, s);
    } else {
      launch<float, float>(x, codes, packed4, scale, zero, y, m, q, p, n_groups, gsz, s);
    }
    return (int)cudaGetLastError();
  }
  const bool grouped = n_groups > 1;
  if ((variant != 1 && variant != 2) || !x_bf16 || (grouped && gsz % 16) ||
      (variant == 2 && grouped && gsz % kSplitQuantum))
    return (int)cudaErrorInvalidValue;
  const auto* xb = (const __nv_bfloat16*)x;
  if (y_bf16)
    return (int)launch_tc<__nv_bfloat16>(variant, xb, codes, packed4, scale, zero,
                                         (__nv_bfloat16*)y, workspace, m, q, p, n_groups, gsz,
                                         split, s);
  return (int)launch_tc<float>(variant, xb, codes, packed4, scale, zero, (float*)y, workspace, m,
                               q, p, n_groups, gsz, split, s);
}
