// Dequantizing GEMM for Hopper (sm_90a): y = x @ ((codes - z) * s)ᵀ.
//
// Replaces the Pallas TPU kernel dequant_matmul_pallas
// (src/repro/kernels/dequant_matmul.py, _dequant_matmul_kernel).
//
// Operands: x (m, p) bf16 or fp32; codes (q, p) uint8 or packed4 (q, p/2) in
// the linear layout (byte b holds column 2b in its low nibble and 2b + 1 in
// its high nibble); scale/zero (q, n_groups) fp32 with column c in group
// c / gsz, so a ragged last group needs nothing special.  y (m, q) in bf16 or
// fp32, accumulated in fp32.
//
// What bounds it.  On the path (m = 2k..8k tokens, q, p in {3072, 8192}) the
// product is 2·m·q·p FLOP over at most 2·m·p + q·p/2 + 2·m·q bytes: far above
// the card's ridge point, so fp32 operations bound it (67 TFLOP/s outside the
// tensor cores).  The weights are dequantized to fp32 and the sum is fp32, as
// in the reference; bf16 tensor cores would round the dequantized weights.
// The design dequantizes each 64 x 32 codes tile straight into shared memory
// (the fp32 weight matrix never exists in device memory, which is the point
// of weight-only quantization) and runs a 64 x 64 output tile per CTA with a
// 4 x 4 register micro-tile.

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

extern "C" int dequant_matmul(const void* x, int x_bf16, const uint8_t* codes, int packed4,
                              const float* scale, const float* zero, void* y, int y_bf16,
                              int m, int q, int p, int n_groups, int gsz, void* stream,
                              int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m <= 0 || q <= 0 || p <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
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
