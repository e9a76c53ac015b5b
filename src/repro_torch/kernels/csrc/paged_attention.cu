// Paged decode attention for Hopper (sm_90a): one query token per sequence
// against a block-paged KV cache.
//
// Replaces the Pallas TPU kernel paged_attention_pallas
// (src/repro/kernels/paged_attention.py, _paged_attn_kernel).
//
// Operands: q (B, KVp, G, hd) in bf16 or fp32, already scaled by 1/sqrt(hd)
// in its own dtype; k/v pages (n_pages, psz, KVp, hd) in bf16 or int8, or
// (n_pages, psz, KVp, hd/2) uint8 holding int4 codes fold-in-half (byte d of
// a head row: element d in the low nibble, d + hd/2 in the high nibble, two's
// complement); optional fp32 scale planes (n_pages, psz, KVp, 1) for
// quantized pages; page_table (B, n_pgs) and lengths (B,) int32.  Output
// (B, KVp, G, hd) in q's dtype.  Positions >= lengths[b] are masked, and with
// a window also those < lengths[b] - window; the softcap tanh(s/c)*c comes
// before the mask.  For quantized pages the k scale multiplies the score
// after the dot and the v scale multiplies p before the P.V product, so the
// dequantized page never exists.  m, l and acc are fp32, and p stays fp32
// into the P.V product, as in the TPU kernel.
//
// What bounds it.  Decode attention does about 4*G flop per KV element it
// reads (G = 1 on the MHA models): far below the card's ridge point, so
// reading the valid pages (bytes) bounds it.  The design reads each valid
// byte once and nothing else:
//   * one CTA per (sequence, kv head), with a loop over the sequence's valid
//     positions inside the block; the block reads its own page_table row and
//     length in place of the TPU's scalar prefetch;
//   * the block's 8 warps split the positions, kUnroll consecutive positions
//     per warp per step, all of whose K and V rows are loaded before any is
//     used, so several loads are in flight per warp; the 32 lanes split the
//     head dim (lane + 32 j), so neighbouring lanes read neighbouring bytes;
//   * positions past the length (whole pages, and the masked tail of the
//     last page) are never loaded: they contribute exactly 0 and never
//     multiply stale V bytes; padded table entries (the null page) are never
//     read;
//   * each warp keeps its own online softmax (m, l, acc in registers), and
//     the warps are combined in shared memory in a fixed order (no atomics:
//     the result does not change from run to run).
// Splitting one long sequence over several CTAs, and cp.async or TMA staging
// of the pages, are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;

enum PageKind { kBf16 = 0, kInt8 = 1, kInt4 = 2 };

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;  // null for unquantized pages
  const float* v_scale;
  const int* page_table;
  const int* lengths;
  void* out;
  int B, KVp, G, hd, psz, n_pgs, window;  // window < 0: none
  float softcap;                          // <= 0: none
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The head-dim element that lane `lane` holds in its register j, or -1.
// Unpacked pages: lane + 32 j.  int4 pages: the lane's bytes are lane + 32 j
// for j < EPL/2; register j holds the byte's low element, register
// EPL/2 + j its high element (hd/2 further on).
template <int KIND, int EPL>
__device__ __forceinline__ int elem_of(int lane, int j, int hd) {
  if (KIND == kInt4) {
    const int half = hd >> 1;
    const int byte = lane + 32 * (j < EPL / 2 ? j : j - EPL / 2);
    if (byte >= half) return -1;
    return j < EPL / 2 ? byte : byte + half;
  }
  const int e = lane + 32 * j;
  return e < hd ? e : -1;
}

// One head row (`row` = (page * psz + slot) * KVp + head) of a page, as fp32,
// in the lane's register order.
template <int KIND, int EPL>
__device__ __forceinline__ void load_row(const void* pages, long long row, int lane, int hd,
                                         float (&out)[EPL]) {
  if (KIND == kInt4) {
    const int half = hd >> 1;
    const uint8_t* p = static_cast<const uint8_t*>(pages) + row * half;
#pragma unroll
    for (int j = 0; j < EPL / 2; ++j) {
      const int byte = lane + 32 * j;
      int lo = 0, hi = 0;
      if (byte < half) {
        const int v = p[byte];
        lo = ((v & 0xF) ^ 8) - 8;  // sign-extend the 4-bit two's complement
        hi = ((v >> 4) ^ 8) - 8;
      }
      out[j] = (float)lo;
      out[EPL / 2 + j] = (float)hi;
    }
  } else if (KIND == kInt8) {
    const int8_t* p = static_cast<const int8_t*>(pages) + row * hd;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int e = lane + 32 * j;
      out[j] = e < hd ? (float)p[e] : 0.f;
    }
  } else {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(pages) + row * hd;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int e = lane + 32 * j;
      out[j] = e < hd ? __bfloat162float(p[e]) : 0.f;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename QT, int KIND, int GMAX, int EPL>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(Args a) {
  extern __shared__ float smem[];  // m [kWarps][G], l [kWarps][G], acc [kWarps][G][hd]
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = a.G, hd = a.hd, psz = a.psz, KVp = a.KVp;
  const int raw_len = a.lengths[b];
  const int hi = min(raw_len, a.n_pgs * psz);
  const int lo = a.window >= 0 ? max(0, raw_len - a.window) : 0;
  const int* pt_row = a.page_table + (long long)b * a.n_pgs;
  const bool quantized = a.k_scale != nullptr;
  const long long qo = ((long long)b * KVp + h) * G * hd;

  float qv[GMAX][EPL], acc[GMAX][EPL], m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int e = elem_of<KIND, EPL>(lane, j, hd);
      qv[g][j] = (g < G && e >= 0) ? to_f32(static_cast<const QT*>(a.q)[qo + g * hd + e]) : 0.f;
      acc[g][j] = 0.f;
    }
  }

  for (int base = lo + warp * kUnroll; base < hi; base += kWarps * kUnroll) {
    // Load all kUnroll positions first; position `base` is always valid.
    float kr[kUnroll][EPL], vr[kUnroll][EPL], ksc[kUnroll], vsc[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u;
      valid[u] = pos < hi;
      ksc[u] = vsc[u] = 1.f;
      if (valid[u]) {
        const long long row = ((long long)pt_row[pos / psz] * psz + pos % psz) * KVp + h;
        load_row<KIND, EPL>(a.k_pages, row, lane, hd, kr[u]);
        load_row<KIND, EPL>(a.v_pages, row, lane, hd, vr[u]);
        if (quantized) {
          ksc[u] = a.k_scale[row];
          vsc[u] = a.v_scale[row];
        }
      } else {
#pragma unroll
        for (int j = 0; j < EPL; ++j) kr[u][j] = vr[u][j] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      float s[kUnroll];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < EPL; ++j) part = fmaf(qv[g][j], kr[u][j], part);
        s[u] = warp_sum(part) * ksc[u];
        if (a.softcap > 0.f) s[u] = tanhf(s[u] / a.softcap) * a.softcap;
        if (!valid[u]) s[u] = -INFINITY;
        mx = fmaxf(mx, s[u]);
      }
      const float corr = expf(m[g] - mx);  // 0 on the first step (m = -inf)
      float p[kUnroll], psum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = valid[u] ? expf(s[u] - mx) : 0.f;
        psum += p[u];
        p[u] *= vsc[u];
      }
      l[g] = l[g] * corr + psum;
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        float acc_j = acc[g][j] * corr;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc_j = fmaf(p[u], vr[u][j], acc_j);
        acc[g][j] = acc_j;
      }
      m[g] = mx;
    }
  }

  // Combine the warps' softmax states in a fixed order.
  float* sm_m = smem;
  float* sm_l = sm_m + kWarps * G;
  float* sm_acc = sm_l + kWarps * G;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int e = elem_of<KIND, EPL>(lane, j, hd);
      if (e >= 0) sm_acc[(warp * G + g) * hd + e] = acc[g][j];
    }
  }
  __syncthreads();
  QT* out = static_cast<QT*>(a.out) + qo;
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    const int g = i / hd, e = i - g * hd;
    float M = -INFINITY;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w * G + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w * G + g];
      const float f = mw == -INFINITY ? 0.f : expf(mw - M);
      L = fmaf(sm_l[w * G + g], f, L);
      A = fmaf(sm_acc[(w * G + g) * hd + e], f, A);
    }
    from_f32(out + i, A / fmaxf(L, 1e-30f));
  }
}

template <typename QT, int KIND, int GMAX, int EPL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<QT, KIND, GMAX, EPL>;
  const size_t smem = sizeof(float) * kWarps * a.G * (a.hd + 2);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.KVp, a.B), kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename QT, int KIND, int GMAX>
cudaError_t by_hd(const Args& a, cudaStream_t s) {
  if (a.hd <= 128) return launch<QT, KIND, GMAX, 4>(a, s);
  if (a.hd <= 256) return launch<QT, KIND, GMAX, 8>(a, s);
  return cudaErrorInvalidValue;
}

template <typename QT, int KIND>
cudaError_t by_group(const Args& a, cudaStream_t s) {
  if (a.G == 1) return by_hd<QT, KIND, 1>(a, s);
  if (a.G <= 4) return by_hd<QT, KIND, 4>(a, s);
  if (a.G <= 8) return by_hd<QT, KIND, 8>(a, s);
  return cudaErrorInvalidValue;
}

template <typename QT>
cudaError_t by_kind(int kind, const Args& a, cudaStream_t s) {
  switch (kind) {
    case kBf16: return by_group<QT, kBf16>(a, s);
    case kInt8: return by_group<QT, kInt8>(a, s);
    case kInt4: return by_group<QT, kInt4>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int paged_attention(const void* q, int q_bf16, const void* k_pages, const void* v_pages,
                               int kind, const float* k_scale, const float* v_scale,
                               const int* page_table, const int* lengths, void* out, int B, int KVp,
                               int G, int hd, int psz, int n_pgs, int window, float softcap,
                               void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || KVp <= 0 || G <= 0 || hd <= 0) return 0;
  const Args a{q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, out,
               B, KVp, G, hd, psz, n_pgs, window, softcap};
  cudaStream_t s = (cudaStream_t)stream;
  err = q_bf16 ? by_kind<__nv_bfloat16>(kind, a, s) : by_kind<float>(kind, a, s);
  return (int)err;
}
