// Paged decode attention for Hopper (sm_90a): one query token per sequence
// against a block-paged KV cache.
//
// Replaces the Pallas TPU kernel paged_attention_pallas
// (src/repro/kernels/paged_attention.py, _paged_attn_kernel).
//
// Operands: q (B, KVp, G, hd) in bf16 or fp32, unscaled; k/v pages
// (n_pages, psz, KVp, hd) in bf16 or int8, or (n_pages, psz, KVp, hd/2)
// uint8 holding int4 codes fold-in-half (byte d of a head row: element d in
// the low nibble, d + hd/2 in the high nibble, two's complement); fp32
// scale planes (n_pages, psz, KVp, 1) for quantized pages; page_table
// (B, n_pgs) and lengths (B,) int32.  Output (B, KVp, G, hd) in q's dtype.
// Positions >= lengths[b] are masked, and with a window also those
// < lengths[b] - window; the softcap tanh(s/c)*c comes before the mask.  q
// is scaled here as the reference does it: float(q) * (float)(1/sqrt(hd)),
// rounded once to q's dtype.  For quantized pages the k scale multiplies
// the score after the dot and the v scale multiplies p before the P.V
// product, so the dequantized page never exists.  m, l, acc and p are fp32.
//
// What bounds it.  Decode attention does about 4*G flop per KV element it
// reads (G <= 8): far below the card's ridge point, so reading the valid
// pages (bytes) bounds it, and the design keeps enough of them in flight:
//   * the KV of one (sequence, kv head) is split over CTAs: grid
//     (KVp, B, n_split), each CTA one partition of part_pages pages of the
//     table (the wrapper's plan_paged picks it from host-known shapes, never
//     from lengths).  A partition with no attended position writes an
//     empty state (m = -inf, l = 0) and exits.  With n_split > 1 each CTA
//     writes its unnormalised (m, l, acc) to an fp32 workspace and
//     paged_attention_combine_kernel merges a sequence's partitions in
//     ascending order (no atomics in any sum: the output is the same from
//     run to run); with one partition the CTA writes the output itself;
//   * a CTA reads its partition's page-table entries into shared memory
//     once (with q and the length, in one round of loads), works out each
//     tile's global row indices a tile ahead, and copies K and V rows (and
//     the scales of quantized pages) a tile of T positions at a time (64
//     for bf16 and int8, 128 for int4; 32 for bf16 rows too wide for four
//     stages of 64) into a ring of kStages shared-memory stages by 16-byte
//     cp.async (4-byte where a row is not a multiple of 16 bytes, byte
//     loads where it is not a multiple of 4), two tiles ahead of the math.
//     Only attended rows are copied: the null page, a masked tail and rows
//     before the window are never read, and positions past a tile's end
//     never enter a product;
//   * the math runs from shared memory, software-pipelined: the scores of
//     tile k + 1 and the P.V of tile k run in one phase between barriers.
//     Scores: L lanes (1 to 8) own one (position, query head) dot and sum
//     it with log2(L) shuffles; the tile's max per query head is a warp
//     REDUX and a shared atomicMax on order-preserving ints (exact, so in
//     no particular order).  P.V: each thread owns 8 head-dim elements of
//     one query head and a fixed subset of the tile's positions, forms their
//     p itself, and keeps acc and its subset's sum of p in registers; the
//     subsets are added in a fixed order at the end.  bf16, int8 and int4
//     rows are widened with integer ops (a shift for bf16, a byte permute
//     into a float's mantissa for the codes).  Staged rows are padded so
//     that at most two lanes of a quarter-warp share a bank.  G = 1 runs
//     128 threads per CTA, G > 1 256 (more dots per byte).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCombineThreads = 128;
constexpr int kMaxSmem = 227 * 1024;  // shared memory one CTA may take on the H100
constexpr int kStages = 4;          // tiles in the ring: two in flight while two are used
constexpr int kMaxPartPages = 256;  // the wrapper's MAX_PART_PAGES: staged table entries
constexpr int kMaxG = 8;            // query heads per kv head (the wrapper's refusal)

enum PageKind { kBf16 = 0, kInt8 = 1, kInt4 = 2 };

// Per page kind: positions per tile (the wrapper's TILE), bytes of a P.V
// column (8 head-dim elements), q elements per 16-byte chunk of a row per
// plane, and q planes (int4: low and high nibbles).
template <int KIND>
struct Kind;
template <>
struct Kind<kBf16> {
  static constexpr int kTile = 64, kPvBytes = 16, kChunkElems = 8, kPlanes = 1;
};
template <>
struct Kind<kInt8> {
  static constexpr int kTile = 64, kPvBytes = 8, kChunkElems = 16, kPlanes = 1;
};
template <>
struct Kind<kInt4> {
  static constexpr int kTile = 128, kPvBytes = 4, kChunkElems = 16, kPlanes = 2;
};

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;  // null for bf16 pages
  const float* v_scale;
  const int* page_table;
  const int* lengths;
  void* out;
  float* part;  // n_split > 1: per (b, h, split) m[G], l[G], acc[G][hd]
  int B, KVp, G, hd, psz, n_pgs, window;  // window < 0: none
  float softcap;                          // <= 0: none
  float inv_sqrt_hd;
  int part_pages, n_split;
};

// Shapes of one launch, worked out on the host (layout_of).
struct Layout {
  int row_bytes;    // bytes of one head row of a page
  int cpr;          // 16-byte chunks per row (the last one zero-padded in shared memory)
  int rbs;          // bytes between staged rows
  int vb;           // copy width: 16, 4 or 1 bytes
  int lanes;        // lanes per QK dot
  int npv;          // P.V columns per query head
  int cols;         // G * npv
  int ts;           // position subsets of the P.V loop
  int stage_bytes;  // one ring stage: K rows, V rows, k and v scales
  int off_q, off_sp, off_ml, off_pt, off_rows, smem;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_as(float, float v) { return v; }
__device__ __forceinline__ float round_as(__nv_bfloat16, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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
// bf16 halves of a word, as fp32 (exact).
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
// Byte n of w, an unsigned value u < 256, as the float 2^23 + u (exact);
// the caller subtracts 2^23 and the bias it added.
__device__ __forceinline__ float byte_f(uint32_t w, int n) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | n));
}
constexpr float kInt8Bias = 8388608.f + 128.f;  // int8 code c is stored as c ^ 0x80 = c + 128
constexpr float kInt4Bias = 8388608.f + 8.f;    // int4 nibble c as (c ^ 8) = c + 8

// Dot of one 16-byte chunk of a K row with its q elements (planes of qn).
template <int KIND>
__device__ __forceinline__ float dot_chunk(uint4 w, const float* qc, int qn) {
  const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
  float s0 = 0.f, s1 = 0.f;
  if (KIND == kBf16) {
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const float4 qa = *reinterpret_cast<const float4*>(qc + 2 * i);
      s0 = fmaf(qa.x, bf_lo(wv[i]), s0);
      s1 = fmaf(qa.y, bf_hi(wv[i]), s1);
      s0 = fmaf(qa.z, bf_lo(wv[i + 1]), s0);
      s1 = fmaf(qa.w, bf_hi(wv[i + 1]), s1);
    }
  } else if (KIND == kInt8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 qa = *reinterpret_cast<const float4*>(qc + 4 * i);
      const uint32_t u = wv[i] ^ 0x80808080u;
      s0 = fmaf(qa.x, byte_f(u, 0) - kInt8Bias, s0);
      s1 = fmaf(qa.y, byte_f(u, 1) - kInt8Bias, s1);
      s0 = fmaf(qa.z, byte_f(u, 2) - kInt8Bias, s0);
      s1 = fmaf(qa.w, byte_f(u, 3) - kInt8Bias, s1);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 ql = *reinterpret_cast<const float4*>(qc + 4 * i);
      const float4 qh = *reinterpret_cast<const float4*>(qc + qn + 4 * i);
      const uint32_t u = wv[i] ^ 0x88888888u;
      const uint32_t lo = u & 0x0F0F0F0Fu, hi = (u >> 4) & 0x0F0F0F0Fu;
      s0 = fmaf(ql.x, byte_f(lo, 0) - kInt4Bias, s0);
      s1 = fmaf(ql.y, byte_f(lo, 1) - kInt4Bias, s1);
      s0 = fmaf(ql.z, byte_f(lo, 2) - kInt4Bias, s0);
      s1 = fmaf(ql.w, byte_f(lo, 3) - kInt4Bias, s1);
      s0 = fmaf(qh.x, byte_f(hi, 0) - kInt4Bias, s0);
      s1 = fmaf(qh.y, byte_f(hi, 1) - kInt4Bias, s1);
      s0 = fmaf(qh.z, byte_f(hi, 2) - kInt4Bias, s0);
      s1 = fmaf(qh.w, byte_f(hi, 3) - kInt4Bias, s1);
    }
  }
  return s0 + s1;
}

// One P.V column of a staged V row: 8 elements, as fp32.  bf16 and int8:
// elements 8*cd .. 8*cd+7; int4: bytes 4*cd .. 4*cd+3, low nibbles then
// high nibbles (elements 4*cd+j and hd/2+4*cd+j).
template <int KIND>
__device__ __forceinline__ void pv_load(const unsigned char* p, float (&v)[8]) {
  if (KIND == kBf16) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = bf_lo(wv[i]);
      v[2 * i + 1] = bf_hi(wv[i]);
    }
  } else if (KIND == kInt8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const uint32_t wv[2] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) v[4 * i + n] = byte_f(wv[i], n) - kInt8Bias;
  } else {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p) ^ 0x88888888u;
    const uint32_t lo = u & 0x0F0F0F0Fu, hi = (u >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      v[n] = byte_f(lo, n) - kInt4Bias;
      v[4 + n] = byte_f(hi, n) - kInt4Bias;
    }
  }
}

// A float as an int that orders as the float does (an involution).
__device__ __forceinline__ int ord(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float unord(int b) { return __int_as_float(b >= 0 ? b : b ^ 0x7FFFFFFF); }

template <typename QT, int KIND, int NT, int T>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(Args a, Layout y) {
  using K = Kind<KIND>;
  constexpr int kMaxQ = kMaxG * 256 / NT;      // q elements a thread stages: G * planes * qn <= 8 * 256
  constexpr int kMaxPt = (kMaxPartPages + NT - 1) / NT;  // table entries a thread stages
  constexpr bool kQuant = KIND != kBf16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int G = a.G, hd = a.hd, psz = a.psz;
  const long long bh = (long long)b * a.KVp + h;
  float* rec = a.part + (bh * a.n_split + split) * G * (hd + 2);
  QT* out = static_cast<QT*>(a.out) + bh * G * hd;

  // Loads that do not wait for the length: the partition's table entries
  // and q.  Then the attended positions of this partition, [a0, a1).
  const int raw_len = a.lengths[b];
  const int p_lo = split * a.part_pages, p_n = min(a.part_pages, a.n_pgs - p_lo);
  const int* pt_row = a.page_table + (long long)b * a.n_pgs + p_lo;
  int ptv[kMaxPt];
#pragma unroll
  for (int j = 0; j < kMaxPt; ++j) ptv[j] = tid + j * NT < p_n ? pt_row[tid + j * NT] : 0;
  const int qn = y.cpr * K::kChunkElems, nq = G * K::kPlanes * qn;
  const QT* qg = static_cast<const QT*>(a.q) + bh * G * hd;
  QT qv[kMaxQ];
#pragma unroll
  for (int j = 0; j < kMaxQ; ++j) {
    const int i = tid + j * NT;
    if (i >= nq) break;
    const int g = i / (K::kPlanes * qn), r = i - g * K::kPlanes * qn;
    const int plane = r / qn, jj = r - plane * qn;
    const int e = KIND == kInt4 ? (jj < hd / 2 ? jj + plane * (hd / 2) : -1) : (jj < hd ? jj : -1);
    qv[j] = e < 0 ? QT(0.f) : qg[g * hd + e];
  }
  const int hi = min(raw_len, a.n_pgs * psz);
  const int lo = a.window >= 0 ? max(0, raw_len - a.window) : 0;
  const int a0 = max(lo, p_lo * psz);
  const int a1 = min(hi, (p_lo + p_n) * psz);
  if (a1 <= a0) {  // nothing attended here: an empty state, or a zero output
    if (a.n_split > 1) {
      for (int g = tid; g < G; g += NT) {
        rec[g] = -INFINITY;
        rec[G + g] = 0.f;
      }
    } else {
      for (int i = tid; i < G * hd; i += NT) store(out + i, 0.f);
    }
    return;
  }

  unsigned char* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + y.off_q);
  float* sp = reinterpret_cast<float*>(smem + y.off_sp);  // scores [2][G][T]
  int* tmax = reinterpret_cast<int*>(smem + y.off_ml);    // the tile's max score, [3][kMaxG]
  float* m_s = reinterpret_cast<float*>(tmax + 3 * kMaxG);
  int* pt_s = reinterpret_cast<int*>(smem + y.off_pt);
  long long* rows = reinterpret_cast<long long*>(smem + y.off_rows);  // [kStages][T]

#pragma unroll
  for (int j = 0; j < kMaxPt; ++j)
    if (tid + j * NT < p_n) pt_s[tid + j * NT] = ptv[j];
  // q scaled and rounded as the reference does, laid out like the staged
  // rows (int4: a plane of low-nibble elements and one of high), zero past hd.
#pragma unroll
  for (int j = 0; j < kMaxQ; ++j) {
    const int i = tid + j * NT;
    if (i >= nq) break;
    q_s[i] = round_as(QT(), to_f32(qv[j]) * a.inv_sqrt_hd);
  }
  if (tid < 3 * kMaxG) tmax[tid] = ord(-INFINITY);
  // Zero the bytes of each staged row between its end and its last chunk's
  // end: the copies never write them, and the dots read them.
  const int tail = y.cpr * 16 - y.row_bytes;
  for (int i = tid; i < kStages * 2 * T * tail; i += NT) {
    const int row = i / tail, st = row / (2 * T);
    ring[st * y.stage_bytes + (row - st * 2 * T) * y.rbs + y.row_bytes + (i - row * tail)] = 0;
  }
  __syncthreads();

  // Copies.  The global row index of each position of tile j, (page * psz
  // + slot) * KVp + h, is worked out once, a tile ahead, into rows[j % kStages];
  // then the threads walk the tile's (position, piece) pairs with a fixed
  // stride, so that no division runs per copy.
  const bool pow2 = (psz & (psz - 1)) == 0;
  const int psh = __ffs(psz) - 1;
  auto fill_rows = [&](int j) {
    const int t0 = a0 + j * T, nt = min(T, a1 - t0);
    long long* r = rows + (j % kStages) * T;
    for (int t = tid; t < nt; t += NT) {
      const int pos = t0 + t, pg = pow2 ? pos >> psh : pos / psz;
      r[t] = ((long long)pt_s[pg - p_lo] * psz + (pos - pg * psz)) * a.KVp + h;
    }
  };
  const int per_row = y.row_bytes / y.vb;
  const int d_row = NT / per_row, d_col = NT - d_row * per_row;
  const int t_first = tid / per_row, c_first = tid - t_first * per_row;
  const unsigned char* kb = static_cast<const unsigned char*>(a.k_pages);
  const unsigned char* vbp = static_cast<const unsigned char*>(a.v_pages);
  auto issue = [&](int k) {
    const int nt = min(T, a1 - (a0 + k * T));
    unsigned char* st = ring + (k % kStages) * y.stage_bytes;
    const long long* r = rows + (k % kStages) * T;
    int t = t_first, c = c_first;
    if (y.vb == 16) {
#pragma unroll 4
      for (int i = tid; i < nt * per_row; i += NT) {
        const long long off = r[t] * y.row_bytes + c * 16;
        unsigned char* dk = st + t * y.rbs + c * 16;
        cp_async16(dk, kb + off);
        cp_async16(dk + T * y.rbs, vbp + off);
        t += d_row;
        c += d_col;
        if (c >= per_row) {
          c -= per_row;
          ++t;
        }
      }
    } else {
      for (int i = tid; i < nt * per_row; i += NT) {
        const long long off = r[t] * y.row_bytes + c * y.vb;
        unsigned char* dk = st + t * y.rbs + c * y.vb;
        unsigned char* dv = dk + T * y.rbs;
        if (y.vb == 4) {
          cp_async4(dk, kb + off);
          cp_async4(dv, vbp + off);
        } else {
          *dk = kb[off];
          *dv = vbp[off];
        }
        t += d_row;
        c += d_col;
        if (c >= per_row) {
          c -= per_row;
          ++t;
        }
      }
    }
    if (kQuant) {
      float* sc = reinterpret_cast<float*>(st + 2 * T * y.rbs);
      for (int u = tid; u < nt; u += NT) {
        cp_async4(sc + u, a.k_scale + r[u]);
        cp_async4(sc + T + u, a.v_scale + r[u]);
      }
    }
  };

  // P.V: one column (query head, 8 elements) and a subset of the tile's
  // positions per thread; the column keeps its query head's softmax state
  // (the same in every thread of that head) and the sum of its subset's p.
  const int col = tid % y.cols, g_pv = col / y.npv, cd = col - g_pv * y.npv;
  const int tsub = tid / y.cols;
  const bool pv_on = tsub < y.ts;
  float acc[8], m_run = -INFINITY, l_run = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  const int L = y.lanes, lid = tid % L, n_chunks = (y.cpr - lid + L - 1) / L;

  // Scores of tile k: L lanes per (query head, position) dot, t fastest, so
  // a warp's dots share one query head; the tile's max per query head.
  auto scores = [&](int k) {
    const unsigned char* st = ring + (k % kStages) * y.stage_bytes;
    const float* sc = reinterpret_cast<const float*>(st + 2 * T * y.rbs);
    const int nt = min(T, a1 - (a0 + k * T));
    float* sp_k = sp + (k & 1) * G * T;
    int* tmax_k = tmax + (k % 3) * kMaxG;
    for (int i = tid / L; i < G * T; i += NT / L) {
      const int g = i / T, t = i - g * T;
      float part = 0.f;
      if (t < nt) {
        const unsigned char* krow = st + t * y.rbs + lid * 16;
        const float* qc = q_s + g * K::kPlanes * qn + lid * K::kChunkElems;
#pragma unroll 4
        for (int j = 0; j < n_chunks; ++j)
          part += dot_chunk<KIND>(*reinterpret_cast<const uint4*>(krow + j * L * 16),
                                  qc + j * L * K::kChunkElems, qn);
      }
      for (int o = L >> 1; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      float s = -INFINITY;
      if (t < nt) {
        s = kQuant ? part * sc[t] : part;
        if (a.softcap > 0.f) s = tanhf(s / a.softcap) * a.softcap;
        if (lid == 0) sp_k[g * T + t] = s;
      }
      const int mx = __reduce_max_sync(0xffffffffu, ord(s));
      if (lane == 0) atomicMax(tmax_k + g, mx);
    }
  };
  // Online softmax and P.V of tile k from its staged V rows.
  auto pv = [&](int k) {
    if (!pv_on) return;
    const unsigned char* st = ring + (k % kStages) * y.stage_bytes;
    const float* sc = reinterpret_cast<const float*>(st + 2 * T * y.rbs);
    const int nt = min(T, a1 - (a0 + k * T));
    const float m_new = fmaxf(m_run, unord(tmax[(k % 3) * kMaxG + g_pv]));
    const float corr = expf(m_run - m_new);  // 0 on the first tile (m = -inf)
    m_run = m_new;
    l_run *= corr;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] *= corr;
    const unsigned char* vcol = st + (T + tsub) * y.rbs + cd * K::kPvBytes;
    const float* s_g = sp + (k & 1) * G * T + g_pv * T + tsub;
    const int n_u = tsub < nt ? (nt - tsub + y.ts - 1) / y.ts : 0;
#pragma unroll 4
    for (int u = 0; u < n_u; ++u) {
      const float p = expf(s_g[u * y.ts] - m_new);
      l_run += p;
      const float pw = kQuant ? p * sc[T + tsub + u * y.ts] : p;  // the v scale folded into p
      float v[8];
      pv_load<KIND>(vcol + u * y.ts * y.rbs, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(pw, v[j], acc[j]);
    }
  };

  // The pipeline: tiles k + 2 and k + 3 in flight while the scores of tile
  // k + 1 and the P.V of tile k run in one phase, one barrier per tile.
  const int n_tiles = (a1 - a0 + T - 1) / T;
  for (int k = 0; k < kStages && k < n_tiles; ++k) fill_rows(k);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_tiles) issue(k);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();  // tile 0 is staged
  scores(0);
  for (int k = 0; k < n_tiles; ++k) {
    cp_async_wait<kStages - 3>();
    __syncthreads();  // tile k + 1 is staged, tile k's scores are complete, tile k - 1 is done
    if (k + kStages - 1 < n_tiles) issue(k + kStages - 1);
    cp_async_commit();
    if (k + kStages < n_tiles) fill_rows(k + kStages);  // its slot was last read by issue(k)
    if (tid < G) tmax[((k + 2) % 3) * kMaxG + tid] = ord(-INFINITY);  // last read for tile k - 1
    if (k + 1 < n_tiles) scores(k + 1);
    pv(k);
  }

  // Sum the P.V subsets in a fixed order and write the result.
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // acc [ts][cols][8], then l [ts][G]
  float* lred = red + 8 * y.ts * y.cols;
  if (pv_on) {
#pragma unroll
    for (int j = 0; j < 8; ++j) red[(tsub * y.cols + col) * 8 + j] = acc[j];
    if (cd == 0) {
      lred[tsub * G + g_pv] = l_run;
      if (tsub == 0) m_s[g_pv] = m_run;
    }
  }
  __syncthreads();
  auto l_of = [&](int g) {  // the query head's sum of p, subsets in order
    float l = 0.f;
    for (int u = 0; u < y.ts; ++u) l += lred[u * G + g];
    return l;
  };
  for (int o = tid; o < G * hd; o += NT) {
    const int g = o / hd, e = o - g * hd;
    int cd, j;
    if (KIND == kInt4) {
      const int half = hd >> 1, eb = e < half ? e : e - half;
      cd = eb >> 2;
      j = (eb & 3) + (e < half ? 0 : 4);
    } else {
      cd = e >> 3;
      j = e & 7;
    }
    const int col = g * y.npv + cd;
    float A = 0.f;
    for (int u = 0; u < y.ts; ++u) A += red[(u * y.cols + col) * 8 + j];
    if (a.n_split > 1)
      rec[2 * G + o] = A;
    else
      store(out + o, A / fmaxf(l_of(g), 1e-30f));
  }
  if (a.n_split > 1 && tid < G) {
    rec[tid] = m_s[tid];
    rec[G + tid] = l_of(tid);
  }
}

// Merge each (sequence, kv head)'s partitions in ascending order.
template <typename QT>
__global__ void __launch_bounds__(kCombineThreads)
paged_attention_combine_kernel(Args a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = a.G, hd = a.hd, S = a.n_split, rl = G * (hd + 2);
  const long long bh = (long long)b * a.KVp + h;
  const float* rec = a.part + bh * S * rl;
  QT* out = static_cast<QT*>(a.out) + bh * G * hd;
  for (int o = threadIdx.x; o < G * hd; o += kCombineThreads) {
    const int g = o / hd;
    float M = -INFINITY;
    for (int s = 0; s < S; ++s) M = fmaxf(M, rec[s * rl + g]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < S; ++s) {
      const float m = rec[s * rl + g];
      if (m == -INFINITY) continue;  // an empty partition: its acc was never written
      const float f = expf(m - M);
      L = fmaf(rec[s * rl + G + g], f, L);
      A = fmaf(rec[s * rl + 2 * G + o], f, A);
    }
    store(out + o, A / fmaxf(L, 1e-30f));
  }
}

// Bytes of one head row of a page.
int row_bytes_of(int kind, int hd) { return kind == kInt4 ? hd / 2 : kind == kInt8 ? hd : 2 * hd; }

template <int KIND, int NT, int T>
Layout layout_of(int G, int hd, int vb) {
  using K = Kind<KIND>;
  Layout y{};
  y.row_bytes = row_bytes_of(KIND, hd);
  y.cpr = (y.row_bytes + 15) / 16;
  y.vb = vb;
  int lanes = 1;
  while (lanes * 2 * G * T <= NT && lanes * 2 <= y.cpr && lanes < 8) lanes *= 2;
  y.lanes = lanes;
  // The 8 lanes of a quarter-warp read 16 bytes each, chunk lane % L of row
  // lane / L: the shortest row stride of u 16-byte units (u >= cpr) that
  // puts at most two of them on one bank group.
  int u = y.cpr;
  for (;; ++u) {
    int hits[8] = {0}, worst = 0;
    for (int q = 0; q < 8; ++q) {
      const int bank = ((q / lanes) * u + q % lanes) % 8;
      worst = ++hits[bank] > worst ? hits[bank] : worst;
    }
    if (worst <= 2) break;
  }
  y.rbs = 16 * u;
  y.npv = (y.row_bytes + K::kPvBytes - 1) / K::kPvBytes;
  y.cols = G * y.npv;
  y.ts = NT / y.cols;  // cols = G * hd / 8 <= NT (the launcher's choice of NT)
  y.stage_bytes = 2 * T * y.rbs + (KIND != kBf16 ? 2 * T * 4 : 0);
  const int ring = kStages * y.stage_bytes;
  const int red = 4 * (8 * y.ts * y.cols + y.ts * G);  // acc and l of the P.V subsets
  y.off_q = ((ring > red ? ring : red) + 15) / 16 * 16;
  y.off_sp = y.off_q + 4 * G * K::kPlanes * y.cpr * K::kChunkElems;
  y.off_ml = y.off_sp + 4 * 2 * G * T;
  y.off_pt = y.off_ml + 4 * 4 * kMaxG;
  y.off_rows = y.off_pt + 4 * kMaxPartPages;
  y.smem = y.off_rows + 8 * kStages * T;
  return y;
}

int copy_width(int row_bytes, const void* k, const void* v) {
  const uintptr_t any = (uintptr_t)k | (uintptr_t)v;
  if (row_bytes % 16 == 0 && any % 16 == 0) return 16;
  if (row_bytes % 4 == 0 && any % 4 == 0) return 4;
  return 1;
}

// One query head per kv head runs 128 threads per CTA, more run 256: the
// dots per byte grow with G, and 256 columns of 8 need 256 threads at
// G = 8, hd = 256.  The grid and the occupancy query take the same
// instance, T positions per tile.
template <typename QT, int KIND, int NT, int T>
struct Instance {
  static Layout layout(const Args& a, int vb) { return layout_of<KIND, NT, T>(a.G, a.hd, vb); }
  static cudaError_t prepare(const Layout& y) {
    if (y.smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(paged_attention_kernel<QT, KIND, NT, T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, y.smem);
  }
  static cudaError_t launch(const Args& a, cudaStream_t stream) {
    const Layout y = layout(a, copy_width(row_bytes_of(KIND, a.hd), a.k_pages, a.v_pages));
    cudaError_t err = prepare(y);
    if (err != cudaSuccess) return err;
    paged_attention_kernel<QT, KIND, NT, T><<<dim3(a.KVp, a.B, a.n_split), NT, y.smem, stream>>>(a, y);
    err = cudaGetLastError();
    if (err != cudaSuccess || a.n_split == 1) return err;
    paged_attention_combine_kernel<QT><<<dim3(a.KVp, a.B), kCombineThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  static int occupancy(const Args& a) {
    const Layout y = layout(a, 16);
    cudaError_t err = prepare(y);
    int n = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, paged_attention_kernel<QT, KIND, NT, T>,
                                                          NT, y.smem);
    return err == cudaSuccess ? n : -(int)err;
  }
};

// The kind's tile, or half of it for bf16 rows too wide for four stages of
// it in the shared memory a CTA may take (hd > 192 at 64 positions).
template <typename QT, int KIND, int NT, typename F>
auto by_tile(int G, int hd, F f) {
  constexpr int T = Kind<KIND>::kTile;
  if constexpr (KIND == kBf16) {
    if (layout_of<KIND, NT, T>(G, hd, 16).smem > kMaxSmem) return f(Instance<QT, KIND, NT, T / 2>());
  }
  return f(Instance<QT, KIND, NT, T>());
}

// Calls f(Instance<...>()) for the instance that takes (q dtype, kind, G, hd).
template <typename F>
auto dispatch(int q_bf16, int kind, int G, int hd, F f) {
#define PA_KIND(QT, KIND) \
  return G == 1 ? by_tile<QT, KIND, 128>(G, hd, f) : by_tile<QT, KIND, 256>(G, hd, f);
#define PA_Q(QT)                              \
  switch (kind) {                             \
    case kBf16: PA_KIND(QT, kBf16)            \
    case kInt8: PA_KIND(QT, kInt8)            \
    default: PA_KIND(QT, kInt4)               \
  }
  if (q_bf16) {
    PA_Q(__nv_bfloat16)
  } else {
    PA_Q(float)
  }
#undef PA_Q
#undef PA_KIND
}

}  // namespace

// Launch kernel 5 on a plan of part_pages pages per partition: ceil(n_pgs /
// part_pages) partitions, one for an empty table (the combine runs when
// there are more than one; part then holds B*KVp*n_split*G*(hd+2) floats).
extern "C" int paged_attention(const void* q, int q_bf16, const void* k_pages, const void* v_pages,
                               int kind, const float* k_scale, const float* v_scale,
                               const int* page_table, const int* lengths, void* out, float* part,
                               int B, int KVp, int G, int hd, int psz, int n_pgs, int window,
                               float softcap, float inv_sqrt_hd, int part_pages, void* stream,
                               int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || KVp <= 0 || G <= 0 || hd <= 0) return 0;
  if (G > kMaxG || hd > 256 || psz <= 0 || part_pages < 1 || part_pages > kMaxPartPages ||
      kind < kBf16 || kind > kInt4 || (kind != kBf16 && !k_scale))
    return (int)cudaErrorInvalidValue;
  const int n_split = n_pgs > 0 ? (n_pgs + part_pages - 1) / part_pages : 1;
  if (n_split > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, out, part,
               B, KVp, G, hd, psz, n_pgs, window, softcap, inv_sqrt_hd, part_pages, n_split};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)dispatch(q_bf16, kind, G, hd, [&](auto inst) { return decltype(inst)::launch(a, s); });
}

// CTAs of kernel 5 for (q dtype, page kind, G, hd) resident on one SM of
// the card (the CUDA occupancy calculator), or -(CUDA error).
extern "C" int paged_ctas_per_sm(int q_bf16, int kind, int G, int hd, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  if (G <= 0 || G > kMaxG || hd <= 0 || hd > 256 || kind < kBf16 || kind > kInt4)
    return -(int)cudaErrorInvalidValue;
  Args a{};
  a.G = G;
  a.hd = hd;
  return dispatch(q_bf16, kind, G, hd, [&](auto inst) { return decltype(inst)::occupancy(a); });
}
