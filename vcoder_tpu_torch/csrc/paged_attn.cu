// Paged attention over a KV page pool, for Hopper (sm_90a): decode (window 1),
// prompt-lookup speculative verify (window k) and lockstep chunk prefill
// (window kc), over bf16 pages or int8 pages with f32 per-token-per-head
// scales.
//
// Port of the TPU kernels `_carry_kernel_multi` (vcoder_tpu/ops/
// paged_attention.py:297), `_carry_kernel_multi_q8` (:664) and, viewed as a
// one-layer pool at window 1, `_paged_kernel` (:55). It computes their
// function, not their structure: the TPU kernels stream a row's pages through
// a double-buffered manual DMA driven by scalar-prefetched page ids, one grid
// step per row; here one block handles one (row b, KV head kh, tile of NC
// query columns) and reads its own page ids and length.
//
// Semantics (paged_attention.py:248-294, FOLD_SCALES=True):
//   * query column c = g*window + t holds head h = kh*group + g at window
//     token t; q is read in the caller's [B, window, H, D] layout through its
//     strides, and out is written as [B, window, H, D], so the
//     [B, KH, group*window, D] transposes of the JAX wrapper cost no copy;
//   * the row's live pages are n_live = ceil(length / page); each page id is
//     clipped to [0, n_pages - 1]; a row with length 0 runs no page and
//     writes zeros (l_safe);
//   * column c may see key tok when tok <= (length - window) + (c % window);
//   * s = (q . k) * D^-0.5 in f32 from bf16 operands (int8 K is upcast, which
//     is exact), then s *= k_scale[tok] for int8 pools; masked s = -1e30;
//   * online softmax per page in f32; lsum accumulates p BEFORE the V scale;
//     int8: p *= v_scale[tok]; p is rounded to bf16 before PV; PV in f32;
//     out = acc / l_safe, rounded to bf16.
//
// What bounds it on the card. At decode (B=8, MHA, window 1, ~1.2k-token
// contexts in 64-token pages) one layer's launch reads ~164 MB of K+V pages
// for ~0.3 GFLOP: HBM bytes bound it (~0.049 ms at 3.35 TB/s). The design
// keeps every byte of a page read exactly once per block and coalesced: a
// half-warp covers one 256-byte key row (16 lanes x 16 bytes; 8 bytes for
// int8), the block's 8 half-warps cover 8 keys at a time, and each lane
// issues the loads of 8 keys before using them. Per page the block runs
// three phases separated by barriers: (A) scores into shared memory, (B) the
// page's softmax update per column (one warp per column), (C) P @ V into
// per-half-warp f32 accumulators, merged once through shared memory at the
// end. The per-page structure repeats the TPU kernel's online softmax page
// by page, so the kernel and its plain version round p against the same
// running maxima. For chunk windows (kc = 128 columns) the columns are tiled
// NC = 8 per block with plain FMA; the pages of a row are then re-read once
// per column tile (mostly from L2).
//
// Later work (ROADMAP K3/K4): split one row's pages over several blocks
// (flash-decoding) for long contexts at small B, a cp.async/TMA page ring so
// the next page loads during phases B and C, wgmma for chunk windows, and
// the fused append (K7).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int HD = 128;           // head dim (the wrapper raises otherwise)
constexpr int NTHREADS = 128;     // 4 warps = 8 half-warps
constexpr int NHW = NTHREADS / 16;
constexpr int BATCH = 8;          // keys a half-warp loads before using them
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void unpack_bf16(const uint4& raw, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack_i8(const uint2& raw, float (&x)[8]) {
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(v[i]);
}

// 8 elements of one K/V row for this lane: 16 bytes of bf16, 8 of int8.
template <bool Q8>
struct Row {
  using Raw = typename std::conditional<Q8, uint2, uint4>::type;
  using Elem = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  static __device__ __forceinline__ Raw load(const Elem* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& raw, float (&x)[8]) {
    if constexpr (Q8) unpack_i8(raw, x); else unpack_bf16(raw, x);
  }
};

template <int NC, bool Q8>
__global__ void __launch_bounds__(NTHREADS)
    paged_attn_kernel(const __nv_bfloat16* __restrict__ q,
                      const typename Row<Q8>::Elem* __restrict__ kp,
                      const typename Row<Q8>::Elem* __restrict__ vp,
                      const float* __restrict__ ks,
                      const float* __restrict__ vs,
                      const int* __restrict__ table,
                      const int* __restrict__ lengths,
                      __nv_bfloat16* __restrict__ out, int window, int H,
                      int KH, int n_pages, int page, int P_max, long long sqb,
                      long long sqk, long long sqh, float scale) {
  using R = Row<Q8>;
  extern __shared__ float smem[];
  float* S = smem;              // [NC, page] scores of the current page
  float* P = smem + NC * page;  // [NC, page] bf16-rounded probabilities
  __shared__ float m_s[NC], l_s[NC], a_s[NC];

  const int b = blockIdx.x, kh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hw = tid >> 4, l16 = tid & 15;
  const int group = H / KH;
  const int C = group * window;
  const int c0 = blockIdx.z * NC;
  const int length = lengths[b];
  int n_live = length > 0 ? (length + page - 1) / page : 0;
  if (n_live > P_max) n_live = P_max;

  // This lane's 8 dims of each column's query; columns past C stay zero.
  float qv[NC][8];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = c0 + c;
    if (col < C) {
      const int g = col / window, t = col % window;
      const __nv_bfloat16* qp = q + b * sqb + t * sqk + (kh * group + g) * sqh;
      unpack_bf16(*reinterpret_cast<const uint4*>(qp + l16 * 8), qv[c]);
    } else {
#pragma unroll
      for (int d = 0; d < 8; ++d) qv[c][d] = 0.f;
    }
  }
  // Column c sees tok <= lim[c]; a column past C sees nothing.
  int lim[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c)
    lim[c] = (c0 + c < C) ? (length - window) + ((c0 + c) % window) : -1;
  if (tid < NC) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[NC][8];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int d = 0; d < 8; ++d) acc[c][d] = 0.f;

  const int tph = page / NHW;  // keys per half-warp per page
  for (int j = 0; j < n_live; ++j) {
    int pg = table[(long long)b * P_max + j];
    pg = pg < 0 ? 0 : (pg >= n_pages ? n_pages - 1 : pg);
    const long long base = ((long long)pg * KH + kh) * page;  // token rows
    const typename R::Elem* kb = kp + base * HD + l16 * 8;
    const typename R::Elem* vb = vp + base * HD + l16 * 8;

    // (A) scores: half-warp hw takes keys hw, hw + 8, ...
    for (int r0 = 0; r0 < tph; r0 += BATCH) {
      typename R::Raw raw[BATCH];
#pragma unroll
      for (int r = 0; r < BATCH; ++r)
        if (r0 + r < tph) raw[r] = R::load(kb + (long long)(hw + NHW * (r0 + r)) * HD);
#pragma unroll
      for (int r = 0; r < BATCH; ++r) {
        if (r0 + r >= tph) break;
        const int i = hw + NHW * (r0 + r);
        float x[8];
        R::unpack(raw[r], x);
        float part[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < 8; ++d) s = fmaf(qv[c][d], x[d], s);
          part[c] = s;
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
        }
        if (l16 == 0) {
          const int tok = j * page + i;
          const float kscale = Q8 ? ks[base + i] : 1.f;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            float s = part[c] * scale;
            if (Q8) s *= kscale;
            S[c * page + i] = tok <= lim[c] ? s : NEG_INF;
          }
        }
      }
    }
    __syncthreads();

    // (B) the page's softmax update, one warp per column.
    for (int c = warp; c < NC; c += NTHREADS / 32) {
      int climit = (c0 + c < C) ? (length - window) + ((c0 + c) % window) : -1;
      float mx = NEG_INF;
      for (int i = lane; i < page; i += 32) mx = fmaxf(mx, S[c * page + i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[c];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int i = lane; i < page; i += 32) {
        const float p = (j * page + i <= climit) ? expf(S[c * page + i] - m_new) : 0.f;
        sum += p;
        const float pv = Q8 ? p * vs[base + i] : p;
        P[c * page + i] = __bfloat162float(__float2bfloat16(pv));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[c] = alpha;
        l_s[c] = alpha * l_s[c] + sum;
        m_s[c] = m_new;
      }
    }
    __syncthreads();

    // (C) P @ V into this half-warp's accumulators.
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float alpha = a_s[c];
#pragma unroll
      for (int d = 0; d < 8; ++d) acc[c][d] *= alpha;
    }
    for (int r0 = 0; r0 < tph; r0 += BATCH) {
      typename R::Raw raw[BATCH];
#pragma unroll
      for (int r = 0; r < BATCH; ++r)
        if (r0 + r < tph) raw[r] = R::load(vb + (long long)(hw + NHW * (r0 + r)) * HD);
#pragma unroll
      for (int r = 0; r < BATCH; ++r) {
        if (r0 + r >= tph) break;
        const int i = hw + NHW * (r0 + r);
        float x[8];
        R::unpack(raw[r], x);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float p = P[c * page + i];
#pragma unroll
          for (int d = 0; d < 8; ++d) acc[c][d] = fmaf(p, x[d], acc[c][d]);
        }
      }
    }
    // The barrier after the next page's phase A orders these reads of P
    // before phase B overwrites it.
  }
  __syncthreads();

  // Merge the 8 half-warps' accumulators; S and P are free now.
  float* M = smem;  // [NHW, NC, HD]
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int d = 0; d < 8; ++d) M[(hw * NC + c) * HD + l16 * 8 + d] = acc[c][d];
  __syncthreads();
  for (int c = 0; c < NC; ++c) {
    const int col = c0 + c;
    if (col >= C) break;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NHW; ++w) sum += M[(w * NC + c) * HD + tid];
    const float l = l_s[c];
    const float l_safe = l == 0.f ? 1.f : l;
    const int g = col / window, t = col % window;
    out[(((long long)b * window + t) * H + kh * group + g) * HD + tid] =
        __float2bfloat16(sum / l_safe);
  }
}

template <int NC, bool Q8>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* table,
                   const int* lengths, void* out, int B, int window, int H,
                   int KH, int n_pages, int page, int P_max, long long sqb,
                   long long sqk, long long sqh, float scale,
                   cudaStream_t stream) {
  using E = typename Row<Q8>::Elem;
  const int C = (H / KH) * window;
  dim3 grid(B, KH, (C + NC - 1) / NC);
  const int a = 2 * NC * page, m = NHW * NC * HD;
  const size_t smem = sizeof(float) * (a > m ? a : m);
  paged_attn_kernel<NC, Q8><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const E*>(kp),
      static_cast<const E*>(vp), ks, vs, table, lengths,
      static_cast<__nv_bfloat16*>(out), window, H, KH, n_pages, page, P_max,
      sqb, sqk, sqh, scale);
  return cudaGetLastError();
}

template <bool Q8>
cudaError_t dispatch(int nc, const void* q, const void* kp, const void* vp,
                     const float* ks, const float* vs, const int* table,
                     const int* lengths, void* out, int B, int window, int H,
                     int KH, int n_pages, int page, int P_max, long long sqb,
                     long long sqk, long long sqh, float scale,
                     cudaStream_t stream) {
#define PAGED_ATTN_LAUNCH(N)                                                  \
  return launch<N, Q8>(q, kp, vp, ks, vs, table, lengths, out, B, window, H, \
                       KH, n_pages, page, P_max, sqb, sqk, sqh, scale, stream)
  if (nc == 1) PAGED_ATTN_LAUNCH(1);
  if (nc == 2) PAGED_ATTN_LAUNCH(2);
  if (nc == 4) PAGED_ATTN_LAUNCH(4);
  PAGED_ATTN_LAUNCH(8);
#undef PAGED_ATTN_LAUNCH
}

}  // namespace

// Plain C entry point for ctypes. q is bf16 [B, window, H, 128] with the given
// element strides (head dim contiguous, strides multiples of 8, data 16-byte
// aligned); kp/vp point at ONE layer's pool [n_pages, KH, page, 128]
// (contiguous; bf16, or int8 when quant != 0, with ks/vs f32 [n_pages, KH,
// page]); table int32 [B, P_max]; lengths int32 [B] (tokens including the
// window); out bf16 [B, window, H, 128] contiguous. page must be a multiple of
// 8 and at most 256 (checked by the Python wrapper). Returns the CUDA error
// code of the launch.
extern "C" int paged_attn(const void* q, const void* kp, const void* vp,
                          const float* ks, const float* vs, const int* table,
                          const int* lengths, void* out, int B, int window,
                          int H, int KH, int n_pages, int page, int P_max,
                          long long sqb, long long sqk, long long sqh,
                          float scale, int quant, void* stream) {
  const int C = (H / KH) * window;
  const int nc = C <= 1 ? 1 : (C <= 2 ? 2 : (C <= 4 ? 4 : 8));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      quant ? dispatch<true>(nc, q, kp, vp, ks, vs, table, lengths, out, B,
                             window, H, KH, n_pages, page, P_max, sqb, sqk,
                             sqh, scale, st)
            : dispatch<false>(nc, q, kp, vp, ks, vs, table, lengths, out, B,
                              window, H, KH, n_pages, page, P_max, sqb, sqk,
                              sqh, scale, st);
  return static_cast<int>(err);
}
