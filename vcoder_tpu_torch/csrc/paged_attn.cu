// Paged attention over a KV page pool, for Hopper (sm_90a): decode (window 1),
// prompt-lookup speculative verify (window k) and lockstep chunk prefill
// (window kc), over bf16 pages or int8 pages with f32 per-token-per-head
// scales; and the fused append + attend of a decode or verify window.
//
// Port of the TPU kernels `_carry_kernel_multi` (vcoder_tpu/ops/
// paged_attention.py:297), `_carry_kernel_multi_q8` (:664), viewed as a
// one-layer pool at window 1 `_paged_kernel` (:55), and, with FUSED,
// `_carry_kernel_fused` (:1263). It computes their function, not their
// structure: the TPU kernels stream a row's pages through a double-buffered
// manual DMA driven by scalar-prefetched page ids, one grid step per row;
// here one block handles one (row b, KV head kh, tile of NC query columns)
// and reads its own page ids and length.
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
// FUSED (paged_attention.py:1263-1421): `lengths` include the window for
// active rows only; the page loop runs over the old = length - window*active
// pre-window tokens, every column seeing tok < old; then one more step runs
// over the window itself, taken from the new_k/new_v operands (not from the
// pool), with the intra-window causal mask t <= c % window (fully masked for
// an inactive row). The block of column tile 0 of each (row, KV head) then
// writes the window's K/V (int8: and their scales) into pool slots
// positions[b] + t through the page table (past the table: page 0, as the
// port's token writer); an inactive row writes the scratch page n_pages - 1.
// One writer block per (row, KV head): with several column tiles, several
// blocks would write the same bytes. The other tiles may be reading the last
// page while it is written: the slots at positions >= old hold stale or
// in-flight bytes, so they are excluded by selects (scores, probabilities,
// V-scales and V rows of keys no column sees), never by multiplying by 0
// (:1334-1342's invariant, a real race on this card).
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
// per column tile (mostly from L2). FUSED saves the separate append
// launches and reads no page that only the window would have opened; its
// writes are a window's worth of rows, small next to the page reads.
//
// Later work (ROADMAP K3/K4/K7): split one row's pages over several blocks
// (flash-decoding) for long contexts at small B, a cp.async/TMA page ring so
// the next page loads during phases B and C, and wgmma for chunk windows.

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

// One block of ntok keys (a page, or the fused window) through the online
// softmax: kb/vb point at this lane's 8 dims of key 0, rs elements apart per
// key; ksb/vsb at key 0's scales, ss apart (int8). Key i is token tok0 + i;
// column c sees it when tok0 + i <= lim[c] (lim_s[c] in shared memory, for
// phase B's dynamic column). TAIL: ntok need not be a multiple of the 8
// half-warps (the window); a page's keys are. SKIP: a key no column sees
// (past lim_max) has its V row skipped, not multiplied by 0 -- the fused
// page loop's stale or mid-write slots. Two barriers inside: after the
// scores (A) and after the softmax update (B). The caller's next block's
// barrier after A orders this block's reads of P (C) before P is
// overwritten.
template <int NC, bool Q8, bool TAIL, bool SKIP>
__device__ __forceinline__ void key_block(
    const typename Row<Q8>::Elem* kb, const typename Row<Q8>::Elem* vb,
    long long rs, const float* ksb, const float* vsb, long long ss, int ntok,
    int tok0, int lim_max, const int (&lim)[NC], const float (&qv)[NC][8],
    float (&acc)[NC][8], float* S, float* P, int sp, float* m_s, float* l_s,
    float* a_s, const int* lim_s, float scale) {
  using R = Row<Q8>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hw = tid >> 4, l16 = tid & 15;
  const int tph = (ntok + NHW - 1) / NHW;  // keys per half-warp

  // (A) scores: half-warp hw takes keys hw, hw + 8, ... Every lane runs the
  // shuffles; with TAIL a key past ntok reads as zeros and is not stored.
  for (int r0 = 0; r0 < tph; r0 += BATCH) {
    typename R::Raw raw[BATCH];
#pragma unroll
    for (int r = 0; r < BATCH; ++r) {
      const int i = hw + NHW * (r0 + r);
      if (TAIL) raw[r] = typename R::Raw{};
      if (r0 + r < tph && (!TAIL || i < ntok)) raw[r] = R::load(kb + (long long)i * rs);
    }
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
      if (l16 == 0 && (!TAIL || i < ntok)) {
        const int tok = tok0 + i;
        const float kscale = Q8 ? ksb[(long long)i * ss] : 1.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float s = part[c] * scale;
          if (Q8) s *= kscale;
          S[c * sp + i] = tok <= lim[c] ? s : NEG_INF;
        }
      }
    }
  }
  __syncthreads();

  // (B) the block's softmax update, one warp per column.
  for (int c = warp; c < NC; c += NTHREADS / 32) {
    const int climit = lim_s[c];
    float mx = NEG_INF;
    for (int i = lane; i < ntok; i += 32) mx = fmaxf(mx, S[c * sp + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_old = m_s[c];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int i = lane; i < ntok; i += 32) {
      const bool seen = tok0 + i <= climit;
      const float p = seen ? expf(S[c * sp + i] - m_new) : 0.f;
      sum += p;
      const float pv = seen ? (Q8 ? p * vsb[(long long)i * ss] : p) : 0.f;
      P[c * sp + i] = __bfloat162float(__float2bfloat16(pv));
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
    for (int r = 0; r < BATCH; ++r) {
      const int i = hw + NHW * (r0 + r);
      if (r0 + r < tph && (!TAIL || i < ntok)) raw[r] = R::load(vb + (long long)i * rs);
    }
#pragma unroll
    for (int r = 0; r < BATCH; ++r) {
      if (r0 + r >= tph) break;
      const int i = hw + NHW * (r0 + r);
      if ((TAIL && i >= ntok) || (SKIP && tok0 + i > lim_max)) continue;
      float x[8];
      R::unpack(raw[r], x);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float p = P[c * sp + i];
#pragma unroll
        for (int d = 0; d < 8; ++d) acc[c][d] = fmaf(p, x[d], acc[c][d]);
      }
    }
  }
}

template <int NC, bool Q8, bool FUSED>
__global__ void __launch_bounds__(NTHREADS)
    paged_attn_kernel(const __nv_bfloat16* __restrict__ q,
                      const typename Row<Q8>::Elem* __restrict__ kp,
                      const typename Row<Q8>::Elem* __restrict__ vp,
                      const float* __restrict__ ks,
                      const float* __restrict__ vs,
                      const int* __restrict__ table,
                      const int* __restrict__ lengths,
                      __nv_bfloat16* __restrict__ out,
                      const typename Row<Q8>::Elem* __restrict__ nk,
                      const typename Row<Q8>::Elem* __restrict__ nv,
                      const float* __restrict__ nks,
                      const float* __restrict__ nvs,
                      const int* __restrict__ positions,
                      const int* __restrict__ active, int window, int H,
                      int KH, int n_pages, int page, int P_max, int sp,
                      long long sqb, long long sqk, long long sqh,
                      float scale) {
  using R = Row<Q8>;
  using E = typename R::Elem;
  extern __shared__ float smem[];
  float* S = smem;            // [NC, sp] scores of the current key block
  float* P = smem + NC * sp;  // [NC, sp] bf16-rounded probabilities
  __shared__ float m_s[NC], l_s[NC], a_s[NC];
  __shared__ int lim_s[NC];

  const int b = blockIdx.x, kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int hw = tid >> 4, l16 = tid & 15;
  const int group = H / KH;
  const int C = group * window;
  const int c0 = blockIdx.z * NC;
  const int length = lengths[b];
  const bool act = FUSED ? active[b] != 0 : true;
  // Tokens read from the pool: the row's (K3/K4), or those before the
  // window (K7, whose window comes from the operands).
  const int old = FUSED ? length - (act ? window : 0) : length;
  int n_live = old > 0 ? (old + page - 1) / page : 0;
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
  // Column c sees pool token tok <= lim[c]; a column past C sees nothing.
  int lim[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = c0 + c;
    lim[c] = col >= C ? -1 : FUSED ? old - 1 : (length - window) + (col % window);
  }
  if (tid < NC) {
    lim_s[tid] = lim[tid];
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[NC][8];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int d = 0; d < 8; ++d) acc[c][d] = 0.f;

  for (int j = 0; j < n_live; ++j) {
    int pg = table[(long long)b * P_max + j];
    pg = pg < 0 ? 0 : (pg >= n_pages ? n_pages - 1 : pg);
    const long long base = ((long long)pg * KH + kh) * page;  // token rows
    key_block<NC, Q8, false, FUSED>(
        kp + base * HD + l16 * 8, vp + base * HD + l16 * 8, HD,
        Q8 ? ks + base : nullptr, Q8 ? vs + base : nullptr, 1, page, j * page,
        old - 1, lim, qv, acc, S, P, sp, m_s, l_s, a_s, lim_s, scale);
  }

  if constexpr (FUSED) {
    // The window as one more key block, from the operands: token t of
    // (b, kh) at nk[((b * window + t) * KH + kh) * HD], causal within the
    // window. Every thread is past the last page's phase B, the only
    // reader of lim_s.
#pragma unroll
    for (int c = 0; c < NC; ++c) lim[c] = (c0 + c < C && act) ? (c0 + c) % window : -1;
    if (tid < NC) lim_s[tid] = lim[tid];
    __syncthreads();
    const long long w0 = (long long)b * window * KH + kh;  // token 0's row
    key_block<NC, Q8, true, false>(
        nk + w0 * HD + l16 * 8, nv + w0 * HD + l16 * 8, (long long)KH * HD,
        Q8 ? nks + w0 : nullptr, Q8 ? nvs + w0 : nullptr, KH, window, 0,
        act ? window - 1 : -1, lim, qv, acc, S, P, sp, m_s, l_s, a_s, lim_s,
        scale);
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

  if constexpr (FUSED) {
    if (blockIdx.z != 0) return;  // one writer block per (row, KV head)
    // The pools are written through the pointers they are read by. Other
    // blocks may read these slots through the read-only path during the
    // launch and see the old bytes: they are past old, never used.
    E* kw = const_cast<E*>(kp);
    E* vw = const_cast<E*>(vp);
    for (int t = hw; t < window; t += NHW) {
      const int pos = positions[b] + t;
      int pg = n_pages - 1;  // inactive rows park on the scratch page
      if (act) {
        const int idx = pos / page;
        pg = (idx < 0 || idx >= P_max) ? 0 : table[(long long)b * P_max + idx];
        pg = pg < 0 ? 0 : (pg >= n_pages ? n_pages - 1 : pg);
      }
      int off = pos % page;
      if (off < 0) off += page;
      const long long dst = ((long long)pg * KH + kh) * page + off;
      const long long src = ((long long)b * window + t) * KH + kh;
      *reinterpret_cast<typename R::Raw*>(kw + dst * HD + l16 * 8) =
          R::load(nk + src * HD + l16 * 8);
      *reinterpret_cast<typename R::Raw*>(vw + dst * HD + l16 * 8) =
          R::load(nv + src * HD + l16 * 8);
      if (Q8 && l16 == 0) {
        const_cast<float*>(ks)[dst] = nks[src];
        const_cast<float*>(vs)[dst] = nvs[src];
      }
    }
  }
}

template <int NC, bool Q8, bool FUSED>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* table,
                   const int* lengths, void* out, const void* nk,
                   const void* nv, const float* nks, const float* nvs,
                   const int* positions, const int* active, int B, int window,
                   int H, int KH, int n_pages, int page, int P_max,
                   long long sqb, long long sqk, long long sqh, float scale,
                   cudaStream_t stream) {
  using E = typename Row<Q8>::Elem;
  const int C = (H / KH) * window;
  // Rows of S and P hold a page, or (FUSED) the window if it is longer.
  const int sp = (FUSED && window > page) ? window : page;
  dim3 grid(B, KH, (C + NC - 1) / NC);
  const int a = 2 * NC * sp, m = NHW * NC * HD;
  const size_t smem = sizeof(float) * (a > m ? a : m);
  paged_attn_kernel<NC, Q8, FUSED><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const E*>(kp),
      static_cast<const E*>(vp), ks, vs, table, lengths,
      static_cast<__nv_bfloat16*>(out), static_cast<const E*>(nk),
      static_cast<const E*>(nv), nks, nvs, positions, active, window, H, KH,
      n_pages, page, P_max, sp, sqb, sqk, sqh, scale);
  return cudaGetLastError();
}

template <bool Q8, bool FUSED>
cudaError_t dispatch(int nc, const void* q, const void* kp, const void* vp,
                     const float* ks, const float* vs, const int* table,
                     const int* lengths, void* out, const void* nk,
                     const void* nv, const float* nks, const float* nvs,
                     const int* positions, const int* active, int B,
                     int window, int H, int KH, int n_pages, int page,
                     int P_max, long long sqb, long long sqk, long long sqh,
                     float scale, cudaStream_t stream) {
#define PAGED_ATTN_LAUNCH(N)                                                  \
  return launch<N, Q8, FUSED>(q, kp, vp, ks, vs, table, lengths, out, nk, nv, \
                              nks, nvs, positions, active, B, window, H, KH,  \
                              n_pages, page, P_max, sqb, sqk, sqh, scale,     \
                              stream)
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
// window; with fused, for active rows only); out bf16 [B, window, H, 128]
// contiguous. With fused != 0: nk/nv [B, window, KH, 128] in the pool's type
// (contiguous, 16-byte aligned), nks/nvs f32 [B, window, KH] (int8),
// positions int32 [B] (window token 0's slot), active int32 [B]; the kernel
// writes them into the pool (null otherwise). page must be a multiple of 8
// and at most 256 (checked by the Python wrapper). Returns the CUDA error
// code of the launch.
extern "C" int paged_attn(const void* q, const void* kp, const void* vp,
                          const float* ks, const float* vs, const int* table,
                          const int* lengths, void* out, const void* nk,
                          const void* nv, const float* nks, const float* nvs,
                          const int* positions, const int* active, int B,
                          int window, int H, int KH, int n_pages, int page,
                          int P_max, long long sqb, long long sqk,
                          long long sqh, float scale, int quant, int fused,
                          void* stream) {
  const int C = (H / KH) * window;
  const int nc = C <= 1 ? 1 : (C <= 2 ? 2 : (C <= 4 ? 4 : 8));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_ATTN_DISPATCH(Q, F)                                              \
  dispatch<Q, F>(nc, q, kp, vp, ks, vs, table, lengths, out, nk, nv, nks, nvs, \
                 positions, active, B, window, H, KH, n_pages, page, P_max,    \
                 sqb, sqk, sqh, scale, st)
  const cudaError_t err =
      quant ? (fused ? PAGED_ATTN_DISPATCH(true, true)
                     : PAGED_ATTN_DISPATCH(true, false))
            : (fused ? PAGED_ATTN_DISPATCH(false, true)
                     : PAGED_ATTN_DISPATCH(false, false));
#undef PAGED_ATTN_DISPATCH
  return static_cast<int>(err);
}
