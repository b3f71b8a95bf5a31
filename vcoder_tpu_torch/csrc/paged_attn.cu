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
// here blocks read their own page ids and lengths (the two bodies below).
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
// Two bodies compute this function. The wrapper (ops/paged_attention.py::
// split_of, the one place that routes) sends the int8 calls and the
// fused calls whose C = group * window is at most 16 (K4 at decode and
// verify, every K7 call) to the SPLIT body, and everything else (the bf16
// unfused calls K3 and K8, int8 chunk windows with C > 16, a fused GQA
// window with C > 16) to the PAGE body, the kernel's first design; the
// entry point's `split` argument says which (0: the PAGE body).
//
// What bounds both on the card. At decode (B=8, MHA, window 1, ~1.2k-token
// contexts in 64-token pages) one layer's launch reads ~164 MB of bf16 K+V
// pages (~82 MB int8 + scales) for ~0.3 GFLOP: HBM bytes bound it (~0.049
// ms bf16, ~0.025 ms int8, at 3.35 TB/s).
//
// SPLIT body (flash-decoding over a cluster, a bulk-copy page ring):
// - One thread-block cluster of S blocks per (row, KV head); block rank r
//   takes the contiguous run [r n / S, (r + 1) n / S) of the row's n live
//   pages. S comes from the wrapper (ops/paged_attention.py::_split_plan):
//   the largest S <= 8 whose grid still fits one wave of the card
//   (paged_attn_capacity reports the cluster occupancy).
// - A ring of 4 tiles in shared memory (64 keys int8, 32 bf16: 16 KB of K
//   and V, ~66 KB in all: 3 blocks an SM at one column, 2 at 2 to 8
//   columns, by registers) fed by 1-D bulk async copies
//   (cp.async.bulk...mbarrier::complete_tx): one tile of one KV head is one
//   contiguous run of the pool (K, V, and the int8 scales), so page ids stay
//   dynamic and no tensor map is needed. A producer warp (one thread) reads
//   the block's page ids and keeps the ring's tiles in flight; a page
//   longer than a tile is several tiles. Pages are multiples of 8 up to
//   256 (the wrapper checks), so every copy is a multiple of 16 bytes at a
//   16-byte aligned address (the pools' bases are checked too). A lost
//   arrival traps (sm90::mbar_wait).
// - Consumer warps (8 up to 4 columns, else 4) take the tiles' 8-key groups
//   in turn, each warp its own online softmax over its keys in registers:
//   no block-wide barrier per tile, only the ring's mbarriers. A lane owns
//   4 of the 128 dims; the partial scores of a chunk of KC keys x NC
//   columns (32 pairs, 8 or 16 at NC 1 or 2) are summed by a reduce-scatter
//   of shuffles that leaves each lane one whole (key, column) score. The
//   k-scale multiplies the score; p is taken against the warp's running
//   maximum, summed into l before the v-scale, multiplied by the v-scale and
//   rounded to bf16; P.V reads V from the ring.
// - int8 becomes f32 without cvt: each 4-byte word is XORed with 0x80808080
//   (bytes b + 128), each byte permuted into the mantissa of 2^23 (PRMT)
//   and 2^23 + 128 subtracted (one FADD): exact, no I2F.
// - The merge stays in the launch: the warps' (m, l, acc) are merged in the
//   block's shared memory, then, after a cluster barrier, each rank merges
//   its share of the C x 128 outputs from every rank's partial through
//   distributed shared memory, in rank order, and writes them; a second
//   cluster barrier keeps shared memory alive until every rank has read
//   it. A split that saw no key (no live page, a length-0 row, every key
//   masked) carries m = -1e30, l = 0, acc = 0, and both merges skip it by
//   a select: it never gets the weight exp(0), and no weight multiplies it.
// - Rounding: p is rounded against the running maximum of the warp's keys
//   of its split, not the row's maximum page by page (the plain version's
//   and the PAGE body's order). Within the card's gates (max-abs 2e-2,
//   each head's relative L2 8e-3; tests/test_torch_paged_split.py pins
//   the gap).
// - FUSED: the window's own keys (from the operands, causal within the
//   window) run in the cluster's last rank only, before its tiles, while
//   the first tiles load; rank 0 alone writes the window's K/V (and int8
//   scales) into the pool, from the producer warp's idle lanes while the
//   ring runs. Slots at positions >= old are excluded by selects: a bulk
//   copy of the last page may read them mid-write, exactly as the loads of
//   the PAGE body may.
//
// PAGE body (the first design): one block of 128 threads handles one (row,
// KV head, tile of NC query columns) and keeps every byte of a page read
// exactly once per block and coalesced: a half-warp covers one 256-byte key row (16 lanes
// x 16 bytes; 8 bytes for int8), the block's 8 half-warps cover 8 keys at a
// time, and each lane issues the loads of 8 keys before using them. Per
// page the block runs three phases separated by barriers: (A) scores into
// shared memory, (B) the page's softmax update per column (one warp per
// column), (C) P @ V into per-half-warp f32 accumulators, merged once
// through shared memory at the end. The per-page structure repeats the TPU
// kernel's online softmax page by page, so the kernel and its plain version
// round p against the same running maxima. For chunk windows (kc = 128
// columns) the columns are tiled NC = 8 per block with plain FMA; the pages
// of a row are then re-read once per column tile (mostly from L2).
//
// FUSED saves the separate append launches and reads no page that only the
// window would have opened; its writes are a window's worth of rows, small
// next to the page reads.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "sm90.cuh"

namespace cg = cooperative_groups;

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
  // The PAGE body takes int8 and fused calls at C > 16 only: 8 columns a
  // block, the one instantiation they need.
  if constexpr (!Q8 && !FUSED) {
    if (nc == 1) PAGED_ATTN_LAUNCH(1);
    if (nc == 2) PAGED_ATTN_LAUNCH(2);
    if (nc == 4) PAGED_ATTN_LAUNCH(4);
  }
  PAGED_ATTN_LAUNCH(8);
#undef PAGED_ATTN_LAUNCH
}

// ---------------------------------------------------------------------------
// SPLIT body: K4 and K7 at C <= 16 (see the note at the top)
// ---------------------------------------------------------------------------

namespace split {

constexpr int MAX_SPLIT = 8;
constexpr int PIDS = 128;  // page ids of a row read into shared memory at the start
constexpr unsigned FULL = 0xffffffffu;

// The ring of one pool type: a stage holds TILE keys (a page, or a run of
// TILE keys of a longer page) of K, of V and (int8) of both scales, 16 KB
// of K and V either way; 4 stages, ~66 KB, so 3 blocks fit an SM's shared
// memory.
template <bool Q8>
struct Ring {
  using Elem = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  static constexpr int ESZ = Q8 ? 1 : 2;
  static constexpr int TILE = 64 / ESZ;       // keys of a stage
  static constexpr int GROUPS = TILE / 8;     // 8-key groups of a stage
  static constexpr int KV = TILE * HD * ESZ;  // bytes of K (or V) in a stage
  static constexpr int STAGE = 2 * KV + (Q8 ? 2 * TILE * 4 : 0);
  static constexpr int STAGES = 4;
  static constexpr int SMEM = STAGES * STAGE;
};

// The warps and lanes of a block serving NC query columns (C <= NC). A
// chunk is KC keys x NC columns = V (key, column) pairs; after the
// reduce-scatter lane l holds pair l >> SH (1 << SH lanes hold each).
template <int NC>
struct Lay {
  static constexpr int WARPS = NC <= 4 ? 8 : 4;  // consumer warps
  static constexpr int KC = NC <= 4 ? 8 : 32 / NC;
  static constexpr int V = KC * NC;
  static constexpr int LOGV = V == 8 ? 3 : (V == 16 ? 4 : 5);
  static constexpr int SH = 5 - LOGV;
  static constexpr int LOGNC = NC == 1 ? 0 : (NC == 2 ? 1 : (NC == 4 ? 2 : (NC == 8 ? 3 : 4)));
  static constexpr int NTHREADS = 32 * (WARPS + 1);  // + the producer warp
  static constexpr int MIN_BLOCKS = NC == 1 ? 3 : (NC <= 8 ? 2 : 1);
};

// An L2 policy that evicts first what it marks: a page is read once a step.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// One 1-D bulk copy global -> this block's shared memory, counted in bytes
// on the mbarrier `bar` (both shared-memory addresses), under the L2
// policy `pol`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(pol)
      : "memory");
}

// This lane's 4 dims of one K/V row as f32. bf16: a shift or a mask. int8:
// the word XORed to bytes b + 128, each byte permuted under the exponent of
// 2^23 (0x4B0000XX = 2^23 + b + 128), then one FADD of -(2^23 + 128):
// exact, and no I2F.
__device__ __forceinline__ void dims4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(w.x << 16);
  x[1] = __uint_as_float(w.x & 0xffff0000u);
  x[2] = __uint_as_float(w.y << 16);
  x[3] = __uint_as_float(w.y & 0xffff0000u);
}

__device__ __forceinline__ void dims4(const int8_t* p, float (&x)[4]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + i)) - 8388736.f;
}

// One stage of the reduce-scatter over the first N of the V values, at
// xor mask M: a lane keeps the half its lane bit selects, added to its
// partner's. (Recursion, not a loop over two induction variables: ptxas
// then keeps the values in registers.)
template <int N, int M, int V>
__device__ __forceinline__ void scatter_stage(float (&v)[V], int lane) {
  if constexpr (N > 1) {
    const bool hi = (lane & M) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = hi ? v[i] : v[i + N / 2];
      const float keep = hi ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, M);
    }
    scatter_stage<N / 2, M / 2, V>(v, lane);
  }
}

// Sums the lanes' V partial values per index: after log2(V) stages (xor
// masks 16, 8, ...) lane l holds index l >> (5 - log2 V) summed over
// 32 >> (5 - log2 V) lanes; the remaining masks add whole. V - 1 + (5 -
// log2 V) shuffles for V sums.
template <int V, int LOGV>
__device__ __forceinline__ float reduce_scatter(float (&v)[V], int lane) {
  scatter_stage<V, 16, V>(v, lane);
#pragma unroll
  for (int m = 16 >> LOGV; m > 0; m >>= 1) v[0] += __shfl_xor_sync(FULL, v[0], m);
  return v[0];
}

// One chunk of KC keys through this warp's online softmax. kb/vb point at
// this lane's 4 dims of the chunk's key 0, rs elements per key; ksb/vsb at
// key 0's scales, ss apart (int8). Keys from nvalid on do not exist (TAIL:
// the window's end; never read). Key i is token tok0 + i; this lane's
// column sees it when tok0 + i <= lim; keys past lim_max (no column sees
// them: stale or mid-write slots) have their V rows skipped and their p
// selected to 0, never multiplied by 0. pbuf/abuf: this warp's exchange of
// p (32 floats) and of the columns' rescale factors (NC floats).
template <int NC, bool Q8, bool TAIL>
__device__ __forceinline__ void chunk(const typename Ring<Q8>::Elem* kb,
                                      const typename Ring<Q8>::Elem* vb, long long rs,
                                      const float* ksb, const float* vsb, long long ss,
                                      int nvalid, int tok0, int lim, int lim_max,
                                      const float (&q)[NC][4], float (&acc)[NC][4], float& m,
                                      float& l, float* pbuf, float* abuf, float scale,
                                      int lane) {
  using L = Lay<NC>;
  constexpr int KC = L::KC, V = L::V;
  float part[V];
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (!TAIL || i < nvalid) dims4(kb + i * rs, x);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float s = q[c][0] * x[0];
      s = fmaf(q[c][1], x[1], s);
      s = fmaf(q[c][2], x[2], s);
      part[i * NC + c] = fmaf(q[c][3], x[3], s);
    }
  }
  const float dot = reduce_scatter<V, L::LOGV>(part, lane);
  const int vi = lane >> L::SH, key = vi >> L::LOGNC;
  const bool exists = !TAIL || key < nvalid;
  const bool seen = exists && tok0 + key <= lim;
  float s = dot * scale;
  if (Q8 && exists) s *= ksb[key * ss];
  s = seen ? s : NEG_INF;
  float mx = s;
#pragma unroll
  for (int msk = 16; msk >= (1 << (L::SH + L::LOGNC)); msk >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, msk));
  const float m_new = fmaxf(m, mx);
  const float alpha = __expf(m - m_new);
  const float p = seen ? __expf(s - m_new) : 0.f;
  l = alpha * l + p;
  m = m_new;
  float pv = p;
  if (Q8) pv = seen ? p * vsb[key * ss] : 0.f;
  pv = __bfloat162float(__float2bfloat16(pv));
  if ((lane & ((1 << L::SH) - 1)) == 0) {
    pbuf[vi] = pv;
    if (key == 0) abuf[vi] = alpha;  // vi is the column when key == 0
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float a = abuf[c];
#pragma unroll
    for (int d = 0; d < 4; ++d) acc[c][d] *= a;
  }
  // Keys whose V rows count: those that exist, up to lim_max.
  const int npv = min(TAIL ? nvalid : KC, lim_max - tok0 + 1);
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    if (i < npv) {
      float x[4];
      dims4(vb + i * rs, x);
      float pc[NC];
      if constexpr (NC >= 4) {
#pragma unroll
        for (int c = 0; c < NC; c += 4) {
          const float4 t = *reinterpret_cast<const float4*>(pbuf + i * NC + c);
          pc[c] = t.x;
          pc[c + 1] = t.y;
          pc[c + 2] = t.z;
          pc[c + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) pc[c] = pbuf[i * NC + c];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int d = 0; d < 4; ++d) acc[c][d] = fmaf(pc[c], x[d], acc[c][d]);
    }
  }
  __syncwarp();
}

// Grid (S, KH, B), clusters of (S, 1, 1): block rank r of the cluster of
// (row b, KV head kh) takes its run of the row's live pages; one column
// tile (C <= NC <= 16). Arguments as paged_attn_kernel's.
template <int NC, bool Q8, bool FUSED>
__global__ void __launch_bounds__(Lay<NC>::NTHREADS, Lay<NC>::MIN_BLOCKS)
    paged_attn_split(const __nv_bfloat16* __restrict__ q,
                     const typename Ring<Q8>::Elem* __restrict__ kp,
                     const typename Ring<Q8>::Elem* __restrict__ vp,
                     const float* __restrict__ ks, const float* __restrict__ vs,
                     const int* __restrict__ table, const int* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ out,
                     const typename Ring<Q8>::Elem* __restrict__ nk,
                     const typename Ring<Q8>::Elem* __restrict__ nv,
                     const float* __restrict__ nks, const float* __restrict__ nvs,
                     const int* __restrict__ positions, const int* __restrict__ active,
                     int window, int H, int KH, int n_pages, int page, int P_max,
                     long long sqb, long long sqk, long long sqh, float scale) {
  using L = Lay<NC>;
  using P = Ring<Q8>;
  using E = typename P::Elem;
  constexpr int W = L::WARPS, R = P::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];  // the ring; then the merge
  __shared__ __align__(8) uint64_t bars[2 * R];           // full[R], empty[R]
  __shared__ float wm[W][NC], wl[W][NC];                  // each warp's m and l
  __shared__ float bm[NC], bl[NC];                        // the block's
  __shared__ __align__(16) float pbufs[W][32];
  __shared__ float abufs[W][NC];
  __shared__ int pids[PIDS];  // the row's first page ids

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const bool alone = S == 1;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = H / KH, C = group * window;
  // The row's first page ids, read while its length is: the producer then
  // waits for no global load between tiles.
  for (int j = tid; j < min(P_max, PIDS); j += L::NTHREADS)
    pids[j] = table[(long long)b * P_max + j];
  const int length = lengths[b];
  const bool act = FUSED ? active[b] != 0 : true;
  // Pool tokens read: the row's (K4), or those before the window (K7).
  const int old = FUSED ? length - (act ? window : 0) : length;
  const int lim_max = old - 1;  // the last pool token any column sees
  int n_live = old > 0 ? (old + page - 1) / page : 0;
  if (n_live > P_max) n_live = P_max;
  const int p0 = static_cast<int>((long long)rank * n_live / S);
  const int p1 = static_cast<int>((long long)(rank + 1) * n_live / S);
  // The run's tiles: every tile of its pages but the last page's tiles
  // past lim_max.
  constexpr int TILE = P::TILE;
  const int tpp = (page + TILE - 1) / TILE;
  int n_tiles = 0;
  if (p1 > p0) {
    const int last = min(page, lim_max + 1 - (p1 - 1) * page);
    n_tiles = (p1 - p0 - 1) * tpp + (last + TILE - 1) / TILE;
  }

  const uint32_t bar0 = static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (tid == 0) {
    for (int s = 0; s < R; ++s) {
      sm90::mbar_init(bar0 + 8 * s, 1);      // the producer's expect_tx
      sm90::mbar_init(bar0 + 8 * (R + s), W);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float* wacc = reinterpret_cast<float*>(smem);  // [W][NC][HD] over the ring, at the end
  if (warp == W) {
    if (lane == 0) {
      // The producer: one thread keeps the ring full.
      const uint64_t pol = evict_first();
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % R;
        if (it >= R) sm90::mbar_wait(bar0 + 8 * (R + s), ((it / R) - 1) & 1);
        const int j = p0 + it / tpp, sub = it % tpp;
        int pg = j < PIDS ? pids[j] : table[(long long)b * P_max + j];
        pg = pg < 0 ? 0 : (pg >= n_pages ? n_pages - 1 : pg);
        const long long row = ((long long)pg * KH + kh) * page + sub * TILE;  // key 0's row
        const int n = min(TILE, page - sub * TILE);
        const uint32_t kv = static_cast<uint32_t>(n * HD * P::ESZ);
        const uint32_t st = ring + s * P::STAGE, full = bar0 + 8 * s;
        sm90::mbar_expect_tx(full, 2 * kv + (Q8 ? 8 * n : 0));
        bulk_load(st, kp + row * HD, kv, full, pol);
        bulk_load(st + P::KV, vp + row * HD, kv, full, pol);
        if (Q8) {
          bulk_load(st + 2 * P::KV, ks + row, 4 * n, full, pol);
          bulk_load(st + 2 * P::KV + 4 * TILE, vs + row, 4 * n, full, pol);
        }
      }
    } else if (FUSED && rank == 0) {
      // The writer, the producer warp's other lanes of rank 0, while the
      // ring runs: the window into the pool, through the pointers it is
      // read by, at slots positions[b] + t of the row's pages (past the
      // table: page 0, as the port's token writer); an inactive row writes
      // the scratch page n_pages - 1. No rank reads these slots as keys
      // (they are at positions >= old).
      E* kw = const_cast<E*>(kp);
      E* vw = const_cast<E*>(vp);
      constexpr int VECS = HD * P::ESZ / 16;  // 16-byte pieces of a row
      for (int idx = lane - 1; idx < window * VECS; idx += 31) {
        const int t = idx / VECS, v16 = idx % VECS;
        const int pos = positions[b] + t;
        int pg = n_pages - 1;
        if (act) {
          const int pi = pos / page;
          pg = (pi < 0 || pi >= P_max) ? 0 : table[(long long)b * P_max + pi];
          pg = pg < 0 ? 0 : (pg >= n_pages ? n_pages - 1 : pg);
        }
        int off = pos % page;
        if (off < 0) off += page;
        const long long dst = ((long long)pg * KH + kh) * page + off;
        const long long src = ((long long)b * window + t) * KH + kh;
        reinterpret_cast<uint4*>(kw + dst * HD)[v16] =
            reinterpret_cast<const uint4*>(nk + src * HD)[v16];
        reinterpret_cast<uint4*>(vw + dst * HD)[v16] =
            reinterpret_cast<const uint4*>(nv + src * HD)[v16];
        if (Q8 && v16 == 0) {
          const_cast<float*>(ks)[dst] = nks[src];
          const_cast<float*>(vs)[dst] = nvs[src];
        }
      }
    }
  } else {
    // This lane's 4 dims of each column's query; columns past C stay zero.
    float qv[NC][4];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < C) {
        const int g = c / window, t = c % window;
        dims4(q + b * sqb + t * sqk + (kh * group + g) * sqh + 4 * lane, qv[c]);
      } else {
#pragma unroll
        for (int d = 0; d < 4; ++d) qv[c][d] = 0.f;
      }
    }
    // This lane's column (fixed: every chunk maps lane l to pair l >> SH).
    const int col = (lane >> L::SH) & (NC - 1);
    const int lim = col >= C ? -1 : FUSED ? old - 1 : (length - window) + col % window;
    float acc[NC][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int d = 0; d < 4; ++d) acc[c][d] = 0.f;
    float m = NEG_INF, l = 0.f;
    float* pbuf = pbufs[warp];
    float* abuf = abufs[warp];

    if (FUSED && rank == S - 1) {
      // The window's own keys, from the operands, while the first tiles
      // load: token t of (b, kh) at nk[((b * window + t) * KH + kh) * HD],
      // causal within the window; none for an inactive row.
      const int limw = (col < C && act) ? col % window : -1;
      const int wmax = act ? window - 1 : -1;
      const long long w0 = (long long)b * window * KH + kh;  // token 0's row
      const long long rs = (long long)KH * HD;
      for (int g = 8 * warp; g <= wmax; g += 8 * W) {
#pragma unroll
        for (int h = 0; h < 8; h += L::KC) {
          const int i = g + h;
          if (i > wmax) break;
          chunk<NC, Q8, true>(nk + (w0 + (long long)i * KH) * HD + 4 * lane,
                              nv + (w0 + (long long)i * KH) * HD + 4 * lane, rs,
                              Q8 ? nks + w0 + (long long)i * KH : nullptr,
                              Q8 ? nvs + w0 + (long long)i * KH : nullptr, KH, window - i, i,
                              limw, wmax, qv, acc, m, l, pbuf, abuf, scale, lane);
        }
      }
    }

    // The tiles' 8-key groups go to the warps in turn across tiles.
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % R;
      sm90::mbar_wait(bar0 + 8 * s, (it / R) & 1);
      const int j = p0 + it / tpp, sub = it % tpp;
      const int tok = j * page + sub * TILE;  // token of the tile's key 0
      const int n = min(TILE, page - sub * TILE);
      const unsigned char* st = smem + s * P::STAGE;
      const E* kt = reinterpret_cast<const E*>(st) + 4 * lane;
      const E* vt = reinterpret_cast<const E*>(st + P::KV) + 4 * lane;
      const float* kst = reinterpret_cast<const float*>(st + 2 * P::KV);
      const float* vst = kst + TILE;
      const int g0 = (warp + W - (it * P::GROUPS) % W) % W;  // this warp's first group
      for (int g = 8 * g0; g < n && tok + g <= lim_max; g += 8 * W) {
#pragma unroll
        for (int h = 0; h < 8; h += L::KC) {
          const int i = g + h;
          chunk<NC, Q8, false>(kt + i * HD, vt + i * HD, HD, kst + i, vst + i, 1, L::KC,
                               tok + i, lim, lim_max, qv, acc, m, l, pbuf, abuf, scale, lane);
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(bar0 + 8 * (R + s));
    }

    // The warp's l: the sum over the lanes of its column.
#pragma unroll
    for (int msk = 16; msk >= (1 << (L::SH + L::LOGNC)); msk >>= 1)
      l += __shfl_xor_sync(FULL, l, msk);
    // Every consumer is past the ring before its bytes are reused.
    sm90::named_barrier(1, 32 * W);
    if ((lane >> L::SH) < NC && (lane & ((1 << L::SH) - 1)) == 0) {
      wm[warp][col] = m;
      wl[warp][col] = l;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(wacc + (warp * NC + c) * HD + 4 * lane) =
          make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
    sm90::named_barrier(1, 32 * W);
    // The block's partial, in warp order, into warp 0's slot; a warp that
    // saw no key is skipped. A cluster of one block writes it as the
    // output (what the merge below would give, bit for bit) and is done.
    for (int e = tid; e < NC * HD; e += 32 * W) {
      const int c = e / HD;
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < W; ++w) M = fmaxf(M, wm[w][c]);
      float ls = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (wm[w][c] != NEG_INF) {
          const float f = expf(wm[w][c] - M);
          ls += f * wl[w][c];
          a += f * wacc[w * NC * HD + e];
        }
      }
      if (alone) {
        if (e < C * HD) {
          const int g = c / window, t = c % window;
          out[(((long long)b * window + t) * H + kh * group + g) * HD + e % HD] =
              __float2bfloat16(a / (ls == 0.f ? 1.f : ls));
        }
      } else {
        wacc[e] = a;
        if (e % HD == 0) {
          bm[c] = M;
          bl[c] = ls;
        }
      }
    }
  }
  if (alone) return;

  // Every rank's partial is in its shared memory; each rank merges its
  // share of the outputs from all of them, in rank order, skipping a rank
  // that saw no key.
  cluster.sync();
  const int n_el = C * HD;
  const int share = (n_el + S - 1) / S;
  const int e_end = min(n_el, (rank + 1) * share);
  for (int e = rank * share + tid; e < e_end; e += L::NTHREADS) {
    const int c = e / HD;
    float mr[MAX_SPLIT], lr[MAX_SPLIT], ar[MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r < S) {
        mr[r] = *cluster.map_shared_rank(&bm[c], r);
        lr[r] = *cluster.map_shared_rank(&bl[c], r);
        ar[r] = *cluster.map_shared_rank(wacc + e, r);
      }
    }
    float M = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < S) M = fmaxf(M, mr[r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r < S && mr[r] != NEG_INF) {
        const float f = expf(mr[r] - M);
        num += f * ar[r];
        den += f * lr[r];
      }
    }
    const int g = c / window, t = c % window;
    out[(((long long)b * window + t) * H + kh * group + g) * HD + e % HD] =
        __float2bfloat16(num / (den == 0.f ? 1.f : den));
  }

  // Keeps every rank's shared memory until the cluster has read it.
  cluster.sync();
}

// Opts the kernel into its dynamic shared memory once per device.
template <int NC, bool Q8, bool FUSED>
cudaError_t prepare() {
  static std::atomic<bool> done[sm90::kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= sm90::kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(paged_attn_split<NC, Q8, FUSED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<Q8>::SMEM);
    if (e != cudaSuccess) return e;
    done[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

template <int NC, bool Q8, bool FUSED>
cudaLaunchConfig_t config(int split, int KH, int B, cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, KH, B);
  cfg.blockDim = dim3(Lay<NC>::NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = Ring<Q8>::SMEM;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int NC, bool Q8, bool FUSED>
cudaError_t launch(const void* q, const void* kp, const void* vp, const float* ks,
                   const float* vs, const int* table, const int* lengths, void* out,
                   const void* nk, const void* nv, const float* nks, const float* nvs,
                   const int* positions, const int* active, int B, int window, int H, int KH,
                   int n_pages, int page, int P_max, long long sqb, long long sqk,
                   long long sqh, float scale, int split, cudaStream_t st) {
  using E = typename Ring<Q8>::Elem;
  cudaError_t e = prepare<NC, Q8, FUSED>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<NC, Q8, FUSED>(split, KH, B, st, attr);
  e = cudaLaunchKernelEx(&cfg, paged_attn_split<NC, Q8, FUSED>,
                         static_cast<const __nv_bfloat16*>(q), static_cast<const E*>(kp),
                         static_cast<const E*>(vp), ks, vs, table, lengths,
                         static_cast<__nv_bfloat16*>(out), static_cast<const E*>(nk),
                         static_cast<const E*>(nv), nks, nvs, positions, active, window, H, KH,
                         n_pages, page, P_max, sqb, sqk, sqh, scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The blocks one wave holds with clusters of 1 .. MAX_SPLIT blocks.
template <int NC, bool Q8, bool FUSED>
cudaError_t capacity(int* blocks) {
  cudaError_t e = prepare<NC, Q8, FUSED>();
  for (int c = 1; c <= MAX_SPLIT && e == cudaSuccess; ++c) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config<NC, Q8, FUSED>(c, 32, 8, nullptr, attr);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, paged_attn_split<NC, Q8, FUSED>, &cfg);
    blocks[c - 1] = clusters * c;
  }
  return e;
}

// The instantiation of a call: Q8 or FUSED (never both off), NC from C.
template <bool Q8, bool FUSED, typename F>
cudaError_t with_nc(int C, F&& f) {
  if (C <= 1) return f(std::integral_constant<int, 1>{});
  if (C <= 2) return f(std::integral_constant<int, 2>{});
  if (C <= 4) return f(std::integral_constant<int, 4>{});
  if (C <= 8) return f(std::integral_constant<int, 8>{});
  return f(std::integral_constant<int, 16>{});
}

}  // namespace split

// The calls the SPLIT body is built for: int8 or fused, C = group * window
// <= 16.
bool split_built(int quant, int fused, int C) { return (quant || fused) && C <= 16; }

}  // namespace

// Plain C entry point for ctypes. q is bf16 [B, window, H, 128] with the given
// element strides (head dim contiguous, strides multiples of 8, data 16-byte
// aligned); kp/vp point at ONE layer's pool [n_pages, KH, page, 128]
// (contiguous, 16-byte aligned; bf16, or int8 when quant != 0, with ks/vs
// f32 [n_pages, KH, page], 16-byte aligned); table int32 [B, P_max]; lengths
// int32 [B] (tokens including the window; with fused, for active rows only);
// out bf16 [B, window, H, 128] contiguous. With fused != 0: nk/nv [B,
// window, KH, 128] in the pool's type (contiguous, 16-byte aligned),
// nks/nvs f32 [B, window, KH] (int8), positions int32 [B] (window token 0's
// slot), active int32 [B]; the kernel writes them into the pool (null
// otherwise). page must be a multiple of 8 and at most 256 (checked by the
// Python wrapper). split: 0 runs the PAGE body; 1..8 runs the SPLIT body
// with clusters of that many blocks splitting a row's pages (only for
// quant or fused calls with C = (H / KH) * window <= 16). The wrapper
// routes (ops/paged_attention.py::split_of). Returns the CUDA error code
// of the launch.
extern "C" int paged_attn(const void* q, const void* kp, const void* vp,
                          const float* ks, const float* vs, const int* table,
                          const int* lengths, void* out, const void* nk,
                          const void* nv, const float* nks, const float* nvs,
                          const int* positions, const int* active, int B,
                          int window, int H, int KH, int n_pages, int page,
                          int P_max, long long sqb, long long sqk,
                          long long sqh, float scale, int quant, int fused,
                          int split, void* stream) {
  const int C = (H / KH) * window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split != 0) {
    if (!split_built(quant, fused, C) || split < 1 || split > split::MAX_SPLIT)
      return static_cast<int>(cudaErrorInvalidValue);
#define PAGED_ATTN_SPLIT(Q, F)                                                            \
  split::with_nc<Q, F>(C, [&](auto nc) {                                                  \
    return split::launch<decltype(nc)::value, Q, F>(                                      \
        q, kp, vp, ks, vs, table, lengths, out, nk, nv, nks, nvs, positions, active, B,   \
        window, H, KH, n_pages, page, P_max, sqb, sqk, sqh, scale, split, st);            \
  })
    const cudaError_t err = quant ? (fused ? PAGED_ATTN_SPLIT(true, true)
                                           : PAGED_ATTN_SPLIT(true, false))
                                  : PAGED_ATTN_SPLIT(false, true);
#undef PAGED_ATTN_SPLIT
    return static_cast<int>(err);
  }
  const int nc = C <= 1 ? 1 : (C <= 2 ? 2 : (C <= 4 ? 4 : 8));
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

// The blocks one wave of the SPLIT body holds, for the instantiation of a
// call with these quant, fused and C = (H / KH) * window, with clusters of
// 1 .. 8 blocks (blocks[c - 1]), from the occupancy of its launch
// configuration on the current device. Returns the CUDA error code
// (cudaErrorInvalidValue for a call the SPLIT body is not built for).
extern "C" int paged_attn_capacity(int quant, int fused, int C, int* blocks) {
  if (!split_built(quant, fused, C)) return static_cast<int>(cudaErrorInvalidValue);
#define PAGED_ATTN_CAPACITY(Q, F) \
  split::with_nc<Q, F>(C, [&](auto nc) { return split::capacity<decltype(nc)::value, Q, F>(blocks); })
  const cudaError_t err = quant ? (fused ? PAGED_ATTN_CAPACITY(true, true)
                                         : PAGED_ATTN_CAPACITY(true, false))
                                : PAGED_ATTN_CAPACITY(false, true);
#undef PAGED_ATTN_CAPACITY
  return static_cast<int>(err);
}
