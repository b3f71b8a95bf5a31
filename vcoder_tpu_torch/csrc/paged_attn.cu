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
// an inactive row). One block per (row, KV head) then writes the window's
// K/V (int8: and their scales) into pool slots positions[b] + t through the
// page table (past the table: page 0, as the port's token writer); an
// inactive row writes the scratch page n_pages - 1. The other blocks may be
// reading the last page while it is written: the slots at positions >= old
// hold stale or in-flight bytes, so they are excluded by selects (scores,
// probabilities, V-scales and V rows of keys no column sees), never by
// multiplying by 0 (:1334-1342's invariant, a real race on this card).
//
// Two bodies compute this function. The wrapper (ops/paged_attention.py::
// split_of, the one place that routes) sends every call with C = group *
// window <= 16 (decode and verify: K3, K4, K7, K8) to the SPLIT body and
// every call with C > 16 (chunk windows, int8 or bf16; fused GQA windows
// past 16 columns) to the TILE body; the entry point's `body` argument says
// which, and the entry point only checks that the body it is given is built
// for the call.
//
// What bounds both on the card: HBM bytes. At decode (B=8, MHA, window 1,
// ~1.2k-token contexts in 64-token pages) one layer's launch reads ~164 MB
// of bf16 K+V pages (~82 MB int8 + scales) for ~0.3 GFLOP (~0.049 ms bf16,
// ~0.025 ms int8, at 3.35 TB/s). A chunk window of 128 columns over the
// same contexts does 128x the products on the same bytes (B=4: ~10 GFLOP,
// ~81 MB): 0.010 ms on the tensor cores against 0.024 ms of bytes, so it
// needs tensor cores to stay bytes-bound, and CUDA-core FMA does not.
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
//   order). Within the card's gates (max-abs 2e-2, each head's relative L2
//   8e-3; tests/test_torch_paged_split.py pins the gap).
// - FUSED: the window's own keys (from the operands, causal within the
//   window) run in the cluster's last rank only, before its tiles, while
//   the first tiles load; rank 0 alone writes the window's K/V (and int8
//   scales) into the pool, from the producer warp's idle lanes while the
//   ring runs. Slots at positions >= old are excluded by selects: a bulk
//   copy of the last page may read them mid-write.
//
// TILE body (flash attention over the window's columns, K/V tiles loaded
// from the page table by TMA, products on tensor cores):
// - One block per (row, KV head, tile of 128 of the C columns): with the
//   window a multiple of 128 that is one query head's 128 window tokens,
//   flash attention's (batch, head, q-tile); a shorter GQA window puts
//   several heads of one KV head into a tile, so each reads the pages once.
//   The tiles of a (row, KV head) are neighbours in the grid and share the
//   pages through L2. No cluster: a grid under one wave (the int8 chunk
//   at 2 rows, 64 blocks) leaves part of the card idle.
// - A producer warp (one thread) loads 64-key tiles into a ring through
//   4-D tensor maps over one layer's pool [n_pages, KH, page, 128] (encoded
//   per call on the host, passed by value, so a CUDA graph records them):
//   page ids and offsets are runtime coordinates, so no per-page map is
//   needed. A tile of 64 tokens is 64 / r boxes of r = gcd(page, 64) rows,
//   each inside one page at its offset (page ids clipped to the pool, read
//   from shared memory), each landing on whole 8-row atoms of the 128-byte
//   swizzle, all counted on the stage's mbarrier; boxes past the tokens any
//   column sees are not loaded. bf16: two 64-dim boxes a row; int8: one
//   128-byte box, and the tile's f32 scales by 1-D bulk copies of r x 4
//   bytes a box.
// - Two consumer warpgroups of 64 columns (a warpgroup with no column
//   does not run): q is loaded by plain 16-byte loads into a swizzled tile
//   (any column -> (head, token) map, any strides); S = Q K^T by wgmma
//   m64n64k16 from shared memory, O += P V by the register-A wgmma
//   m64n128k16 with V read MN-major; each warpgroup issues PV of tile j
//   with QK of tile j+1 and waits once (flash_fwd.cu's mainloop without
//   its ping-pong turns, which moved no case by more than 5% here).
// - Softmax per 64-key tile in f32, exp2 with log2(e) folded in; the
//   k-scale multiplies the score column, p is summed into l, multiplied by
//   the v-scale and rounded to bf16 against the tile's running maximum. At
//   64-token pages that is the plain version's order page for page (tests/
//   test_torch_paged_chunk.py pins it); at other page sizes p is rounded at
//   each 64-token tile instead of each page. A tile whose keys every row of
//   a warp sees skips the mask; the others select (never multiply by 0).
// - Rows of the last tile past the last token any column sees hold stale
//   or (FUSED) in-flight bytes, or bytes of pages not loaded: their scores
//   are masked by selects, and their V rows are written as zeros in shared
//   memory before P V reads them (P V cannot select), as are the V-scales'
//   products by the select on p.
// - int8: a converter warp trio (the producer warpgroup's other warps)
//   turns each int8 stage into the bf16 stage the consumers read: the PRMT
//   trick of the SPLIT body gives each value as an exact f32, whose top 16
//   bits are its bf16 (no I2F), written back in the swizzled layout; the
//   scales come along. Tensor cores need bf16 in shared memory (wgmma's B
//   operand); an extra ring (4 int8 stages, 3 bf16) costs shared memory,
//   not bandwidth.
// - FUSED: the window's keys are one more tile (or more, past 64 tokens)
//   after the pool's, from 4-D tensor maps over new_k/new_v (rows past the
//   window read as zeros), causal within the window, none for an inactive
//   row; the writer is the producer warp's other lanes in the block of
//   column tile 0 of each (row, KV head).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int HD = 128;  // head dim (the wrapper raises otherwise)
constexpr float NEG_INF = -1e30f;

// The entry point's `body` codes (ops/paged_attention.py: BODY_SPLIT, BODY_TILE).
constexpr int BODY_SPLIT = 1;
constexpr int BODY_TILE = 2;

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

// The fused window's writer: token t's K/V of (row b, KV head kh), from
// nk/nv [B, window, KH, 128] (int8: and their scales nks/nvs [B, window,
// KH]), into pool slot pos0 + t through the row's page table (past the
// table: page 0, as the port's token writer), through the pointers the
// pool is read by; an inactive row writes the scratch page n_pages - 1.
// Thread i of n takes the 16-byte pieces i, i + n, ... No block reads
// these slots as keys (they are at positions >= old).
template <typename E>
__device__ __forceinline__ void write_window(const E* kp, const E* vp, const float* ks,
                                             const float* vs, const E* nk, const E* nv,
                                             const float* nks, const float* nvs, const int* table,
                                             int pos0, bool act, int b, int kh, int window, int KH,
                                             int n_pages, int page, int P_max, int i, int n) {
  E* kw = const_cast<E*>(kp);
  E* vw = const_cast<E*>(vp);
  constexpr int VECS = HD * sizeof(E) / 16;  // 16-byte pieces of a row
  for (int idx = i; idx < window * VECS; idx += n) {
    const int t = idx / VECS, v16 = idx % VECS;
    const int pos = pos0 + t;
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
    reinterpret_cast<uint4*>(kw + dst * HD)[v16] = reinterpret_cast<const uint4*>(nk + src * HD)[v16];
    reinterpret_cast<uint4*>(vw + dst * HD)[v16] = reinterpret_cast<const uint4*>(nv + src * HD)[v16];
    if (sizeof(E) == 1 && v16 == 0) {
      const_cast<float*>(ks)[dst] = nks[src];
      const_cast<float*>(vs)[dst] = nvs[src];
    }
  }
}

// ---------------------------------------------------------------------------
// SPLIT body: every call with C <= 16 (see the note at the top)
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
// tile (C <= NC <= 16). Arguments as the entry point's.
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
      // ring runs.
      write_window(kp, vp, ks, vs, nk, nv, nks, nvs, table, positions[b], act, b, kh, window, KH,
                   n_pages, page, P_max, lane - 1, 31);
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

// The instantiation's column count NC for a call of C <= 16 columns.
template <typename F>
cudaError_t with_nc(int C, F&& f) {
  if (C <= 1) return f(std::integral_constant<int, 1>{});
  if (C <= 2) return f(std::integral_constant<int, 2>{});
  if (C <= 4) return f(std::integral_constant<int, 4>{});
  if (C <= 8) return f(std::integral_constant<int, 8>{});
  return f(std::integral_constant<int, 16>{});
}

}  // namespace split

// The calls the SPLIT body is built for: C = group * window <= 16 (its
// NC instantiations).
bool split_built(int C) { return C >= 1 && C <= 16; }


// ---------------------------------------------------------------------------
// TILE body: every call with C > 16 (see the note at the top)
// ---------------------------------------------------------------------------

namespace tile {

using namespace sm90;

constexpr int BQ = 128;            // query columns of a block: two consumer warpgroups x 64
constexpr int BK = 64;             // keys of a K/V tile
constexpr int NTHREADS = 3 * 128;  // two consumer warpgroups + the producer warpgroup
constexpr int NCVT = 96;           // int8: the converter warps' threads
constexpr int PIDS = 256;          // page ids of a row read into shared memory at the start
constexpr float LOG2E = 1.4426950408889634f;
constexpr int Q_BARRIER = 1;       // named barriers 1, 2: a warpgroup's Q is written
constexpr int V_BARRIER = 3;       // named barriers 3, 4: a warpgroup's zeroed V rows are written

// Shared memory of one block, 1 KB aligned. Every bf16 box is 64 dims (128
// bytes a row), 128-byte swizzled: Q as two boxes of BQ rows; a stage of the
// ring the consumers read as K then V, each two boxes of BK keys. int8: a raw
// ring of stages of one 128-byte box of K and one of V (BK keys each), and
// the f32 scales of both rings (k then v, BK each). Then the row's page ids
// and the mbarriers (full, empty of the ring; int8: raw full, raw empty).
template <bool Q8>
struct Smem {
  static constexpr int Q_BOX = BQ * 128;
  static constexpr int KV_BOX = BK * 128;
  static constexpr int K_BYTES = 2 * KV_BOX;
  static constexpr int STAGE = 2 * K_BYTES;
  static constexpr int STAGES = Q8 ? 3 : 4;
  static constexpr int RAW = 2 * KV_BOX;
  static constexpr int RAW_STAGES = Q8 ? 4 : 0;
  static constexpr int RING = 2 * Q_BOX;
  static constexpr int RAW_RING = RING + STAGES * STAGE;
  static constexpr int SCALES = RAW_RING + RAW_STAGES * RAW;  // ring's, then the raw ring's
  static constexpr int PID = SCALES + (Q8 ? (STAGES + RAW_STAGES) * 2 * BK * 4 : 0);
  static constexpr int BARS = PID + PIDS * 4;
  static constexpr int BYTES = 1024 + BARS + 8 * (2 * STAGES + 2 * RAW_STAGES);
};

// Bytes 2i and 2i + 1 of the XORed word u (int8 values + 128) as a bf16
// pair: each an exact f32 by the PRMT trick, whose top 16 bits are its bf16
// (an integer of at most 8 significant bits).
__device__ __forceinline__ uint32_t bf16x2_of(uint32_t u, int i) {
  const float a = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + 2 * i)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441 + 2 * i)) - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// S = Q K^T for one key tile (overwriting s): both operands K-major in
// shared memory; 16 of the 128 dims are 32 bytes along a box's rows.
template <bool Q8>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t qa, uint32_t kst) {
  using L = Smem<Q8>;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n64k16_ss(s, smem_desc(qa + (kk / 4) * L::Q_BOX + (kk % 4) * 32, 16, 1024),
                       smem_desc(kst + (kk / 4) * L::KV_BOX + (kk % 4) * 32, 16, 1024), kk > 0);
}

// O += P V for one key tile: P from registers, V [keys, 128] MN-major (16
// keys are 16 rows of 128 bytes; its 64-dim boxes KV_BOX bytes apart).
template <bool Q8>
__device__ __forceinline__ void issue_pv(float (&acc)[64], const uint32_t (&p)[BK / 16][4],
                                         uint32_t vst) {
  using L = Smem<Q8>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_m64n128k16_rs(acc, p[kk], smem_desc(vst + kk * 2048, L::KV_BOX, 1024));
}

// One key tile of the online softmax (f32, exp in base 2): the score scale
// (and the k-scale of the key), the mask where the tile needs one
// (MASKED), the running max, the rescaled sums and output, p summed before
// the v-scale, then multiplied by it and packed to bf16 as the A fragment
// of P V. Accumulator element 4c + e of a thread is row g + 8 (e / 2), key
// 8c + 2t + e % 2 of the tile, which is token base + key; row i sees it
// when base + key <= lim[i]. sc: the tile's k-scales, then its v-scales
// (int8).
template <bool Q8, bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&acc)[64],
                                             uint32_t (&p)[BK / 16][4], float (&m_run)[2],
                                             float (&l_run)[2], const float* sc, int base,
                                             const int (&lim)[2], float scale, int t) {
  auto seen = [&](int c, int e) {
    return !MASKED || base + 8 * c + 2 * t + (e & 1) <= lim[e >> 1];
  };
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int c = 0; c < BK / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * c + e] * scale;
      if (Q8) x *= sc[8 * c + 2 * t + (e & 1)];
      if (MASKED) x = seen(c, e) ? x : NEG_INF;
      s[4 * c + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2], mb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_run[i], mx[i]);
    alpha[i] = exp2f((m_run[i] - m_new) * LOG2E);
    m_run[i] = m_new;
    mb[i] = m_new * LOG2E;
    l_run[i] *= alpha[i];
  }
#pragma unroll
  for (int c = 0; c < BK / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = exp2f(fmaf(s[4 * c + e], LOG2E, -mb[e >> 1]));
      if (MASKED) x = seen(c, e) ? x : 0.f;
      l_run[e >> 1] += x;
      if (Q8) {
        x *= sc[BK + 8 * c + 2 * t + (e & 1)];
        if (MASKED) x = seen(c, e) ? x : 0.f;
      }
      s[4 * c + e] = x;
    }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    acc[4 * c + 0] *= alpha[0];
    acc[4 * c + 1] *= alpha[0];
    acc[4 * c + 2] *= alpha[1];
    acc[4 * c + 3] *= alpha[1];
  }
}

// Grid (column tiles, KH, B). tmK/tmV: one layer's pool [n_pages, KH, page,
// 128] in boxes of (64 bf16 | 128 int8) dims x box_rows keys; tmNK/tmNV
// (FUSED): new_k/new_v [B, window, KH, 128] in boxes of BK tokens. Other
// arguments as the entry point's.
template <bool Q8, bool FUSED>
__global__ void __launch_bounds__(NTHREADS, 1)
    paged_attn_tile(const __grid_constant__ CUtensorMap tmK, const __grid_constant__ CUtensorMap tmV,
                    const __grid_constant__ CUtensorMap tmNK,
                    const __grid_constant__ CUtensorMap tmNV, const __nv_bfloat16* __restrict__ q,
                    const typename split::Ring<Q8>::Elem* kp,
                    const typename split::Ring<Q8>::Elem* vp, const float* ks, const float* vs,
                    const int* __restrict__ table, const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out,
                    const typename split::Ring<Q8>::Elem* __restrict__ nk,
                    const typename split::Ring<Q8>::Elem* __restrict__ nv,
                    const float* __restrict__ nks, const float* __restrict__ nvs,
                    const int* __restrict__ positions, const int* __restrict__ active,
                    int window, int H, int KH, int n_pages, int page, int P_max, int box_rows,
                    long long sqb, long long sqk, long long sqh, float scale) {
  using L = Smem<Q8>;
  constexpr int R = L::STAGES, RR = L::RAW_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw_addr);  // the same bytes, generic address
  int* const pids = reinterpret_cast<int*>(gbase + L::PID);
  const uint32_t bars = base + L::BARS;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (R + s); };
  auto raw_full = [&](int s) { return bars + 8u * (2 * R + s); };
  auto raw_empty = [&](int s) { return bars + 8u * (2 * R + RR + s); };

  const int tid = threadIdx.x;
  const int ct = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int group = H / KH, C = group * window;
  const int c0 = ct * BQ, c1 = min(C, c0 + BQ);
  const int nwg = c1 - c0 > 64 ? 2 : 1;  // consumer warpgroups with a column

  const int length = lengths[b];
  const bool act = FUSED ? active[b] != 0 : true;
  // Pool tokens read: the row's, or (FUSED) those before the window.
  const int old = FUSED ? length - (act ? window : 0) : length;
  // The largest window token t = c % window among the block's columns.
  const int tmax = (c1 - c0 >= window || c0 % window > (c1 - 1) % window) ? window - 1
                                                                           : (c1 - 1) % window;
  // Pool tokens some column of the block sees: [0, pool_end); then (FUSED,
  // active rows) the window's tokens up to tmax.
  int pool_end = FUSED ? old : length - window + tmax + 1;
  pool_end = max(0, min(pool_end, P_max * page));
  const int n_pool = (pool_end + BK - 1) / BK;
  const int n_tiles = n_pool + ((FUSED && act) ? tmax / BK + 1 : 0);

  for (int j = tid; j < min(P_max, PIDS); j += NTHREADS) pids[j] = table[(long long)b * P_max + j];
  if (tid == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(full(s), Q8 ? NCVT : 1);  // int8: each converter thread; bf16: the expect_tx
      mbar_init(empty(s), 4 * nwg);       // lane 0 of each consumer warp
    }
    for (int s = 0; s < RR; ++s) {
      mbar_init(raw_full(s), 1);
      mbar_init(raw_empty(s), NCVT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = tid / 128;

  if (wg == 2) {
    const int warp = (tid - 256) / 32, lane = tid & 31;
    if (warp == 0 && lane == 0) {
      // The producer: the tiles' boxes into the ring (int8: the raw ring).
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmK)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmV)) : "memory");
      constexpr int RS = Q8 ? RR : R;
      const uint32_t box = static_cast<uint32_t>(box_rows) * 128;  // bytes of one box
      const uint64_t pol = evict_first();  // the int8 scales' bulk copies
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % RS;
        mbar_wait(Q8 ? raw_empty(s) : empty(s), ((j / RS) & 1) ^ 1);
        const uint32_t bar = Q8 ? raw_full(s) : full(s);
        const uint32_t kst = base + (Q8 ? L::RAW_RING + s * L::RAW : L::RING + s * L::STAGE);
        const uint32_t vst = kst + (Q8 ? L::KV_BOX : L::K_BYTES);
        if (j < n_pool) {
          const int x0 = j * BK;
          const int nb = min(BK / box_rows, (pool_end - x0 + box_rows - 1) / box_rows);
          const uint32_t ssc = base + L::SCALES + (R + s) * 2 * BK * 4;
          mbar_expect_tx(bar, nb * box * (Q8 ? 2 : 4) + (Q8 ? nb * box_rows * 8 : 0));
          for (int i = 0; i < nb; ++i) {
            const int x = x0 + i * box_rows, pi = x / page, off = x % page;
            int pg = pi < PIDS ? pids[pi] : table[(long long)b * P_max + pi];
            pg = pg < 0 ? 0 : (pg >= n_pages ? n_pages - 1 : pg);
            const uint32_t r = i * box;
            if constexpr (Q8) {
              tma_load_4d(kst + r, &tmK, bar, 0, off, kh, pg);
              tma_load_4d(vst + r, &tmV, bar, 0, off, kh, pg);
              const long long row = ((long long)pg * KH + kh) * page + off;
              bulk_load(ssc + i * box_rows * 4, ks + row, box_rows * 4, bar, pol);
              bulk_load(ssc + (BK + i * box_rows) * 4, vs + row, box_rows * 4, bar, pol);
            } else {
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                tma_load_4d(kst + c * L::KV_BOX + r, &tmK, bar, c * 64, off, kh, pg);
                tma_load_4d(vst + c * L::KV_BOX + r, &tmV, bar, c * 64, off, kh, pg);
              }
            }
          }
        } else {
          // The window's tokens from the operands (rows past it read 0).
          const int t0 = (j - n_pool) * BK;
          mbar_expect_tx(bar, Q8 ? L::RAW : L::STAGE);
#pragma unroll
          for (int c = 0; c < (Q8 ? 1 : 2); ++c) {
            tma_load_4d(kst + c * L::KV_BOX, &tmNK, bar, c * 64, t0, kh, b);
            tma_load_4d(vst + c * L::KV_BOX, &tmNV, bar, c * 64, t0, kh, b);
          }
        }
      }
    } else if (warp == 0) {
      // The writer, the producer warp's other lanes of column tile 0.
      if (FUSED && ct == 0)
        write_window(kp, vp, ks, vs, nk, nv, nks, nvs, table, positions[b], act, b, kh, window,
                     KH, n_pages, page, P_max, lane - 1, 31);
    } else if constexpr (Q8) {
      // The converters: each raw int8 stage into the bf16 stage the
      // consumers read, swizzled as the boxes are (16-byte chunk c of row r
      // at c ^ (r % 8)); V rows past the last pool token any column sees
      // are written as zeros; the scales come along (the window's from its
      // operands).
      const int ci = tid - 256 - 32;
      for (int j = 0; j < n_tiles; ++j) {
        const int rs = j % RR, cs = j % R;
        mbar_wait(raw_full(rs), (j / RR) & 1);
        mbar_wait(empty(cs), ((j / R) & 1) ^ 1);
        const uint8_t* kr = gbase + L::RAW_RING + rs * L::RAW;
        uint8_t* kc = gbase + L::RING + cs * L::STAGE;
        const int keep = j < n_pool ? pool_end - j * BK : BK;  // V rows kept
        for (int it = ci; it < 2 * BK * 8; it += NCVT) {
          const int v = it / (BK * 8), r = (it / 8) % BK, ch = it % 8;
          const uint4 w = *reinterpret_cast<const uint4*>(kr + v * L::KV_BOX + r * 128 +
                                                          ((ch ^ (r & 7)) << 4));
          const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                                 w.w ^ 0x80808080u};
          uint4 lo = make_uint4(bf16x2_of(u[0], 0), bf16x2_of(u[0], 1), bf16x2_of(u[1], 0),
                                bf16x2_of(u[1], 1));
          uint4 hi = make_uint4(bf16x2_of(u[2], 0), bf16x2_of(u[2], 1), bf16x2_of(u[3], 0),
                                bf16x2_of(u[3], 1));
          if (v && r >= keep) lo = hi = make_uint4(0u, 0u, 0u, 0u);
          uint8_t* dst = kc + v * L::K_BYTES + (ch / 4) * L::KV_BOX + r * 128;
          const int c2 = 2 * (ch % 4);
          *reinterpret_cast<uint4*>(dst + ((c2 ^ (r & 7)) << 4)) = lo;
          *reinterpret_cast<uint4*>(dst + (((c2 + 1) ^ (r & 7)) << 4)) = hi;
        }
        float* sc = reinterpret_cast<float*>(gbase + L::SCALES) + cs * 2 * BK;
        const float* rsc = reinterpret_cast<const float*>(gbase + L::SCALES) + (R + rs) * 2 * BK;
        for (int k = ci; k < 2 * BK; k += NCVT) {
          float x = rsc[k];  // past the loaded boxes: stale, selected away by the consumers
          if (j >= n_pool) {
            const int t = (j - n_pool) * BK + k % BK;
            x = t < window ? (k < BK ? nks : nvs)[((long long)b * window + t) * KH + kh] : 0.f;
          }
          sc[k] = x;
        }
        fence_proxy_async();
        mbar_arrive(raw_empty(rs));
        mbar_arrive(full(cs));
      }
    }
    return;
  }
  if (wg >= nwg) return;

  // The consumers: warpgroup wg owns columns c0 + 64 wg ... + 63.
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // This warpgroup's 64 columns of q into the swizzled Q boxes (columns
  // past C as zeros).
  for (int it = tid % 128; it < 64 * 16; it += 128) {
    const int r = it / 16, ch = it % 16, c = c0 + wg * 64 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c < C) {
      const int gh = c / window, tw = c % window;
      v = *reinterpret_cast<const uint4*>(q + b * sqb + tw * sqk + (kh * group + gh) * sqh +
                                          ch * 8);
    }
    *reinterpret_cast<uint4*>(gbase + (ch / 8) * L::Q_BOX + (wg * 64 + r) * 128 +
                              (((ch % 8) ^ (r & 7)) << 4)) = v;
  }
  fence_proxy_async();
  named_barrier(Q_BARRIER + wg, 128);

  // Rows g and g + 8 of this warp: column, and the last token it sees
  // (length - window + t; FUSED inactive: the pool's old - 1); -1 past C.
  int col[2], lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    col[i] = c0 + wg * 64 + warp * 16 + g + 8 * i;
    lim[i] = col[i] >= C ? -1 : (FUSED && !act) ? old - 1 : length - window + col[i] % window;
  }
  // Tiles wholly at or below the smallest limit among the warp's columns
  // need no mask in this warp.
  const int warp_min = __reduce_min_sync(
      0xffffffffu, min(col[0] < C ? lim[0] : 0x7fffffff, col[1] < C ? lim[1] : 0x7fffffff));

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float s[BK / 2];
  uint32_t p[BK / 16][4];
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  const uint32_t qa = base + wg * (L::Q_BOX / 2);  // this warpgroup's 64 rows of Q box 0
  auto kst = [&](int j) { return base + L::RING + (j % R) * L::STAGE; };
  auto scales = [&](int j) {
    return reinterpret_cast<const float*>(gbase + L::SCALES) + (j % R) * 2 * BK;
  };
  // Tile j's tokens: the pool's from j * BK, capped at pool_end - 1; the
  // window's from old, capped at its last token.
  auto tile_base = [&](int j) { return j < n_pool ? j * BK : old + (j - n_pool) * BK; };
  auto tile_cap = [&](int j) { return j < n_pool ? pool_end - 1 : old + window - 1; };
  // The softmax of tile j with its row limits; without the mask where
  // every row of the warp sees every key of the tile.
  auto softmax = [&](int j) {
    const int b0 = tile_base(j), cap = tile_cap(j);
    const int lj[2] = {min(lim[0], cap), min(lim[1], cap)};
    if (b0 + BK - 1 > min(warp_min, cap))
      softmax_tile<Q8, true>(s, acc, p, m_run, l_run, scales(j), b0, lj, scale, t);
    else
      softmax_tile<Q8, false>(s, acc, p, m_run, l_run, scales(j), b0, lj, scale, t);
  };

  // bf16: the V rows of the last pool tile past pool_end written as zeros
  // (int8: by the converters) before P V reads them.
  auto zero_v = [&](int j) {
    if (Q8 || j != n_pool - 1 || pool_end - j * BK >= BK) return;
    uint8_t* vt = gbase + L::RING + (j % R) * L::STAGE + L::K_BYTES;
    for (int it = (pool_end - j * BK) * 16 + tid % 128; it < BK * 16; it += 128)
      *reinterpret_cast<uint4*>(vt + (it % 16 / 8) * L::KV_BOX + (it / 16) * 128 +
                                (it % 8) * 16) = make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();
    named_barrier(V_BARRIER + wg, 128);
  };

  // The mainloop under one condition, the first QK product before the loop
  // and the last PV product after it, so every product is issued
  // unconditionally in its region (flash_fwd.cu's notes on ptxas).
  if (n_tiles > 0) {
    mbar_wait(full(0), 0);
    zero_v(0);
    fence_acc(acc);
    fence_acc(s);
    wgmma_fence();
    issue_qk<Q8>(s, qa, kst(0));
    wgmma_commit();
    bool landed = true;
    for (int j = 0; j + 1 < n_tiles; ++j) {
      wgmma_wait<0>();  // S of tile j and PV of tile j - 1
      fence_acc(s);
      fence_acc(acc);
      fence_regs(p);
      if (j > 0 && lane == 0) mbar_arrive(empty((j - 1) % R));
      softmax(j);
      fence_acc(acc);
      fence_regs(p);
      // Tile j + 1 must have landed before the products are issued: between
      // the fence and the commit there is straight-line code only.
      landed &= mbar_wait_bounded(full((j + 1) % R), ((j + 1) / R) & 1);
      zero_v(j + 1);
      wgmma_fence();
      issue_pv<Q8>(acc, p, kst(j) + L::K_BYTES);  // O += P V of tile j, then S of tile j + 1
      issue_qk<Q8>(s, qa, kst(j + 1));
      wgmma_commit();
    }
    if (!landed) __trap();
    const int j = n_tiles - 1;
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(acc);
    fence_regs(p);
    if (j > 0 && lane == 0) mbar_arrive(empty((j - 1) % R));
    softmax(j);
    fence_acc(acc);
    fence_regs(p);
    wgmma_fence();
    issue_pv<Q8>(acc, p, kst(j) + L::K_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_regs(p);
    if (lane == 0) mbar_arrive(empty(j % R));
  }

  // The 4 threads of a quad hold partial sums of the same rows.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (col[i] >= C) continue;
    const float l_safe = l_run[i] == 0.f ? 1.f : l_run[i];
    const int gh = col[i] / window, tw = col[i] % window;
    __nv_bfloat16* orow = out + (((long long)b * window + tw) * H + kh * group + gh) * HD;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      *reinterpret_cast<uint32_t*>(orow + c * 8 + t * 2) =
          pack_bf16(acc[4 * c + 2 * i] / l_safe, acc[4 * c + 2 * i + 1] / l_safe);
  }
}

// One launch: the tensor maps (per call, on the host, so a CUDA-graph
// capture records them by value), the shared-memory opt-in (once per device
// and instantiation) and the grid (column tile, KV head, row).
template <bool Q8, bool FUSED>
int launch(const void* q, const void* kp, const void* vp, const float* ks, const float* vs,
           const int* table, const int* lengths, void* out, const void* nk, const void* nv,
           const float* nks, const float* nvs, const int* positions, const int* active, int B,
           int window, int H, int KH, int n_pages, int page, int P_max, long long sqb,
           long long sqk, long long sqh, float scale, cudaStream_t stream) {
  using E = typename split::Ring<Q8>::Elem;
  const CUtensorMapDataType type =
      Q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long esz = sizeof(E);
  int box_rows = 64;  // gcd(page, 64): a box never crosses a page
  while (page % box_rows) box_rows /= 2;
  CUtensorMap tk, tv, tnk, tnv;
  const long long pdims[4] = {HD, page, KH, n_pages};
  const long long pstr[3] = {HD * esz, page * HD * esz, (long long)KH * page * HD * esz};
  const int pbox[4] = {static_cast<int>(128 / esz), box_rows, 1, 1};
  int err = make_map_nd(&tk, kp, 4, pdims, pstr, pbox, type);
  if (err) return err;
  err = make_map_nd(&tv, vp, 4, pdims, pstr, pbox, type);
  if (err) return err;
  tnk = tk;
  tnv = tv;
  if (FUSED) {
    const long long ndims[4] = {HD, window, KH, B};
    const long long nstr[3] = {(long long)KH * HD * esz, HD * esz, (long long)window * KH * HD * esz};
    const int nbox[4] = {static_cast<int>(128 / esz), BK, 1, 1};
    err = make_map_nd(&tnk, nk, 4, ndims, nstr, nbox, type);
    if (err) return err;
    err = make_map_nd(&tnv, nv, 4, ndims, nstr, nbox, type);
    if (err) return err;
  }
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(paged_attn_tile<Q8, FUSED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<Q8>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev].store(true, std::memory_order_release);
  }
  const int C = (H / KH) * window;
  const dim3 grid((C + BQ - 1) / BQ, KH, B);
  paged_attn_tile<Q8, FUSED><<<grid, NTHREADS, Smem<Q8>::BYTES, stream>>>(
      tk, tv, tnk, tnv, static_cast<const __nv_bfloat16*>(q), static_cast<const E*>(kp),
      static_cast<const E*>(vp), ks, vs, table, lengths, static_cast<__nv_bfloat16*>(out),
      static_cast<const E*>(nk), static_cast<const E*>(nv), nks, nvs, positions, active, window,
      H, KH, n_pages, page, P_max, box_rows, sqb, sqk, sqh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile

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
// Python wrapper). body: BODY_SPLIT (1) runs the SPLIT body with clusters of
// `cluster` (1..8) blocks splitting a row's pages, for C = (H / KH) * window
// <= 16; BODY_TILE (2) runs the TILE body (cluster 1), for any C. The
// wrapper routes (ops/paged_attention.py::split_of); a body that is not
// built for the call is refused. Returns the CUDA error code of the launch.
extern "C" int paged_attn(const void* q, const void* kp, const void* vp,
                          const float* ks, const float* vs, const int* table,
                          const int* lengths, void* out, const void* nk,
                          const void* nv, const float* nks, const float* nvs,
                          const int* positions, const int* active, int B,
                          int window, int H, int KH, int n_pages, int page,
                          int P_max, long long sqb, long long sqk,
                          long long sqh, float scale, int quant, int fused,
                          int body, int cluster, void* stream) {
  const int C = (H / KH) * window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == BODY_SPLIT) {
    if (!split_built(C) || cluster < 1 || cluster > split::MAX_SPLIT)
      return static_cast<int>(cudaErrorInvalidValue);
#define PAGED_ATTN_SPLIT(Q, F)                                                            \
  split::with_nc(C, [&](auto nc) {                                                        \
    return split::launch<decltype(nc)::value, Q, F>(                                      \
        q, kp, vp, ks, vs, table, lengths, out, nk, nv, nks, nvs, positions, active, B,   \
        window, H, KH, n_pages, page, P_max, sqb, sqk, sqh, scale, cluster, st);          \
  })
    const cudaError_t err = quant ? (fused ? PAGED_ATTN_SPLIT(true, true)
                                           : PAGED_ATTN_SPLIT(true, false))
                                  : (fused ? PAGED_ATTN_SPLIT(false, true)
                                           : PAGED_ATTN_SPLIT(false, false));
#undef PAGED_ATTN_SPLIT
    return static_cast<int>(err);
  }
  if (body != BODY_TILE || cluster != 1) return static_cast<int>(cudaErrorInvalidValue);
#define PAGED_ATTN_TILE(Q, F)                                                                  \
  tile::launch<Q, F>(q, kp, vp, ks, vs, table, lengths, out, nk, nv, nks, nvs, positions, active, \
                     B, window, H, KH, n_pages, page, P_max, sqb, sqk, sqh, scale, st)
  return quant ? (fused ? PAGED_ATTN_TILE(true, true) : PAGED_ATTN_TILE(true, false))
               : (fused ? PAGED_ATTN_TILE(false, true) : PAGED_ATTN_TILE(false, false));
#undef PAGED_ATTN_TILE
}

// The blocks one wave of the SPLIT body holds, for the instantiation of a
// call with these quant, fused and C = (H / KH) * window, with clusters of
// 1 .. 8 blocks (blocks[c - 1]), from the occupancy of its launch
// configuration on the current device. Returns the CUDA error code
// (cudaErrorInvalidValue for a call the SPLIT body is not built for).
extern "C" int paged_attn_capacity(int quant, int fused, int C, int* blocks) {
  if (!split_built(C)) return static_cast<int>(cudaErrorInvalidValue);
#define PAGED_ATTN_CAPACITY(Q, F) \
  split::with_nc(C, [&](auto nc) { return split::capacity<decltype(nc)::value, Q, F>(blocks); })
  const cudaError_t err = quant ? (fused ? PAGED_ATTN_CAPACITY(true, true)
                                         : PAGED_ATTN_CAPACITY(true, false))
                                : (fused ? PAGED_ATTN_CAPACITY(false, true)
                                         : PAGED_ATTN_CAPACITY(false, false));
#undef PAGED_ATTN_CAPACITY
  return static_cast<int>(err);
}
