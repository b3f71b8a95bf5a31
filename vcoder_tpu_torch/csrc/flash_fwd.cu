// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces the TPU kernels `_fwd_kernel` (vcoder_tpu/ops/flash_attention.py:204,
// rectangular grid) and `_fwd_kernel_tri` (:216, lower-triangle pair grid).
// It computes what they compute: online-softmax attention of q [B,T,H,D]
// against k/v [B,S,KH,D] (GQA: query head h reads KV head h / (H/KH)),
// causal by POSITION (key j is visible to query t when j <= q_positions[b,t]
// and kv_mask[b,j] is set, for any positions), output in bf16 and the per-row
// log-sum-exp in f32 [B,H,T] for the backward. q is scaled in f32 and rounded
// to bf16 before the QK product, exactly as `_flash_fwd` does (the backward
// recomputes P from that rounded q); P is rounded to bf16 before the PV
// product. A row that sees no key gives 0, not NaN (M_FLOOR and l_safe, as at
// flash_attention.py:92-95,192-197).
//
// What bounds it on the card: at the decoder prefill (T=1280, D=128, 32
// heads, causal) the work is 11.8 GFLOP against 40.8 MB, so operations and
// bytes bound it about equally (0.012 ms at 989 TFLOP/s or 3.35 TB/s); the
// tower's d64 case (B=3, T=S=577, 16 heads) is 4.1 GFLOP against 14.3 MB.
// Beside the products each logit costs one exp2 on the SFU, whose 16 a
// clock an SM take half as long as the d128 products and as long as the
// d64 ones. The K/V tiles come from L2 (every q-tile of a head reads them).
//
// Design. One block owns 128 query rows of one (batch, head) and loops over
// the key tiles itself; the running max, sum and output live in registers.
// - Warps. One producer warp issues the TMA loads: the Q tile once, then the
//   K and V tiles of 128 keys into a ring of stages (3 for D=128, 4 for
//   D=64) in dynamic shared memory, with a "full" and an "empty" mbarrier per
//   stage. Its warpgroup gives its registers away (setmaxnreg 24); two
//   consumer warpgroups (240 registers) each own 64 query rows and read
//   every stage.
// - Products. S = Q K^T is wgmma m64n128k16 with both operands in shared
//   memory, K-major (the K tile [keys, D] as stored). O += P V is the
//   register-A wgmma: P is packed to bf16 in the accumulator's own layout
//   (which is the A fragment's), and V [keys, D] is read MN-major through
//   the descriptor's trans-b, so nothing is transposed. A consumer issues
//   PV of tile j and QK of tile j+1 back to back and waits once; the two
//   consumers take turns to issue (ping-pong, named barriers), so one's
//   softmax runs under the other's products.
// - ptxas. It serializes every wgmma of the kernel (a wait after each) when
//   a non-wgmma instruction may write an accumulator while a product is in
//   flight, when anything but straight-line code sits between a fence and
//   its commit, or when a loop that issues wgmma holds a trap (its
//   registers are then allocated as if setmaxnreg had not raised them). So
//   the accumulators are pinned before the first product, the next tile is
//   waited for before the fence, and the mainloop's wait records a timeout
//   and traps after the loop. `cuobjdump -sass` shows one WARPGROUP.DEPBAR
//   per commit group, not one per HGMMA.
// - Tensor maps. 4D over the strided [B, S|T, KH|H, D] views (the head dim
//   contiguous, other strides multiples of 16 bytes, checked by the Python
//   wrapper), 64-column boxes with the 128-byte swizzle, encoded per call on
//   the host and passed by value so a CUDA graph records them. TMA fills rows
//   past T and keys past S with zeros; keys >= S are masked and rows >= T
//   never stored.
// - q scaling. Once Q has landed, each consumer warpgroup scales its rows in
//   f32 and rounds them to bf16 in place (elementwise, so the swizzle does not
//   matter); scale 1 (the tower) skips the pass.
// - Masks. With each K/V tile the producer warp reduces the tile's kv_mask
//   slice (and keys >= S) to 4 bit words and an all-valid flag in shared
//   memory. A warp skips the per-logit mask on a tile whose keys are all
//   valid and whose last key is <= the smallest position among the warp's
//   valid rows (the JAX kernel's mask-free tiles, flash_attention.py:136-142);
//   other tiles pay a bit test and a compare per logit.
// - Causal bound and order. The loop stops at the largest position among
//   the block's valid rows, plus 1 (valid for any positions, also a cached
//   prefill with S > T). Blocks are numbered so that the q-tiles come last
//   to first: under causality the longest blocks start first.
// - Softmax. exp2 with log2(e) folded into one FMA a logit; one reciprocal a
//   row at the end; the LSE is stored in natural-log units for the backward.

#include "sm90.cuh"

namespace {
namespace flash {

using namespace sm90;

constexpr int BQ = 128;             // query rows per block: two consumer warpgroups x 64
constexpr int BK = 128;             // keys per K/V tile
constexpr int NTHREADS = 3 * 128;   // two consumer warpgroups + the producer warpgroup
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e20f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int Q_BARRIER = 1;        // named barriers 1, 2: a warpgroup's scaled Q is written
constexpr int TURN_BARRIER = 3;     // named barriers 3, 4: warpgroup 0's, 1's turn to issue

// Shared memory of one block. Every box is 64 columns (128 bytes a row),
// 128-byte swizzled, 1 KB aligned: Q as D/64 boxes of [BQ rows], a stage as
// K then V, each D/64 boxes of [BK keys]. After the ring, per stage, the
// tile's mask words (4 x 32 keys) and its all-valid flag; then the
// mbarriers (STAGES full, STAGES empty, Q).
template <int D>
struct Smem {
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr int BOXES = D / 64;
  static constexpr int Q_BOX = BQ * 128;
  static constexpr int KV_BOX = BK * 128;
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int K_BYTES = BOXES * KV_BOX;
  static constexpr int STAGE = 2 * K_BYTES;
  static constexpr int RING = Q_BYTES;
  static constexpr int MASKS = RING + STAGES * STAGE;
  static constexpr int BARS = MASKS + STAGES * 32;
  static constexpr int BYTES = 1024 + BARS + (2 * STAGES + 1) * 8;  // 1 KB of alignment slack
};


// S = Q K^T for one key tile (overwriting s): both operands K-major in
// shared memory; 16 of D are 32 bytes along a box's 128-byte rows.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t qa, uint32_t kst) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n128k16_ss(s, smem_desc(qa + (kk / 4) * L::Q_BOX + (kk % 4) * 32, 16, 1024),
                        smem_desc(kst + (kk / 4) * L::KV_BOX + (kk % 4) * 32, 16, 1024), kk > 0);
}

// O += P V for one key tile: P from registers, V [keys, D] MN-major (16 keys
// are 16 rows of 128 bytes; its 64-column boxes KV_BOX bytes apart).
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&p)[BK / 16][4],
                                         uint32_t vst) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = smem_desc(vst + kk * 2048, L::KV_BOX, 1024);
    if constexpr (D == 128)
      wgmma_m64n128k16_rs(acc, p[kk], dv);
    else
      wgmma_m64n64k16_rs(acc, p[kk], dv);
  }
}

// One key tile of the online softmax (f32, base 2): the mask where the tile
// needs one, the running max, the rescaled sums and output, P packed to bf16
// as the A fragment of the PV product. Accumulator element 4c + e of a
// thread is row g + 8 (e / 2), key 8c + 2t + e % 2 of the tile.
template <int D>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&acc)[D / 2],
                                             uint32_t (&p)[BK / 16][4], float (&m_run)[2],
                                             float (&l_run)[2], const uint32_t* mw, int kv0,
                                             const int (&pos)[2], int causal, int warp_min,
                                             int t) {
  if (!(mw[4] != 0 && (!causal || kv0 + BK - 1 <= warp_min))) {
    const uint4 words = *reinterpret_cast<const uint4*>(mw);
    const uint32_t wv[4] = {words.x, words.y, words.z, words.w};
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = 8 * c + 2 * t + (e & 1);
        const bool ok = ((wv[c / 4] >> (kl % 32)) & 1u) && (!causal || kv0 + kl <= pos[e >> 1]);
        s[4 * c + e] = ok ? s[4 * c + e] : NEG_INF;
      }
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int c = 0; c < BK / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * c + e]);
  float alpha[2], mb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(fmaxf(m_run[i], mx[i]), M_FLOOR);
    alpha[i] = exp2f((m_run[i] - m_new) * LOG2E);
    m_run[i] = m_new;
    mb[i] = m_new * LOG2E;
    l_run[i] *= alpha[i];
  }
#pragma unroll
  for (int c = 0; c < BK / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = exp2f(fmaf(s[4 * c + e], LOG2E, -mb[e >> 1]));
      l_run[e >> 1] += x;
      s[4 * c + e] = x;
    }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    acc[4 * c + 0] *= alpha[0];
    acc[4 * c + 1] *= alpha[0];
    acc[4 * c + 2] *= alpha[1];
    acc[4 * c + 3] *= alpha[1];
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tmQ, const __grid_constant__ CUtensorMap tmK,
                   const __grid_constant__ CUtensorMap tmV, const int* __restrict__ qpos,
                   const int* __restrict__ kvmask, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, int T, int S, int H, int KH, float scale,
                   int causal) {
  using L = Smem<D>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int warp_max[4];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // the same bytes, generic address
  const uint32_t bars = base + L::BARS;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  const uint32_t qbar = bars + 8u * 2 * STAGES;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kh = h / (H / KH);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 2);   // the producer's expect_tx arrival and its mask arrival
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The causal loop bound: the largest position among the block's valid rows.
  if (tid < BQ) {
    const int row = q0 + tid;
    int p = (causal && row < T) ? qpos[static_cast<long long>(b) * T + row] : -1;
    p = __reduce_max_sync(0xffffffffu, p);
    if ((tid & 31) == 0) warp_max[tid >> 5] = p;
  }
  __syncthreads();
  const int max_pos = max(max(warp_max[0], warp_max[1]), max(warp_max[2], warp_max[3]));
  const int kv_end = causal ? min(S, max_pos + 1) : S;
  const int n_tiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;
  const int wg = tid / 128;

  if (wg == 2) {
    // The producer warp: lane 0 issues the loads, the warp reduces the masks.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid >= 256 + 32) return;
    const int lane = tid & 31;
    if (lane == 0 && n_tiles > 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmQ)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmK)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmV)) : "memory");
      mbar_expect_tx(qbar, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::BOXES; ++c)
        tma_load_4d(base + c * L::Q_BOX, &tmQ, qbar, c * 64, q0, h, b);
    }
    const int* mrow = kvmask == nullptr ? nullptr : kvmask + static_cast<long long>(b) * S;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int kv0 = j * BK;
      bool valid[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kv0 + 32 * i + lane;
        valid[i] = key < S && (mrow == nullptr || mrow[key] != 0);
      }
      mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t kst = base + L::RING + s * L::STAGE, vst = kst + L::K_BYTES;
        mbar_expect_tx(full(s), L::STAGE);
#pragma unroll
        for (int c = 0; c < L::BOXES; ++c) {
          tma_load_4d(kst + c * L::KV_BOX, &tmK, full(s), c * 64, kv0, kh, b);
          tma_load_4d(vst + c * L::KV_BOX, &tmV, full(s), c * 64, kv0, kh, b);
        }
      }
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = __ballot_sync(0xffffffffu, valid[i]);
      if (lane == 0) {
        uint32_t* m = reinterpret_cast<uint32_t*>(gbase + L::MASKS + s * 32);
        *reinterpret_cast<uint4*>(m) = make_uint4(w[0], w[1], w[2], w[3]);
        m[4] = (w[0] & w[1] & w[2] & w[3]) == 0xffffffffu;
        mbar_arrive(full(s));
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns query rows q0 + 64 wg ... + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  int row[2], pos[2];
  bool rok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + wg * 64 + warp * 16 + g + 8 * i;
    rok[i] = row[i] < T;
    pos[i] = (causal && rok[i]) ? qpos[static_cast<long long>(b) * T + row[i]] : 0;
  }
  // Key tiles wholly at or below the smallest position among the warp's
  // valid rows need no causal mask in this warp.
  const int warp_min = __reduce_min_sync(
      0xffffffffu, min(rok[0] ? pos[0] : 0x7fffffff, rok[1] ? pos[1] : 0x7fffffff));

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BK / 2];
  uint32_t p[BK / 16][4];
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  const uint32_t qa = base + wg * (L::Q_BOX / 2);  // this warpgroup's 64 rows of Q box 0
  auto kst = [&](int j) { return base + L::RING + (j % STAGES) * L::STAGE; };
  auto masks = [&](int j) {
    return reinterpret_cast<const uint32_t*>(gbase + L::MASKS + (j % STAGES) * 32);
  };
  // Ping-pong: a warpgroup waits for its turn before it issues products and
  // passes the turn on once they are issued; warpgroup 1 lets warpgroup 0 go
  // first and does not pass its last turn on (warpgroup 0 has taken all its
  // turns by then).
  auto take_turn = [&]() {
    named_barrier(TURN_BARRIER + wg, 256);
  };
  auto pass_turn = [&](bool last) {
    if (wg == 0 || !last) named_barrier_arrive(TURN_BARRIER + 1 - wg, 256);
  };

  // The whole mainloop sits under one condition, with the first QK product
  // before the loop and the last PV product after it, so every product is
  // issued unconditionally in its region.
  if (n_tiles > 0) {
    mbar_wait(qbar, 0);
    if (scale != 1.f) {
#pragma unroll
      for (int c = 0; c < L::BOXES; ++c)
        for (int i = tid % 128; i < L::Q_BOX / 2 / 16; i += 128) {
          uint4* ptr = reinterpret_cast<uint4*>(gbase + c * L::Q_BOX + wg * (L::Q_BOX / 2) + i * 16);
          *ptr = scale8(*ptr, scale);
        }
      fence_proxy_async();
      named_barrier(Q_BARRIER + wg, 128);
    }
    mbar_wait(full(0), 0);
    if (wg == 1) named_barrier_arrive(TURN_BARRIER, 256);
    take_turn();
    // Both accumulators are pinned here: a zeroing of acc sunk past the
    // first product would make ptxas serialize every wgmma of the kernel.
    fence_acc(acc);
    fence_acc(s);
    wgmma_fence();
    issue_qk<D>(s, qa, kst(0));
    wgmma_commit();
    pass_turn(false);
    bool landed = true;
    for (int j = 0; j + 1 < n_tiles; ++j) {
      wgmma_wait<0>();  // S of tile j and PV of tile j - 1
      fence_acc(s);
      fence_acc(acc);
      fence_regs(p);
      if (j > 0 && lane == 0) mbar_arrive(empty((j - 1) % STAGES));
      softmax_tile<D>(s, acc, p, m_run, l_run, masks(j), j * BK, pos, causal, warp_min, t);
      fence_acc(acc);
      fence_regs(p);
      // Tile j + 1 must have landed before the products are issued: between
      // the fence and the commit there is straight-line code only, or ptxas
      // serializes every wgmma of the kernel.
      landed &= mbar_wait_bounded(full((j + 1) % STAGES), ((j + 1) / STAGES) & 1);
      take_turn();
      wgmma_fence();
      issue_pv<D>(acc, p, kst(j) + L::K_BYTES);  // O += P V of tile j, then S of tile j + 1
      issue_qk<D>(s, qa, kst(j + 1));
      wgmma_commit();
      pass_turn(false);
    }
    if (!landed) __trap();
    const int j = n_tiles - 1;
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(acc);
    fence_regs(p);
    if (j > 0 && lane == 0) mbar_arrive(empty((j - 1) % STAGES));
    softmax_tile<D>(s, acc, p, m_run, l_run, masks(j), j * BK, pos, causal, warp_min, t);
    fence_acc(acc);
    fence_regs(p);
    take_turn();
    wgmma_fence();
    issue_pv<D>(acc, p, kst(j) + L::K_BYTES);
    wgmma_commit();
    pass_turn(true);
    wgmma_wait<0>();
    fence_acc(acc);
    fence_regs(p);
    if (lane == 0) mbar_arrive(empty(j % STAGES));
  }

  // Finalize: the 4 threads of a quad hold partial sums of the same rows.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rok[i]) continue;
    const float l_safe = l_run[i] == 0.f ? 1.f : l_run[i];
    const float inv = 1.f / l_safe;
    __nv_bfloat16* orow = o + ((static_cast<long long>(b) * T + row[i]) * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(orow + c * 8 + t * 2) =
          pack_bf16(acc[4 * c + 2 * i] * inv, acc[4 * c + 2 * i + 1] * inv);
    if (t == 0)
      lse[(static_cast<long long>(b) * H + h) * T + row[i]] =
          fmaxf(m_run[i], M_FLOOR) + logf(l_safe);
  }
}

// One launch: the three tensor maps (per call, on the host, so a CUDA-graph
// capture records them by value), the shared-memory opt-in above 48 KB (once
// per device and instantiation; idempotent, so two threads may both set it)
// and the grid (head, batch, q-tile last to first).
template <int D>
int launch(const void* q, const void* k, const void* v, const int* qpos, const int* kvmask,
           void* o, float* lse, int B, int T, int S, int H, int KH, long long q_sb,
           long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
           long long v_sb, long long v_st, long long v_sh, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const long long qdims[4] = {D, T, H, B}, kdims[4] = {D, S, KH, B};
  const long long qs[3] = {2 * q_st, 2 * q_sh, 2 * q_sb};
  const long long ks[3] = {2 * k_st, 2 * k_sh, 2 * k_sb};
  const long long vs[3] = {2 * v_st, 2 * v_sh, 2 * v_sb};
  const int qbox[4] = {64, BQ, 1, 1}, kbox[4] = {64, BK, 1, 1};
  int err = make_map_nd(&tq, q, 4, qdims, qs, qbox);
  if (err) return err;
  err = make_map_nd(&tk, k, 4, kdims, ks, kbox);
  if (err) return err;
  err = make_map_nd(&tv, v, 4, kdims, vs, kbox);
  if (err) return err;
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(flash_fwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<D>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev].store(true, std::memory_order_release);
  }
  const dim3 grid(H, B, (T + BQ - 1) / BQ);
  flash_fwd_sm90<D><<<grid, NTHREADS, Smem<D>::BYTES, stream>>>(
      tq, tk, tv, qpos, kvmask, static_cast<__nv_bfloat16*>(o), lse, T, S, H, KH, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
}  // namespace

// Plain C entry point for ctypes. Layouts: q [B,T,H,D], k/v [B,S,KH,D] with
// the given element strides (the head-dim stride is 1, the others multiples
// of 8, the data 16-byte aligned); o is a contiguous [B,T,H,D]; lse a
// contiguous f32 [B,H,T]; qpos int32 [B,T] (read only when causal); kvmask
// int32 [B,S] or null for all-valid. D is 64 or 128. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const int* qpos,
                         const int* kvmask, void* o, float* lse, int B, int T, int S, int H,
                         int KH, int D, long long q_sb, long long q_st, long long q_sh,
                         long long k_sb, long long k_st, long long k_sh, long long v_sb,
                         long long v_st, long long v_sh, float scale, int causal,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return flash::launch<128>(q, k, v, qpos, kvmask, o, lse, B, T, S, H, KH, q_sb, q_st, q_sh,
                              k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, causal, st);
  if (D == 64)
    return flash::launch<64>(q, k, v, qpos, kvmask, o, lse, B, T, S, H, KH, q_sb, q_st, q_sh,
                             k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
