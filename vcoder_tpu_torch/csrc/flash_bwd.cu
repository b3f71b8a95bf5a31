// Flash-attention backward for Hopper (sm_90a): bf16 in and out, f32 math.
//
// Replaces the TPU kernels `_bwd_dq_kernel` (vcoder_tpu/ops/flash_attention.py
// :446) and `_bwd_dkv_kernel` (:503), launched by `_flash_bwd` (:570). It
// computes what they compute, for q [B,T,H,D], k/v [B,S,KH,D] (GQA: query head
// h reads KV head h / (H/KH)), the forward's output O and output-gradient dO
// [B,T,H,D] and the forward's per-row log-sum-exp lse [B,H,T]:
//
//   delta = rowsum(dO * O) in f32 (plain XLA in `_flash_bwd:577`)
//   P  = exp(S - lse) on visible keys, 0 elsewhere,  S = round_bf16(q*scale) K^T
//   dP = dO V^T,  dS = P * (dP - delta)
//   dQ = scale * round_bf16(dS) K
//   dV = sum over the group's query heads of round_bf16(P)^T dO
//   dK = sum over the group's query heads of scale * round_bf16(dS)^T q
//
// with the roundings of the TPU kernels: q is scaled in f32 and rounded to
// bf16 before QK, exactly as the forward did (`_recompute_p:412`; scaling
// after the dot would leave P rows that do not sum to 1 under the saved lse);
// dS is rounded before both of its products (:485, :551); P is rounded before
// dV (:539); dK takes the unscaled q. Visibility is the forward's: key j is
// visible to query t when kv_mask[b,j] is set and, if causal, j <=
// q_positions[b,t], for any positions (S >= T allowed). A row that sees no
// key (its lse is the forward's floor, -1e20) gets P = 0, so its gradients
// are exact zeros, never NaN: masked logits are set to -inf before the exp.
//
// What bounds it on the card: at the training shape (B=4, T=S=2048, 32
// heads, D=128, causal, ~1240 valid rows a sequence) the five products over
// the visible pairs are ~0.13 TFLOP against ~0.54 GB moved once (~0.13 ms by
// operations, ~0.16 ms by bytes at 989 TFLOP/s and 3.35 TB/s). The pair of
// kernels recomputes S and dP in both (seven products where five are
// needed), so the tensor cores bound it; each logit also pays one exp2.
//
// Design. The TPU kernels walk a sequential grid axis and carry their f32
// sums in VMEM between grid steps. Hopper's blocks run in no order, so each
// block owns its output tile and loops itself: two kernels, dq then dkv,
// nothing atomic, the result independent of the schedule. Both have the
// forward's shape: one producer warp issues TMA loads (4D tensor maps over
// the strided [B, T|S, H|KH, D] views, 64-column boxes with the 128-byte
// swizzle, encoded per call on the host and passed by value so a CUDA graph
// records them) into a ring of stages with a full and an empty mbarrier
// each; its warpgroup gives its registers away (setmaxnreg 24 in dq; 40 in
// dkv, whose producer also writes each tile's rows: at 24 it spills) and two
// consumer warpgroups (240 registers in dq, 232 in dkv) run wgmma on what
// has landed. Every
// operand is read from shared memory as TMA stored it: the products that
// need a tile transposed read it MN-major through the descriptor's trans-b,
// so nothing is transposed or copied.
//
// * dq: one block per (128 query rows, head, batch); each consumer
//   warpgroup owns 64 rows. In its prologue it computes delta for its rows
//   from O and dO in f32, keeps it and writes it to a [B,H,T] f32 scratch
//   for the dkv kernel; once the Q and dO tiles have landed it scales its
//   rows of Q in f32 and rounds them in place (writing them also to a
//   [B,T,H,D] scratch: dkv's S^T needs round(q*scale), its dK the unscaled
//   q). The producer streams 64-key K/V tiles (4 stages) up to the largest
//   position of the block's valid rows, with the tile's kv_mask reduced to
//   two bit words and an all-valid flag. Per tile: S = Qs K^T and dP = dO V^T
//   (wgmma m64n64k16, both operands from shared memory, K-major as stored),
//   dS in registers, then dQ += round(dS) K (register-A wgmma m64n128k16, K
//   read MN-major). dQ of tile j is issued with S and dP of tile j + 1 and
//   waited for once, and the two warpgroups take turns to issue (ping-pong,
//   as in the forward), so one's dS runs under the other's products. Blocks
//   run their q tiles last to first (longest first).
// * dkv: one block per (128 keys, KV head, batch), K and V resident (one TMA
//   load each); each consumer warpgroup owns 64 keys. The block first marks
//   the 64-row query tiles with a valid row that sees its first key; the
//   producer walks the group's query heads x those tiles (`_bwd_dkv_kernel`'s
//   fused m axis, :622-660) and feeds each tile's round(q*scale), q and dO
//   (3 stages of 48 KB) with its rows' lse (times log2 e; +inf on rows >= T,
//   so their P is 0), delta, positions (-1 on rows >= T) and the smallest
//   valid position. Per tile: S^T = K Qs^T and dP^T = V dO^T (shared-memory
//   wgmma), P^T and dS^T in registers, then dV += round(P^T) dO and dK +=
//   round(dS^T) q (register-A wgmma, dO and q read MN-major), each group
//   waited for before the next: dK and dV hold 128 registers a thread, so
//   the next tile's S^T and dP^T cannot be in flight beside them. Key blocks
//   are numbered first to last: under causality the earliest keys see the
//   most rows. Keys >= S are never stored; a block no row sees writes zeros.
// * Masks. A warp skips the per-logit test on a tile whose keys are all
//   valid and lie wholly at or below the smallest position of the rows it
//   multiplies (JAX's mask-free tiles, :460-463, :519-522); other tiles pay
//   a bit test and a compare a logit.
// * ptxas serializes every wgmma of a kernel (a WARPGROUP.DEPBAR per HGMMA)
//   when anything but straight-line code sits between a fence and its
//   commit, when an accumulator may be written while a product is in
//   flight, or when a loop that issues wgmma holds a trap (its registers are
//   then allocated as if setmaxnreg had not raised them). So every product
//   is issued unconditionally in the loop body, the ring is waited for
//   before the fence, the accumulators are pinned around each wait, and the
//   loop's waits record a timeout and trap after the loop.

#include "sm90.cuh"

namespace {
namespace bwd {

using namespace sm90;

constexpr int D = 128;             // head dim: the decoder's (the tower is frozen)
constexpr int NTHREADS = 3 * 128;  // two consumer warpgroups + the producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_Q_TILES = 256 * 32;  // dkv's tile bit set: T <= 524288
constexpr int Q_BARRIER = 1;     // dq's named barriers 1, 2: a warpgroup's scaled Q is written
constexpr int TURN_BARRIER = 3;  // dq's named barriers 3, 4: warpgroup 0's, 1's turn to issue

__device__ __forceinline__ float inf() { return __uint_as_float(0x7f800000u); }

// dq: Q and dO as two 64-column boxes of 128 rows each, then the ring of
// K/V stages (two boxes of 64 keys each for K, then V), then per stage the
// tile's mask words (2 x 32 keys) and all-valid flag, the block's delta
// (f32 [128]) and the mbarriers (STAGES full, STAGES empty, Q).
struct DqSmem {
  static constexpr int BQ = 128;  // query rows per block
  static constexpr int BK = 64;   // keys per K/V tile
  static constexpr int STAGES = 4;
  static constexpr int Q_BOX = BQ * 128;
  static constexpr int KV_BOX = BK * 128;
  static constexpr int Q = 0;
  static constexpr int DO = 2 * Q_BOX;
  static constexpr int RING = 4 * Q_BOX;
  static constexpr int K_BYTES = 2 * KV_BOX;
  static constexpr int STAGE = 2 * K_BYTES;
  static constexpr int MASKS = RING + STAGES * STAGE;
  static constexpr int DELTA = MASKS + STAGES * 16;
  static constexpr int BARS = DELTA + BQ * 4;
  static constexpr int BYTES = 1024 + BARS + (2 * STAGES + 1) * 8;  // 1 KB of alignment slack
};

// dkv: K and V as two 64-column boxes of 128 keys each, then the ring of
// q-tile stages (round(q*scale), q, dO: two boxes of 64 rows each), then per
// stage the tile's rows (lse * log2 e, delta, position: 64 each) and its
// smallest valid position, the bit set of seen query tiles and the
// mbarriers (STAGES full, STAGES empty, K/V).
struct DkvSmem {
  static constexpr int BK = 128;  // keys per block
  static constexpr int BQ = 64;   // query rows per tile
  static constexpr int STAGES = 3;
  static constexpr int KV_BOX = BK * 128;
  static constexpr int Q_BOX = BQ * 128;
  static constexpr int K = 0;
  static constexpr int V = 2 * KV_BOX;
  static constexpr int RING = 4 * KV_BOX;
  static constexpr int TILE = 2 * Q_BOX;
  static constexpr int STAGE = 3 * TILE;  // round(q*scale), q, dO
  static constexpr int META = RING + STAGES * STAGE;
  static constexpr int META_BYTES = 3 * BQ * 4 + 16;
  static constexpr int SEEN = META + STAGES * META_BYTES;
  static constexpr int BARS = SEEN + MAX_Q_TILES / 8;
  static constexpr int BYTES = 1024 + BARS + (2 * STAGES + 1) * 8;
};


// The f32 dot product of eight bf16 pairs.
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t* wa = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* wb = reinterpret_cast<const uint32_t*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wa[i]));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wb[i]));
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
  }
  return s;
}

// d[64 x 64] = A B^T over D = 128: A the warpgroup's 64 rows at `a` of a
// tile whose 64-column boxes are A_BOX bytes apart, B a 64-row tile at `b`
// with boxes B_BOX apart, both K-major (16 of D are 32 bytes of a box's
// 128-byte rows).
template <int A_BOX, int B_BOX>
__device__ __forceinline__ void issue_abt(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss(d, smem_desc(a + (kk / 4) * A_BOX + (kk % 4) * 32, 16, 1024),
                       smem_desc(b + (kk / 4) * B_BOX + (kk % 4) * 32, 16, 1024), kk > 0);
}

// d[64 x 128] += F B over 64 rows of B: F from registers (the A fragments
// of 4 k-steps), B a [64 rows, D] tile at `b` read MN-major (16 rows are
// 2048 bytes; its 64-column boxes B_BOX bytes apart).
template <int B_BOX>
__device__ __forceinline__ void issue_fb(float (&d)[64], const uint32_t (&f)[4][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16_rs(d, f[kk], smem_desc(b + kk * 2048, B_BOX, 1024));
}

// Packs a 64 x 64 f32 accumulator to bf16 A fragments: element 4c + e of a
// thread is row g + 8 (e / 2), column 8c + 2t + e % 2, and the A fragment
// of k-step kk holds columns 16kk ... 16kk + 15.
__device__ __forceinline__ void pack_frags(const float (&x)[32], uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq(const __grid_constant__ CUtensorMap tmQ, const __grid_constant__ CUtensorMap tmG,
                 const __grid_constant__ CUtensorMap tmK, const __grid_constant__ CUtensorMap tmV,
                 const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const int* __restrict__ qpos,
                 const int* __restrict__ kvmask, float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ qs, __nv_bfloat16* __restrict__ dq, int T, int S,
                 int H, int KH, long long o_sb, long long o_st, long long o_sh, long long g_sb,
                 long long g_st, long long g_sh, float scale, int causal) {
  using L = DqSmem;
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
  const int q0 = (gridDim.z - 1 - blockIdx.z) * L::BQ;
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
  if (tid < L::BQ) {
    const int row = q0 + tid;
    int p = (causal && row < T) ? qpos[static_cast<long long>(b) * T + row] : -1;
    p = __reduce_max_sync(0xffffffffu, p);
    if ((tid & 31) == 0) warp_max[tid >> 5] = p;
  }
  __syncthreads();
  const int max_pos = max(max(warp_max[0], warp_max[1]), max(warp_max[2], warp_max[3]));
  const int kv_end = causal ? min(S, max_pos + 1) : S;
  const int n_tiles = kv_end > 0 ? (kv_end + L::BK - 1) / L::BK : 0;
  const int wg = tid / 128;

  if (wg == 2) {
    // The producer warp: lane 0 issues the loads, the warp reduces the masks.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid >= 256 + 32) return;
    const int lane = tid & 31;
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmQ)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmG)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmK)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmV)) : "memory");
      mbar_expect_tx(qbar, 4 * L::Q_BOX);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        tma_load_4d(base + L::Q + c * L::Q_BOX, &tmQ, qbar, c * 64, q0, h, b);
        tma_load_4d(base + L::DO + c * L::Q_BOX, &tmG, qbar, c * 64, q0, h, b);
      }
    }
    const int* mrow = kvmask == nullptr ? nullptr : kvmask + static_cast<long long>(b) * S;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int kv0 = j * L::BK;
      bool valid[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = kv0 + 32 * i + lane;
        valid[i] = key < S && (mrow == nullptr || mrow[key] != 0);
      }
      mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t kst = base + L::RING + s * L::STAGE, vst = kst + L::K_BYTES;
        mbar_expect_tx(full(s), L::STAGE);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          tma_load_4d(kst + c * L::KV_BOX, &tmK, full(s), c * 64, kv0, kh, b);
          tma_load_4d(vst + c * L::KV_BOX, &tmV, full(s), c * 64, kv0, kh, b);
        }
      }
      const uint32_t w0 = __ballot_sync(0xffffffffu, valid[0]);
      const uint32_t w1 = __ballot_sync(0xffffffffu, valid[1]);
      if (lane == 0) {
        uint32_t* m = reinterpret_cast<uint32_t*>(gbase + L::MASKS + s * 16);
        *reinterpret_cast<uint4*>(m) = make_uint4(w0, w1, (w0 & w1) == 0xffffffffu, 0u);
        mbar_arrive(full(s));
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns query rows q0 + 64 wg ... + 63; a
  // thread's rows are g and g + 8 of its warp's 16.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long bh = static_cast<long long>(b) * H + h;
  int row[2], pos[2];
  bool rok[2];
  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + wg * 64 + warp * 16 + g + 8 * i;
    rok[i] = row[i] < T;
    pos[i] = (causal && rok[i]) ? qpos[static_cast<long long>(b) * T + row[i]] : 0;
    lse2[i] = rok[i] ? lse[bh * T + row[i]] * LOG2E : 0.f;
  }
  // Key tiles wholly at or below the smallest position among the warp's
  // valid rows need no causal mask in this warp.
  const int warp_min = __reduce_min_sync(
      0xffffffffu, min(rok[0] ? pos[0] : 0x7fffffff, rok[1] ? pos[1] : 0x7fffffff));

  // delta = rowsum(dO * O) of the warp's 16 rows in f32, two rows at a time
  // (16 lanes a row, 8 elements a lane, all loads in flight at once), kept
  // in shared memory for the thread's rows and written to the scratch for
  // the dkv kernel.
  float* const delta_s = reinterpret_cast<float*>(gbase + L::DELTA) + wg * 64 + warp * 16;
  {
    const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 4), col = (lane & 15) * 8;
    const __nv_bfloat16* orow = out + b * o_sb + h * o_sh + col;
    const __nv_bfloat16* grow = dout + b * g_sb + h * g_sh + col;
    uint4 ov[8], gv[8];
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int r = r0 + 2 * it;
      ov[it] = r < T ? *reinterpret_cast<const uint4*>(orow + r * o_st) : make_uint4(0, 0, 0, 0);
      gv[it] = r < T ? *reinterpret_cast<const uint4*>(grow + r * g_st) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int r = r0 + 2 * it;
      float acc = dot8(ov[it], gv[it]);
#pragma unroll
      for (int x = 8; x >= 1; x >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, x);
      if ((lane & 15) == 0) {
        delta_s[2 * it + (lane >> 4)] = acc;
        if (r < T) delta[bh * T + r] = acc;
      }
    }
  }
  __syncwarp();
  const float dl[2] = {delta_s[g], delta_s[g + 8]};

  // Q scaled in f32 and rounded in place (elementwise, so the swizzle does
  // not matter), and written to the scratch in [B,T,H,D] order: 16-byte
  // chunk p of a box row r holds the row's columns 8 (p ^ (r % 8)) ...
  mbar_wait(qbar, 0);
#pragma unroll
  for (int c = 0; c < 2; ++c)
    for (int i = tid % 128; i < 64 * 8; i += 128) {
      const int rr = i / 8, p = i % 8, r = q0 + wg * 64 + rr;
      uint4* ptr = reinterpret_cast<uint4*>(gbase + L::Q + c * L::Q_BOX + wg * (L::Q_BOX / 2) + i * 16);
      const uint4 val = scale8(*ptr, scale);
      *ptr = val;
      if (r < T)
        *reinterpret_cast<uint4*>(qs + ((static_cast<long long>(b) * T + r) * H + h) * D + c * 64 +
                                  (p ^ (rr & 7)) * 8) = val;
    }
  fence_proxy_async();
  named_barrier(Q_BARRIER + wg, 128);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float sa[32], dp[32];
  uint32_t ds[4][4];
  const uint32_t qa = base + L::Q + wg * (L::Q_BOX / 2);  // this warpgroup's rows of box 0
  const uint32_t ga = base + L::DO + wg * (L::Q_BOX / 2);
  auto kst = [&](int j) { return base + L::RING + (j % STAGES) * L::STAGE; };
  // dS of key tile j from S and dP, as the A fragments of dQ's product:
  // the mask where the tile needs one, P = exp2(S log2 e - lse log2 e),
  // dS = P (dP - delta).
  auto ds_tile = [&](int j) {
    const uint32_t* mw = reinterpret_cast<const uint32_t*>(gbase + L::MASKS + (j % STAGES) * 16);
    const int kv0 = j * L::BK;
    const bool clean = mw[2] != 0 && (!causal || kv0 + L::BK - 1 <= warp_min);
    if (!clean) {
      const uint32_t wv[2] = {mw[0], mw[1]};
#pragma unroll
      for (int c = 0; c < L::BK / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = 8 * c + 2 * t + (e & 1);
          const bool ok = ((wv[c / 4] >> (kl % 32)) & 1u) && (!causal || kv0 + kl <= pos[e >> 1]);
          sa[4 * c + e] = ok ? sa[4 * c + e] : -inf();
        }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(fmaf(sa[i], LOG2E, -lse2[(i >> 1) & 1]));
      sa[i] = p * (dp[i] - dl[(i >> 1) & 1]);
    }
    pack_frags(sa, ds);
  };
  // Ping-pong, as in the forward: a warpgroup waits for its turn before it
  // issues products and passes the turn on once they are issued, so one's
  // dS runs under the other's products; warpgroup 1 lets warpgroup 0 go
  // first and does not pass its last turn on.
  auto take_turn = [&](bool first) {
    if (first && wg == 1) named_barrier_arrive(TURN_BARRIER, 256);
    named_barrier(TURN_BARRIER + wg, 256);
  };
  auto pass_turn = [&](bool last) {
    if (wg == 0 || !last) named_barrier_arrive(TURN_BARRIER + 1 - wg, 256);
  };
  // S and dP of tile j + 1 are issued with dQ of tile j and waited for
  // once; the whole mainloop sits under one condition, with the first S and
  // dP before the loop and the last dQ after it, so every product is issued
  // unconditionally in its region.
  if (n_tiles > 0) {
    bool landed = mbar_wait_bounded(full(0), 0);
    // The accumulator is pinned here: a zeroing sunk past the first product
    // would make ptxas serialize every wgmma of the kernel.
    fence_acc(acc);
    take_turn(true);
    wgmma_fence();
    issue_abt<L::Q_BOX, L::KV_BOX>(sa, qa, kst(0));                // S = Qs K^T
    issue_abt<L::Q_BOX, L::KV_BOX>(dp, ga, kst(0) + L::K_BYTES);   // dP = dO V^T
    wgmma_commit();
    pass_turn(false);
    for (int j = 0; j + 1 < n_tiles; ++j) {
      wgmma_wait<0>();  // S and dP of tile j, dQ of tile j - 1
      fence_acc(sa);
      fence_acc(dp);
      fence_acc(acc);
      fence_regs(ds);
      if (j > 0 && lane == 0) mbar_arrive(empty((j - 1) % STAGES));
      ds_tile(j);
      fence_regs(ds);
      // Tile j + 1 must have landed before the products are issued: between
      // the fence and the commit there is straight-line code only.
      landed &= mbar_wait_bounded(full((j + 1) % STAGES), ((j + 1) / STAGES) & 1);
      take_turn(false);
      wgmma_fence();
      issue_fb<L::KV_BOX>(acc, ds, kst(j));  // dQ += round(dS) K
      issue_abt<L::Q_BOX, L::KV_BOX>(sa, qa, kst(j + 1));
      issue_abt<L::Q_BOX, L::KV_BOX>(dp, ga, kst(j + 1) + L::K_BYTES);
      wgmma_commit();
      pass_turn(false);
    }
    if (!landed) __trap();
    const int j = n_tiles - 1;
    wgmma_wait<0>();
    fence_acc(sa);
    fence_acc(dp);
    fence_acc(acc);
    fence_regs(ds);
    if (j > 0 && lane == 0) mbar_arrive(empty((j - 1) % STAGES));
    ds_tile(j);
    fence_regs(ds);
    take_turn(false);
    wgmma_fence();
    issue_fb<L::KV_BOX>(acc, ds, kst(j));
    wgmma_commit();
    pass_turn(true);
    wgmma_wait<0>();
    fence_acc(acc);
    fence_regs(ds);
    if (lane == 0) mbar_arrive(empty(j % STAGES));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rok[i]) continue;
    __nv_bfloat16* drow = dq + ((static_cast<long long>(b) * T + row[i]) * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(drow + c * 8 + t * 2) =
          pack_bf16(acc[4 * c + 2 * i] * scale, acc[4 * c + 2 * i + 1] * scale);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkv(const __grid_constant__ CUtensorMap tmQS, const __grid_constant__ CUtensorMap tmQ,
                  const __grid_constant__ CUtensorMap tmG, const __grid_constant__ CUtensorMap tmK,
                  const __grid_constant__ CUtensorMap tmV, const float* __restrict__ lse,
                  const float* __restrict__ delta, const int* __restrict__ qpos,
                  const int* __restrict__ kvmask, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int T, int S, int H, int KH, float scale,
                  int causal) {
  using L = DkvSmem;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::BARS;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  const uint32_t kvbar = bars + 8u * 2 * STAGES;
  auto stage = [&](int s) { return base + L::RING + s * L::STAGE; };
  auto meta = [&](int s) { return reinterpret_cast<float*>(gbase + L::META + s * L::META_BYTES); };

  const int tid = threadIdx.x, lane = tid % 32;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int kv0 = blockIdx.z * L::BK;
  const int group = H / KH;
  const int nq = (T + L::BQ - 1) / L::BQ;
  const int nwords = (nq + 31) / 32;
  uint32_t* const seen = reinterpret_cast<uint32_t*>(gbase + L::SEEN);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 33);  // the producer's expect_tx arrival and its 32 lanes' rows
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int w = tid; w < nwords; w += NTHREADS) seen[w] = 0u;
  __syncthreads();
  // The query tiles with a valid row that sees the block's first key: each
  // warp reads 32 rows of one tile at a time, eight such reads in flight.
  const int* const qrow = qpos + static_cast<long long>(b) * T;
  for (int rb = (tid / 32) * 32; rb < T; rb += 8 * NTHREADS) {
    bool sees[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r = rb + u * NTHREADS + lane;
      sees[u] = r < T && (!causal || qrow[r] >= kv0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r0 = rb + u * NTHREADS, tile = r0 / L::BQ;
      const bool ok = sees[u];
      const bool tile_seen = __any_sync(0xffffffffu, ok);
      if (lane == 0 && tile_seen) atomicOr(&seen[tile / 32], 1u << (tile % 32));
    }
  }
  __syncthreads();
  int n_seen = 0;
  for (int w = 0; w < nwords; ++w) n_seen += __popc(seen[w]);
  const int n_tiles = group * n_seen;
  const int wg = tid / 128;

  if (wg == 2) {
    // The producer warp: lane 0 issues the loads, the warp writes the rows.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid >= 256 + 32 || n_tiles == 0) return;
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmQS)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmQ)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmG)) : "memory");
      mbar_expect_tx(kvbar, 4 * L::KV_BOX);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        tma_load_4d(base + L::K + c * L::KV_BOX, &tmK, kvbar, c * 64, kv0, kh, b);
        tma_load_4d(base + L::V + c * L::KV_BOX, &tmV, kvbar, c * 64, kv0, kh, b);
      }
    }
    // The stage and its phase run on; a tile's rows are written once its
    // stage is free (held across the wait, they spill even at 40 registers).
    int s = 0, phase = 0;
    for (int h = kh * group; h < (kh + 1) * group; ++h) {
      const float* const lse_h = lse + (static_cast<long long>(b) * H + h) * T;
      const float* const delta_h = delta + (static_cast<long long>(b) * H + h) * T;
      for (int w = 0; w < nwords; ++w) {
        uint32_t bits = seen[w];
        while (bits != 0u) {
          const int qt0 = (w * 32 + __ffs(bits) - 1) * L::BQ;
          bits &= bits - 1u;
          mbar_wait(empty(s), phase ^ 1);
          if (lane == 0) {
            const uint32_t st = stage(s);
            mbar_expect_tx(full(s), L::STAGE);
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              tma_load_4d(st + c * L::Q_BOX, &tmQS, full(s), c * 64, qt0, h, b);
              tma_load_4d(st + L::TILE + c * L::Q_BOX, &tmQ, full(s), c * 64, qt0, h, b);
              tma_load_4d(st + 2 * L::TILE + c * L::Q_BOX, &tmG, full(s), c * 64, qt0, h, b);
            }
          }
          float* const m = meta(s);
          int* const mi = reinterpret_cast<int*>(m);
          int pm = 0x7fffffff;
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int r = qt0 + 32 * k + lane;
            const bool ok = r < T;
            const int p = ok ? (causal ? qrow[r] : 0) : -1;
            m[32 * k + lane] = ok ? lse_h[r] * LOG2E : inf();
            m[L::BQ + 32 * k + lane] = ok ? delta_h[r] : 0.f;
            mi[2 * L::BQ + 32 * k + lane] = p;
            if (ok) pm = min(pm, p);
          }
          pm = __reduce_min_sync(0xffffffffu, pm);
          if (lane == 0) mi[3 * L::BQ] = pm;
          mbar_arrive(full(s));
          if (++s == STAGES) s = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns keys kv0 + 64 wg ... + 63; a thread's
  // keys are g and g + 8 of its warp's 16.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = (tid / 32) % 4;
  const int g = lane / 4, t = lane % 4;
  int key[2];
  bool kok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = kv0 + wg * 64 + warp * 16 + g + 8 * i;
    kok[i] = key[i] < S && (kvmask == nullptr || kvmask[static_cast<long long>(b) * S + key[i]] != 0);
  }
  // A q tile whose smallest valid position is at or past the warp's last
  // key needs no mask in this warp when all its keys are valid.
  const bool warp_valid = __all_sync(0xffffffffu, kok[0] && kok[1]);
  const int warp_last = kv0 + wg * 64 + warp * 16 + 15;

  float dka[64], dva[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;
  float st[32], dpt[32];
  uint32_t pf[4][4], sf[4][4];
  const uint32_t ka = base + L::K + wg * (L::KV_BOX / 2);  // this warpgroup's keys of box 0
  const uint32_t va = base + L::V + wg * (L::KV_BOX / 2);
  if (n_tiles > 0) {
    mbar_wait(kvbar, 0);
    fence_acc(dka);
    fence_acc(dva);
    bool landed = true;
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % STAGES;
      const uint32_t qst = stage(s), qt = qst + L::TILE, gt = qst + 2 * L::TILE;
      landed &= mbar_wait_bounded(full(s), (n / STAGES) & 1);
      wgmma_fence();
      issue_abt<L::KV_BOX, L::Q_BOX>(st, ka, qst);  // S^T = K Qs^T
      issue_abt<L::KV_BOX, L::Q_BOX>(dpt, va, gt);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dpt);
      const float* m = meta(s);
      const int* mi = reinterpret_cast<const int*>(m);
      const bool clean = warp_valid && (!causal || warp_last <= mi[3 * L::BQ]);
      // Element 4c + e: key g + 8 (e / 2) of the warp's, query row 8c + 2t + e % 2.
#pragma unroll
      for (int c = 0; c < L::BQ / 8; ++c) {
        const int col = 8 * c + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(m + col);
        const float2 d2 = *reinterpret_cast<const float2*>(m + L::BQ + col);
        const float lc[2] = {l2.x, l2.y}, dc[2] = {d2.x, d2.y};
        if (!clean) {
          const int2 p2 = *reinterpret_cast<const int2*>(mi + 2 * L::BQ + col);
          const int pc[2] = {p2.x, p2.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = kok[e >> 1] && (!causal || key[e >> 1] <= pc[e & 1]);
            st[4 * c + e] = ok ? st[4 * c + e] : -inf();
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(st[4 * c + e], LOG2E, -lc[e & 1]));
          st[4 * c + e] = p;
          dpt[4 * c + e] = p * (dpt[4 * c + e] - dc[e & 1]);
        }
      }
      pack_frags(st, pf);
      pack_frags(dpt, sf);
      fence_regs(pf);
      fence_regs(sf);
      wgmma_fence();
      issue_fb<L::Q_BOX>(dva, pf, gt);  // dV += round(P^T) dO
      issue_fb<L::Q_BOX>(dka, sf, qt);  // dK += round(dS^T) q
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dva);
      fence_acc(dka);
      fence_regs(pf);
      fence_regs(sf);
      if (lane == 0) mbar_arrive(empty(s));
    }
    if (!landed) __trap();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= S) continue;
    const long long off = ((static_cast<long long>(b) * S + key[i]) * KH + kh) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(dk + off + c * 8 + t * 2) =
          pack_bf16(dka[4 * c + 2 * i] * scale, dka[4 * c + 2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + c * 8 + t * 2) =
          pack_bf16(dva[4 * c + 2 * i], dva[4 * c + 2 * i + 1]);
    }
  }
}

// Shared-memory opt-in above 48 KB: once per device and kernel (idempotent,
// so two threads may both set it; not again while a CUDA graph is captured).
template <typename K>
int opt_in(K kernel, int bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    done[dev].store(true, std::memory_order_release);
  }
  return 0;
}

}  // namespace bwd
}  // namespace

// Plain C entry point for ctypes. Layouts: q, out and dout [B,T,H,D], k/v
// [B,S,KH,D] with the given element strides (the head-dim stride is 1, the
// others multiples of 8, the data 16-byte aligned); lse a contiguous f32
// [B,H,T]; qpos int32 [B,T] (read only when causal); kvmask int32 [B,S] or
// null for all-valid; dq a contiguous [B,T,H,D], dk/dv contiguous
// [B,S,KH,D], all bf16. `delta` (f32 [B,H,T]) and `qs` (bf16 [B,T,H,D]) are
// contiguous scratch the dq kernel writes and the dkv kernel reads. D is
// 128, T at most 524288. Launches the dq kernel, then the dkv kernel, on
// `stream`. Returns the CUDA error code of the launches (0 on success).
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* out,
                         const void* dout, const float* lse, float* delta, void* qs,
                         const int* qpos, const int* kvmask, void* dq, void* dk, void* dv, int B,
                         int T, int S, int H, int KH, int Dh, long long q_sb, long long q_st,
                         long long q_sh, long long k_sb, long long k_st, long long k_sh,
                         long long v_sb, long long v_st, long long v_sh, long long o_sb,
                         long long o_st, long long o_sh, long long g_sb, long long g_st,
                         long long g_sh, float scale, int causal, void* stream) {
  using namespace bwd;
  if (Dh != D || KH <= 0 || H % KH != 0 || T <= 0 || S <= 0 || T > MAX_Q_TILES * DkvSmem::BQ)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long qdims[4] = {D, T, H, B}, kdims[4] = {D, S, KH, B};
  const long long qstr[3] = {2 * q_st, 2 * q_sh, 2 * q_sb};
  const long long gstr[3] = {2 * g_st, 2 * g_sh, 2 * g_sb};
  const long long kstr[3] = {2 * k_st, 2 * k_sh, 2 * k_sb};
  const long long vstr[3] = {2 * v_st, 2 * v_sh, 2 * v_sb};
  const long long sstr[3] = {2ll * H * D, 2ll * D, 2ll * T * H * D};  // the contiguous qs
  const int box128[4] = {64, 128, 1, 1}, box64[4] = {64, 64, 1, 1};
  CUtensorMap tq, tg, tk, tv, tqs, tq64, tg64, tk128, tv128;
  int err = make_map_nd(&tq, q, 4, qdims, qstr, box128);
  if (!err) err = make_map_nd(&tg, dout, 4, qdims, gstr, box128);
  if (!err) err = make_map_nd(&tk, k, 4, kdims, kstr, box64);
  if (!err) err = make_map_nd(&tv, v, 4, kdims, vstr, box64);
  if (!err) err = make_map_nd(&tqs, qs, 4, qdims, sstr, box64);
  if (!err) err = make_map_nd(&tq64, q, 4, qdims, qstr, box64);
  if (!err) err = make_map_nd(&tg64, dout, 4, qdims, gstr, box64);
  if (!err) err = make_map_nd(&tk128, k, 4, kdims, kstr, box128);
  if (!err) err = make_map_nd(&tv128, v, 4, kdims, vstr, box128);
  if (err) return err;
  static std::atomic<bool> dq_set[kMaxDevices], dkv_set[kMaxDevices];
  err = opt_in(flash_bwd_dq, DqSmem::BYTES, dq_set);
  if (!err) err = opt_in(flash_bwd_dkv, DkvSmem::BYTES, dkv_set);
  if (err) return err;
  flash_bwd_dq<<<dim3(H, B, (T + DqSmem::BQ - 1) / DqSmem::BQ), NTHREADS, DqSmem::BYTES, st>>>(
      tq, tg, tk, tv, static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), lse, qpos, kvmask, delta,
      static_cast<__nv_bfloat16*>(qs), static_cast<__nv_bfloat16*>(dq), T, S, H, KH, o_sb, o_st,
      o_sh, g_sb, g_st, g_sh, scale, causal);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkv<<<dim3(KH, B, (S + DkvSmem::BK - 1) / DkvSmem::BK), NTHREADS, DkvSmem::BYTES,
                  st>>>(tqs, tq64, tg64, tk128, tv128, lse, delta, qpos, kvmask,
                        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), T, S, H,
                        KH, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
