// Flash-attention backward for Hopper (sm_90a): bf16 in and out, f32 math.
//
// Replaces the TPU kernels `_bwd_dq_kernel` (vcoder_tpu/ops/flash_attention.py
// :446) and `_bwd_dkv_kernel` (:503), launched by `_flash_bwd` (:570). It
// computes what they compute, for q [B,T,H,D], k/v [B,S,KH,D] (GQA: query head
// h reads KV head h / (H/KH)), the forward's output-gradient dO [B,T,H,D], the
// forward's per-row log-sum-exp lse [B,H,T] and delta = rowsum(dO * O) [B,H,T]
// (plain torch before the launch, as `_flash_bwd:577` is plain XLA):
//
//   P  = exp(S - lse) on visible keys, 0 elsewhere,  S = round_bf16(q*scale) K^T
//   dP = dO V^T,  dS = P * (dP - delta)
//   dQ = scale * round_bf16(dS) K
//   dV = sum over the group's query heads of round_bf16(P)^T dO
//   dK = sum over the group's query heads of scale * round_bf16(dS)^T q
//
// with every product on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate) and the roundings of the TPU kernels: q is scaled in f32 and
// rounded to bf16 before QK, exactly as the forward did (`_recompute_p:412`;
// scaling after the dot would leave P rows that do not sum to 1 under the
// saved lse); dS is rounded before both of its products (:485, :551); P is
// rounded before dV (:539). Visibility is the forward's: key j is visible to
// query t when kv_mask[b,j] is set and, if causal, j <= q_positions[b,t]. A
// row that sees no key (its lse is the forward's floor, -1e20) gets P = 0, so
// its gradients are 0, never NaN: masked entries are zeroed, not exp'd.
//
// Design. The TPU kernels walk a sequential grid axis and carry their f32 sums
// in VMEM scratch between grid steps. Hopper's blocks run in no order, so each
// block owns its output tile and loops itself; nothing is atomic, and the
// result does not depend on the schedule.
//
// * dq: one block per (64 query rows, head, batch). Each of the 4 warps owns
//   16 rows, holds its rows' scaled q and dO as A fragments in registers and
//   walks the 64-key tiles the block can see (up to the largest position of
//   its valid rows, the forward's loop bound). K and V are staged row-major
//   (the B operand of S and dP), K also transposed (the B operand of dS K).
// * dkv: one block per (64 keys, KV head, batch). Each warp owns 16 keys and
//   walks the group's query heads x 64-row query tiles (`_bwd_dkv_kernel`'s
//   fused m axis, :622-660), skipping a tile none of whose valid rows can see
//   the block's first key. It computes S^T = K q^T and dP^T = V dO^T
//   directly, so P^T and dS^T land in registers as the A operand of dV and
//   dK (the FA2 arrangement); q and dO are staged row-major and transposed.
//
// Keys are processed 16 at a time so that only one 16x16 slice of S, dP and
// dS is live in registers. Staged rows carry 8 elements of padding, so the
// fragment loads of a warp hit 32 distinct banks.
//
// What bounds it on the card: at the training shape (B=4, T=2048, 32 heads,
// D=128, causal, ~1240 valid rows) the five products over the visible pairs
// are ~0.13 TFLOP against ~0.54 GB moved once, so in principle it sits near
// the card's balance point (~0.16 ms by bytes, ~0.13 ms by operations). This
// first version loads synchronously, stages transposed tiles with scattered
// 2-byte stores, recomputes S and dP in both kernels and uses mma.sync
// rather than wgmma, so it is bound by instruction throughput and load
// latency; TMA + wgmma with K/V resident and a pipelined q/dO ring is the
// later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;  // per-device shared-memory opt-in flags

constexpr int D = 128;          // head dim: the decoder's (the tower is frozen)
constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 128;   // 4 warps x 16 rows (dq) or 16 keys (dkv)
constexpr int RSTR = D + 8;     // row-major tile stride [rows][D]
constexpr int TSTR = BQ + 8;    // transposed tile stride [D][64] (BQ == BK)
constexpr int DK = D / 16;      // k-steps over the head dim
constexpr int DN = D / 8;       // n-tiles over the head dim

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two neighbouring elements of a global row, optionally scaled in f32 and
// rounded back to bf16; 0 for a row past the end.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p, bool ok,
                                              bool scaled, float scale) {
  if (!ok) return 0u;
  const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
  if (!scaled) return raw;
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return pack_bf16(__bfloat162float(v.x) * scale,
                   __bfloat162float(v.y) * scale);
}

// Stage rows [r0, r0 + 64) of a [n_rows, D] strided operand into `rows`
// ([64][RSTR], optional; scaled and rounded when `scale` is not 1) and/or
// `tr` ([D][TSTR], transposed, unscaled). Rows past n_rows are zero.
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* base,
                                           long long row_stride, int r0,
                                           int n_rows, __nv_bfloat16* rows,
                                           __nv_bfloat16* tr, float scale) {
  for (int c = threadIdx.x; c < 64 * D / 8; c += NTHREADS) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(base + (r0 + r) * row_stride + col);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
    if (tr != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[(col + i) * TSTR + r] = e[i];
    }
    if (rows != nullptr) {
      if (scale != 1.f) {
        uint4 s;
        uint32_t* sw = reinterpret_cast<uint32_t*>(&s);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sw[i] = pack_bf16(__bfloat162float(e[2 * i]) * scale,
                            __bfloat162float(e[2 * i + 1]) * scale);
        val = s;
      }
      *reinterpret_cast<uint4*>(&rows[r * RSTR + col]) = val;
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ qpos,
                        const int* __restrict__ kvmask,
                        __nv_bfloat16* __restrict__ dq, int T, int S, int H,
                        int KH, long long q_sb, long long q_st, long long q_sh,
                        long long k_sb, long long k_st, long long k_sh,
                        long long v_sb, long long v_st, long long v_sh,
                        long long o_sb, long long o_st, long long o_sh,
                        float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [BK][RSTR]
  __nv_bfloat16* Vs = Ks + BK * RSTR;                          // [BK][RSTR]
  __nv_bfloat16* Kt = Vs + BK * RSTR;                          // [D][TSTR]
  int* kmask = reinterpret_cast<int*>(Kt + D * TSTR);          // [BK]
  __shared__ int max_pos;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);

  // This thread's rows: warp * 16 + g and + 8.
  int row[2], pos[2];
  bool rok[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + 8 * i;
    rok[i] = row[i] < T;
    pos[i] = (causal && rok[i]) ? qpos[(long long)b * T + row[i]] : 0;
    const long long li = ((long long)b * H + h) * T + row[i];
    lse_r[i] = rok[i] ? lse[li] : 0.f;
    delta_r[i] = rok[i] ? delta[li] : 0.f;
  }

  if (tid == 0) max_pos = 0;
  __syncthreads();
  if (causal && tid < BQ && q0 + tid < T)
    atomicMax(&max_pos, qpos[(long long)b * T + q0 + tid]);
  __syncthreads();
  const int kv_end = causal ? min(S, max_pos + 1) : S;

  // A fragments of the scaled q and of dO for this warp's 16 rows.
  uint32_t qa[DK][4], da[DK][4];
  {
    const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
    const __nv_bfloat16* ob = dout + b * o_sb + h * o_sh;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      const int c = kk * 16 + tig * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cc = c + 8 * half;
        qa[kk][2 * half] = load_pair(qb + row[0] * q_st + cc, rok[0], true, scale);
        qa[kk][2 * half + 1] = load_pair(qb + row[1] * q_st + cc, rok[1], true, scale);
        da[kk][2 * half] = load_pair(ob + row[0] * o_st + cc, rok[0], false, 1.f);
        da[kk][2 * half + 1] = load_pair(ob + row[1] * o_st + cc, rok[1], false, 1.f);
      }
    }
  }

  float acc[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const __nv_bfloat16* kb = k + b * k_sb + kh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kh * v_sh;

  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    stage_tile(kb, k_st, kv0, S, Ks, Kt, 1.f);
    stage_tile(vb, v_st, kv0, S, Vs, nullptr, 1.f);
    if (tid < BK) {
      const int key = kv0 + tid;
      kmask[tid] = key < S ? (kvmask ? kvmask[(long long)b * S + key] : 1) : 0;
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < BK / 16; ++c) {
      // S and dP for this warp's 16 rows x 16 keys (two n8 tiles).
      float s[2][4], dp[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
        dp[t][0] = dp[t][1] = dp[t][2] = dp[t][3] = 0.f;
        const __nv_bfloat16* kr = &Ks[(16 * c + 8 * t + g) * RSTR + tig * 2];
        const __nv_bfloat16* vr = &Vs[(16 * c + 8 * t + g) * RSTR + tig * 2];
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          mma_bf16_16816(s[t], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                         lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
          mma_bf16_16816(dp[t], da[kk][0], da[kk][1], da[kk][2], da[kk][3],
                         lds32(vr + kk * 16), lds32(vr + kk * 16 + 8));
        }
      }
      // dS = P * (dP - delta), P recomputed from the saved lse.
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = 16 * c + 8 * t + tig * 2 + (e & 1);
          const int ri = e >> 1;
          const bool ok = kmask[kl] != 0 && (!causal || kv0 + kl <= pos[ri]);
          const float p = ok ? expf(s[t][e] - lse_r[ri]) : 0.f;
          s[t][e] = p * (dp[t][e] - delta_r[ri]);
        }
      }
      const uint32_t a0 = pack_bf16(s[0][0], s[0][1]);
      const uint32_t a1 = pack_bf16(s[0][2], s[0][3]);
      const uint32_t a2 = pack_bf16(s[1][0], s[1][1]);
      const uint32_t a3 = pack_bf16(s[1][2], s[1][3]);
      // dQ += dS K over these 16 keys: K^T from the transposed tile.
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const __nv_bfloat16* kt = &Kt[(j * 8 + g) * TSTR + 16 * c + tig * 2];
        mma_bf16_16816(acc[j], a0, a1, a2, a3, lds32(kt), lds32(kt + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rok[i]) continue;
    __nv_bfloat16* drow = dq + (((long long)b * T + row[i]) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DN; ++j)
      *reinterpret_cast<uint32_t*>(drow + j * 8 + tig * 2) =
          pack_bf16(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ qpos,
                         const int* __restrict__ kvmask,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int T, int S, int H,
                         int KH, long long q_sb, long long q_st,
                         long long q_sh, long long k_sb, long long k_st,
                         long long k_sh, long long v_sb, long long v_st,
                         long long v_sh, long long o_sb, long long o_st,
                         long long o_sh, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [BK][RSTR]
  __nv_bfloat16* Vs = Ks + BK * RSTR;                          // [BK][RSTR]
  __nv_bfloat16* Qs = Vs + BK * RSTR;    // [BQ][RSTR] scaled, rounded q
  __nv_bfloat16* Os = Qs + BQ * RSTR;    // [BQ][RSTR] dO
  __nv_bfloat16* Qt = Os + BQ * RSTR;    // [D][TSTR] q, unscaled
  __nv_bfloat16* Ot = Qt + D * TSTR;     // [D][TSTR] dO
  float* lse_s = reinterpret_cast<float*>(Ot + D * TSTR);  // [BQ]
  float* delta_s = lse_s + BQ;                             // [BQ]
  int* pos_s = reinterpret_cast<int*>(delta_s + BQ);       // [BQ]
  int* rok_s = pos_s + BQ;                                 // [BQ]
  int* kmask = rok_s + BQ;                                 // [BK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int kv0 = blockIdx.x * BK;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int group = H / KH;

  stage_tile(k + b * k_sb + kh * k_sh, k_st, kv0, S, Ks, nullptr, 1.f);
  stage_tile(v + b * v_sb + kh * v_sh, v_st, kv0, S, Vs, nullptr, 1.f);
  if (tid < BK) {
    const int key = kv0 + tid;
    kmask[tid] = key < S ? (kvmask ? kvmask[(long long)b * S + key] : 1) : 0;
  }

  float dk_acc[DN][4], dv_acc[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }
  const int kr = warp * 16 + g;  // this thread's keys: kr and kr + 8 (local)

#pragma unroll 1
  for (int hq = 0; hq < group; ++hq) {
    const int h = kh * group + hq;
    const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
    const __nv_bfloat16* ob = dout + b * o_sb + h * o_sh;
#pragma unroll 1
    for (int q0 = 0; q0 < T; q0 += BQ) {
      // Skip a query tile none of whose valid rows sees this key tile.
      const bool sees = !causal || (tid < BQ && q0 + tid < T &&
                                    qpos[(long long)b * T + q0 + tid] >= kv0);
      if (!__syncthreads_or(sees)) continue;
      stage_tile(qb, q_st, q0, T, Qs, Qt, scale);
      stage_tile(ob, o_st, q0, T, Os, Ot, 1.f);
      if (tid < BQ) {
        const int r = q0 + tid;
        const bool ok = r < T;
        const long long li = ((long long)b * H + h) * T + r;
        rok_s[tid] = ok;
        pos_s[tid] = (causal && ok) ? qpos[(long long)b * T + r] : 0;
        lse_s[tid] = ok ? lse[li] : 0.f;
        delta_s[tid] = ok ? delta[li] : 0.f;
      }
      __syncthreads();

#pragma unroll 1
      for (int c = 0; c < BQ / 16; ++c) {
        // S^T = K q^T and dP^T = V dO^T for 16 keys x 16 query rows.
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          st[t][0] = st[t][1] = st[t][2] = st[t][3] = 0.f;
          dpt[t][0] = dpt[t][1] = dpt[t][2] = dpt[t][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          const __nv_bfloat16* ka = &Ks[kr * RSTR + kk * 16 + tig * 2];
          const __nv_bfloat16* va = &Vs[kr * RSTR + kk * 16 + tig * 2];
          const uint32_t k0 = lds32(ka), k1 = lds32(ka + 8 * RSTR),
                         k2 = lds32(ka + 8), k3 = lds32(ka + 8 * RSTR + 8);
          const uint32_t v0 = lds32(va), v1 = lds32(va + 8 * RSTR),
                         v2 = lds32(va + 8), v3 = lds32(va + 8 * RSTR + 8);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int qr = 16 * c + 8 * t + g;
            const __nv_bfloat16* qp = &Qs[qr * RSTR + kk * 16 + tig * 2];
            const __nv_bfloat16* op = &Os[qr * RSTR + kk * 16 + tig * 2];
            mma_bf16_16816(st[t], k0, k1, k2, k3, lds32(qp), lds32(qp + 8));
            mma_bf16_16816(dpt[t], v0, v1, v2, v3, lds32(op), lds32(op + 8));
          }
        }
        // P^T and dS^T; element e of tile t is key kr + 8 * (e >> 1), query
        // row 16c + 8t + 2 tig + (e & 1).
#pragma unroll
        for (int t = 0; t < 2; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = 16 * c + 8 * t + tig * 2 + (e & 1);
            const int kl = kr + 8 * (e >> 1);
            const bool ok = rok_s[ql] && kmask[kl] != 0 &&
                            (!causal || kv0 + kl <= pos_s[ql]);
            const float p = ok ? expf(st[t][e] - lse_s[ql]) : 0.f;
            st[t][e] = p;
            dpt[t][e] = p * (dpt[t][e] - delta_s[ql]);
          }
        }
        const uint32_t p0 = pack_bf16(st[0][0], st[0][1]);
        const uint32_t p1 = pack_bf16(st[0][2], st[0][3]);
        const uint32_t p2 = pack_bf16(st[1][0], st[1][1]);
        const uint32_t p3 = pack_bf16(st[1][2], st[1][3]);
        const uint32_t s0 = pack_bf16(dpt[0][0], dpt[0][1]);
        const uint32_t s1 = pack_bf16(dpt[0][2], dpt[0][3]);
        const uint32_t s2 = pack_bf16(dpt[1][0], dpt[1][1]);
        const uint32_t s3 = pack_bf16(dpt[1][2], dpt[1][3]);
        // dV += P^T dO and dK += dS^T q over these 16 query rows.
#pragma unroll
        for (int j = 0; j < DN; ++j) {
          const __nv_bfloat16* ot = &Ot[(j * 8 + g) * TSTR + 16 * c + tig * 2];
          const __nv_bfloat16* qt = &Qt[(j * 8 + g) * TSTR + 16 * c + tig * 2];
          mma_bf16_16816(dv_acc[j], p0, p1, p2, p3, lds32(ot), lds32(ot + 8));
          mma_bf16_16816(dk_acc[j], s0, s1, s2, s3, lds32(qt), lds32(qt + 8));
        }
      }
      __syncthreads();  // the tile's readers are done before the next staging
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kv0 + kr + 8 * i;
    if (key >= S) continue;
    const long long off = (((long long)b * S + key) * KH + kh) * D;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + j * 8 + tig * 2) =
          pack_bf16(dk_acc[j][2 * i] * scale, dk_acc[j][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + j * 8 + tig * 2) =
          pack_bf16(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

constexpr int DQ_SMEM = (2 * BK * RSTR + D * TSTR) * 2 + BK * 4;
constexpr int DKV_SMEM =
    (2 * BK * RSTR + 2 * BQ * RSTR + 2 * D * TSTR) * 2 + 4 * BQ * 4 + BK * 4;

}  // namespace

// Plain C entry point for ctypes. Layouts: q and dout [B,T,H,D], k/v
// [B,S,KH,D] with the given element strides (the head-dim stride is 1, the
// others multiples of 8); lse and delta contiguous f32 [B,H,T]; qpos int32
// [B,T] (read only when causal); kvmask int32 [B,S] or null for all-valid;
// dq a contiguous [B,T,H,D], dk/dv contiguous [B,S,KH,D], all bf16. Launches
// the dq kernel, then the dkv kernel, on `stream`. Returns the CUDA error
// code of the launches (0 on success).
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, const int* qpos,
                         const int* kvmask, void* dq, void* dk, void* dv,
                         int B, int T, int S, int H, int KH, int Dh,
                         long long q_sb, long long q_st, long long q_sh,
                         long long k_sb, long long k_st, long long k_sh,
                         long long v_sb, long long v_st, long long v_sh,
                         long long o_sb, long long o_st, long long o_sh,
                         float scale, int causal, void* stream) {
  if (Dh != D || H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  const auto* oo = static_cast<const __nv_bfloat16*>(dout);
  // Over 48 KB of dynamic shared memory needs the opt-in, which holds per
  // device: set once for each (not again while a CUDA graph is being
  // captured). Two threads may both set it; the call is idempotent.
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DQ_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DKV_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev].store(true, std::memory_order_release);
  }
  flash_bwd_dq_kernel<<<dim3((T + BQ - 1) / BQ, H, B), NTHREADS, DQ_SMEM, st>>>(
      qq, kk, vv, oo, lse, delta, qpos, kvmask,
      static_cast<__nv_bfloat16*>(dq), T, S, H, KH, q_sb, q_st, q_sh, k_sb,
      k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<<<dim3((S + BK - 1) / BK, KH, B), NTHREADS, DKV_SMEM,
                         st>>>(
      qq, kk, vv, oo, lse, delta, qpos, kvmask,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), T, S,
      H, KH, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st,
      o_sh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
