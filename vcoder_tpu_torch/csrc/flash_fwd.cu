// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces the TPU kernels `_fwd_kernel` (vcoder_tpu/ops/flash_attention.py:204,
// rectangular grid) and `_fwd_kernel_tri` (:216, lower-triangle pair grid).
// It computes what they compute: online-softmax attention of q [B,T,H,D]
// against k/v [B,S,KH,D] (GQA: query head h reads KV head h / (H/KH)),
// causal by POSITION (key j is visible to query t when j <= q_positions[b,t]
// and kv_mask[b,j] is set), output in bf16 and the per-row log-sum-exp in f32
// [B,H,T] for the backward. q is scaled in f32 and rounded to bf16 before the
// QK product, exactly as `_flash_fwd` does (the backward recomputes P from that
// rounded q). A row that sees no key gives 0, not NaN (M_FLOOR and l_safe, as
// at flash_attention.py:92-95,192-197).
//
// Design. The TPU kernel walks KV blocks on a sequential grid axis and keeps
// the running max/sum/accumulator in VMEM scratch between grid steps. Hopper's
// blocks run in no order, so here one CUDA block owns one (q-tile of 64 rows,
// head, batch) and loops over 64-key tiles itself; the running statistics
// live in registers. The causal skip comes from the loop bound: the block
// stops at the largest position among its valid query rows (the rule of
// `should_compute`, flash_attention.py:128-129), which is valid for any
// positions, including a cached prefill where S > T. Ragged T and S are masked
// here, so the caller pads nothing.
//
// Each of the 4 warps owns 16 query rows. QK^T and PV run on the tensor cores
// through mma.sync m16n8k16 (bf16 in, f32 accumulate); P is rounded to bf16
// for PV like the TPU kernel's `p.astype(v.dtype)`. K is staged in shared
// memory row-major, V transposed, both with 8 elements of padding per row so
// the fragment loads hit 32 distinct banks.
//
// What bounds it on the card: at the decoder prefill (T=1280, D=128, 32
// heads) the work is ~12 GFLOP against ~40 MB, ~300 FLOP/byte, so the tensor
// cores bound it in principle. This first version issues synchronous loads
// with no double buffering and uses mma.sync rather than wgmma, so in practice
// it is bound by load latency and issue rate; TMA + wgmma + a pipelined ring
// of K/V tiles is the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per block: 4 warps x 16
constexpr int BK = 64;  // keys per KV tile
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e20f;

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

// Two neighbouring q elements, scaled in f32 and rounded back to bf16.
__device__ __forceinline__ uint32_t load_q_pair(const __nv_bfloat16* q,
                                                bool ok, float scale) {
  if (!ok) return 0u;
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(q);
  return pack_bf16(__bfloat162float(v.x) * scale,
                   __bfloat162float(v.y) * scale);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ qpos,
                     const int* __restrict__ kvmask,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int T, int S, int H, int KH, long long q_sb,
                     long long q_st, long long q_sh, long long k_sb,
                     long long k_st, long long k_sh, long long v_sb,
                     long long v_st, long long v_sh, float scale,
                     int causal) {
  constexpr int KSTR = D + 8;   // K tile row stride (elements)
  constexpr int VSTR = BK + 8;  // transposed V tile row stride
  constexpr int DK = D / 16;    // k-steps of the QK product
  constexpr int DN = D / 8;     // n-tiles of the output
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * KSTR];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * VSTR];
  __shared__ int kmask[BK];
  __shared__ int max_pos;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);

  // Query rows of this thread: r[0] = g, r[1] = g + 8 within the warp's 16.
  int row[2], pos[2];
  bool rok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + 8 * i;
    rok[i] = row[i] < T;
    // Rows past T are never stored; position 0 as the TPU wrapper gives pads.
    pos[i] = (causal && rok[i]) ? qpos[(long long)b * T + row[i]] : 0;
  }

  if (tid == 0) max_pos = 0;
  __syncthreads();
  if (causal && tid < BQ && q0 + tid < T)
    atomicMax(&max_pos, qpos[(long long)b * T + q0 + tid]);
  __syncthreads();
  const int kv_end = causal ? min(S, max_pos + 1) : S;

  // Q fragments (A operand, row-major 16 x D), kept in registers.
  uint32_t qa[DK][4];
  {
    const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
    const __nv_bfloat16* q_lo = qb + (long long)row[0] * q_st;
    const __nv_bfloat16* q_hi = qb + (long long)row[1] * q_st;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      const int c = kk * 16 + tig * 2;
      qa[kk][0] = load_q_pair(q_lo + c, rok[0], scale);
      qa[kk][1] = load_q_pair(q_hi + c, rok[1], scale);
      qa[kk][2] = load_q_pair(q_lo + c + 8, rok[0], scale);
      qa[kk][3] = load_q_pair(q_hi + c + 8, rok[1], scale);
    }
  }

  float acc[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sum

  const __nv_bfloat16* kb = k + b * k_sb + kh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kh * v_sh;

  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < BK * D / 8; c += NTHREADS) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      const int key = kv0 + r;
      uint4 kval = make_uint4(0, 0, 0, 0), vval = make_uint4(0, 0, 0, 0);
      if (key < S) {
        kval = *reinterpret_cast<const uint4*>(kb + key * k_st + col);
        vval = *reinterpret_cast<const uint4*>(vb + key * v_st + col);
      }
      *reinterpret_cast<uint4*>(&Ks[r * KSTR + col]) = kval;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vval);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(col + i) * VSTR + r] = ve[i];
    }
    if (tid < BK) {
      const int key = kv0 + tid;
      kmask[tid] = key < S ? (kvmask ? kvmask[(long long)b * S + key] : 1) : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = &Ks[(j * 8 + g) * KSTR + tig * 2];
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        mma_bf16_16816(s[j], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                       lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
    }

    // Mask, then the online-softmax update (f32).
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = j * 8 + tig * 2 + (e & 1);
        const int key = kv0 + kl;
        const int ri = e >> 1;
        const bool ok = kmask[kl] != 0 && (!causal || key <= pos[ri]);
        s[j][e] = ok ? s[j][e] : NEG_INF;
        mx[ri] = fmaxf(mx[ri], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(fmaxf(m_run[i], mx[i]), M_FLOOR);
      alpha[i] = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        s[j][e] = expf(s[j][e] - m_run[ri]);
        l_run[ri] += s[j][e];
      }
    }
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: P (bf16) from the S accumulators, V^T from shared memory.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const __nv_bfloat16* vr = &Vt[(j * 8 + g) * VSTR + kk * 16 + tig * 2];
        mma_bf16_16816(acc[j], a0, a1, a2, a3, lds32(vr), lds32(vr + 8));
      }
    }
  }

  // Finalize: the 4 threads of a row group hold partial sums of that row.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  const float l_safe[2] = {l_run[0] == 0.f ? 1.f : l_run[0],
                           l_run[1] == 0.f ? 1.f : l_run[1]};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rok[i]) continue;
    __nv_bfloat16* orow = o + (((long long)b * T + row[i]) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const float x0 = acc[j][2 * i] / l_safe[i];
      const float x1 = acc[j][2 * i + 1] / l_safe[i];
      *reinterpret_cast<uint32_t*>(orow + j * 8 + tig * 2) = pack_bf16(x0, x1);
    }
    if (tig == 0)
      lse[((long long)b * H + h) * T + row[i]] = m_run[i] + logf(l_safe[i]);
  }
}

}  // namespace

// Plain C entry point for ctypes. Layouts: q [B,T,H,D], k/v [B,S,KH,D] with
// the given element strides (the head-dim stride is 1); o is a contiguous
// [B,T,H,D]; lse a contiguous f32 [B,H,T]; qpos int32 [B,T] (read only when
// causal); kvmask int32 [B,S] or null for all-valid. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const int* qpos, const int* kvmask, void* o,
                         float* lse, int B, int T, int S, int H, int KH,
                         int D, long long q_sb, long long q_st,
                         long long q_sh, long long k_sb, long long k_st,
                         long long k_sh, long long v_sb, long long v_st,
                         long long v_sh, float scale, int causal,
                         void* stream) {
  dim3 grid((T + BQ - 1) / BQ, H, B);
  dim3 block(NTHREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  if (D == 128) {
    flash_fwd_kernel<128><<<grid, block, 0, st>>>(
        qq, kk, vv, qpos, kvmask, oo, lse, T, S, H, KH, q_sb, q_st, q_sh,
        k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, causal);
  } else if (D == 64) {
    flash_fwd_kernel<64><<<grid, block, 0, st>>>(
        qq, kk, vv, qpos, kvmask, oo, lse, T, S, H, KH, q_sb, q_st, q_sh,
        k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, causal);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
