// int8 x int8 -> int32 GEMM for Hopper (sm_90a), with an optional
// row x column scale epilogue.
//
//   C[M,N] = A[M,K] @ B[K,N]                        (s32, exact)
//   Y[M,N] = out_dtype( (float(C) * sa[M,1]) * sb[1,N] )   (SCALED)
//
// Port of `_mm_kernel` (scripts/bench_int8_matmul.py:76) and
// `_mm_scaled_kernel` (:92), one source templated on the epilogue. On the
// TPU they run a (M/bm, N/bn, K/bk) grid whose sequential K axis carries an
// s32 accumulator in VMEM; the scaled form multiplies by sa*sb at the last K
// step. Here a block owns a 128 x 128 output tile and walks K itself, the
// accumulator living in registers. The scaled form is the W8A8 prefill
// product of ops/quant.py, so its epilogue multiplies in that path's order,
// (acc * sa) * sb, with each product rounded in f32 and the result rounded
// to bf16 once: the plain version reproduces it bit for bit.
//
// What bounds it on the card: operations. At the 7B prefill (M = 1280,
// K = 4096, N = 11008) the product is 115.4 GOP over ~79 MB, 0.058 ms at the
// H100's 1,979 dense int8 TOP/s against 0.023 ms for the bytes.
//
// What the design does about it:
// - Tensor cores through mma.sync.m16n8k32 (s8 x s8 -> s32). 8 warps in a
//   2 x 4 layout, each computing 64 x 32 of the tile (16 MMAs per 32-deep K
//   step, 64 s32 accumulators per thread). Fragments come from shared
//   memory through ldmatrix.x4, reading int8 pairs as 16-bit elements:
//   four instructions give a warp's A fragments and two its B fragments
//   for 16 MMAs.
// - The layout trap: the MMA wants B fragments contiguous in K, but the
//   weight is [K, N] with N contiguous (the layout every quantized leaf
//   keeps), and ldmatrix.trans moves 16-bit elements only. So B is
//   transposed while it is staged: each thread loads a 4 (k) x 4 (n) byte
//   block as four 32-bit words, transposes it in registers with four pairs
//   of PRMTs, and stores four words that are each 4 consecutive k of one n.
// - Shared rows are padded to 80 bytes, so the eight 16-byte rows of each
//   ldmatrix matrix hit distinct banks, and so do the transposed stores.
// - K advances 64 at a time through two shared-memory stages: the next
//   tile's global loads are issued before the current tile's MMAs and
//   stored into the other stage after them, with one barrier per step.
// - Ragged edges (M = 1201 of 1280 or 1731, N = 32000 or 11008, any K) load
//   zeros and mask the stores; 16-byte A loads and 4-byte B loads where K
//   and N allow, byte loads otherwise.
// There is no cp.async/TMA ring and no wgmma yet, so it runs well short of
// the int8 peak; those are the later steps.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int STR = BK + 16;  // bytes per shared row
constexpr int NTHREADS = 256;

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of 16-bit elements (here: 8 rows x 16 int8 bytes);
// lanes 8j..8j+7 give the row addresses of matrix j, and every lane
// receives, in r[j], bytes 4*(lane%4)..+3 of row lane/4 of matrix j.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const int8_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16 bytes of row `gr` of A from column gk (zeros past M or K).
__device__ __forceinline__ uint4 load_a(const int8_t* __restrict__ A, int gr,
                                        int gk, int M, int K, bool vec) {
  if (gr >= M || gk >= K) return make_uint4(0u, 0u, 0u, 0u);
  const int8_t* p = A + (long long)gr * K + gk;
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < 16 && gk + j < K; ++j)
    w[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 4 bytes of row gk of B from column gn (zeros past K or N).
__device__ __forceinline__ uint32_t load_b(const int8_t* __restrict__ Bm,
                                           int gk, int gn, int K, int N,
                                           bool vec) {
  if (gk >= K || gn >= N) return 0u;
  const int8_t* p = Bm + (long long)gk * N + gn;
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0u;
  for (int j = 0; j < 4 && gn + j < N; ++j)
    w |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * j);
  return w;
}

template <bool SCALED>
__global__ void __launch_bounds__(NTHREADS)
    int8_mm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bm,
                   const float* __restrict__ sa, const float* __restrict__ sb,
                   void* __restrict__ C, int M, int N, int K, int out_kind,
                   int vec_a, int vec_b) {
  __shared__ __align__(16) int8_t As[2][BM * STR];
  __shared__ __align__(16) int8_t Bs[2][BN * STR];  // B transposed: [n][k]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  // Staging roles, two of each per thread: A rows and 16-byte chunks; B
  // 4 (k) x 4 (n) byte blocks, k quads (lane & 7) + 8h, n quad of the lane.
  const int a_row = tid >> 2, a_k = (tid & 3) * 16;  // + 64 rows for the 2nd
  const int b_kq = lane & 7, b_nq = warp * 4 + (lane >> 3);
  // ldmatrix row of this lane: matrix j = lane / 8, row lane % 8.
  const int lj = lane >> 3, lr = lane & 7;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  uint4 ra[2];
  uint32_t rb[2][4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ra[h] = load_a(A, m_blk + a_row + 64 * h, k0 + a_k, M, K, vec_a);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rb[h][i] = load_b(Bm, k0 + (b_kq + 8 * h) * 4 + i, n_blk + b_nq * 4, K,
                          N, vec_b);
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<uint4*>(&As[buf][(a_row + 64 * h) * STR + a_k]) = ra[h];
      // rb[h][i] holds n0..n3 of row k_i; store n_j's k0..k3 as one word.
      const uint32_t t0 = __byte_perm(rb[h][0], rb[h][1], 0x5140);
      const uint32_t t1 = __byte_perm(rb[h][2], rb[h][3], 0x5140);
      const uint32_t t2 = __byte_perm(rb[h][0], rb[h][1], 0x7362);
      const uint32_t t3 = __byte_perm(rb[h][2], rb[h][3], 0x7362);
      int8_t* dst = &Bs[buf][(b_nq * 4) * STR + (b_kq + 8 * h) * 4];
      *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t1, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + STR) = __byte_perm(t0, t1, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * STR) = __byte_perm(t2, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * STR) = __byte_perm(t2, t3, 0x7632);
    }
  };

  fetch(0);
  stage(0);
  __syncthreads();
  for (int k0 = 0, buf = 0; k0 < K; k0 += BK, buf ^= 1) {
    const bool more = k0 + BK < K;
    if (more) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(a[mt], &As[buf][(wm + mt * 16 + (lj & 1) * 8 + lr) * STR + kk +
                                (lj >> 1) * 16]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, &Bs[buf][(wn + np * 16 + (lj >> 1) * 8 + lr) * STR + kk +
                            (lj & 1) * 16]);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          mma_s8_16832(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3],
                       b[nt][0], b[nt][1]);
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
  }

  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m_blk + wm + mt * 16 + g + (i >= 2 ? 8 : 0);
        const int c = n_blk + wn + nt * 8 + tig * 2 + (i & 1);
        if (r >= M || c >= N) continue;
        const long long o = (long long)r * N + c;
        if (!SCALED) {
          static_cast<int*>(C)[o] = acc[mt][nt][i];
        } else {
          const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][i]), sa[r]),
                                    sb[c]);
          if (out_kind == 0)
            static_cast<__nv_bfloat16*>(C)[o] = __float2bfloat16_rn(v);
          else if (out_kind == 1)
            static_cast<__half*>(C)[o] = __float2half_rn(v);
          else
            static_cast<float*>(C)[o] = v;
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. A [M,K] and B [K,N] are contiguous int8;
// sa [M] and sb [N] f32 (null for the s32 form); C [M,N] contiguous: s32, or
// with `scaled` bf16 (out_kind 0), f16 (1) or f32 (2). Returns the CUDA error
// code of the launch.
extern "C" int int8_mm(const void* A, const void* Bm, const void* sa,
                       const void* sb, void* C, int M, int N, int K, int scaled,
                       int out_kind, void* stream) {
  const int vec_a = (K % 16 == 0) && (reinterpret_cast<uintptr_t>(A) % 16 == 0);
  const int vec_b = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(Bm) % 4 == 0);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* b = static_cast<const int8_t*>(Bm);
  if (scaled)
    int8_mm_kernel<true><<<grid, NTHREADS, 0, st>>>(
        a, b, static_cast<const float*>(sa), static_cast<const float*>(sb), C,
        M, N, K, out_kind, vec_a, vec_b);
  else
    int8_mm_kernel<false><<<grid, NTHREADS, 0, st>>>(
        a, b, nullptr, nullptr, C, M, N, K, out_kind, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}
