// bf16 GEMM with an optional f32 bias, f32 accumulation, for Hopper (sm_90a).
//
//   C[M,N] = bf16( A[M,K] @ W[N,K]^T + bias[N] )
//
// Part of the port of the TPU kernel `_block_kernel`
// (vcoder_tpu/ops/vit_attention.py:52), the fused CLIP attention block. That
// kernel runs the QKV projection, the bidirectional attention and the
// out-projection in one body, accumulating the out-projection over a
// SEQUENTIAL head-group grid axis in VMEM (vit_attention.py:88,94-96).
// Hopper's blocks run in no order, so the port splits the block into three
// launches: this GEMM for the QKV projection (bias added in f32, then rounded
// to bf16 as at vit_attention.py:62-67), the flash forward of flash_fwd.cu
// (head dim 64, not causal), and this GEMM again for the out-projection over
// all H*dh inputs at once (no bias: the caller adds the out bias and the
// residual, as on the TPU). The out-projection therefore sums in one f32
// accumulator per output element instead of over head groups.
//
// W is given as [N, K] (output-major, the nn.Linear layout), so both operands
// are K-contiguous and every tensor-core fragment is one 32-bit shared-memory
// load. Block tile 64 x 128, K step 32, 4 warps in a 2 x 2 layout, each warp
// 32 x 64 through mma.sync m16n8k16 (bf16 in, f32 accumulate). Rows of the
// shared tiles carry 8 elements of padding so fragment loads hit distinct
// banks.
//
// What bounds it on the card: at the tower's shapes (M = 3 x 577 rows,
// K = 1024, N = 3072 or 1024) the GEMM does ~10.9 GFLOP over ~10 MB, far past
// the H100's ~295 FLOP/byte ridge, so the tensor cores bound it. This first
// version has no cp.async/TMA pipeline and no wgmma, so it is bound by
// shared-memory load latency and mma.sync issue; a multistage TMA + wgmma
// pipeline is the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BKK = 32;
constexpr int STR = BKK + 8;
constexpr int NTHREADS = 128;

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

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(NTHREADS)
    gemm_bias_kernel(const __nv_bfloat16* __restrict__ A,
                     const __nv_bfloat16* __restrict__ W,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 As[BM * STR];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN * STR];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BKK) {
    // 16-byte chunks: A tile 64 x 32 (256 chunks), W tile 128 x 32 (512).
    for (int c = tid; c < BM * BKK / 8; c += NTHREADS) {
      const int r = c >> 2, kc = (c & 3) * 8;
      const int gr = m_blk + r, gk = k0 + kc;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gr < M && gk < K)
        val = *reinterpret_cast<const uint4*>(A + (long long)gr * K + gk);
      *reinterpret_cast<uint4*>(&As[r * STR + kc]) = val;
    }
    for (int c = tid; c < BN * BKK / 8; c += NTHREADS) {
      const int r = c >> 2, kc = (c & 3) * 8;
      const int gn = n_blk + r, gk = k0 + kc;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gn < N && gk < K)
        val = *reinterpret_cast<const uint4*>(W + (long long)gn * K + gk);
      *reinterpret_cast<uint4*>(&Bs[r * STR + kc]) = val;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BKK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* ar = &As[(wm + mt * 16 + g) * STR + kk + tig * 2];
        a[mt][0] = lds32(ar);
        a[mt][1] = lds32(ar + 8 * STR);
        a[mt][2] = lds32(ar + 8);
        a[mt][3] = lds32(ar + 8 * STR + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* br = &Bs[(wn + nt * 8 + g) * STR + kk + tig * 2];
        const uint32_t b0 = lds32(br), b1 = lds32(br + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16_16816(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3],
                         b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = n_blk + wn + nt * 8 + tig * 2;
      if (col >= N) continue;
      const float b0 = bias ? bias[col] : 0.f;
      const float b1 = bias ? bias[col + 1] : 0.f;
      const int r0 = m_blk + wm + mt * 16 + g;
      if (r0 < M)
        *reinterpret_cast<uint32_t*>(C + (long long)r0 * N + col) =
            pack_bf16(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
      if (r0 + 8 < M)
        *reinterpret_cast<uint32_t*>(C + (long long)(r0 + 8) * N + col) =
            pack_bf16(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. A [M,K], W [N,K] and C [M,N] are contiguous
// bf16; bias is f32 [N] or null. K and N must be multiples of 8 (checked by
// the Python wrapper). Returns the CUDA error code of the launch.
extern "C" int gemm_bias(const void* A, const void* W, const float* bias,
                         void* C, int M, int N, int K, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bias_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(A),
      static_cast<const __nv_bfloat16*>(W), bias,
      static_cast<__nv_bfloat16*>(C), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
