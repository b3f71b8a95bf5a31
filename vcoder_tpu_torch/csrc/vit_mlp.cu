// The CLIP MLP half-block, for Hopper (sm_90a):
//
//   y = bf16( x + fc2( bf16(quick_gelu(fc1(LN2(x)) + b1)) ) + b2 )
//
// Port of the TPU kernel `_mlp_kernel` (vcoder_tpu/ops/vit_attention.py:154,
// wrapper `fused_block_mlp:191`). That kernel keeps the [T, I] GELU
// intermediate in VMEM one i_block stripe at a time and accumulates fc2 over
// a SEQUENTIAL grid axis of I stripes. Hopper's blocks run in no order, so
// the port is three launches: a LayerNorm kernel, a GEMM whose epilogue adds
// the fc1 bias and applies quick-GELU in f32, and a GEMM whose epilogue adds
// the residual and the fc2 bias. It keeps the TPU kernel's roundings
// exactly: LN statistics in f32 and the normalized row rounded once to bf16
// (vit_attention.py:161-166); fc1 accumulated in f32, plus the bias, GELU in
// f32 (:170-175); the GELU output rounded to bf16 before fc2 (:176-180); fc2
// accumulated in f32 over all of I in one accumulator per output element
// (the TPU sums i_block stripes; the order within f32 is immaterial within
// tolerance); y = (x + acc) + b2 in f32, rounded once (:184-185). T stays
// 577 rows per image (the TPU's 584-row pad was a sublane rule); the GEMMs
// mask the ragged edge.
//
// The weights are read in their parameter layout, fc1 [Dm, I] and fc2
// [I, Dm] (N contiguous), so no transpose is made per call: the B tile is
// stored in shared memory as loaded, [k][n], and each tensor-core fragment
// comes out transposed through ldmatrix.trans. Block tile 64 x 128, K step
// 32, 4 warps in a 2 x 2 layout, each warp 32 x 64 through mma.sync
// m16n8k16 (bf16 in, f32 accumulate).
//
// What bounds it on the card: at the tower's shapes (M = 3 x 577 = 1731
// rows, Dm = 1024, I = 4096) the two products are 4 M Dm I = 29 GFLOP over
// ~28 MB of operands and outputs, far past the H100's ~295 FLOP/byte
// ridge: the tensor cores bound it (~0.029 ms at 989 TFLOP/s). The bf16
// [M, I] intermediate (14 MB) makes one round trip through L2/HBM that the
// TPU kernel kept in VMEM; it is small next to the products' time here. This
// first version has no cp.async/TMA pipeline and no wgmma, so it is bound by
// shared-memory latency and mma.sync issue; a multistage TMA + wgmma pipeline
// (and fusing fc2 behind fc1 per row tile) is the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BKK = 32;
constexpr int ASTR = BKK + 8;  // A tile row: 32 k + 8 pad (bf16)
constexpr int BSTR = BN + 8;   // B tile row: 128 n + 8 pad (bf16)
constexpr int NTHREADS = 128;

enum Epilogue { kBiasGelu = 0, kResidualBias = 1 };

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

// Four 8x8 bf16 matrices from shared memory, transposed: lane l gives the
// row address of matrix l / 8. With rows k of a [k][n] tile, matrix i's
// register is the B fragment {B[2t][g], B[2t+1][g]} of mma.m16n8k16.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red is reused between calls
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NTHREADS / 32; ++w) s += red[w];
  return s;
}

// LN2 of one row per block: f32 mean and population variance, the
// normalized row times the scale plus the bias in f32, rounded once.
__global__ void __launch_bounds__(NTHREADS)
    ln_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ s,
              const float* __restrict__ bias, __nv_bfloat16* __restrict__ h,
              int Dm, float eps) {
  __shared__ float red[NTHREADS / 32];
  const __nv_bfloat16* xr = x + (long long)blockIdx.x * Dm;
  __nv_bfloat16* hr = h + (long long)blockIdx.x * Dm;
  float sum = 0.f;
  for (int i = threadIdx.x; i < Dm; i += NTHREADS) sum += __bfloat162float(xr[i]);
  const float mean = block_sum(sum, red) / Dm;
  float sq = 0.f;
  for (int i = threadIdx.x; i < Dm; i += NTHREADS) {
    const float d = __bfloat162float(xr[i]) - mean;
    sq = fmaf(d, d, sq);
  }
  const float rstd = rsqrtf(block_sum(sq, red) / Dm + eps);
  for (int i = threadIdx.x; i < Dm; i += NTHREADS)
    hr[i] = __float2bfloat16((__bfloat162float(xr[i]) - mean) * rstd * s[i] + bias[i]);
}

// C[M,N] = epilogue(A[M,K] @ B[K,N]): A and B bf16 row-major, f32 sums.
// kBiasGelu: C = bf16(quick_gelu(acc + bias)); kResidualBias:
// C = bf16((R + acc) + bias), R bf16 [M,N].
template <int EPI>
__global__ void __launch_bounds__(NTHREADS)
    gemm_kernel(const __nv_bfloat16* __restrict__ A,
                const __nv_bfloat16* __restrict__ B,
                const float* __restrict__ bias,
                const __nv_bfloat16* __restrict__ R,
                __nv_bfloat16* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 As[BM * ASTR];
  __shared__ __align__(16) __nv_bfloat16 Bs[BKK * BSTR];

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
    // 16-byte chunks: A tile 64 x 32 (256 chunks), B tile 32 x 128 (512).
    for (int c = tid; c < BM * BKK / 8; c += NTHREADS) {
      const int r = c >> 2, kc = (c & 3) * 8;
      const int gr = m_blk + r, gk = k0 + kc;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gr < M && gk < K)
        val = *reinterpret_cast<const uint4*>(A + (long long)gr * K + gk);
      *reinterpret_cast<uint4*>(&As[r * ASTR + kc]) = val;
    }
    for (int c = tid; c < BKK * BN / 8; c += NTHREADS) {
      const int r = c >> 4, nc = (c & 15) * 8;
      const int gk = k0 + r, gn = n_blk + nc;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gk < K && gn < N)
        val = *reinterpret_cast<const uint4*>(B + (long long)gk * N + gn);
      *reinterpret_cast<uint4*>(&Bs[r * BSTR + nc]) = val;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BKK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* ar = &As[(wm + mt * 16 + g) * ASTR + kk + tig * 2];
        a[mt][0] = lds32(ar);
        a[mt][1] = lds32(ar + 8 * ASTR);
        a[mt][2] = lds32(ar + 8);
        a[mt][3] = lds32(ar + 8 * ASTR + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        // Matrices 0/1: rows kk..kk+15 of n-tile nt; 2/3: of n-tile nt + 1.
        uint32_t b[4];
        ldsm_x4_trans(b, &Bs[(kk + (lane & 15)) * BSTR + wn + nt * 8 + (lane >> 4) * 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16_16816(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[0], b[1]);
          mma_bf16_16816(acc[mt][nt + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[2],
                         b[3]);
        }
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
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m_blk + wm + mt * 16 + g + half * 8;
        if (row >= M) continue;
        float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        const long long o = (long long)row * N + col;
        if (EPI == kBiasGelu) {
          v0 += b0;
          v1 += b1;
          v0 = v0 * (1.f / (1.f + expf(-1.702f * v0)));
          v1 = v1 * (1.f / (1.f + expf(-1.702f * v1)));
        } else {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(R + o));
          v0 = (r.x + v0) + b0;
          v1 = (r.y + v1) + b1;
        }
        *reinterpret_cast<uint32_t*>(C + o) = pack_bf16(v0, v1);
      }
    }
  }
}

}  // namespace

// Plain C entry point for ctypes: the three launches of one MLP half-block.
// x [M, Dm], fc1 [Dm, I], fc2 [I, Dm], y [M, Dm] contiguous bf16; ln_s,
// ln_b, b2 f32 [Dm], b1 f32 [I]; h [M, Dm] and g [M, I] bf16 scratch from the
// caller. Dm and I must be multiples of 8 and the bf16 buffers 16-byte
// aligned (checked by the Python wrapper). Returns the first launch's CUDA
// error, or 0.
extern "C" int vit_mlp(const void* x, const float* ln_s, const float* ln_b,
                       const void* fc1, const float* b1, const void* fc2,
                       const float* b2, void* h, void* g, void* y, int M,
                       int Dm, int I, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* hb = static_cast<__nv_bfloat16*>(h);
  __nv_bfloat16* gb = static_cast<__nv_bfloat16*>(g);
  ln_kernel<<<M, NTHREADS, 0, st>>>(xb, ln_s, ln_b, hb, Dm, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_kernel<kBiasGelu><<<dim3((I + BN - 1) / BN, (M + BM - 1) / BM), NTHREADS, 0, st>>>(
      hb, static_cast<const __nv_bfloat16*>(fc1), b1, nullptr, gb, M, I, Dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_kernel<kResidualBias><<<dim3((Dm + BN - 1) / BN, (M + BM - 1) / BM), NTHREADS, 0, st>>>(
      gb, static_cast<const __nv_bfloat16*>(fc2), b2, xb,
      static_cast<__nv_bfloat16*>(y), M, Dm, I);
  return static_cast<int>(cudaGetLastError());
}
