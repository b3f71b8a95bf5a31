// The CLIP MLP half-block, for Hopper (sm_90a):
//
//   y = bf16( x + fc2( bf16(quick_gelu(fc1(LN2(x)) + b1)) ) + b2 )
//
// Port of the TPU kernel `_mlp_kernel` (vcoder_tpu/ops/vit_attention.py:154,
// wrapper `fused_block_mlp:191`, K9). That kernel keeps the [T, I] GELU
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
// 577 rows per image (the TPU's 584-row pad was a sublane rule); TMA's zero
// fill and the epilogue's masks take the ragged edge.
//
// Both GEMMs are the shared mainloop of gemm_sm90.cuh (TMA ring of 4 stages
// of 64-deep K, wgmma from two ping-pong consumer warpgroups, 64 x 256
// tiles, persistent), with the bias + quick-GELU and the residual + bias
// epilogues. The weights are read in their parameter layout, fc1 [Dm, I]
// and fc2 [I, Dm] (MN-major B), so no transpose is made per call; the LN
// parameters and biases are read as stored (f32 or bf16), so a bf16 model
// pays no cast launches. The sigmoid's reciprocal is __fdividef (within 2
// ulp of the f32 division, far below the bf16 rounding that follows).
//
// What bounds it on the card: at the tower's shapes (M = 3 x 577 = 1731
// rows, Dm = 1024, I = 4096) the two products are 4 M Dm I = 29 GFLOP over
// ~28 MB of operands and outputs, far past the H100's ~295 FLOP/byte
// ridge: the tensor cores bound it (~0.029 ms at 989 TFLOP/s); fc1 makes 448
// tiles (3.4 waves on 132 SMs, so one warpgroup's GELU epilogue overlaps the
// other's mainloop), fc2 112 (0.85 of a wave, K = 4096). nvcc: 168
// registers at entry (40 / 232 after setmaxnreg), no spills, 164,944 bytes
// of shared memory; the LN kernel 40-46 registers.
// The bf16 [M, I] intermediate (14 MB) makes one round trip through the
// 50 MB L2 that the TPU kernel kept in VMEM. Fusing fc2 behind fc1 per row
// tile would need a 64 x 1024 f32 accumulator (256 KB), more than an SM
// holds. The LayerNorm reads and writes 16 bytes a thread; it moves 7 MB,
// ~2 us at the HBM rate.

#include "gemm_sm90.cuh"

namespace {

constexpr int LN_THREADS = 128;

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red is reused between calls
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < LN_THREADS / 32; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// LN2 of one row per block, 8 values a thread per step (16-byte loads and
// stores of the row): f32 mean and population variance, the normalized row
// times the scale plus the bias in f32, rounded once. The scale and bias are
// read as stored (V = float or bf16, which widens exactly).
template <typename V>
__global__ void __launch_bounds__(LN_THREADS)
    ln_kernel(const __nv_bfloat16* __restrict__ x, const V* __restrict__ s,
              const V* __restrict__ bias, __nv_bfloat16* __restrict__ h, int Dm, float eps) {
  __shared__ float red[LN_THREADS / 32];
  const __nv_bfloat16* xr = x + (long long)blockIdx.x * Dm;
  __nv_bfloat16* hr = h + (long long)blockIdx.x * Dm;
  float f[8];
  float sum = 0.f;
  for (int c = threadIdx.x * 8; c < Dm; c += LN_THREADS * 8) {
    load8(xr + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += f[i];
  }
  const float mean = block_sum(sum, red) / Dm;
  float sq = 0.f;
  for (int c = threadIdx.x * 8; c < Dm; c += LN_THREADS * 8) {
    load8(xr + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = f[i] - mean;
      sq = fmaf(d, d, sq);
    }
  }
  const float rstd = rsqrtf(block_sum(sq, red) / Dm + eps);
  for (int c = threadIdx.x * 8; c < Dm; c += LN_THREADS * 8) {
    float sv[8], bv[8];
    load8(xr + c, f);
    load8(s + c, sv);
    load8(bias + c, bv);
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = sm90::pack_bf16((f[2 * i] - mean) * rstd * sv[2 * i] + bv[2 * i],
                             (f[2 * i + 1] - mean) * rstd * sv[2 * i + 1] + bv[2 * i + 1]);
    *reinterpret_cast<uint4*>(hr + c) = out;
  }
}

}  // namespace

// Plain C entry points for ctypes, one per launch of the half-block; the
// Python wrapper calls them in order. Buffers are contiguous and 16-byte
// aligned, Dm and I multiples of 8 (checked by the wrapper); the LN
// parameters and biases are f32 or, with vec_bf16 / bias_bf16, bf16, read as
// stored. Each returns a CUDA error code or 0.
//
// LN2: x [M, Dm] bf16 -> h [M, Dm] bf16; s, b [Dm].
extern "C" int vit_mlp_ln(const void* x, const void* s, const void* b, void* h, int M, int Dm,
                          float eps, int vec_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* hb = static_cast<__nv_bfloat16*>(h);
  if (vec_bf16)
    ln_kernel<__nv_bfloat16><<<M, LN_THREADS, 0, st>>>(
        xb, static_cast<const __nv_bfloat16*>(s), static_cast<const __nv_bfloat16*>(b), hb, Dm,
        eps);
  else
    ln_kernel<float><<<M, LN_THREADS, 0, st>>>(xb, static_cast<const float*>(s),
                                               static_cast<const float*>(b), hb, Dm, eps);
  return static_cast<int>(cudaGetLastError());
}

// C [M, N] = epilogue(A [M, K] @ W [K, N]), bias [N]; epi 1: fc1's
// bias + quick-GELU; epi 2: fc2's residual R [M, N] bf16 + bias.
extern "C" int vit_mlp_gemm(const void* A, const void* W, const void* bias, int bias_bf16,
                            const void* R, void* C, int M, int N, int K, int epi, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (epi == sm90::kBiasGelu)
    return sm90::gemm<sm90::kBiasGelu>(A, W, bias, bias_bf16, nullptr, C, M, N, K, st);
  if (epi == sm90::kResidualBias)
    return sm90::gemm<sm90::kResidualBias>(A, W, bias, bias_bf16, R, C, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
