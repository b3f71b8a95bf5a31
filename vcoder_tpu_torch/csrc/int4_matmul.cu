// int4 (nibble-packed) decode matmul for Hopper (sm_90a), f32 accumulation.
//
//   out[B,N] = x[B,K] @ unpack(qp[K/2,N])
//
// qp holds two signed nibbles per int8 byte: packed row i carries weight row
// 2i in its low nibble and row 2i+1 in its high nibble. The per-column scale
// is the caller's (applied after the call, as the TPU kernel leaves it).
//
// Port of `_kernel` (vcoder_tpu/ops/int4_matmul.py:47). The TPU kernel DMAs
// a [K/2, Nb] packed block per grid step, sign-extends both nibbles on the
// VPU and runs two MXU dots against the even and odd activation columns, so
// each packed byte is read from HBM once.
//
// What bounds it on the card: bytes. At decode (B <= 8) the product does
// 2*B*K*N operations over K*N/2 weight bytes, ~4*B operations per byte,
// far below the H100's ~295 FLOP/byte ridge: the 8.4 MB of a 7B q/k/v/o
// projection take 2.5 us at 3.35 TB/s, the 22.5 MB of gate/up/down 6.7 us,
// the 65.5 MB of lm_head 19.6 us.
//
// What the design does about it:
// - Each packed byte is read once. The weight is [K/2, N] with N contiguous;
//   a lane loads 16 bytes (16 output columns) of one packed row, 8 lanes
//   cover a block's 128 columns of that row (four full 32-byte sectors),
//   and the block's 32 lane groups walk 32 packed rows at a time. The loads
//   of several rows are issued before any is used.
// - Enough bytes in flight: N = 4096 gives only 32 column blocks for 132
//   SMs, so the packed rows are also split across blocks (grid.y); each
//   split writes f32 partial sums and a second small kernel adds them and
//   rounds. Inside a block the 32 groups' sums meet in shuffles and shared
//   memory.
// - Sign extension and conversion without int->float instructions: XOR
//   0x8 turns each signed nibble s into s + 8 in [0, 15]; PRMT places that
//   byte under the exponent of 2^23 and one FADD of -(2^23 + 8) gives s
//   exactly. x_even * lo + x_odd * hi accumulate in f32; the activations
//   are read in place through their row stride (x[b, 2i] and x[b, 2i+1]
//   are neighbours), with no strided copies.
// - Rows: B is processed in tiles of up to 4 rows (16 accumulators per row
//   and lane); a second tile re-reads the block's weight slice, which it
//   finds in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 128;                 // output columns per block
constexpr int NTHREADS = 256;             // 8 warps
constexpr int GROUPS = NTHREADS / 8;      // lane groups of 8, one packed row each
constexpr int NWARPS = NTHREADS / 32;
constexpr float MAGIC = 8388616.0f;       // 2^23 + 8

__device__ __forceinline__ float nibble(uint32_t biased, int k) {
  // Byte k of `biased` (a value in [0, 15]) under the exponent of 2^23.
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | k)) - MAGIC;
}

__device__ __forceinline__ uint4 load_row(const int8_t* __restrict__ qp,
                                          long long off, int col0, int N,
                                          bool vec) {
  if (vec && col0 + 16 <= N)
    return __ldg(reinterpret_cast<const uint4*>(qp + off + col0));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < 16; ++j) {
    const int c = col0 + j;
    const uint32_t byte = c < N ? static_cast<uint8_t>(qp[off + c]) : 0u;
    w[j >> 2] |= byte << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int BT>
__global__ void __launch_bounds__(NTHREADS)
    int4_matmul_kernel(const __nv_bfloat16* __restrict__ x, long long sx,
                       const int8_t* __restrict__ qp, float* __restrict__ part,
                       void* __restrict__ out, int B, int K2, int N,
                       int rows_per_split, int out_f32, int vec) {
  constexpr int U = BT <= 2 ? 4 : 2;  // packed rows in flight per lane
  __shared__ float red[NWARPS][BT][COLS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane & 7;                   // 16 columns each
  const int grp = (warp << 2) | (lane >> 3);  // 0..31
  const int col0 = blockIdx.x * COLS + sub * 16;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(K2, r_begin + rows_per_split);

  for (int b0 = 0; b0 < B; b0 += BT) {
    float acc[BT][16];
#pragma unroll
    for (int bb = 0; bb < BT; ++bb)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[bb][j] = 0.f;

    for (int r = r_begin + grp; r < r_end; r += GROUPS * U) {
      uint4 wv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * GROUPS;
        wv[u] = rr < r_end ? load_row(qp, (long long)rr * N, col0, N, vec)
                           : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * GROUPS;
        if (rr >= r_end) break;
        float xe[BT], xo[BT];
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) {
          const int b = b0 + bb;
          if (b < B) {
            const __nv_bfloat16* xr = x + (long long)b * sx + 2 * rr;
            xe[bb] = __bfloat162float(xr[0]);
            xo[bb] = __bfloat162float(xr[1]);
          } else {
            xe[bb] = xo[bb] = 0.f;
          }
        }
        const uint32_t words[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
#pragma unroll
        for (int wi = 0; wi < 4; ++wi) {
          const uint32_t wx = words[wi] ^ 0x88888888u;
          const uint32_t lo = wx & 0x0F0F0F0Fu;
          const uint32_t hi = (wx >> 4) & 0x0F0F0F0Fu;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float fl = nibble(lo, k), fh = nibble(hi, k);
#pragma unroll
            for (int bb = 0; bb < BT; ++bb)
              acc[bb][wi * 4 + k] =
                  fmaf(xe[bb], fl, fmaf(xo[bb], fh, acc[bb][wi * 4 + k]));
          }
        }
      }
    }

    // Lanes l, l^8, l^16, l^24 hold the same columns: add the warp's four
    // groups, then the eight warps through shared memory.
#pragma unroll
    for (int bb = 0; bb < BT; ++bb)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float v = acc[bb][j];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[bb][j] = v;
      }
    if (lane < 8) {
#pragma unroll
      for (int bb = 0; bb < BT; ++bb)
#pragma unroll
        for (int j = 0; j < 16; ++j) red[warp][bb][sub * 16 + j] = acc[bb][j];
    }
    __syncthreads();
    for (int o = tid; o < BT * COLS; o += NTHREADS) {
      const int bb = o / COLS, c = o % COLS;
      const int b = b0 + bb, col = blockIdx.x * COLS + c;
      if (b >= B || col >= N) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) s += red[w][bb][c];
      if (gridDim.y > 1)
        part[((long long)split * B + b) * N + col] = s;
      else if (out_f32)
        static_cast<float*>(out)[(long long)b * N + col] = s;
      else
        static_cast<__nv_bfloat16*>(out)[(long long)b * N + col] =
            __float2bfloat16_rn(s);
    }
    __syncthreads();
  }
}

__global__ void int4_split_sum(const float* __restrict__ part,
                               void* __restrict__ out, int splits,
                               long long n, int out_f32) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(long long)k * n + i];
  if (out_f32)
    static_cast<float*>(out)[i] = s;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(s);
}

}  // namespace

// Plain C entry point for ctypes. x [B, K] bf16 with row stride sx (elements,
// unit column stride); qp [K2 = K/2, N] int8, contiguous; out [B, N] bf16 (or
// f32 with out_f32). With splits > 1, part is an f32 scratch of
// splits * B * N; each split covers rows_per_split packed rows. Returns the
// CUDA error code of the launches.
extern "C" int int4_matmul(const void* x, const void* qp, void* part, void* out,
                           int B, int K2, int N, long long sx, int splits,
                           int rows_per_split, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(qp) % 16 == 0);
  dim3 grid((N + COLS - 1) / COLS, splits);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* q = static_cast<const int8_t*>(qp);
  float* p = static_cast<float*>(part);
  if (B == 1)
    int4_matmul_kernel<1><<<grid, NTHREADS, 0, st>>>(
        xb, sx, q, p, out, B, K2, N, rows_per_split, out_f32, vec);
  else if (B == 2)
    int4_matmul_kernel<2><<<grid, NTHREADS, 0, st>>>(
        xb, sx, q, p, out, B, K2, N, rows_per_split, out_f32, vec);
  else
    int4_matmul_kernel<4><<<grid, NTHREADS, 0, st>>>(
        xb, sx, q, p, out, B, K2, N, rows_per_split, out_f32, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = (long long)B * N;
  int4_split_sum<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(p, out, splits, n,
                                                            out_f32);
  return static_cast<int>(cudaGetLastError());
}
