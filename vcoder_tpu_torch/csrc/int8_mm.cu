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
// step. Here a persistent block walks whole output tiles, K inside, the
// accumulators in registers. The scaled form is the W8A8 prefill product of
// ops/quant.py, so its epilogue multiplies in that path's order,
// (acc * sa) * sb, with each product rounded in f32 and the result rounded
// once to bf16 (f16, f32): the plain version reproduces it bit for bit.
//
// What bounds it on the card: operations. At the 7B prefill (M = 1280,
// K = 4096, N = 11008) the product is 115.4 GOP over ~79 MB, 0.058 ms at the
// H100's 1,979 dense int8 TOP/s against 0.023 ms for the bytes.
//
// What the design does about it:
// - The layout trap: the s8 wgmma reads shared-memory operands only
//   K-major (PTX has no transpose for 8-bit types), but the weight is
//   [K, N] with N contiguous (the layout every quantized leaf keeps). So
//   the kernel computes each tile transposed, Cᵀ[n, m] = Bᵀ[n, K] Aᵀ[K, m]:
//   the weight is wgmma's register operand, whose fragment each thread
//   builds from the weight's raw tile, and the activations, K-major
//   already, are its shared-memory operand read in place. A warp's weight
//   fragment for 32 k is one ldmatrix.x4.trans (16-bit pairs of columns,
//   transposed) and four PRMTs (the k bytes of each column gathered); the
//   fragment rows are ordered so each lane's two rows are one such pair,
//   and the ldmatrix rows so its reads hit 8 distinct swizzle chunks. No
//   copy of the weight is made, in global or in shared memory. (A first
//   version transposed B in shared memory with a producer warpgroup, for
//   wgmma's shared-memory form: its transposer and the extra ring cost
//   twice this one's time on an H100 80GB HBM3 at 700 W; PERF.md.)
// - Tensor cores through wgmma.m64n128k32.s32.s8.s8, s32 accumulators in
//   registers: a 128 (n) x 128 (m) tile, two consumer warpgroups of 64
//   weight columns each, K in stages of 128. One producer thread keeps a
//   ring of 6 stages full with TMA (the raw weight box [128 k][128 n] and
//   the activation box [128 m][128 k], 32 KB, both 128-byte swizzled), with
//   one "full" and one "empty" mbarrier a stage; its warpgroup gives its
//   registers away with setmaxnreg (40 kept, 232 for the consumers). The
//   consumers take k-steps in pairs, two register buffers of fragments: a
//   step's fragments are built while the previous step's four products
//   run, and a stage is released once the wait for its products returned.
// - Tiles: 128 x 128 on every shape of the path; 256 activation rows a tile
//   ran slower on five of the six path shapes (ptxas serializes its wgmma
//   for want of registers) and 7% faster on the tower's fc1 (H100 80GB
//   HBM3 at 700 W; PERF.md). The grid is persistent, min(tiles, SMs)
//   blocks, consecutive tiles along M so concurrent blocks share weight
//   columns in L2.
// - Ragged edges: TMA fills rows, columns and K past the tensor with zeros
//   (an odd count of k-steps gets one more, all zeros); the epilogue masks
//   rows >= M and columns >= N. TMA needs 16-byte global strides and
//   16-byte-aligned bases, so K and N are multiples of 16 and A and B
//   16-byte aligned (checked here and by the Python wrapper).
// - Epilogue: straight from the accumulators, each thread holding 2 x 2
//   blocks of C (rows m, m + 1; columns n, n + 1): sb read once per tile,
//   sa 4 row pairs at a time, each pair of columns one store.
//
// The Hopper primitives (mbarriers, TMA loads, descriptors, the s8 wgmma,
// the tensor-map encoder) are those of sm90.cuh.

#include <cuda_fp16.h>

#include "sm90.cuh"

namespace {
namespace i8mm {

using namespace sm90;

constexpr int TM = 128;  // activation rows of a tile (the wgmma's N)
constexpr int TN = 128;  // weight columns of a tile: two consumer warpgroups of 64
constexpr int BK = 128;  // K bytes of a stage: one 128-byte swizzled row
constexpr int NTHREADS = 3 * 128;  // two consumer warpgroups + the producer warpgroup

// A stage holds the weight as its raw box [BK k][TN n] and the activations
// as [TM m][BK k], both 128-byte swizzled.
constexpr int W_BYTES = BK * TN;
constexpr int X_BYTES = TM * BK;
constexpr int STAGE = W_BYTES + X_BYTES;
constexpr int STAGES = 6;
// 1 KB of slack to align the ring to the swizzle atom, the ring, then the
// mbarriers (full and empty per stage).
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE + 2 * STAGES * 8;

// Four 8 x 8 matrices of 16-bit elements, transposed: lanes 8j..8j+7 give
// the row addresses of matrix j, and every lane receives in r[j] elements
// (rows 2 (lane % 4) and 2 (lane % 4) + 1, column lane / 4) of matrix j.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(f[i][e])::"memory");
}

// One persistent GEMM, computed transposed: a tile is Cᵀ[TN n, TM m] =
// Bᵀ[TN, K] · Aᵀ[K, TM], the weight as wgmma's register operand (64 of its
// columns a consumer warpgroup) and the activations as its shared-memory
// operand.
template <bool SCALED>
__global__ void __launch_bounds__(NTHREADS, 1)
    int8_mm_sm90(const __grid_constant__ CUtensorMap tmW, const __grid_constant__ CUtensorMap tmX,
                 const float* __restrict__ sa, const float* __restrict__ sb,
                 void* __restrict__ C, int M, int N, int K, int out_kind) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int m_tiles = (M + TM - 1) / TM;
  const int tiles = m_tiles * ((N + TN - 1) / TN);
  // The consumers take k-steps in pairs (two register buffers of weight
  // fragments); an odd count gets one step past K, which TMA fills with 0.
  const int k_iters = (K + BK - 1) / BK;
  const int k_steps = k_iters + (k_iters & 1);
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;

  if (wg == 2) {
    // The producer: one thread keeps the ring full, tile after tile; its
    // warpgroup gives registers to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 256) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmW)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmX)) : "memory");
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % m_tiles) * TM, n0 = (t / m_tiles) * TN;
      for (int kb = 0; kb < k_steps; ++kb) {
        const int k0 = kb * BK;
        mbar_wait(empty(stage), phase ^ 1);
        const uint32_t w = base + stage * STAGE;
        mbar_expect_tx(full(stage), STAGE);
        tma_load(w, &tmW, full(stage), n0, k0);
        tma_load(w + W_BYTES, &tmX, full(stage), k0, m0);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg computes weight columns 64 wg .. 64 wg + 63
  // of each tile against all TM activation rows. Warp w's fragment rows are
  // the tile's 16 columns of chunk c = 4 wg + w (16 bytes of each k row):
  // fragment row g is column 2g of the chunk, row g + 8 column 2g + 1, so a
  // lane's two rows are one pair of bf16-sized elements, which ldmatrix.trans
  // delivers: matrix j row i (lane 8j + i gives its address) is k row
  //   16 (j >> 1) + 4 (i >> 1) + (i & 1) + 2 (up(i >> 1) ^ (j & 1)),
  // up(t) = (t ^ (t >> 1)) & 1, so lane t = lane % 4 receives k 4t .. 4t + 3
  // of its two columns across matrices 0 and 1 (16 + that across 2 and 3),
  // and the 8 rows of a matrix fall in 8 distinct chunks of the swizzle.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int mi = lane & 7, mj = lane >> 3;
  const int krow = 16 * (mj >> 1) + 4 * (mi >> 1) + (mi & 1) +
                   2 * ((((mi >> 1) ^ (mi >> 2)) & 1) ^ (mj & 1));
  const int chunk = wg * 4 + warp;
  const uint32_t lrow = krow * 128 + ((chunk ^ (krow & 7)) << 4);
  const int t4 = lane & 3;
  const bool up = ((t4 ^ (t4 >> 1)) & 1) != 0;  // matrix 0 holds k 4t + 2, 4t + 3
  const uint32_t sel_lo = up ? 0x2064u : 0x6420u, sel_hi = up ? 0x3175u : 0x7531u;

  int acc[TM / 2];
  uint32_t fa[BK / 32][4], fb[BK / 32][4];
  bool ok = true;
  int g = 0;
  // One k-step into fragment buffer f: wait for stage g, build the weight
  // fragments (k 32 kk .. 32 kk + 31 of this warp's 16 columns), issue the
  // four products, then wait for the previous step's and release its stage.
  auto step = [&](uint32_t(&f)[BK / 32][4], int kb) {
    const int s = g % STAGES;
    ok &= mbar_wait_bounded(full(s), (g / STAGES) & 1);
    const uint32_t w = base + s * STAGE, x = w + W_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t r[4];
      ldsm_x4_trans(r, w + kk * 32 * 128 + lrow);
      f[kk][0] = __byte_perm(r[0], r[1], sel_lo);
      f[kk][1] = __byte_perm(r[0], r[1], sel_hi);
      f[kk][2] = __byte_perm(r[2], r[3], sel_lo);
      f[kk][3] = __byte_perm(r[2], r[3], sel_hi);
    }
    fence_frags(f);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      // 32 k are 32 bytes along the activations' 128-byte swizzled rows,
      // 8-row groups 1 KB apart.
      wgmma_m64n128k32_s8_rs(acc, f[kk], smem_desc(x + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
    fence_frags(f);
    if (kb > 0 && lane == 0) mbar_arrive(empty((g - 1) % STAGES));
    ++g;
  };
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % m_tiles) * TM, n0 = (t / m_tiles) * TN;
#pragma unroll
    for (int e = 0; e < TM / 2; ++e) acc[e] = 0;
    for (int kb = 0; kb < k_steps; kb += 2) {
      step(fa, kb);
      step(fb, kb + 1);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty((g - 1) % STAGES));

    // Accumulator 4j + {0, 1, 2, 3}: (column n, row m), (n, m + 1),
    // (n + 1, m), (n + 1, m + 1) with m = m0 + 8j + 2 (lane % 4).
    const int n = n0 + 64 * wg + 16 * warp + 2 * (lane / 4);
    if (n >= N) continue;  // N % 16 == 0: n + 1 < N as well
    float sc[2] = {0.f, 0.f};
    if (SCALED) {
      sc[0] = sb[n];
      sc[1] = sb[n + 1];
    }
#pragma unroll
    for (int jc = 0; jc < TM / 8; jc += 4) {
      float sr[4][2];
      if (SCALED) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + 8 * (jc + jj) + 2 * t4 + h;
            sr[jj][h] = sa[m < M ? m : 0];
          }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = jc + jj;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 8 * j + 2 * t4 + h;
          if (m >= M) continue;
          const long long o = static_cast<long long>(m) * N + n;
          const int v0 = acc[4 * j + h], v1 = acc[4 * j + 2 + h];
          if (!SCALED) {
            *reinterpret_cast<int2*>(static_cast<int*>(C) + o) = make_int2(v0, v1);
          } else {
            const float f0 = __fmul_rn(__fmul_rn(__int2float_rn(v0), sr[jj][h]), sc[0]);
            const float f1 = __fmul_rn(__fmul_rn(__int2float_rn(v1), sr[jj][h]), sc[1]);
            if (out_kind == 0)
              *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(C) + o) =
                  __floats2bfloat162_rn(f0, f1);
            else if (out_kind == 1)
              *reinterpret_cast<__half2*>(static_cast<__half*>(C) + o) =
                  __floats2half2_rn(f0, f1);
            else
              *reinterpret_cast<float2*>(static_cast<float*>(C) + o) = make_float2(f0, f1);
          }
        }
      }
    }
  }
  if (!ok) __trap();  // a lost arrival: fail the launch instead of hanging
}

// One launch: the shared-memory opt-in above 48 KB (per device and
// instantiation: set once for each, not again while a graph is being
// captured; two threads may both set it, the call is idempotent), and the
// persistent grid.
template <bool SCALED>
int launch(const CUtensorMap& tw, const CUtensorMap& tx, const float* sa, const float* sb,
           void* C, int M, int N, int K, int out_kind, int dev, int sms, cudaStream_t stream) {
  static std::atomic<bool> smem_set[kMaxDevices];
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_mm_sm90<SCALED>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev].store(true, std::memory_order_release);
  }
  const int tiles = ((M + TM - 1) / TM) * ((N + TN - 1) / TN);
  int8_mm_sm90<SCALED><<<tiles < sms ? tiles : sms, NTHREADS, SMEM_BYTES, stream>>>(
      tw, tx, sa, sb, C, M, N, K, out_kind);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace i8mm
}  // namespace

// Plain C entry point for ctypes. A [M,K] and B [K,N] are contiguous int8,
// 16-byte aligned, K and N multiples of 16; sa [M] and sb [N] f32 (null for
// the s32 form); C [M,N] contiguous: s32, or with `scaled` bf16 (out_kind 0),
// f16 (1) or f32 (2). Returns a CUDA error code (cudaErrorInvalidValue for
// operands TMA cannot read) or 0.
extern "C" int int8_mm(const void* A, const void* Bm, const void* sa, const void* sb, void* C,
                       int M, int N, int K, int scaled, int out_kind, void* stream) {
  using namespace i8mm;
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 16 != 0 ||
      reinterpret_cast<uintptr_t>(A) % 16 != 0 || reinterpret_cast<uintptr_t>(Bm) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const int sms = sm_count(dev);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  // The weight B: [K rows][N] in its raw [128 k][128 n] boxes; the
  // activations A: [M rows][K] in [TM m][128 k] boxes; both 128-byte
  // swizzled.
  const long long kdim = K;
  const long long dims_w[2] = {N, kdim}, strides_w[1] = {N};
  const long long dims_x[2] = {kdim, M}, strides_x[1] = {K};
  const int box_w[2] = {TN, BK}, box_x[2] = {BK, TM};
  CUtensorMap tw, tx;
  int err = make_map_nd(&tw, Bm, 2, dims_w, strides_w, box_w, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err) return err;
  err = make_map_nd(&tx, A, 2, dims_x, strides_x, box_x, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(sa);
  const float* fb = static_cast<const float*>(sb);
  return scaled ? launch<true>(tw, tx, fa, fb, C, M, N, K, out_kind, dev, sms, st)
                : launch<false>(tw, tx, nullptr, nullptr, C, M, N, K, out_kind, dev, sms, st);
}
