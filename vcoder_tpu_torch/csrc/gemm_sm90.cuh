// One bf16 GEMM mainloop for Hopper (sm_90a): TMA loads into a ring of
// shared-memory stages, wgmma from shared memory, f32 accumulators in
// registers, and three epilogues.
//
//   C[M,N] = epilogue(A[M,K] @ B[K,N]),  B row-major (N contiguous, "MN-major")
//
// Epilogues (template parameter EPI), each in the f32 order of the kernel it
// serves:
//   kBias          C = bf16(acc + bias)             (bias [N] or none)
//   kBiasGelu      C = bf16(quick_gelu(acc + bias)) (quick_gelu in f32: the
//                  sigmoid's reciprocal by __fdividef, within 2 ulp of f32
//                  division; the IEEE division cost fc1 ~8 us of 47)
//   kResidualBias  C = bf16((R + acc) + bias)       (R bf16 [M,N])
// The bias is f32 or bf16, read as stored (bf16 widens exactly).
//
// It is the GEMM under two TPU kernels of vcoder_tpu/ops/vit_attention.py:
// `_block_kernel` (:52, K2: the CLIP block's QKV projection and
// out-projection, csrc/gemm_bias.cu) and `_mlp_kernel` (:154, K9: fc1 and
// fc2 of the MLP half-block, csrc/vit_mlp.cu).
//
// What bounds it on the card: at the tower's shapes (M = 3 pictures x 577
// tokens = 1731, Dm = 1024, I = 4096) K2's two products are 14.5 GFLOP and
// K9's two are 29 GFLOP over 10-28 MB: far past the H100's ~295 FLOP/byte
// ridge, so the tensor cores bound them (0.0147 and 0.0294 ms at 989
// TFLOP/s; under load the card holds 1.5-1.8 GHz at its 700 W limit, not
// the 1.83 GHz of that rate). The design feeds the tensor cores:
//
// - Tiles. 64 x 256 outputs, K in stages of 64. On 132 SMs the products
//   make 336 tiles (QKV, N 3072), 112 (out-projection and fc2, N 1024) and
//   448 (fc1, N 4096): 2.5, 0.85 and 3.4 waves (M = 1731 fills 27.05 row
//   tiles). The kernel is persistent: grid = min(tiles, SMs), each block
//   walks its tiles.
// - Warps. One producer warpgroup (one thread issues the TMA loads; the
//   group gives its registers away with setmaxnreg, 40 kept) and two
//   consumer warpgroups (232 registers each) issuing wgmma.m64n256k16 (bf16
//   in, f32 accumulate; 128 accumulator registers a thread). The consumers
//   run "ping-pong": each owns whole tiles, and one's mainloop runs while
//   the other writes its epilogue. A block with one tile leaves its second
//   warpgroup idle; one m64n256 warpgroup still keeps the tensor cores
//   busy. One mode serves every shape: on the tower's four products it
//   timed as fast as 128 x 128 tiles with ping-pong where tiles outnumber
//   SMs and both warpgroups on one tile elsewhere (QKV 0.0270 against
//   0.0273 ms, out-projection 0.0116 / 0.0121, fc1 0.0377 / 0.0396, fc2
//   0.0299 / 0.0295 on an H100 80GB HBM3 at 700 W; PERF.md).
// - Stages. A ring of 4 stages (A 64 x 64 and B 64 x 256 bf16, 40 KB a
//   stage) in dynamic shared memory with the 128-byte swizzle, one "full"
//   mbarrier (TMA transaction bytes) and one "empty" mbarrier (the reading
//   warps) per stage. A consumer keeps one k-block of wgmma in flight and
//   releases a stage once the wait for its group returned. 6 stages, two
//   k-blocks in flight, or 128-deep stages measured no faster (on 128 x 128
//   tiles).
// - Operands. A is K-major (the activations): one 64 x 64 TMA box. B is
//   read in place in its parameter layout [K,N] through the wgmma
//   descriptor's trans-b: four 64-column boxes of 64 K rows each, 8 KB
//   apart (the descriptor's leading byte offset), 8-row groups 1 KB apart
//   (its stride byte offset). No weight is copied per call.
// - Epilogue. Straight from the accumulators to global memory; its operand
//   loads (bias, residual) are issued 8 columns at a time so they are in
//   flight together (one dependent load a column cost microseconds a tile).
// - Ragged edges. TMA fills rows, columns and K past the tensor with zeros
//   (a box wholly past N as well); the epilogue masks rows >= M and columns
//   >= N. K and N must be multiples of 8 (TMA's 16-byte stride rule, checked
//   by the Python wrappers).
//
// nvcc -Xptxas -v (CUDA 12.8): every instantiation 168 registers at entry
// (384 threads; setmaxnreg moves them to 40 / 232), 0 bytes spilled;
// 164,944 bytes of dynamic shared memory, 1 block an SM. cuobjdump -sass:
// HGMMA and UTMALDG, no HMMA.
//
// The Hopper primitives (mbarriers, TMA loads, descriptors, wgmma, the
// tensor-map encoder) are those of sm90.cuh, shared with flash_fwd.cu.

#pragma once

#include "sm90.cuh"

namespace {
namespace sm90 {

constexpr int BM = 64;
constexpr int BN = 256;
constexpr int BK = 64;        // K depth of a stage: one 128-byte swizzled row
constexpr int STAGES = 4;
constexpr int INFLIGHT = 1;   // k-blocks of wgmma a warpgroup keeps in flight
constexpr int NTHREADS = 3 * 128;  // two consumer warpgroups + the producer warpgroup

enum Epilogue { kBias = 0, kBiasGelu = 1, kResidualBias = 2 };

// A stage holds A as one box of [BM rows][64 k] and B as BN / 64 boxes of
// [BK rows][64 n], each row 128 bytes, 128-byte swizzled.
constexpr int A_TILE = BM * BK * 2;
constexpr int B_BOX = BK * 64 * 2;
constexpr int STAGE = A_TILE + BK * BN * 2;
// Dynamic shared memory: 1 KB of slack to align the ring to the 1 KB swizzle
// atom, the ring, then the mbarriers (STAGES full, STAGES empty, 2 turns).
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE + (2 * STAGES + 2) * 8;

// Element i of an f32 or bf16 vector (bf16 widens exactly); 0 for none.
__device__ __forceinline__ float load_vec(const void* v, int is_bf16, int i) {
  if (v == nullptr) return 0.f;
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(v)[i])
                 : static_cast<const float*>(v)[i];
}

// One persistent GEMM of BM x BN tiles; the two consumer warpgroups take
// turns, each owning whole tiles.
template <int EPI>
__global__ void __launch_bounds__(NTHREADS, 1)
    gemm_sm90(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
              const void* __restrict__ bias, int bias_bf16, const __nv_bfloat16* __restrict__ R,
              __nv_bfloat16* __restrict__ C, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  // done[w] completes a phase each time warpgroup w has issued a mainloop.
  auto done = [&](int w) { return bars + 8u * (2 * STAGES + w); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // the four warps of the warpgroup that reads the stage
    }
    for (int w = 0; w < 2; ++w) mbar_init(done(w), 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int m_tiles = (M + BM - 1) / BM;
  const int tiles = m_tiles * ((N + BN - 1) / BN);
  const int k_iters = (K + BK - 1) / BK;
  const int wg = tid / 128;

  if (wg == 2) {
    // The producer: one thread keeps the ring full, tile after tile; its
    // warpgroup gives registers to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 256) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmA)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmB)) : "memory");
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % m_tiles) * BM, n0 = (t / m_tiles) * BN;
      for (int kb = 0; kb < k_iters; ++kb) {
        mbar_wait(empty(stage), phase ^ 1);
        const uint32_t a = base + stage * STAGE, b = a + A_TILE;
        mbar_expect_tx(full(stage), STAGE);
        tma_load(a, &tmA, full(stage), kb * BK, m0);
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          tma_load(b + q * B_BOX, &tmB, full(stage), n0 + 64 * q, kb * BK);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg on the block's tiles i = wg, wg + 2, ...,
  // reading ring positions g = i * k_iters + kb. A warpgroup starts
  // mainloop i only once the other has issued mainloop i - 1 (done[]), so no
  // mbarrier is waited on more than one phase ahead of its last completed
  // one, which its parity could not tell apart; and one warpgroup's
  // mainloop runs while the other writes its epilogue.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = (tid / 32) % 4, lane = tid % 32;
  float acc[BN / 2];
  for (int i = wg;; i += 2) {
    const int t = blockIdx.x + i * gridDim.x;
    if (t >= tiles) break;
    const int m0 = (t % m_tiles) * BM, n0 = (t / m_tiles) * BN;
    if (i > 0) mbar_wait(done(1 - wg), ((i - 1) / 2) & 1);
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
    for (int kb = 0; kb < k_iters; ++kb) {
      const int g = i * k_iters + kb;
      const int stage = g % STAGES;
      mbar_wait(full(stage), (g / STAGES) & 1);
      const uint32_t a = base + stage * STAGE, b = a + A_TILE;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        // A: 16 k are 32 bytes along a 128-byte swizzled row, 8-row groups
        // 1 KB apart. B: 16 k are 16 rows of 128 bytes, its 64-column boxes
        // B_BOX bytes apart.
        wgmma_m64n256k16(acc, smem_desc(a + kk * 32, 16, 1024),
                         smem_desc(b + kk * 2048, B_BOX, 1024));
      wgmma_commit();
      wgmma_wait<INFLIGHT>();  // the k-block INFLIGHT back is done: release it
      fence_acc(acc);
      if (kb >= INFLIGHT && lane == 0) mbar_arrive(empty((g - INFLIGHT) % STAGES));
    }
    if (lane == 0) mbar_arrive(done(wg));
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0)
      for (int kb = k_iters > INFLIGHT ? k_iters - INFLIGHT : 0; kb < k_iters; ++kb)
        mbar_arrive(empty((i * k_iters + kb) % STAGES));

    // Accumulator j*4 + {0,1,2,3}: row r, cols c, c+1; row r+8, cols c, c+1.
    // Operands are loaded 8 columns at a time with clamped indices (those
    // outputs are not stored), so each batch of loads is in flight at once.
    const int c0 = n0 + (lane % 4) * 2;
    const int r = m0 + warp * 16 + lane / 4;
#pragma unroll
    for (int jc = 0; jc < BN / 8; jc += 8) {
      float bv[8][2];
      uint32_t rv[8][2];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = c0 + (jc + jj) * 8 < N ? c0 + (jc + jj) * 8 : 0;
        bv[jj][0] = load_vec(bias, bias_bf16, col);
        bv[jj][1] = load_vec(bias, bias_bf16, col + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + h * 8 < M ? r + h * 8 : 0;
          rv[jj][h] = EPI == kResidualBias ? *reinterpret_cast<const uint32_t*>(
                                                 R + static_cast<long long>(row) * N + col)
                                           : 0u;
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = jc + jj;
        const int col = c0 + j * 8;
        if (col >= N) continue;  // N % 8 == 0: col + 1 < N as well
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + h * 8;
          if (row >= M) continue;
          float v0 = acc[j * 4 + h * 2], v1 = acc[j * 4 + h * 2 + 1];
          if (EPI == kBias) {
            v0 += bv[jj][0];
            v1 += bv[jj][1];
          } else if (EPI == kBiasGelu) {
            v0 += bv[jj][0];
            v1 += bv[jj][1];
            v0 = v0 * __fdividef(1.f, 1.f + expf(-1.702f * v0));
            v1 = v1 * __fdividef(1.f, 1.f + expf(-1.702f * v1));
          } else {
            const float2 rr =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv[jj][h]));
            v0 = (rr.x + v0) + bv[jj][0];
            v1 = (rr.y + v1) + bv[jj][1];
          }
          *reinterpret_cast<uint32_t*>(C + static_cast<long long>(row) * N + col) =
              pack_bf16(v0, v1);
        }
      }
    }
  }
}

// One GEMM: the two tensor maps (built per call, on the host, so a CUDA-graph
// capture records them by value), the shared-memory opt-in above 48 KB (it
// holds per device: set once for each, not again while a graph is being
// captured; two threads may both set it, the call is idempotent), and the
// persistent grid. Returns a CUDA error code or 0.
template <int EPI>
int gemm(const void* A, const void* B, const void* bias, int bias_bf16, const void* R, void* C,
         int M, int N, int K, cudaStream_t stream) {
  CUtensorMap ta, tb;
  int err = make_map(&ta, A, K, M, 64, BM);
  if (err) return err;
  err = make_map(&tb, B, N, K, 64, BK);
  if (err) return err;
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(gemm_sm90<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev].store(true, std::memory_order_release);
  }
  const int sms = sm_count(dev);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  gemm_sm90<EPI><<<tiles < sms ? tiles : sms, NTHREADS, SMEM_BYTES, stream>>>(
      ta, tb, bias, bias_bf16, static_cast<const __nv_bfloat16*>(R),
      static_cast<__nv_bfloat16*>(C), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace
