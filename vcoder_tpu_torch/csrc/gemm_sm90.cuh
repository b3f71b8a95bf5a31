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

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {
namespace sm90 {

constexpr int BM = 64;
constexpr int BN = 256;
constexpr int BK = 64;        // K depth of a stage: one 128-byte swizzled row
constexpr int STAGES = 4;
constexpr int INFLIGHT = 1;   // k-blocks of wgmma a warpgroup keeps in flight
constexpr int NTHREADS = 3 * 128;  // two consumer warpgroups + the producer warpgroup
constexpr int kMaxDevices = 64;    // per-device SM counts and shared-memory opt-ins

enum Epilogue { kBias = 0, kBiasGelu = 1, kResidualBias = 2 };

// A stage holds A as one box of [BM rows][64 k] and B as BN / 64 boxes of
// [BK rows][64 n], each row 128 bytes, 128-byte swizzled.
constexpr int A_TILE = BM * BK * 2;
constexpr int B_BOX = BK * 64 * 2;
constexpr int STAGE = A_TILE + BK * BN * 2;
// Dynamic shared memory: 1 KB of slack to align the ring to the 1 KB swizzle
// atom, the ring, then the mbarriers (STAGES full, STAGES empty, 2 turns).
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE + (2 * STAGES + 2) * 8;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Returns once the phase of parity `parity` has completed. A phase that
// never completes (a lost arrival: a bug) traps after ~2^35 cycles, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// One 2D TMA tile load; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (all >> 4), layout type 1 (B128).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma region.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] @ B[16 x 256], both from shared memory, B read
// MN-major (trans-b 1).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Element i of an f32 or bf16 vector (bf16 widens exactly); 0 for none.
__device__ __forceinline__ float load_vec(const void* v, int is_bf16, int i) {
  if (v == nullptr) return 0.f;
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(v)[i])
                 : static_cast<const float*>(v)[i];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the
// library links no driver library. Looked up once; two threads may both look
// it up and store the same pointer.
inline EncodeTiled encode_tiled() {
  static std::atomic<EncodeTiled> cached{nullptr};
  EncodeTiled fn = cached.load(std::memory_order_acquire);
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
      cached.store(fn, std::memory_order_release);
    }
  }
  return fn;
}

// A row-major bf16 [outer, inner] tensor, loaded in boxes of
// [box_outer, box_inner] with the 128-byte swizzle; out of bounds reads 0.
inline int make_map(CUtensorMap* map, const void* ptr, int inner, int outer, int box_inner,
                    int box_outer) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The SM count of device `dev`, read once per device.
inline int sm_count(int dev) {
  static std::atomic<int> counts[kMaxDevices];
  int n = counts[dev].load(std::memory_order_acquire);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    counts[dev].store(n, std::memory_order_release);
  }
  return n;
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
