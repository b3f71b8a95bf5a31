// int4 (nibble-packed) decode matmul for Hopper (sm_90a): tensor-core
// products on nibbles dequantized in registers, the split along K reduced
// inside the launch, and an optional per-column scale in the epilogue.
//
//   out[B,N] = T(x[B,K] @ unpack(qp[K/2,N]))                  (no scale)
//   out[B,N] = T(float(T(acc)) * float(T(scale[N])))          (with a scale)
//
// T rounds to the output type (x's: bf16, f16 or f32), acc is the f32
// product over bf16 activations. qp holds two signed nibbles per int8 byte:
// packed row i carries weight row 2i in its low nibble and row 2i+1 in its
// high nibble (the JAX package's layout, N contiguous, read as it is). The
// scaled form is ``qmatmul``'s int4 route, ``int4_matmul(x, q) *
// scale.to(x.dtype)``, fused: bit-equal to the product, rounded, times the
// rounded scale, rounded again.
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
// the 65.5 MB of lm_head 19.6 us. So the unpacking and the products have to
// hide under the loads, and enough bytes have to be in flight.
//
// What the design does about it:
// - Tensor cores, with the weight as the A operand: each block computes a
//   tile of the transposed output, Cᵀ[128 columns, 8 rows] = Wᵀ · xᵀ, with
//   mma.sync.m16n8k16 (bf16 in, f32 accumulators). A warp's k-step is 16 k
//   (8 packed rows) by the block's 128 columns: lane (g, t) = (lane / 4,
//   lane % 4) loads 16 contiguous bytes (columns c = 16 g .. 16 g + 15) of
//   packed rows 8 s + 2 t and 8 s + 2 t + 1, one LDG.128 each (8 lanes
//   read a row's 128 bytes). Byte 2 j of a row is row g of the lane's
//   fragment of m16 tile j (column c + 2 j), byte 2 j + 1 its row g + 8
//   (column c + 2 j + 1): the two nibbles of one byte are the two k of one
//   bf16x2 fragment register. So the load gives the lane all its A
//   registers for eight m16 tiles, with no shuffle or transpose. The k order
//   inside a step is permuted consistently in A and B (the fragment's k
//   pair 2t, 2t+1 is k 4t, 4t+1 of the step, its pair 2t+8, 2t+9 is k 4t+2,
//   4t+3), so a lane's activations are 4 neighbouring bf16, 8 bytes of
//   x[g][16 s + 4 t ..] (x is the B operand, its 8 rows the mma's n8).
// - Unpacking in registers, 3.25 instructions a byte: one shift per word,
//   then per byte a PRMT (the byte's low nibble to bits 0-3, its high nibble
//   to bits 16-19), a LOP3 ((y & 0x000F000F) ^ 0x43084308: both nibbles
//   biased by 8, under the bf16 exponent of 128) and one HSUB2 of 136,
//   which leaves the exact signed values. No int->float conversion.
// - Bytes in flight: a warp loads its k-steps in batches of UB = 2, into
//   two register buffers; each batch is waited for, the next issued, then
//   the waited one multiplied while the next is in flight. The order is a
//   data dependency (the next batch's addresses add a zero made from the
//   waited batch's words), because loads share scoreboards: loads issued
//   freely into a register ring made each step wait for every load in
//   flight, ~1 us a step on an H100. 8 warps a block, 2 blocks an SM.
//   (A per-warp TMA ring of [8 rows][128 columns] boxes counted on
//   mbarriers, and a cp.async ring, both ran slower than these plain
//   loads on an H100 80GB HBM3; PERF.md.)
// - The split along K, reduced in the launch: the 8 warps of a block take
//   8 consecutive slices of the block's K range, and the blocks of a
//   thread-block cluster (up to 8, one column tile) take consecutive
//   ranges, so a column tile gets up to 64 slices. The wrapper takes the
//   largest cluster whose grid still fits one wave: clusters of 3 and more
//   lose SMs to the GPC layout (int4_matmul_capacity reports the card's
//   cluster occupancy), and a second wave doubles the time of its blocks.
//   Each warp leaves its partial sums in shared
//   memory; the block adds its 8 in warp order; after a cluster barrier
//   each block adds, for its share of the tile, the cluster's partials in
//   rank order through distributed shared memory and runs the epilogue;
//   a second barrier keeps every block's shared memory alive until then.
//   No workspace, no counter, no atomics: two launches give the same bits.
// - Rows of x: a block takes 8 rows (grid.y walks further groups of 8,
//   re-reading the weight, from L2 while the groups run together). B = 1
//   and B = 8 are the fast cases; any B is right.
// - Ragged edges: packed rows past K/2 and columns past N load as zero
//   bytes (exact zeros), activations past K or past B as zeros. Unless N is
//   a multiple of 16, K of 4 and x's row stride of 4, with 16- and 8-byte
//   aligned bases, each lane reads its weight bytes and activations one by
//   one (the slow path); the epilogue masks rows >= B and columns >= N.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int COLS = 128;               // output columns per block
constexpr int WARPS = 8;                // K slices per block, one per warp
constexpr int NTHREADS = 32 * WARPS;
constexpr int ROWS = 8;                 // rows of x per block (the mma's n8)
constexpr int MAX_CLUSTER = 8;
constexpr int UB = 2;                   // k-steps per batch of loads
// The warps' partial sums, in shared memory after the main loop.
constexpr int RED_LD = COLS + 4;        // padded row of the partial sums

// The slow path's loads, for a weight or activations whose rows are not
// aligned for vector loads: 16 bytes of packed row r
// at columns col .. col + 15, and activations k .. k + 3 of one row, zeros
// past the tensors.
__device__ __forceinline__ uint4 load_w_bytes(const int8_t* __restrict__ qp, int r, int col,
                                              int K2, int N) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (r < K2) {
    const int8_t* p = qp + (long long)r * N + col;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (col + j < N)
        w[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint2 load_x_elems(const __nv_bfloat16* __restrict__ xr, int k,
                                              int K) {
  uint32_t e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    e[i] = k + i < K ? __ldg(reinterpret_cast<const unsigned short*>(xr + k + i)) : 0u;
  return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
}

// 16 (weights, no L1 allocation) or 8 (activations) bytes when `p`, zeros
// otherwise; always issued, so the loads of a batch form one group.
__device__ __forceinline__ uint4 ldg16(const void* ptr, bool p) {
  uint4 v;
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %5, 0;\n"
      "mov.u32 %0, 0;\nmov.u32 %1, 0;\nmov.u32 %2, 0;\nmov.u32 %3, 0;\n"
      "@q ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(ptr), "r"(static_cast<int>(p)));
  return v;
}

__device__ __forceinline__ uint2 ldg8(const void* ptr, bool p) {
  uint2 v;
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %3, 0;\n"
      "mov.u32 %0, 0;\nmov.u32 %1, 0;\n"
      "@q ld.global.nc.v2.u32 {%0, %1}, [%2];\n}\n"
      : "=r"(v.x), "=r"(v.y)
      : "l"(ptr), "r"(static_cast<int>(p)));
  return v;
}

// Byte p of the packed word w as a bf16x2 fragment register: its low nibble
// (weight row 2i) in the low half, its high nibble (row 2i+1) in the high
// half, both exact. s = w >> 4, so byte p of s holds the high nibble low.
__device__ __forceinline__ uint32_t unpack(uint32_t w, uint32_t s, int p) {
  const uint32_t y = __byte_perm(w, s, p | ((p + 4) << 8));
  uint32_t b;  // (y & 0x000F000F) ^ 0x43084308: 128 + (nibble ^ 8) in each half
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(b) : "r"(y), "r"(0x000F000Fu), "r"(0x43084308u));
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&b);
  v = __hsub2(v, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of a lane: rows 8s + 2t (ra) and 8s + 2t + 1 (rb) of its 16
// columns against its activations xv, into the eight m16 tiles.
__device__ __forceinline__ void step(float (&acc)[8][4], const uint4& ra, const uint4& rb,
                                     const uint2& xv) {
  const uint32_t wa[4] = {ra.x, ra.y, ra.z, ra.w};
  const uint32_t wb[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t sa = wa[q] >> 4, sb = wb[q] >> 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // tile 2q + h: bytes 4q + 2h (row g), 4q + 2h + 1 (g + 8)
      const uint32_t f[4] = {unpack(wa[q], sa, 2 * h), unpack(wa[q], sa, 2 * h + 1),
                             unpack(wb[q], sb, 2 * h), unpack(wb[q], sb, 2 * h + 1)};
      mma_bf16(acc[2 * q + h], f, xv.x, xv.y);
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }


// Grid: (column tiles x cluster size, groups of 8 rows); cluster (C, 1, 1),
// the C blocks of a column tile each taking 1/C of K. VEC: the weight's
// rows are 16-byte aligned, the activations' 8-byte aligned and K a
// multiple of 4, so both load as whole vectors; otherwise each lane reads
// its bytes one by one.
template <typename OutT, bool VEC>
__global__ void __launch_bounds__(NTHREADS, 2)
    int4_matmul_kernel(const __nv_bfloat16* __restrict__ x, long long sx,
                       const int8_t* __restrict__ qp, const float* __restrict__ scale,
                       OutT* __restrict__ out, int B, int K2, int N) {
  __shared__ __align__(16) float red[WARPS][ROWS][RED_LD];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / C;
  const int row0 = blockIdx.y * ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col = tile * COLS + 16 * g;

  // This warp's slice of the k-steps: slices are consecutive across the
  // warps of a block and the blocks of the cluster.
  const int ksteps = (K2 + 7) / 8;
  const int slices = C * WARPS, slice = rank * WARPS + warp;
  const int kb = static_cast<int>((long long)slice * ksteps / slices);
  const int n = static_cast<int>((long long)(slice + 1) * ksteps / slices) - kb;
  const int K = 2 * K2;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (VEC) {
    // Loads in batches of UB k-steps, two register buffers: a batch's
    // loads are waited for, then the next batch is issued, then the
    // waited batch is multiplied while the next one is in flight. The
    // loads share scoreboards, so issued in another order a wait for one
    // batch would also wait for the next. The order is a data dependency:
    // the next batch's addresses add `dep`, zero at run time (B > 0), made
    // from the waited batch's words.
    const bool has_row = row0 + g < B;
    const int8_t* wp = qp + (long long)(8 * kb + 2 * t) * N + col;
    const __nv_bfloat16* xp = x + (has_row ? (long long)(row0 + g) * sx : 0) + 16 * kb + 4 * t;
    const bool in_col = col < N;
    uint4 wa[2][UB], wb[2][UB];
    uint2 wx[2][UB];
    auto load = [&](int buf, int i0, int dep) {  // steps kb + i0 .. kb + i0 + UB - 1
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int i = i0 + u, r = 8 * (kb + i) + 2 * t;
        const long long o = (long long)i * 8 * N + dep;
        wa[buf][u] = ldg16(wp + o, in_col && i < n && r < K2);
        wb[buf][u] = ldg16(wp + o + N, in_col && i < n && r + 1 < K2);
        wx[buf][u] = ldg8(xp + 16 * i + dep, has_row && i < n && 16 * (kb + i) + 4 * t < K);
      }
    };
    auto wait = [&](int buf) {
      uint32_t v = 0;
#pragma unroll
      for (int u = 0; u < UB; ++u) v ^= wa[buf][u].x ^ wb[buf][u].x ^ wx[buf][u].x;
      return static_cast<int>(v) & (B >> 31);
    };
    auto mul = [&](int buf, int i0) {
#pragma unroll
      for (int u = 0; u < UB; ++u)
        if (i0 + u < n) step(acc, wa[buf][u], wb[buf][u], wx[buf][u]);
    };
    load(0, 0, 0);
    for (int i0 = 0; i0 < n; i0 += 2 * UB) {
      load(1, i0 + UB, wait(0));
      mul(0, i0);
      load(0, i0 + 2 * UB, wait(1));
      mul(1, i0 + UB);
    }
  } else {
    const bool has_row = row0 + g < B;
    const __nv_bfloat16* xr = x + (has_row ? (long long)(row0 + g) * sx : 0);
    for (int i = 0; i < n; ++i) {
      const int s = kb + i;
      const int r = 8 * s + 2 * t;
      step(acc, load_w_bytes(qp, r, col, K2, N), load_w_bytes(qp, r + 1, col, K2, N),
           has_row ? load_x_elems(xr, 16 * s + 4 * t, K) : make_uint2(0u, 0u));
    }
  }

  // The warp's partial sums: acc[j] holds (row 2t, column c + 2j), (row
  // 2t + 1, c + 2j), (row 2t, c + 2j + 1), (row 2t + 1, c + 2j + 1), with
  // c = 16 g the lane's first column in the tile.
  {
    float* r0 = &red[warp][2 * t][16 * g];
    float* r1 = &red[warp][2 * t + 1][16 * g];
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      *reinterpret_cast<float4*>(r0 + 2 * j) =
          make_float4(acc[j][0], acc[j][2], acc[j + 1][0], acc[j + 1][2]);
      *reinterpret_cast<float4*>(r1 + 2 * j) =
          make_float4(acc[j][1], acc[j][3], acc[j + 1][1], acc[j + 1][3]);
    }
  }
  __syncthreads();
  const int nrows = min(ROWS, B - row0);
  const int n_el = nrows * COLS;
  for (int e = threadIdx.x; e < n_el; e += NTHREADS) {
    const int r = e / COLS, c = e % COLS;
    float v = red[0][r][c];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += red[w][r][c];
    red[0][r][c] = v;
  }
  // Every block's sum is in its red[0]; each block finishes its share of
  // the tile from the cluster's sums, added in rank order.
  cluster.sync();
  const int share = (n_el + C - 1) / C;
  const int e_end = min(n_el, (rank + 1) * share);
  for (int e = rank * share + static_cast<int>(threadIdx.x); e < e_end; e += NTHREADS) {
    const int r = e / COLS, c = e % COLS;
    // All ranks' sums are read at once, then added in rank order.
    float part[MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      part[q] = q < C ? *cluster.map_shared_rank(&red[0][r][c], q) : 0.f;
    float v = part[0];
#pragma unroll
    for (int q = 1; q < MAX_CLUSTER; ++q)
      if (q < C) v += part[q];
    const int nc = tile * COLS + c;
    if (nc >= N) continue;
    OutT y = from_float<OutT>(v);
    if (scale != nullptr)
      y = from_float<OutT>(to_float(y) * to_float(from_float<OutT>(scale[nc])));
    out[(long long)(row0 + r) * N + nc] = y;
  }
  // Keeps every block's shared memory until the cluster has read it.
  cluster.sync();
}

template <typename OutT, bool VEC>
cudaError_t launch_as(const void* x, long long sx, const void* qp, const void* scale, void* out,
                      int B, int K2, int N, int cluster, cudaStream_t st) {
  const int tiles = (N + COLS - 1) / COLS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cluster, (B + ROWS - 1) / ROWS, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int4_matmul_kernel<OutT, VEC>,
                            static_cast<const __nv_bfloat16*>(x), sx,
                            static_cast<const int8_t*>(qp), static_cast<const float*>(scale),
                            static_cast<OutT*>(out), B, K2, N);
}

template <typename OutT>
cudaError_t launch(const void* x, long long sx, const void* qp, const void* scale, void* out,
                   int B, int K2, int N, int cluster, cudaStream_t st) {
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(qp) % 16 == 0 && sx % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 8 == 0 && K2 % 2 == 0;
  return vec ? launch_as<OutT, true>(x, sx, qp, scale, out, B, K2, N, cluster, st)
             : launch_as<OutT, false>(x, sx, qp, scale, out, B, K2, N, cluster, st);
}

}  // namespace

// The blocks that one wave holds with clusters of 1 .. 8 blocks
// (blocks[c - 1]), from the occupancy of the launch configuration on the
// current device. Returns the CUDA error code.
extern "C" int int4_matmul_capacity(int* blocks) {
  auto kernel = int4_matmul_kernel<__nv_bfloat16, true>;
  cudaError_t err = cudaSuccess;
  for (int c = 1; c <= MAX_CLUSTER && err == cudaSuccess; ++c) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c * 64, 1, 1);
    cfg.blockDim = dim3(NTHREADS, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    blocks[c - 1] = clusters * c;
  }
  return static_cast<int>(err);
}

// Plain C entry point for ctypes. x [B, K = 2 K2] bf16 with row stride sx
// (elements, unit column stride); qp [K2, N] int8, contiguous; scale [N]
// f32 or null; out [B, N] contiguous, of out_kind 0 bf16, 1 f32, 2 f16;
// cluster: blocks splitting K per column tile (1..8). One launch. Returns
// the CUDA error code of the launch.
extern "C" int int4_matmul(const void* x, const void* qp, const void* scale, void* out, int B,
                           int K2, int N, long long sx, int cluster, int out_kind,
                           void* stream) {
  if (B <= 0 || N <= 0 || K2 < 0 || cluster < 1 || cluster > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_kind == 0)
    err = launch<__nv_bfloat16>(x, sx, qp, scale, out, B, K2, N, cluster, st);
  else if (out_kind == 1)
    err = launch<float>(x, sx, qp, scale, out, B, K2, N, cluster, st);
  else if (out_kind == 2)
    err = launch<__half>(x, sx, qp, scale, out, B, K2, N, cluster, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
