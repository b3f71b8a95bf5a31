// The CLIP attention block's two GEMMs, for Hopper (sm_90a):
//
//   C[M,N] = bf16( A[M,K] @ W[K,N] + bias[N] )
//
// Part of the port of the TPU kernel `_block_kernel`
// (vcoder_tpu/ops/vit_attention.py:52, K2), the fused CLIP attention block.
// That kernel runs the QKV projection, the bidirectional attention and the
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
// The GEMM is the shared mainloop of gemm_sm90.cuh (TMA ring of 4 stages of
// 64-deep K, wgmma from two ping-pong consumer warpgroups, 64 x 256 tiles,
// persistent) with its bias epilogue. The weights are read in their
// parameter layout: the QKV weight is the column concatenation [Dm, 3*Dm]
// (q columns pre-scaled) and the out-projection [Dm, Dm] as stored, both
// MN-major, so no transpose is made per call. What bounds it: at the
// tower's shapes (M = 1731, K = 1024) the QKV product is 10.9 GFLOP in 336
// tiles (2.5 waves on 132 SMs) and the out-projection 3.6 GFLOP in 112
// (0.85 of a wave); the tensor cores bound both (0.0147 ms together at 989
// TFLOP/s). nvcc: 168 registers at entry (40 / 232 after setmaxnreg), no
// spills, 164,944 bytes of shared memory; the SASS issues HGMMA fed by
// UTMALDG.

#include "gemm_sm90.cuh"

// Plain C entry point for ctypes. A [M,K], W [K,N] and C [M,N] are
// contiguous bf16; bias is f32 [N] or null. K and N must be multiples of 8
// and the bf16 buffers 16-byte aligned (checked by the Python wrapper).
// Returns a CUDA error code or 0.
extern "C" int gemm_bias(const void* A, const void* W, const float* bias, void* C, int M, int N,
                         int K, void* stream) {
  return sm90::gemm<sm90::kBias>(A, W, bias, 0, nullptr, C, M, N, K,
                                 static_cast<cudaStream_t>(stream));
}
