// Block-ELL SPMM kernel for Hopper (sm_90a), bound to Python with ctypes.
//
// K3 spmm_block_ell_launch replaces src/repro/kernels/spmm/spmm.py
//    spmm_block_ell_pallas (body _spmm_kernel).  For every 8-row block rb
//    it computes out[rb] (8 x N) = sum_{k < counts[rb]} vals[rb, k] (8 x 128)
//    @ rhs[colblocks[rb, k] * 128 : +128, :].  The TPU kernel loops over
//    k_max and masks k >= count with a 0/1 factor; for finite data skipping
//    those blocks gives the same sum, so this loop stops at counts[rb].
//
// Design: one CTA per row block, one thread per output column n (blockDim
// 128, looping when N is wider), eight f32 accumulators a thread, one for
// each row of the block.  For each occupied column block the CTA stages the
// (8 x 128) values in shared memory, transposed so that a thread reads the
// eight rows of one column as two 16-byte loads (a broadcast: every thread
// reads the same address); each rhs element is read once from global
// memory (L2: the 15 MB rhs stays resident) and used for eight rows.
//
// Arithmetic: IEEE f32 on the CUDA cores, no TF32.  Each term is a rounded
// multiply and a rounded add (__fmul_rn/__fadd_rn, never fused), summed
// in ascending column order, which the plain PyTorch version repeats op
// for op, so the two agree bitwise.  At the paper's size a row sums up to
// ~30k terms, and two summation orders differ by more than the reference's
// 1e-4 (chip_smoke.py prints how far cuSPARSE's CSR product lies from it),
// so only the same order can be held to it.  Fusing would halve the FP32 instructions; that is left for later.
//
// Bound: operations.  2 * 8 * 128 * N flops per occupied block; at the
// paper's size (sum of counts ~869k, N = 128) that is ~228 GFLOP, 3.4 ms at
// the 67 TFLOP/s f32 rate, against ~3.6 GB of values (1.1 ms at 3.35 TB/s).
//
// The entry point returns cudaGetLastError() so the wrapper can raise on a
// refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kRowBlock = 8;
constexpr int kColBlock = 128;
constexpr int kThreads = 128;

__global__ void spmm_block_ell_kernel(const int* __restrict__ counts,
                                      const int* __restrict__ colblocks,
                                      const float* __restrict__ vals,
                                      const float* __restrict__ rhs, float* __restrict__ out,
                                      int k_max, int n_dense) {
  __shared__ __align__(16) float a_t[kColBlock][kRowBlock];  // a_t[c][r] = vals[rb, k, r, c]
  const int rb = blockIdx.x;
  const int count = counts[rb];
  const int* cbs = colblocks + static_cast<long>(rb) * k_max;
  const float* v = vals + static_cast<long>(rb) * k_max * kRowBlock * kColBlock;
  for (int n0 = 0; n0 < n_dense; n0 += blockDim.x) {
    const int n = n0 + threadIdx.x;
    float acc[kRowBlock];
#pragma unroll
    for (int r = 0; r < kRowBlock; ++r) acc[r] = 0.0f;
    for (int k = 0; k < count; ++k) {
      __syncthreads();  // the previous block's values are no longer read
      const float* vk = v + static_cast<long>(k) * kRowBlock * kColBlock;
      for (int e = threadIdx.x; e < kRowBlock * kColBlock; e += blockDim.x) {
        a_t[e % kColBlock][e / kColBlock] = vk[e];
      }
      __syncthreads();
      if (n < n_dense) {
        const float* b = rhs + static_cast<long>(cbs[k]) * kColBlock * n_dense + n;
#pragma unroll 4
        for (int c = 0; c < kColBlock; ++c) {
          const float bv = b[static_cast<long>(c) * n_dense];
          const float4 lo = *reinterpret_cast<const float4*>(&a_t[c][0]);
          const float4 hi = *reinterpret_cast<const float4*>(&a_t[c][4]);
          acc[0] = __fadd_rn(acc[0], __fmul_rn(lo.x, bv));
          acc[1] = __fadd_rn(acc[1], __fmul_rn(lo.y, bv));
          acc[2] = __fadd_rn(acc[2], __fmul_rn(lo.z, bv));
          acc[3] = __fadd_rn(acc[3], __fmul_rn(lo.w, bv));
          acc[4] = __fadd_rn(acc[4], __fmul_rn(hi.x, bv));
          acc[5] = __fadd_rn(acc[5], __fmul_rn(hi.y, bv));
          acc[6] = __fadd_rn(acc[6], __fmul_rn(hi.z, bv));
          acc[7] = __fadd_rn(acc[7], __fmul_rn(hi.w, bv));
        }
      }
    }
    if (n < n_dense) {
#pragma unroll
      for (int r = 0; r < kRowBlock; ++r) {
        out[(static_cast<long>(rb) * kRowBlock + r) * n_dense + n] = acc[r];
      }
    }
  }
}

}  // namespace

extern "C" {

const char* spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int spmm_block_ell_launch(const int* counts, const int* colblocks, const float* vals,
                          const float* rhs, float* out, int n_row_blocks, int k_max,
                          int n_dense, void* stream) {
  if (n_row_blocks <= 0) return static_cast<int>(cudaGetLastError());
  spmm_block_ell_kernel<<<n_row_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      counts, colblocks, vals, rhs, out, k_max, n_dense);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
