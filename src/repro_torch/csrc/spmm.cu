// Block-ELL SPMM kernel for Hopper (sm_90a), bound to Python with ctypes.
//
// K3 spmm_block_ell_launch replaces src/repro/kernels/spmm/spmm.py
//    spmm_block_ell_pallas (body _spmm_kernel).  For every 8-row block rb
//    it computes out[rb] (8 x N) = sum_{k < counts[rb]} vals[rb, k] (8 x 128)
//    @ rhs[colblocks[rb, k] * 128 : +128, :].  The TPU kernel loops over
//    k_max and masks k >= count with a 0/1 factor, and multiplies every
//    block densely.
//
// Exactness.  The result equals the plain version (spmm.py
// spmm_block_ell_plain) bitwise: each row sums its terms in ascending
// (k, c) order, each a rounded multiply and a rounded add (__fmul_rn /
// __fadd_rn, never fused), IEEE f32 on the CUDA cores, no TF32.  The plain
// version adds every entry of every block, zeros included; this kernel
// adds only the nonzero ones.  For finite rhs the two agree: a zero value
// gives a term of +-0, acc + (+-0) is acc, and acc, which starts at +0,
// never becomes -0 (x + y rounds to -0 only when both are -0).  Skipping
// the blocks k >= count already relies on the same argument.
//
// Bound: bytes.  The function must read vals once (count x 4 KB per row
// block, 3.56 GB at the paper's size), plus rhs, out and the indices: 3.59
// GB, 1.07 ms at 3.35 TB/s.  Its nonzero multiply-adds (2 * nnz * N flops,
// 1.5 GFLOP there) take 0.02 ms at the f32 rate.  Only 0.66 % of an
// occupied block is nonzero there, so a dense product of each block (228
// GFLOP of unfused f32 instructions, and 128 rhs rows read from L2 per
// block) would bound the kernel at operations, far from the bytes.
//
// Design: one CTA per row block (and per 128 output columns), 512 threads.
//  - A row block's occupied blocks vals[rb, 0:count] are one contiguous run
//    of count x 4 KB.  Thread 0 streams it through a ring of 3 stages of 8
//    blocks (32 KB each) with 1-D bulk copies (cp.async.bulk) that
//    complete on one mbarrier per stage, so up to 64 KB per CTA, two CTAs
//    per SM, are in flight while the CTA works on the current stage.  The
//    copies carry an L2 evict-first policy, so the stream does not push
//    rhs out of L2.
//  - For each stage, warp w finds row w's nonzero columns with ballots and
//    writes them compacted, in ascending (k, c), as (value, k-in-stage *
//    128 + c): the value in place over the stage's own copy, the index in
//    a 16 KB list.
//  - Each thread owns one output column n and two rows.  It walks each
//    row's compacted list, reads the rhs row rhs[cb_k * 128 + c, n] from
//    L2 (a warp reads 128 contiguous bytes), eight loads in flight before
//    their eight ordered multiply-adds.  About 6.8 nonzeros a block thus
//    replace 128 rhs rows and 1024 multiply-adds per column and block.
// Offsets into vals are 64-bit: they exceed 2^31 bytes at the paper's size.
//
// The entry point returns cudaGetLastError() so the wrapper can raise on a
// refused launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kRowBlock = 8;
constexpr int kColBlock = 128;
constexpr int kBlockFloats = kRowBlock * kColBlock;
constexpr int kBlockBytes = kBlockFloats * static_cast<int>(sizeof(float));
constexpr int kStageBlocks = 8;
constexpr int kStages = 3;
constexpr int kThreads = 512;
constexpr int kRowsPerThread = kRowBlock * kColBlock / kThreads;
constexpr int kBatch = 8;  // rhs loads in flight per thread

struct Smem {
  float vals[kStages][kStageBlocks * kBlockFloats];
  uint16_t idx[kRowBlock][kStageBlocks * kColBlock];  // (block in stage) * 128 + c
  int cb[kStageBlocks];                                 // the stage's column blocks
  int nnz[kRowBlock];                                   // entries in each row's list
  uint64_t full[kStages];
};

// Where entry e of row r's compacted list keeps its value: in place over
// the row's own segments of the stage, so entry e lands at or before the
// element it came from.
__device__ __forceinline__ int entry_offset(int r, int e) {
  return (e >> 7) * kBlockFloats + r * kColBlock + (e & (kColBlock - 1));
}

__global__ void __launch_bounds__(kThreads, 2)
spmm_block_ell_kernel(const int* __restrict__ counts, const int* __restrict__ colblocks,
                      const float* __restrict__ vals, const float* __restrict__ rhs,
                      float* __restrict__ out, int k_max, int n_dense) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int rb = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n = blockIdx.y * kColBlock + tid % kColBlock;
  const int r0 = tid / kColBlock * kRowsPerThread;
  const int count = counts[rb];
  const int n_stages = (count + kStageBlocks - 1) / kStageBlocks;
  const int* cbs = colblocks + static_cast<int64_t>(rb) * k_max;
  const char* src = reinterpret_cast<const char*>(vals) +
                    static_cast<int64_t>(rb) * k_max * kBlockBytes;

  // vals streams through L2 once: evicting it first keeps rhs (15 MB at
  // the paper's size, read again by every row block) resident
  const uint64_t stream_once = sm90::l2_evict_first();
  auto load_stage = [&](int i) {  // stage i of the row block into ring slot i % kStages
    const int nb = min(kStageBlocks, count - i * kStageBlocks);
    sm90::bulk_load(sm90::smem_u32(sm.vals[i % kStages]),
                    src + static_cast<int64_t>(i) * kStageBlocks * kBlockBytes,
                    static_cast<uint32_t>(nb * kBlockBytes), sm90::smem_u32(&sm.full[i % kStages]),
                    stream_once);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(sm90::smem_u32(&sm.full[s]), 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < kStages && i < n_stages; ++i) load_stage(i);
  }

  float acc[kRowsPerThread];
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) acc[rr] = 0.0f;

  for (int i = 0; i < n_stages; ++i) {
    const int slot = i % kStages;
    const int nb = min(kStageBlocks, count - i * kStageBlocks);
    float* stage = sm.vals[slot];
    sm90::mbar_wait(sm90::smem_u32(&sm.full[slot]), (i / kStages) & 1);

    // compact: warp w lists row w's nonzeros in ascending (k, c)
    if (warp < kRowBlock) {
      const unsigned below = (1u << lane) - 1u;
      int pos = 0;
      for (int kk = 0; kk < nb; ++kk) {
        const float* row = stage + kk * kBlockFloats + warp * kColBlock;
        float x[4];
        unsigned live[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[j] = row[32 * j + lane];
          live[j] = __ballot_sync(0xffffffffu, x[j] != 0.0f);
        }
        __syncwarp();  // the whole segment is read before entries overwrite it
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (x[j] != 0.0f) {
            const int e = pos + __popc(live[j] & below);
            stage[entry_offset(warp, e)] = x[j];
            sm.idx[warp][e] = static_cast<uint16_t>(kk * kColBlock + 32 * j + lane);
          }
          pos += __popc(live[j]);
        }
        __syncwarp();
      }
      if (lane == 0) sm.nnz[warp] = pos;
    }
    if (tid < nb) sm.cb[tid] = cbs[i * kStageBlocks + tid];
    __syncthreads();

    // accumulate: rows r0.., column n, entries in list order
    if (n < n_dense) {
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr) {
        const int r = r0 + rr;
        const int cnt = sm.nnz[r];
        for (int e0 = 0; e0 < cnt; e0 += kBatch) {
          float v[kBatch], b[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (e0 + u < cnt) {
              const int id = sm.idx[r][e0 + u];
              v[u] = stage[entry_offset(r, e0 + u)];
              const int64_t rhs_row =
                  static_cast<int64_t>(sm.cb[id / kColBlock]) * kColBlock + id % kColBlock;
              b[u] = __ldg(rhs + rhs_row * n_dense + n);
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (e0 + u < cnt) acc[rr] = __fadd_rn(acc[rr], __fmul_rn(v[u], b[u]));
          }
        }
      }
    }
    // the slot was written in place by this proxy; the next bulk copy into
    // it is the async proxy's
    sm90::fence_proxy_async();
    __syncthreads();
    if (tid == 0 && i + kStages < n_stages) load_stage(i + kStages);
  }

  if (n < n_dense) {
#pragma unroll
    for (int rr = 0; rr < kRowsPerThread; ++rr) {
      out[(static_cast<int64_t>(rb) * kRowBlock + r0 + rr) * n_dense + n] = acc[rr];
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
  if (n_row_blocks <= 0 || n_dense <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(spmm_block_ell_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_row_blocks),
                  static_cast<unsigned>((n_dense + kColBlock - 1) / kColBlock));
  spmm_block_ell_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      counts, colblocks, vals, rhs, out, k_max, n_dense);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
