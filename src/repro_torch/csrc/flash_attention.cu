// Flash attention forward (K4) for Hopper (sm_90a), bound to Python with ctypes.
//
// flash_attention_launch replaces src/repro/kernels/flash_attention/
//    flash_attention.py flash_attention_pallas (body _flash_kernel): GQA
//    attention over q (B, Sq, H, D) and k, v (B, Sk, KVH, D), the G = H/KVH
//    query heads of one kv head sharing its keys, with an online softmax in
//    f32 (running max m, denominator l, accumulator acc) and the output
//    acc / max(l, 1e-30) in q's dtype.  Masks as in the TPU kernel: causal
//    is top-left aligned (query i sees keys j <= i), the window keeps
//    j > i - window, and masked scores are -0.7 * FLT_MAX (not -inf), so a
//    fully masked tile behaves as it does there.  Keys past Sk and query
//    rows past Sq (the ragged last tiles) are masked here, so any length
//    runs through the kernel.
//
// Design: one CTA per (batch, kv head, block of 64 query rows), where a
// row is one (position i, group g) pair, numbered i * G + g: the G heads
// of a position are adjacent in memory and share the CTA's keys.  The
// CTA stages its q rows (scaled, as f32, transposed) once, then walks the
// keys in tiles of 64: K (transposed) and V tiles are staged in shared
// memory as f32; each of the 128 threads computes an 8 x 4 block of the
// 64 x 64 score tile on the CUDA cores (FMA, no tensor cores), the row max
// and sum are reduced across the 16 threads that share a row with warp
// shuffles, P goes through shared memory, and each thread accumulates an
// 8 x D/16 block of the output in registers.  A causal CTA stops at the
// tile that holds its last row's diagonal, as the TPU kernel does.
//
// Bound on the card: operations.  kernel_flops = 4 * B * H * Sq * Sk * D
// (halved when causal); for tinyllama's prefill at S = 2048 that is 17.2
// GFLOP against 25 MB of q, k, v, o.  The bound uses the bf16 tensor-core
// peak for bf16 inputs; this kernel runs on the CUDA cores in f32, so it
// can reach at most the f32 rate (67 TFLOP/s): moving the two products to
// wgmma is the first step to its bound.
//
// The entry point returns cudaGetLastError() so the wrapper can raise on a
// refused launch.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;      // query rows (position, group) per CTA
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 128;  // 8 row groups x 16 column groups
constexpr int kRowsPerThread = 8;
constexpr int kKeysPerThread = 4;
constexpr int kPad = 4;        // keeps float4 alignment of the transposed tiles
constexpr int kQStride = kRows + kPad;
constexpr int kKStride = kKeys + kPad;
constexpr float kMaskValue = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sum over the 16 lanes that share a row, read back from the first of them
// so that every lane holds the same rounding of the sum.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, threadIdx.x & 16);
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int D>
constexpr int smem_floats() {
  return D * kQStride + D * kKStride + kKeys * D + kKeys * kQStride;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int seq_q, int seq_k, int heads, int kv_heads, int causal,
                 int window, float scale) {
  constexpr int kCols = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [D][kQStride]   q rows, transposed
  float* ks = qs + D * kQStride;         // [D][kKStride]   key tile, transposed
  float* vs = ks + D * kKStride;         // [kKeys][D]      value tile
  float* ps = vs + kKeys * D;            // [kKeys][kQStride] probabilities, transposed

  const int groups = heads / kv_heads;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int total_rows = seq_q * groups;
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;

  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int rho = row0 + r;
    float val = 0.0f;
    if (rho < total_rows) {
      const int i = rho / groups, g = rho % groups;
      val = to_f32(q[((static_cast<long>(b) * seq_q + i) * heads + kvh * groups + g) * D + d]) *
            scale;
    }
    qs[d * kQStride + r] = val;
  }

  int q_pos[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) q_pos[r] = (row0 + tr * kRowsPerThread + r) / groups;

  int n_tiles = (seq_k + kKeys - 1) / kKeys;
  if (causal) {
    const int last_pos = (min(row0 + kRows, total_rows) - 1) / groups;
    n_tiles = min(n_tiles, (last_pos + kKeys) / kKeys);
  }

  float m_run[kRowsPerThread], l_run[kRowsPerThread], acc[kRowsPerThread][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    m_run[r] = kMaskValue;
    l_run[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  const long kv_base = static_cast<long>(b) * seq_k;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int e = tid; e < kKeys * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const int kp = k0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (kp < seq_k) {
        const long idx = ((kv_base + kp) * kv_heads + kvh) * D + d;
        kv = to_f32(k[idx]);
        vv = to_f32(v[idx]);
      }
      ks[d * kKStride + j] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) s[r][jj] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&qs[d * kQStride + tr * 8]);
      const float4 qb = *reinterpret_cast<const float4*>(&qs[d * kQStride + tr * 8 + 4]);
      const float4 kk = *reinterpret_cast<const float4*>(&ks[d * kKStride + tc * 4]);
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int jj = 0; jj < kKeysPerThread; ++jj) s[r][jj] = fmaf(qv[r], kv[jj], s[r][jj]);
    }

#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      float mx = kMaskValue;
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) {
        const int kp = k0 + tc * 4 + jj;
        bool keep = kp < seq_k;
        if (causal) keep = keep && kp <= q_pos[r];
        if (window) keep = keep && kp > q_pos[r] - window;
        if (!keep) s[r][jj] = kMaskValue;
        mx = fmaxf(mx, s[r][jj]);
      }
      const float m_new = fmaxf(m_run[r], row_max(mx));
      const float alpha = expf(m_run[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) {
        const int kp = k0 + tc * 4 + jj;
        // keys past Sk are not there at all: they add nothing to l
        const float p = kp < seq_k ? expf(s[r][jj] - m_new) : 0.0f;
        s[r][jj] = p;
        sum += p;
      }
      l_run[r] = l_run[r] * alpha + row_sum(sum);
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < kKeysPerThread; ++jj) {
      float* dst = &ps[(tc * 4 + jj) * kQStride + tr * 8];
      *reinterpret_cast<float4*>(dst) = make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(s[4][jj], s[5][jj], s[6][jj], s[7][jj]);
    }
    __syncthreads();

    const int n_keys = min(kKeys, seq_k - k0);
    for (int j = 0; j < n_keys; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(&ps[j * kQStride + tr * 8]);
      const float4 pb = *reinterpret_cast<const float4*>(&ps[j * kQStride + tr * 8 + 4]);
      const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vs[j * D + tc + 16 * c];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int rho = row0 + tr * kRowsPerThread + r;
    if (rho >= total_rows) continue;
    const int i = rho / groups, g = rho % groups;
    const float denom = fmaxf(l_run[r], 1e-30f);
    T* dst = o + ((static_cast<long>(b) * seq_q + i) * heads + kvh * groups + g) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[tc + 16 * c] = from_f32<T>(acc[r][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int seq_q,
                   int seq_k, int heads, int kv_heads, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long row_blocks = (static_cast<long>(seq_q) * (heads / kv_heads) + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned>(row_blocks), kv_heads, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), seq_q, seq_k, heads, kv_heads, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int head_dim, const void* q, const void* k, const void* v, void* o,
                       int batch, int seq_q, int seq_k, int heads, int kv_heads, int causal,
                       int window, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, o, batch, seq_q, seq_k, heads, kv_heads, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, batch, seq_q, seq_k, heads, kv_heads, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, batch, seq_q, seq_k, heads, kv_heads, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, batch, seq_q, seq_k, heads, kv_heads, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 float32, 1 bfloat16.  q, o (B, Sq, H, D) and k, v (B, Sk, KVH, D),
// contiguous, on the card.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int batch,
                           int seq_q, int seq_k, int heads, int kv_heads, int head_dim,
                           int dtype, int causal, int window, float scale, void* stream) {
  if (batch <= 0 || seq_q <= 0 || seq_k <= 0 || kv_heads <= 0 || heads % kv_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dim<float>(head_dim, q, k, v, o, batch, seq_q, seq_k, heads, kv_heads, causal,
                            window, scale, s);
  } else if (dtype == 1) {
    err = launch_dim<__nv_bfloat16>(head_dim, q, k, v, o, batch, seq_q, seq_k, heads, kv_heads,
                                    causal, window, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
