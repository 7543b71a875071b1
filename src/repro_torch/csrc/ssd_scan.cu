// SSD (Mamba2) chunked scan (K5) for Hopper (sm_90a), bound to Python with ctypes.
//
// ssd_scan_launch replaces src/repro/kernels/ssd_scan/ssd_scan.py
//    ssd_scan_pallas (body _ssd_kernel).  Inputs x (B, S, H, P) already
//    scaled by dt, log_a (B, S, H), B and C (B, S, N), optionally the state
//    h0 (B, H, P, N) carried in; outputs y (B, S, H, P) and the final state
//    (B, H, P, N), all f32.  Per chunk of Q steps, with cs = cumsum(log_a):
//        y  = (C B^T * tril(exp(cs_i - cs_j))) x + exp(cs) (C h^T)
//        h' = exp(cs_Q) h + (x * exp(cs_Q - cs))^T B
//    A partial last chunk behaves as if padded with log_a = 0 and B = 0 (the
//    reference model's padding), so the final state is that of the S steps.
//
// Design, two kernels on one stream:
//  1. ssd_gram_kernel: G = C B^T for every chunk, once per (batch, chunk)
//     and not once per head (B and C are shared by the heads; the TPU
//     kernel recomputes it per head).  32 x 32 output tiles, only those on
//     or below the diagonal; stored transposed (G^T[j][i]) so that the scan
//     reads it coalesced.  At mamba2's chunk of 256 the (Q, Q) block is
//     256 KB, more than a CTA's shared memory, so it lives in device memory
//     (L2: 2 MB for S = 2048).
//  2. ssd_scan_kernel: one CTA per (head, block of 16 of the P columns,
//     batch) walks the chunks in order.  Columns of the state are
//     independent, so splitting P gives 4 x more CTAs than the TPU grid
//     (B, H).  The CTA keeps its (16 x N) state slice in shared memory, and
//     for each chunk stages cs (an in-block scan) and the x slice; thread i
//     computes row i of y over j <= i only (exp(cs_i - cs_j) is never formed
//     above the diagonal, where it overflows), then the threads update the
//     state slice.
//
// Bound on the card: operations, at mamba2's prefill (S 2048, H 24, P 64,
// N 128, Q 256): ~1.9 GFLOP of f32 multiply-adds against ~35 MB of inputs
// and outputs.  All arithmetic is f32 on the CUDA cores (the tolerance is
// 2e-4); the scan kernel has 96 CTAs for one batch-1 prefill, fewer than
// the 132 SMs.
//
// The entry point returns cudaGetLastError() so the wrapper can raise on a
// refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kPB = 16;            // state columns (of P) per scan CTA
constexpr int kScanThreads = 256;
constexpr int kScanPerThread = 4;  // chunk <= kScanThreads * kScanPerThread

__global__ void __launch_bounds__(kTile * 8)
ssd_gram_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                float* __restrict__ gram_t, int seq, int n_state, int chunk, int n_chunks) {
  __shared__ float c_t[kTile][kTile + 1];  // [n][i]
  __shared__ float b_t[kTile][kTile + 1];  // [n][j]
  const int it = blockIdx.x, jt = blockIdx.y;
  if (jt > it) return;  // strictly above the diagonal: never read
  const int bc = blockIdx.z;
  const int b = bc / n_chunks, c = bc % n_chunks;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long row_base = static_cast<long>(b) * seq + static_cast<long>(c) * chunk;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int n0 = 0; n0 < n_state; n0 += kTile) {
    const int n = n0 + tx;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = ty + 8 * k;
      const int i = it * kTile + r, j = jt * kTile + r;
      const bool n_ok = n < n_state;
      c_t[tx][r] = (n_ok && i < chunk && c * chunk + i < seq)
                       ? cm[(row_base + i) * n_state + n] : 0.0f;
      b_t[tx][r] = (n_ok && j < chunk && c * chunk + j < seq)
                       ? bm[(row_base + j) * n_state + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int nn = 0; nn < kTile; ++nn) {
      const float cv = c_t[nn][tx];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = fmaf(cv, b_t[nn][ty + 8 * k], acc[k]);
    }
    __syncthreads();
  }
  const int i = it * kTile + tx;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = jt * kTile + ty + 8 * k;
    if (i < chunk && j < chunk) gram_t[(static_cast<long>(bc) * chunk + j) * chunk + i] = acc[k];
  }
}

__global__ void __launch_bounds__(kScanThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ log_a,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ gram_t, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out, int seq, int heads,
                int head_dim, int n_state, int chunk, int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  const int chunk_pad = (chunk + 3) & ~3;
  float* cs = smem;                  // [chunk]        cumsum of log_a
  float* xs = cs + chunk_pad;        // [chunk][kPB]   x slice (then x * decay)
  float* hs = xs + chunk * kPB;      // [n_state][kPB] state slice, transposed
  const int h = blockIdx.x;
  const int p0 = blockIdx.y * kPB;
  const int b = blockIdx.z;
  const int pb = min(kPB, head_dim - p0);
  const int tid = threadIdx.x;
  const long hp_base = (static_cast<long>(b) * heads + h) * head_dim + p0;  // (b, h, p0)

  for (int e = tid; e < n_state * kPB; e += kScanThreads) {
    const int n = e / kPB, pp = e % kPB;
    hs[e] = (h0 != nullptr && pp < pb) ? h0[(hp_base + pp) * n_state + n] : 0.0f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * chunk;
    const int valid = min(chunk, seq - t0);
    const long row0 = static_cast<long>(b) * seq + t0;  // (b, t0) in (B, S)
    __syncthreads();  // the previous chunk is done with cs, xs and hs
    for (int i = tid; i < chunk; i += kScanThreads)
      cs[i] = i < valid ? log_a[(row0 + i) * heads + h] : 0.0f;
    for (int e = tid; e < chunk * kPB; e += kScanThreads) {
      const int j = e / kPB, pp = e % kPB;
      xs[e] = (j < valid && pp < pb) ? x[((row0 + j) * heads + h) * head_dim + p0 + pp] : 0.0f;
    }
    // inclusive scan of cs (Hillis-Steele)
    for (int off = 1; off < chunk; off <<= 1) {
      __syncthreads();
      float add[kScanPerThread];
#pragma unroll
      for (int k = 0; k < kScanPerThread; ++k) {
        const int i = tid + k * kScanThreads;
        add[k] = (i < chunk && i >= off) ? cs[i - off] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kScanPerThread; ++k) {
        const int i = tid + k * kScanThreads;
        if (i < chunk) cs[i] += add[k];
      }
    }
    __syncthreads();

    // y: thread i takes row i
    const float* g_chunk = gram_t + static_cast<long>(b * n_chunks + c) * chunk * chunk;
    for (int i = tid; i < valid; i += kScanThreads) {
      const float cs_i = cs[i];
      float acc[kPB];
#pragma unroll
      for (int pp = 0; pp < kPB; ++pp) acc[pp] = 0.0f;
      for (int j = 0; j <= i; ++j) {
        const float w = g_chunk[static_cast<long>(j) * chunk + i] * expf(cs_i - cs[j]);
        const float4* xr = reinterpret_cast<const float4*>(&xs[j * kPB]);
#pragma unroll
        for (int q4 = 0; q4 < kPB / 4; ++q4) {
          const float4 xv = xr[q4];
          acc[4 * q4 + 0] = fmaf(w, xv.x, acc[4 * q4 + 0]);
          acc[4 * q4 + 1] = fmaf(w, xv.y, acc[4 * q4 + 1]);
          acc[4 * q4 + 2] = fmaf(w, xv.z, acc[4 * q4 + 2]);
          acc[4 * q4 + 3] = fmaf(w, xv.w, acc[4 * q4 + 3]);
        }
      }
      float inter[kPB];
#pragma unroll
      for (int pp = 0; pp < kPB; ++pp) inter[pp] = 0.0f;
      const float* c_row = cm + (row0 + i) * n_state;
      for (int n = 0; n < n_state; ++n) {
        const float cv = c_row[n];
        const float4* hr = reinterpret_cast<const float4*>(&hs[n * kPB]);
#pragma unroll
        for (int q4 = 0; q4 < kPB / 4; ++q4) {
          const float4 hv = hr[q4];
          inter[4 * q4 + 0] = fmaf(cv, hv.x, inter[4 * q4 + 0]);
          inter[4 * q4 + 1] = fmaf(cv, hv.y, inter[4 * q4 + 1]);
          inter[4 * q4 + 2] = fmaf(cv, hv.z, inter[4 * q4 + 2]);
          inter[4 * q4 + 3] = fmaf(cv, hv.w, inter[4 * q4 + 3]);
        }
      }
      const float e_i = expf(cs_i);
      float* y_row = y + ((row0 + i) * heads + h) * head_dim + p0;
#pragma unroll
      for (int pp = 0; pp < kPB; ++pp)
        if (pp < pb) y_row[pp] = acc[pp] + e_i * inter[pp];
    }
    __syncthreads();  // y is done with hs and xs

    // state: h' = exp(cs_Q) h + sum_j (x_j exp(cs_Q - cs_j)) B_j
    const float cs_last = cs[chunk - 1];
    for (int e = tid; e < valid * kPB; e += kScanThreads) xs[e] *= expf(cs_last - cs[e / kPB]);
    __syncthreads();
    const float e_last = expf(cs_last);
    for (int e = tid; e < n_state * kPB; e += kScanThreads) {
      const int n = e / kPB, pp = e % kPB;
      float acc = 0.0f;
      for (int j = 0; j < valid; ++j) acc = fmaf(xs[j * kPB + pp], bm[(row0 + j) * n_state + n], acc);
      hs[e] = e_last * hs[e] + acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < n_state * kPB; e += kScanThreads) {
    const int n = e / kPB, pp = e % kPB;
    if (pp < pb) h_out[(hp_base + pp) * n_state + n] = hs[e];
  }
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, y (B, S, H, P); log_a (B, S, H); bm, cm (B, S, N); h0 (nullable), h_out
// (B, H, P, N); gram (B, n_chunks, chunk, chunk) scratch.  f32, contiguous.
int ssd_scan_launch(const float* x, const float* log_a, const float* bm, const float* cm,
                    const float* h0, float* y, float* h_out, float* gram, int batch, int seq,
                    int heads, int head_dim, int n_state, int chunk, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 || n_state <= 0 || chunk <= 0 ||
      chunk > kScanThreads * kScanPerThread)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (seq + chunk - 1) / chunk;
  if (static_cast<long>(batch) * n_chunks > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);  // grid z limit
  const int tiles = (chunk + kTile - 1) / kTile;
  ssd_gram_kernel<<<dim3(tiles, tiles, batch * n_chunks), dim3(kTile, 8), 0, s>>>(
      bm, cm, gram, seq, n_state, chunk, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = (((chunk + 3) & ~3) + chunk * kPB + n_state * kPB) * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(heads, (head_dim + kPB - 1) / kPB, batch);
  ssd_scan_kernel<<<grid, kScanThreads, smem, s>>>(x, log_a, bm, cm, gram, h0, y, h_out, seq,
                                                   heads, head_dim, n_state, chunk, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
