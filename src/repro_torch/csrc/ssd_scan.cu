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
// The output does not depend on the chunk length, so the kernels work at
// their own sub-chunk of kSub = 64 steps, whatever chunk the caller names
// (mamba2's is 256): the quadratic term is 4x smaller than at 256 and there
// are 4x as many independent units.  The TPU kernel walks the chunks of a
// (batch, head) in order; here only the small state recurrence is walked in
// order.  Three kernels on one stream:
//  1. ssd_state_kernel, a CTA per (sub-chunk, head, batch x 64 columns of
//     P): cs by a warp scan, the sub-chunk's decay exp(cs_Q) and its state
//     contribution s_c = (x * exp(cs_Q - cs))^T B, a register-tiled product
//     (4 x 8 outputs a thread) from shared memory.  An extra row of CTAs
//     (head index H) forms G = C B^T of each sub-chunk once, shared by the
//     heads (B and C are (B, S, N)).
//  2. ssd_pass_kernel, a thread per (batch, head, state element): runs
//     h_c = exp(cs_Q,c) h_{c-1} + s_c over the sub-chunks in order from h0
//     (or zeros), overwrites s_c with the state entering sub-chunk c and
//     writes the final state.  The states scratch, (B, S/64, H, P, N) f32
//     like h0, is 25 MB at mamba2's S 2048 (half the 50 MB L2).
//  3. ssd_output_kernel, a CTA per (sub-chunk, head, batch x 64 columns of
//     P): y = diag(exp cs) (C h_in^T) + (G * L) x, one register-tiled
//     product (4 x 4 outputs a thread) over N + 64 terms, 64 at a time.
//     exp(cs_i - cs_j) is formed once per (i, j) a CTA and only on or below
//     the diagonal, where it cannot overflow; the warps skip the columns of
//     the intra-chunk term above their rows.
// Kernels 1 and 3 stage their operands with cp.async into two buffers, so
// the next slab's loads overlap the current slab's products (zero-filled
// past the sequence, N and P; h_in lands transposed).
//
// Bound on the card: operations, at mamba2's prefill (S 2048, H 24, P 64,
// N 128): ~1.7 GFLOP of f32 multiply-adds against ~28 MB of inputs and
// outputs.  All arithmetic is IEEE f32 on the CUDA cores (the tolerance is
// 2e-4; TF32 operands would not hold it).
//
// ssd_scan_backward_launch is the gradient of the same function (below, after
// the forward's kernels): the JAX package differentiates plain jnp code with
// XLA, and this is the port's kernel for it.
//
// The entry points return cudaGetLastError() so the wrapper can raise on a
// refused launch.

#include <cuda_runtime.h>

#include <mutex>

#include "sm90.cuh"

namespace {

constexpr int kSub = 64;        // steps of a sub-chunk
constexpr int kThreads = 256;
constexpr int kPTile = 64;      // columns of P a CTA of kernels 1 and 3 takes
constexpr int kNBlock = 128;    // rows of N kernel 1 computes at once
constexpr int kGramStride = kSub + 4;  // padded row of a staged 64-column slab of B or C
constexpr int kBStride = kPTile + 4;  // padded row of kernel 3's [k][p] operand
constexpr int kMaxState = 256;
constexpr int kMaxDevices = 64;
// dynamic shared memory of kernel 1: two stages, each half the steps of x
// and of a block of B's columns
constexpr int kHalf = kSub / 2;
constexpr int kStateStage = kHalf * kPTile + kHalf * kNBlock;
constexpr int kStateSmem = 2 * kStateStage * sizeof(float);
static_assert(2 * kSub * kGramStride * sizeof(float) <= kStateSmem, "gram slabs fit");

// cs[j] = log_a[t0] + ... + log_a[t0 + j] for j < kSub (0 past the sequence),
// by the first warp, 2 steps a lane.  Callers __syncthreads() after it.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ log_a, long row0,
                                             int heads, int h, int valid, float* cs) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, j0 = 2 * lane;
  const float v0 = j0 < valid ? log_a[(row0 + j0) * heads + h] : 0.0f;
  const float v1 = j0 + 1 < valid ? log_a[(row0 + j0 + 1) * heads + h] : 0.0f;
  float incl = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  cs[j0] = excl + v0;
  cs[j0 + 1] = cs[j0] + v1;
}

// G = C B^T of one sub-chunk (rows past the sequence are 0), row-major
// kSub x kSub; thread (ty, tx) computes rows 4ty.. and columns tx + 16s.
__device__ void gram_tile(const float* __restrict__ bm, const float* __restrict__ cm,
                          float* __restrict__ g, long row0, int valid, int n_state,
                          float* smem) {
  float* ct = smem;                      // [kSub][kGramStride] C slab
  float* bt = ct + kSub * kGramStride;   // [kSub][kGramStride] B slab
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < n_state; n0 += kSub) {
    __syncthreads();
#pragma unroll 4
    for (int it = 0; it < kSub * kSub / kThreads; ++it) {
      const int e = tid + it * kThreads, i = e / kSub, n = e % kSub;
      const bool ok = i < valid && n0 + n < n_state;
      ct[i * kGramStride + n] = ok ? cm[(row0 + i) * n_state + n0 + n] : 0.0f;
      bt[i * kGramStride + n] = ok ? bm[(row0 + i) * n_state + n0 + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < kSub; k += 4) {
      float4 a[4], w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const float4*>(&ct[(4 * ty + r) * kGramStride + k]);
#pragma unroll
      for (int s = 0; s < 4; ++s)
        w[s] = *reinterpret_cast<const float4*>(&bt[(tx + 16 * s) * kGramStride + k]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          float v = acc[r][s];
          v = fmaf(a[r].x, w[s].x, v);
          v = fmaf(a[r].y, w[s].y, v);
          v = fmaf(a[r].z, w[s].z, v);
          acc[r][s] = fmaf(a[r].w, w[s].w, v);
        }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) g[(4 * ty + r) * kSub + tx + 16 * s] = acc[r][s];
}

__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ log_a,
                 const float* __restrict__ bm, const float* __restrict__ cm,
                 float* __restrict__ states, float* __restrict__ decay,
                 float* __restrict__ gram, int seq, int heads, int head_dim, int n_state,
                 int p_tiles, int reverse) {
  extern __shared__ __align__(16) float smem[];
  // cumsum of log_a; exp(cs_Q - cs_j), or in reverse mode (the backward's) exp(cs_j)
  __shared__ float cs[kSub], w[kSub];
  const int c = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / p_tiles, pt = blockIdx.z - b * p_tiles;
  const int n_sub = gridDim.x;
  const int t0 = c * kSub, valid = min(kSub, seq - t0);
  const long row0 = static_cast<long>(b) * seq + t0;  // (b, t0) in (B, S)
  const long bc = static_cast<long>(b) * n_sub + c;   // (b, c) in (B, S/kSub)
  if (h == heads) {
    if (pt == 0) gram_tile(bm, cm, gram + bc * kSub * kSub, row0, valid, n_state, smem);
    return;
  }
  const int tid = threadIdx.x, p0 = pt * kPTile;
  // stage sl: rows 32 (sl % 2).. of x (then scaled by w) and of a block of
  // B's columns (block sl / 2), by cp.async, zero past the sequence
  auto issue = [&](int sl, int st) {
    float* xs = smem + st * kStateStage;  // [kHalf][kPTile]
    float* bs = xs + kHalf * kPTile;       // [kHalf][kNBlock]
    const int j0 = (sl % 2) * kHalf, n0 = (sl / 2) * kNBlock;
#pragma unroll 4
    for (int it = 0; it < kHalf * kPTile / kThreads; ++it) {
      const int e = tid + it * kThreads, j = j0 + e / kPTile, p = e % kPTile;
      const bool ok = j < valid && p0 + p < head_dim;
      sm90::cp_async4(sm90::smem_u32(&xs[e]),
                      ok ? &x[((row0 + j) * heads + h) * head_dim + p0 + p] : x, ok);
    }
#pragma unroll 4
    for (int it = 0; it < kHalf * kNBlock / kThreads; ++it) {
      const int e = tid + it * kThreads, j = j0 + e / kNBlock, n = e % kNBlock;
      const bool ok = j < valid && n0 + n < n_state;
      sm90::cp_async4(sm90::smem_u32(&bs[e]), ok ? &bm[(row0 + j) * n_state + n0 + n] : bm, ok);
    }
    sm90::cp_async_commit();
  };
  const int total = 2 * ((n_state + kNBlock - 1) / kNBlock);
  issue(0, 0);
  issue(1, 1);
  chunk_cumsum(log_a, row0, heads, h, valid, cs);
  __syncthreads();
  const float cs_last = cs[kSub - 1];
  if (tid < kSub) w[tid] = reverse ? expf(cs[tid]) : expf(cs_last - cs[tid]);
  if (tid == 0 && pt == 0 && !reverse) decay[bc * heads + h] = expf(cs_last);

  // s_c[p][n] = sum_j x[j][p] w[j] B[j][n]; thread (ty, tx): p 4ty.., n 4tx.. and 64 + 4tx..
  const int ty = tid / 16, tx = tid % 16;
  const bool vec = n_state % 4 == 0;  // float4 stores stay aligned
  float* dst = states + (bc * heads + h) * static_cast<long>(head_dim) * n_state;
  float acc[4][8] = {};
  for (int sl = 0; sl < total; ++sl) {
    const int st = sl & 1;
    if (sl + 1 < total) sm90::cp_async_wait<1>(); else sm90::cp_async_wait<0>();
    __syncthreads();  // stage sl has landed for every thread (and w is set)
    float* xs = smem + st * kStateStage;
    const float* bs = xs + kHalf * kPTile;
    const int j0 = (sl % 2) * kHalf;
#pragma unroll 4
    for (int it = 0; it < kHalf * kPTile / kThreads; ++it) {
      const int e = tid + it * kThreads;
      xs[e] *= w[j0 + e / kPTile];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kHalf; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[j * kPTile + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[j * kNBlock + 4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[j * kNBlock + 64 + 4 * tx]);
      const float ar[4] = {a.x, a.y, a.z, a.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(ar[r], br[q], acc[r][q]);
    }
    if (sl % 2 == 1) {  // the block of columns is complete
      const int n0 = (sl / 2) * kNBlock;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = p0 + 4 * ty + r;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int n = n0 + 64 * u + 4 * tx;
          if (p >= head_dim) continue;
          float* out = dst + static_cast<long>(p) * n_state + n;
          if (vec && n + 3 < n_state) {
            *reinterpret_cast<float4*>(out) = make_float4(acc[r][4 * u], acc[r][4 * u + 1],
                                                          acc[r][4 * u + 2], acc[r][4 * u + 3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (n + q < n_state) out[q] = acc[r][4 * u + q];
          }
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
      }
    }
    __syncthreads();  // every thread is done with stage st
    if (sl + 2 < total) issue(sl + 2, st);
  }
}

// One thread per state element (p, n) of a (batch, head), in the layout of
// h0 and of the states scratch; 8 sub-chunks' contributions are loaded
// before they are chained, so the loads overlap.
__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(const float* __restrict__ h0, const float* __restrict__ decay,
                float* __restrict__ states, float* __restrict__ h_out, int n_sub, int heads,
                int head_dim, int n_state) {
  const int per_head = n_state * head_dim;
  const int e = blockIdx.x * kThreads + threadIdx.x;  // p * N + n
  if (e >= per_head) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long hp = (static_cast<long>(b) * heads + h) * per_head + e;  // in (B, H, P, N)
  float hv = h0 != nullptr ? h0[hp] : 0.0f;
  const long stride = static_cast<long>(heads) * per_head;  // one sub-chunk further
  float* st = states + (static_cast<long>(b) * n_sub * heads + h) * per_head + e;
  const float* dc = decay + static_cast<long>(b) * n_sub * heads + h;
  for (int c = 0; c < n_sub; c += 8) {
    float s[8], d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      s[u] = c + u < n_sub ? st[(c + u) * stride] : 0.0f;
      d[u] = c + u < n_sub ? dc[(c + u) * heads] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c + u < n_sub) {
        st[(c + u) * stride] = hv;
        hv = fmaf(d[u], hv, s[u]);
      }
    }
  }
  h_out[hp] = hv;
}

// dynamic shared memory of kernel 3: two stages of an A slab [64][64] and
// a B slab [64][kBStride]
constexpr int kOutStage = kSub * kSub + kSub * kBStride;
constexpr int kOutSmem = 2 * kOutStage * sizeof(float);

__global__ void __launch_bounds__(kThreads)
ssd_output_kernel(const float* __restrict__ x, const float* __restrict__ log_a,
                  const float* __restrict__ cm, const float* __restrict__ states,
                  const float* __restrict__ gram, float* __restrict__ y, int seq, int heads,
                  int head_dim, int n_state, int p_tiles) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float cs[kSub], ecs[kSub];
  const int c = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / p_tiles, pt = blockIdx.z - b * p_tiles;
  const int n_sub = gridDim.x;
  const int t0 = c * kSub, valid = min(kSub, seq - t0);
  const long row0 = static_cast<long>(b) * seq + t0;
  const long bc = static_cast<long>(b) * n_sub + c;
  const int p0 = pt * kPTile;
  const int tid = threadIdx.x, warp = tid / 32, ty = tid / 16, tx = tid % 16;
  // the state entering this sub-chunk, (P, N) in the states scratch
  const float* hin = states + (bc * heads + h) * static_cast<long>(head_dim) * n_state;
  const float* g = gram + bc * kSub * kSub;
  const int n_slabs = (n_state + kSub - 1) / kSub;  // of C h^T; then one of G x

  // slab `sl` into stage `st` by cp.async: C (rows past the sequence and
  // columns past N zero) and h_in^T, or G and x
  auto issue = [&](int sl, int st) {
    float* a = smem + st * kOutStage;
    float* bs = a + kSub * kSub;
    if (sl < n_slabs) {
      const int n0 = sl * kSub;
#pragma unroll 4
      for (int it = 0; it < kSub * kSub / kThreads; ++it) {
        const int e = tid + it * kThreads, i = e / kSub, n = e % kSub;
        const bool ok = i < valid && n0 + n < n_state;
        sm90::cp_async4(sm90::smem_u32(&a[e]), ok ? &cm[(row0 + i) * n_state + n0 + n] : cm, ok);
      }
#pragma unroll 4
      for (int it = 0; it < kSub * kPTile / kThreads; ++it) {  // read along n, land transposed
        const int e = tid + it * kThreads, p = e / kSub, n = e % kSub;
        const bool ok = n0 + n < n_state && p0 + p < head_dim;
        sm90::cp_async4(sm90::smem_u32(&bs[n * kBStride + p]),
                        ok ? &hin[static_cast<long>(p0 + p) * n_state + n0 + n] : hin, ok);
      }
    } else {
#pragma unroll 4
      for (int it = 0; it < kSub * kSub / kThreads; ++it) {
        const int e = tid + it * kThreads;
        sm90::cp_async4(sm90::smem_u32(&a[e]), &g[e], true);
      }
#pragma unroll 4
      for (int it = 0; it < kSub * kPTile / kThreads; ++it) {
        const int e = tid + it * kThreads, j = e / kPTile, p = e % kPTile;
        const bool ok = j < valid && p0 + p < head_dim;
        sm90::cp_async4(sm90::smem_u32(&bs[j * kBStride + p]),
                        ok ? &x[((row0 + j) * heads + h) * head_dim + p0 + p] : x, ok);
      }
    }
    sm90::cp_async_commit();
  };
  issue(0, 0);
  issue(1, 1);  // there are at least two slabs: one of C h^T and G x
  chunk_cumsum(log_a, row0, heads, h, valid, cs);
  __syncthreads();
  if (tid < kSub) ecs[tid] = expf(cs[tid]);

  // thread (ty, tx) computes rows 4ty.. and columns 4tx..; warp w holds rows
  // 8w..8w+7, whose intra-chunk terms end at column 8w+7
  float acc[4][4] = {};
  auto accumulate = [&](const float* a, const float* bs, int k_end) {
#pragma unroll 2
    for (int k = 0; k < k_end; k += 4) {
      float4 av[4], v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = *reinterpret_cast<const float4*>(&a[(4 * ty + r) * kSub + k]);
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = *reinterpret_cast<const float4*>(&bs[(k + u) * kBStride + 4 * tx]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ar[4] = {av[r].x, av[r].y, av[r].z, av[r].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[r][0] = fmaf(ar[u], v[u].x, acc[r][0]);
          acc[r][1] = fmaf(ar[u], v[u].y, acc[r][1]);
          acc[r][2] = fmaf(ar[u], v[u].z, acc[r][2]);
          acc[r][3] = fmaf(ar[u], v[u].w, acc[r][3]);
        }
      }
    }
  };
  const int total = n_slabs + 1;
  for (int sl = 0; sl < total; ++sl) {
    const int st = sl & 1;
    if (sl + 1 < total) sm90::cp_async_wait<1>(); else sm90::cp_async_wait<0>();
    __syncthreads();  // slab sl has landed for every thread (and ecs is set)
    float* a = smem + st * kOutStage;
    const float* bs = a + kSub * kSub;
    if (sl < n_slabs) {
      accumulate(a, bs, kSub);
    } else {
      // y = diag(exp cs) (C h^T) + (G * L) x: scale the sums so far, then
      // mask and decay G in place, on and below the diagonal only
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] *= ecs[4 * ty + r];
#pragma unroll 4
      for (int it = 0; it < kSub * kSub / kThreads; ++it) {
        const int e = tid + it * kThreads, i = e / kSub, j = e % kSub;
        a[e] = j <= i ? a[e] * expf(cs[i] - cs[j]) : 0.0f;
      }
      __syncthreads();
      accumulate(a, bs, 8 * warp + 8);
    }
    __syncthreads();  // every thread is done with stage st
    if (sl + 2 < total) issue(sl + 2, st);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ty + r;
    if (i >= valid) continue;
    float* y_row = y + ((row0 + i) * heads + h) * head_dim;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = p0 + 4 * tx + q;
      if (p < head_dim) y_row[p] = acc[r][q];
    }
  }
}

// ---------------------------------------------------------------------------
// The backward (ssd_scan_backward_launch): the gradient of the function
// above for dy (B, S, H, P) and the final state's gradient dh (B, H, P, N,
// or none: 0).  Per sub-chunk c and head, with cs the inclusive cumsum of
// log_a in the sub-chunk (0 past the sequence, where B, C, x and dy are 0),
// G_ij = C_i . B_j, L_ij = exp(cs_i - cs_j) for i >= j (else 0), w_j =
// exp(cs_Q - cs_j), h_in the state entering the sub-chunk and dh_out the
// gradient of the state leaving it:
//   dh_in = exp(cs_Q) dh_out + sum_i exp(cs_i) dy_i C_i^T        (dh0 = dh_in of c = 0)
//   dx_j  = sum_{i>=j} G_ij L_ij dy_i + w_j dh_out B_j
//   dC_i  = sum_heads [ sum_{j<=i} L_ij (dy_i . x_j) B_j + exp(cs_i) h_in^T dy_i ]
//   dB_j  = sum_heads [ sum_{i>=j} L_ij (dy_i . x_j) C_i + w_j dh_out^T x_j ]
//   dcs_i = sum_j t_ij - sum_k t_ki + exp(cs_i) dy_i . (C_i h_in^T) - w_i x_i . (dh_out B_i)
//           (+ sum_j w_j x_j . (dh_out B_j) + exp(cs_Q) <dh_out, h_in> at i = Q - 1),
//           t_ij = G_ij L_ij (dy_i . x_j)
//   dlog_a_k = sum_{i>=k} dcs_i within the sub-chunk.
// Six launches on the stream, no atomics (two calls give the same bits):
//  1-2. ssd_state_kernel and ssd_pass_kernel as in the forward: h_in of
//       every sub-chunk (recomputed, not saved: the forward keeps no
//       scratch), exp(cs_Q) and G.
//  3.   ssd_state_kernel in reverse mode on (dy, C) with weights exp(cs_i):
//       each sub-chunk's sum_i exp(cs_i) dy_i C_i^T.
//  4.   ssd_dpass_kernel, a thread per (batch, head, state element): the
//       dh recurrence from the last sub-chunk to the first, leaving dh_out
//       of each sub-chunk in place of its sum and writing dh0.
//  5.   ssd_bwd_kernel, a CTA per (sub-chunk, head, batch x 64 columns of
//       P): dx, and this head's (and P tile's) shares of dB, dC and dcs
//       into scratch, from 64 x 64 register-tiled products (4 x 4 outputs
//       a thread) in shared memory, N in slabs of 64.  exp(cs_i - cs_j)
//       only on or below the diagonal, as the forward.
//  6.   ssd_bwd_reduce_kernel, a CTA per (sub-chunk, batch, slab of B x N):
//       dB and dC summed over the shares (heads x P tiles) in order, and
//       dlog_a as the reverse cumsum of dcs summed over the P tiles.
// Bound: operations (f32, about 12 Q P N + 4 Q^2 (P + N) multiply-adds a
// sub-chunk and head), against reads of x, log_a, B, C, dy, dh and writes
// of dx, dlog_a, dB, dC, dh0.

// The dh recurrence backwards: dstates holds sum_i exp(cs_i) dy_i C_i^T of
// each sub-chunk and receives dh_out; 8 sub-chunks' loads before they are
// chained.
__global__ void __launch_bounds__(kThreads)
ssd_dpass_kernel(const float* __restrict__ dh_final, const float* __restrict__ decay,
                 float* __restrict__ dstates, float* __restrict__ dh0, int n_sub, int heads,
                 int head_dim, int n_state) {
  const int per_head = n_state * head_dim;
  const int e = blockIdx.x * kThreads + threadIdx.x;  // p * N + n
  if (e >= per_head) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long hp = (static_cast<long>(b) * heads + h) * per_head + e;  // in (B, H, P, N)
  float dh = dh_final != nullptr ? dh_final[hp] : 0.0f;
  const long stride = static_cast<long>(heads) * per_head;
  float* st = dstates + (static_cast<long>(b) * n_sub * heads + h) * per_head + e;
  const float* dc = decay + static_cast<long>(b) * n_sub * heads + h;
  for (int c0 = n_sub - 1; c0 >= 0; c0 -= 8) {
    float s[8], d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      s[u] = c0 - u >= 0 ? st[(c0 - u) * stride] : 0.0f;
      d[u] = c0 - u >= 0 ? dc[(c0 - u) * heads] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 - u >= 0) {
        st[(c0 - u) * stride] = dh;
        dh = fmaf(d[u], dh, s[u]);
      }
    }
  }
  if (dh0 != nullptr) dh0[hp] = dh;
}

constexpr int kLd = kSub + 4;           // padded row of a 64-wide slab
constexpr int kSlab = kSub * kLd;
constexpr int kBwdSlabs = 11;
constexpr int kBwdSmem = kBwdSlabs * kSlab * sizeof(float);

// acc[r][q] += sum_k A(4 ty + r, k) B(k, 4 tx + q) over k < 64, B stored
// [k][kLd] with its columns contiguous; A stored [row][kLd] (kATrans false)
// or [k][kLd] (kATrans true).  Sums in k order.
template <bool kATrans>
__device__ __forceinline__ void tile_mm(float (&acc)[4][4], const float* __restrict__ a,
                                        const float* __restrict__ b) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  if constexpr (kATrans) {
#pragma unroll 4
    for (int k = 0; k < kSub; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&a[k * kLd + 4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&b[k * kLd + 4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(ar[r], bv.x, acc[r][0]);
        acc[r][1] = fmaf(ar[r], bv.y, acc[r][1]);
        acc[r][2] = fmaf(ar[r], bv.z, acc[r][2]);
        acc[r][3] = fmaf(ar[r], bv.w, acc[r][3]);
      }
    }
  } else {
#pragma unroll 2
    for (int k = 0; k < kSub; k += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        av[r] = *reinterpret_cast<const float4*>(&a[(4 * ty + r) * kLd + k]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        bv[u] = *reinterpret_cast<const float4*>(&b[(k + u) * kLd + 4 * tx]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ar[4] = {av[r].x, av[r].y, av[r].z, av[r].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[r][0] = fmaf(ar[u], bv[u].x, acc[r][0]);
          acc[r][1] = fmaf(ar[u], bv[u].y, acc[r][1]);
          acc[r][2] = fmaf(ar[u], bv[u].z, acc[r][2]);
          acc[r][3] = fmaf(ar[u], bv[u].w, acc[r][3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
}

// Sum over the 16 lanes that share a ty (a half-warp).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ log_a,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const float* __restrict__ dy, const float* __restrict__ states,
               const float* __restrict__ dstates, const float* __restrict__ gram,
               float* __restrict__ dx, float* __restrict__ part_bc, float* __restrict__ part_cs,
               int seq, int heads, int head_dim, int n_state, int p_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* xt = smem;                 // [p][j] x, transposed
  float* dys = xt + kSlab;          // [i][p] dy
  float* gl = dys + kSlab;          // [i][j] G, then G * L
  float* ms = gl + kSlab;           // [i][j] M = L * (dy . x)
  float* ts = ms + kSlab;           // [i][j] t = G * M
  float* bs = ts + kSlab;           // [j][n] B slab
  float* cs_ = bs + kSlab;          // [i][n] C slab
  float* hin = cs_ + kSlab;         // [p][n] h_in slab
  float* hint = hin + kSlab;        // [n][p] h_in slab, transposed
  float* dho = hint + kSlab;        // [p][n] dh_out slab
  float* dhot = dho + kSlab;        // [n][p] dh_out slab, transposed
  __shared__ float cs[kSub], ecs[kSub], w[kSub], dcs[kSub], e1[kSub], e2[kSub], red[kThreads / 32];

  const int c = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / p_tiles, pt = blockIdx.z - b * p_tiles;
  const int n_sub = gridDim.x;
  const int t0 = c * kSub, valid = min(kSub, seq - t0);
  const long row0 = static_cast<long>(b) * seq + t0;
  const long bc = static_cast<long>(b) * n_sub + c;
  const int p0 = pt * kPTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long state_base = (bc * heads + h) * static_cast<long>(head_dim) * n_state;

  for (int e = tid; e < kSub * kSub; e += kThreads) {
    const int j = e / kSub, p = e % kSub;
    const bool ok = j < valid && p0 + p < head_dim;
    const long at = ((row0 + j) * heads + h) * head_dim + p0 + p;
    xt[p * kLd + j] = ok ? x[at] : 0.0f;
    dys[j * kLd + p] = ok ? dy[at] : 0.0f;
    gl[j * kLd + p] = gram[bc * kSub * kSub + e];  // G[j][p]: rows past the sequence are 0
  }
  chunk_cumsum(log_a, row0, heads, h, valid, cs);
  __syncthreads();
  if (tid < kSub) {
    ecs[tid] = expf(cs[tid]);
    w[tid] = expf(cs[kSub - 1] - cs[tid]);
  }

  // D = dy x^T; M = L * D, t = G * M, G * L in place, each thread its own elements
  float acc[4][4];
  zero(acc);
  tile_mm<false>(acc, dys, xt);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ty + r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * tx + q;
      const float l = j <= i ? expf(cs[i] - cs[j]) : 0.0f;
      const float m = l * acc[r][q], g = gl[i * kLd + j];
      ms[i * kLd + j] = m;
      ts[i * kLd + j] = g * m;
      gl[i * kLd + j] = g * l;
    }
  }
  __syncthreads();
  if (tid < kSub) {  // dcs_i from the intra-chunk terms: row i of t less column i
    float row = 0.0f, col = 0.0f;
    for (int j = 0; j < kSub; ++j) {
      row += ts[tid * kLd + j];
      col += ts[j * kLd + tid];
    }
    dcs[tid] = row - col;
  }
  // dx_j = sum_i (G * L)_ij dy_i, then + w_j U_j with U = B dh_out^T
  float dxa[4][4], u[4][4], v[4][4];
  zero(dxa);
  zero(u);
  zero(v);
  tile_mm<true>(dxa, gl, dys);
  float hd = 0.0f;  // this thread's share of <dh_out, h_in> over the P tile
  for (int n0 = 0; n0 < n_state; n0 += kSub) {
    __syncthreads();  // the previous slabs are no longer read
    for (int e = tid; e < kSub * kSub; e += kThreads) {
      const int r = e / kSub, n = e % kSub;
      const bool in_n = n0 + n < n_state;
      const bool ok = r < valid && in_n;
      bs[r * kLd + n] = ok ? bm[(row0 + r) * n_state + n0 + n] : 0.0f;
      cs_[r * kLd + n] = ok ? cm[(row0 + r) * n_state + n0 + n] : 0.0f;
      const bool in_p = in_n && p0 + r < head_dim;
      const long at = state_base + static_cast<long>(p0 + r) * n_state + n0 + n;
      const float hv = in_p ? states[at] : 0.0f, dv = in_p ? dstates[at] : 0.0f;
      hin[r * kLd + n] = hv;
      hint[n * kLd + r] = hv;
      dho[r * kLd + n] = dv;
      dhot[n * kLd + r] = dv;
      hd = fmaf(hv, dv, hd);
    }
    __syncthreads();
    tile_mm<false>(u, bs, dhot);
    tile_mm<false>(v, cs_, hint);
    // dC_i (this head's share) = M B + exp(cs_i) dy h_in
    float a1[4][4], a2[4][4];
    zero(a1);
    zero(a2);
    tile_mm<false>(a1, ms, bs);
    tile_mm<false>(a2, dys, hin);
    float* out_c = part_bc + (static_cast<long>(gridDim.z / p_tiles) * n_sub * heads * p_tiles +
                              bc * heads * p_tiles + h * p_tiles + pt) * kSub * n_state;
    float* out_b = part_bc + (bc * heads * p_tiles + h * p_tiles + pt) * kSub * n_state;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + 4 * tx + q;
        if (n < n_state) out_c[(4 * ty + r) * n_state + n] = a1[r][q] + ecs[4 * ty + r] * a2[r][q];
      }
    // dB_j (this head's share) = M^T C + w_j x dh_out
    zero(a1);
    zero(a2);
    tile_mm<true>(a1, ms, cs_);
    tile_mm<true>(a2, xt, dho);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + 4 * tx + q;
        if (n < n_state) out_b[(4 * ty + r) * n_state + n] = a1[r][q] + w[4 * ty + r] * a2[r][q];
      }
  }

  // dx, and the inter-chunk terms of dcs: e1_i = dy_i . V_i, e2_j = x_j . U_j
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = 4 * ty + r;
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = 4 * tx + q;
      s1 = fmaf(dys[j * kLd + p], v[r][q], s1);
      s2 = fmaf(xt[p * kLd + j], u[r][q], s2);
      if (j < valid && p0 + p < head_dim)
        dx[((row0 + j) * heads + h) * head_dim + p0 + p] = dxa[r][q] + w[j] * u[r][q];
    }
    s1 = half_warp_sum(s1);
    s2 = half_warp_sum(s2);
    if (tx == 0) {
      e1[j] = ecs[j] * s1;
      e2[j] = w[j] * s2;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) hd += __shfl_xor_sync(0xffffffffu, hd, off);
  if (tid % 32 == 0) red[tid / 32] = hd;
  __syncthreads();
  if (tid < kSub) {
    float d = dcs[tid] + e1[tid] - e2[tid];
    if (tid == kSub - 1) {  // cs_Q's own terms: the state leaving the sub-chunk
      float hsum = 0.0f, e2sum = 0.0f;
      for (int k = 0; k < kThreads / 32; ++k) hsum += red[k];
      for (int j = 0; j < kSub; ++j) e2sum += e2[j];
      d += e2sum + ecs[kSub - 1] * hsum;
    }
    part_cs[((bc * heads + h) * p_tiles + pt) * kSub + tid] = d;
  }
}

// dB, dC: the shares summed in order (heads, then P tiles); dlog_a: dcs
// summed over the P tiles, then cumulated from the sub-chunk's end.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ part_bc, const float* __restrict__ part_cs,
                      float* __restrict__ dbm, float* __restrict__ dcm,
                      float* __restrict__ dlog_a, int seq, int heads, int n_state, int p_tiles) {
  const int c = blockIdx.x, b = blockIdx.y;
  const int n_sub = gridDim.x;
  const int t0 = c * kSub, valid = min(kSub, seq - t0);
  const int shares = heads * p_tiles;
  const long slab = static_cast<long>(kSub) * n_state;
  const long plane = static_cast<long>(gridDim.y) * n_sub * shares * slab;  // dB's, then dC's
  const long bc = static_cast<long>(b) * n_sub + c;
  const float* pb = part_bc + bc * shares * slab;
  const long out0 = (static_cast<long>(b) * seq + t0) * n_state;
  for (int e = blockIdx.z * kThreads + threadIdx.x; e < valid * n_state;
       e += gridDim.z * kThreads) {
    float sb = 0.0f, sc = 0.0f;
    for (int k = 0; k < shares; ++k) {
      sb += pb[k * slab + e];
      sc += pb[plane + k * slab + e];
    }
    dbm[out0 + e] = sb;
    dcm[out0 + e] = sc;
  }
  if (blockIdx.z != 0) return;
  for (int h = threadIdx.x; h < heads; h += kThreads) {
    const float* pc = part_cs + (bc * heads + h) * p_tiles * kSub;
    float run = 0.0f;
    for (int i = kSub - 1; i >= 0; --i) {
      float d = 0.0f;
      for (int pt = 0; pt < p_tiles; ++pt) d += pc[pt * kSub + i];
      run += d;
      if (i < valid) dlog_a[(static_cast<long>(b) * seq + t0 + i) * heads + h] = run;
    }
  }
}

// Once per device: the kernels' shared-memory opt-in.
cudaError_t opt_in(int device) {
  static std::mutex mu;
  static bool ready[kMaxDevices];
  std::lock_guard<std::mutex> lock(mu);
  if (ready[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(ssd_state_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kStateSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_output_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kOutSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBwdSmem);
  if (err == cudaSuccess) ready[device] = true;
  return err;
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, y (B, S, H, P); log_a (B, S, H); bm, cm (B, S, N); h0 (nullable), h_out
// (B, H, P, N); scratch: states (B, S/sub, H, P, N), decay (B, S/sub, H),
// gram (B, S/sub, sub, sub), with S/sub rounded up.  f32, contiguous.  `sub`
// must be the kernels' sub-chunk (64); `device` is the pointers' CUDA
// device, current on the calling thread.
int ssd_scan_launch(const float* x, const float* log_a, const float* bm, const float* cm,
                    const float* h0, float* y, float* h_out, float* states, float* decay,
                    float* gram, int batch, int seq, int heads, int head_dim, int n_state,
                    int sub, int device, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 || n_state <= 0 ||
      n_state > kMaxState || sub != kSub || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_sub = (seq + kSub - 1) / kSub;
  const int p_tiles = (head_dim + kPTile - 1) / kPTile;
  const long per_head = static_cast<long>(n_state) * head_dim;
  if (static_cast<long>(batch) * p_tiles > 65535 || heads >= 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);  // grid y and z limits
  cudaError_t err = opt_in(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssd_state_kernel<<<dim3(n_sub, heads + 1, batch * p_tiles), kThreads, kStateSmem, s>>>(
      x, log_a, bm, cm, states, decay, gram, seq, heads, head_dim, n_state, p_tiles, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned pass_blocks = static_cast<unsigned>((per_head + kThreads - 1) / kThreads);
  ssd_pass_kernel<<<dim3(pass_blocks, heads, batch), kThreads, 0, s>>>(
      h0, decay, states, h_out, n_sub, heads, head_dim, n_state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_output_kernel<<<dim3(n_sub, heads, batch * p_tiles), kThreads, kOutSmem, s>>>(
      x, log_a, cm, states, gram, y, seq, heads, head_dim, n_state, p_tiles);
  return static_cast<int>(cudaGetLastError());
}

// The backward.  x, dy, dx (B, S, H, P); log_a, dlog_a (B, S, H); bm, cm,
// dbm, dcm (B, S, N); h0, dh (the final state's gradient) and dh0 (B, H,
// P, N), each nullable (dh0 is written when non-null); scratch: states and
// dstates (B, S/sub, H, P, N), decay (B, S/sub, H), gram (B, S/sub, sub,
// sub), h_last (B, H, P, N), part_bc (2, B, S/sub, H * ceil(P/64), sub, N)
// and part_cs (B, S/sub, H, ceil(P/64), sub), with S/sub rounded up.  f32,
// contiguous.  `sub` must be 64; `device` is the pointers' CUDA device.
int ssd_scan_backward_launch(const float* x, const float* log_a, const float* bm,
                             const float* cm, const float* h0, const float* dy, const float* dh,
                             float* dx, float* dlog_a, float* dbm, float* dcm, float* dh0,
                             float* states, float* dstates, float* decay, float* gram,
                             float* h_last, float* part_bc, float* part_cs, int batch, int seq,
                             int heads, int head_dim, int n_state, int sub, int device,
                             void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 || n_state <= 0 ||
      n_state > kMaxState || sub != kSub || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_sub = (seq + kSub - 1) / kSub;
  const int p_tiles = (head_dim + kPTile - 1) / kPTile;
  const long per_head = static_cast<long>(n_state) * head_dim;
  if (static_cast<long>(batch) * p_tiles > 65535 || heads >= 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);  // grid y and z limits
  cudaError_t err = opt_in(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned pass_blocks = static_cast<unsigned>((per_head + kThreads - 1) / kThreads);
  // 1-2: h_in of each sub-chunk, exp(cs_Q) and G, as the forward
  ssd_state_kernel<<<dim3(n_sub, heads + 1, batch * p_tiles), kThreads, kStateSmem, s>>>(
      x, log_a, bm, cm, states, decay, gram, seq, heads, head_dim, n_state, p_tiles, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_pass_kernel<<<dim3(pass_blocks, heads, batch), kThreads, 0, s>>>(
      h0, decay, states, h_last, n_sub, heads, head_dim, n_state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // 3-4: sum_i exp(cs_i) dy_i C_i^T of each sub-chunk, then dh_out
  ssd_state_kernel<<<dim3(n_sub, heads, batch * p_tiles), kThreads, kStateSmem, s>>>(
      dy, log_a, cm, bm, dstates, decay, gram, seq, heads, head_dim, n_state, p_tiles, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_dpass_kernel<<<dim3(pass_blocks, heads, batch), kThreads, 0, s>>>(
      dh, decay, dstates, dh0, n_sub, heads, head_dim, n_state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // 5-6: dx and the shares, then their sums and dlog_a
  ssd_bwd_kernel<<<dim3(n_sub, heads, batch * p_tiles), kThreads, kBwdSmem, s>>>(
      x, log_a, bm, cm, dy, states, dstates, gram, dx, part_bc, part_cs, seq, heads, head_dim,
      n_state, p_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slabs = (kSub * n_state + 4 * kThreads - 1) / (4 * kThreads);
  ssd_bwd_reduce_kernel<<<dim3(n_sub, batch, slabs), kThreads, 0, s>>>(
      part_bc, part_cs, dbm, dcm, dlog_a, seq, heads, n_state, p_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
