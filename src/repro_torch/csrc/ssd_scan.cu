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
//       P): dx, and this head's (and P tile's) share of dcs (64 floats)
//       into scratch, from 64 x 64 register-tiled products (4 x 4 outputs
//       a thread) in shared memory, N in steps of 32 staged by cp.async
//       into two buffers (106,496 bytes: two CTAs a SM).  exp(cs_i - cs_j)
//       only on or below the diagonal, as the forward.
//  6.   ssd_bwd_bc_kernel, a CTA per (sub-chunk, batch, 64 columns of N):
//       dB and dC, walking the heads (and their P tiles) in order and
//       summing in registers: per head it stages dy, x and its columns of
//       h_in and dh_out by cp.async into two buffers, and recomputes
//       M = L * (dy x^T), 64 x 64.  Its CTAs of the first 64 columns also
//       form dlog_a: dcs summed over the P tiles, then cumulated from the
//       sub-chunk's end.  No scratch grows as H x N.  Where these CTAs
//       would not fill one wave of the card (short sequences, batch 1),
//       the wrapper splits the heads into groups walked by CTAs of their
//       own, and ssd_bwd_groups_kernel (a seventh launch) adds the groups'
//       sums in order: scratch of groups x B x S x N, groups < H.
// Bound: operations (f32, about 12 Q P N + 4 Q^2 (P + N) multiply-adds a
// sub-chunk and head; kernel 6 forms dy x^T again for each 64 columns of
// N), against reads of x, log_a, B, C, dy, dh and writes of dx, dlog_a,
// dB, dC, dh0.

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

constexpr int kLd = kSub + 4;    // padded row of a 64-wide slab
constexpr int kSlab = kSub * kLd;
constexpr int kNStep = 32;       // columns of N a step of ssd_bwd_kernel takes
constexpr int kLdN = kNStep + 4; // padded row of a 32-wide slab
// a stage of ssd_bwd_kernel: B and C [64][kLdN], h_in^T and dh_out^T [32][kLd]
constexpr int kBwdStage = 2 * kSub * kLdN + 2 * kNStep * kLd;
constexpr int kBwdSmem = (2 * kSlab + 2 * kBwdStage) * sizeof(float);
static_assert(2 * kSlab <= kBwdStage, "G and t fit in the second stage");
// two CTAs a SM: 233,472 bytes of shared memory, 1 KB of it reserved a CTA
static_assert(2 * (kBwdSmem + 2048 + 1024) <= 233472, "two ssd_bwd_kernel CTAs a SM");
// ssd_bwd_bc_kernel: B, C and M [64][kLd], two stages of dy, x^T, h_in, dh_out
constexpr int kBcSmem = (3 + 2 * 4) * kSlab * sizeof(float);

// acc[r][q] += sum_k A(4 ty + r, k) B(k, 4 tx + q) over k < K, B stored
// [k][ldb] with its columns contiguous; A stored [row][lda] (kATrans false)
// or [k][lda] (kATrans true).  Sums in k order.
template <bool kATrans, int K = kSub>
__device__ __forceinline__ void tile_mm(float (&acc)[4][4], const float* __restrict__ a,
                                        const float* __restrict__ b, int lda = kLd,
                                        int ldb = kLd) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  if constexpr (kATrans) {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&a[k * lda + 4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&b[k * ldb + 4 * tx]);
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
    for (int k = 0; k < K; k += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        av[r] = *reinterpret_cast<const float4*>(&a[(4 * ty + r) * lda + k]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        bv[u] = *reinterpret_cast<const float4*>(&b[(k + u) * ldb + 4 * tx]);
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

// 64 x 64 floats from a row-major source (row r at src + r * ld, its first
// `cols` columns; rows past `rows` and columns past `cols` zero) into
// shared memory by 4-byte cp.async, as dst[r * kLd + c] or, with kTrans,
// dst[c * kLd + r]: read along the rows, land transposed.
template <bool kTrans>
__device__ __forceinline__ void stage_slab(float* dst, const float* __restrict__ src, long ld,
                                           int rows, int cols) {
#pragma unroll 4
  for (int it = 0; it < kSub * kSub / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads, r = e / kSub, c = e % kSub;
    const bool ok = r < rows && c < cols;
    sm90::cp_async4(sm90::smem_u32(&dst[kTrans ? c * kLd + r : r * kLd + c]),
                    ok ? src + r * ld + c : src, ok);
  }
}

// dx and this P tile's share of dcs for one (sub-chunk, head, batch x 64
// columns of P); N in steps of 32, double-buffered.
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ log_a,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const float* __restrict__ dy, const float* __restrict__ states,
               const float* __restrict__ dstates, const float* __restrict__ gram,
               float* __restrict__ dx, float* __restrict__ part_cs, int seq, int heads,
               int head_dim, int n_state, int p_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* xt = smem;                 // [p][j] x, transposed
  float* dys = xt + kSlab;          // [i][p] dy
  float* stage0 = dys + kSlab;      // N steps: [j][n] B, [i][n] C, [n][p] h_in^T, dh_out^T
  float* gl = stage0 + kBwdStage;   // [i][j] G, then G * L (in the second stage's room)
  float* ts = gl + kSlab;           // [i][j] t = G * L * (dy . x)
  __shared__ float cs[kSub], ecs[kSub], w[kSub], dcs[kSub], e1[kSub], e2[kSub], red[kThreads / 32];

  const int c = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / p_tiles, pt = blockIdx.z - b * p_tiles;
  const int n_sub = gridDim.x;
  const int t0 = c * kSub, valid = min(kSub, seq - t0);
  const long row0 = static_cast<long>(b) * seq + t0;
  const long bc = static_cast<long>(b) * n_sub + c;
  const int p0 = pt * kPTile, p_valid = min(kPTile, head_dim - p0);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long state_base = (bc * heads + h) * static_cast<long>(head_dim) * n_state;
  const long xrow = static_cast<long>(heads) * head_dim;  // one step further in x and dy

  // step sl's 32 columns of N into stage st by cp.async, zero past the
  // sequence, N and P
  auto issue = [&](int sl, int st) {
    float* bs = stage0 + st * kBwdStage;
    float* cs_ = bs + kSub * kLdN;
    float* hint = cs_ + kSub * kLdN;
    float* dhot = hint + kNStep * kLd;
    const int n0 = sl * kNStep;
#pragma unroll 4
    for (int it = 0; it < kSub * kNStep / kThreads; ++it) {
      const int e = tid + it * kThreads, r = e / kNStep, n = e % kNStep;
      const bool ok = r < valid && n0 + n < n_state;
      const long at = (row0 + r) * n_state + n0 + n;
      sm90::cp_async4(sm90::smem_u32(&bs[r * kLdN + n]), ok ? bm + at : bm, ok);
      sm90::cp_async4(sm90::smem_u32(&cs_[r * kLdN + n]), ok ? cm + at : cm, ok);
      const bool in_p = r < p_valid && n0 + n < n_state;  // r is p here
      const long hp = state_base + static_cast<long>(p0 + r) * n_state + n0 + n;
      sm90::cp_async4(sm90::smem_u32(&hint[n * kLd + r]), in_p ? states + hp : states, in_p);
      sm90::cp_async4(sm90::smem_u32(&dhot[n * kLd + r]), in_p ? dstates + hp : dstates, in_p);
    }
    sm90::cp_async_commit();
  };

  const long at = (row0 * heads + h) * head_dim + p0;  // row 0 of x and dy
  stage_slab<true>(xt, x + at, xrow, valid, p_valid);
  stage_slab<false>(dys, dy + at, xrow, valid, p_valid);
  stage_slab<false>(gl, gram + bc * kSub * kSub, kSub, kSub, kSub);  // rows past the sequence are 0
  sm90::cp_async_commit();
  const int n_steps = (n_state + kNStep - 1) / kNStep;
  issue(0, 0);
  chunk_cumsum(log_a, row0, heads, h, valid, cs);
  sm90::cp_async_wait<1>();  // x, dy and G have landed
  __syncthreads();
  if (tid < kSub) {
    ecs[tid] = expf(cs[tid]);
    w[tid] = expf(cs[kSub - 1] - cs[tid]);
  }

  // D = dy x^T; t = G * L * D, G * L in place, each thread its own elements
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
      const float g = gl[i * kLd + j];
      ts[i * kLd + j] = g * (l * acc[r][q]);
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
  __syncthreads();  // G * L and t are no longer read: the second stage is free
  if (n_steps > 1) issue(1, 1);
  float hd = 0.0f;  // this thread's share of <dh_out, h_in> over the P tile
  for (int sl = 0; sl < n_steps; ++sl) {
    const int st = sl & 1;
    if (sl + 1 < n_steps) sm90::cp_async_wait<1>(); else sm90::cp_async_wait<0>();
    __syncthreads();  // step sl has landed for every thread
    const float* bs = stage0 + st * kBwdStage;
    const float* cs_ = bs + kSub * kLdN;
    const float* hint = cs_ + kSub * kLdN;
    const float* dhot = hint + kNStep * kLd;
    tile_mm<false, kNStep>(u, bs, dhot, kLdN, kLd);
    tile_mm<false, kNStep>(v, cs_, hint, kLdN, kLd);
#pragma unroll
    for (int it = 0; it < kNStep * kSub / kThreads; ++it) {
      const int e = tid + it * kThreads, at = e / kSub * kLd + e % kSub;
      hd = fmaf(hint[at], dhot[at], hd);
    }
    __syncthreads();  // every thread is done with stage st
    if (sl + 2 < n_steps) issue(sl + 2, st);
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
      if (j < valid && p < p_valid)
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

// dB and dC of one (sub-chunk, batch x group of heads, 64 columns of N):
// the group's heads walked in order, each head's P tiles in order, the sums
// kept in registers; and, in the first group's CTAs of the first 64
// columns, dlog_a: dcs summed over the P tiles, then cumulated from the
// sub-chunk's end.  Per head it stages dy, x, and the columns of h_in and
// dh_out (64 x 64 each a P tile), double-buffered, and recomputes
// M = L * (dy x^T) (64 x 64).  With one group (a grid of a wave or more)
// it writes dB and dC; with several, the group's sums go to part (groups,
// 2, B, S, N) and ssd_bwd_groups_kernel adds them in order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_bc_kernel(const float* __restrict__ x, const float* __restrict__ log_a,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ dy, const float* __restrict__ states,
                  const float* __restrict__ dstates, const float* __restrict__ part_cs,
                  float* __restrict__ dbm, float* __restrict__ dcm, float* __restrict__ dlog_a,
                  float* __restrict__ part, int seq, int heads, int head_dim, int n_state,
                  int p_tiles, int groups) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;               // [j][n] B slab
  float* cs_ = bs + kSlab;        // [i][n] C slab
  float* ms = cs_ + kSlab;        // [i][j] M of the head
  float* stages = ms + kSlab;     // stage s: [i][p] dy, [p][j] x^T, [p][n] h_in, [p][n] dh_out
  __shared__ float cs[kSub];

  const int c = blockIdx.x, b = blockIdx.y / groups, grp = blockIdx.y % groups;
  const int n0 = blockIdx.z * kSub;
  const int n_sub = gridDim.x, batch = gridDim.y / groups;
  const int h0 = grp * heads / groups, h1 = (grp + 1) * heads / groups;  // the group's heads
  const int t0 = c * kSub, valid = min(kSub, seq - t0);
  const long row0 = static_cast<long>(b) * seq + t0;
  const long bc = static_cast<long>(b) * n_sub + c;
  const int n_valid = min(kSub, n_state - n0);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long xrow = static_cast<long>(heads) * head_dim;

  // step s = (head h0 + s / p_tiles, P tile s % p_tiles) into stage s % 2
  auto issue = [&](int s) {
    float* st = stages + (s & 1) * 4 * kSlab;
    const int h = h0 + s / p_tiles, p0 = (s % p_tiles) * kPTile;
    const int p_valid = min(kPTile, head_dim - p0);
    const long at = (row0 * heads + h) * head_dim + p0;
    const long hp = ((bc * heads + h) * head_dim + p0) * static_cast<long>(n_state) + n0;
    stage_slab<false>(st, dy + at, xrow, valid, p_valid);
    stage_slab<true>(st + kSlab, x + at, xrow, valid, p_valid);
    stage_slab<false>(st + 2 * kSlab, states + hp, n_state, p_valid, n_valid);
    stage_slab<false>(st + 3 * kSlab, dstates + hp, n_state, p_valid, n_valid);
    sm90::cp_async_commit();
  };
  stage_slab<false>(bs, bm + row0 * n_state + n0, n_state, valid, n_valid);
  stage_slab<false>(cs_, cm + row0 * n_state + n0, n_state, valid, n_valid);
  const int n_steps = (h1 - h0) * p_tiles;
  issue(0);  // B and C join its group
  if (n_steps > 1) issue(1);

  float dc[4][4], db[4][4], d[4][4], tc[4][4], tb[4][4];
  zero(dc);
  zero(db);
  zero(d);
  zero(tc);
  zero(tb);
  for (int s = 0; s < n_steps; ++s) {
    const int h = h0 + s / p_tiles, pt = s % p_tiles;
    if (s + 1 < n_steps) sm90::cp_async_wait<1>(); else sm90::cp_async_wait<0>();
    __syncthreads();  // step s has landed; the previous head's M and cs are read
    if (pt == 0) chunk_cumsum(log_a, row0, heads, h, valid, cs);
    const float* st = stages + (s & 1) * 4 * kSlab;
    tile_mm<false>(d, st, st + kSlab);                // dy x^T
    tile_mm<false>(tc, st, st + 2 * kSlab);           // dy h_in
    tile_mm<true>(tb, st + kSlab, st + 3 * kSlab);    // x dh_out
    __syncthreads();  // stage s % 2 is free; cs is set
    if (s + 2 < n_steps) issue(s + 2);
    if (pt + 1 < p_tiles) continue;
    // the head's M = L * D; dC += diag(exp cs) tc + M B, dB += diag(w) tb + M^T C
    const float last = cs[kSub - 1];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ty + r;
      const float ecs = expf(cs[i]), wr = expf(last - cs[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * tx + q;
        ms[i * kLd + j] = j <= i ? expf(cs[i] - cs[j]) * d[r][q] : 0.0f;
        dc[r][q] = fmaf(ecs, tc[r][q], dc[r][q]);
        db[r][q] = fmaf(wr, tb[r][q], db[r][q]);
      }
    }
    zero(d);
    zero(tc);
    zero(tb);
    __syncthreads();
    tile_mm<false>(dc, ms, bs);
    tile_mm<true>(db, ms, cs_);
  }
  // one group: dB and dC; several: this group's sums, (groups, 2, B, S, N)
  const long plane = static_cast<long>(batch) * seq * n_state;
  float* out_b = groups == 1 ? dbm : part + 2 * grp * plane;
  float* out_c = groups == 1 ? dcm : part + (2 * grp + 1) * plane;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ty + r;
    if (i >= valid) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = 4 * tx + q;
      if (n >= n_valid) continue;
      out_c[(row0 + i) * n_state + n0 + n] = dc[r][q];
      out_b[(row0 + i) * n_state + n0 + n] = db[r][q];
    }
  }
  if (blockIdx.z != 0 || grp != 0) return;
  for (int h = tid; h < heads; h += kThreads) {
    const float* pc = part_cs + (bc * heads + h) * p_tiles * kSub;
    float run = 0.0f;
    for (int i = kSub - 1; i >= 0; --i) {
      float dsum = 0.0f;
      for (int pt = 0; pt < p_tiles; ++pt) dsum += pc[pt * kSub + i];
      run += dsum;
      if (i < valid) dlog_a[(row0 + i) * heads + h] = run;
    }
  }
}

// dB and dC: the head groups' sums of ssd_bwd_bc_kernel added in order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_groups_kernel(const float* __restrict__ part, float* __restrict__ dbm,
                      float* __restrict__ dcm, long plane, int groups) {
  for (long e = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x; e < plane;
       e += static_cast<long>(gridDim.x) * kThreads) {
    float sb = 0.0f, sc = 0.0f;
    for (int g = 0; g < groups; ++g) {
      sb += part[2 * g * plane + e];
      sc += part[(2 * g + 1) * plane + e];
    }
    dbm[e] = sb;
    dcm[e] = sc;
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
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_bc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBcSmem);
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
// sub), h_last (B, H, P, N), part_cs (B, S/sub, H, ceil(P/64), sub) and,
// with `groups` > 1 head groups for dB and dC, part_groups (groups, 2, B,
// S, N) (null with one group), with S/sub rounded up.  f32, contiguous.
// `sub` must be 64; `device` is the pointers' CUDA device.
int ssd_scan_backward_launch(const float* x, const float* log_a, const float* bm,
                             const float* cm, const float* h0, const float* dy, const float* dh,
                             float* dx, float* dlog_a, float* dbm, float* dcm, float* dh0,
                             float* states, float* dstates, float* decay, float* gram,
                             float* h_last, float* part_cs, float* part_groups, int batch,
                             int seq, int heads, int head_dim, int n_state, int sub,
                             int groups, int device, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 || n_state <= 0 ||
      n_state > kMaxState || sub != kSub || device < 0 || device >= kMaxDevices ||
      groups < 1 || groups > heads || (groups > 1) != (part_groups != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_sub = (seq + kSub - 1) / kSub;
  const int p_tiles = (head_dim + kPTile - 1) / kPTile;
  const long per_head = static_cast<long>(n_state) * head_dim;
  if (static_cast<long>(batch) * p_tiles > 65535 || heads >= 65535 ||
      static_cast<long>(batch) * groups > 65535)
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
  // 5-6: dx and dcs's shares, then dB, dC and dlog_a
  ssd_bwd_kernel<<<dim3(n_sub, heads, batch * p_tiles), kThreads, kBwdSmem, s>>>(
      x, log_a, bm, cm, dy, states, dstates, gram, dx, part_cs, seq, heads, head_dim, n_state,
      p_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_bc_kernel<<<dim3(n_sub, batch * groups, (n_state + kSub - 1) / kSub), kThreads,
                      kBcSmem, s>>>(x, log_a, bm, cm, dy, states, dstates, part_cs, dbm, dcm,
                                    dlog_a, part_groups, seq, heads, head_dim, n_state, p_tiles,
                                    groups);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return static_cast<int>(err);
  const long plane = static_cast<long>(batch) * seq * n_state;
  const long blocks = (plane + kThreads - 1) / kThreads;
  const unsigned sum_blocks = static_cast<unsigned>(blocks < 4096 ? blocks : 4096);
  ssd_bwd_groups_kernel<<<sum_blocks, kThreads, 0, s>>>(part_groups, dbm, dcm, plane, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
