// Depthwise causal conv with its bias and, optionally, SiLU, for Hopper
// (sm_90a), bound to Python with ctypes.
//
// It replaces no TPU kernel: the JAX package's SSD and RG-LRU blocks run the
// conv as plain jnp code that XLA fuses.  Eagerly, the same chain (pad, four
// shifted f32 multiply-adds, bias, casts, SiLU) is 14 full-size launches
// forward and about as many backward, each reading and writing the whole
// (B, S, C) activation.  Here one launch reads x once and writes the output
// once:
//
//   out[t, c] = act(round(b[c] + sum_i x[t - W + 1 + i, c] * w[i, c]))
//
// with rows before the sequence read as 0, round() to x's type and act SiLU
// (x / (1 + exp(-x)), rounded to x's type again) or nothing.  Every product
// and sum is rounded on its own (__fmul_rn, __fadd_rn), in tap order from
// 0.0f, so the output has the bits of the eager chain it replaces: nvcc
// would otherwise contract them into fused multiply-adds.
//
// The backward takes the gradient g of the output, forms the pre-activation
// again from x, w and b (nothing else is saved), and in f32
//   gc = g * act'(pre),  dx[t] = sum_i gc[t + W - 1 - i] * w[i],
//   dw[i] = sum_{b,t} gc[t] * x[t - W + 1 + i],  db = sum_{b,t} gc[t].
// dx is rounded once to x's type.  SiLU's derivative takes the fast exp and
// a rounded reciprocal: their error, about 1e-6 of it, lies far below the
// bf16 rounding that autograd's eager chain applied to gc.  dw and db are
// summed per CTA in a fixed order into f32 partials, which a second launch
// adds in order: no atomics, so two calls give the same bits.
//
// Layout: x is (B, S, C) with unit channel stride and any batch and row
// strides (the SSD block's xBC is a column slice of a wider row), w (W, C),
// b (C,), the output, g and dx contiguous (B, S, C).  W is 4 (kWidth),
// every configuration's conv width, and the only one built.  A CTA is 32 lanes
// along C (V channels a lane: 8 bytes of a row forward, 4 channels
// backward, where the strides allow it) by 8 segments along S, kRows rows a
// thread.  A thread walks its rows in order with the last W rows of x (and
// of gc) in registers, so each row of x and g is read once, plus W - 1 rows
// of halo a segment.  A memory-bound walk needs many bytes in flight; here
// they cost no registers: each thread keeps the next 64 bytes of each
// operand's rows in flight through its own slots of a shared-memory ring
// (cp.async), and waits only for the row it takes.
//
// Bound on the card: bytes.  At mamba2-130m's training shape (B 32, S 2048,
// C 1792, bf16) the forward moves 0.47 GB and the backward 0.71 GB; the
// arithmetic is a few tens of operations an element.
//
// The entry points return cudaGetLastError() so the wrapper can raise on a
// refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kLanes = 32;                 // lanes of a CTA along C
constexpr int kSegments = 8;               // segments of a CTA along S
constexpr int kThreads = kLanes * kSegments;
constexpr int kRows = 64;                  // rows a thread
constexpr int kCtaRows = kSegments * kRows;
// bytes of each operand a thread keeps in flight, and of a row a lane takes
// forward (channels backward, whose threads hold more registers a channel)
constexpr int kFwdInFlight = 64, kFwdBytes = 8;
constexpr int kBwdInFlight = 64, kBwdChannels = 4;
constexpr int kWidth = 4;                  // taps: every configuration's conv_width

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive values, loaded and stored as one access
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  const Pack<T, V> raw = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = widen(raw.v[k]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  Pack<T, V> raw;
#pragma unroll
  for (int k = 0; k < V; ++k) raw.v[k] = narrow<T>(in[k]);
  *reinterpret_cast<Pack<T, V>*>(p) = raw;
}

// The eager chain's pre-activation of one channel: taps in order from 0.0f,
// each product and sum rounded on its own, the bias last, rounded to T.
template <typename T, int V>
__device__ __forceinline__ float pre_activation(const float (&xw)[kWidth][V],
                                                const float (&wf)[kWidth][V], const float (&bf)[V],
                                                int v) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kWidth; ++i) acc = __fadd_rn(acc, __fmul_rn(xw[i][v], wf[i][v]));
  return widen(narrow<T>(__fadd_rn(acc, bf[v])));
}

template <int V>
__device__ __forceinline__ void shift(float (&win)[kWidth][V]) {
#pragma unroll
  for (int i = 0; i + 1 < kWidth; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) win[i][v] = win[i + 1][v];
}

template <int kBytes>
__device__ __forceinline__ void copy_async(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
               "n"(kBytes), "r"(valid ? kBytes : 0)
               : "memory");
}

// A thread's rows of its V channels of one or two operands, in order.  Where
// a lane's share of a row is 4 bytes or more, kInFlight bytes of each
// operand's rows are in flight at once, copied (cp.async) into the thread's
// own slots of a shared ring, so the bytes in flight cost no registers; else
// each row is read when taken.
template <typename T, int V, int kInFlight>
struct Rows {
  static constexpr int kBytes = V * static_cast<int>(sizeof(T));
  static constexpr bool kAsync = kBytes >= 4;
  static constexpr int kStages = kAsync ? kInFlight / kBytes : 1;
  static_assert((kStages & (kStages - 1)) == 0, "a power of two");
  static constexpr int kRingBytes = kAsync ? kStages * kThreads * kBytes : 0;

  // the slot of row r (r >= 0) of operand k, for thread tid
  static __device__ __forceinline__ unsigned char* slot(unsigned char* ring, int k, int r,
                                                         int tid) {
    return ring + ((k * kStages + (r & (kStages - 1))) * kThreads + tid) * kBytes;
  }
  // starts the copy of row r of an operand at src (rows `stride` apart),
  // zeros from row `end` on
  static __device__ __forceinline__ void fetch(unsigned char* ring, int k, int tid, const T* src,
                                               long long stride, int r, int end) {
    const bool valid = r < end;
    copy_async<kBytes>(sm90::smem_u32(slot(ring, k, r, tid)), src + (valid ? r : 0) * stride,
                       valid);
  }
  static __device__ __forceinline__ void read(unsigned char* ring, int k, int tid, int r,
                                              float (&out)[V]) {
    load<T, V>(reinterpret_cast<const T*>(slot(ring, k, r, tid)), out);
  }
};

// w and b of this lane's V channels, and the W - 1 rows of x before row t0
// (0 before the sequence) in xw[1 .. W - 1]
template <typename T, int V>
__device__ __forceinline__ void start(const T* __restrict__ w, const T* __restrict__ b,
                                      const T* __restrict__ xb, int channels, int c0, int t0,
                                      long long row_stride, float (&wf)[kWidth][V], float (&bf)[V],
                                      float (&xw)[kWidth][V]) {
#pragma unroll
  for (int i = 0; i < kWidth; ++i) load<T, V>(w + static_cast<long long>(i) * channels + c0, wf[i]);
  load<T, V>(b + c0, bf);
#pragma unroll
  for (int i = 1; i < kWidth; ++i) {
    const int row = t0 - kWidth + i;
#pragma unroll
    for (int v = 0; v < V; ++v) xw[i][v] = 0.0f;
    if (row >= 0) load<T, V>(xb + row * row_stride, xw[i]);
  }
}

template <typename T, int V, bool kSilu>
__global__ void __launch_bounds__(kThreads)
    causal_conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ b, T* __restrict__ out, int seq, int channels,
                           long long batch_stride, long long row_stride) {
  using R = Rows<T, V, kFwdInFlight>;
  __shared__ alignas(16) unsigned char ring[R::kAsync ? R::kRingBytes : 16];
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int c0 = (blockIdx.x * kLanes + threadIdx.x) * V;
  const int t0 = (blockIdx.y * kSegments + threadIdx.y) * kRows;
  if (c0 >= channels || t0 >= seq) return;
  const int t1 = min(t0 + kRows, seq);
  const T* xb = x + blockIdx.z * batch_stride + c0;
  T* ob = out + static_cast<long long>(blockIdx.z) * seq * channels + c0;
  float wf[kWidth][V], bf[V], xw[kWidth][V];
  start<T, V>(w, b, xb, channels, c0, t0, row_stride, wf, bf, xw);
  if constexpr (R::kAsync) {
    for (int k = 0; k + 1 < R::kStages; ++k) {
      R::fetch(ring, 0, tid, xb, row_stride, t0 + k, t1);
      sm90::cp_async_commit();
    }
  }
  for (int t = t0; t < t1; ++t) {
    shift<V>(xw);
    if constexpr (R::kAsync) {
      R::fetch(ring, 0, tid, xb, row_stride, t + R::kStages - 1, t1);
      sm90::cp_async_commit();
      sm90::cp_async_wait<R::kStages - 1>();  // row t has landed
      R::read(ring, 0, tid, t, xw[kWidth - 1]);
    } else {
      load<T, V>(xb + t * row_stride, xw[kWidth - 1]);
    }
    float o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float c = pre_activation<T, V>(xw, wf, bf, v);
      // PyTorch's SiLU in f32, then rounded to T again by store()
      o[v] = kSilu ? __fdiv_rn(c, __fadd_rn(1.0f, expf(-c))) : c;
    }
    store<T, V>(ob + static_cast<long long>(t) * channels, o);
  }
}

template <typename T, int V, bool kSilu>
__global__ void __launch_bounds__(kThreads)
    causal_conv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ b, const T* __restrict__ g, T* __restrict__ dx,
                           float* __restrict__ partial, int seq, int channels,
                           long long batch_stride, long long row_stride) {
  using R = Rows<T, V, kBwdInFlight>;
  constexpr int cols = kLanes * V;
  // the rings of x and g while the rows are walked; then each segment's sums
  // of gc * x (W taps) and of gc (the bias), by column
  constexpr int kRedBytes = kSegments * (kWidth + 1) * cols * static_cast<int>(sizeof(float));
  __shared__ alignas(16) unsigned char smem[2 * R::kRingBytes > kRedBytes ? 2 * R::kRingBytes
                                                                          : kRedBytes];
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int lane_c = threadIdx.x * V;
  const int c0 = blockIdx.x * cols + lane_c;
  const int t0 = (blockIdx.y * kSegments + threadIdx.y) * kRows;
  float acc[kWidth + 1][V];
#pragma unroll
  for (int i = 0; i <= kWidth; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[i][v] = 0.0f;
  if (c0 < channels && t0 < seq) {
    const int t1 = min(t0 + kRows, seq);
    const T* xb = x + blockIdx.z * batch_stride + c0;
    const T* gb = g + static_cast<long long>(blockIdx.z) * seq * channels + c0;
    T* dxb = dx + static_cast<long long>(blockIdx.z) * seq * channels + c0;
    float wf[kWidth][V], bf[V], xw[kWidth][V], gw[kWidth][V];
    start<T, V>(w, b, xb, channels, c0, t0, row_stride, wf, bf, xw);
#pragma unroll
    for (int i = 0; i < kWidth; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) gw[i][v] = 0.0f;
    // row u's gc enters gw[W - 1]; dx of row u - W + 1 needs gc up to row u
    const int end = t1 + kWidth - 1, last = min(end, seq);
    if constexpr (R::kAsync) {
      for (int k = 0; k + 1 < R::kStages; ++k) {
        R::fetch(smem, 0, tid, xb, row_stride, t0 + k, last);
        R::fetch(smem, 1, tid, gb, channels, t0 + k, last);
        sm90::cp_async_commit();
      }
    }
    for (int u = t0; u < end; ++u) {
      shift<V>(xw);
      shift<V>(gw);
      float gu[V];  // rows from the sequence's end on are 0
      if constexpr (R::kAsync) {
        R::fetch(smem, 0, tid, xb, row_stride, u + R::kStages - 1, last);
        R::fetch(smem, 1, tid, gb, channels, u + R::kStages - 1, last);
        sm90::cp_async_commit();
        sm90::cp_async_wait<R::kStages - 1>();  // row u has landed
        R::read(smem, 0, tid, u, xw[kWidth - 1]);
        R::read(smem, 1, tid, u, gu);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) xw[kWidth - 1][v] = gu[v] = 0.0f;
        if (u < last) {
          load<T, V>(xb + u * row_stride, xw[kWidth - 1]);
          load<T, V>(gb + static_cast<long long>(u) * channels, gu);
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float gc = gu[v];
        if (kSilu && u < last) {  // silu'(c) at the rounded pre-activation
          const float c = pre_activation<T, V>(xw, wf, bf, v);
          const float s = __frcp_rn(1.0f + __expf(-c));
          gc = gc * s * (1.0f + c * (1.0f - s));
        }
        gw[kWidth - 1][v] = gc;
      }
      if (u < t1) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
#pragma unroll
          for (int i = 0; i < kWidth; ++i) acc[i][v] = fmaf(gw[kWidth - 1][v], xw[i][v], acc[i][v]);
          acc[kWidth][v] += gw[kWidth - 1][v];
        }
      }
      const int t = u - (kWidth - 1);
      if (t >= t0) {
        float d[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float s = 0.0f;
#pragma unroll
          for (int i = 0; i < kWidth; ++i) s = fmaf(gw[kWidth - 1 - i][v], wf[i][v], s);
          d[v] = s;
        }
        store<T, V>(dxb + static_cast<long long>(t) * channels, d);
      }
    }
    if constexpr (R::kAsync) sm90::cp_async_wait<0>();  // the ring is reused below
  }
  __syncthreads();
  float (*red)[kWidth + 1][cols] = reinterpret_cast<float (*)[kWidth + 1][cols]>(smem);
#pragma unroll
  for (int i = 0; i <= kWidth; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) red[threadIdx.y][i][lane_c + v] = acc[i][v];
  __syncthreads();
  // the CTA's partial: its segments summed in order
  float* part = partial + (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) *
                              (kWidth + 1) * channels;
  for (int e = tid; e < (kWidth + 1) * cols; e += kThreads) {
    const int i = e / cols, j = e % cols;
    const int c = blockIdx.x * cols + j;
    if (c >= channels) continue;
    float s = 0.0f;
#pragma unroll
    for (int y = 0; y < kSegments; ++y) s += red[y][i][j];
    part[static_cast<long long>(i) * channels + c] = s;
  }
}

// dw (W, C) and db (C,) from the CTAs' partials (parts, W + 1, C), added in order
template <typename T>
__global__ void causal_conv_bwd_sum_kernel(const float* __restrict__ partial, T* __restrict__ dw,
                                           T* __restrict__ db, int parts, int width,
                                           int channels) {
  const int n = (width + 1) * channels;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
#pragma unroll 8
  for (int p = 0; p < parts; ++p) s += partial[static_cast<long long>(p) * n + e];
  if (e < width * channels)
    dw[e] = narrow<T>(s);
  else
    db[e - width * channels] = narrow<T>(s);
}

struct Args {
  const void *x, *w, *b, *g;
  void *out, *dw, *db;  // out: the forward's output, or dx
  float* partial;
  int batch, seq, channels, width, silu;
  long long batch_stride, row_stride;
  cudaStream_t stream;
};

template <bool kBackward, typename T, int V, bool kSilu>
cudaError_t run(const Args& a) {
  const dim3 grid((a.channels / V + kLanes - 1) / kLanes, (a.seq + kCtaRows - 1) / kCtaRows,
                  a.batch);
  const dim3 block(kLanes, kSegments);
  const T *x = static_cast<const T*>(a.x), *w = static_cast<const T*>(a.w),
          *b = static_cast<const T*>(a.b);
  if constexpr (!kBackward) {
    causal_conv_fwd_kernel<T, V, kSilu><<<grid, block, 0, a.stream>>>(
        x, w, b, static_cast<T*>(a.out), a.seq, a.channels, a.batch_stride, a.row_stride);
    return cudaGetLastError();
  } else {
    causal_conv_bwd_kernel<T, V, kSilu><<<grid, block, 0, a.stream>>>(
        x, w, b, static_cast<const T*>(a.g), static_cast<T*>(a.out), a.partial, a.seq,
        a.channels, a.batch_stride, a.row_stride);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int n = (kWidth + 1) * a.channels;
    causal_conv_bwd_sum_kernel<T><<<(n + 255) / 256, 256, 0, a.stream>>>(
        a.partial, static_cast<T*>(a.dw), static_cast<T*>(a.db), grid.y * grid.z, kWidth,
        a.channels);
    return cudaGetLastError();
  }
}

template <bool kBackward, typename T, int V>
cudaError_t by_silu(const Args& a) {
  return a.silu ? run<kBackward, T, V, true>(a) : run<kBackward, T, V, false>(a);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

// V channels a lane where every row of every operand starts on a V-value
// boundary, else 1.
template <bool kBackward, typename T>
cudaError_t by_vector(const Args& a) {
  constexpr int V = kBackward ? kBwdChannels : kFwdBytes / static_cast<int>(sizeof(T));
  constexpr int bytes = V * static_cast<int>(sizeof(T));
  const bool vec = a.channels % V == 0 && a.batch_stride % V == 0 && a.row_stride % V == 0 &&
                   aligned(a.x, bytes) && aligned(a.w, bytes) && aligned(a.b, bytes) &&
                   aligned(a.out, bytes) && (!kBackward || aligned(a.g, bytes));
  return vec ? by_silu<kBackward, T, V>(a) : by_silu<kBackward, T, 1>(a);
}

template <bool kBackward>
int dispatch(const Args& a, int bf16) {
  if (a.batch <= 0 || a.seq <= 0 || a.channels <= 0 || a.width != kWidth ||
      a.batch > 65535 || (a.seq + kCtaRows - 1) / kCtaRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bf16 ? by_vector<kBackward, __nv_bfloat16>(a)
                               : by_vector<kBackward, float>(a));
}

}  // namespace

extern "C" {

const char* causal_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, S, C), unit channel stride, batch and row strides in elements; w (W,
// C), b (C,), out (B, S, C) contiguous; all float32 (bf16 0) or bfloat16
// (bf16 1); silu 0 or 1; W 4 (kWidth), the only width built.
int causal_conv_forward(const void* x, const void* w, const void* b, void* out, int batch,
                        int seq, int channels, int width, long long batch_stride,
                        long long row_stride, int bf16, int silu, void* stream) {
  const Args a{x, w, b, nullptr, out, nullptr, nullptr, nullptr, batch, seq, channels, width,
               silu, batch_stride, row_stride, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, bf16);
}

// As the forward, with g and dx (B, S, C) contiguous, dw (W, C) and db (C,)
// in the same type, and f32 scratch `partial` of (B * ceil(S / cta_rows),
// W + 1, C); cta_rows must be the kernel's rows a CTA (512).
int causal_conv_backward(const void* x, const void* w, const void* b, const void* g, void* dx,
                         void* dw, void* db, float* partial, int batch, int seq, int channels,
                         int width, long long batch_stride, long long row_stride, int bf16,
                         int silu, int cta_rows, void* stream) {
  if (cta_rows != kCtaRows) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w, b, g, dx, dw, db, partial, batch, seq, channels, width, silu,
               batch_stride, row_stride, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, bf16);
}

}  // extern "C"
