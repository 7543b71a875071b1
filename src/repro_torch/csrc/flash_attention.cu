// Flash attention forward (K4) in bf16 for Hopper (sm_90a), bound to Python with ctypes.
//
// flash_attention_launch replaces src/repro/kernels/flash_attention/
//    flash_attention.py flash_attention_pallas (body _flash_kernel) for bf16
//    q, k, v with a head dim D up to 128: GQA attention over q (B, Sq, H, D)
//    and k, v (B, Sk, KVH, D), the G = H/KVH query heads of one kv head
//    sharing its keys, with an online softmax in f32 (running max m,
//    denominator l, accumulator acc) and the output acc / max(l, 1e-30) in
//    bf16.  Masks as in the TPU kernel: causal is top-left aligned (query i
//    sees keys j <= i), the window keeps j > i - window, and masked scores
//    are -0.7 * FLT_MAX (not -inf), so a fully masked tile behaves as it
//    does there.  Keys past Sk (which add nothing to l) and query rows past
//    Sq (the ragged last tiles) are masked here, so any length runs through
//    the kernel.  bf16 past D 128 runs csrc/flash_attention_wide.cu, and
//    float32 csrc/flash_attention_f32.cu.
//
// Head dims: the padded widths DP 64 and 128; the columns D .. DP - 1 are
// zero in shared memory, so the padded products add exact zeros and equal
// the unpadded ones.  Only D columns are read from and written to device
// memory.
//
// One CTA to each (batch, kv head, block of 64 query rows), where a row is
// one (position i, group g) pair, numbered i * G + g: the G heads of a
// position are adjacent in memory and share the CTA's keys.  A causal CTA
// stops at the tile that holds its last row's diagonal, as the TPU kernel
// does.  A windowed CTA starts at the tile that holds its first row's
// window edge, max(0, first position - window + 1): no key before it is
// kept, and at the first walked tile alpha = exp(MASK - m) = 0 multiplies
// what the skipped tiles would have added by zero, so o and the statistics
// keep their bits.  A CTA holding a fully masked row (position >= Sk +
// window - 1, when Sq > Sk) walks from tile 0, so that row averages every
// key as the TPU kernel's does (flash::forward_walk in csrc/flash_tiles.cuh,
// for every forward kernel; forward_walk in
// kernels/flash_attention/flash_attention.py states it for the tests).
// Where a training step will take the gradient, the caller passes a
// (2, B, H, Sq) f32 buffer and each row's final max m and denominator l
// are written there for the backward (csrc/flash_attention_bwd.cu); with
// null (serving) nothing else changes.
//
// flash_fwd_bf16_kernel: the tensor cores.  Bound: operations,
// kernel_flops = 4 * B * H * Sq * Sk * D (halved when causal): 17.2 GFLOP
// for tinyllama's prefill at S = 2048, 0.017 ms at the 989 TFLOP/s bf16
// peak, against 19 MB of q, k, v and o.  One warpgroup (128 threads) owns
// the CTA's 64 rows, wgmma's M:
//  - S = Q K^T by wgmma m64n64k16 (bf16 operands, f32 accumulators), DP/16
//    steps, Q and the K tile read from shared memory K-major, as they lie
//    in memory; scale multiplies the f32 scores.
//  - The online softmax runs on the accumulator fragments in registers: a
//    row's max is reduced over the 4 lanes that share the row, its sum l
//    stays a per-lane share until the end.  Masks are applied only on the
//    tiles that need them (the diagonal, the window's edge, the ragged
//    last key tile).
//  - P is rounded to bf16 in registers, where the S fragment already has
//    the layout of wgmma's A operand, and O += P V runs in the RS form,
//    DP columns as m64n128k16 pieces and an m64n64k16 for the last 64 of
//    DP = 64, with the V tile read from shared memory MN-major (the
//    transpose bit), as it lies in memory.  The scale, max, exp, l and O
//    stay f32: only P is rounded.
//  - K and V tiles arrive by 16-byte cp.async copies in a ring of two
//    stages, each completing on an mbarrier (cp.async.mbarrier.arrive), so
//    tile t + 1 loads while tile t is multiplied.  Key rows past Sk are
//    zero-filled by the copy and read nothing.  Tiles are stored with the
//    128-byte swizzle that wgmma's descriptors name, in regions of 64
//    columns.  The copies need D % 8 == 0 and 16-byte aligned tensors: the
//    wrapper pads D to a multiple of 8 with zero columns, and copies an
//    unaligned tensor to an aligned one, before the launch.
//
// The entry points return cudaGetLastError() so the wrapper can raise on a
// refused launch.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_tiles.cuh"
#include "sm90.cuh"

namespace {

constexpr int kMaxHeadDim = 256;
constexpr int kMaxSmemBytes = 232448;  // dynamic shared memory a block may use on sm_90
constexpr float kMaskValue = -0.7f * FLT_MAX;

using flash::kTileRows;
using flash::kWarpgroup;
using flash::load_tile;
using flash::pv_product;
using flash::qk_product;
using flash::zero_padding;

constexpr int bf16_smem_bytes(int dp) {
  return 5 * dp * 128 + 2 * 8 + 1024;  // Q, two K and two V tiles, two barriers, alignment
}
static_assert(bf16_smem_bytes(128) <= kMaxSmemBytes, "bf16 K4 tiles exceed shared memory");

// kFull: D == DP, a compile-time head dim for the exact widths 64 and 128
// (at D 64 a runtime D took 20 % more time on an H100).
template <int DP, bool kFull>
__global__ void __launch_bounds__(kWarpgroup)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      int seq_q, int seq_k, int heads, int kv_heads, int head_dim, int causal,
                      int window, float scale, float* __restrict__ stats) {
  constexpr int kTileBytes = DP * 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-aligned
  unsigned char* const tiles = smem_raw + (base - raw);
  const uint32_t q_tile = base;                   // then K0, V0, K1, V1
  const uint32_t full = base + 5 * kTileBytes;    // stage s's barrier at full + 8 s

  const int D = kFull ? DP : head_dim;
  const int groups = heads / kv_heads;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const int total_rows = seq_q * groups;
  const int tid = threadIdx.x;

  if (tid == 0) {
    sm90::mbar_init(full, kWarpgroup);
    sm90::mbar_init(full + 8, kWarpgroup);
    sm90::fence_mbar_init();
  }
  if constexpr (!kFull) zero_padding<DP>(tiles, 5, D);
  __syncthreads();

  load_tile<DP>(q_tile, q, D, [&](int r) -> const __nv_bfloat16* {
    const int rho = row0 + r;
    if (rho >= total_rows) return nullptr;
    const int i = rho / groups, g = rho % groups;
    return q + ((static_cast<int64_t>(b) * seq_q + i) * heads + kvh * groups + g) * D;
  });
  const int last_row = min(row0 + kTileRows, total_rows) - 1;
  const int first_pos = row0 / groups;
  const int last_pos = last_row / groups;
  const flash::ForwardWalk walk = flash::forward_walk(first_pos, last_pos, seq_k, causal, window);
  const int t_lo = walk.t_lo;
  const int n_tiles = walk.t_end - t_lo;

  // the walk's j-th tile (key tile t_lo + j) into stage j % 2; Q joins stage
  // 0's first phase
  auto load_kv = [&](int j) {
    const uint32_t kt = base + (1 + 2 * (j & 1)) * kTileBytes;
    auto row = [&](const __nv_bfloat16* x) {
      return [&, x](int r) -> const __nv_bfloat16* {
        const int key = (t_lo + j) * kTileRows + r;
        if (key >= seq_k) return nullptr;
        return x + ((static_cast<int64_t>(b) * seq_k + key) * kv_heads + kvh) * D;
      };
    };
    load_tile<DP>(kt, k, D, row(k));
    load_tile<DP>(kt + kTileBytes, v, D, row(v));
    sm90::cp_async_arrive(full + 8 * (j & 1));
  };
  load_kv(0);

  // this thread's two rows (h = 0, 1) and its first column in each 8-column block
  const int ra = tid / 32 * 16 + tid % 32 / 4;
  const int pos[2] = {(row0 + ra) / groups, (row0 + ra + 8) / groups};
  const int col = 2 * (tid % 4);

  float m_run[2] = {kMaskValue, kMaskValue};
  float l_run[2] = {0.0f, 0.0f};  // this lane's share of the row sums
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  float s[32];

  for (int j = 0; j < n_tiles; ++j) {
    // stage (j + 1) % 2 was released by the barrier that ended tile j - 1
    if (j + 1 < n_tiles) load_kv(j + 1);
    const uint32_t kt = base + (1 + 2 * (j & 1)) * kTileBytes;
    sm90::mbar_wait(full + 8 * (j & 1), (j >> 1) & 1);
    sm90::fence_proxy_async();  // the copies' writes, before wgmma reads them
    qk_product<DP>(s, q_tile, kt);

    const int k0 = (t_lo + j) * kTileRows;
    const bool masked = k0 + kTileRows > seq_k || (causal && k0 + kTileRows - 1 > first_pos) ||
                        (window && k0 <= last_pos - window);
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = i % 4 / 2;
      float x = s[i] * scale;
      if (masked) {
        const int key = k0 + i / 4 * 8 + col + i % 2;
        bool keep = key < seq_k;
        if (causal) keep = keep && key <= pos[h];
        if (window) keep = keep && key > pos[h] - window;
        if (!keep) x = kMaskValue;
      }
      s[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = i % 4 / 2;
      // keys past Sk are not there at all: they add nothing to l
      const bool absent = masked && k0 + i / 4 * 8 + col + i % 2 >= seq_k;
      const float p = absent ? 0.0f : expf(s[i] - m_run[h]);
      s[i] = p;
      l_run[h] += p;
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[i % 4 / 2];
    pv_product<DP>(acc, s, kt + kTileBytes);
    __syncthreads();  // every warp is done with this stage before it is loaded again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int rho = row0 + ra + 8 * h;
    if (rho >= total_rows) continue;
    const float denom = fmaxf(l, 1e-30f);
    const int i = rho / groups, g = rho % groups;
    if (stats != nullptr && tid % 4 == 0) {  // m and l, (2, B, H, Sq), for the backward
      const int64_t idx = (static_cast<int64_t>(b) * heads + kvh * groups + g) * seq_q + i;
      stats[idx] = m_run[h];
      stats[static_cast<int64_t>(gridDim.z) * heads * seq_q + idx] = l;
    }
    __nv_bfloat16* dst = o + ((static_cast<int64_t>(b) * seq_q + i) * heads + kvh * groups + g) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const float lo = acc[4 * j + 2 * h] / denom, hi = acc[4 * j + 2 * h + 1] / denom;
      if (8 * j < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + col) = __floats2bfloat162_rn(lo, hi);
    }
  }
}

// One tile of each product on its own, for the card tests: S = q k^T and
// O = bf16(S) v for (64, D) row-major q, k, v (D % 8 == 0), in the kernel's
// layouts at the padded width DP.
template <int DP>
__global__ void __launch_bounds__(kWarpgroup)
wgmma_probe_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, float* __restrict__ s_out,
                   float* __restrict__ o_out, int head_dim) {
  constexpr int kTileBytes = DP * 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const tiles = smem_raw + (base - raw);
  const uint32_t full = base + 3 * kTileBytes;
  const int D = head_dim;
  if (threadIdx.x == 0) {
    sm90::mbar_init(full, kWarpgroup);
    sm90::fence_mbar_init();
  }
  zero_padding<DP>(tiles, 3, D);
  __syncthreads();
  const __nv_bfloat16* src[3] = {q, k, v};
  for (int t = 0; t < 3; ++t) {
    load_tile<DP>(base + t * kTileBytes, q, D, [&](int r) { return src[t] + r * D; });
  }
  sm90::cp_async_arrive(full);
  sm90::mbar_wait(full, 0);
  sm90::fence_proxy_async();

  float s[32], acc[DP / 2];
  qk_product<DP>(s, base, base + kTileBytes);
  const int ra = threadIdx.x / 32 * 16 + threadIdx.x % 32 / 4;
  const int col = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int i = 0; i < 32; ++i) s_out[(ra + 8 * (i % 4 / 2)) * 64 + i / 4 * 8 + col + i % 2] = s[i];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  pv_product<DP>(acc, s, base + 2 * kTileBytes);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int c = i / 4 * 8 + col + i % 2;
    if (c < D) o_out[(ra + 8 * (i % 4 / 2)) * D + c] = acc[i];
  }
}

template <int DP, bool kFull>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int batch,
                        int seq_q, int seq_k, int heads, int kv_heads, int head_dim, int causal,
                        int window, float scale, float* stats, cudaStream_t stream) {
  constexpr int smem = bf16_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DP, kFull>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long row_blocks =
      (static_cast<long>(seq_q) * (heads / kv_heads) + kTileRows - 1) / kTileRows;
  const dim3 grid(static_cast<unsigned>(row_blocks), kv_heads, batch);
  flash_fwd_bf16_kernel<DP, kFull><<<grid, kWarpgroup, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), seq_q, seq_k, heads,
      kv_heads, head_dim, causal, window, scale, stats);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16_dp(int head_dim, const void* q, const void* k, const void* v, void* o,
                           int batch, int seq_q, int seq_k, int heads, int kv_heads, int causal,
                           int window, float scale, float* stats, cudaStream_t stream) {
#define K4_BF16(FULL)                                                                     \
  launch_bf16<DP, FULL>(q, k, v, o, batch, seq_q, seq_k, heads, kv_heads, head_dim, causal, \
                        window, scale, stats, stream)
  if (head_dim == DP) return K4_BF16(true);
  return K4_BF16(false);
#undef K4_BF16
}

cudaError_t launch_bf16_width(int head_dim, const void* q, const void* k, const void* v,
                              void* o, int batch, int seq_q, int seq_k, int heads, int kv_heads,
                              int causal, int window, float scale, float* stats,
                              cudaStream_t stream) {
#define K4_BF16(DP)                                                                        \
  launch_bf16_dp<DP>(head_dim, q, k, v, o, batch, seq_q, seq_k, heads, kv_heads, causal,   \
                     window, scale, stats, stream)
  if (head_dim <= 64) return K4_BF16(64);
  if (head_dim <= 128) return K4_BF16(128);
  return cudaErrorInvalidValue;  // csrc/flash_attention_wide.cu takes D > 128
#undef K4_BF16
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int DP>
cudaError_t launch_probe(const void* q, const void* k, const void* v, float* s, float* o,
                         int head_dim, cudaStream_t stream) {
  constexpr int smem = 3 * DP * 128 + 8 + 1024;
  cudaError_t err = cudaFuncSetAttribute(wgmma_probe_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wgmma_probe_kernel<DP><<<1, kWarpgroup, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), s, o, head_dim);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o (B, Sq, H, D) and k, v (B, Sk, KVH, D) in bfloat16, contiguous, on
// the card, 1 <= D <= 128 (the rest is flash_attention_wide_launch's),
// D % 8 == 0, 16-byte aligned.  stats, null or (2, B, H, Sq) f32, receives
// each row's final max m and denominator l for the backward
// (csrc/flash_attention_bwd.cu); null leaves the forward as it is.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int batch,
                           int seq_q, int seq_k, int heads, int kv_heads, int head_dim,
                           int causal, int window, float scale, float* stats, void* stream) {
  // 16-byte copies need whole 8-column chunks on 16-byte aligned rows
  if (batch <= 0 || seq_q <= 0 || seq_k <= 0 || kv_heads <= 0 || heads % kv_heads ||
      head_dim < 1 || head_dim > kMaxHeadDim || head_dim % 8 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_bf16_width(head_dim, q, k, v, o, batch, seq_q, seq_k, heads,
                                            kv_heads, causal, window, scale, stats,
                                            static_cast<cudaStream_t>(stream)));
}

// One tile of each bf16 product (S = q k^T, O = bf16(S) v) for (64, D)
// row-major q, k, v on the card (D a multiple of 8 up to 256, 16-byte
// aligned); s is (64, 64) and o (64, D), f32.
int flash_attention_wgmma_probe(const void* q, const void* k, const void* v, float* s, float* o,
                                int head_dim, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim < 8 || head_dim > kMaxHeadDim || head_dim % 8 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim <= 64) return static_cast<int>(launch_probe<64>(q, k, v, s, o, head_dim, st));
  if (head_dim <= 128) return static_cast<int>(launch_probe<128>(q, k, v, s, o, head_dim, st));
  if (head_dim <= 192) return static_cast<int>(launch_probe<192>(q, k, v, s, o, head_dim, st));
  return static_cast<int>(launch_probe<256>(q, k, v, s, o, head_dim, st));
}

}  // extern "C"
