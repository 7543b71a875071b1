// Flash attention forward (K4) in float32 for Hopper (sm_90a), bound to Python with ctypes.
//
// flash_attention_f32_launch replaces src/repro/kernels/flash_attention/
//    flash_attention.py flash_attention_pallas (body _flash_kernel, whose two
//    jnp.dot are f32 with f32 accumulation) for float32 q, k, v: GQA over q
//    (B, Sq, H, D) and k, v (B, Sk, KVH, D), rows (position i, group g)
//    numbered i * G + g, an online softmax in f32 (running max m,
//    denominator l, accumulator acc) and o = acc / max(l, 1e-30) in f32.
//    Masks as in the TPU kernel: causal top-left (query i sees keys j <= i),
//    the window keeping j > i - window, masked scores at -0.7 * FLT_MAX
//    (not -inf), keys past Sk absent (they add nothing to l).  q is scaled
//    in f32 before the product, as the plain version does.  Where the caller
//    passes it, the (2, B, H, Sq) f32 buffer receives each row's final max m
//    and denominator l for the backward (csrc/flash_attention_f32_bwd.cu).
//    csrc/flash_attention.cu and csrc/flash_attention_wide.cu take bf16.
//
// This is the path of the f32 parity checks (the serving path's greedy
// tokens, the f32 training step), held to 2e-4 / 2e-5 of the plain version.
// The CUDA cores' f32 rate (67 TFLOP/s) put this kernel's earlier version
// far behind PyTorch's own f32 attention at D 128, for whisper's encoder and
// for the vision model's cross-attention.  So the products run on the tensor
// cores: each f32 operand is split into three bf16 pieces and every product
// is the six products of pieces (flash::ss_pieces, flash::rs_pieces in
// csrc/flash_tiles.cuh), near-f32 arithmetic; TF32 (10-bit mantissas) alone
// would miss the tolerance.  Bound: operations, six times kernel_flops = 4 B
// H Sq Sk D (halved when causal, scaled by the pairs a window keeps) at the
// 989 TFLOP/s bf16 peak: tinyllama's prefill at S 2048 is 17.2 GFLOP of f32
// products, 103 GFLOP of bf16 ones, 0.104 ms, against 38 MB of q, k, v and o.
//
// One warpgroup (128 threads) owns a CTA's 64 rows, wgmma's M, at every
// width: Q's three pieces take 3 x 64 x DP bf16 (96 KB at DP 256), so two
// warpgroups of 64 rows each, as the bf16 kernels run past D 128, would
// leave no room for the key tiles.  Key tiles hold KT keys (key_tile: 64 at
// DP 64, 16 past it), so that Q's pieces, one K and one V tile of pieces and
// the running O fit the shared memory, and a thread's registers hold the
// accumulators, the scores, P's pieces and the next tile in flight:
//  - Q is read once, scaled, split and stored as three pieces.  Each K and V
//    tile is read from device memory into registers (16-byte loads, whole
//    rows a warp) one step ahead, and split once into its pieces as it is
//    stored: F32Rows.  K of tile j + 1 is split while P V of tile j runs on
//    the tensor cores, and V of tile j while S of tile j does.
//  - S = Q K^T as six SS products; the softmax runs in f32 on the
//    accumulator fragments in registers as the bf16 kernel's does (a row's
//    max over the 4 lanes that share it, expf, l a per-lane share until the
//    end), masks only on the tiles that need them.
//  - P is split into three RS operands in registers, and O += P V runs as
//    six RS products, V MN-major (the transpose bit) as it lies in memory,
//    into accumulators that take 64 keys' tiles and are then added into the
//    running O (f32, in shared memory, rescaled by the alphas since) with
//    one rounding an element, under the next tile's S.  One accumulator
//    across a whole walk drifted from the exact sum on an H100: tinyllama's
//    S 2048 row sat 0.065 of the f32 tolerance from float64, three times
//    the CUDA-core kernel's 0.022.
//  - A causal grid launches its last row blocks (the longest walks) first,
//    and every walk starts at its window's edge (flash::forward_walk in
//    csrc/flash_tiles.cuh, the same statement for every forward kernel).
// The loads need D % 4 == 0 and 16-byte aligned tensors: the wrapper pads D
// to a multiple of 4 with zero columns, and copies an unaligned tensor to
// an aligned one, before the launch; the columns past D are zero in every
// piece, so the padded products add exact zeros.
//
// The entry point returns cudaGetLastError() so the wrapper can raise on a
// refused launch.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_tiles.cuh"
#include "sm90.cuh"

namespace {

using flash::kPieces;
using flash::kTileRows;
using flash::kWarpgroup;

constexpr int kMaxHeadDim = 256;
constexpr int kMaxSmemBytes = 232448;  // dynamic shared memory a block may use on sm_90
constexpr float kMaskValue = -0.7f * FLT_MAX;

// Keys of a key tile at the padded width DP: 16 past DP 64 (at DP 128, 32
// left one CTA an SM, and its rows ran 11-16 % slower on an H100).
template <int DP>
__host__ __device__ constexpr int key_tile() {
  return DP == 64 ? 64 : 16;
}
// Q's pieces, one K and one V tile of pieces, the running O in f32, alignment.
template <int DP>
__host__ __device__ constexpr int smem_bytes() {
  return kPieces * (kTileRows + 2 * key_tile<DP>()) * DP * 2 + kTileRows * DP * 4 + 1024;
}
static_assert(smem_bytes<256>() <= kMaxSmemBytes && smem_bytes<192>() <= kMaxSmemBytes,
              "f32 K4 pieces exceed shared memory");
// CTAs a SM the registers must allow
template <int DP>
__host__ __device__ constexpr int min_ctas() {
  return DP <= 128 ? 2 : 1;
}

template <int DP>
__global__ void __launch_bounds__(kWarpgroup, min_ctas<DP>())
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int batch, int seq_q,
                     int seq_k, int heads, int kv_heads, int head_dim, int causal, int window,
                     float scale, float* __restrict__ stats) {
  constexpr int KT = key_tile<DP>();
  constexpr int kQBytes = kPieces * kTileRows * DP * 2, kKvBytes = kPieces * KT * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-aligned
  unsigned char* const q_gen = smem_raw + (base - raw);
  unsigned char* const k_gen = q_gen + kQBytes;
  unsigned char* const v_gen = k_gen + kKvBytes;
  // the running O: this thread's accumulator element i at o_run[i * 128 + tid]
  float* const o_run = reinterpret_cast<float*>(v_gen + kKvBytes);
  const uint32_t q_tile = base, k_tile = base + kQBytes, v_tile = k_tile + kKvBytes;

  const int D = head_dim, groups = heads / kv_heads;
  const int nbh = batch * kv_heads;
  const int bh = blockIdx.x % nbh, b = bh / kv_heads, kvh = bh % kv_heads;
  const int total_rows = seq_q * groups;
  const int n_blocks = (total_rows + kTileRows - 1) / kTileRows;
  const int o_th = blockIdx.x / nbh;  // longest walk first: a causal grid from its last block
  const int row0 = (causal ? n_blocks - 1 - o_th : o_th) * kTileRows;
  const int tid = threadIdx.x;

  const int first_pos = row0 / groups;
  const int last_pos = (min(row0 + kTileRows, total_rows) - 1) / groups;
  const flash::ForwardWalk walk = flash::forward_walk(first_pos, last_pos, seq_k, causal, window);
  // the walk in tiles of KT keys: a causal walk stops at the last row's diagonal
  const int j_lo = walk.t_lo * (kTileRows / KT);
  int j_end = min(walk.t_end * (kTileRows / KT), (seq_k + KT - 1) / KT);
  if (causal) j_end = min(j_end, last_pos / KT + 1);
  const int n = max(j_end - j_lo, 0);

  auto q_row = [&](int r) -> const float* {
    const int rho = row0 + r;
    if (rho >= total_rows) return nullptr;
    const int i = rho / groups, g = rho - i * groups;
    return q + ((static_cast<int64_t>(b) * seq_q + i) * heads + kvh * groups + g) * D;
  };
  auto kv_rows = [&](const float* x, int k0) {
    return [&, x, k0](int r) -> const float* {
      if (k0 + r >= seq_k) return nullptr;
      return x + ((static_cast<int64_t>(b) * seq_k + k0 + r) * kv_heads + kvh) * D;
    };
  };

  // Q's pieces (scaled), KT rows at a time; K of the first tile; its V in flight
  flash::F32Rows<KT, DP> next;
#pragma unroll 1
  for (int r0 = 0; r0 < kTileRows; r0 += KT) {
    next.load(D, [&](int r) { return q_row(r0 + r); });
    next.template store<kTileRows>(q_gen, r0, scale);
  }
  next.load(D, kv_rows(k, j_lo * KT));
  next.template store<KT>(k_gen, 0, 1.0f);
  next.load(D, kv_rows(v, j_lo * KT));
  sm90::fence_proxy_async();  // the pieces' writes, before wgmma reads them
  __syncthreads();

  // this thread's two rows (h = 0, 1) and its first key in each 8-key block
  const int ra = tid / 32 * 16 + tid % 32 / 4;
  const int pos[2] = {(row0 + ra) / groups, (row0 + ra + 8) / groups};
  const int col = 2 * (tid % 4);

  float m_run[2] = {kMaskValue, kMaskValue};
  float l_run[2] = {0.0f, 0.0f};  // this lane's share of the row sums
  // O = o_run x carry + acc: acc the P V of the walk's tiles since the last
  // flush (every kFlushTiles tiles, 64 keys), carry the alphas since then
  constexpr int kFlushTiles = kTileRows / KT;
  float acc[DP / 2], carry[2] = {1.0f, 1.0f};
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o_run[i * kWarpgroup + tid] = 0.0f;
  float s[KT / 2];
  uint32_t p[kPieces][KT / 16][4];
  // o_run = o_run x carry + acc, each element rounded once (one accumulator
  // across the walk would take every tile's wgmma sums)
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      float& o = o_run[i * kWarpgroup + tid];
      o = fmaf(o, carry[i % 4 / 2], acc[i]);
    }
    carry[0] = carry[1] = 1.0f;
  };

  for (int j = 0; j < n; ++j) {
    const int k0 = (j_lo + j) * KT;
    // S of tile j on the tensor cores while V of tile j is split
    sm90::wgmma_fence();
    flash::ss_pieces<DP, KT>(s, q_tile, k_tile);
    sm90::wgmma_commit();
    if (j > 0 && j % kFlushTiles == 0) flush();  // the tiles up to j - 1
    next.template store<KT>(v_gen, 0, 1.0f);  // P V of tile j - 1 has completed
    sm90::fence_proxy_async();
    if (j + 1 < n) next.load(D, kv_rows(k, k0 + KT));
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    __syncthreads();  // V of tile j in place; every warp's S has read K of tile j

    const bool masked = k0 + KT > seq_k || (causal && k0 + KT - 1 > first_pos) ||
                        (window && k0 <= last_pos - window);
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const int h = i % 4 / 2;
      float x = s[i];
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
      carry[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const int h = i % 4 / 2;
      // keys past Sk are not there at all: they add nothing to l
      const bool absent = masked && k0 + i / 4 * 8 + col + i % 2 >= seq_k;
      const float e = absent ? 0.0f : expf(s[i] - m_run[h]);
      s[i] = e;
      l_run[h] += e;
    }
    const bool fresh = j % kFlushTiles == 0;  // the first tile since a flush
    if (!fresh) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[i % 4 / 2];
    }

    // tile j's P V while K of tile j + 1 is split
    flash::split_operand3(s, p);
    flash::fence_operand3(p);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    flash::rs_pieces<DP, KT / 16>(acc, p, v_tile, fresh);
    sm90::wgmma_commit();
    if (j + 1 < n) {
      next.template store<KT>(k_gen, 0, 1.0f);
      sm90::fence_proxy_async();
      next.load(D, kv_rows(v, k0 + KT));
    }
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    flash::fence_operand3(p);  // P V has read them
    __syncthreads();  // K of tile j + 1 in place; every warp's P V has read V of tile j
  }
  if (n > 0) flush();

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
      stats[static_cast<int64_t>(batch) * heads * seq_q + idx] = l;
    }
    float* dst = o + ((static_cast<int64_t>(b) * seq_q + i) * heads + kvh * groups + g) * D;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      const int c = 8 * jj + col;  // D is even: c < D leaves c + 1 < D
      if (c < D)
        *reinterpret_cast<float2*>(dst + c) =
            make_float2(o_run[(4 * jj + 2 * h) * kWarpgroup + tid] / denom,
                        o_run[(4 * jj + 2 * h + 1) * kWarpgroup + tid] / denom);
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int seq_q,
                   int seq_k, int heads, int kv_heads, int head_dim, int causal, int window,
                   float scale, float* stats, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(seq_q) * (heads / kv_heads);
  const int64_t ctas =
      static_cast<int64_t>(batch) * kv_heads * ((rows + kTileRows - 1) / kTileRows);
  if (ctas > INT32_MAX || rows > INT32_MAX) return cudaErrorInvalidValue;
  flash_fwd_f32_kernel<DP><<<static_cast<unsigned>(ctas), kWarpgroup, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), batch, seq_q, seq_k, heads, kv_heads, head_dim, causal, window,
      scale, stats);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

const char* flash_attention_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o (B, Sq, H, D) and k, v (B, Sk, KVH, D) in float32, contiguous, on
// the card, 1 <= D <= 256, D % 4 == 0, 16-byte aligned.  stats, null or
// (2, B, H, Sq) f32, receives each row's final max m and denominator l for
// the backward (csrc/flash_attention_f32_bwd.cu); null leaves the forward
// as it is.
int flash_attention_f32_launch(const void* q, const void* k, const void* v, void* o, int batch,
                               int seq_q, int seq_k, int heads, int kv_heads, int head_dim,
                               int causal, int window, float scale, float* stats, void* stream) {
  if (batch <= 0 || seq_q <= 0 || seq_k <= 0 || kv_heads <= 0 || heads % kv_heads ||
      head_dim < 1 || head_dim > kMaxHeadDim || head_dim % 4 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K4_F32(DP)                                                                          \
  launch<DP>(q, k, v, o, batch, seq_q, seq_k, heads, kv_heads, head_dim, causal, window,    \
             scale, stats, s)
  if (head_dim <= 64) return static_cast<int>(K4_F32(64));
  if (head_dim <= 128) return static_cast<int>(K4_F32(128));
  if (head_dim <= 192) return static_cast<int>(K4_F32(192));
  return static_cast<int>(K4_F32(256));
#undef K4_F32
}

}  // extern "C"
