// Flash attention forward (K4) in bf16 past D 128 for Hopper (sm_90a),
// bound to Python with ctypes.
//
// flash_attention_wide_launch replaces src/repro/kernels/flash_attention/
//    flash_attention.py flash_attention_pallas (body _flash_kernel) for bf16
//    q, k, v with a head dim D from 129 to 256 (stablelm-12b's 160,
//    recurrentgemma-9b's 256); csrc/flash_attention.cu takes every other
//    call.  The function, the masks and the arithmetic are that kernel's:
//    GQA over q (B, Sq, H, D) and k, v (B, Sk, KVH, D), rows (position i,
//    group g) numbered i * G + g; S = Q K^T in f32 times scale, masked
//    scores at -0.7 * FLT_MAX (causal top-left, the window keeping
//    j > i - window, keys past Sk absent), the online softmax in f32 with
//    expf, only P rounded to bf16 for O += P V, o = acc / max(l, 1e-30) in
//    bf16, and where the caller passes it the (2, B, H, Sq) f32 buffer of
//    each row's final max m and denominator l for the backward.  Each
//    element goes through the same operations in the same order as in
//    flash_fwd_bf16_kernel (csrc/flash_attention.cu), each rounded on its
//    own, so that the two kernels' arithmetic is one.
//
// Bound: operations, kernel_flops = 4 B H Sq Sk D (halved when causal, scaled
// by the pairs a window keeps) at the 989 TFLOP/s bf16 peak: stablelm-12b's
// prefill at S 2048 is 43 GFLOP, 0.043 ms, against 47 MB of q, k, v and o.
// One warpgroup of 64 rows a CTA holding DP / 2 f32 accumulators a thread
// leaves one CTA of 4 warps an SM at these widths, with nothing to overlap
// the softmax, the products and the loads.  The design:
//  - 128 rows a CTA: two consumer warpgroups of 64 rows each (rows 64 w ..
//    64 w + 63 of the CTA) share one ring of K tiles (3 stages) and one of
//    V tiles (3 at DP 192, 2 at DP 256), which halves the K/V traffic a row
//    and puts 8 consumer warps on the SM.
//  - K and V arrive by 16-byte cp.async, each tile completing on its
//    stage's "full" mbarrier (cp.async.mbarrier.arrive); each consumer warp
//    releases a stage on its "empty" mbarrier (8 arrivals) once the product
//    that read it has completed, and a stage is reloaded only after both
//    warpgroups released it.  No __syncthreads in the walk.  Who copies
//    depends on the registers (kProducer): at D 129 .. 160 a producer
//    warpgroup copies every K and V tile as stages free up; ptxas holds
//    every thread of that 384-thread CTA to 168 registers (setmaxnreg or
//    not), which the consumers' 80 accumulators, S and P fit.  At DP 192
//    and 256 they would spill, and the products run serialised, so there
//    the consumers' 256 threads copy for themselves (up to 255 registers a
//    thread), every K tile two tiles ahead and every V tile one or two.
//  - The softmax overlaps the tensor cores within each warpgroup: tile t's
//    S = Q K_t^T is issued, then O += P_{t-1} V_{t-1}; wgmma.wait_group 1
//    completes S, and tile t's softmax runs while P_{t-1} V_{t-1} does.
//    O is rescaled by tile t's alpha once that product has completed, and
//    P_t (bf16, packed as wgmma's A operand) waits in registers for the
//    next step: one f32 S fragment a thread, not two.
//  - No work on padding: the products cover kCols columns (160 for D 136 ..
//    160, 192, 256), not the padded storage width DP (192, 256): at D 160
//    QK^T takes 10 k-steps, not 12, and P V's pieces are n128 + n32.  The
//    columns D .. kCols - 1 are zero in shared memory, so the products add
//    exact zeros.
//  - Longest walk first: a causal grid launches its last row blocks (the
//    most key tiles) first.
//  - The walk starts at the key tile that holds max(0, first position -
//    window + 1), where no key before it is kept; a CTA holding a fully
//    masked row (position >= Sk + window - 1, when Sq > Sk) walks from tile
//    0, so that row averages every key as the TPU kernel's does.  The
//    tiles skipped add nothing: at the first walked tile alpha = exp(MASK -
//    m) = 0 multiplies l and acc by zero.  (flash::forward_walk in
//    csrc/flash_tiles.cuh, shared with csrc/flash_attention.cu; forward_walk
//    in kernels/flash_attention/flash_attention.py states it for the tests.)
//
// The copies need D % 8 == 0 and 16-byte aligned tensors: the wrapper pads D
// to a multiple of 8 with zero columns, and copies an unaligned tensor to an
// aligned one, before the launch.  The entry point returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_tiles.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::kTileRows;
using flash::kWarpgroup;

constexpr int kMaxSmemBytes = 232448;  // dynamic shared memory a block may use on sm_90
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr int kConsumers = 2;  // warpgroups of 64 rows
constexpr int kConsumerThreads = kConsumers * kWarpgroup;
constexpr int kCtaRows = kConsumers * kTileRows;
constexpr int kWarps = kConsumerThreads / 32;  // arrivals that empty a stage

// kProducer: a third warpgroup copies K and V into the rings (else the
// consumers copy them themselves).
template <bool kProducer>
__host__ __device__ constexpr int threads() {
  return kConsumerThreads + (kProducer ? kWarpgroup : 0);
}

// Stages of the K ring and of the V ring: K is loaded kStagesK - 1 tiles
// ahead, V (read one step later, by P V) kStagesV - 1.
template <int DP>
__host__ __device__ constexpr int k_stages() {
  return 3;
}
template <int DP>
__host__ __device__ constexpr int v_stages() {
  return DP == 192 ? 3 : 2;
}
// Two Q tiles, the K and V rings, their barriers, alignment.
template <int DP>
__host__ __device__ constexpr int smem_bytes() {
  return (kConsumers + k_stages<DP>() + v_stages<DP>()) * DP * 128 +
         (1 + 2 * (k_stages<DP>() + v_stages<DP>())) * 8 + 1024;
}
static_assert(smem_bytes<192>() <= kMaxSmemBytes && smem_bytes<256>() <= kMaxSmemBytes,
              "wide K4 tiles exceed shared memory");

// Copies of the 64 rows of a tile by kCopiers threads: row r from row(r)
// (null: zeros), its first d columns (d % 8 == 0, d <= kCols), as 16-byte
// cp.async chunks into the swizzled layout (flash::tile_offset); thread tid
// takes every kCopiers-th (row, chunk) pair.
template <int kCols, int kCopiers, typename Row>
__device__ __forceinline__ void copy_tile(uint32_t tile, const bf16* any, int d, int tid,
                                          Row row) {
  constexpr int kSlots = kCols / 8;
  for (int e = tid; e < kTileRows * kSlots; e += kCopiers) {
    const int r = e / kSlots, ch = e % kSlots;
    if (8 * ch >= d) continue;
    const bf16* src = row(r);
    sm90::cp_async16(tile + flash::tile_offset(r, ch), src ? src + 8 * ch : any,
                     src != nullptr);
  }
}

// What every thread of a CTA knows: the call's arguments, the CTA's place
// and its walk, and the shared-memory layout.
struct Cta {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* stats;
  int batch, seq_q, seq_k, heads, kv_heads, head_dim, causal, window;
  float scale;
  int G, total_rows, b, kvh, rho0;  // rho0: the CTA's first row
  int t_lo, n;                      // the walk: key tiles t_lo .. t_lo + n - 1
  // warpgroup w's Q tile at base + w T; K stage s at k_ring + s T, V stage s
  // at v_ring + s T; barriers: q_full, then stage s's at full_k + 8 s, ...
  uint32_t base, k_ring, v_ring, q_full, full_k, full_v, empty_k, empty_v;
};

// The tile j of x (K or V) of the walk into its stage, once the tile it
// held has been released; kCopiers threads copy, each arriving on the
// stage's "full" barrier when its copies land.
template <int DP, int kCols, int kCopiers>
__device__ __forceinline__ void load_ring_tile(const Cta& c, const bf16* x, uint32_t ring,
                                               uint32_t full, uint32_t empty, int stages, int j,
                                               int tid) {
  if (j >= c.n) return;
  const int st = j % stages;
  sm90::mbar_wait_or_trap(empty + 8 * st, ((j / stages) & 1) ^ 1);  // a fresh stage passes
  const int k0 = (c.t_lo + j) * kTileRows;
  const int64_t row_stride = static_cast<int64_t>(c.kv_heads) * c.head_dim;
  copy_tile<kCols, kCopiers>(ring + st * DP * 128, x, c.head_dim, tid,
                             [&](int r) -> const bf16* {
    if (k0 + r >= c.seq_k) return nullptr;
    return x + (static_cast<int64_t>(c.b) * c.seq_k + k0 + r) * row_stride + c.kvh * c.head_dim;
  });
  sm90::cp_async_arrive(full + 8 * st);
}

// The producer warpgroup: K and V of every walked tile, in order.
template <int DP, int kCols>
__device__ __forceinline__ void produce(const Cta& c, int tid) {
  constexpr int kStagesK = k_stages<DP>(), kStagesV = v_stages<DP>();
  for (int j = 0; j < c.n; ++j) {
    load_ring_tile<DP, kCols, kWarpgroup>(c, c.k, c.k_ring, c.full_k, c.empty_k, kStagesK, j,
                                          tid);
    load_ring_tile<DP, kCols, kWarpgroup>(c, c.v, c.v_ring, c.full_v, c.empty_v, kStagesV, j,
                                          tid);
  }
  sm90::cp_async_commit();  // leave no copy of this thread in flight at exit
  sm90::cp_async_wait<0>();
}

// A consumer warpgroup: 64 rows (the CTA's rows 64 wg .. 64 wg + 63), and,
// without a producer, its share of every copy into the rings.
template <int DP, int kCols, bool kProducer>
__device__ __forceinline__ void attend(const Cta& c, int wg, int tid) {
  constexpr int T = DP * 128, kStagesK = k_stages<DP>(), kStagesV = v_stages<DP>();
  const uint32_t q_tile = c.base + wg * T;
  const int rho0 = c.rho0 + kTileRows * wg;
  const int first_pos = rho0 / c.G;
  const int last_pos = (min(rho0 + kTileRows, c.total_rows) - 1) / c.G;
  // this thread's two rows (h = 0, 1) and its first column in each 8-column block
  const int ra = tid / 32 * 16 + tid % 32 / 4;
  const int pos[2] = {(rho0 + ra) / c.G, (rho0 + ra + 8) / c.G};
  const int col = 2 * (tid % 4);
  const bool lane0 = tid % 32 == 0;

  float m_run[2] = {kMaskValue, kMaskValue};
  float l_run[2] = {0.0f, 0.0f};  // this lane's share of the row sums
  float acc[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.0f;
  float s[32];
  uint32_t p[4][4];  // P of the previous tile as the A operand of P V

  // the walk's j-th K (or V) tile, once both warpgroups have released the
  // tile its stage held (a producer loads them otherwise)
  const int D = c.head_dim;
  auto load_k = [&](int j) {
    if constexpr (!kProducer)
      load_ring_tile<DP, kCols, kConsumerThreads>(c, c.k, c.k_ring, c.full_k, c.empty_k,
                                                  kStagesK, j, threadIdx.x);
  };
  auto load_v = [&](int j) {
    if constexpr (!kProducer)
      load_ring_tile<DP, kCols, kConsumerThreads>(c, c.v, c.v_ring, c.full_v, c.empty_v,
                                                  kStagesV, j, threadIdx.x);
  };
  auto ready = [&](uint32_t bar, int stages, int j) {
    sm90::mbar_wait_or_trap(bar + 8 * (j % stages), (j / stages) & 1);
    sm90::fence_proxy_async();  // the copies' writes, before wgmma reads them
  };
  auto release = [&](uint32_t bar, int stages, int j) {
    if (lane0) sm90::mbar_arrive(bar + 8 * (j % stages));
  };
  auto issue_qk = [&](int j) {
    flash::ss_issue<kCols, true>(s, q_tile, c.k_ring + j % kStagesK * T);
    sm90::wgmma_commit();
  };
  auto issue_pv = [&](int j) {
    const uint32_t vt = c.v_ring + j % kStagesV * T;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      flash::rs_issue_cols<0, kCols, 0>(acc, p[ks], vt + ks * 2 * flash::kAtomBytes);
    sm90::wgmma_commit();
  };
  // tile j's softmax on s (the one-warpgroup kernel's arithmetic, every
  // operation rounded on its own, as that kernel's compiled: no product
  // fused into a sum): scale, mask, the running max, alpha; P = exp(S - m)
  // in s; l
  auto softmax = [&](int j, float (&alpha)[2]) {
    const int k0 = (c.t_lo + j) * kTileRows;
    const bool masked = k0 + kTileRows > c.seq_k ||
                        (c.causal && k0 + kTileRows - 1 > first_pos) ||
                        (c.window && k0 <= last_pos - c.window);
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = i % 4 / 2;
      float x = __fmul_rn(s[i], c.scale);
      if (masked) {
        const int key = k0 + i / 4 * 8 + col + i % 2;
        bool keep = key < c.seq_k;
        if (c.causal) keep = keep && key <= pos[h];
        if (c.window) keep = keep && key > pos[h] - c.window;
        if (!keep) x = kMaskValue;
      }
      s[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = expf(__fsub_rn(m_run[h], m_new));
      m_run[h] = m_new;
      l_run[h] = __fmul_rn(l_run[h], alpha[h]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = i % 4 / 2;
      // keys past Sk are not there at all: they add nothing to l
      const bool absent = masked && k0 + i / 4 * 8 + col + i % 2 >= c.seq_k;
      const float e = absent ? 0.0f : expf(__fsub_rn(s[i], m_run[h]));
      s[i] = e;
      l_run[h] = __fadd_rn(l_run[h], e);
    }
  };

  // the CTA's Q rows, then the first tiles of the rings
  for (int w = 0; w < kConsumers; ++w) {
    copy_tile<kCols, kConsumerThreads>(c.base + w * T, c.q, D, threadIdx.x,
                                       [&](int r) -> const bf16* {
      const int rho = c.rho0 + kTileRows * w + r;
      if (rho >= c.total_rows) return nullptr;
      const int i = rho / c.G, g = rho - i * c.G;
      return c.q + ((static_cast<int64_t>(c.b) * c.seq_q + i) * c.heads + c.kvh * c.G + g) * D;
    });
  }
  sm90::cp_async_arrive(c.q_full);
  for (int j = 0; j + 1 < kStagesK; ++j) load_k(j);
  for (int j = 0; j + 1 < kStagesV; ++j) load_v(j);
  sm90::mbar_wait_or_trap(c.q_full, 0);
  sm90::fence_proxy_async();
  float alpha[2];
  // tile 0: S, its softmax (acc is still 0), P
  load_k(kStagesK - 1);
  ready(c.full_k, kStagesK, 0);
  sm90::wgmma_fence();
  issue_qk(0);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  release(c.empty_k, kStagesK, 0);
  softmax(0, alpha);
  flash::pack_operand(s, p);
  for (int j = 1; j < c.n; ++j) {
    // the loads kStagesK - 1 and kStagesV - 1 tiles ahead, each into the
    // stage released one step before; then S of tile j, and P V of tile
    // j - 1 behind it on the tensor cores
    load_k(j + kStagesK - 1);
    load_v(j + kStagesV - 2);
    ready(c.full_k, kStagesK, j);
    ready(c.full_v, kStagesV, j - 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) sm90::fence_regs(p[ks]);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    issue_qk(j);
    issue_pv(j - 1);
    sm90::wgmma_wait<1>();  // S has landed; P V runs on under the softmax
    sm90::fence_regs(s);
    release(c.empty_k, kStagesK, j);
    softmax(j, alpha);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) sm90::fence_regs(p[ks]);  // P V has read them
    release(c.empty_v, kStagesV, j - 1);
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) acc[i] = __fmul_rn(acc[i], alpha[i % 4 / 2]);
    flash::pack_operand(s, p);
  }
  ready(c.full_v, kStagesV, c.n - 1);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) sm90::fence_regs(p[ks]);
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
  issue_pv(c.n - 1);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int rho = rho0 + ra + 8 * h;
    if (rho >= c.total_rows) continue;
    const float denom = fmaxf(l, 1e-30f);
    const int i = rho / c.G, g = rho % c.G;
    if (c.stats != nullptr && tid % 4 == 0) {  // m and l, (2, B, H, Sq), for the backward
      const int64_t idx = (static_cast<int64_t>(c.b) * c.heads + c.kvh * c.G + g) * c.seq_q + i;
      c.stats[idx] = m_run[h];
      c.stats[static_cast<int64_t>(c.batch) * c.heads * c.seq_q + idx] = l;
    }
    bf16* dst =
        c.o + ((static_cast<int64_t>(c.b) * c.seq_q + i) * c.heads + c.kvh * c.G + g) * c.head_dim;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const float lo = acc[4 * j + 2 * h] / denom, hi = acc[4 * j + 2 * h + 1] / denom;
      if (8 * j < c.head_dim)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + col) = __floats2bfloat162_rn(lo, hi);
    }
  }
}

// DP: the storage width of a tile (192 or 256: 64-column swizzled regions);
// kCols <= DP: the columns the products cover (160, 192 or 256), D <= kCols.
template <int DP, int kCols, bool kProducer>
__global__ void __launch_bounds__(threads<kProducer>(), 1)
flash_fwd_bf16_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int batch, int seq_q,
                    int seq_k, int heads, int kv_heads, int head_dim, int causal, int window,
                    float scale, float* __restrict__ stats) {
  constexpr int T = DP * 128;
  constexpr int kStagesK = k_stages<DP>(), kStagesV = v_stages<DP>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  Cta c{q, k, v, o, stats, batch, seq_q, seq_k, heads, kv_heads, head_dim, causal, window, scale};
  c.base = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-aligned
  c.k_ring = c.base + kConsumers * T;
  c.v_ring = c.k_ring + kStagesK * T;
  c.q_full = c.v_ring + kStagesV * T;
  c.full_k = c.q_full + 8;
  c.full_v = c.full_k + 8 * kStagesK;
  c.empty_k = c.full_v + 8 * kStagesV;
  c.empty_v = c.empty_k + 8 * kStagesK;

  c.G = heads / kv_heads;
  c.total_rows = seq_q * c.G;
  const int nbh = batch * kv_heads;
  const int bh = blockIdx.x % nbh;
  c.b = bh / kv_heads;
  c.kvh = bh % kv_heads;
  const int n_blocks = (c.total_rows + kCtaRows - 1) / kCtaRows;
  const int o_th = blockIdx.x / nbh;  // longest walk first: a causal grid from its last block
  c.rho0 = (causal ? n_blocks - 1 - o_th : o_th) * kCtaRows;

  const int last_pos = (min(c.rho0 + kCtaRows, c.total_rows) - 1) / c.G;
  const flash::ForwardWalk walk =
      flash::forward_walk(c.rho0 / c.G, last_pos, seq_k, causal, window);
  c.t_lo = walk.t_lo;
  c.n = walk.t_end - c.t_lo;

  if (threadIdx.x == 0) {
    constexpr int kCopiers = kProducer ? kWarpgroup : kConsumerThreads;
    sm90::mbar_init(c.q_full, kConsumerThreads);
    for (int s = 0; s < kStagesK; ++s) {
      sm90::mbar_init(c.full_k + 8 * s, kCopiers);
      sm90::mbar_init(c.empty_k + 8 * s, kWarps);
    }
    for (int s = 0; s < kStagesV; ++s) {
      sm90::mbar_init(c.full_v + 8 * s, kCopiers);
      sm90::mbar_init(c.empty_v + 8 * s, kWarps);
    }
    sm90::fence_mbar_init();
  }
  if (head_dim < kCols)
    flash::zero_padding<DP, threads<kProducer>()>(smem_raw + (c.base - raw),
                                                  kConsumers + kStagesK + kStagesV, head_dim);
  __syncthreads();
  const int wg = threadIdx.x / kWarpgroup;
  if constexpr (kProducer) {
    if (wg == kConsumers) {
      produce<DP, kCols>(c, threadIdx.x % kWarpgroup);
      return;
    }
  }
  attend<DP, kCols, kProducer>(c, wg, threadIdx.x % kWarpgroup);
}

template <int DP, int kCols, bool kProducer>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int seq_q,
                   int seq_k, int heads, int kv_heads, int head_dim, int causal, int window,
                   float scale, float* stats, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_wide<DP, kCols, kProducer>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(seq_q) * (heads / kv_heads);
  const int64_t ctas = static_cast<int64_t>(batch) * kv_heads * ((rows + kCtaRows - 1) / kCtaRows);
  if (ctas > INT32_MAX || rows > INT32_MAX) return cudaErrorInvalidValue;
  flash_fwd_bf16_wide<DP, kCols, kProducer>
      <<<static_cast<unsigned>(ctas), threads<kProducer>(), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), batch, seq_q, seq_k, heads, kv_heads, head_dim, causal, window,
      scale, stats);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

const char* flash_attention_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o (B, Sq, H, D) and k, v (B, Sk, KVH, D) in bfloat16, contiguous, on
// the card, 128 < D <= 256, D % 8 == 0, 16-byte aligned.  stats, null or
// (2, B, H, Sq) f32, receives each row's final max m and denominator l for
// the backward (csrc/flash_attention_bwd.cu); null leaves the forward as it
// is.
int flash_attention_wide_launch(const void* q, const void* k, const void* v, void* o, int batch,
                                int seq_q, int seq_k, int heads, int kv_heads, int head_dim,
                                int causal, int window, float scale, float* stats,
                                void* stream) {
  if (batch <= 0 || seq_q <= 0 || seq_k <= 0 || kv_heads <= 0 || heads % kv_heads ||
      head_dim <= 128 || head_dim > 256 || head_dim % 8 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K4_WIDE(DP, COLS, PRODUCER)                                                          \
  launch<DP, COLS, PRODUCER>(q, k, v, o, batch, seq_q, seq_k, heads, kv_heads, head_dim,      \
                             causal, window, scale, stats, s)
  if (head_dim <= 160) return static_cast<int>(K4_WIDE(192, 160, true));
  if (head_dim <= 192) return static_cast<int>(K4_WIDE(192, 192, false));
  return static_cast<int>(K4_WIDE(256, 256, false));
#undef K4_WIDE
}

}  // extern "C"
