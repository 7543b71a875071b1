// Flash attention backward (K4's gradient) for Hopper (sm_90a), bound to Python with ctypes.
//
// flash_attention_backward_launch is the gradient of flash_attention_launch
//    (csrc/flash_attention.cu), which replaces src/repro/kernels/
//    flash_attention/flash_attention.py flash_attention_pallas.  The TPU
//    kernel has no backward: the JAX package trains through XLA's autodiff
//    of plain jnp attention, and this is the port's kernel for the same
//    gradient.  Inputs q, dO (B, Sq, H, D), k, v (B, Sk, KVH, D) and the
//    forward's row statistics (m, l) (2, B, H, Sq) in f32; outputs dq, dk, dv
//    in the inputs' dtype.  With S = scale q k^T masked to -0.7 * FLT_MAX
//    (the forward's masks and arithmetic) and P = exp(S - m) / L, L the row
//    sum of exp(S - m) recomputed here (the forward's l where the row sees
//    no key, m = MASK):
//        dV = P^T dO,  dP = dO V^T,  Delta = rowsum(P * dP) over the kept keys,
//        dS = P * (dP - Delta) (0 where masked),  dQ = scale dS K,  dK = scale dS^T Q.
//    The statistics are m and l, not one logsumexp: a fully masked row has
//    m = MASK, where m + log(l) rounds back to m in f32 and exp(S - lse)
//    would give 1 in place of the forward's 1 / l.  Such a row gives its
//    uniform P to dV and nothing to dQ or dK, as autograd of masked_fill
//    does.  Delta is formed from the same f32 P and dP that dS takes, not as
//    rowsum(dO * O) from the output rounded to bf16: a row that sees one key
//    (P = 1) then has dS = 0 exactly, as autograd gives, where O's rounding
//    would leave dQ a remainder past the bf16 row tolerance.  No atomics:
//    two calls give the same bits.
//
// bf16 runs on wgmma (csrc/flash_tiles.cuh) in two launches (three where
// the dK/dV walk is split, below).  At padded widths DP 64 and 128 (every
// D <= 128; tinyllama, qwen3-moe and every phase-9 rank) one warpgroup a
// CTA:
//  1. flash_bwd_rows_wgmma, a CTA per (batch, kv head, 64 rows; rows
//     numbered i * G + g as in the forward): three walks over the key tiles
//     its rows see, the tiles by cp.async into a ring of two or three
//     stages on mbarriers (the next tiles load while one is multiplied):
//     S = Q K^T (SS form) and L, two key tiles a step; then S, dP = dO V^T
//     and Delta; then S, dP, dS and dQ += dS K, dS from registers (RS form,
//     K MN-major).  It writes dq and each row's m log2(e), 1 / L and Delta
//     (aux, 3 planes of (B, H, Sq)).
//  2. flash_bwd_dkdv_wgmma, a CTA per (batch, kv head, 64 keys), K and V
//     held in shared memory: walks the 64-row tiles that its masks let see
//     the keys (causal: from its first key on; windowed: up to its last
//     key + window - 1) and the tiles of fully masked rows past
//     Sk + window - 1, Q and dO tiles (and the rows' statistics) by cp.async
//     into a ring of four stages; S^T = K Q^T and dP^T = V dO^T
//     (SS form), whose
//     accumulators already have the layout of wgmma's A operand, so P^T and
//     dS^T stay in registers for dV += P^T dO and dK += dS^T Q (RS form, Q
//     and dO MN-major).  The G heads of the kv head are summed inside it.
// At DP 192 and 256 (stablelm's D 160, recurrentgemma's 256; every D from
// 129) one warpgroup holding dQ's 64 x DP f32 accumulators spills, and it
// cannot hold dK's and dV's 2 x 64 x DP (255 registers a thread), so each
// CTA runs two consumer warpgroups (256 threads, one CTA a SM: its tiles
// take ~195 KB):
//  1. The rows kernel.  DP 192: flash_bwd_rows_wgmma with two warpgroups,
//     each the kernel above for 64 rows of its own, the CTA's 128 rows
//     sharing one ring of key tiles (half the tile traffic a row).  DP 256,
//     where the 128 rows' Q and dO would leave no room for a ring:
//     flash_bwd_rows_wide, 64 rows a CTA, warpgroup w taking keys
//     [32 w, 32 w + 32) of every key tile (S and dP as m64n32 products, dS K
//     as an RS product of two k steps over the whole DP): no product twice;
//     the warpgroups' row sums meet in shared memory, and warpgroup 1's dQ
//     is added to warpgroup 0's there, in that order.
//  2. flash_bwd_dkdv_wide: flash_bwd_dkdv_wgmma's walk, warpgroup w owning
//     dK's and dV's columns [w DP / 2, (w + 1) DP / 2) (n128, n64 and n32
//     products); both form the whole S^T and dP^T, so that P^T and dS^T stay
//     in registers for their halves of dV and dK (RS form).  Where its
//     CTAs (batch x kv heads x 64-key tiles) are short of a wave of the
//     card's SMs (recurrentgemma's one kv head at B 1: 64), the wrapper
//     cuts each key tile's row walk into the least number of contiguous
//     ranges that fills one (at most the kv head's row tiles); each CTA
//     sums its range into f32 scratch, part (splits, 2, B, Sk, KVH, DP),
//     and
//  3. flash_bwd_split_sum adds the ranges in order and writes dk and dv.
// All grids are launched longest walk first: causal dK/dV CTAs from the
// first key tile on, causal row CTAs from the last row tile back, and a
// window without causality the other way round.  exp is the MUFU's 2^x of
// scores scaled by scale * log2(e).  Up to DP 128 P and dS enter their
// products as two bf16 operands each (the value and its rounding's
// remainder): D 1 under cancellation needs them, and D 1 .. 64 share the
// DP 64 kernel.  Past it (D >= 129) they enter as bf16 alone, which every
// case holds within the bf16 tolerance (a row's terms cancel less there),
// and the products the remainders took are saved.  P is e / L with L the
// row's own sum, so a row that sees one key has e == L and P = 1 exactly
// (the rows kernels test e == L, and a key the masks drop adds e = 0
// exactly to either warpgroup's share of L; elsewhere they multiply by
// 1 / L, within one rounding of the quotient).
//
// Head dims: any D from 1 to 256, at padded widths DP of 64, 128, 192 and
// 256 whose extra columns are zero in shared memory.  bf16 needs D % 8 == 0
// and 16-byte aligned tensors (the wrapper pads).  float32 runs
// csrc/flash_attention_f32_bwd.cu.
//
// Bound: operations, at the bf16 tensor-core rate (989 TFLOP/s); the least
// work is 2.5x the
// forward's kernel_flops, against reads of q, k, v, dO and writes of dq,
// dk, dv.  The wgmma kernels form S three times and dP twice a (row tile,
// key tile) pair, and with the remainders run 13 tile products where the
// forward runs 2; past DP 128, without the remainders and with both of the
// dK/dV kernel's warpgroups forming S^T and dP^T, 12 (backward_flops in
// kernels/flash_attention/ops.py).
//
// The entry point returns cudaGetLastError() so the wrapper can raise on a
// refused launch.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "flash_tiles.cuh"
#include "sm90.cuh"

namespace {

constexpr int kMaxHeadDim = 256;
constexpr int kMaxSmemBytes = 232448;  // dynamic shared memory a block may use on sm_90
constexpr int kRows = 64;              // query rows (position, group) of a row tile
constexpr float kMaskValue = -0.7f * FLT_MAX;

using bf16 = __nv_bfloat16;

// What a CTA knows of its problem.
struct Problem {
  int batch, seq_q, seq_k, heads, kv_heads, head_dim, groups, total_rows, causal, window;
  float scale;
};

// The statistics' index (b, kvh * G + g, i) in (B, H, Sq) of row rho.
__device__ __forceinline__ int64_t stat_index(const Problem& pb, int b, int kvh, int rho) {
  const int i = rho / pb.groups, g = rho % pb.groups;
  return (static_cast<int64_t>(b) * pb.heads + kvh * pb.groups + g) * pb.seq_q + i;
}

// The 64-row tiles a dK/dV CTA walks for its kt keys from k0: those whose
// masks let a row see one of the keys (causal: from the first key on;
// windowed: up to the last key + window - 1), then those holding fully
// masked rows (a window past every key), which give dV their uniform P.
struct RowWalk {
  int t_lo, t_hi, f_lo, n;
  __device__ RowWalk(const Problem& pb, int k0, int kt) {
    const int G = pb.groups;
    const int k_last = min(k0 + kt, pb.seq_k) - 1;
    const int lo = pb.causal ? k0 : 0;
    const int hi = pb.window ? min(pb.seq_q, k_last + pb.window) : pb.seq_q;
    t_lo = lo * G / kRows;
    t_hi = hi > lo ? (hi * G + kRows - 1) / kRows : t_lo;
    const int fm = pb.window ? pb.seq_k + pb.window - 1 : pb.seq_q;  // first fully masked position
    f_lo = max(t_hi, fm * G / kRows);
    const int f_hi = fm < pb.seq_q ? max(f_lo, (pb.seq_q * G + kRows - 1) / kRows) : f_lo;
    n = (t_hi - t_lo) + (f_hi - f_lo);
  }
  __device__ int tile(int it) const {
    return it < t_hi - t_lo ? t_lo + it : f_lo + (it - (t_hi - t_lo));
  }
};

__device__ __forceinline__ int64_t plane(const Problem& pb) {
  return static_cast<int64_t>(pb.batch) * pb.heads * pb.seq_q;
}

// ---------------------------------------------------------------------------
// bf16 at DP 64 and 128: wgmma, one warpgroup a CTA (csrc/flash_tiles.cuh).

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmPerSmBytes = 233472;  // shared memory of one SM, 1 KB of it reserved a CTA

// Stages of the ring of streamed tiles: loads run kStages - 1 steps ahead.
// The rows kernels keep three CTAs a SM at DP 64 and two at DP 128, and one
// at DP 256 (two stages; DP 192: rows_stages); the dK/dV kernels, whose
// registers allow two CTAs a SM at DP 64 and one past it, take four up to
// DP 128, then three at DP 192 and two at 256 (flash_bwd_dkdv_wide's two
// held tiles fill the rest).
template <int DP, bool kDkdv>
__host__ __device__ constexpr int ring_stages() {
  if (DP > 128) return DP == 192 ? 3 : 2;
  return kDkdv ? 4 : (DP == 64 ? 3 : 2);
}

// Two held tiles, kStages stages of two streamed tiles and of the streamed
// rows' statistics (3 x 64 f32), a barrier a stage, alignment.
template <int DP, bool kDkdv>
__host__ __device__ constexpr int wg_smem_bytes() {
  return (2 + 2 * ring_stages<DP, kDkdv>()) * DP * 128 +
         ring_stages<DP, kDkdv>() * (3 * kRows * 4 + 8) + 1024;
}
static_assert(3 * (wg_smem_bytes<64, false>() + 1024) <= kSmPerSmBytes, "3 rows CTAs a SM, DP 64");
static_assert(2 * (wg_smem_bytes<128, false>() + 1024) <= kSmPerSmBytes, "2 rows CTAs a SM, DP 128");
static_assert(2 * (wg_smem_bytes<64, true>() + 1024) <= kSmPerSmBytes, "2 dK/dV CTAs a SM, DP 64");
static_assert(wg_smem_bytes<128, true>() <= kMaxSmemBytes, "dK/dV ring at DP 128");
static_assert(wg_smem_bytes<256, false>() <= kMaxSmemBytes, "rows ring at DP 256");
static_assert(wg_smem_bytes<192, true>() <= kMaxSmemBytes, "dK/dV ring at DP 192");
static_assert(wg_smem_bytes<256, true>() <= kMaxSmemBytes, "dK/dV ring at DP 256");

// The CTAs a SM the registers must allow: at DP 64 three rows CTAs (168
// registers a thread) and two dK/dV CTAs (up to 255: capped at 168 it
// spills, and ran slower on an H100).
template <int DP, bool kDkdv>
__host__ __device__ constexpr int min_ctas() {
  return DP == 64 ? (kDkdv ? 2 : 3) : 1;
}

// 2^x on the MUFU unit (subnormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The tile index of the CTA launched o-th of n: longest walks first.
__device__ __forceinline__ int longest_first(int o, int n, bool reverse) {
  return reverse ? n - 1 - o : o;
}

// v as an RS product's A operand: the bf16 value and its rounding's
// remainder, so that the products of P and dS stay near f32 where a row's
// terms cancel.
__device__ __forceinline__ void split_operand(const float (&v)[32], uint32_t (&hi)[4][4],
                                              uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = v[8 * ks + 2 * i], c = v[8 * ks + 2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, c);
      hi[ks][i] = *reinterpret_cast<const uint32_t*>(&h);
      lo[ks][i] = flash::pack_bf16(a - __low2float(h), c - __high2float(h));
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
}

template <int KS>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) sm90::fence_regs(a[ks]);
}

// Sum over the 4 lanes that hold one accumulator row; every lane gets the
// same bits.
__device__ __forceinline__ float row_total(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The key tiles the rows of a 64-row tile see (dS is 0 elsewhere).
struct KeyWalk {
  int t_lo, n;
  __device__ KeyWalk(const Problem& pb, int first_pos, int last_pos) {
    const int k_lo = pb.window ? max(0, first_pos - pb.window + 1) : 0;
    const int k_hi = pb.causal ? min(pb.seq_k, last_pos + 1) : pb.seq_k;
    t_lo = k_lo / kRows;
    n = k_hi > k_lo ? (k_hi + kRows - 1) / kRows - t_lo : 0;
  }
};

// Whether a (64 rows from rho0, 64 keys from k0) tile pair holds a pair the
// masks drop, a row past the end or a key past Sk.
__device__ __forceinline__ bool tile_masked(const Problem& pb, int rho0, int k0) {
  const int first_pos = rho0 / pb.groups;
  const int last_pos = (min(rho0 + kRows, pb.total_rows) - 1) / pb.groups;
  return k0 + kRows > pb.seq_k || rho0 + kRows > pb.total_rows ||
         (pb.causal && k0 + kRows - 1 > first_pos) || (pb.window && k0 <= last_pos - pb.window);
}

// The swizzled tile of 64 keys from k0 of x (B, Sk, KVH, D) by cp.async,
// zero past Sk.
template <int DP, int kThreads = flash::kWarpgroup>
__device__ __forceinline__ void load_keys(uint32_t tile, const bf16* x, const Problem& pb, int b,
                                          int kvh, int k0, int d) {
  flash::load_tile<DP, kThreads>(tile, x, d, [&](int r) -> const bf16* {
    if (k0 + r >= pb.seq_k) return nullptr;
    return x + ((static_cast<int64_t>(b) * pb.seq_k + k0 + r) * pb.kv_heads + kvh) * d;
  });
}

// The swizzled tiles of rows rho0 .. rho0 + 63 of q and of dO by cp.async
// (zero past the last row): one division a row.  kThreads threads copy
// (threadIdx.x % kThreads of them).
template <int DP, int kThreads = flash::kWarpgroup>
__device__ __forceinline__ void load_row_tiles(uint32_t q_tile, uint32_t do_tile, const bf16* q,
                                               const bf16* dout, const Problem& pb, int b,
                                               int kvh, int rho0, int d) {
  constexpr int kSlots = DP / 8;
  const int tid = threadIdx.x % kThreads;
  const int c = tid % kSlots;
  if (8 * c >= d) return;  // padding, zeroed once
  for (int r = tid / kSlots; r < kRows; r += kThreads / kSlots) {
    const int rho = rho0 + r;
    const bool ok = rho < pb.total_rows;
    int64_t off = 0;
    if (ok) {
      const int i = rho / pb.groups, g = rho - i * pb.groups;
      off = ((static_cast<int64_t>(b) * pb.seq_q + i) * pb.heads + kvh * pb.groups + g) * d +
            8 * c;
    }
    const uint32_t at = flash::tile_offset(r, c);
    sm90::cp_async16(q_tile + at, q + off, ok);
    sm90::cp_async16(do_tile + at, dout + off, ok);
  }
}

// kWGs warpgroups a CTA, each with 64 rows of its own (the CTA's rows
// 64 w .. 64 w + 63), sharing the ring of key tiles (kStages stages); one
// warpgroup up to DP 128, two at DP 192.
template <int DP, int kWGs>
__host__ __device__ constexpr int rows_stages() {
  return kWGs == 1 ? ring_stages<DP, false>() : 2;
}
template <int DP, int kWGs>
__host__ __device__ constexpr int rows_smem_bytes() {
  return (2 * kWGs + 2 * rows_stages<DP, kWGs>()) * DP * 128 +
         rows_stages<DP, kWGs>() * (3 * kRows * 4 + 8) + 1024;
}
static_assert(rows_smem_bytes<192, 2>() <= kMaxSmemBytes, "paired rows at DP 192");

// kFull: D == DP, a compile-time head dim.
// kRemainder: dS enters dQ += dS K as value + remainder (up to DP 128;
// past it as bf16 alone, within the bf16 tolerance at every D it takes).
template <int DP, bool kFull, int kWGs = 1, bool kRemainder = true>
__global__ void __launch_bounds__(flash::kWarpgroup * kWGs, kWGs == 1 ? min_ctas<DP, false>() : 1)
flash_bwd_rows_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ stats, float* __restrict__ aux,
                     bf16* __restrict__ dq, Problem pb) {
  constexpr int T = DP * 128;  // bytes of a tile
  constexpr int kStages = rows_stages<DP, kWGs>();
  constexpr int kThreads = flash::kWarpgroup * kWGs, kCtaRows = kRows * kWGs;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-aligned
  unsigned char* const tiles = smem_raw + (base - raw);
  const int tid = threadIdx.x % flash::kWarpgroup, wg = threadIdx.x / flash::kWarpgroup;
  // warpgroup w's Q and dO at 2w T, (2w + 1) T; stage s: K at (2 kWGs + 2s) T, V after it
  const uint32_t q_tile = base + 2 * wg * T, do_tile = q_tile + T;
  const uint32_t ring = base + 2 * kWGs * T;
  const uint32_t full = ring + 2 * kStages * T;  // stage s's barrier at full + 8 s

  const int nbh = pb.batch * pb.kv_heads;
  const int bh = blockIdx.x % nbh, b = bh / pb.kv_heads, kvh = bh % pb.kv_heads;
  const int n_row_tiles = (pb.total_rows + kCtaRows - 1) / kCtaRows;
  const int cta_rho0 = longest_first(blockIdx.x / nbh, n_row_tiles, pb.causal) * kCtaRows;
  const int rho0 = cta_rho0 + kRows * wg;  // this warpgroup's rows
  const int D = kFull ? DP : pb.head_dim, G = pb.groups;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(full + 8 * s, kThreads);
    sm90::fence_mbar_init();
  }
  if constexpr (!kFull) flash::zero_padding<DP, kThreads>(tiles, 2 * kWGs + 2 * kStages, D);
  __syncthreads();

  // the key tiles any row of the CTA sees
  const int first_pos = cta_rho0 / G;
  const int last_pos = (min(cta_rho0 + kCtaRows, pb.total_rows) - 1) / G;
  const KeyWalk walk(pb, first_pos, last_pos);
  // the walk for L takes two key tiles a step (S of the second in dP's
  // registers); then the walks for Delta and for dQ, a tile a step
  const int n0 = (walk.n + 1) / 2;
  const int n_steps = walk.n ? n0 + 2 * walk.n : 0;

  load_row_tiles<DP>(q_tile, do_tile, q, dout, pb, b, kvh, rho0, D);  // each warpgroup its own
  // step's tiles into its stage: K, and the next K (the walk for L) or V;
  // the first stage's phase also covers Q and dO
  auto load_step = [&](int step) {
    const bool first_walk = step < n0;
    const int t = first_walk ? 2 * step : (step - n0) % walk.n;
    const int st = step % kStages, k0 = (walk.t_lo + t) * kRows;
    const uint32_t kt = ring + 2 * st * T;
    load_keys<DP, kThreads>(kt, k, pb, b, kvh, k0, D);
    if (!first_walk) {
      load_keys<DP, kThreads>(kt + T, v, pb, b, kvh, k0, D);
    } else if (t + 1 < walk.n) {
      load_keys<DP, kThreads>(kt + T, k, pb, b, kvh, k0 + kRows, D);
    }
    sm90::cp_async_arrive(full + 8 * st);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < n_steps) load_step(s);
  if (n_steps == 0) {  // rows that see no key: nothing is multiplied
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
  }

  // this thread's two rows (h = 0, 1) and its first key in each 8-key block
  const int ra = tid / 32 * 16 + tid % 32 / 4;
  const int col = 2 * (tid % 4);
  bool row_ok[2], masked_row[2];
  int pos[2];
  float m2[2], l_fwd[2];  // m log2(e) (MASK where the row sees no key), the forward's l
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = rho0 + ra + 8 * h;
    row_ok[h] = rho < pb.total_rows;
    pos[h] = rho / G;
    float m = 0.0f;
    l_fwd[h] = 1.0f;
    if (row_ok[h]) {
      const int64_t idx = stat_index(pb, b, kvh, rho);
      m = stats[idx];
      l_fwd[h] = stats[plane(pb) + idx];
    }
    masked_row[h] = m == kMaskValue;
    m2[h] = masked_row[h] ? kMaskValue : m * kLog2e;
  }
  const float scale2 = pb.scale * kLog2e;
  // e = exp(S - m) of accumulator element i of the tile at key k0 (0 where
  // the key or the row is not there); keep: the masks keep the pair.
  // kMasked (a std::bool_constant): the tile holds a pair the masks drop,
  // a row past the end or a key past Sk; without, no mask is computed.
  auto exp_score = [&](float s, int i, int k0, auto kMasked, bool& keep) -> float {
    const int h = i % 4 / 2;
    keep = true;
    if constexpr (!decltype(kMasked)::value) {
      return ex2(s * scale2 - m2[h]);
    } else {
      const int key = k0 + i / 4 * 8 + col + i % 2;
      const bool present = row_ok[h] && key < pb.seq_k;  // keys past Sk are not there at all
      keep = present;
      if (pb.causal) keep = keep && key <= pos[h];
      if (pb.window) keep = keep && key > pos[h] - pb.window;
      return present ? ex2((keep ? s * scale2 : kMaskValue) - m2[h]) : 0.0f;
    }
  };

  // step's stage once its tiles have landed, after starting the load of
  // step + kStages - 1 (into the stage that step - 1 used: the caller has
  // synchronised since that step's last read of it)
  auto ready = [&](int step, bool load) -> uint32_t {
    if (load && step + kStages - 1 < n_steps) load_step(step + kStages - 1);
    const int st = step % kStages;
    sm90::mbar_wait(full + 8 * st, (step / kStages) & 1);
    sm90::fence_proxy_async();  // the copies' writes, before wgmma reads them
    return ring + 2 * st * T;
  };
  float s[32], dp[32];
  int step = 0;

  // L: the sums of e, two key tiles a step (S of the second in dP's registers)
  float part[2] = {0.0f, 0.0f};
  auto sum_l = [&](const float (&acc)[32], int key0, auto kMasked) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      bool keep;
      part[i % 4 / 2] += exp_score(acc[i], i, key0, kMasked, keep);
    }
  };
  for (int t = 0; t < walk.n; t += 2, ++step) {
    const uint32_t kt = ready(step, true);
    const int k0 = (walk.t_lo + t) * kRows;
    const bool pair = t + 1 < walk.n;  // the second key tile in the V slot
    sm90::wgmma_fence();  // s and dp are the products' outputs only
    flash::ss_issue<DP, true>(s, q_tile, kt);
    if (pair) flash::ss_issue<DP, true>(dp, q_tile, kt + T);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    if (tile_masked(pb, rho0, k0)) {
      sum_l(s, k0, std::true_type{});
    } else {
      sum_l(s, k0, std::false_type{});
    }
    if (pair && tile_masked(pb, rho0, k0 + kRows)) {
      sum_l(dp, k0 + kRows, std::true_type{});
    } else if (pair) {
      sum_l(dp, k0 + kRows, std::false_type{});
    }
    __syncthreads();  // every warp is done with this stage before it is loaded again
  }
  float norm[2], inv_norm[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = row_total(part[h]);  // every lane of the warp shuffles
    norm[h] = fmaxf(masked_row[h] ? l_fwd[h] : sum, 1e-30f);
    inv_norm[h] = 1.0f / norm[h];
    part[h] = 0.0f;
  }

  // S and dP of a step's key tile, then P = e / L (e == L: the row's one
  // key, P = 1 exactly; such a row lies in masked tiles only, the others
  // keep all 64 keys of a row) into s; fn(i, p, keep) takes each element
  auto gradient_step = [&](uint32_t kt, int k0, auto fn) {
    sm90::wgmma_fence();
    flash::ss_issue<DP, true>(s, q_tile, kt);         // S = Q K^T
    flash::ss_issue<DP, true>(dp, do_tile, kt + T);   // dP = dO V^T
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    auto body = [&](auto kMasked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        bool keep;
        const float e = exp_score(s[i], i, k0, kMasked, keep);
        float p = e * inv_norm[i % 4 / 2];
        if constexpr (decltype(kMasked)::value) p = e == norm[i % 4 / 2] ? 1.0f : p;
        fn(i, p, keep);
      }
    };
    if (tile_masked(pb, rho0, k0)) {
      body(std::true_type{});
    } else {
      body(std::false_type{});
    }
  };
  // Delta: the sums of P dP where kept
  for (int t = 0; t < walk.n; ++t, ++step) {
    const uint32_t kt = ready(step, true);
    gradient_step(kt, (walk.t_lo + t) * kRows, [&](int i, float p, bool keep) {
      if (keep) part[i % 4 / 2] = fmaf(p, dp[i], part[i % 4 / 2]);
    });
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) delta[h] = row_total(part[h]);

  // dQ += dS K, dS = P (dP - Delta) where kept (kRemainder: as value +
  // remainder).  A step's product runs on while the next step's S and dP
  // are issued: the wait for those completes it, and only then (all warps
  // past it) is its stage loaded again and its operand's registers free.
  float dq_acc[DP / 2];
  zero(dq_acc);
  uint32_t hi[4][4] = {}, lo[4][4] = {};
  for (int t = 0; t < walk.n; ++t, ++step) {
    const uint32_t kt = ready(step, t == 0);
    gradient_step(kt, (walk.t_lo + t) * kRows, [&](int i, float p, bool keep) {
      dp[i] = keep ? p * (dp[i] - delta[i % 4 / 2]) : 0.0f;
    });
    fence_operand(hi);  // the previous step's product has completed
    if constexpr (kRemainder) fence_operand(lo);
    __syncthreads();
    if (t > 0 && step + kStages - 1 < n_steps) load_step(step + kStages - 1);
    if constexpr (kRemainder) {
      split_operand(dp, hi, lo);
      fence_operand(lo);
    } else {
      flash::pack_operand(dp, hi);
    }
    fence_operand(hi);
    sm90::fence_regs(dq_acc);
    sm90::wgmma_fence();
    flash::rs_issue<DP>(dq_acc, hi, kt);
    if constexpr (kRemainder) flash::rs_issue<DP>(dq_acc, lo, kt);
    sm90::wgmma_commit();
  }
  sm90::wgmma_wait_all();
  sm90::fence_regs(dq_acc);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const int rho = rho0 + ra + 8 * h;
    if (tid % 4 == 0) {  // for the dK/dV kernel: m log2(e), 1 / L, Delta
      const int64_t idx = stat_index(pb, b, kvh, rho);
      aux[idx] = m2[h];
      aux[plane(pb) + idx] = inv_norm[h];
      aux[2 * plane(pb) + idx] = delta[h];
    }
    const int i = rho / G, g = rho % G;
    bf16* dst = dq + ((static_cast<int64_t>(b) * pb.seq_q + i) * pb.heads + kvh * G + g) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + col) = __floats2bfloat162_rn(
            dq_acc[4 * j + 2 * h] * pb.scale, dq_acc[4 * j + 2 * h + 1] * pb.scale);
    }
  }
}

template <int DP, bool kFull>
__global__ void __launch_bounds__(flash::kWarpgroup, min_ctas<DP, true>())
flash_bwd_dkdv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ aux, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     Problem pb) {
  constexpr int T = DP * 128;
  constexpr int kStages = ring_stages<DP, true>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const tiles = smem_raw + (base - raw);
  const uint32_t k_tile = base, v_tile = base + T;  // stage s: Q at (2 + 2s) T, dO at (3 + 2s) T
  // stage s: the streamed rows' m log2(e), 1 / L and Delta, 64 each
  float* const row_stats = reinterpret_cast<float*>(tiles + (2 + 2 * kStages) * T);
  const uint32_t full = base + (2 + 2 * kStages) * T + kStages * 3 * kRows * 4;

  const int nbh = pb.batch * pb.kv_heads;
  const int bh = blockIdx.x % nbh, b = bh / pb.kv_heads, kvh = bh % pb.kv_heads;
  const int n_key_tiles = (pb.seq_k + kRows - 1) / kRows;
  const int k0 = longest_first(blockIdx.x / nbh, n_key_tiles, !pb.causal && pb.window) * kRows;
  const int D = kFull ? DP : pb.head_dim;
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(full + 8 * s, flash::kWarpgroup);
    sm90::fence_mbar_init();
  }
  if constexpr (!kFull) flash::zero_padding<DP>(tiles, 2 + 2 * kStages, D);
  __syncthreads();

  load_keys<DP>(k_tile, k, pb, b, kvh, k0, D);
  load_keys<DP>(v_tile, v, pb, b, kvh, k0, D);
  const RowWalk walk(pb, k0, kRows);
  // iteration it's rows into stage it % kStages (the first stage's phase
  // also covers K and V); this thread copies the statistics of row
  // tid % 64: m log2(e) and Delta (tid < 64), or 1 / L
  auto load_step = [&](int it) {
    const int st = it % kStages, rho0 = walk.tile(it) * kRows;
    const uint32_t qt = base + (2 + 2 * st) * T;
    load_row_tiles<DP>(qt, qt + T, q, dout, pb, b, kvh, rho0, D);
    float* rs = row_stats + st * 3 * kRows;
    const int r = tid % kRows, rho = rho0 + r;
    const bool ok = rho < pb.total_rows;
    const int64_t idx = ok ? stat_index(pb, b, kvh, rho) : 0;
    for (int p = tid / kRows; p < 3; p += flash::kWarpgroup / kRows)
      sm90::cp_async4(sm90::smem_u32(rs + p * kRows + r), aux + p * plane(pb) + idx, ok);
    sm90::cp_async_arrive(full + 8 * st);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < walk.n) load_step(s);
  if (walk.n == 0) {  // keys no row sees: dK = dV = 0
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
  }

  // this thread's two keys (h = 0, 1) and its first row in each 8-row block
  const int ra = tid / 32 * 16 + tid % 32 / 4;
  const int col = 2 * (tid % 4);
  const float scale2 = pb.scale * kLog2e;
  float dk_acc[DP / 2], dv_acc[DP / 2];
  zero(dk_acc);
  zero(dv_acc);
  float s[32], dp[32];

  for (int it = 0; it < walk.n; ++it) {
    if (it + kStages - 1 < walk.n) load_step(it + kStages - 1);
    const int st = it % kStages, rho0 = walk.tile(it) * kRows;
    const uint32_t qt = base + (2 + 2 * st) * T;
    sm90::mbar_wait(full + 8 * st, (it / kStages) & 1);
    sm90::fence_proxy_async();
    sm90::wgmma_fence();  // s and dp are the products' outputs only
    flash::ss_issue<DP, true>(s, k_tile, qt);       // S^T = K Q^T
    flash::ss_issue<DP, true>(dp, v_tile, qt + T);  // dP^T = V dO^T
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // P^T and dS^T in place of S^T and dP^T; kMasked as in the rows kernel
    const float* rs = row_stats + st * 3 * kRows;
    auto gradient = [&](auto kMasked) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // rows 8 j + col, + 1 of the tile
        const float2 m2 = *reinterpret_cast<const float2*>(rs + 8 * j + col);
        const float2 il = *reinterpret_cast<const float2*>(rs + kRows + 8 * j + col);
        const float2 dl = *reinterpret_cast<const float2*>(rs + 2 * kRows + 8 * j + col);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          int pos = 0;
          bool row_ok = true;
          if constexpr (decltype(kMasked)::value) {
            const int rho = rho0 + 8 * j + col + u;
            row_ok = rho < pb.total_rows;
            pos = rho / pb.groups;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + u;
            bool present = true, keep = true;
            if constexpr (decltype(kMasked)::value) {
              const int key = k0 + ra + 8 * h;
              present = row_ok && key < pb.seq_k;
              keep = present;
              if (pb.causal) keep = keep && key <= pos;
              if (pb.window) keep = keep && key > pos - pb.window;
            }
            const float e =
                present ? ex2((keep ? s[i] * scale2 : kMaskValue) - (u ? m2.y : m2.x)) : 0.0f;
            const float p = e * (u ? il.y : il.x);
            dp[i] = keep ? p * (dp[i] - (u ? dl.y : dl.x)) : 0.0f;
            s[i] = p;
          }
        }
      }
    };
    if (tile_masked(pb, rho0, k0)) {
      gradient(std::true_type{});
    } else {
      gradient(std::false_type{});
    }
    // dV += P^T dO, dK += dS^T Q, P and dS as value + remainder
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
    split_operand(s, p_hi, p_lo);
    split_operand(dp, ds_hi, ds_lo);
    fence_operand(p_hi);
    fence_operand(p_lo);
    fence_operand(ds_hi);
    fence_operand(ds_lo);
    sm90::fence_regs(dv_acc);
    sm90::fence_regs(dk_acc);
    sm90::wgmma_fence();
    flash::rs_issue<DP>(dv_acc, p_hi, qt + T);
    flash::rs_issue<DP>(dv_acc, p_lo, qt + T);
    flash::rs_issue<DP>(dk_acc, ds_hi, qt);
    flash::rs_issue<DP>(dk_acc, ds_lo, qt);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(dv_acc);
    sm90::fence_regs(dk_acc);
    __syncthreads();  // every warp is done with this stage before it is loaded again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + ra + 8 * h;
    if (key >= pb.seq_k) continue;
    const int64_t at = ((static_cast<int64_t>(b) * pb.seq_k + key) * pb.kv_heads + kvh) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j >= D) continue;
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j + col) = __floats2bfloat162_rn(
          dk_acc[4 * j + 2 * h] * pb.scale, dk_acc[4 * j + 2 * h + 1] * pb.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j + col) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at DP 192 and 256: the dK/dV kernel with two consumer warpgroups.

constexpr int kWide = 2 * flash::kWarpgroup;  // threads of flash_bwd_dkdv_wide

// o (64 x DP / 2 f32) += A B[:, half], A (64 x 64) from registers (the
// layout of pack_operand), B (64 x DP) MN-major in shared memory, half the
// columns [kHalf * DP / 2, (kHalf + 1) * DP / 2).  The caller fences,
// commits, waits.
template <int DP, int kHalf>
__device__ __forceinline__ void rs_issue_half(float (&o)[DP / 4], const uint32_t (&a)[4][4],
                                              uint32_t b_tile) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    flash::rs_issue_cols<kHalf * DP / 2, DP / 2, 0>(o, a[ks], b_tile + ks * 2 * flash::kAtomBytes);
}

// Issues s (64 x 32 f32) = A (64 x DP) B^T for 32 rows of B from b_rows,
// both tiles K-major (b_rows a multiple of 8 rows into its tile): DP / 16
// wgmma steps, the first overwriting s.  The caller fences, commits, waits.
template <int DP>
__device__ __forceinline__ void ss_issue_n32(float (&s)[16], uint32_t a_tile, uint32_t b_rows) {
  using flash::kAtomBytes;
  using flash::kRegionBytes;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const uint32_t off = ks / 4 * kRegionBytes + ks % 4 * 32;
    const uint64_t da = sm90::wgmma_desc_sw128(a_tile + off, 16, kAtomBytes);
    const uint64_t db = sm90::wgmma_desc_sw128(b_rows + off, 16, kAtomBytes);
    if (ks == 0) {
      sm90::wgmma_ss_m64n32k16_first(s, da, db);
    } else {
      sm90::wgmma_ss_m64n32k16(s, da, db, 1);
    }
  }
}

// bf16 at DP 256: flash_bwd_rows_wgmma's three walks with two warpgroups
// a CTA (one warpgroup holding dQ's 64 x DP f32 accumulators spills, and
// two warpgroups of 64 rows each, as at DP 192, would leave no room for a
// ring of key tiles beside their Q and dO).  Warpgroup w takes keys [32 w, 32 w + 32) of every key tile: its
// S and dP are m64n32 products (SS form) and its dS enters dQ += dS K as an
// RS product of two k steps over the whole DP, so no product is formed
// twice.  The warpgroups' row sums of e (L) and of P dP (Delta) meet in
// shared memory, warpgroup 0's first, and warpgroup 1's dQ is added to
// warpgroup 0's in shared memory at the end: the same order every call.  A
// key the masks drop gives e = 0 exactly, so a row's one key still has
// e == L and P = 1.
template <int DP>
__global__ void __launch_bounds__(kWide, 1)
flash_bwd_rows_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ stats, float* __restrict__ aux,
                    bf16* __restrict__ dq, Problem pb) {
  constexpr int T = DP * 128;
  constexpr int kStages = ring_stages<DP, false>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const tiles = smem_raw + (base - raw);
  const uint32_t q_tile = base, do_tile = base + T;  // stage s: K at (2 + 2s) T, V at (3 + 2s) T
  // the warpgroups' row sums: [L, Delta][warpgroup][64 rows]
  float* const red = reinterpret_cast<float*>(tiles + (2 + 2 * kStages) * T);
  const uint32_t full = base + (2 + 2 * kStages) * T + 4 * kRows * 4;  // a barrier a stage

  const int nbh = pb.batch * pb.kv_heads;
  const int bh = blockIdx.x % nbh, b = bh / pb.kv_heads, kvh = bh % pb.kv_heads;
  const int n_row_tiles = (pb.total_rows + kRows - 1) / kRows;
  const int rho0 = longest_first(blockIdx.x / nbh, n_row_tiles, pb.causal) * kRows;
  const int D = pb.head_dim, G = pb.groups;
  const int tid = threadIdx.x, wg = tid / flash::kWarpgroup, t = tid % flash::kWarpgroup;
  const int kw = 32 * wg;  // this warpgroup's first key of a tile

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(full + 8 * s, kWide);
    sm90::fence_mbar_init();
  }
  flash::zero_padding<DP, kWide>(tiles, 2 + 2 * kStages, D);
  __syncthreads();

  const int first_pos = rho0 / G, last_pos = (min(rho0 + kRows, pb.total_rows) - 1) / G;
  const KeyWalk walk(pb, first_pos, last_pos);
  const int n0 = (walk.n + 1) / 2;
  const int n_steps = walk.n ? n0 + 2 * walk.n : 0;

  load_row_tiles<DP, kWide>(q_tile, do_tile, q, dout, pb, b, kvh, rho0, D);
  auto load_step = [&](int step) {
    const bool first_walk = step < n0;
    const int tt = first_walk ? 2 * step : (step - n0) % walk.n;
    const int st = step % kStages, k0 = (walk.t_lo + tt) * kRows;
    const uint32_t kt = base + (2 + 2 * st) * T;
    load_keys<DP, kWide>(kt, k, pb, b, kvh, k0, D);
    if (!first_walk) {
      load_keys<DP, kWide>(kt + T, v, pb, b, kvh, k0, D);
    } else if (tt + 1 < walk.n) {
      load_keys<DP, kWide>(kt + T, k, pb, b, kvh, k0 + kRows, D);
    }
    sm90::cp_async_arrive(full + 8 * st);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < n_steps) load_step(s);
  if (n_steps == 0) {
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
  }

  const int ra = t / 32 * 16 + t % 32 / 4;
  const int col = 2 * (t % 4);
  bool row_ok[2], masked_row[2];
  int pos[2];
  float m2[2], l_fwd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = rho0 + ra + 8 * h;
    row_ok[h] = rho < pb.total_rows;
    pos[h] = rho / G;
    float m = 0.0f;
    l_fwd[h] = 1.0f;
    if (row_ok[h]) {
      const int64_t idx = stat_index(pb, b, kvh, rho);
      m = stats[idx];
      l_fwd[h] = stats[plane(pb) + idx];
    }
    masked_row[h] = m == kMaskValue;
    m2[h] = masked_row[h] ? kMaskValue : m * kLog2e;
  }
  const float scale2 = pb.scale * kLog2e;
  // as in flash_bwd_rows_wgmma, for accumulator element i (of 16) of this
  // warpgroup's 32 keys of the tile at k0
  auto exp_score = [&](float x, int i, int k0, auto kMasked, bool& keep) -> float {
    const int h = i % 4 / 2;
    keep = true;
    if constexpr (!decltype(kMasked)::value) {
      return ex2(x * scale2 - m2[h]);
    } else {
      const int key = k0 + kw + i / 4 * 8 + col + i % 2;
      const bool present = row_ok[h] && key < pb.seq_k;
      keep = present;
      if (pb.causal) keep = keep && key <= pos[h];
      if (pb.window) keep = keep && key > pos[h] - pb.window;
      return present ? ex2((keep ? x * scale2 : kMaskValue) - m2[h]) : 0.0f;
    }
  };
  auto ready = [&](int step, bool load) -> uint32_t {
    if (load && step + kStages - 1 < n_steps) load_step(step + kStages - 1);
    const int st = step % kStages;
    sm90::mbar_wait(full + 8 * st, (step / kStages) & 1);
    sm90::fence_proxy_async();
    return base + (2 + 2 * st) * T;
  };
  // each row's sum over both warpgroups' keys, warpgroup 0's share first
  // (every lane of a warp shuffles); which: 0 for L, 1 for Delta
  auto row_sums = [&](float (&part)[2], int which, float (&out)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = row_total(part[h]);
      if (t % 4 == 0) red[(2 * which + wg) * kRows + ra + 8 * h] = v;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h)
      out[h] = red[2 * which * kRows + ra + 8 * h] + red[(2 * which + 1) * kRows + ra + 8 * h];
  };
  float s[16], dp[16];
  int step = 0;
  const uint32_t k_rows = kw * 128;  // byte offset of this warpgroup's keys in a K-major tile

  // L: the sums of e, two key tiles a step
  float part[2] = {0.0f, 0.0f};
  auto sum_l = [&](const float (&acc)[16], int key0, auto kMasked) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      bool keep;
      part[i % 4 / 2] += exp_score(acc[i], i, key0, kMasked, keep);
    }
  };
  for (int tt = 0; tt < walk.n; tt += 2, ++step) {
    const uint32_t kt = ready(step, true);
    const int k0 = (walk.t_lo + tt) * kRows;
    const bool pair = tt + 1 < walk.n;
    sm90::wgmma_fence();
    ss_issue_n32<DP>(s, q_tile, kt + k_rows);
    if (pair) ss_issue_n32<DP>(dp, q_tile, kt + T + k_rows);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    if (tile_masked(pb, rho0, k0)) {
      sum_l(s, k0, std::true_type{});
    } else {
      sum_l(s, k0, std::false_type{});
    }
    if (pair && tile_masked(pb, rho0, k0 + kRows)) {
      sum_l(dp, k0 + kRows, std::true_type{});
    } else if (pair) {
      sum_l(dp, k0 + kRows, std::false_type{});
    }
    __syncthreads();
  }
  float norm[2], inv_norm[2], delta[2], sum[2];
  row_sums(part, 0, sum);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    norm[h] = fmaxf(masked_row[h] ? l_fwd[h] : sum[h], 1e-30f);
    inv_norm[h] = 1.0f / norm[h];
    part[h] = 0.0f;
  }

  auto gradient_step = [&](uint32_t kt, int k0, auto fn) {
    sm90::wgmma_fence();
    ss_issue_n32<DP>(s, q_tile, kt + k_rows);       // S = Q K^T, this warpgroup's keys
    ss_issue_n32<DP>(dp, do_tile, kt + T + k_rows);  // dP = dO V^T
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    auto body = [&](auto kMasked) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        bool keep;
        const float e = exp_score(s[i], i, k0, kMasked, keep);
        float p = e * inv_norm[i % 4 / 2];
        if constexpr (decltype(kMasked)::value) p = e == norm[i % 4 / 2] ? 1.0f : p;
        fn(i, p, keep);
      }
    };
    if (tile_masked(pb, rho0, k0)) {
      body(std::true_type{});
    } else {
      body(std::false_type{});
    }
  };
  for (int tt = 0; tt < walk.n; ++tt, ++step) {  // Delta
    const uint32_t kt = ready(step, true);
    gradient_step(kt, (walk.t_lo + tt) * kRows, [&](int i, float p, bool keep) {
      if (keep) part[i % 4 / 2] = fmaf(p, dp[i], part[i % 4 / 2]);
    });
    __syncthreads();
  }
  row_sums(part, 1, delta);

  // dQ += dS K over this warpgroup's 32 keys (K's rows kw .. kw + 31 as the
  // MN-major B operand), a step's product running on while the next step's
  // S and dP are issued, as in flash_bwd_rows_wgmma
  float dq_acc[DP / 2];
  zero(dq_acc);
  uint32_t ds[2][4] = {};
  for (int tt = 0; tt < walk.n; ++tt, ++step) {
    const uint32_t kt = ready(step, tt == 0);
    gradient_step(kt, (walk.t_lo + tt) * kRows, [&](int i, float p, bool keep) {
      dp[i] = keep ? p * (dp[i] - delta[i % 4 / 2]) : 0.0f;
    });
    fence_operand(ds);
    __syncthreads();
    if (tt > 0 && step + kStages - 1 < n_steps) load_step(step + kStages - 1);
    flash::pack_operand(dp, ds);
    fence_operand(ds);
    sm90::fence_regs(dq_acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      flash::rs_issue_cols<0, DP, 0>(dq_acc, ds[ks], kt + (kw / 8 + 2 * ks) * flash::kAtomBytes);
    sm90::wgmma_commit();
  }
  sm90::wgmma_wait_all();
  sm90::fence_regs(dq_acc);

  // warpgroup 1's dQ through the ring's first stage (no longer read), then
  // warpgroup 0 adds it to its own and writes
  float* const dq1 = reinterpret_cast<float*>(tiles + 2 * T);
  __syncthreads();
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq1[i * flash::kWarpgroup + t] = dq_acc[i];
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] += dq1[i * flash::kWarpgroup + t];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const int rho = rho0 + ra + 8 * h;
    if (t % 4 == 0) {  // for the dK/dV kernel: m log2(e), 1 / L, Delta
      const int64_t idx = stat_index(pb, b, kvh, rho);
      aux[idx] = m2[h];
      aux[plane(pb) + idx] = inv_norm[h];
      aux[2 * plane(pb) + idx] = delta[h];
    }
    const int i = rho / G, g = rho % G;
    bf16* dst = dq + ((static_cast<int64_t>(b) * pb.seq_q + i) * pb.heads + kvh * G + g) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + col) = __floats2bfloat162_rn(
            dq_acc[4 * j + 2 * h] * pb.scale, dq_acc[4 * j + 2 * h + 1] * pb.scale);
    }
  }
}

// A CTA per (batch, kv head, 64 keys; `splits` ranges of its row walk):
// flash_bwd_dkdv_wgmma's walk with 256 threads.  Warpgroup w owns dK's and
// dV's columns [w DP / 2, (w + 1) DP / 2), 2 x DP / 4 f32 a thread (one
// warpgroup would need 2 x DP / 2, past the 255 registers a thread may
// hold); both form the whole S^T and dP^T (SS form), so that P^T and dS^T
// stay in registers as the A operand of their own halves of dV += P^T dO and
// dK += dS^T Q (RS form).  Q and dO tiles by cp.async into a ring of
// ring_stages stages on mbarriers, as in flash_bwd_dkdv_wgmma.  With one
// range the CTA writes dk (times scale) and dv in bf16; with several (the
// grid of key tiles short of a wave) its range's sums go to part (splits,
// 2, B, Sk, KVH, DP) in f32 and flash_bwd_split_sum adds them in order.
template <int DP>
__global__ void __launch_bounds__(kWide, 1)
flash_bwd_dkdv_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ aux, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    float* __restrict__ part, int splits, Problem pb) {
  constexpr int T = DP * 128;
  constexpr int kStages = ring_stages<DP, true>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const tiles = smem_raw + (base - raw);
  const uint32_t k_tile = base, v_tile = base + T;  // stage s: Q at (2 + 2s) T, dO at (3 + 2s) T
  float* const row_stats = reinterpret_cast<float*>(tiles + (2 + 2 * kStages) * T);
  const uint32_t full = base + (2 + 2 * kStages) * T + kStages * 3 * kRows * 4;

  const int nbh = pb.batch * pb.kv_heads;
  const int sp = blockIdx.x % splits, cta = blockIdx.x / splits;
  const int bh = cta % nbh, b = bh / pb.kv_heads, kvh = bh % pb.kv_heads;
  const int n_key_tiles = (pb.seq_k + kRows - 1) / kRows;
  const int k0 = longest_first(cta / nbh, n_key_tiles, !pb.causal && pb.window) * kRows;
  const int D = pb.head_dim;
  const int tid = threadIdx.x, wg = tid / flash::kWarpgroup, t = tid % flash::kWarpgroup;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(full + 8 * s, kWide);
    sm90::fence_mbar_init();
  }
  flash::zero_padding<DP, kWide>(tiles, 2 + 2 * kStages, D);
  __syncthreads();

  load_keys<DP, kWide>(k_tile, k, pb, b, kvh, k0, D);
  load_keys<DP, kWide>(v_tile, v, pb, b, kvh, k0, D);
  const RowWalk walk(pb, k0, kRows);
  const int it0 = static_cast<int>(static_cast<int64_t>(sp) * walk.n / splits);  // this range
  const int n = static_cast<int>(static_cast<int64_t>(sp + 1) * walk.n / splits) - it0;
  // the range's j-th row tile into stage j % kStages (the first stage's
  // phase also covers K and V); threads tid < 192 copy the statistics of
  // row tid % 64: m log2(e), 1 / L, Delta
  auto load_step = [&](int j) {
    const int st = j % kStages, rho0 = walk.tile(it0 + j) * kRows;
    const uint32_t qt = base + (2 + 2 * st) * T;
    load_row_tiles<DP, kWide>(qt, qt + T, q, dout, pb, b, kvh, rho0, D);
    const int p = tid / kRows;
    if (p < 3) {
      const int r = tid % kRows, rho = rho0 + r;
      const bool ok = rho < pb.total_rows;
      const int64_t idx = ok ? stat_index(pb, b, kvh, rho) : 0;
      sm90::cp_async4(sm90::smem_u32(row_stats + st * 3 * kRows + p * kRows + r),
                      aux + p * plane(pb) + idx, ok);
    }
    sm90::cp_async_arrive(full + 8 * st);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < n) load_step(s);
  if (n == 0) {  // no row of this range sees the keys: zero sums
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
  }

  // this thread's two keys (h = 0, 1) and its first row in each 8-row block,
  // as in flash_bwd_dkdv_wgmma (each warpgroup holds the whole S^T)
  const int ra = t / 32 * 16 + t % 32 / 4;
  const int col = 2 * (t % 4);
  const float scale2 = pb.scale * kLog2e;
  float dk_acc[DP / 4], dv_acc[DP / 4];
  zero(dk_acc);
  zero(dv_acc);
  float s[32], dp[32];

  for (int j = 0; j < n; ++j) {
    if (j + kStages - 1 < n) load_step(j + kStages - 1);
    const int st = j % kStages, rho0 = walk.tile(it0 + j) * kRows;
    const uint32_t qt = base + (2 + 2 * st) * T;
    sm90::mbar_wait(full + 8 * st, (j / kStages) & 1);
    sm90::fence_proxy_async();
    const float* rs = row_stats + st * 3 * kRows;
    sm90::wgmma_fence();  // s and dp are the products' outputs only
    flash::ss_issue<DP, true>(s, k_tile, qt);       // S^T = K Q^T
    flash::ss_issue<DP, true>(dp, v_tile, qt + T);  // dP^T = V dO^T
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // P^T and dS^T in place of S^T and dP^T, as in flash_bwd_dkdv_wgmma
    auto gradient = [&](auto kMasked) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {  // rows 8 jj + col, + 1 of the tile
        const float2 m2 = *reinterpret_cast<const float2*>(rs + 8 * jj + col);
        const float2 il = *reinterpret_cast<const float2*>(rs + kRows + 8 * jj + col);
        const float2 dl = *reinterpret_cast<const float2*>(rs + 2 * kRows + 8 * jj + col);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          int pos = 0;
          bool row_ok = true;
          if constexpr (decltype(kMasked)::value) {
            const int rho = rho0 + 8 * jj + col + u;
            row_ok = rho < pb.total_rows;
            pos = rho / pb.groups;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * jj + 2 * h + u;
            bool present = true, keep = true;
            if constexpr (decltype(kMasked)::value) {
              const int key = k0 + ra + 8 * h;
              present = row_ok && key < pb.seq_k;
              keep = present;
              if (pb.causal) keep = keep && key <= pos;
              if (pb.window) keep = keep && key > pos - pb.window;
            }
            const float e =
                present ? ex2((keep ? s[i] * scale2 : kMaskValue) - (u ? m2.y : m2.x)) : 0.0f;
            const float p = e * (u ? il.y : il.x);
            dp[i] = keep ? p * (dp[i] - (u ? dl.y : dl.x)) : 0.0f;
            s[i] = p;
          }
        }
      }
    };
    if (tile_masked(pb, rho0, k0)) {
      gradient(std::true_type{});
    } else {
      gradient(std::false_type{});
    }
    // dV[:, half] += P^T dO[:, half], dK[:, half] += dS^T Q[:, half], P and
    // dS in bf16
    uint32_t pa[4][4], dsa[4][4];
    flash::pack_operand(s, pa);
    flash::pack_operand(dp, dsa);
    fence_operand(pa);
    fence_operand(dsa);
    sm90::fence_regs(dv_acc);
    sm90::fence_regs(dk_acc);
    sm90::wgmma_fence();
    if (wg == 0) {
      rs_issue_half<DP, 0>(dv_acc, pa, qt + T);
      rs_issue_half<DP, 0>(dk_acc, dsa, qt);
    } else {
      rs_issue_half<DP, 1>(dv_acc, pa, qt + T);
      rs_issue_half<DP, 1>(dk_acc, dsa, qt);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(dv_acc);
    sm90::fence_regs(dk_acc);
    __syncthreads();  // both warpgroups are done with this stage before it is loaded again
  }

  const int c0 = wg * DP / 2;
  const int64_t part_plane = static_cast<int64_t>(pb.batch) * pb.seq_k * pb.kv_heads * DP;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + ra + 8 * h;
    if (key >= pb.seq_k) continue;
    const int64_t kr = (static_cast<int64_t>(b) * pb.seq_k + key) * pb.kv_heads + kvh;
#pragma unroll
    for (int jj = 0; jj < DP / 16; ++jj) {
      const int c = c0 + 8 * jj + col;
      if (c >= D) continue;
      const float2 gk = make_float2(dk_acc[4 * jj + 2 * h], dk_acc[4 * jj + 2 * h + 1]);
      const float2 gv = make_float2(dv_acc[4 * jj + 2 * h], dv_acc[4 * jj + 2 * h + 1]);
      if (splits == 1) {
        *reinterpret_cast<__nv_bfloat162*>(dk + kr * D + c) =
            __floats2bfloat162_rn(gk.x * pb.scale, gk.y * pb.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + kr * D + c) = __floats2bfloat162_rn(gv.x, gv.y);
      } else {
        float* at = part + 2 * sp * part_plane + kr * DP + c;
        *reinterpret_cast<float2*>(at) = gk;
        *reinterpret_cast<float2*>(at + part_plane) = gv;
      }
    }
  }
}

// dk (times scale) and dv in bf16: the `splits` ranges' sums of
// flash_bwd_dkdv_wide in part (splits, 2, rows, DP) added in order (two
// calls give the same bits); rows = B Sk KVH, two columns a thread.
__global__ void __launch_bounds__(256)
flash_bwd_split_sum(const float* __restrict__ part, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    int64_t rows, int d, int dp, int splits, float scale) {
  const int64_t plane = rows * dp, pairs = rows * (d / 2);
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; e < pairs;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = e / (d / 2);
    const int c = 2 * static_cast<int>(e % (d / 2));
    float2 gk = make_float2(0.0f, 0.0f), gv = gk;
    for (int sp = 0; sp < splits; ++sp) {
      const float2 a = *reinterpret_cast<const float2*>(part + 2 * sp * plane + r * dp + c);
      const float2 w = *reinterpret_cast<const float2*>(part + (2 * sp + 1) * plane + r * dp + c);
      gk.x += a.x;
      gk.y += a.y;
      gv.x += w.x;
      gv.y += w.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(dk + r * d + c) =
        __floats2bfloat162_rn(gk.x * scale, gk.y * scale);
    *reinterpret_cast<__nv_bfloat162*>(dv + r * d + c) = __floats2bfloat162_rn(gv.x, gv.y);
  }
}

template <int DP, bool kFull>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* dout,
                         const float* stats, float* aux, void* dq, void* dk, void* dv,
                         const Problem& pb, cudaStream_t stream) {
  constexpr int rows_smem = wg_smem_bytes<DP, false>(), kv_smem = wg_smem_bytes<DP, true>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_rows_wgmma<DP, kFull>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, rows_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<DP, kFull>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err != cudaSuccess) return err;
  const int64_t nbh = static_cast<int64_t>(pb.batch) * pb.kv_heads;
  const int64_t row_ctas = nbh * ((pb.total_rows + kRows - 1) / kRows);
  const int64_t key_ctas = nbh * ((pb.seq_k + kRows - 1) / kRows);
  if (row_ctas > INT32_MAX || key_ctas > INT32_MAX) return cudaErrorInvalidValue;
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  flash_bwd_rows_wgmma<DP, kFull><<<static_cast<unsigned>(row_ctas), flash::kWarpgroup,
                                    rows_smem, stream>>>(tq, tk, tv, tdo, stats, aux,
                                                         static_cast<bf16*>(dq), pb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wgmma<DP, kFull><<<static_cast<unsigned>(key_ctas), flash::kWarpgroup, kv_smem,
                                    stream>>>(tq, tk, tv, tdo, aux, static_cast<bf16*>(dk),
                                              static_cast<bf16*>(dv), pb);
  return cudaGetLastError();
}

// bf16 at DP 192 and 256: the rows kernel (flash_bwd_rows_wgmma with two
// warpgroups at DP 192, flash_bwd_rows_wide at 256), flash_bwd_dkdv_wide
// over `splits` ranges of each key tile's walk, and with several ranges
// flash_bwd_split_sum.
template <int DP>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* dout,
                        const float* stats, float* aux, void* dq, void* dk, void* dv, float* part,
                        int splits, const Problem& pb, cudaStream_t stream) {
  // DP 192: two warpgroups of 64 rows a CTA; DP 256 (whose 128 rows of Q
  // and dO leave no room for a ring): 64 rows, the keys split
  constexpr bool kPair = DP == 192;
  constexpr int rows_smem = kPair ? rows_smem_bytes<DP, 2>() : wg_smem_bytes<DP, false>();
  constexpr int kv_smem = wg_smem_bytes<DP, true>(), cta_rows = kPair ? 2 * kRows : kRows;
  const auto rows_kernel = [] {
    if constexpr (kPair) {
      return flash_bwd_rows_wgmma<DP, false, 2, false>;
    } else {
      return flash_bwd_rows_wide<DP>;
    }
  }();
  cudaError_t err = cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         rows_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_wide<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err != cudaSuccess) return err;
  const int64_t nbh = static_cast<int64_t>(pb.batch) * pb.kv_heads;
  const int64_t row_ctas = nbh * ((pb.total_rows + cta_rows - 1) / cta_rows);
  const int64_t key_ctas = nbh * ((pb.seq_k + kRows - 1) / kRows) * splits;
  if (row_ctas > INT32_MAX || key_ctas > INT32_MAX) return cudaErrorInvalidValue;
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  rows_kernel<<<static_cast<unsigned>(row_ctas), kWide, rows_smem, stream>>>(
      tq, tk, tv, tdo, stats, aux, static_cast<bf16*>(dq), pb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wide<DP><<<static_cast<unsigned>(key_ctas), kWide, kv_smem, stream>>>(
      tq, tk, tv, tdo, aux, static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, splits, pb);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t rows = static_cast<int64_t>(pb.batch) * pb.seq_k * pb.kv_heads;
  const int64_t blocks = std::min<int64_t>((rows * (pb.head_dim / 2) + 255) / 256, 4096);
  flash_bwd_split_sum<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), rows, pb.head_dim, DP, splits,
      pb.scale);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const float* stats, float* aux, void* dq, void* dk, void* dv,
                        float* part, int splits, const Problem& pb, cudaStream_t stream) {
#define K4_WGMMA(DP, FULL) launch_wgmma<DP, FULL>(q, k, v, dout, stats, aux, dq, dk, dv, pb, stream)
#define K4_WIDE(DP) launch_wide<DP>(q, k, v, dout, stats, aux, dq, dk, dv, part, splits, pb, stream)
  const int d = pb.head_dim;
  if (d <= 64) return d == 64 ? K4_WGMMA(64, true) : K4_WGMMA(64, false);
  if (d <= 128) return d == 128 ? K4_WGMMA(128, true) : K4_WGMMA(128, false);
  return d <= 192 ? K4_WIDE(192) : K4_WIDE(256);
#undef K4_WIDE
#undef K4_WGMMA
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, KVH, D) in bfloat16,
// contiguous, on the card, 1 <= D <= 256, D % 8 == 0, 16-byte aligned q,
// k, v, dout; stats (2, B, H, Sq) f32: the forward's m, then l; aux (3, B,
// H, Sq) f32 scratch (the rows' statistics for the dK/dV kernel).  splits:
// the ranges each key tile's row walk is cut into, 1 but past D 128, whose
// part is then (splits, 2, B, Sk, KVH, DP) f32 scratch (DP 192 up to D 192,
// else 256); null with one range.
int flash_attention_backward_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const float* stats, float* aux, void* dq,
                                    void* dk, void* dv, float* part, int batch, int seq_q,
                                    int seq_k, int heads, int kv_heads, int head_dim, int causal,
                                    int window, int splits, float scale, void* stream) {
  // 16-byte copies need whole 8-column chunks on 16-byte aligned rows
  if (batch <= 0 || seq_q <= 0 || seq_k <= 0 || kv_heads <= 0 || heads % kv_heads ||
      head_dim < 1 || head_dim > kMaxHeadDim || batch > 65535 || kv_heads > 65535 ||
      static_cast<int64_t>(seq_q) * (heads / kv_heads) > (int64_t{1} << 30) || splits < 1 ||
      splits > 65535 || (splits > 1) != (part != nullptr) || (splits > 1 && head_dim <= 128) ||
      head_dim % 8 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem pb{batch, seq_q, seq_k, heads, kv_heads, head_dim, heads / kv_heads,
                   seq_q * (heads / kv_heads), causal, window, scale};
  return static_cast<int>(launch_bf16(q, k, v, dout, stats, aux, dq, dk, dv, part, splits, pb,
                                      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
