// Flash attention backward (K4's gradient) in float32 for Hopper (sm_90a),
// bound to Python with ctypes.
//
// flash_attention_f32_backward_launch is the gradient of
//    flash_attention_f32_launch (csrc/flash_attention_f32.cu), which replaces
//    src/repro/kernels/flash_attention/flash_attention.py
//    flash_attention_pallas for float32.  The TPU kernel has no backward: the
//    JAX package trains through XLA's autodiff of plain jnp attention, and
//    this is the port's kernel for the same gradient.  csrc/flash_attention_bwd.cu
//    takes bf16 and states the function; in short, with S = (scale q) k^T
//    masked to -0.7 * FLT_MAX, P = exp(S - m) / L (L recomputed here as the
//    row sum of exp(S - m); the forward's l where the row sees no key, m =
//    MASK):
//        dV = P^T dO,  dP = dO V^T,  Delta = rowsum(P * dP) over the kept keys,
//        dS = P * (dP - Delta) (0 where masked),  dQ = scale dS K,  dK = dS^T (scale q).
//    Delta is formed from the same f32 P and dP that dS takes, and P is a
//    quotient of e by its own row sum, so a row that sees one key has P = 1
//    and dS = 0 exactly (dQ = 0 to the bit).  A fully masked row gives its
//    uniform P to dV and nothing to dQ or dK.  No atomics: two calls give the
//    same bits.
//
// The path of the f32 training step's parity checks, held to 2e-4 / 2e-5 of
// the plain version.  Its first kernels ran mma.sync's fragment layout on
// the CUDA cores (67 TFLOP/s), 4-12x slower than PyTorch's f32
// memory-efficient attention backward.  Here every product runs on wgmma
// as the six products of three bf16 pieces of each f32 operand
// (flash::ss_pieces, flash::rs_pieces, csrc/flash_tiles.cuh).  Bound:
// operations; the least work is 2.5 x kernel_flops of f32 products, 15 x of
// bf16 ones at 989 TFLOP/s; these kernels form S three times and dP twice a
// (row, key) pair in the rows kernel, and S and dP once in the dK/dV kernel
// up to DP 128 (S twice past it): 10 (11) f32 products where the forward
// runs 2 (backward_flops in kernels/flash_attention/ops.py), 60 (66) of bf16.
//
// The pieces of two held 64 x DP tiles take 2 x 3 x 64 x DP bf16, 192 KB at
// DP 256, so a CTA holds those two and streams tiles of T rows through
// buffers of pieces; one warpgroup (128 threads) a CTA at every width.  Each
// streamed tile is read into registers (16-byte loads, whole rows a warp)
// one tile ahead, while the tensor cores run the products of the tile
// before, and split once into its pieces as it is stored (F32Rows).
//  1. flash_bwd_f32_rows, a CTA per (batch, kv head, 64 rows numbered
//     i * G + g): holds Q (scaled) and dO as pieces, and walks the key tiles
//     its rows see three times: K for S and L; V for dP, then K for S, P and
//     Delta; V for dP, then K for S, dS and dQ += dS K (dS's pieces from
//     registers, RS form, K MN-major).  Key tiles of T = stream_rows keys
//     (64 at DP 64, 32 at DP 128, 16 past it) in two buffers, the next
//     tile's split under the products of the one before, where they fit
//     (all but DP 256).  It writes dq and each row's L and Delta (aux, 2
//     planes of (B, H, Sq)).
//  2. flash_bwd_f32_dkdv, a CTA per (batch, kv head, 64 keys; a range of its
//     row walk), holds K and V as pieces and walks the 64-row tiles whose
//     masks let a row see the keys (and the tiles of fully masked rows) in
//     row tiles of T = dkdv_rows (32 at DP 64, 16 past it).  Up to DP 128
//     (one_walk) once, Q and dO of a row tile in two buffers: S^T = K Q^T and
//     dP^T = V dO^T, then P^T and dS^T, then dV += P^T dO and dK += dS^T Q.
//     Wider, dK's and dV's accumulators together would pass 255 registers a
//     thread, so it walks twice through one buffer, one accumulator at a
//     time: Q for S^T and P^T, then dO for dV += P^T dO; then dO for dP^T,
//     then Q for S^T, dS^T and dK += dS^T Q.  Q is scaled as it is split, so
//     dK needs no scale after; P^T's and dS^T's pieces stay in registers (RS
//     form).
//  An accumulator that takes a whole walk drifts from the exact sum: on an
//  H100, 1000 wgmma sums into one accumulator (a 333-position D 160 dK at
//  G 8) put dK 0.16 of the f32 tolerance from the float64 gradient, about
//  what sums that do not round to nearest give, and a training row's walk
//  takes some 3000 (256 rows, 96 sums, an accumulator still put a
//  6400-row D 256 dK 0.24 of it away, twice the plain f32 version's
//  error).  So each accumulator takes 64 keys (dQ) or 64 rows (dK, dV), 24
//  wgmma sums, and is then added into the output (or the range's scratch)
//  in f32 and zeroed (add_row).
//  3. Where the dK/dV grid (batch x kv heads x 64-key tiles) is short of a
//     wave of the card's SMs (recurrentgemma's one kv head), each key tile's
//     row walk is cut into `splits` contiguous ranges whose f32 sums
//     flash_bwd_f32_split_sum adds in order.
// Both grids launch the longest walks first (causal row CTAs from the last
// row tile, causal dK/dV CTAs from the first key tile, a window without
// causality the other way round).  exp is expf and P a true quotient, as in
// the forward.  The loads need D % 4 == 0 and 16-byte aligned tensors (the
// wrapper pads D with zero columns); the columns past D are zero in every
// piece.
//
// The entry point returns cudaGetLastError() so the wrapper can raise on a
// refused launch.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "flash_tiles.cuh"
#include "sm90.cuh"

namespace {

using flash::kPieces;
using flash::kTileRows;
using flash::kWarpgroup;

constexpr int kMaxHeadDim = 256;
constexpr int kMaxSmemBytes = 232448;  // dynamic shared memory a block may use on sm_90
constexpr float kMaskValue = -0.7f * FLT_MAX;

// What a CTA knows of its problem.
struct Problem {
  int batch, seq_q, seq_k, heads, kv_heads, head_dim, groups, total_rows, causal, window;
  float scale;
};

// Rows of a streamed tile at the padded width DP.
template <int DP>
__host__ __device__ constexpr int stream_rows() {
  return DP == 64 ? 64 : DP == 128 ? 32 : 16;
}
// Whether the dK/dV kernel walks its rows once, holding dK's and dV's
// accumulators together, with Q and dO in two buffers (up to DP 128, where
// the registers allow), or twice (dV, then dK) through one buffer.
template <int DP>
__host__ __device__ constexpr bool one_walk() {
  return DP <= 128;
}
// Rows of a tile the dK/dV kernel streams.
template <int DP>
__host__ __device__ constexpr int dkdv_rows() {
  return DP == 64 ? 32 : 16;
}
// The rows kernel's buffers of streamed tiles: two wherever they fit beside
// the held tiles (a tile's split then runs under the products of the tile
// before), one at DP 256.  The dK/dV kernel's: Q's and dO's in its one walk,
// one in its two walks (alternating two there made ptxas spill, and ran
// 10-38 % slower on an H100).
template <int DP>
__host__ __device__ constexpr int stream_buffers() {
  return DP == 256 ? 1 : 2;
}
template <int DP>
__host__ __device__ constexpr int dkdv_buffers() {
  return one_walk<DP>() ? 2 : 1;
}
// Two held 64-row tiles and `buffers` streamed tiles of T rows, each as three
// pieces, the streamed rows' statistics (m, L, Delta), alignment.
__host__ __device__ constexpr int smem_bytes(int dp, int t, int buffers) {
  return kPieces * (2 * kTileRows + buffers * t) * dp * 2 + 3 * t * 4 + 1024;
}
template <int DP>
__host__ __device__ constexpr int rows_smem() {
  return smem_bytes(DP, stream_rows<DP>(), stream_buffers<DP>());
}
template <int DP>
__host__ __device__ constexpr int dkdv_smem() {
  return smem_bytes(DP, dkdv_rows<DP>(), dkdv_buffers<DP>());
}
static_assert(rows_smem<256>() <= kMaxSmemBytes && dkdv_smem<256>() <= kMaxSmemBytes &&
              rows_smem<192>() <= kMaxSmemBytes && dkdv_smem<192>() <= kMaxSmemBytes,
              "f32 K4 backward pieces exceed shared memory");
template <int DP>
__host__ __device__ constexpr int min_ctas() {
  return DP == 64 ? 2 : 1;
}
// The rows (dK, dV) or keys (dQ) an accumulator takes before it is added
// into the output: 24 wgmma sums at every width.
constexpr int kFlushRows = kTileRows;

__device__ __forceinline__ int64_t plane(const Problem& pb) {
  return static_cast<int64_t>(pb.batch) * pb.heads * pb.seq_q;
}

__device__ __forceinline__ int64_t stat_index(const Problem& pb, int b, int kvh, int rho) {
  const int i = rho / pb.groups, g = rho % pb.groups;
  return (static_cast<int64_t>(b) * pb.heads + kvh * pb.groups + g) * pb.seq_q + i;
}

// Row rho of x (q or dO, (B, Sq, H, D)) of kv head kvh, or null past the end.
__device__ __forceinline__ const float* row_of(const float* x, const Problem& pb, int b, int kvh,
                                               int rho) {
  if (rho >= pb.total_rows) return nullptr;
  const int i = rho / pb.groups, g = rho - i * pb.groups;
  return x + ((static_cast<int64_t>(b) * pb.seq_q + i) * pb.heads + kvh * pb.groups + g) *
                 pb.head_dim;
}

// Key `key` of x (k or v, (B, Sk, KVH, D)), or null past Sk.
__device__ __forceinline__ const float* key_of(const float* x, const Problem& pb, int b, int kvh,
                                               int key) {
  if (key >= pb.seq_k) return nullptr;
  return x + ((static_cast<int64_t>(b) * pb.seq_k + key) * pb.kv_heads + kvh) * pb.head_dim;
}

// Whether the pairs of rows rho0 .. rho0 + nr - 1 and keys k0 .. k0 + nk - 1
// hold one the masks drop, a row past the end or a key past Sk.
__device__ __forceinline__ bool tile_masked(const Problem& pb, int rho0, int nr, int k0, int nk) {
  const int first_pos = rho0 / pb.groups;
  const int last_pos = (min(rho0 + nr, pb.total_rows) - 1) / pb.groups;
  return k0 + nk > pb.seq_k || rho0 + nr > pb.total_rows ||
         (pb.causal && k0 + nk - 1 > first_pos) || (pb.window && k0 <= last_pos - pb.window);
}

// Whether the masks keep (row at position pos, key); present: the row and
// the key exist.
__device__ __forceinline__ bool kept(const Problem& pb, bool present, int key, int pos) {
  bool keep = present;
  if (pb.causal) keep = keep && key <= pos;
  if (pb.window) keep = keep && key > pos - pb.window;
  return keep;
}

// The tile index of the CTA launched o-th of n: longest walks first.
__device__ __forceinline__ int longest_first(int o, int n, bool reverse) {
  return reverse ? n - 1 - o : o;
}

// Sum over the 4 lanes that hold one accumulator row; every lane gets the
// same bits.
__device__ __forceinline__ float row_total(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
}

// Row h (0, 1) of a thread's share of a 64 x DP accumulator, times mult,
// into the D columns of dst (this thread's columns 8 jj + col, + 1), added
// to what dst holds unless first.  Eight pairs are read at a time, each
// eight after the sums of the eight before (an opaque dependence on them):
// reads of a whole row at once would take DP / 2 more registers.
template <int DP>
__device__ __forceinline__ void add_row(float* dst, const float (&acc)[DP / 2], int h, int col,
                                        int d, float mult, bool first) {
#pragma unroll
  for (int g = 0; g < DP / 64; ++g) {
    if (64 * g + col >= d) break;
    float2 x[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int jj = 8 * g + t;
      x[t] = make_float2(acc[4 * jj + 2 * h] * mult, acc[4 * jj + 2 * h + 1] * mult);
    }
    if (!first) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int c = 64 * g + 8 * t + col;  // D is even: c < D leaves c + 1 < D
        if (c < d) {
          const float2 sum = *reinterpret_cast<const float2*>(dst + c);
          x[t] = make_float2(sum.x + x[t].x, sum.y + x[t].y);
        }
      }
      asm volatile("" : "+l"(dst) : "f"(x[0].x));
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int c = 64 * g + 8 * t + col;
      if (c < d) *reinterpret_cast<float2*>(dst + c) = x[t];
    }
  }
}

// The 64-row tiles a dK/dV CTA walks for its 64 keys from k0: those whose
// masks let a row see one of the keys (causal: from the first key on;
// windowed: up to the last key + window - 1), then those holding fully
// masked rows (a window past every key), which give dV their uniform P.
struct RowWalk {
  int t_lo, t_hi, f_lo, n;
  __device__ RowWalk(const Problem& pb, int k0) {
    const int G = pb.groups;
    const int k_last = min(k0 + kTileRows, pb.seq_k) - 1;
    const int lo = pb.causal ? k0 : 0;
    const int hi = pb.window ? min(pb.seq_q, k_last + pb.window) : pb.seq_q;
    t_lo = lo * G / kTileRows;
    t_hi = hi > lo ? (hi * G + kTileRows - 1) / kTileRows : t_lo;
    const int fm = pb.window ? pb.seq_k + pb.window - 1 : pb.seq_q;  // first fully masked position
    f_lo = max(t_hi, fm * G / kTileRows);
    const int f_hi =
        fm < pb.seq_q ? max(f_lo, (pb.seq_q * G + kTileRows - 1) / kTileRows) : f_lo;
    n = (t_hi - t_lo) + (f_hi - f_lo);
  }
  __device__ int tile(int it) const {
    return it < t_hi - t_lo ? t_lo + it : f_lo + (it - (t_hi - t_lo));
  }
};

// Held tiles' pieces from x's 64 rows row(r), T rows at a time, times mult.
template <int DP, int T, typename Row>
__device__ __forceinline__ void hold(unsigned char* tile, int d, float mult, Row row) {
  flash::F32Rows<T, DP> rows;
#pragma unroll 1
  for (int r0 = 0; r0 < kTileRows; r0 += T) {
    rows.load(d, [&](int r) { return row(r0 + r); });
    rows.template store<kTileRows>(tile, r0, mult);
  }
}

// ---------------------------------------------------------------------------
// 1. dQ, L and Delta per 64 rows.

template <int DP>
__global__ void __launch_bounds__(kWarpgroup, min_ctas<DP>())
flash_bwd_f32_rows(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ stats, float* __restrict__ aux,
                   float* __restrict__ dq, Problem pb) {
  constexpr int T = stream_rows<DP>(), kFlush = kFlushRows / T, kBufs = stream_buffers<DP>();
  constexpr int kHeld = kPieces * kTileRows * DP * 2, kBuf = kPieces * T * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-aligned
  unsigned char* const q_gen = smem_raw + (base - raw);
  unsigned char* const do_gen = q_gen + kHeld;
  unsigned char* const buf_gen = do_gen + kHeld;
  const uint32_t q_tile = base, do_tile = base + kHeld, buf = base + 2 * kHeld;

  const int nbh = pb.batch * pb.kv_heads;
  const int bh = blockIdx.x % nbh, b = bh / pb.kv_heads, kvh = bh % pb.kv_heads;
  const int n_row_tiles = (pb.total_rows + kTileRows - 1) / kTileRows;
  const int rho0 = longest_first(blockIdx.x / nbh, n_row_tiles, pb.causal) * kTileRows;
  const int D = pb.head_dim, G = pb.groups, tid = threadIdx.x;

  hold<DP, T>(q_gen, D, pb.scale, [&](int r) { return row_of(q, pb, b, kvh, rho0 + r); });
  hold<DP, T>(do_gen, D, 1.0f, [&](int r) { return row_of(dout, pb, b, kvh, rho0 + r); });

  // the key tiles of T keys any row of the CTA sees (dS is 0 elsewhere)
  const int first_pos = rho0 / G;
  const int last_pos = (min(rho0 + kTileRows, pb.total_rows) - 1) / G;
  const int k_lo = pb.window ? max(0, first_pos - pb.window + 1) : 0;
  const int k_hi = pb.causal ? min(pb.seq_k, last_pos + 1) : pb.seq_k;
  const int j_lo = k_lo / T;
  const int nj = k_hi > k_lo ? (k_hi + T - 1) / T - j_lo : 0;
  // the streamed tiles in order: K of each key tile (L); V, K of each (Delta);
  // V, K of each (dQ)
  const int n_ops = 5 * nj;
  flash::F32Rows<T, DP> next;
  // streamed tile o's rows into registers
  auto load_op = [&](int o) {
    const float* x = k;
    int j = o;
    if (o >= nj) {
      const int m = (o - nj) % (2 * nj);
      j = m / 2;
      if (m % 2 == 0) x = v;
    }
    const int k0 = (j_lo + j) * T;
    next.load(D, [&](int r) { return key_of(x, pb, b, kvh, k0 + r); });
  };
  // tile `stored` from registers into its buffer (stored % kBufs: the
  // products that read that buffer before have completed, every warp past
  // them), the loads of the one after it issued behind it
  int stored = 0;
  auto store_next = [&]() {
    next.template store<T>(buf_gen + stored % kBufs * kBuf, 0, 1.0f);
    sm90::fence_proxy_async();  // the pieces' writes, before wgmma reads them
    if (stored + 1 < n_ops) load_op(stored + 1);
    ++stored;
  };
  if (n_ops) {
    load_op(0);
    store_next();
  }
  sm90::fence_proxy_async();
  __syncthreads();  // Q's and dO's pieces and the first tile in place

  // this thread's two rows (h = 0, 1) and its first key in each 8-key block
  const int ra = tid / 32 * 16 + tid % 32 / 4;
  const int col = 2 * (tid % 4);
  bool row_ok[2], masked_row[2];
  int pos[2];
  float m[2], l_fwd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = rho0 + ra + 8 * h;
    row_ok[h] = rho < pb.total_rows;
    pos[h] = rho / G;
    m[h] = 0.0f;
    l_fwd[h] = 1.0f;
    if (row_ok[h]) {
      const int64_t idx = stat_index(pb, b, kvh, rho);
      m[h] = stats[idx];
      l_fwd[h] = stats[plane(pb) + idx];
    }
    masked_row[h] = m[h] == kMaskValue;
  }
  // e = exp(S - m) of accumulator element i of the tile at key k0 (0 where
  // the key or the row is not there); keep: the masks keep the pair
  auto exp_score = [&](float s, int i, int k0, bool masked, bool& keep) -> float {
    const int h = i % 4 / 2;
    if (!masked) {
      keep = true;
      return expf(s - m[h]);
    }
    const int key = k0 + i / 4 * 8 + col + i % 2;
    const bool present = row_ok[h] && key < pb.seq_k;  // keys past Sk are not there at all
    keep = kept(pb, present, key, pos[h]);
    return present ? expf((keep ? s : kMaskValue) - m[h]) : 0.0f;
  };
  // acc = held tile x tile `used`'s rows^T, the tile's first product; with
  // two buffers the next tile is split into the other one meanwhile
  int used = 0;
  auto product = [&](float (&acc)[T / 2], uint32_t held) {
    sm90::wgmma_fence();
    flash::ss_pieces<DP, T>(acc, held, buf + used % kBufs * kBuf);
    sm90::wgmma_commit();
    if constexpr (kBufs == 2) {
      if (stored < n_ops) store_next();
    }
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
  };
  // tile `used` has had its last product: every warp past it, and with one
  // buffer the next tile goes in now
  auto release = [&]() {
    ++used;
    __syncthreads();
    if constexpr (kBufs == 1) {
      if (stored < n_ops) store_next();
      __syncthreads();
    }
  };
  float s[T / 2], dp[T / 2];

  // L: the sums of e
  float part[2] = {0.0f, 0.0f};
  for (int j = 0; j < nj; ++j) {
    product(s, q_tile);  // S = Q K^T
    release();
    const int k0 = (j_lo + j) * T;
    const bool masked = tile_masked(pb, rho0, kTileRows, k0, T);
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      bool keep;
      part[i % 4 / 2] += exp_score(s[i], i, k0, masked, keep);
    }
  }
  float norm[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = row_total(part[h]);  // every lane of the warp shuffles
    norm[h] = fmaxf(masked_row[h] ? l_fwd[h] : sum, 1e-30f);
    part[h] = 0.0f;
  }

  // dP = dO V^T, then S = Q K^T; K's tile not yet released
  auto scores = [&]() {
    product(dp, do_tile);
    release();
    product(s, q_tile);
  };
  // Delta: the sums of P dP where kept, P = e / L
  for (int j = 0; j < nj; ++j) {
    scores();
    const int k0 = (j_lo + j) * T;
    const bool masked = tile_masked(pb, rho0, kTileRows, k0, T);
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      bool keep;
      const float p = exp_score(s[i], i, k0, masked, keep) / norm[i % 4 / 2];
      if (keep) part[i % 4 / 2] = fmaf(p, dp[i], part[i % 4 / 2]);
    }
    release();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) delta[h] = row_total(part[h]);

  // dQ += dS K, dS = P (dP - Delta) where kept, each kFlush key tiles' sum
  // (times scale) added into dq in f32 (the first written) and the
  // accumulators zeroed
  float dq_acc[DP / 2];
  zero(dq_acc);
  auto flush = [&](bool first) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!row_ok[h]) continue;
      const int rho = rho0 + ra + 8 * h, i = rho / G, g = rho % G;
      add_row<DP>(dq + ((static_cast<int64_t>(b) * pb.seq_q + i) * pb.heads + kvh * G + g) * D,
                  dq_acc, h, col, D, pb.scale, first);
    }
    zero(dq_acc);
  };
  uint32_t ds[kPieces][T / 16][4];
  for (int j = 0; j < nj; ++j) {
    scores();
    const int k0 = (j_lo + j) * T;
    const bool masked = tile_masked(pb, rho0, kTileRows, k0, T);
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      bool keep;
      const float p = exp_score(s[i], i, k0, masked, keep) / norm[i % 4 / 2];
      dp[i] = keep ? p * (dp[i] - delta[i % 4 / 2]) : 0.0f;
    }
    flash::split_operand3(dp, ds);
    flash::fence_operand3(ds);
    sm90::fence_regs(dq_acc);
    sm90::wgmma_fence();
    flash::rs_pieces<DP, T / 16>(dq_acc, ds, buf + used % kBufs * kBuf);  // K's tile
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(dq_acc);
    flash::fence_operand3(ds);
    if ((j + 1) % kFlush == 0 || j + 1 == nj) flush(j < kFlush);
    release();
  }
  if (nj == 0) flush(true);  // rows that see no key: dQ = 0

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row_ok[h] && tid % 4 == 0) {  // for the dK/dV kernel: L, Delta
      const int64_t idx = stat_index(pb, b, kvh, rho0 + ra + 8 * h);
      aux[idx] = norm[h];
      aux[plane(pb) + idx] = delta[h];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV per 64 keys (a range of their row walk).

template <int DP>
__global__ void __launch_bounds__(kWarpgroup, min_ctas<DP>())
flash_bwd_f32_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ stats, const float* __restrict__ aux,
                   float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ part,
                   int splits, Problem pb) {
  constexpr bool kOneWalk = one_walk<DP>();
  constexpr int T = dkdv_rows<DP>(), kSub = kTileRows / T, kFlush = kFlushRows / T;
  constexpr int kBufs = dkdv_buffers<DP>();
  constexpr int kHeld = kPieces * kTileRows * DP * 2, kBuf = kPieces * T * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const k_gen = smem_raw + (base - raw);
  unsigned char* const v_gen = k_gen + kHeld;
  unsigned char* const buf_gen = v_gen + kHeld;  // one walk: Q's pieces, then dO's
  // the streamed rows' m, L and Delta, T each
  float* const row_stats = reinterpret_cast<float*>(buf_gen + kBufs * kBuf);
  const uint32_t k_tile = base, v_tile = base + kHeld, buf = base + 2 * kHeld;

  const int nbh = pb.batch * pb.kv_heads;
  const int sp = blockIdx.x % splits, cta = blockIdx.x / splits;
  const int bh = cta % nbh, b = bh / pb.kv_heads, kvh = bh % pb.kv_heads;
  const int n_key_tiles = (pb.seq_k + kTileRows - 1) / kTileRows;
  const int k0 = longest_first(cta / nbh, n_key_tiles, !pb.causal && pb.window) * kTileRows;
  const int D = pb.head_dim, tid = threadIdx.x;

  const RowWalk walk(pb, k0);
  const int it0 = static_cast<int>(static_cast<int64_t>(sp) * walk.n / splits);  // this range
  const int n = static_cast<int>(static_cast<int64_t>(sp + 1) * walk.n / splits) - it0;
  const int nu = n * kSub;  // row tiles of T rows (a multiple of kFlush)
  if (nu == 0) {  // no row of this range sees the keys: zero sums
    const int64_t part_plane = static_cast<int64_t>(pb.batch) * pb.seq_k * pb.kv_heads * DP;
    for (int e = tid; e < kTileRows * D; e += kWarpgroup) {
      const int r = e / D, c = e % D;
      if (k0 + r >= pb.seq_k) continue;
      const int64_t kr = (static_cast<int64_t>(b) * pb.seq_k + k0 + r) * pb.kv_heads + kvh;
      if (splits == 1) {
        dk[kr * D + c] = 0.0f;
        dv[kr * D + c] = 0.0f;
      } else {
        part[2 * sp * part_plane + kr * DP + c] = 0.0f;
        part[(2 * sp + 1) * part_plane + kr * DP + c] = 0.0f;
      }
    }
    return;
  }
  hold<DP, T>(k_gen, D, 1.0f, [&](int r) { return key_of(k, pb, b, kvh, k0 + r); });
  hold<DP, T>(v_gen, D, 1.0f, [&](int r) { return key_of(v, pb, b, kvh, k0 + r); });
  auto rows_of = [&](int u) { return walk.tile(it0 + u / kSub) * kTileRows + u % kSub * T; };
  // rows rho0 .. rho0 + T - 1 of x (q or dO) into registers, and with
  // to_stats, thread tid < T's row's m, L and Delta
  auto load_rows = [&](flash::F32Rows<T, DP>& to, const float* x, int rho0, float* to_stats) {
    to.load(D, [&](int r) { return row_of(x, pb, b, kvh, rho0 + r); });
    if (to_stats != nullptr && tid < T) {
      const int rho = rho0 + tid;
      to_stats[0] = 0.0f;
      to_stats[1] = 1.0f;
      to_stats[2] = 0.0f;
      if (rho < pb.total_rows) {
        const int64_t idx = stat_index(pb, b, kvh, rho);
        to_stats[0] = stats[idx];
        to_stats[1] = aux[idx];
        to_stats[2] = aux[plane(pb) + idx];
      }
    }
  };
  // the three pieces of rows from registers into buffer `at` (Q's times
  // scale, with their statistics into shared memory)
  auto store_rows = [&](const flash::F32Rows<T, DP>& from, int at, bool is_q,
                        const float (&next_stats)[3]) {
    from.template store<T>(buf_gen + at * kBuf, 0, is_q ? pb.scale : 1.0f);
    if (is_q && tid < T) {
#pragma unroll
      for (int p = 0; p < 3; ++p) row_stats[p * T + tid] = next_stats[p];
    }
  };

  // this thread's two keys (h = 0, 1) and its first row in each 8-row block
  const int ra = tid / 32 * 16 + tid % 32 / 4;
  const int col = 2 * (tid % 4);
  // acc = A B^T, A a held tile (K or V), B the tile in buffer `at`
  auto issue_product = [&](float (&acc)[T / 2], uint32_t held, int at) {
    flash::ss_pieces<DP, T>(acc, held, buf + at * kBuf);
  };
  // acc += A B, A's pieces from registers, B the tile in buffer `at` MN-major
  auto issue_accumulate = [&](float (&acc)[DP / 2], const uint32_t (&a)[kPieces][T / 16][4],
                              int at) {
    flash::rs_pieces<DP, T / 16>(acc, a, buf + at * kBuf);
  };
  // P^T in place of S^T of the row tile at rho0 (its rows' statistics in
  // shared memory); with ds, dS^T in place of dP^T
  auto gradient = [&](float (&st)[T / 2], float (&dpt)[T / 2], int rho0, bool ds) {
    const bool masked = tile_masked(pb, rho0, T, k0, kTileRows);
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      const int r = i / 4 * 8 + col + i % 2, key = k0 + ra + 8 * (i % 4 / 2);
      bool keep = true, present = true;
      if (masked) {
        const int rho = rho0 + r;
        present = rho < pb.total_rows && key < pb.seq_k;
        keep = kept(pb, present, key, rho / pb.groups);
      }
      const float e = present ? expf((keep ? st[i] : kMaskValue) - row_stats[r]) : 0.0f;
      const float p = e / row_stats[T + r];
      if (ds) dpt[i] = keep ? p * (dpt[i] - row_stats[2 * T + r]) : 0.0f;
      st[i] = p;
    }
  };
  // kFlushRows rows' sums added into dk or dv (or this range's plane of
  // part) in f32, the first written, and the accumulators zeroed
  auto flush = [&](float* out, float (&acc)[DP / 2], int which, bool first) {
    const int64_t part_plane = static_cast<int64_t>(pb.batch) * pb.seq_k * pb.kv_heads * DP;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + ra + 8 * h;
      if (key >= pb.seq_k) continue;
      const int64_t kr = (static_cast<int64_t>(b) * pb.seq_k + key) * pb.kv_heads + kvh;
      add_row<DP>(splits == 1 ? out + kr * D : part + (2 * sp + which) * part_plane + kr * DP,
                  acc, h, col, D, 1.0f, first);
    }
    zero(acc);
  };
  float st[T / 2], dpt[T / 2];

  if constexpr (kOneWalk) {
    // each row tile once: Q into buffer 0, dO into buffer 1 (both read one
    // tile ahead), S^T and dP^T, then dV += P^T dO and dK += dS^T Q
    flash::F32Rows<T, DP> next_q, next_do;
    float next_stats[3];
    load_rows(next_q, q, rows_of(0), next_stats);
    load_rows(next_do, dout, rows_of(0), nullptr);
    sm90::fence_proxy_async();
    __syncthreads();  // K's and V's pieces in place
    float dk_acc[DP / 2], dv_acc[DP / 2];
    zero(dk_acc);
    zero(dv_acc);
    uint32_t pa[kPieces][T / 16][4], da[kPieces][T / 16][4];
    for (int u = 0; u < nu; ++u) {
      store_rows(next_q, 0, true, next_stats);
      store_rows(next_do, 1, false, next_stats);
      sm90::fence_proxy_async();  // the pieces' writes, before wgmma reads them
      if (u + 1 < nu) {
        load_rows(next_q, q, rows_of(u + 1), next_stats);
        load_rows(next_do, dout, rows_of(u + 1), nullptr);
      }
      __syncthreads();
      sm90::wgmma_fence();
      issue_product(st, k_tile, 0);    // S^T = K Q^T
      issue_product(dpt, v_tile, 1);   // dP^T = V dO^T
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);
      gradient(st, dpt, rows_of(u), true);
      flash::split_operand3(st, pa);
      flash::split_operand3(dpt, da);
      flash::fence_operand3(pa);
      flash::fence_operand3(da);
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
      sm90::wgmma_fence();
      issue_accumulate(dv_acc, pa, 1);  // dV += P^T dO
      issue_accumulate(dk_acc, da, 0);  // dK += dS^T Q
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
      flash::fence_operand3(pa);
      flash::fence_operand3(da);
      if ((u + 1) % kFlush == 0) {
        flush(dv, dv_acc, 1, u < kFlush);
        flush(dk, dk_acc, 0, u < kFlush);
      }
      __syncthreads();  // every warp's products have read both buffers
    }
  } else {
    // the streamed tiles in order through the one buffer: Q, dO of each row
    // tile (dV); dO, Q of each (dK)
    const int n_ops = 4 * nu;
    auto op_is_q = [&](int o) { return (o % 2 == 0) == (o < 2 * nu); };
    flash::F32Rows<T, DP> next;
    float next_stats[3];
    auto load_op = [&](int o) {  // a dO tile's rows are the Q tile's: the same statistics
      load_rows(next, op_is_q(o) ? q : dout, rows_of(o % (2 * nu) / 2), next_stats);
    };
    load_op(0);
    // the next tile into the buffer (the products that read the tile before
    // have completed, every warp past them), the loads of the one after it
    // issued behind it
    int op = 0;
    auto stage = [&]() {
      store_rows(next, 0, op_is_q(op), next_stats);
      sm90::fence_proxy_async();  // the pieces' writes, before wgmma reads them
      if (op + 1 < n_ops) load_op(op + 1);
      ++op;
      __syncthreads();
    };
    sm90::fence_proxy_async();
    __syncthreads();  // K's and V's pieces in place
    auto product = [&](float (&acc)[T / 2], uint32_t held) {
      sm90::wgmma_fence();
      issue_product(acc, held, 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(acc);
    };
    auto accumulate = [&](float (&acc)[DP / 2], uint32_t (&a)[kPieces][T / 16][4]) {
      flash::fence_operand3(a);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
      issue_accumulate(acc, a, 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(acc);
      flash::fence_operand3(a);
    };

    float acc[DP / 2];
    uint32_t a[kPieces][T / 16][4];
    // dV += P^T dO, flushed every kFlushRows rows
    zero(acc);
    for (int u = 0; u < nu; ++u) {
      stage();  // Q
      product(st, k_tile);  // S^T = K Q^T
      __syncthreads();  // every warp's S^T has read Q
      gradient(st, dpt, rows_of(u), false);
      flash::split_operand3(st, a);
      stage();  // dO
      accumulate(acc, a);
      if ((u + 1) % kFlush == 0) flush(dv, acc, 1, u < kFlush);
      __syncthreads();  // every warp's P^T dO has read dO
    }
    // dK += dS^T Q, flushed every kFlushRows rows
    for (int u = 0; u < nu; ++u) {
      stage();  // dO
      product(dpt, v_tile);  // dP^T = V dO^T
      __syncthreads();
      stage();  // Q
      product(st, k_tile);
      gradient(st, dpt, rows_of(u), true);
      flash::split_operand3(dpt, a);
      accumulate(acc, a);
      if ((u + 1) % kFlush == 0) flush(dk, acc, 0, u < kFlush);
      __syncthreads();  // every warp's dS^T Q has read Q
    }
  }
}

// dk and dv: the `splits` ranges' sums of flash_bwd_f32_dkdv in part
// (splits, 2, rows, DP) added in order (two calls give the same bits); rows
// = B Sk KVH, two columns a thread.
__global__ void __launch_bounds__(256)
flash_bwd_f32_split_sum(const float* __restrict__ part, float* __restrict__ dk,
                        float* __restrict__ dv, int64_t rows, int d, int dp, int splits) {
  const int64_t plane = rows * dp, pairs = rows * (d / 2);
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; e < pairs;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = e / (d / 2);
    const int c = 2 * static_cast<int>(e % (d / 2));
    float2 gk = make_float2(0.0f, 0.0f), gv = gk;
    for (int s = 0; s < splits; ++s) {
      const float2 a = *reinterpret_cast<const float2*>(part + 2 * s * plane + r * dp + c);
      const float2 w = *reinterpret_cast<const float2*>(part + (2 * s + 1) * plane + r * dp + c);
      gk.x += a.x;
      gk.y += a.y;
      gv.x += w.x;
      gv.y += w.y;
    }
    *reinterpret_cast<float2*>(dk + r * d + c) = gk;
    *reinterpret_cast<float2*>(dv + r * d + c) = gv;
  }
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v, const float* dout,
                   const float* stats, float* aux, float* dq, float* dk, float* dv, float* part,
                   int splits, const Problem& pb, cudaStream_t stream) {
  constexpr int smem = rows_smem<DP>(), kv_smem = dkdv_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_f32_rows<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_f32_dkdv<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err != cudaSuccess) return err;
  const int64_t nbh = static_cast<int64_t>(pb.batch) * pb.kv_heads;
  const int64_t row_ctas = nbh * ((pb.total_rows + kTileRows - 1) / kTileRows);
  const int64_t key_ctas = nbh * ((pb.seq_k + kTileRows - 1) / kTileRows) * splits;
  if (row_ctas > INT32_MAX || key_ctas > INT32_MAX) return cudaErrorInvalidValue;
  flash_bwd_f32_rows<DP><<<static_cast<unsigned>(row_ctas), kWarpgroup, smem, stream>>>(
      q, k, v, dout, stats, aux, dq, pb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_f32_dkdv<DP><<<static_cast<unsigned>(key_ctas), kWarpgroup, kv_smem, stream>>>(
      q, k, v, dout, stats, aux, dk, dv, part, splits, pb);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t rows = static_cast<int64_t>(pb.batch) * pb.seq_k * pb.kv_heads;
  const int64_t blocks = std::min<int64_t>((rows * (pb.head_dim / 2) + 255) / 256, 4096);
  flash_bwd_f32_split_sum<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      part, dk, dv, rows, pb.head_dim, DP, splits);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

const char* flash_attention_f32_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, KVH, D) in float32,
// contiguous, on the card, 1 <= D <= 256, D % 4 == 0, 16-byte aligned;
// stats (2, B, H, Sq) f32: the forward's m, then l; aux (2, B, H, Sq) f32
// scratch (the rows' L and Delta for the dK/dV kernel).  splits: the ranges
// each key tile's row walk is cut into; with more than one, part is
// (splits, 2, B, Sk, KVH, DP) f32 scratch (DP the padded width: 64, 128,
// 192 or 256), else null.
int flash_attention_f32_backward_launch(const void* q, const void* k, const void* v,
                                        const void* dout, const float* stats, float* aux,
                                        void* dq, void* dk, void* dv, float* part, int batch,
                                        int seq_q, int seq_k, int heads, int kv_heads,
                                        int head_dim, int causal, int window, int splits,
                                        float scale, void* stream) {
  if (batch <= 0 || seq_q <= 0 || seq_k <= 0 || kv_heads <= 0 || heads % kv_heads ||
      head_dim < 1 || head_dim > kMaxHeadDim || head_dim % 4 ||
      static_cast<int64_t>(seq_q) * (heads / kv_heads) > (int64_t{1} << 30) || splits < 1 ||
      splits > 65535 || (splits > 1) != (part != nullptr) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout) || !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem pb{batch, seq_q, seq_k, heads, kv_heads, head_dim, heads / kv_heads,
                   seq_q * (heads / kv_heads), causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K4_F32_BWD(DP)                                                                       \
  launch<DP>(static_cast<const float*>(q), static_cast<const float*>(k),                      \
             static_cast<const float*>(v), static_cast<const float*>(dout), stats, aux,       \
             static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), part, \
             splits, pb, s)
  if (head_dim <= 64) return static_cast<int>(K4_F32_BWD(64));
  if (head_dim <= 128) return static_cast<int>(K4_F32_BWD(128));
  if (head_dim <= 192) return static_cast<int>(K4_F32_BWD(192));
  return static_cast<int>(K4_F32_BWD(256));
#undef K4_F32_BWD
}

}  // extern "C"
