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
// bf16 at padded widths DP 64 and 128 (every D <= 128; tinyllama, qwen3-moe
// and every phase-9 rank) runs on wgmma (csrc/flash_tiles.cuh), one
// warpgroup a CTA, in two launches:
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
//  Both grids are launched longest walk first: causal dK/dV CTAs from the
//  first key tile on, causal row CTAs from the last row tile back, and a
//  window without causality the other way round.  exp is the MUFU's 2^x of
//  scores scaled by scale * log2(e).  P and dS enter their products as two bf16
//  operands each (the value and its rounding's remainder): D 1 under
//  cancellation needs them, and D 1 .. 64 share the DP 64 kernel.  P is
//  e / L with L the row's own sum, so a row that sees one key has e == L and
//  P = 1 exactly (the rows kernel tests e == L; elsewhere it multiplies by
//  1 / L, within one rounding of the quotient).
//
// bf16 at DP 192 and 256 (stablelm's D 160, recurrentgemma's 256) and f32
// at every width keep the first kernels (PR 23), three launches:
//  1. flash_bwd_rows_kernel<kDelta = true>, a CTA per (batch, kv head, 64
//     rows): walks the key tiles the forward walks (and from the window's
//     first key on), recomputes S and dP, and sums P * dP per row: Delta.
//  2. flash_bwd_dkdv_kernel, a CTA per (batch, kv head, tile of KT keys):
//     the walk of the wgmma kernel above; recomputes S and dP, forms P and
//     dS, and accumulates dV += P^T dO and dK += dS^T Q in registers.
//  3. flash_bwd_rows_kernel<kDelta = false>: as kernel 1, accumulating
//     dQ += dS K.
// There, bf16 runs mma.sync m16n8k16 on the tensor cores with f32
// accumulators (one warpgroup cannot hold 2 x 64 x DP f32 accumulators of
// dK and dV past DP 128); f32 runs the same fragment layout on the CUDA
// cores in IEEE f32 FMA (no TF32), q scaled before the product as in the
// forward: it is the path of the parity checks.  Each CTA is 8 warps.
// Tiles live in shared memory, padded by 16 bytes a row so that the
// fragment loads meet no bank conflicts; the operands that are read along
// their rows (dO, Q and K as the B operand of dV, dK and dQ) go through
// ldmatrix.trans in bf16.  Key tiles are 64 keys up to DP 128 and 32 past
// it, which keeps the f32 kernels within the 232,448 bytes of shared
// memory a block may use (217,856 at DP 256).
//
// Head dims: any D from 1 to 256, at padded widths DP of 16, 32, 64, 128,
// 192, 256 (bf16: 64, 128, 192, 256) whose extra columns are zero in shared
// memory.  bf16 needs D % 8 == 0 and 16-byte aligned tensors (the wrapper
// pads).
//
// Bound: operations, at the bf16 tensor-core rate (989 TFLOP/s) for bf16
// and the 67 TFLOP/s f32 rate otherwise; the least work is 2.5x the
// forward's kernel_flops, against reads of q, k, v, dO and writes of dq,
// dk, dv.  The wgmma kernels form S three times and dP twice a (row tile,
// key tile) pair, and with the remainders run 13 tile products where the
// forward runs 2 (backward_flops in kernels/flash_attention/ops.py).
//
// The entry point returns cudaGetLastError() so the wrapper can raise on a
// refused launch.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_tiles.cuh"
#include "sm90.cuh"

namespace {

constexpr int kMaxHeadDim = 256;
constexpr int kMaxSmemBytes = 232448;  // dynamic shared memory a block may use on sm_90
constexpr int kRows = 64;              // query rows (position, group) of a row tile
constexpr int kThreads = 256;          // 8 warps
constexpr float kMaskValue = -0.7f * FLT_MAX;

using bf16 = __nv_bfloat16;

// elements of row padding: 16 bytes
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / static_cast<int>(sizeof(T));
}
// keys of a key tile: 64, or 32 past DP 128 (shared memory)
template <int DP> __host__ __device__ constexpr int key_tile() { return DP <= 128 ? 64 : 32; }

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8x8 bf16 matrices (rows k .. k + 15, 8 columns from p), transposed:
// the B fragment of m16n8k16 for a B stored with its n columns contiguous.
// Lanes 0-15 name the 16 rows.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(sm90::smem_u32(p)));
}

// One warp: acc[nt] += A (16 x kdim) B (kdim x 8 NT), in mma.sync's m16n8
// fragment layout: lane (gid = lane / 4, tig = lane % 4) holds rows gid and
// gid + 8 and columns 2 tig, 2 tig + 1 of each 8-column tile nt, as
// acc[nt][0, 1] (row gid) and acc[nt][2, 3] (row gid + 8).  A(r, k) =
// a[r * lda + k]; B(k, n) = b[n * ldb + k] (kBRows false: each column of B
// contiguous along k) or b[k * ldb + n] (kBRows true).  kdim % 16 == 0.
// f32: the CUDA cores, sums in k order.
template <int NT, bool kBRows>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* a, int lda,
                                         const float* b, int ldb, int kdim) {
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const float* a0p = a + gid * lda;
  const float* a1p = a + (gid + 8) * lda;
#pragma unroll 4
  for (int k = 0; k < kdim; ++k) {
    const float a0 = a0p[k], a1 = a1p[k];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * tig;
      const float b0 = kBRows ? b[k * ldb + n] : b[n * ldb + k];
      const float b1 = kBRows ? b[k * ldb + n + 1] : b[(n + 1) * ldb + k];
      acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
      acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
      acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
      acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
    }
  }
}

// bf16: the tensor cores.  A's pairs along k are 32-bit loads; B's too when
// its columns run along k, else ldmatrix.trans (rows 16-byte aligned).
template <int NT, bool kBRows>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const bf16* a, int lda,
                                         const bf16* b, int ldb, int kdim) {
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  for (int k0 = 0; k0 < kdim; k0 += 16) {
    uint32_t af[4];
    af[0] = ld32(a + gid * lda + k0 + 2 * tig);
    af[1] = ld32(a + (gid + 8) * lda + k0 + 2 * tig);
    af[2] = ld32(a + gid * lda + k0 + 8 + 2 * tig);
    af[3] = ld32(a + (gid + 8) * lda + k0 + 8 + 2 * tig);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b0, b1;
      if constexpr (kBRows) {
        ldmatrix_x2_trans(b0, b1, b + (k0 + lane % 16) * ldb + nt * 8);
      } else {
        const bf16* col = b + (nt * 8 + gid) * ldb + k0 + 2 * tig;
        b0 = ld32(col);
        b1 = ld32(col + 8);
      }
      mma_bf16(acc[nt], af, b0, b1);
    }
  }
}

// Rows [0, n_rows) of a tile of DP columns with row stride ld: row r from
// row_ptr(r) (null: zeros), its first d columns, times mult (f32 only);
// the other columns zero.
template <int DP, typename RowPtr>
__device__ __forceinline__ void load_rows(float* dst, int ld, int n_rows, int d, float mult,
                                          RowPtr row_ptr) {
  for (int e = threadIdx.x; e < n_rows * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    const float* src = row_ptr(r);
    dst[r * ld + c] = (src != nullptr && c < d) ? src[c] * mult : 0.0f;
  }
}

// bf16: 16-byte copies of whole 8-column chunks (d % 8 == 0).
template <int DP, typename RowPtr>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, int n_rows, int d, float,
                                          RowPtr row_ptr) {
  constexpr int kChunks = DP / 8;
  for (int e = threadIdx.x; e < n_rows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bf16* src = row_ptr(r);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (src != nullptr && 8 * c < d) val = *reinterpret_cast<const uint4*>(src + 8 * c);
    *reinterpret_cast<uint4*>(dst + r * ld + 8 * c) = val;
  }
}

// What a CTA knows of its problem.
struct Problem {
  int batch, seq_q, seq_k, heads, kv_heads, head_dim, groups, total_rows, causal, window;
  float scale;
};

// The 64 rows of row tile rho0 of (b, kvh): their q (or dO) rows and their
// statistics' index (b, kvh * G + g, i) in (B, H, Sq).
template <typename T>
__device__ __forceinline__ const T* row_of(const T* x, const Problem& pb, int b, int kvh, int rho) {
  if (rho >= pb.total_rows) return nullptr;
  const int i = rho / pb.groups, g = rho % pb.groups;
  return x + ((static_cast<int64_t>(b) * pb.seq_q + i) * pb.heads + kvh * pb.groups + g) *
                 pb.head_dim;
}

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

// The tile's rows' m and, where aux holds them, L and Delta (aux (2, B, H,
// Sq): L, then Delta) into shared memory; without aux L = 1, Delta = 0.
// Rows past the end: P = 0 there anyway.
__device__ __forceinline__ void load_stats(float* m_row, float* n_row, float* d_row,
                                           const float* stats, const float* aux,
                                           const Problem& pb, int b, int kvh, int rho0) {
  const int r = threadIdx.x;
  if (r >= kRows) return;
  const int rho = rho0 + r;
  float m = 0.0f, n = 1.0f, dl = 0.0f;
  if (rho < pb.total_rows) {
    const int64_t idx = stat_index(pb, b, kvh, rho);
    m = stats[idx];
    if (aux != nullptr) {
      n = aux[idx];
      dl = aux[plane(pb) + idx];
    }
  }
  m_row[r] = m;
  n_row[r] = n;
  d_row[r] = dl;
}

// S = Q K^T (and with kDp dP = dO V^T) for the 64 rows (from rho0) and KT
// keys (from k0) in shared memory, warp (wr, wc) of a 4 x 2 grid taking
// rows 16 wr and keys wc KT / 2.  Each element goes to out(row, key, a, b)
// (tile coordinates): with kDp a = P = exp(S - m) / L and b = dS = P (dP -
// Delta) (0 where masked); without, a = exp(S - m), b = 0.  s_scale: scale
// for bf16 (the forward scales the f32 scores), 1 for f32 (q was scaled as
// it was loaded).
template <typename T, int DP, int KT, bool kDp, typename Out>
__device__ __forceinline__ void scores(const T* qs, const T* dos, const T* ks, const T* vs,
                                       int ld, const float* m_row, const float* n_row,
                                       const float* d_row, const Problem& pb, int rho0, int k0,
                                       float s_scale, Out out) {
  constexpr int NT = KT / 16;
  const int warp = threadIdx.x / 32, wr = warp % 4, wc = warp / 4;
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  float s[NT][4], dp[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
  warp_mma<NT, false>(s, qs + 16 * wr * ld, ld, ks + wc * (KT / 2) * ld, ld, DP);
  if constexpr (kDp)
    warp_mma<NT, false>(dp, dos + 16 * wr * ld, ld, vs + wc * (KT / 2) * ld, ld, DP);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * wr + gid + 8 * h;
    const int rho = rho0 + r;
    const bool row_ok = rho < pb.total_rows;
    const int pos = rho / pb.groups;
    const float m = m_row[r], n = n_row[r], delta = d_row[r];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kl = wc * (KT / 2) + nt * 8 + 2 * tig + u;
        const int key = k0 + kl;
        const bool present = row_ok && key < pb.seq_k;  // keys past Sk are not there at all
        bool keep = present;
        if (pb.causal) keep = keep && key <= pos;
        if (pb.window) keep = keep && key > pos - pb.window;
        const float x = keep ? s[nt][2 * h + u] * s_scale : kMaskValue;
        const float e = present ? expf(x - m) : 0.0f;
        if constexpr (kDp) {
          const float p = e / n;
          out(r, kl, p, keep ? p * (dp[nt][2 * h + u] - delta) : 0.0f);
        } else {
          out(r, kl, e, 0.0f);
        }
      }
  }
}

// v as a product's operand: bf16 keeps its rounding's remainder in a second
// operand (hi + lo), so that the products of P and dS stay near f32 where a
// row's terms cancel; f32 stores v whole.
template <typename T>
__device__ __forceinline__ void store_operand(T* hi, T* lo, float v) {
  const T h = from_f32<T>(v);
  *hi = h;
  if constexpr (sizeof(T) == 2) *lo = from_f32<T>(v - to_f32(h));
}

// Per-row sums of a value each lane holds for rows gid and gid + 8 of its
// warp's 16 (scores' warp grid: rows warp % 4, key halves warp / 4): over
// the 4 lanes of a row, then the two key halves in order, into sums[row].
// halves: 2 * kRows floats of scratch.
__device__ __forceinline__ void row_sums(float (&part)[2], float* halves, float* sums) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
    part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
  }
  if (lane % 4 == 0) {
    float* half = halves + (warp / 4) * kRows + 16 * (warp % 4) + gid;
    half[0] = part[0];
    half[8] = part[1];
  }
  __syncthreads();
  if (threadIdx.x < kRows) sums[threadIdx.x] = halves[threadIdx.x] + halves[kRows + threadIdx.x];
  __syncthreads();
}

template <typename T>
__host__ __device__ constexpr int parts() {
  return sizeof(T) == 2 ? 2 : 1;
}

template <typename T, int DP>
constexpr int dkdv_smem_bytes() {
  constexpr int ld = DP + pad<T>(), ldp = kRows + pad<T>(), kt = key_tile<DP>();
  return (2 * kt * ld + 2 * kRows * ld + 2 * parts<T>() * kt * ldp) *
             static_cast<int>(sizeof(T)) + 3 * kRows * 4;
}

template <typename T, int DP>
constexpr int rows_smem_bytes() {
  constexpr int ld = DP + pad<T>(), lds = key_tile<DP>() + pad<T>(), kt = key_tile<DP>();
  return (2 * kRows * ld + 2 * kt * ld + parts<T>() * kRows * lds) *
             static_cast<int>(sizeof(T)) + 5 * kRows * 4;
}

static_assert(dkdv_smem_bytes<float, kMaxHeadDim>() <= kMaxSmemBytes, "f32 dK/dV tiles");
static_assert(rows_smem_bytes<float, kMaxHeadDim>() <= kMaxSmemBytes, "f32 row tiles");
static_assert(dkdv_smem_bytes<float, 128>() <= kMaxSmemBytes, "f32 dK/dV tiles at DP 128");
static_assert(dkdv_smem_bytes<bf16, kMaxHeadDim>() <= kMaxSmemBytes, "bf16 dK/dV tiles");

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ stats,
                      const float* __restrict__ aux, T* __restrict__ dk, T* __restrict__ dv,
                      Problem pb) {
  constexpr int KT = key_tile<DP>();
  constexpr int ld = DP + pad<T>(), ldp = kRows + pad<T>();
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int WK = KT / 16, WD = 8 / WK, DW = DP / WD, NT = DW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [KT][ld] keys
  T* vs = ks + KT * ld;                    // [KT][ld] values
  T* qs = vs + KT * ld;                    // [kRows][ld] q rows (f32: scaled)
  T* dos = qs + kRows * ld;                // [kRows][ld] dO rows
  T* pt = dos + kRows * ld;                // [parts][KT][ldp] P^T (bf16: hi, lo)
  T* dst = pt + parts<T>() * KT * ldp;     // [parts][KT][ldp] dS^T
  float* m_row = reinterpret_cast<float*>(dst + parts<T>() * KT * ldp);
  float* n_row = m_row + kRows;
  float* d_row = n_row + kRows;

  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * KT;
  const int D = pb.head_dim;
  auto kv_row = [&](const T* x) {
    return [&, x](int r) -> const T* {
      if (k0 + r >= pb.seq_k) return nullptr;
      return x + ((static_cast<int64_t>(b) * pb.seq_k + k0 + r) * pb.kv_heads + kvh) * D;
    };
  };
  load_rows<DP>(ks, ld, KT, D, 1.0f, kv_row(k));
  load_rows<DP>(vs, ld, KT, D, 1.0f, kv_row(v));

  const RowWalk walk(pb, k0, KT);

  const int warp = threadIdx.x / 32, wk = warp % WK, wd = warp / WK;
  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.0f;

  for (int it = 0; it < walk.n; ++it) {
    const int rho0 = walk.tile(it) * kRows;
    __syncthreads();  // the previous tile's rows, P and dS are no longer read
    load_rows<DP>(qs, ld, kRows, D, kF32 ? pb.scale : 1.0f,
                  [&](int r) { return row_of(q, pb, b, kvh, rho0 + r); });
    load_rows<DP>(dos, ld, kRows, D, 1.0f,
                  [&](int r) { return row_of(dout, pb, b, kvh, rho0 + r); });
    load_stats(m_row, n_row, d_row, stats, aux, pb, b, kvh, rho0);
    __syncthreads();
    scores<T, DP, KT, true>(qs, dos, ks, vs, ld, m_row, n_row, d_row, pb, rho0, k0,
                            kF32 ? 1.0f : pb.scale, [&](int r, int kl, float p, float ds) {
                              store_operand(&pt[kl * ldp + r], &pt[(KT + kl) * ldp + r], p);
                              store_operand(&dst[kl * ldp + r], &dst[(KT + kl) * ldp + r], ds);
                            });
    __syncthreads();
#pragma unroll
    for (int part = 0; part < parts<T>(); ++part) {
      warp_mma<NT, true>(dv_acc, pt + (part * KT + 16 * wk) * ldp, ldp, dos + wd * DW, ld, kRows);
      warp_mma<NT, true>(dk_acc, dst + (part * KT + 16 * wk) * ldp, ldp, qs + wd * DW, ld, kRows);
    }
  }

  // f32 multiplied by scale as q was loaded; bf16 scales here
  const float dk_mult = kF32 ? 1.0f : pb.scale;
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * wk + gid + 8 * h;
    if (key >= pb.seq_k) continue;
    const int64_t base = ((static_cast<int64_t>(b) * pb.seq_k + key) * pb.kv_heads + kvh) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int d = wd * DW + nt * 8 + 2 * tig + u;
        if (d < D) {
          dk[base + d] = from_f32<T>(dk_acc[nt][2 * h + u] * dk_mult);
          dv[base + d] = from_f32<T>(dv_acc[nt][2 * h + u]);
        }
      }
  }
}

// kDelta: per row, L = sum of exp(S - m) over the keys (the forward's l
// where the row sees no key, m = MASK), then Delta = sum of P dP over the
// kept keys with P = exp(S - m) / L, into aux (2, B, H, Sq); else dQ =
// scale dS K of those rows, from aux.
template <typename T, int DP, bool kDelta>
__global__ void __launch_bounds__(kThreads)
flash_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ stats,
                      float* __restrict__ aux, T* __restrict__ dq, Problem pb) {
  constexpr int KT = key_tile<DP>();
  constexpr int ld = DP + pad<T>(), lds = KT + pad<T>();
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int DW = DP / 2, NT = DW / 8;  // warp (wr, wd) of 4 x 2: 16 rows, DP / 2 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kRows][ld] q rows (f32: scaled)
  T* dos = qs + kRows * ld;                // [kRows][ld] dO rows
  T* ks = dos + kRows * ld;                // [KT][ld] keys
  T* vs = ks + KT * ld;                    // [KT][ld] values
  T* dss = vs + KT * ld;                   // [parts][kRows][lds] dS (bf16: hi, lo)
  float* m_row = reinterpret_cast<float*>(dss + parts<T>() * kRows * lds);
  float* n_row = m_row + kRows;            // L
  float* d_row = n_row + kRows;            // Delta (0 while kDelta sums P dP)
  float* halves = d_row + kRows;           // [2][kRows] the key halves' row sums

  const int b = blockIdx.z, kvh = blockIdx.y, rho0 = blockIdx.x * kRows;
  const int G = pb.groups, D = pb.head_dim;
  load_rows<DP>(qs, ld, kRows, D, kF32 ? pb.scale : 1.0f,
                [&](int r) { return row_of(q, pb, b, kvh, rho0 + r); });
  load_rows<DP>(dos, ld, kRows, D, 1.0f, [&](int r) { return row_of(dout, pb, b, kvh, rho0 + r); });
  load_stats(m_row, n_row, d_row, stats, kDelta ? nullptr : aux, pb, b, kvh, rho0);

  // the key tiles any row of the CTA sees (dS is 0 elsewhere)
  const int first_pos = rho0 / G;
  const int last_pos = (min(rho0 + kRows, pb.total_rows) - 1) / G;
  const int k_lo = pb.window ? max(0, first_pos - pb.window + 1) : 0;
  const int k_hi = pb.causal ? min(pb.seq_k, last_pos + 1) : pb.seq_k;
  const int t_lo = k_lo / KT;
  const int t_hi = k_hi > k_lo ? (k_hi + KT - 1) / KT : t_lo;
  auto load_keys = [&](int k0, bool values) {
    auto kv_row = [&](const T* x) {
      return [&, x](int r) -> const T* {
        if (k0 + r >= pb.seq_k) return nullptr;
        return x + ((static_cast<int64_t>(b) * pb.seq_k + k0 + r) * pb.kv_heads + kvh) * D;
      };
    };
    load_rows<DP>(ks, ld, KT, D, 1.0f, kv_row(k));
    if (values) load_rows<DP>(vs, ld, KT, D, 1.0f, kv_row(v));
  };
  const float s_scale = kF32 ? 1.0f : pb.scale;

  if constexpr (kDelta) {
    float part[2] = {0.0f, 0.0f};  // rows gid and gid + 8 of the warp's 16, this lane's keys
    for (int t = t_lo; t < t_hi; ++t) {  // L
      __syncthreads();  // the previous tile's keys are no longer read
      load_keys(t * KT, false);
      __syncthreads();
      scores<T, DP, KT, false>(qs, dos, ks, vs, ld, m_row, n_row, d_row, pb, rho0, t * KT,
                               s_scale,
                               [&](int r, int, float e, float) { part[(r % 16) / 8] += e; });
    }
    __syncthreads();
    row_sums(part, halves, n_row);
    if (threadIdx.x < kRows) {  // a row that sees no key keeps the forward's l
      const int r = threadIdx.x, rho = rho0 + r;
      if (rho < pb.total_rows) {
        const int64_t idx = stat_index(pb, b, kvh, rho);
        float n = n_row[r];
        if (m_row[r] == kMaskValue) n = stats[plane(pb) + idx];
        n = fmaxf(n, 1e-30f);
        n_row[r] = n;
        aux[idx] = n;
      } else {
        n_row[r] = 1.0f;
      }
    }
    part[0] = part[1] = 0.0f;
    for (int t = t_lo; t < t_hi; ++t) {  // Delta: dS with Delta = 0 is P dP where kept
      __syncthreads();
      load_keys(t * KT, true);
      __syncthreads();
      scores<T, DP, KT, true>(qs, dos, ks, vs, ld, m_row, n_row, d_row, pb, rho0, t * KT, s_scale,
                              [&](int r, int, float, float ds) { part[(r % 16) / 8] += ds; });
    }
    __syncthreads();
    row_sums(part, halves, d_row);
    const int r = threadIdx.x;
    if (r < kRows && rho0 + r < pb.total_rows)
      aux[plane(pb) + stat_index(pb, b, kvh, rho0 + r)] = d_row[r];
    return;
  }

  const int warp = threadIdx.x / 32, wr = warp % 4, wd = warp / 4;
  float dq_acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[nt][e] = 0.0f;
  for (int t = t_lo; t < t_hi; ++t) {
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    load_keys(t * KT, true);
    __syncthreads();
    scores<T, DP, KT, true>(qs, dos, ks, vs, ld, m_row, n_row, d_row, pb, rho0, t * KT, s_scale,
                            [&](int r, int kl, float, float ds) {
                              store_operand(&dss[r * lds + kl], &dss[(kRows + r) * lds + kl], ds);
                            });
    __syncthreads();
#pragma unroll
    for (int part = 0; part < parts<T>(); ++part)
      warp_mma<NT, true>(dq_acc, dss + (part * kRows + 16 * wr) * lds, lds, ks + wd * DW, ld, KT);
  }

  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = rho0 + 16 * wr + gid + 8 * h;
    if (rho >= pb.total_rows) continue;
    const int i = rho / G, g = rho % G;
    T* row = dq + ((static_cast<int64_t>(b) * pb.seq_q + i) * pb.heads + kvh * G + g) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int d = wd * DW + nt * 8 + 2 * tig + u;
        if (d < D) row[d] = from_f32<T>(dq_acc[nt][2 * h + u] * pb.scale);
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 at DP 64 and 128: wgmma, one warpgroup a CTA (csrc/flash_tiles.cuh).

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmPerSmBytes = 233472;  // shared memory of one SM, 1 KB of it reserved a CTA

// Stages of the ring of streamed tiles: loads run kStages - 1 steps ahead.
// The rows kernels keep three CTAs a SM at DP 64 and two at DP 128; the
// dK/dV kernels, whose registers allow two CTAs a SM at DP 64 and one at
// DP 128, take four.
template <int DP, bool kDkdv>
__host__ __device__ constexpr int ring_stages() {
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

__device__ __forceinline__ void fence_operand(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) sm90::fence_regs(a[ks]);
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
template <int DP>
__device__ __forceinline__ void load_keys(uint32_t tile, const bf16* x, const Problem& pb, int b,
                                          int kvh, int k0, int d) {
  flash::load_tile<DP>(tile, x, d, [&](int r) -> const bf16* {
    if (k0 + r >= pb.seq_k) return nullptr;
    return x + ((static_cast<int64_t>(b) * pb.seq_k + k0 + r) * pb.kv_heads + kvh) * d;
  });
}

// The swizzled tiles of rows rho0 .. rho0 + 63 of q and of dO by cp.async
// (zero past the last row): one division a row.
template <int DP>
__device__ __forceinline__ void load_row_tiles(uint32_t q_tile, uint32_t do_tile, const bf16* q,
                                               const bf16* dout, const Problem& pb, int b,
                                               int kvh, int rho0, int d) {
  constexpr int kSlots = DP / 8;
  const int c = threadIdx.x % kSlots;
  if (8 * c >= d) return;  // padding, zeroed once
  for (int r = threadIdx.x / kSlots; r < kRows; r += flash::kWarpgroup / kSlots) {
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

// kFull: D == DP, a compile-time head dim.
template <int DP, bool kFull>
__global__ void __launch_bounds__(flash::kWarpgroup, min_ctas<DP, false>())
flash_bwd_rows_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ stats, float* __restrict__ aux,
                     bf16* __restrict__ dq, Problem pb) {
  constexpr int T = DP * 128;  // bytes of a tile
  constexpr int kStages = ring_stages<DP, false>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-aligned
  unsigned char* const tiles = smem_raw + (base - raw);
  const uint32_t q_tile = base, do_tile = base + T;  // stage s: K at (2 + 2s) T, V at (3 + 2s) T
  const uint32_t full = base + (2 + 2 * kStages) * T;  // stage s's barrier at full + 8 s

  const int nbh = pb.batch * pb.kv_heads;
  const int bh = blockIdx.x % nbh, b = bh / pb.kv_heads, kvh = bh % pb.kv_heads;
  const int n_row_tiles = (pb.total_rows + kRows - 1) / kRows;
  const int rho0 = longest_first(blockIdx.x / nbh, n_row_tiles, pb.causal) * kRows;
  const int D = kFull ? DP : pb.head_dim, G = pb.groups;
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(full + 8 * s, flash::kWarpgroup);
    sm90::fence_mbar_init();
  }
  if constexpr (!kFull) flash::zero_padding<DP>(tiles, 2 + 2 * kStages, D);
  __syncthreads();

  const int first_pos = rho0 / G, last_pos = (min(rho0 + kRows, pb.total_rows) - 1) / G;
  const KeyWalk walk(pb, first_pos, last_pos);
  // the walk for L takes two key tiles a step (S of the second in dP's
  // registers); then the walks for Delta and for dQ, a tile a step
  const int n0 = (walk.n + 1) / 2;
  const int n_steps = walk.n ? n0 + 2 * walk.n : 0;

  load_row_tiles<DP>(q_tile, do_tile, q, dout, pb, b, kvh, rho0, D);
  // step's tiles into its stage: K, and the next K (the walk for L) or V;
  // the first stage's phase also covers Q and dO
  auto load_step = [&](int step) {
    const bool first_walk = step < n0;
    const int t = first_walk ? 2 * step : (step - n0) % walk.n;
    const int st = step % kStages, k0 = (walk.t_lo + t) * kRows;
    const uint32_t kt = base + (2 + 2 * st) * T;
    load_keys<DP>(kt, k, pb, b, kvh, k0, D);
    if (!first_walk) {
      load_keys<DP>(kt + T, v, pb, b, kvh, k0, D);
    } else if (t + 1 < walk.n) {
      load_keys<DP>(kt + T, k, pb, b, kvh, k0 + kRows, D);
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
    return base + (2 + 2 * st) * T;
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

  // dQ += dS K, dS = P (dP - Delta) where kept, as value + remainder.  A
  // step's product runs on while the next step's S and dP are issued: the
  // wait for those completes it, and only then (all warps past it) is its
  // stage loaded again and its operand's registers free.
  float dq_acc[DP / 2];
  zero(dq_acc);
  uint32_t hi[4][4] = {}, lo[4][4] = {};
  for (int t = 0; t < walk.n; ++t, ++step) {
    const uint32_t kt = ready(step, t == 0);
    gradient_step(kt, (walk.t_lo + t) * kRows, [&](int i, float p, bool keep) {
      dp[i] = keep ? p * (dp[i] - delta[i % 4 / 2]) : 0.0f;
    });
    fence_operand(hi);  // the previous step's product has completed
    fence_operand(lo);
    __syncthreads();
    if (t > 0 && step + kStages - 1 < n_steps) load_step(step + kStages - 1);
    split_operand(dp, hi, lo);
    fence_operand(hi);
    fence_operand(lo);
    sm90::fence_regs(dq_acc);
    sm90::wgmma_fence();
    flash::rs_issue<DP>(dq_acc, hi, kt);
    flash::rs_issue<DP>(dq_acc, lo, kt);
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

template <typename T, int DP>
cudaError_t launch_width(const void* q, const void* k, const void* v, const void* dout,
                         const float* stats, float* aux, void* dq, void* dk, void* dv,
                         const Problem& pb, cudaStream_t stream) {
  constexpr int kv_smem = dkdv_smem_bytes<T, DP>();
  constexpr int rows_smem = rows_smem_bytes<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_rows_kernel<T, DP, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, rows_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_rows_kernel<T, DP, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, rows_smem);
  if (err != cudaSuccess) return err;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const dim3 rows_grid((pb.total_rows + kRows - 1) / kRows, pb.kv_heads, pb.batch);
  flash_bwd_rows_kernel<T, DP, true><<<rows_grid, kThreads, rows_smem, stream>>>(
      tq, tk, tv, tdo, stats, aux, nullptr, pb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int KT = key_tile<DP>();
  const dim3 kv_grid((pb.seq_k + KT - 1) / KT, pb.kv_heads, pb.batch);
  flash_bwd_dkdv_kernel<T, DP><<<kv_grid, kThreads, kv_smem, stream>>>(
      tq, tk, tv, tdo, stats, aux, static_cast<T*>(dk), static_cast<T*>(dv), pb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_rows_kernel<T, DP, false><<<rows_grid, kThreads, rows_smem, stream>>>(
      tq, tk, tv, tdo, stats, aux, static_cast<T*>(dq), pb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, const void* dout,
                         const float* stats, float* aux, void* dq, void* dk, void* dv,
                         const Problem& pb, cudaStream_t stream) {
#define K4_BWD(DP) launch_width<T, DP>(q, k, v, dout, stats, aux, dq, dk, dv, pb, stream)
  const int d = pb.head_dim;
  if constexpr (sizeof(T) == 2) {  // bf16: wgmma up to DP 128
#define K4_WGMMA(DP, FULL) launch_wgmma<DP, FULL>(q, k, v, dout, stats, aux, dq, dk, dv, pb, stream)
    if (d <= 64) return d == 64 ? K4_WGMMA(64, true) : K4_WGMMA(64, false);
    if (d <= 128) return d == 128 ? K4_WGMMA(128, true) : K4_WGMMA(128, false);
#undef K4_WGMMA
  } else {
    if (d <= 16) return K4_BWD(16);
    if (d <= 32) return K4_BWD(32);
    if (d <= 64) return K4_BWD(64);
    if (d <= 128) return K4_BWD(128);
  }
  if (d <= 192) return K4_BWD(192);
  return K4_BWD(256);
#undef K4_BWD
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 float32, 1 bfloat16.  q, dout, dq (B, Sq, H, D); k, v, dk, dv
// (B, Sk, KVH, D), contiguous, on the card, 1 <= D <= 256; stats (2, B, H,
// Sq) f32: the forward's m, then l; aux (3, B, H, Sq) f32 scratch (the
// rows' statistics for the dK/dV kernel).  bfloat16 also needs D % 8 == 0
// and 16-byte aligned q, k, v, dout.
int flash_attention_backward_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const float* stats, float* aux, void* dq,
                                    void* dk, void* dv, int batch, int seq_q, int seq_k, int heads,
                                    int kv_heads, int head_dim, int dtype, int causal, int window,
                                    float scale, void* stream) {
  if (batch <= 0 || seq_q <= 0 || seq_k <= 0 || kv_heads <= 0 || heads % kv_heads ||
      head_dim < 1 || head_dim > kMaxHeadDim || batch > 65535 || kv_heads > 65535 ||
      static_cast<int64_t>(seq_q) * (heads / kv_heads) > (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem pb{batch, seq_q, seq_k, heads, kv_heads, head_dim, heads / kv_heads,
                   seq_q * (heads / kv_heads), causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_dtype<float>(q, k, v, dout, stats, aux, dq, dk, dv, pb, s));
  if (dtype == 1) {
    // 16-byte copies need whole 8-column chunks on 16-byte aligned rows
    if (head_dim % 8 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_dtype<bf16>(q, k, v, dout, stats, aux, dq, dk, dv, pb, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
