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
//    (the forward's masks and arithmetic) and P = exp(S - m) / max(l, 1e-30):
//        dV = P^T dO,  dP = dO V^T,  Delta = rowsum(P * dP) over the kept keys,
//        dS = P * (dP - Delta) (0 where masked),  dQ = scale dS K,  dK = scale dS^T Q.
//    The statistics are m and l, not one logsumexp: a fully masked row has
//    m = MASK, where m + log(l) rounds back to m in f32 and exp(S - lse)
//    would give 1 in place of the forward's 1 / l.  Such a row gives its
//    uniform P to dV and nothing to dQ or dK, as autograd of masked_fill
//    does.  Delta is formed from the same f32 P and dP that dS takes, not as
//    rowsum(dO * O) from the output rounded to bf16: a row that sees one key
//    (P = 1) then has dS = 0 exactly, as autograd gives, where O's rounding
//    would leave dQ a remainder past the bf16 row tolerance.
//
// Three kernels on one stream, no atomics, so two calls give the same bits:
//  1. flash_bwd_rows_kernel<kDelta = true>, a CTA per (batch, kv head, 64
//     rows): walks the key tiles the forward walks (and from the window's
//     first key on), recomputes S and dP, and sums P * dP per row: Delta.
//  2. flash_bwd_dkdv_kernel, a CTA per (batch, kv head, tile of KT keys):
//     walks the 64-row tiles (rows numbered i * G + g, as in the forward,
//     so the G heads of the kv head are summed inside the CTA) that its
//     masks let see the tile (causal: from its first key on; windowed: up
//     to its last key + window - 1) and the fully masked rows past
//     Sk + window - 1; recomputes S and dP, forms P and dS, and accumulates
//     dV += P^T dO and dK += dS^T Q in registers.
//  3. flash_bwd_rows_kernel<kDelta = false>: as kernel 1, accumulating
//     dQ += dS K.
// Recomputing S and dP in each kernel costs 9 tile products where the
// forward has 2: 4.5x the forward's operations (kernel_flops assumes 2.5x
// for a backward that forms S and dP once and shares them through atomics).
//
// Products: bf16 runs mma.sync m16n8k16 on the tensor cores with f32
// accumulators; P and dS are rounded to bf16 only as operands, as the
// forward rounds P.  f32 runs the same fragment layout on the CUDA cores in
// IEEE f32 FMA (no TF32), q scaled before the product as in the forward.
// Each CTA is 8 warps.  Tiles live in shared memory, padded by 16 bytes a
// row so that the fragment loads meet no bank conflicts; the operands that
// are read along their rows (dO, Q and K as the B operand of dV, dK and dQ)
// go through ldmatrix.trans in bf16.
//
// Head dims: any D from 1 to 256, at padded widths DP of 16, 32, 64, 128,
// 192, 256 whose extra columns are zero in shared memory.  Key tiles are
// 64 keys up to DP 128 and 32 past it, which keeps the f32 kernels within
// the 232,448 bytes of shared memory a block may use (217,856 at DP 256).
// bf16 needs D % 8 == 0 and 16-byte aligned tensors (the wrapper pads).
//
// Bound: operations, at the bf16 tensor-core rate (989 TFLOP/s) for bf16
// and the 67 TFLOP/s f32 rate otherwise; the least work is 2.5x the
// forward's kernel_flops, against reads of q, k, v, dO and writes of dq,
// dk, dv.  A simple tiled kernel: loads are not overlapped with the
// products, and kernel 2's causal CTAs are unbalanced (the first key tile
// walks every row, the last one few).
//
// The entry point returns cudaGetLastError() so the wrapper can raise on a
// refused launch.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
  int seq_q, seq_k, heads, kv_heads, head_dim, groups, total_rows, causal, window;
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

__device__ __forceinline__ int64_t plane(const Problem& pb) {
  return static_cast<int64_t>(gridDim.z) * pb.heads * pb.seq_q;
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
  const int G = pb.groups, D = pb.head_dim;
  auto kv_row = [&](const T* x) {
    return [&, x](int r) -> const T* {
      if (k0 + r >= pb.seq_k) return nullptr;
      return x + ((static_cast<int64_t>(b) * pb.seq_k + k0 + r) * pb.kv_heads + kvh) * D;
    };
  };
  load_rows<DP>(ks, ld, KT, D, 1.0f, kv_row(k));
  load_rows<DP>(vs, ld, KT, D, 1.0f, kv_row(v));

  // the row tiles whose masks let a row see a key of this tile, then those
  // holding fully masked rows (a window past every key), which give dV
  // their uniform P
  const int k_last = min(k0 + KT, pb.seq_k) - 1;
  const int lo = pb.causal ? k0 : 0;
  const int hi = pb.window ? min(pb.seq_q, k_last + pb.window) : pb.seq_q;
  const int t_lo = lo * G / kRows;
  const int t_hi = hi > lo ? (hi * G + kRows - 1) / kRows : t_lo;
  const int fm = pb.window ? pb.seq_k + pb.window - 1 : pb.seq_q;  // first fully masked position
  const int f_lo = max(t_hi, fm * G / kRows);
  const int f_hi = fm < pb.seq_q ? max(f_lo, (pb.seq_q * G + kRows - 1) / kRows) : f_lo;
  const int n_iter = (t_hi - t_lo) + (f_hi - f_lo);

  const int warp = threadIdx.x / 32, wk = warp % WK, wd = warp / WK;
  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.0f;

  for (int it = 0; it < n_iter; ++it) {
    const int t = it < t_hi - t_lo ? t_lo + it : f_lo + (it - (t_hi - t_lo));
    const int rho0 = t * kRows;
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

template <typename T, int DP>
cudaError_t launch_width(const void* q, const void* k, const void* v, const void* dout,
                         const float* stats, float* aux, void* dq, void* dk, void* dv,
                         int batch, const Problem& pb, cudaStream_t stream) {
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
  const dim3 rows_grid((pb.total_rows + kRows - 1) / kRows, pb.kv_heads, batch);
  flash_bwd_rows_kernel<T, DP, true><<<rows_grid, kThreads, rows_smem, stream>>>(
      tq, tk, tv, tdo, stats, aux, nullptr, pb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int KT = key_tile<DP>();
  const dim3 kv_grid((pb.seq_k + KT - 1) / KT, pb.kv_heads, batch);
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
                         int batch, const Problem& pb, cudaStream_t stream) {
#define K4_BWD(DP) launch_width<T, DP>(q, k, v, dout, stats, aux, dq, dk, dv, batch, pb, stream)
  const int d = pb.head_dim;
  if (d <= 16) return K4_BWD(16);
  if (d <= 32) return K4_BWD(32);
  if (d <= 64) return K4_BWD(64);
  if (d <= 128) return K4_BWD(128);
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
// Sq) f32: the forward's m, then l; aux (2, B, H, Sq) f32 scratch (L, then
// Delta).  bfloat16
// also needs D % 8 == 0 and 16-byte aligned q, k, v, dout.
int flash_attention_backward_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const float* stats, float* aux, void* dq,
                                    void* dk, void* dv, int batch, int seq_q, int seq_k, int heads,
                                    int kv_heads, int head_dim, int dtype, int causal, int window,
                                    float scale, void* stream) {
  if (batch <= 0 || seq_q <= 0 || seq_k <= 0 || kv_heads <= 0 || heads % kv_heads ||
      head_dim < 1 || head_dim > kMaxHeadDim || batch > 65535 || kv_heads > 65535 ||
      static_cast<int64_t>(seq_q) * (heads / kv_heads) > (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem pb{seq_q, seq_k, heads, kv_heads, head_dim, heads / kv_heads,
                   seq_q * (heads / kv_heads), causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_dtype<float>(q, k, v, dout, stats, aux, dq, dk, dv, batch,
                                                pb, s));
  if (dtype == 1) {
    // 16-byte copies need whole 8-column chunks on 16-byte aligned rows
    if (head_dim % 8 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_dtype<bf16>(q, k, v, dout, stats, aux, dq, dk, dv, batch,
                                               pb, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
