// K4's bf16 tiles and tensor-core products, shared by the forwards
// (csrc/flash_attention.cu, csrc/flash_attention_wide.cu) and the backward
// (csrc/flash_attention_bwd.cu), and the forwards' walk over the key tiles;
// at the end, the f32 kernels' operands as three bf16 pieces.
//
// A tile is 64 rows of DP bf16 (DP a multiple of 64) in shared memory,
// stored in regions of 64 columns (one 128-byte row each), each region
// 128-byte swizzled: the layout wgmma's descriptors name.  One tile serves
// as a K-major operand (its DP columns along the product's depth) and as an
// MN-major B operand (its 64 rows along the depth, DP along N).  One
// warpgroup (128 threads) issues every product; the f32 accumulators of a
// 64 x 64 product already have the layout of wgmma's register A operand.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace flash {

constexpr int kWarpgroup = 128;
constexpr int kTileRows = 64;                   // rows of a tile = wgmma's M
constexpr int kRegionBytes = kTileRows * 128;   // 64 rows of 64 bf16
constexpr int kAtomBytes = 8 * 128;             // one 128-byte swizzle atom: 8 rows

// Byte offset of the 16-byte chunk c (columns 8c .. 8c + 7) of row r.
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return (c / 8) * kRegionBytes + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

// The key tiles [t_lo, t_end) of kTileRows keys that a forward CTA whose
// rows sit at positions first_pos .. last_pos walks, in every forward
// kernel (forward_walk in kernels/flash_attention/flash_attention.py states
// the same arithmetic for the tests): a causal walk stops at the tile of
// the last row's diagonal; a window starts at the tile that holds the first
// row's window edge, max(0, first_pos - window + 1), except where a row sees
// no key at all (position >= Sk + window - 1, when Sq > Sk): that CTA walks
// from tile 0, so the row averages every key, as the TPU kernel's does.
struct ForwardWalk {
  int t_lo, t_end;
};

__device__ __forceinline__ ForwardWalk forward_walk(int first_pos, int last_pos, int seq_k,
                                                    int causal, int window) {
  ForwardWalk w{0, (seq_k + kTileRows - 1) / kTileRows};
  if (causal) w.t_end = min(w.t_end, last_pos / kTileRows + 1);
  if (window && last_pos < static_cast<int64_t>(seq_k) + window - 1)
    w.t_lo = max(0, first_pos - window + 1) / kTileRows;
  return w;
}

// Fills a tile of 64 rows of DP bf16 in shared memory by 16-byte cp.async
// copies of the d / 8 chunks (d % 8 == 0) of row r from row_ptr(r), or
// zeros where row_ptr(r) is null; the columns past d were zeroed once by
// zero_padding.  The CTA's kThreads threads copy.
template <int DP, int kThreads = kWarpgroup, typename RowPtr>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* any, int d,
                                          RowPtr row_ptr) {
  constexpr int kSlots = DP / 8;
  for (int e = threadIdx.x; e < kTileRows * kSlots; e += kThreads) {
    const int r = e / kSlots, c = e % kSlots;
    if (8 * c >= d) continue;
    const __nv_bfloat16* src = row_ptr(r);
    sm90::cp_async16(tile + tile_offset(r, c), src ? src + 8 * c : any, src != nullptr);
  }
}

// Zeroes the columns d .. DP - 1 (d % 8 == 0) of `n_tiles` consecutive
// tiles: the products read them, and no copy writes them.
template <int DP, int kThreads = kWarpgroup>
__device__ __forceinline__ void zero_padding(unsigned char* tiles, int n_tiles, int d) {
  constexpr int kTileBytes = DP * 128;
  const int pad_chunks = (DP - d) / 8;
  if (pad_chunks == 0) return;
  for (int e = threadIdx.x; e < n_tiles * kTileRows * pad_chunks; e += kThreads) {
    const int t = e / (kTileRows * pad_chunks);
    const int r = e / pad_chunks % kTileRows;
    const int c = d / 8 + e % pad_chunks;
    *reinterpret_cast<uint4*>(tiles + t * kTileBytes + tile_offset(r, c)) = make_uint4(0, 0, 0, 0);
  }
}

// Issues s (64 x 64 f32) = A (64 x DP) B^T, both tiles K-major: DP / 16
// wgmma steps, the first overwriting s.  The caller fences, commits, waits.
// kFresh: the first step's accumulators are outputs only (s need not be
// defined before, nor zeroed).
template <int DP, bool kFresh = false>
__device__ __forceinline__ void ss_issue(float (&s)[32], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    // 16 columns are 32 bytes of a row; every 4 steps the next region
    const uint32_t off = ks / 4 * kRegionBytes + ks % 4 * 32;
    const uint64_t da = sm90::wgmma_desc_sw128(a_tile + off, 16, kAtomBytes);
    const uint64_t db = sm90::wgmma_desc_sw128(b_tile + off, 16, kAtomBytes);
    if (kFresh && ks == 0) {
      sm90::wgmma_ss_m64n64k16_first(s, da, db);
    } else {
      sm90::wgmma_ss_m64n64k16(s, da, db, ks);
    }
  }
}

// S (64 x 64 f32) = Q (64 x DP) K^T, both tiles K-major in shared memory.
template <int DP>
__device__ __forceinline__ void qk_product(float (&s)[32], uint32_t q_tile, uint32_t k_tile) {
  sm90::fence_regs(s);
  sm90::wgmma_fence();
  ss_issue<DP>(s, q_tile, k_tile);
  sm90::wgmma_commit();
  sm90::wgmma_wait_all();
  sm90::fence_regs(s);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A operand of an RS product from a 64 x 16 KS accumulator p: k step
// ks takes p's 8-column blocks 2ks and 2ks + 1, as pairs of bf16.
template <int KS>
__device__ __forceinline__ void pack_operand(const float (&p)[8 * KS], uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[ks][i] = pack_bf16(p[8 * ks + 2 * i], p[8 * ks + 2 * i + 1]);
  }
}

// Issues o (64 x DP f32) += A B, A (64 x 64) from registers in the layout
// of pack_operand, B (64 x DP: its 64 rows along the depth, DP contiguous)
// an MN-major tile in shared memory.  The DP columns go as n128 pieces (two
// 64-column regions each), then one n64 for a last odd region; a piece's
// accumulators are o's next 64 (or 32) registers, the layout of one wide
// product.  The caller fences, commits, waits.
template <int DP>
__device__ __forceinline__ void rs_issue(float (&o)[DP / 2], const uint32_t (&a)[4][4],
                                         uint32_t b_tile) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    // 16 rows are two 8-row groups; the 64-column regions are kRegionBytes apart
    const uint32_t rows = b_tile + ks * 2 * kAtomBytes;
#pragma unroll
    for (int n = 0; n < DP / 128; ++n) {
      sm90::wgmma_rs_m64n128k16(
          *reinterpret_cast<float(*)[64]>(o + 64 * n), a[ks],
          sm90::wgmma_desc_sw128(rows + 2 * n * kRegionBytes, kRegionBytes, kAtomBytes), 1);
    }
    if constexpr (DP % 128 != 0) {
      constexpr int kLast = DP / 64 - 1;
      sm90::wgmma_rs_m64n64k16(
          *reinterpret_cast<float(*)[32]>(o + 32 * kLast), a[ks],
          sm90::wgmma_desc_sw128(rows + kLast * kRegionBytes, kRegionBytes, kAtomBytes), 1);
    }
  }
}

// Issues o (64 x kN f32, from register kOff of o) += A B[:, kC0 .. kC0 + kN),
// A (64 x 16) from registers, B an MN-major tile in shared memory whose 16
// rows along the depth start at `rows` (its DP columns in 64-column
// regions, kRegionBytes apart): pieces of n128 (two whole regions), n64 (one)
// and n32 (half a region, from its start or 64 bytes in), in column order,
// each piece's accumulators o's next registers.
template <int kC0, int kN, int kOff, int N>
__device__ __forceinline__ void rs_issue_cols(float (&o)[N], const uint32_t (&a)[4],
                                              uint32_t rows) {
  if constexpr (kN > 0) {
    constexpr int kRegion = kC0 / 64, kIn = kC0 % 64;
    const uint32_t at = rows + kRegion * kRegionBytes + kIn * 2;
    if constexpr (kIn == 0 && kN >= 128) {
      sm90::wgmma_rs_m64n128k16(*reinterpret_cast<float(*)[64]>(o + kOff), a,
                                sm90::wgmma_desc_sw128(at, kRegionBytes, kAtomBytes), 1);
      rs_issue_cols<kC0 + 128, kN - 128, kOff + 64>(o, a, rows);
    } else if constexpr (kIn == 0 && kN >= 64) {
      sm90::wgmma_rs_m64n64k16(*reinterpret_cast<float(*)[32]>(o + kOff), a,
                               sm90::wgmma_desc_sw128(at, kRegionBytes, kAtomBytes), 1);
      rs_issue_cols<kC0 + 64, kN - 64, kOff + 32>(o, a, rows);
    } else {
      static_assert(kIn % 32 == 0 && kN >= 32, "pieces of 32 columns within a region");
      sm90::wgmma_rs_m64n32k16(*reinterpret_cast<float(*)[16]>(o + kOff), a,
                               sm90::wgmma_desc_sw128(at, kRegionBytes, kAtomBytes), 1);
      rs_issue_cols<kC0 + 32, kN - 32, kOff + 16>(o, a, rows);
    }
  }
}

// O (64 x DP f32) += bf16(P) V, P in the S fragment's registers (RS form),
// the V tile (keys x DP, DP contiguous) MN-major in shared memory.
template <int DP>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2], const float (&p)[32],
                                           uint32_t v_tile) {
  uint32_t a[4][4];
  pack_operand(p, a);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) sm90::fence_regs(a[ks]);
  sm90::fence_regs(o);
  sm90::wgmma_fence();
  rs_issue<DP>(o, a, v_tile);
  sm90::wgmma_commit();
  sm90::wgmma_wait_all();
  sm90::fence_regs(o);
}

// ---------------------------------------------------------------------------
// f32 operands as three bf16 pieces, for the f32 kernels
// (csrc/flash_attention_f32.cu, csrc/flash_attention_f32_bwd.cu).
//
// x becomes x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1), each
// subtraction exact in f32: the pieces carry x's 24 significant bits, so
// x0 + x1 + x2 == x (but where bf16(x) rounds past f32's largest value, or
// x2 falls below the normal range and keeps fewer bits).  A product a b
// runs as the six products of pieces whose sum of piece indices is at most
// 2, on wgmma with f32 accumulators; the three left out (a1 b2, a2 b1,
// a2 b2) are about 2^-24 of it.  The smaller products go first, so that
// the accumulator's roundings fall on the large terms alone.
//
// A piece tile is R rows of DP bf16 (R a multiple of 8, DP of 64) stored
// as flash::tile_offset stores 64 rows: regions of 64 columns, R * 128
// bytes each, 128-byte swizzled; the three pieces of a tile follow one
// another, R * DP * 2 bytes apart.

constexpr int kPieces = 3;
constexpr int kPieceProducts = 6;

// The (A piece, B piece) of the pp-th of the six products, smallest first.
__host__ __device__ constexpr int piece_a(int pp) { return pp == 0 ? 2 : pp == 1 || pp == 3 ? 1 : 0; }
__host__ __device__ constexpr int piece_b(int pp) { return pp == 2 ? 2 : pp == 1 || pp == 4 ? 1 : 0; }

// Byte offset of the 16-byte chunk c (columns 8c .. 8c + 7) of row r in a
// piece tile of R rows.
template <int R>
__device__ __forceinline__ uint32_t rows_offset(int r, int c) {
  return (c / 8) * (R * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

// The three pieces of a and of b, packed in pairs of bf16 (a low, b high).
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& p0, uint32_t& p1,
                                           uint32_t& p2) {
  const __nv_bfloat162 x0 = __floats2bfloat162_rn(a, b);
  const float ra = __fsub_rn(a, __low2float(x0)), rb = __fsub_rn(b, __high2float(x0));
  const __nv_bfloat162 x1 = __floats2bfloat162_rn(ra, rb);
  const __nv_bfloat162 x2 = __floats2bfloat162_rn(__fsub_rn(ra, __low2float(x1)),
                                                  __fsub_rn(rb, __high2float(x1)));
  p0 = *reinterpret_cast<const uint32_t*>(&x0);
  p1 = *reinterpret_cast<const uint32_t*>(&x1);
  p2 = *reinterpret_cast<const uint32_t*>(&x2);
}

// The A operand of an RS product from a 64 x 16 KS accumulator v, as its
// three pieces: a[p] in the layout of pack_operand.
template <int KS>
__device__ __forceinline__ void split_operand3(const float (&v)[8 * KS],
                                               uint32_t (&a)[kPieces][KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_pair(v[8 * ks + 2 * i], v[8 * ks + 2 * i + 1], a[0][ks][i], a[1][ks][i], a[2][ks][i]);
}

template <int KS>
__device__ __forceinline__ void fence_operand3(uint32_t (&a)[kPieces][KS][4]) {
#pragma unroll
  for (int p = 0; p < kPieces; ++p)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) sm90::fence_regs(a[p][ks]);
}

// R rows of DP f32 on their way from device memory to a piece tile: kThreads
// threads each hold R * DP / (4 kThreads) 16-byte chunks in registers, chunk
// e of thread t being chunk e * kThreads + t of the tile (DP / 4 a row), so
// that a warp reads whole rows.  load() issues the reads (row r from
// row(r), null: zeros; its first d columns, d % 4 == 0, 16-byte aligned);
// store() writes the three pieces of each value times mult (f32, rounded
// once) into rows r0 + r of a piece tile of RT rows, zeros past column d.
template <int R, int DP, int kThreads = kWarpgroup>
struct F32Rows {
  static constexpr int kChunks = DP / 4;
  static constexpr int kSlots = R * kChunks / kThreads;
  static_assert(R * kChunks % kThreads == 0, "whole chunks a thread");
  float4 x[kSlots];

  template <typename Row>
  __device__ __forceinline__ void load(int d, Row row) {
    const int tid = threadIdx.x % kThreads;
#pragma unroll
    for (int e = 0; e < kSlots; ++e) {
      const int at = e * kThreads + tid, r = at / kChunks, c = at % kChunks;
      const float* src = row(r);
      x[e] = src != nullptr && 4 * c < d ? __ldg(reinterpret_cast<const float4*>(src) + c)
                                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  template <int RT>
  __device__ __forceinline__ void store(unsigned char* tile, int r0, float mult) const {
    constexpr int kPieceBytes = RT * DP * 2;
    const int tid = threadIdx.x % kThreads;
#pragma unroll
    for (int e = 0; e < kSlots; ++e) {
      const int at = e * kThreads + tid, r = at / kChunks, c = at % kChunks;
      const uint32_t off = rows_offset<RT>(r0 + r, c / 2) + (c % 2) * 8;
      uint32_t lo[kPieces], hi[kPieces];
      split_pair(__fmul_rn(x[e].x, mult), __fmul_rn(x[e].y, mult), lo[0], lo[1], lo[2]);
      split_pair(__fmul_rn(x[e].z, mult), __fmul_rn(x[e].w, mult), hi[0], hi[1], hi[2]);
#pragma unroll
      for (int p = 0; p < kPieces; ++p)
        *reinterpret_cast<uint2*>(tile + p * kPieceBytes + off) = make_uint2(lo[p], hi[p]);
    }
  }
};

template <int N>
__device__ __forceinline__ void ss_step(float (&d)[N / 2], uint64_t da, uint64_t db, bool first) {
  if constexpr (N == 64) {
    if (first) {
      sm90::wgmma_ss_m64n64k16_first(d, da, db);
    } else {
      sm90::wgmma_ss_m64n64k16(d, da, db, 1);
    }
  } else if constexpr (N == 32) {
    if (first) {
      sm90::wgmma_ss_m64n32k16_first(d, da, db);
    } else {
      sm90::wgmma_ss_m64n32k16(d, da, db, 1);
    }
  } else {
    static_assert(N == 16, "N of 16, 32 or 64");
    if (first) {
      sm90::wgmma_ss_m64n16k16_first(d, da, db);
    } else {
      sm90::wgmma_ss_m64n16k16(d, da, db, 1);
    }
  }
}

// The descriptors of a piece product: a base descriptor and immediate
// offsets (the start address field is the address over 16, 14 bits, and
// shared memory below 256 KB never carries out of it).  The opaque copy of
// the addresses keeps the compiler from holding every product's descriptor
// in registers across a walk.

// Issues acc (64 x N f32) = A B^T as the six products of pieces: A 64 rows of
// DP (three K-major pieces of a 64-row tile at a), B N rows of DP (three
// K-major pieces of an N-row tile at b); the first step overwrites acc.
// The caller fences, commits, waits.
template <int DP, int N>
__device__ __forceinline__ void ss_pieces(float (&acc)[N / 2], uint32_t a, uint32_t b) {
  constexpr uint32_t kA = kTileRows * DP * 2, kB = N * DP * 2;
  asm volatile("" : "+r"(a), "+r"(b));
  const uint64_t da0 = sm90::wgmma_desc_sw128(a, 16, kAtomBytes);
  const uint64_t db0 = sm90::wgmma_desc_sw128(b, 16, kAtomBytes);
#pragma unroll
  for (int pp = 0; pp < kPieceProducts; ++pp) {
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const uint32_t oa = piece_a(pp) * kA + ks / 4 * kRegionBytes + ks % 4 * 32;
      const uint32_t ob = piece_b(pp) * kB + ks / 4 * (N * 128) + ks % 4 * 32;
      ss_step<N>(acc, da0 + (oa >> 4), db0 + (ob >> 4), pp == 0 && ks == 0);
    }
  }
}

// Issues acc (64 x DP f32) += A B as the six products of pieces: A (64 x 16
// KS) from registers as its three pieces (split_operand3), B (16 KS rows
// along the depth, DP columns) three MN-major pieces of a 16 KS-row tile at
// b; fresh: acc = A B (the first step overwrites acc).  DP as n128 pieces
// and an n64 for a last odd region.  The caller fences, commits, waits.
template <int DP, int KS>
__device__ __forceinline__ void rs_pieces(float (&acc)[DP / 2], const uint32_t (&a)[kPieces][KS][4],
                                          uint32_t b, bool fresh = false) {
  constexpr uint32_t kRegion = 16 * KS * 128, kB = 16 * KS * DP * 2;
  asm volatile("" : "+r"(b));
  const uint64_t db0 = sm90::wgmma_desc_sw128(b, kRegion, kAtomBytes);
#pragma unroll
  for (int pp = 0; pp < kPieceProducts; ++pp) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t rows = piece_b(pp) * kB + ks * 2 * kAtomBytes;
      const uint32_t(&op)[4] = a[piece_a(pp)][ks];
      const int accumulate = !fresh || pp > 0 || ks > 0;
#pragma unroll
      for (int n = 0; n < DP / 128; ++n) {
        sm90::wgmma_rs_m64n128k16(*reinterpret_cast<float(*)[64]>(acc + 64 * n), op,
                                  db0 + ((rows + 2 * n * kRegion) >> 4), accumulate);
      }
      if constexpr (DP % 128 != 0) {
        constexpr int kLast = DP / 64 - 1;
        sm90::wgmma_rs_m64n64k16(*reinterpret_cast<float(*)[32]>(acc + 32 * kLast), op,
                                 db0 + ((rows + kLast * kRegion) >> 4), accumulate);
      }
    }
  }
}

}  // namespace flash
