// K4's bf16 tiles and tensor-core products, shared by the forwards
// (csrc/flash_attention.cu, csrc/flash_attention_wide.cu) and the backward
// (csrc/flash_attention_bwd.cu), and the forwards' walk over the key tiles.
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

}  // namespace flash
