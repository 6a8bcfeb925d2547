// Hadamard SATD of one block row held across the lanes of a warp, shared by
// kvz_satd (csrc/q_kernels.cu) and kvz_merge_search (csrc/merge_kernels.cu).
//
// A row is an N x N block stored row-major (N = 4, 8, 16, 32 or 64) and
// cut into B x B subblocks (B = 4 when N = 4, else 8).  A lane holds one
// chunk: B consecutive samples of one sample row of one subblock, so the
// lanes of a warp read consecutive 16-byte words and a 16x16 row is one
// contiguous 1 KB warp load.  Chunk c of a row covers samples c*B .. c*B +
// B - 1, sample row y = c / P and column group c % P, P = N / B chunks per
// sample row.  Up to N = 32 (P * B <= 32) lane l of iteration it holds
// chunk it * 32 + l, so the B sample rows of a subblock sit P lanes apart,
// and the vertical butterfly runs across lanes with __shfl_xor_sync at
// masks P, 2P, .., P*B/2 (2, 4 and 8 for a 16x16 row).  A 64x64 row's
// subblock rows lie 8 chunks apart, 64 in all, more than a warp: there an
// iteration holds four side-by-side subblocks instead (lane l: sample row
// l / 4 of subblock column l % 4 of the half band it % 2 of band it / 2),
// whose rows sit S = 4 lanes apart.  The horizontal butterfly runs in
// registers.
//
// All int32 and exact: |Hadamard coefficient| <= 64 * 255 for 8-bit input.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace kvz {

constexpr unsigned kFullMask = 0xffffffffu;

// Lane geometry of one N x N row cut into B x B subblocks.
template <int B, int N>
struct SatdGeom {
  static constexpr int P = N / B;                       // chunks per sample row
  static constexpr int CHUNKS = N * N / B;              // chunks per block row
  static constexpr int LR = CHUNKS < 32 ? CHUNKS : 32;  // lanes per block row
  static constexpr int ITER = CHUNKS / LR;              // chunks per lane
  static constexpr int RW = 32 / LR;                    // block rows per warp
  static constexpr bool WIDE = P * B > 32;              // N = 64: see above
  static constexpr int S = WIDE ? 32 / B : P;           // lanes between subblock rows
};

// The chunk that lane l holds in iteration it.
template <int B, int N>
__device__ __forceinline__ int chunk_of(int it, int l) {
  using G = SatdGeom<B, N>;
  if constexpr (!G::WIDE) {
    return it * G::LR + l;
  } else {
    constexpr int HALVES = G::P / G::S;  // iterations per band of B sample rows
    const int band = it / HALVES, part = it % HALVES;
    return (band * B + l / G::S) * G::P + part * G::S + l % G::S;
  }
}

// In-register Walsh-Hadamard butterfly over B values.
template <int B>
__device__ __forceinline__ void hadamard_regs(int (&v)[B]) {
#pragma unroll
  for (int h = 1; h < B; h <<= 1) {
#pragma unroll
    for (int i = 0; i < B; i += 2 * h) {
#pragma unroll
      for (int j = i; j < i + h; ++j) {
        int a = v[j], b = v[j + h];
        v[j] = a + b;
        v[j + h] = a - b;
      }
    }
  }
}

// Rounded SATD of the B x B subblock whose rows the calling lanes hold,
// STRIDE lanes apart; every lane of the subblock returns it.  The stages
// of the Hadamard transform commute, so the order of the lane stages does
// not change the coefficients.  Every lane of the warp must call it.
template <int B, int STRIDE>
__device__ __forceinline__ int satd_subblock(int (&d)[B], int lane) {
  hadamard_regs<B>(d);
#pragma unroll
  for (int h = STRIDE; h < STRIDE * B; h <<= 1) {
    bool upper = (lane & h) != 0;
#pragma unroll
    for (int i = 0; i < B; ++i) {
      int o = __shfl_xor_sync(kFullMask, d[i], h);
      d[i] = upper ? o - d[i] : d[i] + o;
    }
  }
  int s = 0;
#pragma unroll
  for (int i = 0; i < B; ++i) s += abs(d[i]);
#pragma unroll
  for (int h = STRIDE; h < STRIDE * B; h <<= 1) s += __shfl_xor_sync(kFullMask, s, h);
  return B == 8 ? (s + 2) >> 2 : (s + 1) >> 1;
}

// B int32 values at p (16-byte aligned) into v.
template <int B>
__device__ __forceinline__ void load_chunk(const int* p, int (&v)[B]) {
#pragma unroll
  for (int q = 0; q < B / 4; ++q) {
    int4 w = *reinterpret_cast<const int4*>(p + 4 * q);
    v[4 * q] = w.x;
    v[4 * q + 1] = w.y;
    v[4 * q + 2] = w.z;
    v[4 * q + 3] = w.w;
  }
}

// SATD of the N x N rows a and b (N*N int32 each, 16-byte aligned): sum of
// the rounded subblock SATDs.  The calling warp's lanes l = lane % LR of
// each LR-lane group share one row; `live` false gives 0 (the lane still
// takes part in the shuffles).  Every lane of the group returns the sum.
template <int B, int N>
__device__ __forceinline__ int satd_row(const int* a, const int* b, int lane, bool live) {
  using G = SatdGeom<B, N>;
  int l = lane % G::LR;
  int total = 0;
#pragma unroll
  for (int it = 0; it < G::ITER; ++it) {
    int c = chunk_of<B, N>(it, l);
    int d[B], e[B];
    if (live) {
      load_chunk<B>(a + c * B, d);
      load_chunk<B>(b + c * B, e);
#pragma unroll
      for (int i = 0; i < B; ++i) d[i] -= e[i];
    } else {
#pragma unroll
      for (int i = 0; i < B; ++i) d[i] = 0;
    }
    int s = satd_subblock<B, G::S>(d, lane);
    // one lane per subblock (its first sample row) contributes
    total += ((c / G::P) % B == 0) ? s : 0;
  }
#pragma unroll
  for (int h = 1; h < G::LR; h <<= 1) total += __shfl_xor_sync(kFullMask, total, h);
  return total;
}

}  // namespace kvz
