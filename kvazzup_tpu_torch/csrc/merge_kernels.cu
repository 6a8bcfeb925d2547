// The P wave's merge-candidate search for the CTB16 path, written for
// Hopper (sm_90a).  Built with plain nvcc into the port's shared library
// with a C interface; the entry point launches on the caller's stream and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.  Bit-identical to `merge_search_plain` in
// kvazzup_tpu_torch/ops/merge.py.  Built without --use_fast_math: the cost
// is one explicit __fmaf_rn.
//
// kvz_merge_search fuses, for every lane of one wave and all K merge
// candidates, what the reference's merge block computes
// (kvazzup_tpu/encoder/frame_inter.py:471-490): luma MC of each candidate
// (mc_luma_window_batch: 8-tap horizontal pass with no shift, vertical
// pass, >> 6, then (p + 32) >> 6 clipped to 0..255, samples outside the
// 55x55 window read as 0), its SATD against the original (the Pallas
// `_satd_kernel`, kvazzup_tpu/ops/pallas_q.py:85, through the warp SATD of
// csrc/satd_warp.cuh), the cost fma(lambda, 2 + merge_idx bits, SATD) and
// the first-index argmin.  The eager form of the same block is about 110
// device operations at K = 1 and 530 at K = 5; here it is one launch.
//
// Design: one CTA of 256 threads per lane.  The lane's 55x55 uint8 window
// is read straight from the sheared reference strips (a strided view:
// base, lane stride, row stride) into shared memory, with the lane's
// 16x16 original.  The horizontal pass of every candidate (K x 23 x 16
// sums) runs at once, then the vertical pass (K x 256 predictions), each
// behind one barrier; warp k then takes candidate k's SATD, thread 0 the
// argmin, and the CTA writes the chosen prediction.  Bound: bytes, about
// 5.1 KB per lane, 0.1 us for a 68-lane wave: the launch is the cost.

#include <cuda_runtime.h>
#include <stdint.h>

#include "satd_warp.cuh"

// Table 8-11: luma interpolation coefficients per quarter-pel phase
__constant__ int kLumaFilter[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                                      {-1, 4, -10, 58, 17, -5, 1, 0},
                                      {-1, 4, -11, 40, 40, -11, 4, -1},
                                      {0, 1, -5, 17, 58, -10, 4, -1}};

namespace {

constexpr int kN = 16;               // CTB16 luma block
constexpr int kWin = 55;             // kN + 2 * 16 (search range) + 3 + 4 taps
constexpr int kExt = kN + 7;         // rows of the horizontal pass
constexpr int kMaxCands = 5;
constexpr int kThreads = 256;        // one per output sample

__global__ void __launch_bounds__(kThreads)
merge_search_kernel(const uint8_t* __restrict__ win, long long lane_stride,
                    long long row_stride, const int* __restrict__ cands,
                    const int* __restrict__ orig, const float* __restrict__ lam,
                    int lanes, int k_cands, int org, int* __restrict__ idx_out,
                    float* __restrict__ cost_out, int* __restrict__ mv_out,
                    int* __restrict__ pred_out) {
  __shared__ uint8_t win_s[kWin * kWin];
  __shared__ __align__(16) int orig_s[kN * kN];
  __shared__ int acc_s[kMaxCands][kExt * kN];
  __shared__ __align__(16) int pred_s[kMaxCands][kN * kN];
  __shared__ int satd_s[kMaxCands];
  __shared__ int best_s;

  const int lane_id = blockIdx.x;
  const int t = threadIdx.x;
  const uint8_t* w = win + lane_id * lane_stride;
  for (int i = t; i < kWin * kWin; i += kThreads) {
    int r = i / kWin;
    win_s[i] = w[r * row_stride + (i - r * kWin)];
  }
  orig_s[t] = orig[lane_id * (kN * kN) + t];
  __syncthreads();

  // horizontal 8-tap pass of every candidate, no shift (14-bit domain)
  for (int i = t; i < k_cands * kExt * kN; i += kThreads) {
    int k = i / (kExt * kN), j = i - k * (kExt * kN);
    int r = j / kN, x = j - r * kN;
    const int* mv = cands + 2 * (k * lanes + lane_id);
    int mvx = mv[0], mvy = mv[1];
    int wy = org + (mvy >> 2) - 3 + r;
    int wx = org + (mvx >> 2) - 3 + x;
    const int* f = kLumaFilter[mvx & 3];
    int s = 0;
    if (wy >= 0 && wy < kWin) {
#pragma unroll
      for (int tap = 0; tap < 8; ++tap) {
        int xx = wx + tap;
        int v = (xx >= 0 && xx < kWin) ? win_s[wy * kWin + xx] : 0;
        s += f[tap] * v;
      }
    }
    acc_s[k][j] = s;
  }
  __syncthreads();

  // vertical pass, >> 6, then uni-prediction rounding and clip
  {
    int y = t / kN, x = t - y * kN;
    for (int k = 0; k < k_cands; ++k) {
      const int* f = kLumaFilter[cands[2 * (k * lanes + lane_id) + 1] & 3];
      int s = 0;
#pragma unroll
      for (int tap = 0; tap < 8; ++tap) s += f[tap] * acc_s[k][(y + tap) * kN + x];
      int p = ((s >> 6) + 32) >> 6;
      pred_s[k][t] = min(max(p, 0), 255);
    }
  }
  __syncthreads();

  // SATD of candidate k in warp k (warp-uniform: whole warps take part)
  const int warp = t >> 5, lane = t & 31;
  if (warp < k_cands) {
    int s = kvz::satd_row<8, kN>(pred_s[warp], orig_s, lane, true);
    if (lane == 0) satd_s[warp] = s;
  }
  __syncthreads();

  if (t == 0) {
    // cost = lambda * (2 + merge_idx bits) + SATD with one rounding, as the
    // reference's fused CPU program; strict < keeps the first of equal costs
    float lamf = lam[lane_id];
    int best = 0;
    float best_cost = 0.0f;
    for (int k = 0; k < k_cands; ++k) {
      int bits = k_cands > 1 ? min(k + 1, k_cands - 1) : 0;
      float c = __fmaf_rn(lamf, 2.0f + (float)bits, (float)satd_s[k]);
      if (k == 0 || c < best_cost) {
        best = k;
        best_cost = c;
      }
    }
    idx_out[lane_id] = best;
    cost_out[lane_id] = best_cost;
    mv_out[2 * lane_id] = cands[2 * (best * lanes + lane_id)];
    mv_out[2 * lane_id + 1] = cands[2 * (best * lanes + lane_id) + 1];
    best_s = best;
  }
  __syncthreads();
  pred_out[lane_id * (kN * kN) + t] = pred_s[best_s][t];
}

}  // namespace

extern "C" {

// One wave: win points at lane 0's window (row 0, the clamped start
// column) of the (lanes, 55, total) uint8 strips, lane_stride / row_stride
// in bytes; cands (k_cands, lanes, 2) int32 quarter-pel MVs; orig (lanes,
// 256) int32; lam (lanes,) float32.  Outputs: idx (lanes,) int32, cost
// (lanes,) float32, mv (lanes, 2) int32, pred (lanes, 256) int32.
int kvz_merge_search(const void* win, long long lane_stride, long long row_stride,
                     const void* cands, const void* orig, const void* lam,
                     int lanes, int k_cands, int org, void* idx, void* cost,
                     void* mv, void* pred, void* stream) {
  if (lanes == 0) return 0;
  if (k_cands < 1 || k_cands > kMaxCands) return (int)cudaErrorInvalidValue;
  merge_search_kernel<<<lanes, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)win, lane_stride, row_stride, (const int*)cands,
      (const int*)orig, (const float*)lam, lanes, k_cands, org, (int*)idx,
      (float*)cost, (int*)mv, (int*)pred);
  return (int)cudaGetLastError();
}

}  // extern "C"
