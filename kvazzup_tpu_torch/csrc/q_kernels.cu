// Quantization, dequantization and Hadamard SATD for the CTB16 encode path,
// written for Hopper (sm_90a).  Built with plain nvcc into a shared library
// with a C interface; each entry point launches on the caller's stream and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.  All arithmetic is int32, bit-identical to the plain PyTorch
// versions in kvazzup_tpu_torch/ops/hopper_q.py.
//
// kvz_quant replaces kvazzup_tpu/ops/pallas_q.py `_quant_kernel`
// (wrapper `quantize_2d`).  Bound: bytes.  Per coefficient it reads 4 B and
// writes 4 B, plus 8 B per row of qp/deadzone; at the 1080p IDR prepass
// (8160 x 3 rows of 256) that is 16 MB per call, about 5 us of HBM time at
// 3.35 TB/s.  In the CTB16 wave it runs on 68 rows, where launch latency
// dominates.  Design: one thread per coefficient, a fused single pass
// (load, scale, deadzone, shift, clip, sign, store), the six scale factors
// in __constant__ memory, the per-row qp/deadzone read through the cache.
//
// kvz_dequant replaces pallas_q.py `_dequant_kernel` (wrapper
// `dequantize_2d`).  Bound: bytes (4 B in, 4 B out per level).  Same
// one-thread-per-element fused pass; both shift directions are computed
// branch-free from the per-row qp.
//
// kvz_satd replaces pallas_q.py `_satd_kernel` (wrapper `satd_2d`).  The
// Pallas kernel multiplies the difference by a (K, K) f32 Kronecker
// Hadamard matrix and sums subblocks with a 0/1 selector matmul, because
// the TPU's matrix unit was the cheap resource.  Here the butterflies run
// in int32 registers and across lanes (csrc/satd_warp.cuh): exact by
// construction, no weights moved.  Bound: bytes; the 1080p P-frame ME cost
// reads 2 x 8160 x 256 x 4 B = 16.7 MB per call.  Design for that bound:
// the lanes of a warp hold consecutive 8-sample chunks of a row, so a 16x16
// row is one contiguous 1 KB warp load of 16-byte vectors (two per operand
// and lane); the vertical butterfly is three shuffle stages; one warp per
// 16x16, 32x32 or 64x64 row, several 4x4 / 8x8 rows per warp, 8 warps per
// CTA, so the ME call has 1020 CTAs for 132 SMs.  A 64x64 row (the CTB64
// path's CU64 costs: 510 rows at 1080p) takes 16 iterations of four
// 8x8 subblocks each.  The intra-sweep form broadcasts
// the original block over the 35 predictions (b row = a row / group), so
// it reads a once and b 35x less.

#include <cuda_runtime.h>
#include <stdint.h>

#include "satd_warp.cuh"

__constant__ int kQuantScales[6] = {26214, 23302, 20560, 18396, 16384, 14564};
__constant__ int kDequantScales[6] = {40, 45, 51, 57, 64, 72};

namespace {

__global__ void quant_kernel(const int* __restrict__ coef,
                             const int* __restrict__ qp,
                             const int* __restrict__ dz,
                             int* __restrict__ out, long long n, int k,
                             int log2, int bd) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int row = (int)(i / k);
  int q = __ldg(qp + row);
  int per = q / 6, rem = q % 6;
  int qbits = 29 - bd + per - log2;
  int offset = __ldg(dz + row) << (qbits - 9);
  int c = __ldg(coef + i);
  // int32 wrap-around semantics, as in the reference (unsigned math is
  // defined on overflow; the shift is arithmetic on the signed result)
  unsigned ac = c < 0 ? 0u - (unsigned)c : (unsigned)c;
  int mag = (int)(ac * (unsigned)kQuantScales[rem] + (unsigned)offset) >> qbits;
  mag = min(max(mag, 0), 32767);
  out[i] = c < 0 ? -mag : mag;
}

__global__ void dequant_kernel(const int* __restrict__ lev,
                               const int* __restrict__ qp,
                               int* __restrict__ out, long long n, int k,
                               int log2, int bd) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int row = (int)(i / k);
  int q = __ldg(qp + row);
  int per = q / 6, rem = q % 6;
  int sh = bd + log2 - 5 - per;
  unsigned x = (unsigned)__ldg(lev + i) * (unsigned)(kDequantScales[rem] * 16);
  int rsh = max(sh, 1);
  int d = sh > 0 ? (int)(x + (1u << (rsh - 1))) >> rsh
                 : (int)(x << max(-sh, 0));
  out[i] = min(max(d, -32768), 32767);
}

// One warp per SatdGeom<B, N>::RW rows; 8 warps per CTA.
template <int B, int N>
__global__ void satd_kernel(const int* __restrict__ a,
                            const int* __restrict__ b,
                            int* __restrict__ out, int rows, int group) {
  using G = kvz::SatdGeom<B, N>;
  int lane = threadIdx.x & 31;
  long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  long long row = warp * G::RW + lane / G::LR;
  bool live = row < rows;
  long long r = live ? row : 0;
  int total = kvz::satd_row<B, N>(a + r * (N * N), b + (r / group) * (N * N), lane, live);
  if (live && lane % G::LR == 0) out[row] = total;
}

template <int B, int N>
cudaError_t launch_satd(const int* a, const int* b, int* out, int rows,
                        int group, cudaStream_t stream) {
  const int threads = 256;
  const int rows_per_cta = (threads / 32) * kvz::SatdGeom<B, N>::RW;
  unsigned blocks = (unsigned)((rows + rows_per_cta - 1) / rows_per_cta);
  satd_kernel<B, N><<<blocks, threads, 0, stream>>>(a, b, out, rows, group);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int kvz_quant(const void* coef, const void* qp, const void* dz, void* out,
              int rows, int k, int log2, int bd, void* stream) {
  long long n = (long long)rows * k;
  if (n == 0) return 0;
  const int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  quant_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)coef, (const int*)qp, (const int*)dz, (int*)out, n, k, log2,
      bd);
  return (int)cudaGetLastError();
}

int kvz_dequant(const void* lev, const void* qp, void* out, int rows, int k,
                int log2, int bd, void* stream) {
  long long n = (long long)rows * k;
  if (n == 0) return 0;
  const int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  dequant_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)lev, (const int*)qp, (int*)out, n, k, log2, bd);
  return (int)cudaGetLastError();
}

// a: (rows, n*n) int32; b: (rows / group, n*n) int32; out: (rows,) int32;
// a and b 16-byte aligned (vector loads).
int kvz_satd(const void* a, const void* b, void* out, int rows, int group,
             int log2, void* stream) {
  if (rows == 0) return 0;
  if (((uintptr_t)a | (uintptr_t)b) & 15) return (int)cudaErrorMisalignedAddress;
  const int* pa = (const int*)a;
  const int* pb = (const int*)b;
  int* po = (int*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (log2) {
    case 2: return (int)launch_satd<4, 4>(pa, pb, po, rows, group, s);
    case 3: return (int)launch_satd<8, 8>(pa, pb, po, rows, group, s);
    case 4: return (int)launch_satd<8, 16>(pa, pb, po, rows, group, s);
    case 5: return (int)launch_satd<8, 32>(pa, pb, po, rows, group, s);
    case 6: return (int)launch_satd<8, 64>(pa, pb, po, rows, group, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
