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
// the TPU's matrix unit was the cheap resource.  Here each thread owns one
// 8x8 (or 4x4) subblock of one row and runs the Hadamard butterflies in
// int32 registers: exact by construction, no weights moved.  The row's
// subblock sums are combined with warp shuffles.  Bound: bytes; the 1080p
// P-frame ME cost reads 2 x 8160 x 256 x 4 B = 16.7 MB per call.  The
// intra-sweep form broadcasts the original block over the 35 predictions
// (b row = a row / group), so it reads a once and b 35x less.

#include <cuda_runtime.h>
#include <stdint.h>

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

// In-place Walsh-Hadamard butterfly over B values spaced `stride` apart.
template <int B>
__device__ __forceinline__ void butterfly(int* v, int stride) {
#pragma unroll
  for (int h = 1; h < B; h <<= 1) {
#pragma unroll
    for (int i = 0; i < B; i += 2 * h) {
#pragma unroll
      for (int j = i; j < i + h; ++j) {
        int a = v[j * stride], b = v[(j + h) * stride];
        v[j * stride] = a + b;
        v[(j + h) * stride] = a - b;
      }
    }
  }
}

// One thread per (row, B x B subblock); NSB subblocks per row, a power of
// two <= 16, so a row's threads sit in one warp.
template <int B, int NSB>
__global__ void satd_kernel(const int* __restrict__ a,
                            const int* __restrict__ b,
                            int* __restrict__ out, int rows, int group,
                            int n) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long row = t / NSB;
  int sb = (int)(t % NSB);
  bool live = row < rows;
  int total = 0;
  if (live) {
    int per_side = n / B;
    int y0 = (sb / per_side) * B, x0 = (sb % per_side) * B;
    const int* pa = a + row * (long long)n * n + y0 * n + x0;
    const int* pb = b + (row / group) * (long long)n * n + y0 * n + x0;
    int d[B * B];
#pragma unroll
    for (int y = 0; y < B; ++y) {
#pragma unroll
      for (int x = 0; x < B; ++x) d[y * B + x] = __ldg(pa + y * n + x) - __ldg(pb + y * n + x);
    }
#pragma unroll
    for (int y = 0; y < B; ++y) butterfly<B>(d + y * B, 1);
#pragma unroll
    for (int x = 0; x < B; ++x) butterfly<B>(d + x, B);
    int s = 0;
#pragma unroll
    for (int i = 0; i < B * B; ++i) s += abs(d[i]);
    total = B == 8 ? (s + 2) >> 2 : (s + 1) >> 1;
  }
  // Sum the NSB subblocks of the row (lanes are contiguous within a warp).
#pragma unroll
  for (int off = NSB / 2; off > 0; off >>= 1)
    total += __shfl_xor_sync(0xffffffffu, total, off, NSB);
  if (live && sb == 0) out[row] = total;
}

template <int B, int NSB>
cudaError_t launch_satd(const int* a, const int* b, int* out, int rows,
                        int group, int n, cudaStream_t stream) {
  const int threads = 256;
  long long work = (long long)rows * NSB;
  unsigned blocks = (unsigned)((work + threads - 1) / threads);
  satd_kernel<B, NSB><<<blocks, threads, 0, stream>>>(a, b, out, rows, group, n);
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

// a: (rows, n*n) int32; b: (rows / group, n*n) int32; out: (rows,) int32.
int kvz_satd(const void* a, const void* b, void* out, int rows, int group,
             int log2, void* stream) {
  if (rows == 0) return 0;
  const int* pa = (const int*)a;
  const int* pb = (const int*)b;
  int* po = (int*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (log2) {
    case 2: return (int)launch_satd<4, 1>(pa, pb, po, rows, group, 4, s);
    case 3: return (int)launch_satd<8, 1>(pa, pb, po, rows, group, 8, s);
    case 4: return (int)launch_satd<8, 4>(pa, pb, po, rows, group, 16, s);
    case 5: return (int)launch_satd<8, 16>(pa, pb, po, rows, group, 32, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
