// Residual coding of the CTB16 encode path, written for Hopper (sm_90a):
// residual -> forward transform -> quant -> dequant -> inverse transform ->
// reconstruction of whole blocks in one kernel.  Built with plain nvcc into
// the port's shared library; the C entry point launches on the caller's
// stream and returns cudaGetLastError().  All arithmetic is int32 and
// element-identical to the plain chain `code_residual_rows_plain` in
// kvazzup_tpu_torch/ops/hopper_q.py.
//
// Replaces kvazzup_tpu/ops/pallas_q.py `_quant_kernel` (:56) and
// `_dequant_kernel` (:70), together with the reference's transforms around
// them (kvazzup_tpu/ops/ctu_kernels.py `fwd_transform_flat` /
// `inv_transform_flat`).  Those transforms are float32 Kronecker matmuls
// with an 8-bit limb split, because the TPU's matrix unit was the cheap
// resource.  Here every stage is exact in plain int32: |residual| <= 255,
// the row sums of |DCT-16| are <= 1024 and its column sums <= 940, and the
// inverse input is clipped to int16, so no stage sum reaches 2^26.
//
// Bound: bytes.  Per sample it reads orig and pred and writes the level and
// the recon, 16 B (orig once per group of rows), plus qp and the intra flag
// per row.  A 1080p wave (68 lanes x (256 + 2 x 64) samples) moves 0.42 MB,
// about 0.12 us at 3.35 TB/s; the IDR mode prepass (8160 x 3 blocks of 256
// samples against one original each) 84 MB, about 25 us.  At the wave shape
// the launch, not the device, is the cost: so one launch covers luma, Cb
// and Cr of a wave, and the six stages of the old eager chain (about 50
// device launches per plane) run inside it.
//
// Design: one CTA per block row (a CTU lane), one thread per sample of the
// row's block in each plane (256 luma + 64 + 64 chroma = 384 threads for a
// CTB16 wave, 256 + 256 for the Cb and Cr TU16s of a CTB64 wave's CU32;
// a single-plane call has N^2 threads).  A plane is a "segment" with
// its own pointers, row count and size.  Each stage's result is staged in
// shared memory for the transpose to the next stage, with __syncthreads
// between stages.  The DCT-16 and DCT-8 matrices and their transposes are
// staged into shared memory at block start: the lanes of a warp read
// different matrix entries, which __constant__ memory would serialise.  The
// 8-point matrix is rows 0, 2, .., 14 of the 16-point one, columns 0..7.
//
// Stage order follows the plain chain on row-major y*N + x blocks: the
// forward transform runs down the columns first (T = M R), then along the
// rows (C = T M^T); the inverse likewise (T = M^T C, then R = T M).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ const int kDct16[256] = {
    64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64,
    90, 87, 80, 70, 57, 43, 25, 9, -9, -25, -43, -57, -70, -80, -87, -90,
    89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89,
    87, 57, 9, -43, -80, -90, -70, -25, 25, 70, 90, 80, 43, -9, -57, -87,
    83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83,
    80, 9, -70, -87, -25, 57, 90, 43, -43, -90, -57, 25, 87, 70, -9, -80,
    75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75,
    70, -43, -87, 9, 90, 25, -80, -57, 57, 80, -25, -90, -9, 87, 43, -70,
    64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64,
    57, -80, -25, 90, -9, -87, 43, 70, -70, -43, 87, 9, -90, 25, 80, -57,
    50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50,
    43, -90, 57, 25, -87, 70, 9, -80, 80, -9, -70, 87, -25, -57, 90, -43,
    36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36,
    25, -70, 90, -80, 43, 9, -57, 87, -87, 57, -9, -43, 80, -90, 70, -25,
    18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18,
    9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80, -70, 57, -43, 25, -9};

__constant__ int kQuantScales[6] = {26214, 23302, 20560, 18396, 16384, 14564};
__constant__ int kDequantScales[6] = {40, 45, 51, 57, 64, 72};

constexpr int kMaxThreads = 512;  // two 16x16 chroma blocks (or 16x16 + 2 x 8x8)

// One plane of the call: `rows` blocks of N x N = 2^log2 x 2^log2 samples.
// orig and qp hold one entry per group of `group` rows.
struct Seg {
  const int* orig;
  const int* pred;
  const int* qp;
  int* lev;
  int* rec;
  int rows;
  int log2;
  int base;  // first thread (and shared-memory slot) of this plane
};

struct Args {
  Seg s[3];
  const uint8_t* intra;  // per-group intra flag, or null: `dz` for every row
  int group;
  int dz;
};

__device__ __forceinline__ int clip16(int v) { return min(max(v, -32768), 32767); }

__global__ void __launch_bounds__(kMaxThreads) code_residual_kernel(Args a) {
  constexpr int bd = 8;
  __shared__ int m16[256], mt16[256], m8[64], mt8[64];
  __shared__ int A[kMaxThreads], B[kMaxThreads];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const int v = kDct16[i];
    m16[i] = v;
    mt16[(i & 15) * 16 + (i >> 4)] = v;
    if (i < 64) {
      const int k = i >> 3, j = i & 7, w = kDct16[2 * k * 16 + j];
      m8[i] = w;
      mt8[j * 8 + k] = w;
    }
  }
  const int t = threadIdx.x;
  const Seg sg = t >= a.s[2].base ? a.s[2] : t >= a.s[1].base ? a.s[1] : a.s[0];
  const int log2 = sg.log2, n = 1 << log2, i = t - sg.base;
  const int y = i >> log2, x = i & (n - 1);
  const int* M = log2 == 4 ? m16 : m8;    // M[k * n + j] = M(k, j)
  const int* Mt = log2 == 4 ? mt16 : mt8;  // Mt[j * n + k] = M(k, j)
  const int r = blockIdx.x;
  const bool live = r < sg.rows;
  const int g = r / a.group;
  int* As = A + sg.base;
  int* Bs = B + sg.base;

  int p = 0, o = 0;
  if (live) {
    p = __ldg(sg.pred + (long long)r * n * n + i);
    o = __ldg(sg.orig + (long long)g * n * n + i);
  }
  As[i] = o - p;
  __syncthreads();  // also publishes the matrices

  // forward stage 1, down the columns: T(y, x) = sum_j M(y, j) R(j, x)
  const int s1 = log2 + bd - 9;
  int acc = 0;
  for (int j = 0; j < n; ++j) acc += M[y * n + j] * As[j * n + x];
  Bs[i] = (acc + (1 << (s1 - 1))) >> s1;
  __syncthreads();

  // forward stage 2, along the rows: C(y, x) = sum_j T(y, j) M(x, j)
  const int s2 = log2 + 6;
  acc = 0;
  for (int j = 0; j < n; ++j) acc += Bs[y * n + j] * Mt[j * n + x];
  const int c = (acc + (1 << (s2 - 1))) >> s2;

  // quant, with the int32 wrap-around of the plain version, then dequant
  const int q = live ? __ldg(sg.qp + g) : 0;
  const int dz = a.intra ? (live && __ldg(a.intra + g) ? 171 : 85) : a.dz;
  const int per = q / 6, rem = q % 6;
  const int qbits = 29 - bd + per - log2;
  const unsigned ac = c < 0 ? 0u - (unsigned)c : (unsigned)c;
  int mag = (int)(ac * (unsigned)kQuantScales[rem] + ((unsigned)dz << (qbits - 9))) >> qbits;
  mag = min(max(mag, 0), 32767);
  const int lev = c < 0 ? -mag : mag;
  const int sh = bd + log2 - 5 - per;
  const unsigned xs = (unsigned)lev * (unsigned)(kDequantScales[rem] * 16);
  const int deq = clip16(sh > 0 ? (int)(xs + (1u << (sh - 1))) >> sh : (int)(xs << -sh));
  if (live) sg.lev[(long long)r * n * n + i] = lev;
  As[i] = deq;
  __syncthreads();

  // inverse stage 1, down the columns: T(y, x) = sum_u M(u, y) C(u, x)
  acc = 0;
  for (int u = 0; u < n; ++u) acc += Mt[y * n + u] * As[u * n + x];
  Bs[i] = clip16((acc + 64) >> 7);
  __syncthreads();

  // inverse stage 2, along the rows: R(y, x) = sum_u T(y, u) M(u, x)
  acc = 0;
  for (int u = 0; u < n; ++u) acc += Bs[y * n + u] * M[u * n + x];
  const int res = clip16((acc + (1 << (19 - bd))) >> (20 - bd));
  if (live) sg.rec[(long long)r * n * n + i] = min(max(p + res, 0), (1 << bd) - 1);
}

}  // namespace

extern "C" {

// Up to three planes k = 0, 1, 2, each (orig_k, pred_k, qp_k, lev_k, rec_k,
// rows_k, log2_k); a plane with 0 rows is unused.  pred, lev, rec: (rows,
// N^2) int32; orig: (rows / group, N^2) int32; qp: (rows / group,) int32.
// intra: (rows / group,) uint8 flags shared by the planes, or null to use
// the deadzone numerator `dz` (171 intra, 85 inter) for every row.  log2 is
// 3 or 4, at most 512 samples per row over the planes, bit depth 8.
int kvz_code_residual(const void* o0, const void* p0, const void* q0, void* l0,
                      void* r0, int rows0, int log20,
                      const void* o1, const void* p1, const void* q1, void* l1,
                      void* r1, int rows1, int log21,
                      const void* o2, const void* p2, const void* q2, void* l2,
                      void* r2, int rows2, int log22,
                      const void* intra, int group, int dz, void* stream) {
  const void* o[3] = {o0, o1, o2};
  const void* p[3] = {p0, p1, p2};
  const void* q[3] = {q0, q1, q2};
  void* l[3] = {l0, l1, l2};
  void* r[3] = {r0, r1, r2};
  const int rows[3] = {rows0, rows1, rows2};
  const int lg[3] = {log20, log21, log22};
  if (group < 1) return (int)cudaErrorInvalidValue;
  Args a;
  int threads = 0, grid = 0;
  for (int k = 0; k < 3; ++k) {
    if (rows[k] < 0 || (rows[k] > 0 && lg[k] != 3 && lg[k] != 4))
      return (int)cudaErrorInvalidValue;
    a.s[k] = Seg{(const int*)o[k], (const int*)p[k], (const int*)q[k], (int*)l[k],
                 (int*)r[k], rows[k], lg[k], threads};
    if (rows[k] > 0) threads += 1 << (2 * lg[k]);
    grid = max(grid, rows[k]);
  }
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  if (grid == 0) return 0;
  // an unused plane owns no thread: its base lies past the last one
  for (int k = 1; k < 3; ++k)
    if (rows[k] == 0) a.s[k].base = kMaxThreads;
  a.intra = (const uint8_t*)intra;
  a.group = group;
  a.dz = dz;
  code_residual_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
