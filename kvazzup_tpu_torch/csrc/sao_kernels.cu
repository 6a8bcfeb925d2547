// Sample Adaptive Offset application (H.265 8.7.3) for 8-bit planes,
// written for Hopper (sm_90a).  Built with plain nvcc into the port's
// shared library with a C interface; the entry point launches on the
// caller's stream and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.  Bit-identical to `sao_apply_plain` in
// kvazzup_tpu_torch/ops/sao.py.
//
// kvz_sao_apply replaces kvazzup_tpu/ops/sao.py `_sao_strip_kernel`
// (wrapper `_sao_apply_pallas`).  The Pallas kernel walks CTB-row strips
// with one-row halos and upsamples each CTB's parameters to pixels with a
// (cbw, W) 0/1 selector matmul, because Mosaic rejected the repeat form.
// Here one thread owns one output sample and reads its CTB's type, class or
// band position and four offsets at (y / ctb, x / ctb) directly.
//
// Neighbours are read from the unmodified input and the result goes to a
// separate output, so every neighbour is the pre-SAO sample.  Edge classes
// drop the samples whose neighbour pair leaves the picture: class 0
// (horizontal) at the first and last column, class 1 (vertical) at the
// first and last row, the diagonals at both.
//
// Bound: bytes.  One read and one write of each 8-bit sample plus 24 B of
// parameters per CTB; the three planes of a 1920x1088 frame move
// 2 * (1920*1088 + 2*960*544) B = 6.27 MB, about 1.9 us at 3.35 TB/s, so each
// of the three launches a frame is bound by launch latency instead.
// Neighbour reads hit the L1/L2 copies of the rows the warp's neighbours
// already loaded.

#include <cuda_runtime.h>
#include <stdint.h>

// (dx0, dy0, dx1, dy1) per EO class: 0 horizontal, 1 vertical, 2 135 deg,
// 3 45 deg.
__constant__ int kEoDirs[4][4] = {
    {-1, 0, 1, 0}, {0, -1, 0, 1}, {-1, -1, 1, 1}, {1, -1, -1, 1}};

namespace {

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

__global__ void sao_apply_kernel(const uint8_t* __restrict__ rec,
                                 const int* __restrict__ typ,
                                 const int* __restrict__ aux,
                                 const int* __restrict__ offs,
                                 uint8_t* __restrict__ out, int h, int w,
                                 int ctb, int cbw) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  long long i = (long long)y * w + x;
  int r = rec[i];
  int c = (y / ctb) * cbw + x / ctb;
  int t = __ldg(typ + c);
  int delta = 0;
  if (t == 2) {  // edge offset
    int cls = __ldg(aux + c);
    if (cls >= 0 && cls < 4) {
      int x0 = x + kEoDirs[cls][0], y0 = y + kEoDirs[cls][1];
      int x1 = x + kEoDirs[cls][2], y1 = y + kEoDirs[cls][3];
      if (x0 >= 0 && x0 < w && x1 >= 0 && x1 < w && y0 >= 0 && y0 < h &&
          y1 >= 0 && y1 < h) {
        int raw = 2 + sgn(r - rec[(long long)y0 * w + x0]) +
                  sgn(r - rec[(long long)y1 * w + x1]);
        // 0, 1, 2, 3, 4 -> categories 1, 2, 0 (none), 3, 4
        int cat = raw == 2 ? 0 : (raw < 2 ? raw + 1 : raw);
        if (cat) delta = __ldg(offs + 4 * c + cat - 1);
      }
    }
  } else if (t == 1) {  // band offset: 32 bands of 8 values, window wraps
    int brel = ((r >> 3) - __ldg(aux + c)) & 31;
    if (brel < 4) delta = __ldg(offs + 4 * c + brel);
  }
  out[i] = (uint8_t)min(max(r + delta, 0), 255);
}

}  // namespace

extern "C" {

// rec, out: (h, w) uint8; typ, aux: (ceil(h/ctb), cbw) int32;
// offs: (ceil(h/ctb), cbw, 4) int32, cbw = ceil(w/ctb).
int kvz_sao_apply(const void* rec, const void* typ, const void* aux,
                  const void* offs, void* out, int h, int w, int ctb, int cbw,
                  void* stream) {
  if (h == 0 || w == 0) return 0;
  if (ctb <= 0) return (int)cudaErrorInvalidValue;
  dim3 block(32, 8);
  dim3 grid((unsigned)((w + block.x - 1) / block.x),
            (unsigned)((h + block.y - 1) / block.y));
  sao_apply_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rec, (const int*)typ, (const int*)aux, (const int*)offs,
      (uint8_t*)out, h, w, ctb, cbw);
  return (int)cudaGetLastError();
}

}  // extern "C"
