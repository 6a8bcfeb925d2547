// Sample Adaptive Offset application (H.265 8.7.3) for 8-bit planes
// (uint8) and 9- to 16-bit planes (uint16, the reference's bd 10 mode),
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
//
// Bound: bytes.  One read and one write of each sample plus 24 B of
// parameters per CTB; the three planes of a 1920x1088 frame move
// 2 * (1920*1088 + 2*960*544) B = 6.27 MB, about 1.9 us at 3.35 TB/s, so a
// launch per plane costs more than the work.  Design: one launch covers up
// to three planes (grid.z = plane, each plane's geometry in a by-value
// struct: luma at ctb 16, Cb and Cr at ctb 8 in the encoder).  A CTA of
// 32 x 8 threads owns a 128 x 32 tile; each thread owns 4 adjacent samples
// in each of 4 rows, 8 rows apart, so a 1080p frame's three planes are 782
// CTAs, all resident at once on 132 SMs (at one sample a thread the same
// work took some 6,000 CTAs in turn, and the CTAs' latency, not the bytes,
// set the time).  The tile and a one-sample halo are staged in shared
// memory with one load of 4 samples (32 bits at 8 bits a sample, 64 at 16;
// coalesced; sample loads only at the picture's edge or where a row is not
// aligned to 4 samples), and the CTB parameters the tile touches are
// staged once.  The kernel is a template on the sample type; the band
// shift (bd - 5) and the clip to 2^bd - 1 come from the bit depth.  Neighbours are read from
// the staged, unmodified input and the result goes to a separate output,
// so every neighbour is the pre-SAO sample.  Edge classes drop the samples
// whose neighbour pair leaves the picture: class 0 (horizontal) at the
// first and last column, class 1 (vertical) at the first and last row,
// the diagonals at both.  Any width works, down to a tail narrower than
// one word; the CTB size must be a multiple of 4, so that a thread's 4
// samples share a CTB.  Per sample the work is a few shared-memory loads
// and selects: each CTB's offsets are staged as a table indexed by EO
// category or band, with its class's neighbour offsets in the tile and its
// picture-edge mask, so no sample divides by the CTB size or reads the
// class table (a first version that did took 0.013 ms for a 1080p luma
// plane on an H100).

#include <cuda_runtime.h>
#include <stdint.h>

// (dx, dy) of the first neighbour per EO class (0 horizontal, 1 vertical,
// 2 135 deg, 3 45 deg); the second is its mirror (-dx, -dy).
__constant__ int kEoDirs[4][2] = {{-1, 0}, {0, -1}, {-1, -1}, {1, -1}};

namespace {

constexpr int kThreadsX = 32, kThreadsY = 8;
constexpr int kRowsPerThread = 4;
constexpr int kTileW = 4 * kThreadsX, kTileH = kThreadsY * kRowsPerThread;  // 128 x 32
constexpr int kRowSamples = kTileW + 8;          // a halo quad each side
constexpr int kQuads = kRowSamples / 4;
constexpr int kMinCtb = 4;
// CTBs a tile can touch at ctb >= kMinCtb: 9 rows of 33
constexpr int kMaxCtbs = ((kTileH - 2) / kMinCtb + 2) * ((kTileW - 2) / kMinCtb + 2);

// four adjacent samples, moved as one 32- or 64-bit word
template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T s[4];
};

template <typename T>
struct SaoPlane {
  const T* rec;
  T* out;
  const int* typ;
  const int* aux;
  const int* offs;
  int h, w, ctb, cbw;
};

template <typename T>
struct SaoPlanes {
  SaoPlane<T> p[3];
};

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

template <typename T>
__global__ void __launch_bounds__(kThreadsX * kThreadsY) sao_apply_kernel(SaoPlanes<T> planes,
                                                                          int bd) {
  const SaoPlane<T>& pl = planes.p[blockIdx.z];
  const int h = pl.h, w = pl.w, ctb = pl.ctb;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  if (x0 >= w || y0 >= h) return;  // the whole CTA: this plane is smaller

  __shared__ Quad<T> tile_q[(kTileH + 2) * kQuads];
  T* tile = tile_q[0].s;
  __shared__ int pmode[kMaxCtbs], paux[kMaxCtbs], pmask[kMaxCtbs];
  __shared__ int ptab[kMaxCtbs][5], pnb[kMaxCtbs][2];
  constexpr uintptr_t kAlign = sizeof(Quad<T>) - 1;
  const bool vec = ((w & 3) == 0) && ((((uintptr_t)pl.rec) | ((uintptr_t)pl.out)) & kAlign) == 0;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int n_threads = kThreadsX * kThreadsY;
  const int band_shift = bd - 5, maxval = (1 << bd) - 1;

  // tile rows y0 - 1 .. y0 + kTileH, columns x0 - 4 .. x0 + kTileW + 3
  for (int i = tid; i < (kTileH + 2) * kQuads; i += n_threads) {
    int r = i / kQuads, c = i - r * kQuads;
    int y = y0 - 1 + r, x = x0 - 4 + 4 * c;
    Quad<T> v = {{0, 0, 0, 0}};
    if (y >= 0 && y < h) {
      const T* row = pl.rec + (long long)y * w;
      if (vec && x >= 0 && x + 4 <= w) {
        v = *reinterpret_cast<const Quad<T>*>(row + x);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (x + b >= 0 && x + b < w) v.s[b] = row[x + b];
      }
    }
    tile_q[i] = v;
  }
  // The CTBs of the tile, each as: mode (0 none, 1 band, 2 edge), an
  // offset table indexed by EO category or by band position + 1 (entry 0 =
  // no offset), the band window's start, and for edge offset the two
  // neighbours' byte offsets in the staged tile and which picture edges
  // mask its class (bit 0: left / right, bit 1: top / bottom).
  const int cy0 = y0 / ctb, cx0 = x0 / ctb;
  const int ncx = (min(x0 + kTileW, w) - 1) / ctb - cx0 + 1;
  const int nc = ((min(y0 + kTileH, h) - 1) / ctb - cy0 + 1) * ncx;
  for (int i = tid; i < nc; i += n_threads) {
    int c = (cy0 + i / ncx) * pl.cbw + cx0 + i % ncx;
    int t = __ldg(pl.typ + c), a = __ldg(pl.aux + c);
    int mode = (t == 2 && a >= 0 && a < 4) ? 2 : (t == 1 ? 1 : 0);
    pmode[i] = mode;
    paux[i] = a;
    ptab[i][0] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) ptab[i][j + 1] = mode ? __ldg(pl.offs + 4 * c + j) : 0;
    if (mode == 2) {
      int dx = kEoDirs[a][0], dy = kEoDirs[a][1];
      pnb[i][0] = dy * kRowSamples + dx;
      pnb[i][1] = -dy * kRowSamples - dx;
      pmask[i] = (dx != 0) | ((dy != 0) << 1);
    }
  }
  __syncthreads();

  // a thread's 4 samples share a CTB column (ctb is a multiple of 4)
  const int lx = 4 * threadIdx.x, x = x0 + lx;
  if (x >= w) return;
  const int col = x / ctb - cx0;
  const bool whole_word = vec && x + 4 <= w;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int ly = threadIdx.y + i * kThreadsY, y = y0 + ly;
    if (y >= h) break;
    const T* p = tile + (ly + 1) * kRowSamples + 4 + lx;  // sample (y, x)
    const int slot = (y / ctb - cy0) * ncx + col;
    const int* tab = ptab[slot];
    Quad<T> res;
    if (pmode[slot] == 2) {  // edge offset
      const int o0 = pnb[slot][0], o1 = pnb[slot][1], m = pmask[slot];
      const bool v_edge = (m & 2) && (y == 0 || y == h - 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int r = p[j];
        int raw = 2 + sgn(r - p[j + o0]) + sgn(r - p[j + o1]);
        // 0, 1, 2, 3, 4 -> categories 1, 2, 0 (none), 3, 4
        int cat = raw == 2 ? 0 : (raw < 2 ? raw + 1 : raw);
        bool h_edge = (m & 1) && (x + j == 0 || x + j == w - 1);
        int d = (v_edge || h_edge) ? 0 : tab[cat];
        res.s[j] = (T)min(max(r + d, 0), maxval);
      }
    } else {  // band offset (32 bands, the window wraps), or none
      const int band = paux[slot];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int r = p[j];
        int brel = ((r >> band_shift) - band) & 31;
        res.s[j] = (T)min(max(r + tab[brel < 4 ? brel + 1 : 0], 0), maxval);
      }
    }
    T* orow = pl.out + (long long)y * w;
    if (whole_word) {
      *reinterpret_cast<Quad<T>*>(orow + x) = res;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x + j < w) orow[x + j] = res.s[j];
    }
  }
}

template <typename T>
int launch(const void* const* ptrs, const int* dims, int n_planes, int bd, cudaStream_t stream) {
  SaoPlanes<T> planes = {};
  int tiles_x = 0, tiles_y = 0;
  for (int i = 0; i < n_planes; ++i) {
    const void* const* q = ptrs + 5 * i;
    const int* d = dims + 4 * i;
    SaoPlane<T>& p = planes.p[i];
    p = {(const T*)q[0], (T*)q[4], (const int*)q[1], (const int*)q[2], (const int*)q[3],
         d[0], d[1], d[2], d[3]};
    if (p.ctb < kMinCtb || p.ctb % 4) return (int)cudaErrorInvalidValue;
    int tx = (p.w + kTileW - 1) / kTileW, ty = (p.h + kTileH - 1) / kTileH;
    tiles_x = tx > tiles_x ? tx : tiles_x;
    tiles_y = ty > tiles_y ? ty : tiles_y;
  }
  if (tiles_x == 0 || tiles_y == 0) return 0;
  dim3 grid((unsigned)tiles_x, (unsigned)tiles_y, (unsigned)n_planes);
  sao_apply_kernel<T><<<grid, dim3(kThreadsX, kThreadsY), 0, stream>>>(planes, bd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Up to three planes in one launch.  Plane i: rec_i, out_i (h_i, w_i),
// uint8 at bd 8 and uint16 at bd 9..16; typ_i, aux_i (ceil(h_i / ctb_i),
// cbw_i) int32; offs_i (.., cbw_i, 4) int32, cbw_i = ceil(w_i / ctb_i),
// ctb_i a multiple of 4.  Unused planes: null pointers and zero sizes.
int kvz_sao_apply(const void* rec0, const void* typ0, const void* aux0, const void* offs0,
                  void* out0, int h0, int w0, int ctb0, int cbw0,
                  const void* rec1, const void* typ1, const void* aux1, const void* offs1,
                  void* out1, int h1, int w1, int ctb1, int cbw1,
                  const void* rec2, const void* typ2, const void* aux2, const void* offs2,
                  void* out2, int h2, int w2, int ctb2, int cbw2, int n_planes, int bd,
                  void* stream) {
  if (n_planes < 1 || n_planes > 3 || bd < 8 || bd > 16) return (int)cudaErrorInvalidValue;
  const void* ptrs[15] = {rec0, typ0, aux0, offs0, out0, rec1, typ1, aux1, offs1, out1,
                          rec2, typ2, aux2, offs2, out2};
  const int dims[12] = {h0, w0, ctb0, cbw0, h1, w1, ctb1, cbw1, h2, w2, ctb2, cbw2};
  cudaStream_t st = (cudaStream_t)stream;
  return bd == 8 ? launch<uint8_t>(ptrs, dims, n_planes, bd, st)
                 : launch<uint16_t>(ptrs, dims, n_planes, bd, st);
}

}  // extern "C"
