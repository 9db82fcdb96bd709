// K2 thinthres / thincubic: non-max suppression of the edge magnitude
// along the unit gradient, with bicubic samples at +-1 and +-2 steps.
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_thin.py:_thin_kernel
// (thinthres_pallas / thincubic_pallas).  Reference: thinthres_f_f_f2
// oclimgutil.cl:456-471, thincubic_float_float :473-491, bicubic :65-94.
//
// Bound: device memory, 12 B read (em, vec) and 4 B written per pixel
// (14.7 MB at 720p).  Each pixel's four samples read 64 taps of em at
// data-dependent offsets in -3..+4 (thin.py:_R) and interpolate them with
// 20 Horner steps of ~12 float operations, so its float work and the 256
// bytes of taps a pixel reads from shared memory, not its device-memory
// bytes, set its time.  Each block owns a kTileRows x kTileCols output
// tile:
//   1. it loads its em window, rows and columns [tile - 3, tile + 4],
//      once into shared memory with coalesced loads, applying reflect-101
//      at the frame border while it loads;
//   2. for every window row r and every column s at which a sample's row
//      of 4 taps can start, it computes the part of bicubicSub that does
//      not depend on the fraction, a cell (A, B, C, p1; cell_of), once for
//      all the samples that read those taps (1.6 cells a pixel at 16 x 32
//      tiles, where a pixel's samples use 16);
//   3. each pixel's sample reads its 4 cells at constant offsets from one
//      shared address (no border arithmetic) and finishes each row with 5
//      float operations instead of 12, then the column with the full
//      bicubicSub.
// vec is read as one float2 a pixel; each thread owns kTileRows /
// kRowsPerPass pixels of a column.  The sample position, its truncation
// and every float operation of the Horner bicubicSub sequence are the
// plain version's, in its order (fused multiply-adds where the JAX
// reference has them), only computed once per cell, and --fmad=false keeps
// the flat-plateau tie am1 <= a0 exact: the output is bit-equal to one
// thread evaluating bicubicSub tap by tap.  The sample position is a float
// in frame columns, so its rounding depends on the column: a width tile of
// the width-tiled path (dist/tile.py) passes its frame column gx0 (0 for a
// whole frame), and the taps stay local.
//
// Batch form: b frames of h x w stacked on a leading axis, one grid with
// blockIdx.z = frame; frame z reads and writes only its own plane (its
// reflect-101 stays inside it), so b = 1 is the single-frame kernel and gx0
// is every frame's column offset.

#include "common.cuh"

namespace {

// output tile of a block: kTileRows x kTileCols pixels, kRowsPerPass rows
// of kTileCols threads
constexpr int kTileCols = 32;
constexpr int kTileRows = 16;
constexpr int kRowsPerPass = 8;
constexpr int kThreads = kTileCols * kRowsPerPass;
// tap offsets of a sample span -kHaloLo..+kHaloHi around its pixel
constexpr int kHaloLo = 3;
constexpr int kHaloHi = 4;
constexpr int kWinCols = kTileCols + kHaloLo + kHaloHi;
constexpr int kWinRows = kTileRows + kHaloLo + kHaloHi;
constexpr int kWinSize = kWinRows * kWinCols;
constexpr int kLoads = (kWinSize + kThreads - 1) / kThreads;
// cells a window row: a row of 4 taps starts at most kHaloLo + kHaloHi - 3
// columns past the tile
constexpr int kCells = kWinCols - 3;

// bicubicSub(p0, p1, p2, p3, x) =
//   u = fma(A, x, B); u = fma(u, x, C); u * x * 0.5 + p1 with
//   v = p1 - p2, w = p3 - p0, A = fma(v, 3, w),
//   B = fma(-4, v, (p0 - p1) - w), C = p2 - p0;
// a cell holds (A, B, C, p1) of the 4 taps that start at its column
__device__ __forceinline__ float4 cell_of(float p0, float p1, float p2,
                                          float p3) {
  const float v = p1 - p2;
  const float w = p3 - p0;
  // multiply-adds fused as in the JAX reference (ops/fp.py)
  return make_float4(__fmaf_rn(v, 3.0f, w), __fmaf_rn(-4.0f, v, p0 - p1 - w),
                     p2 - p0, p1);
}

__device__ __forceinline__ float finish(float4 c, float x) {
  float u = __fmaf_rn(c.x, x, c.y);
  u = __fmaf_rn(u, x, c.z);
  return u * x * 0.5f + c.w;
}

__device__ __forceinline__ float bicubic_sub(float p0, float p1, float p2,
                                             float p3, float x) {
  return finish(cell_of(p0, p1, p2, p3), x);
}

// split pos = c + k*v into the integer tap offset and the fraction;
// offsets outside [-kr, kr] take -kr, as the plain select chain does
__device__ __forceinline__ void int_frac(float k, float v, int c, int kr,
                                         int* fd, float* f) {
  const float pos = (float)c + k * v;
  const float ip = truncf(pos);
  int d = (int)ip - c;
  *fd = (d < -kr || d > kr) ? -kr : d;
  *f = pos - ip;
}

// the bicubic sample at (x + k vx, y + k vy), x the frame column; c: the
// cell of the pixel's row whose taps start at the pixel's column
__device__ __forceinline__ float sample(const float4* c, int x, int y,
                                        float vx, float vy, float k, int kr) {
  int fdx, fdy;
  float fx, fy;
  int_frac(k, vx, x, kr, &fdx, &fx);
  int_frac(k, vy, y, kr, &fdy, &fy);
  const float4* t = c + (fdy - 1) * kCells + (fdx - 1);
  float rows[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) rows[j] = finish(t[j * kCells], fx);
  return bicubic_sub(rows[0], rows[1], rows[2], rows[3], fy);
}

// reflect-101 (valid for the rows and columns any in-frame pixel taps,
// since h, w >= 5), clamped into the frame for the window cells only
// out-of-frame pixels would read
__device__ __forceinline__ int window_index(int i, int n) {
  return min(max(rd::mirror(i, n), 0), n - 1);
}

__global__ void __launch_bounds__(kThreads)
    thin_kernel(const float* __restrict__ em, const float2* __restrict__ vec,
                float* __restrict__ out, int h, int w, int cubic,
                float slack, int gx0) {
  __shared__ float win[kWinSize];
  __shared__ float4 cells[kWinRows * kCells];
  const int x0 = blockIdx.x * kTileCols;
  const int y0 = blockIdx.y * kTileRows;
  const int tid = threadIdx.y * kTileCols + threadIdx.x;
  // this block's frame
  const size_t plane = (size_t)h * w;
  em += blockIdx.z * plane;
  vec += blockIdx.z * plane;
  out += blockIdx.z * plane;
  // every load of a thread is issued before its first store, so a warp
  // has kLoads loads in flight rather than one
  float ld[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = min(tid + j * kThreads, kWinSize - 1);
    const int r = i / kWinCols;
    ld[j] = em[(size_t)window_index(y0 - kHaloLo + r, h) * w +
              window_index(x0 - kHaloLo + (i - r * kWinCols), w)];
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = tid + j * kThreads;
    if (i < kWinSize) win[i] = ld[j];
  }
  __syncthreads();
#pragma unroll
  for (int i = tid; i < kWinRows * kCells; i += kThreads) {
    const int r = i / kCells;
    const float* p = win + r * kWinCols + (i - r * kCells);
    cells[i] = cell_of(p[0], p[1], p[2], p[3]);
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x >= w) return;  // after the last barrier
#pragma unroll
  for (int k = 0; k < kTileRows / kRowsPerPass; ++k) {
    const int ty = threadIdx.y + k * kRowsPerPass;
    const int y = y0 + ty;
    if (y >= h) break;
    const size_t p = (size_t)y * w + x;
    const float2 v = vec[p];
    // the cell whose taps start at the pixel: window column tx + 3
    const float4* c = cells + (ty + kHaloLo) * kCells + threadIdx.x + kHaloLo;
    const int xg = x + gx0;
    const float am2 = sample(c, xg, y, v.x, v.y, -2.0f, 2);
    const float am1 = sample(c, xg, y, v.x, v.y, -1.0f, 1);
    const float a0 = win[(ty + kHaloLo) * kWinCols + threadIdx.x + kHaloLo];
    const float ap1 = sample(c, xg, y, v.x, v.y, 1.0f, 1);
    const float ap2 = sample(c, xg, y, v.x, v.y, 2.0f, 2);
    bool keep;
    if (cubic) {
      keep = (am2 * slack <= a0) && (am1 * slack <= a0) &&
             (a0 >= ap1 * slack) && (a0 >= ap2 * slack);
    } else {
      keep = (am1 <= a0) && (a0 >= ap1);
    }
    out[p] = keep ? am2 + am1 + a0 + ap1 + ap2 : 0.0f;
  }
}

}  // namespace

// em, out: (b, h, w) float32; vec: (b, h, w, 2) float32, 8-byte aligned;
// h, w >= 5; 1 <= b <= 65535 (gridDim.z); gx0: the frame column of local
// column 0 (0 for a whole frame)
extern "C" int rd_thin(const void* em, const void* vec, void* out, int h,
                       int w, int b, int cubic, float slack, int gx0,
                       void* stream) {
  if (b < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTileCols - 1) / kTileCols,
                  (h + kTileRows - 1) / kTileRows, b);
  thin_kernel<<<grid, dim3(kTileCols, kRowsPerPass), 0,
                (cudaStream_t)stream>>>((const float*)em, (const float2*)vec,
                                        (float*)out, h, w, cubic, slack,
                                        gx0);
  rd::count_launch();
  return (int)cudaGetLastError();
}
