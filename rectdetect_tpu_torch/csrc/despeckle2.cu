// Kernel #8 despeckle2: region sizes (calcSize, oclrect.cl:336-348), then
// every region of <= thre pixels takes the label of its largest in-frame
// 3x3 neighbour (despeckle2, oclrect.cl:350-371), the first maximum in
// (dy, dx) scan order (strict >).
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_morph.py:
// _despeckle2_kernel (despeckle2_pallas) and the size pass that feeds it.
//
// Bound: device memory, 4 B read and 4 B written per pixel (7.4 MB at
// 720p).  The merged regions are large (the background and the quads
// cover most of a frame), so a histogram by one atomicAdd per pixel, or
// even per warp, queues tens of thousands of atomics on a few addresses,
// which L2 serializes.  One cooperative launch of a co-resident grid does
// it in three phases, two grid barriers apart, each block walking its
// kTileRows x kTileCols tiles (the grid is as large as the tiles or as
// many blocks as fit on the card, whichever is smaller):
//   A  load the tile's labels with a one-pixel halo into shared memory;
//      count them by runs of equal labels along each warp row (a shuffle
//      and a ballot; each run's first lane counts it) into a shared table
//      of kSlots distinct labels (open addressing, at most kMaxProbes
//      probes; a run that finds no slot spills and keeps its count); zero
//      the size of every label of the tile, one store per table entry and
//      per spilled run;
//   B  one global atomicAdd per table entry and per spilled run;
//   C  every pixel reads its own region's size and, only if it is <=
//      thre, its in-frame neighbours' labels (shared memory) and sizes.
// The size table is scratch of h*w int32 that needs no memset: phase A
// zeroes exactly the entries that labels name.  B walks the block's tiles
// in reverse and C forwards again, so each phase starts on the tile whose
// table and window the previous one left in shared memory (with one tile
// a block, as at 720p, each tile is loaded and counted once).  Sizes are
// indexed by the clamped label min(max(l, 0), n - 1), as in the plain
// version.  Phase C reads them with plain loads, through L1: the grid
// barrier's acquire makes B's atomics visible, and each SM then fetches
// a large region's size line from L2 once (loads that bypass L1 send one
// request a warp to that one line; PERF.md section 6).
//
// The grid barrier is cooperative_groups' grid sync under
// cudaLaunchCooperativeKernel, rather than a counter of our own: the
// launch itself refuses a grid that cannot be co-resident, so a barrier
// can never wait on a block that is not running.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
// tile of a block: kTileRows x kTileCols pixels, kRowsPerPass rows of
// kTileCols threads (one warp a row)
constexpr int kTileCols = 32;
constexpr int kTileRows = 64;
constexpr int kRowsPerPass = 8;
constexpr int kThreads = kTileCols * kRowsPerPass;
constexpr int kPasses = kTileRows / kRowsPerPass;
constexpr int kWinCols = kTileCols + 2;
constexpr int kWinRows = kTileRows + 2;
// the per-tile table of distinct labels
constexpr int kSlotBits = 7;
constexpr int kSlots = 1 << kSlotBits;
constexpr int kMaxProbes = 8;
constexpr int kEmpty = -1;

static_assert(kTileCols == 32, "a warp is one tile row");
static_assert(kSlots <= kThreads, "one thread a table slot");

struct Shared {
  int win[kWinRows * kWinCols];  // labels of the tile and its halo
  int key[kSlots];               // clamped label, or kEmpty
  int count[kSlots];
};

struct Tile {
  int x0, y0;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_x) {
  const int ty = t / tiles_x;
  return {(t - ty * tiles_x) * kTileCols, ty * kTileRows};
}

__device__ __forceinline__ int clamp_label(int l, int n) {
  return min(max(l, 0), n - 1);
}

// the tile's labels and their one-pixel halo; out-of-frame cells are
// never read.  Every load of a thread is issued before its first store, so
// a warp has kLoads loads in flight rather than one.
constexpr int kWinSize = kWinRows * kWinCols;
constexpr int kLoads = (kWinSize + kThreads - 1) / kThreads;

__device__ void load_window(Shared& s, const int* __restrict__ label,
                            Tile t, int h, int w) {
  const int tid = threadIdx.y * kTileCols + threadIdx.x;
  int v[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / kWinCols;
    const int y = t.y0 - 1 + r, x = t.x0 - 1 + (i - r * kWinCols);
    v[j] = i < kWinSize && y >= 0 && y < h && x >= 0 && x < w
               ? label[y * w + x]
               : 0;
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = tid + j * kThreads;
    if (i < kWinSize) s.win[i] = v[j];
  }
}

// a run of `c` pixels of clamped label l into the table; false if it found
// no slot in kMaxProbes probes
__device__ bool insert(Shared& s, int l, int c) {
  unsigned slot = ((unsigned)l * 2654435761u) >> (32 - kSlotBits);
  for (int probe = 0; probe < kMaxProbes; ++probe) {
    const int prev = atomicCAS(&s.key[slot], kEmpty, l);
    if (prev == kEmpty || prev == l) {
      atomicAdd(&s.count[slot], c);
      return true;
    }
    slot = (slot + 1) & (kSlots - 1);
  }
  return false;
}

// the tile's table from its window (s.win loaded and visible): each warp
// takes its rows of the tile pass by pass, and the first lane of each run
// of equal labels along a row inserts the run.  spill[k]: the length of
// the run this lane heads in pass k if it found no slot, else 0.
__device__ __forceinline__ void count_tile(Shared& s, Tile t, int h, int w,
                                           int n, int spill[kPasses]) {
  const int tid = threadIdx.y * kTileCols + threadIdx.x;
  if (tid < kSlots) {
    s.key[tid] = kEmpty;
    s.count[tid] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x;
  const int x = t.x0 + lane;
  // (every lane reaches each shuffle and ballot: no short circuit)
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const int ty = threadIdx.y + k * kRowsPerPass;
    const bool in = x < w && t.y0 + ty < h;
    const int l =
        in ? clamp_label(s.win[(ty + 1) * kWinCols + threadIdx.x + 1], n)
           : kEmpty;
    const int left = __shfl_up_sync(kFull, l, 1);
    const bool head = lane == 0 || left != l;
    const unsigned after = __ballot_sync(kFull, head) & ~((2u << lane) - 1);
    const int len = (after ? __ffs(after) - 1 : 32) - lane;
    spill[k] = in && head && !insert(s, l, len) ? len : 0;
  }
  __syncthreads();
}

// the clamped label of this lane's pixel of pass k
__device__ __forceinline__ int own_label(const Shared& s, int k, int n) {
  const int ty = threadIdx.y + k * kRowsPerPass;
  return clamp_label(s.win[(ty + 1) * kWinCols + threadIdx.x + 1], n);
}

__global__ void __launch_bounds__(kThreads)
    despeckle2_kernel(const int* __restrict__ label, int* __restrict__ sizes,
                      int* __restrict__ out, int h, int w, int thre,
                      int tiles_x, int tiles) {
  __shared__ Shared s;
  const cg::grid_group grid = cg::this_grid();
  const int n = h * w;
  const int tid = threadIdx.y * kTileCols + threadIdx.x;
  const int b = blockIdx.x, g = gridDim.x;
  const int mine = (tiles - b + g - 1) / g;  // tiles b, b + g, ...
  int spill[kPasses];

  // A: each label of the tile zeroed once
  for (int i = 0; i < mine; ++i) {
    const Tile t = tile_of(b + i * g, tiles_x);
    __syncthreads();
    load_window(s, label, t, h, w);
    __syncthreads();
    count_tile(s, t, h, w, n, spill);
    if (tid < kSlots && s.key[tid] != kEmpty) sizes[s.key[tid]] = 0;
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      if (spill[k]) sizes[own_label(s, k, n)] = 0;
    }
  }
  grid.sync();

  // B: the counts added, the tiles in reverse (the last one's table and
  // spills are still here)
  for (int i = mine - 1; i >= 0; --i) {
    const Tile t = tile_of(b + i * g, tiles_x);
    if (i != mine - 1) {
      __syncthreads();
      load_window(s, label, t, h, w);
      __syncthreads();
      count_tile(s, t, h, w, n, spill);
    }
    if (tid < kSlots && s.key[tid] != kEmpty) {
      atomicAdd(sizes + s.key[tid], s.count[tid]);
    }
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      if (spill[k]) atomicAdd(sizes + own_label(s, k, n), spill[k]);
    }
  }
  grid.sync();

  // C: the absorption, the tiles forwards (the first one's window is
  // still here)
  for (int i = 0; i < mine; ++i) {
    const Tile t = tile_of(b + i * g, tiles_x);
    if (i != 0) {
      __syncthreads();
      load_window(s, label, t, h, w);
      __syncthreads();
    }
    const int x = t.x0 + threadIdx.x;
    if (x >= w) continue;
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int ty = threadIdx.y + k * kRowsPerPass;
      const int y = t.y0 + ty;
      if (y >= h) break;
      const int* p = s.win + (ty + 1) * kWinCols + threadIdx.x + 1;
      const int lb = *p;
      int best_lb = lb;
      if (sizes[clamp_label(lb, n)] <= thre) {
        int best_sz = 0;
        for (int dy = -1; dy <= 1; ++dy) {
          for (int dx = -1; dx <= 1; ++dx) {
            const int yy = y + dy, xx = x + dx;
            if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
            const int cl = p[dy * kWinCols + dx];
            const int sz = sizes[clamp_label(cl, n)];
            if (sz > best_sz) {
              best_sz = sz;
              best_lb = cl;
            }
          }
        }
      }
      out[y * w + x] = best_lb;
    }
  }
}

// blocks of despeckle2_kernel the card holds at once, per device
int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev]) return cached[dev];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, despeckle2_kernel, kThreads, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  if (dev < 64) cached[dev] = per_sm * sms;
  return per_sm * sms;
}

}  // namespace

// sizes: (h*w,) int32 scratch, any contents
extern "C" int rd_despeckle2(const void* label, void* sizes, void* out, int h,
                             int w, int thre, void* stream) {
  int tiles_x = (w + kTileCols - 1) / kTileCols;
  int tiles = tiles_x * ((h + kTileRows - 1) / kTileRows);
  const int resident = resident_blocks();
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const int blocks = tiles < resident ? tiles : resident;
  const int* lab = (const int*)label;
  int* sz = (int*)sizes;
  int* o = (int*)out;
  void* args[] = {&lab, &sz, &o, &h, &w, &thre, &tiles_x, &tiles};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)despeckle2_kernel, dim3(blocks),
      dim3(kTileCols, kRowsPerPass), args, 0, (cudaStream_t)stream);
  rd::count_launch();
  return (int)err;
}
