// K3 strings_chain: the edge -> strings morphology prefix.
//   rect:        simpleJunction(positive) -> simpleConnect(rect)
//                -> stringify(parity 0) -> stringify(parity 1)
//                (oclrect.c:265-272, oclrect.cl:74-121)
//   poly_branch: simpleJunction -> simpleConnect(poly) -> stringify x2
//                -> removeBranch (oclpolyline.c stages 1-4,
//                oclpolyline.cl:66-147)
// with bridge2, either variant runs simple_connect2 (the 2-px staircase
// bridging of the bridge_gap2 accuracy extension) after the connect stage.
//
// Replaces the TPU kernel rectdetect_tpu/ops/pallas_morph.py:_morph_kernel
// (morph_chain_pallas, bridge2 off and on); the semantics are
// ops/morphology.py's, borders included (each stage zeroes its own border
// ring, reads outside the frame are 0).
//
// Bound: device memory, the (H,W) int32 map read once and written once
// (7.4 MB at 720p).  The whole chain is one launch.  Each block owns a
// kTileRows x kTileWords*32 output tile and keeps the chain in shared
// memory as bit words (bit i of a word = pixel x0 + i, x0 a multiple of
// 32), over a window that reaches halo(variant, bridge2) rows above and
// below the tile and one word on each side.  Every stage works on the
// words of a window that shrinks by the stage's reach, so the tile's words
// are exact after the last one:
//   junction     reach 1: two bit-planes, NZ (jn != 0: set with at least
//                one set neighbour) and ONE (jn == 2: exactly one), from a
//                saturating bit-sliced count of the 8 shifted neighbour
//                planes, masked by interior(1);
//   connect      reach 2 (poly) or 1 (rect): the gap patterns as word
//                logic on NZ and ONE, masked by interior(2);
//   connect2     reach 3 (bridge2 only): the chain ends E (degree 2: set
//                with exactly one set neighbour), the ONE plane recomputed
//                on the connect output by the same saturating count (reach
//                1); then the fill, the OR over the directions d = (0,1),
//                (1,0), (1,1), (1,-1) of E(-d) & E(+2d) and E(-2d) & E(+d)
//                (reach 2), ORed into the connect output and masked by
//                interior(2);
//   stringify    reach 1 each, parity 0 then parity 1: clear
//                (up|dn) & (lf|rt) on the checkerboard parity, whose mask
//                is 0x55555555 or 0xAAAAAAAA by the row's parity, masked
//                by interior(1);
//   removeBranch reach 1 (poly): keep set bits with at most 2 set
//                neighbours, by the same saturating count, interior(1).
// So the halo is 6 rows for poly_branch and 4 for rect, 9 and 7 with
// bridge2.  A neighbour bit comes from the adjacent word by a shift and
// carry (Row3::at, |dx| <= 2); words beyond the window read 0, which
// disturbs at most 9 bits of the halo words (the stages' horizontal
// reaches summed) and never the tile's.
// Interior masks use frame coordinates, so the frame border, not the
// tile's, decides them.  The offset form (the width-tiled path,
// dist/tile.py) runs on a halo-widened width tile of a frame of width wt
// whose local column 0 sits at frame column gx0: the interior masks and
// stringify's checkerboard parity take the frame column (local + gx0)
// and wt, and the loads and stores stay local; gx0 = 0, wt = w is the
// whole frame.  The batch form takes b frames of (h, w) one after the
// other: grid z is the frame, and a block reads and writes its own
// frame's plane only, at the offset z h w, so each frame's first word
// starts at its own column 0 and its border is its own.  Loads are one
// coalesced 128-byte warp read per window word, turned into the word by
// __ballot_sync (every lane reaches it: there is no early return); stores
// one 128-byte warp write per tile word, each lane its own pixel.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileRows = 32;
constexpr int kTileWords = 4;
constexpr int kWinWords = kTileWords + 2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// variant 0 = rect, 1 = poly_branch: the stages' reaches summed
__host__ __device__ constexpr int halo(int variant, bool bridge2) {
  return (variant == 0 ? 4 : 6) + (bridge2 ? 3 : 0);
}

// bits [lo, hi) of a word, 0 <= lo, hi <= 32
__device__ __forceinline__ unsigned bit_range(int lo, int hi) {
  if (hi <= lo) return 0u;
  const unsigned top = hi >= 32 ? kFull : (1u << hi) - 1u;
  return top & ~((1u << lo) - 1u);
}

// interior(m) of the frame as the word of row y whose bit 0 is pixel x0
__device__ __forceinline__ unsigned interior(int m, int y, int x0, int h,
                                             int w) {
  if (y < m || y >= h - m) return 0u;
  return bit_range(min(max(m - x0, 0), 32), min(max(w - m - x0, 0), 32));
}

// three adjacent words of one window row; at(dx) is the word whose bit i
// holds pixel x0 + i + dx, |dx| <= 2
struct Row3 {
  unsigned l, m, r;
  __device__ __forceinline__ unsigned at(int dx) const {
    if (dx == 0) return m;
    if (dx > 0) return (m >> dx) | (r << (32 - dx));
    return (m << -dx) | (l >> (32 + dx));
  }
};

__device__ __forceinline__ Row3 row3(const unsigned* plane, int r, int c) {
  const unsigned* row = plane + r * kWinWords;
  return {c > 0 ? row[c - 1] : 0u, row[c],
          c + 1 < kWinWords ? row[c + 1] : 0u};
}

// saturating bit-sliced count: a1, a2, a3 = at least 1, 2, 3 bits seen
struct Count3 {
  unsigned a1 = 0u, a2 = 0u, a3 = 0u;
  __device__ __forceinline__ void add(unsigned p) {
    a3 |= a2 & p;
    a2 |= a1 & p;
    a1 |= p;
  }
  // the 8 neighbours of the middle row's words
  __device__ __forceinline__ void add8(const Row3& up, const Row3& md,
                                       const Row3& dn) {
    add(up.at(-1));
    add(up.m);
    add(up.at(1));
    add(md.at(-1));
    add(md.at(1));
    add(dn.at(-1));
    add(dn.m);
    add(dn.at(1));
  }
};

// one stage: f(r, c) for every word of window rows [k, rows - k)
template <typename F>
__device__ __forceinline__ void stage(int rows, int k, F f) {
  const int n = (rows - 2 * k) * kWinWords;
  for (int i = threadIdx.x; i < n; i += kThreads)
    f(k + i / kWinWords, i % kWinWords);
  __syncthreads();
}

template <int V, bool B2>
__global__ void __launch_bounds__(kThreads)
    chain_kernel(const int* __restrict__ edge, int* __restrict__ out, int h,
                 int w, int gx0, int wt) {
  constexpr int R = halo(V, B2);
  constexpr int WR = kTileRows + 2 * R;
  constexpr int kWin = WR * kWinWords;
  constexpr int kLoads = (kWin + kWarps - 1) / kWarps;
  __shared__ unsigned s_a[kWin], s_b[kWin], s_c[kWin];
  const size_t plane = (size_t)blockIdx.z * h * w;
  edge += plane;
  out += plane;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty0 = blockIdx.y * kTileRows;
  const int tw0 = blockIdx.x * kTileWords;
  // window row r is frame row ty0 - R + r; window word c starts at pixel
  // (tw0 - 1 + c) * 32
  auto frame_y = [&](int r) { return ty0 - R + r; };
  auto frame_x0 = [&](int c) { return (tw0 - 1 + c) * 32; };
  // interior(m) of the frame as window word (r, c), in frame columns
  auto inner = [&](int m, int r, int c) {
    return interior(m, frame_y(r), frame_x0(c) + gx0, h, wt);
  };

  // load: all of a warp's pixels first, then one ballot per word
  int v[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = warp + j * kWarps;
    const int y = frame_y(i / kWinWords);
    const int x = frame_x0(i % kWinWords) + lane;
    v[j] = i < kWin && y >= 0 && y < h && x >= 0 && x < w ? edge[y * w + x]
                                                          : 0;
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const unsigned bits = __ballot_sync(kFull, V == 0 ? v[j] > 0 : v[j] != 0);
    const int i = warp + j * kWarps;
    if (lane == 0 && i < kWin) s_a[i] = bits;
  }
  __syncthreads();

  // junction: s_a -> NZ in s_b, ONE in s_c
  stage(WR, 1, [&](int r, int c) {
    const Row3 md = row3(s_a, r, c);
    Count3 n;
    n.add8(row3(s_a, r - 1, c), md, row3(s_a, r + 1, c));
    const unsigned base = md.m & n.a1 & inner(1, r, c);
    s_b[r * kWinWords + c] = base;
    s_c[r * kWinWords + c] = base & ~n.a2;
  });

  // connect: NZ, ONE -> s_a
  constexpr int kConnect = V == 0 ? 2 : 3;
  stage(WR, kConnect, [&](int r, int c) {
    unsigned b;
    const Row3 nm = row3(s_b, r, c);
    const Row3 ou = row3(s_c, r - 1, c), om = row3(s_c, r, c),
               od = row3(s_c, r + 1, c);
    if (V == 0) {
      const Row3 nu = row3(s_b, r - 1, c), nd = row3(s_b, r + 1, c);
      b = (om.at(-1) & nm.at(1)) | (nm.at(-1) & om.at(1)) |
          (ou.m & nd.m) | (nu.m & od.m) | (ou.at(-1) & od.at(1)) |
          (ou.at(1) & od.at(-1)) | (om.at(1) & od.at(-1)) |
          (om.at(-1) & od.at(1)) | (ou.at(1) & od.m) | (ou.at(-1) & od.m);
    } else {
      const Row3 n2u = row3(s_b, r - 2, c), nd = row3(s_b, r + 1, c),
                 n2d = row3(s_b, r + 2, c);
      b = (nm.at(-2) & om.at(-1) & om.at(1) & nm.at(2)) |
          (n2u.m & ou.m & od.m & n2d.m) |
          (n2u.at(-2) & ou.at(-1) & od.at(1) & n2d.at(2)) |
          (n2u.at(2) & ou.at(1) & od.at(-1) & n2d.at(-2)) |
          (nm.at(2) & om.at(1) & od.at(-1) & nd.at(-2)) |
          (nm.at(-2) & om.at(-1) & od.at(1) & nd.at(2)) |
          (n2u.at(1) & ou.at(1) & od.m & n2d.m) |
          (n2u.at(-1) & ou.at(-1) & od.m & n2d.m);
    }
    s_a[r * kWinWords + c] = (nm.m | b) & inner(2, r, c);
  });

  // connect2 (bridge2): the connect output s_a, its chain ends E in s_b,
  // the bridged map in s_c, which the stages below take as their input
  constexpr int kB = B2 ? 3 : 0;
  unsigned* conn = s_a;
  unsigned* t1 = s_b;
  unsigned* t2 = s_c;
  if (B2) {
    stage(WR, kConnect + 1, [&](int r, int c) {
      const Row3 md = row3(s_a, r, c);
      Count3 n;
      n.add8(row3(s_a, r - 1, c), md, row3(s_a, r + 1, c));
      s_b[r * kWinWords + c] = md.m & n.a1 & ~n.a2;
    });
    stage(WR, kConnect + 3, [&](int r, int c) {
      const Row3 u2 = row3(s_b, r - 2, c), u1 = row3(s_b, r - 1, c),
                 e0 = row3(s_b, r, c), d1 = row3(s_b, r + 1, c),
                 d2 = row3(s_b, r + 2, c);
      const unsigned fill =
          (e0.at(-1) & e0.at(2)) | (e0.at(-2) & e0.at(1)) |      // (0, 1)
          (u1.m & d2.m) | (u2.m & d1.m) |                        // (1, 0)
          (u1.at(-1) & d2.at(2)) | (u2.at(-2) & d1.at(1)) |      // (1, 1)
          (u1.at(1) & d2.at(-2)) | (u2.at(2) & d1.at(-1));       // (1, -1)
      s_c[r * kWinWords + c] = (s_a[r * kWinWords + c] | fill) &
                               inner(2, r, c);
    });
    conn = s_c;
    t1 = s_a;
    t2 = s_b;
  }

  // stringify parity p: src -> dst; bit i is frame column frame_x0(c) +
  // gx0 + i, and frame_x0(c) is even
  auto stringify = [&](const unsigned* src, unsigned* dst, int k, int p) {
    stage(WR, k, [&](int r, int c) {
      const Row3 md = row3(src, r, c);
      const unsigned up = src[(r - 1) * kWinWords + c];
      const unsigned dn = src[(r + 1) * kWinWords + c];
      const int y = frame_y(r);
      const unsigned parity =
          ((y + p + gx0) & 1) ? 0xAAAAAAAAu : 0x55555555u;
      const unsigned clear = parity & (up | dn) & (md.at(-1) | md.at(1)) &
                             inner(1, r, c);
      dst[r * kWinWords + c] = md.m & ~clear;
    });
  };
  stringify(conn, t1, kConnect + kB + 1, 0);
  stringify(t1, t2, kConnect + kB + 2, 1);
  const unsigned* result = t2;

  // removeBranch (poly_branch): t2 -> conn, free by now
  if (V == 1) {
    stage(WR, kConnect + kB + 3, [&](int r, int c) {
      const Row3 md = row3(t2, r, c);
      Count3 n;
      n.add8(row3(t2, r - 1, c), md, row3(t2, r + 1, c));
      conn[r * kWinWords + c] = md.m & ~n.a3 & inner(1, r, c);
    });
    result = conn;
  }
  static_assert(kConnect + kB + 2 + V == R, "the halo is the stages' reaches");

  // store: one warp per tile word, each lane its own pixel
  for (int i = warp; i < kTileRows * kTileWords; i += kWarps) {
    const int r = i / kTileWords, c = i % kTileWords;
    const int y = ty0 + r, x = (tw0 + c) * 32 + lane;
    const unsigned word = result[(R + r) * kWinWords + 1 + c];
    if (y < h && x < w) out[y * w + x] = (int)((word >> lane) & 1u);
  }
}

}  // namespace

template <int V, bool B2>
static void launch_chain(const void* edge, void* out, int h, int w, int b,
                         int gx0, int wt, cudaStream_t s) {
  const dim3 grid((w + 32 * kTileWords - 1) / (32 * kTileWords),
                  (h + kTileRows - 1) / kTileRows, b);
  chain_kernel<V, B2><<<grid, kThreads, 0, s>>>((const int*)edge, (int*)out,
                                                h, w, gx0, wt);
}

// edge, out: (b, h, w) int32, 1 <= b <= 65535 (gridDim.z); variant: 0 =
// rect, 1 = poly_branch; bridge2: 0 or 1; gx0: the frame column of local
// column 0, wt: the frame's width (0 and w for a whole frame); one launch
// for any
extern "C" int rd_strings_chain(const void* edge, void* out, int h,
                                int w, int b, int variant, int bridge2,
                                int gx0, int wt, void* stream) {
  if (b < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0)
    bridge2 ? launch_chain<0, true>(edge, out, h, w, b, gx0, wt, s)
            : launch_chain<0, false>(edge, out, h, w, b, gx0, wt, s);
  else
    bridge2 ? launch_chain<1, true>(edge, out, h, w, b, gx0, wt, s)
            : launch_chain<1, false>(edge, out, h, w, b, gx0, wt, s);
  rd::count_launch();
  return (int)cudaGetLastError();
}
