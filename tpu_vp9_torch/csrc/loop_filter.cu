// The exact VP9 loop filter of the realtime steps, all three planes in one
// launch.
//
// Replaces the XLA stage tpu_vp9/pipeline/tpu_encdec.py:loop_filter_device
// (with _lf_mixed, _lf_vert_gather, _lf_horz_gather, _lf_horz_regular and
// the _band_* helpers around it): the 32 grid, every edge of width 16 (tx32
// luma, tx16 chroma); with a split mask the 16x16 children's edges (luma
// width 16 at the 16 offsets inside split blocks; chroma width 8 on the 8
// grid over split blocks); and the bottom 16-pixel strip of a geometry with
// mi_rows % 4 == 2 (its 16x16 blocks: luma verticals at the 16 offsets of
// its rows, chroma edges of width 8 every 8 pixels of its rows and at its
// top). The filter's order is libvpx's: superblocks in raster order, in each
// all vertical edges, then all horizontal ones. The plain version beside
// the wrapper (pipeline/tpu_encdec.py:loop_filter_ref) is held to it bit for
// bit.
//
// What bounds it on an H100: neither bytes nor operations. A 1080p frame is
// 3.1 MB in and 3.1 MB out (1.9 us at HBM speed) and under 1e8 integer
// operations. What takes the time is the order of the edges: a few levels
// of dependent edge filters, each a run of byte loads from shared memory,
// some hundred dependent integer operations and byte stores, with a
// barrier between levels, in CTAs that share an SM's issue slots
// (tpu_vp9_torch/utils/lf_phases.py prints each level's cycles). So every
// CTA is short: a tile of one superblock row and one superblock column,
// loaded, filtered in at most seven levels and stored; no CTA holds a
// whole column, and none waits for another, so one launch does.
//
// The tiles. With S the superblock's rows (64 luma, 32 chroma) and x_b = S k
// the boundary columns, the columns fall into bands [x_b - 8, x_b + 8) and
// the strips between them (the JAX package proves that no edge of a strip
// reads or writes a band column and the reverse, but for the chroma width-8
// verticals at x_b -+ 8, which read only unfiltered pixels of their row).
// Tile (k, t) of a plane is band k (none for k = 0) and the strip to its
// right: luma columns [64k - 8, 64k + 56), chroma [32k - 8, 32k + 24) (the
// last tile to the plane's edge), and the rows [S t - 8, S t + S - 8) (the
// first from 0, the last to the plane's end). A luma tile is one CTA; both
// chroma planes' tiles (k, t) are one CTA. Each loads its rows and the
// columns its edges read (luma [64k - 16, 64k + 64), chroma [32k - 16,
// 32k + 32)) as 16-byte loads, filters in shared memory as bytes, and
// stores the tile's own rows and columns as 16-byte (8 at the tile's two
// 8-column ends) stores.
//
// The halos. An edge at row y touches rows [y - 8, y + 8) at width 16 and
// [y - 4, y + 4) at width 8 (it reads them; it writes one fewer a side);
// verticals touch their row only. A tile's rows start and end at S t - 8, so
// every width-16 horizontal window lies inside one tile. Read and write sets
// in libvpx's order then give:
//   - luma: no halo. A band row is touched by the boundary vertical V of its
//     superblock row and by one horizontal window a half, all inside the
//     tile, and V's row needs nothing outside its row.
//   - chroma without a split mask: no halo (the same argument; the strip's
//     top edge at strip_y / 2, a multiple of 16, has a window of +-4).
//   - chroma with a split mask: 20 rows above, 4 below. The right half's
//     width-8 edge at 32r + 24 (a tile's first row) reads rows [32r + 20,
//     32r + 28) after V on them; V at width 8 reads the left half's columns
//     x_b - 4 .. x_b - 1 of rows 32r + 20 .. 32r + 23 after the left half's
//     edge at 32r + 16, which at width 16 reads rows [32r + 8, 32r + 24)
//     after the left edge at 32r + 8, which reads rows [32r + 4, 32r + 12)
//     and nothing filtered before it but the width-8 vertical at x_b - 8: so
//     rows from 32r + 4, 20 above the tile. At the tile's end, 32r' + 24,
//     the edges at 32r' + 24 read 4 rows below, and V on those rows follows
//     no horizontal edge of the next superblock row. An exhaustive check
//     over the split masks of the blocks around a boundary finds 20 and 4
//     the least that keep the stored rows exact.
// A tile filters every edge whose read window lies inside its loaded rows
// (one that leaves them would be filtered wrong and its rows are not the
// tile's) and stores only its own rows.
//
// The levels, from libvpx's order within a band. A horizontal edge at S r
// touches rows [S r - 8, S r + 8), the others rows [S r + 8, S r + S - 8),
// and: a row of V(r) follows the left half's edges that touch it and
// precedes the one of the next superblock row that does; of two horizontal
// edges of one column only a width-8 edge at 16j + 8 (chroma, split blocks)
// and the edge at 16j + 16 share pixels, the first first; the right half's
// edges follow V on the rows they touch. Levels with a barrier between them
// (HA: chroma edges at 16j + 8; HM: the other edges inside a superblock;
// HT: the edge at its top; V rows by their place in it):
//   chroma: 0. the verticals the band and strip compute from unfiltered
//              pixels (x_b - 8, x_b + 8, x_b + 24) and x_b + 16 (after
//              x_b + 8 in its row: a width-8 edge there over a split block
//              writes three columns that a width-16 edge at x_b + 16 over
//              the next, unsplit block reads)
//           1. HA left, the strip's HA      2. HM left, V rows [24, 32),
//                                              the strip's other edges
//           3. HT left, V rows [8, 24)      4. V rows [0, 8)
//           5. HA right                     6. HM and HT right
//   luma:   1. the strip's verticals, HM left, V rows [56, 64)
//           2. HT left, V rows [8, 56), the strip's horizontals
//           3. V rows [0, 8)                4. the right half's edges
// The kernel is built twice, with and without a mask (SPLIT). A tile with
// no split block around it (its mask bytes, read into shared memory with
// the load) starts no lane for an edge that cannot exist: a luma tile none
// at the 16 offsets (but in the strip's rows); a chroma tile filters its
// own rows only, without the halo, and skips levels 1 and 5, as without a
// mask. CTAs of both kinds are one launch's grid, the chroma ones first.
//
// An edge lane keeps its taps in registers: 4 a side for a width of 8, 8
// for 16; a lane of a vertical edge reads and writes its row's bytes one
// by one (a form with 32-bit words and the masks' differences four bytes
// at once was slower on an H100). Widths come from the mask's bytes. Rows
// >= h_mi and columns >= w_mi pass through; level 0 copies (the level,
// lim and mblim come from the step's row, step_scalars.cuh, so a level of
// 0 is the kernel's own branch and the launch is the same). Shared-memory
// pitches are an odd number of words, so a warp whose lanes take
// consecutive rows of one vertical edge hits 32 banks.

#include <cstdint>
#include <cuda_runtime.h>

#include "step_scalars.cuh"

namespace {

constexpr int THREADS = 256;
// resident CTAs an SM must hold: ptxas keeps a thread within 64 registers
// (the free choice, about 80, gives 3 and was slower; 48 spills around the
// calls of edge_lane)
constexpr int MIN_CTAS = 4;
constexpr int LUMA_CHUNKS = 5;        // 80 loaded columns: 64 k - 16 ..
constexpr int LUMA_PITCH = 84;
constexpr int LUMA_ROWS = 72;         // the last tile: 64 t - 8 .. 64 t + 64
constexpr int CHROMA_CHUNKS = 3;      // 48 loaded columns: 32 k - 16 ..
constexpr int CHROMA_PITCH = 52;
constexpr int CHROMA_TOP = 20;        // halo rows with a split mask
constexpr int CHROMA_BOTTOM = 4;
constexpr int CHROMA_OWN_ROWS = 40;   // the last tile: 32 t - 8 .. 32 t + 32
constexpr int CHROMA_ROWS = 64;       // loaded, at most
constexpr int CHROMA_PLANE_BYTES = CHROMA_ROWS * CHROMA_PITCH;
constexpr int SPLIT_BYTES = 16;       // the mask's 4 x 4 blocks around a tile
// dynamic shared memory of every CTA: the larger kind's tile (a luma tile
// 6,048 bytes, the chroma pair 6,656) and the mask's bytes, whatever the
// plane's size
constexpr int SMEM_BYTES =
    SPLIT_BYTES + (LUMA_ROWS * LUMA_PITCH > 2 * CHROMA_PLANE_BYTES
                       ? LUMA_ROWS * LUMA_PITCH
                       : 2 * CHROMA_PLANE_BYTES);

struct Params {
  const uint8_t* in[3];
  uint8_t* out[3];
  const int* split;  // (rows32, cols32) 0/1, or null
  int pad_h, pad_w;  // luma plane; chroma planes are half in both
  int h_mi, w_mi;    // the coded luma size: nothing is filtered beyond it
  int strip_y;       // luma row of the strip's top; pad_h without a strip
  int rows32, cols32;
  const int* sc;     // the step's row: lvl, lim, mblim (step_scalars.cuh)
  int ncol, nrow;    // superblock columns and rows: tiles of a plane
  int parts;         // which kinds of CTA work (bits: luma tiles, chroma
                     // tiles); 3 but when a measurement times one alone
};

// The filter's thresholds at the frame's level: the high edge variance
// threshold (lvl >> 4), the interior limit and the edge limit.
struct Filt {
  int thresh, lim, blim;
};

__device__ __forceinline__ int c8(int x) { return min(127, max(-128, x)); }

__device__ __forceinline__ int absdiff(int a, int b) { return abs(a - b); }

// One lane of one edge, in place: q0 points at the first pixel after the
// edge, pixel k before it is q0[-(k + 1) * stride], pixel k after it
// q0[k * stride]. This is _lf_mixed of the plain version: the mask, filter4
// with or without high edge variance, filter8 where flat and width >= 8,
// filter16 where flat2 and width >= 16. A lane takes the shortest path its
// class allows, and reads the outer four taps a side only where filter16
// can apply: an edge of width 8 reads four a side. A form that computed
// all three filters beside the decisions and selected at the end, to
// shorten the dependent path, was no faster on an H100. The function is
// not inlined: one copy serves its dozen and more call sites, so the
// kernel's code stays within the SM's instruction cache (inlined at every
// site it was slower, most of all with a mix of tiles with and without a
// split block, whose levels run different code).
__device__ __noinline__ void edge_lane(uint8_t* q0, int stride, int width,
                                       const Filt F) {
  constexpr int TAPS = 8;
  if (width == 0) return;
  int p[TAPS], q[TAPS];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    p[k] = q0[-(k + 1) * stride];
    q[k] = q0[k * stride];
  }
  const int dp0 = absdiff(p[1], p[0]), dq0 = absdiff(q[1], q[0]);
  const int m = max(max(max(dp0, absdiff(p[2], p[1])),
                        max(dq0, absdiff(q[2], q[1]))),
                    max(absdiff(p[3], p[2]), absdiff(q[3], q[2])));
  if (m > F.lim ||
      absdiff(p[0], q[0]) * 2 + (absdiff(p[1], q[1]) >> 1) > F.blim)
    return;
  const int flat = max(max(max(dp0, absdiff(p[2], p[0])),
                           max(dq0, absdiff(q[2], q[0]))),
                       max(absdiff(p[3], p[0]), absdiff(q[3], q[0])));
  if (width >= 8 && flat <= 1) {
    int flat2 = 2;
    if (width >= 16) {
#pragma unroll
      for (int k = 4; k < TAPS; ++k) {
        p[k] = q0[-(k + 1) * stride];
        q[k] = q0[k * stride];
      }
      flat2 = max(max(max(absdiff(p[4], p[0]), absdiff(q[4], q[0])),
                      max(absdiff(p[5], p[0]), absdiff(q[5], q[0]))),
                  max(max(absdiff(p[6], p[0]), absdiff(q[6], q[0])),
                      max(absdiff(p[7], p[0]), absdiff(q[7], q[0]))));
    }
    if (flat2 <= 1) {
      // filter16: p_i' = ((i+1) p7 + p_i + sum_{j<7} p_j
      //                   + sum_{j<7-i} q_j + 8) >> 4, and q likewise
      int pp[7], qp[7];  // prefix sums
      pp[0] = p[0];
      qp[0] = q[0];
#pragma unroll
      for (int k = 1; k < 7; ++k) {
        pp[k] = pp[k - 1] + p[k];
        qp[k] = qp[k - 1] + q[k];
      }
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        q0[-(i + 1) * stride] = static_cast<uint8_t>(
            ((i + 1) * p[TAPS - 1] + p[i] + pp[6] + qp[6 - i] + 8) >> 4);
        q0[i * stride] = static_cast<uint8_t>(
            ((i + 1) * q[TAPS - 1] + q[i] + qp[6] + pp[6 - i] + 8) >> 4);
      }
      return;
    }
    // filter8, the same sums with three pixels a side
    const int ps = p[0] + p[1] + p[2], qs = q[0] + q[1] + q[2];
    q0[-1 * stride] = static_cast<uint8_t>((p[3] + p[0] + ps + qs + 4) >> 3);
    q0[-2 * stride] =
        static_cast<uint8_t>((2 * p[3] + p[1] + ps + q[0] + q[1] + 4) >> 3);
    q0[-3 * stride] =
        static_cast<uint8_t>((3 * p[3] + p[2] + ps + q[0] + 4) >> 3);
    q0[0] = static_cast<uint8_t>((q[3] + q[0] + qs + ps + 4) >> 3);
    q0[1 * stride] =
        static_cast<uint8_t>((2 * q[3] + q[1] + qs + p[0] + p[1] + 4) >> 3);
    q0[2 * stride] =
        static_cast<uint8_t>((3 * q[3] + q[2] + qs + p[0] + 4) >> 3);
    return;
  }
  // filter4
  const bool hev = max(dp0, dq0) > F.thresh;
  const int ps1 = p[1] - 128, ps0 = p[0] - 128;
  const int qs0 = q[0] - 128, qs1 = q[1] - 128;
  const int f = c8((hev ? c8(ps1 - qs1) : 0) + 3 * (qs0 - ps0));
  const int f1 = c8(f + 4) >> 3;  // arithmetic shifts: f may be negative
  const int f2 = c8(f + 3) >> 3;
  const int fa = hev ? 0 : (f1 + 1) >> 1;
  q0[-1 * stride] = static_cast<uint8_t>(c8(ps0 + f2) + 128);
  q0[-2 * stride] = static_cast<uint8_t>(c8(ps1 + fa) + 128);
  q0[0] = static_cast<uint8_t>(c8(qs0 - f1) + 128);
  q0[1 * stride] = static_cast<uint8_t>(c8(qs1 - fa) + 128);
}

// A tile in shared memory: planes (one luma, or u and v) of the loaded rows
// [r0, r1) and the columns from c0 (the chunks left of the plane, for the
// first tile column, are not loaded), PITCH bytes a row, PLANE_BYTES a
// plane.
template <int PITCH, int PLANE_BYTES>
struct Tile {
  static constexpr int pitch = PITCH;
  uint8_t* s;
  int r0, r1, c0;
  __device__ uint8_t* at(int pl, int y, int x) const {
    return s + pl * PLANE_BYTES + (y - r0) * PITCH + (x - c0);
  }
  // the same buffer seen as rows [a, b) only
  __device__ Tile rows(int a, int b) const {
    return Tile{s + (a - r0) * PITCH, a, b, c0};
  }
};

// The tile's rows from global memory, CHUNKS 16-byte chunks a row of
// PLANES planes of at most MAX_ROWS rows: every load of a thread is in
// flight before it writes the first to shared memory (as 4-byte words, the
// pitch being no multiple of 16). Rows start 16-byte aligned (pitches
// pad_w and pad_w / 2, the wrapper checks the bases). Index arithmetic by
// constants only.
template <int PLANES, int CHUNKS, int MAX_ROWS, class TileT>
__device__ __forceinline__ void load_tile(const TileT& T,
                                          const uint8_t* const* g, int gw) {
  constexpr int PER_PLANE = MAX_ROWS * CHUNKS, TOTAL = PLANES * PER_PLANE;
  constexpr int N = (TOTAL + THREADS - 1) / THREADS;
  uint4 v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int pl = i / PER_PLANE, r = i % PER_PLANE / CHUNKS;
    const int x = T.c0 + 16 * (i % CHUNKS);
    if (i < TOTAL && r < T.r1 - T.r0 && x >= 0 && x < gw)
      v[j] = __ldg(reinterpret_cast<const uint4*>(
          g[pl] + static_cast<size_t>(T.r0 + r) * gw + x));
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int pl = i / PER_PLANE, r = i % PER_PLANE / CHUNKS;
    const int x = T.c0 + 16 * (i % CHUNKS);
    if (i < TOTAL && r < T.r1 - T.r0 && x >= 0 && x < gw) {
      uint32_t* d = reinterpret_cast<uint32_t*>(T.at(pl, T.r0 + r, x));
      d[0] = v[j].x;
      d[1] = v[j].y;
      d[2] = v[j].z;
      d[3] = v[j].w;
    }
  }
}

// Rows [r0, r1) (at most MAX_ROWS) x columns [c_lo, c_hi) (multiples of 8)
// of the tile to global memory: a 16-byte store per chunk of the tile's
// CHUNKS that the range covers, 8 bytes where it covers half of one.
template <int PLANES, int CHUNKS, int MAX_ROWS, class TileT>
__device__ __forceinline__ void store_tile(const TileT& T, uint8_t* const* g,
                                           int gw, int r0, int r1, int c_lo,
                                           int c_hi) {
  constexpr int PER_PLANE = MAX_ROWS * CHUNKS, TOTAL = PLANES * PER_PLANE;
  for (int i = threadIdx.x; i < TOTAL; i += THREADS) {
    const int pl = i / PER_PLANE, r = i % PER_PLANE / CHUNKS;
    const int x = T.c0 + 16 * (i % CHUNKS);
    if (r >= r1 - r0 || x + 16 <= c_lo || x >= c_hi) continue;
    const uint32_t* s =
        reinterpret_cast<const uint32_t*>(T.at(pl, r0 + r, x));
    uint8_t* d = g[pl] + static_cast<size_t>(r0 + r) * gw + x;
    if (x < c_lo) {
      *reinterpret_cast<uint2*>(d + 8) = uint2{s[2], s[3]};
    } else if (x + 16 > c_hi) {
      *reinterpret_cast<uint2*>(d) = uint2{s[0], s[1]};
    } else {
      *reinterpret_cast<uint4*>(d) = uint4{s[0], s[1], s[2], s[3]};
    }
  }
}

// The split mask's blocks (row0 + i, col0 + j), i, j < 4, as bytes (0
// where there is no mask or no such block). Written before the barrier
// that ends the tile's load.
__device__ __forceinline__ void load_split(uint8_t* sp, const Params& P,
                                           int row0, int col0) {
  if (threadIdx.x < SPLIT_BYTES) {
    const int r = row0 + (threadIdx.x >> 2), c = col0 + (threadIdx.x & 3);
    sp[threadIdx.x] = (P.split != nullptr && r >= 0 && r < P.rows32 &&
                       c >= 0 && c < P.cols32 && P.split[r * P.cols32 + c])
                          ? 1
                          : 0;
  }
}

struct Split {
  const uint8_t* sp;
  int row0, col0;
  __device__ bool at(int r, int c) const {
    return sp[4 * (r - row0) + (c - col0)] != 0;
  }
};

// Widths of the edges, the plain version's rules (a block decides the
// edges at its position). Luma: verticals at x % 16 == 0, horizontals at
// y % 16 == 0; chroma: both every 8. Only a CTA of a level above 0 asks.
__device__ __forceinline__ int luma_v_width(const Params& P, const Split& S,
                                            int x, int y) {
  if (x <= 0 || x >= P.w_mi || y >= P.h_mi) return 0;
  if ((x & 31) == 0 || y >= P.strip_y || S.at(y >> 5, x >> 5))
    return 16;
  return 0;
}

__device__ __forceinline__ int luma_h_width(const Params& P, const Split& S,
                                            int y, int x) {
  if (y <= 0 || y >= P.h_mi || x >= P.w_mi) return 0;
  return ((y & 31) == 0 || S.at(y >> 5, x >> 5)) ? 16 : 0;
}

__device__ __forceinline__ int chroma_v_width(const Params& P,
                                              const Split& S, int x, int y) {
  if (x <= 0 || x >= (P.w_mi >> 1) || y >= (P.h_mi >> 1)) return 0;
  const bool narrow = y >= (P.strip_y >> 1) || S.at(y >> 4, x >> 4);
  if ((x & 15) == 0) return narrow ? 8 : 16;
  return narrow ? 8 : 0;
}

__device__ __forceinline__ int chroma_h_width(const Params& P,
                                              const Split& S, int y, int x) {
  if (y <= 0 || y >= (P.h_mi >> 1) || x >= (P.w_mi >> 1)) return 0;
  const bool split = S.at(y >> 4, x >> 4);
  if ((y & 15) == 0)
    return (split || y >= (P.strip_y >> 1)) ? 8 : 16;
  return split ? 8 : 0;
}

// Lanes of a level are numbered across its groups, so that the groups
// spread over the CTA's threads: a group of n lanes starts where the last
// ended. Returns this thread's first lane of the group.
__device__ __forceinline__ int first_lane(int& base, int n) {
  const int i = (static_cast<int>(threadIdx.x) - base) & (THREADS - 1);
  base += n;
  return i;
}

// The horizontal edges at rows y0 + STEP e, e < NE, over columns [x0, x0 +
// cols) of each of PLANES planes: a lane per edge, plane and COLS columns
// (the usual width; a lane takes column c + COLS too where cols is more).
// An edge whose read window [y - taps, y + taps) leaves the loaded rows is
// not filtered.
template <int PLANES, int NE, int STEP, int COLS, bool CHROMA, class TileT>
__device__ __forceinline__ void h_group(const Params& P, const Filt& F,
                                        const Split& Sp, const TileT& T,
                                        int& base, int y0, int x0,
                                        int cols) {
  constexpr int N = PLANES * NE * COLS;
  for (int i = first_lane(base, N); i < N; i += THREADS) {
    const int e = i / COLS % NE, pl = i / (COLS * NE);
    const int y = y0 + STEP * e;
    for (int x = x0 + i % COLS; x < x0 + cols; x += COLS) {
      const int w = CHROMA ? chroma_h_width(P, Sp, y, x)
                           : luma_h_width(P, Sp, y, x);
      const int taps = w > 8 ? 8 : 4;
      if (w == 0 || y - taps < T.r0 || y + taps > T.r1) continue;
      edge_lane(T.at(pl, y, x), T.pitch, w, F);
    }
  }
}

// The boundary vertical edge at column x on the loaded rows y = S (sb0 +
// q) + A + r, q < NSB, r < B - A, of each of PLANES planes.
template <int PLANES, int S, int A, int B, int NSB, bool CHROMA, class TileT>
__device__ __forceinline__ void v_group(const Params& P, const Filt& F,
                                        const Split& Sp, const TileT& T,
                                        int& base, int x, int sb0) {
  constexpr int R = B - A, N = PLANES * NSB * R;
  for (int i = first_lane(base, N); i < N; i += THREADS) {
    const int r = i % R, q = i / R % NSB, pl = i / (R * NSB);
    const int y = S * (sb0 + q) + A + r;
    if (y < T.r0 || y >= T.r1) continue;
    const int w =
        CHROMA ? chroma_v_width(P, Sp, x, y) : luma_v_width(P, Sp, x, y);
    edge_lane(T.at(pl, y, x), 1, w, F);
  }
}

using LumaTile = Tile<LUMA_PITCH, 0>;
using ChromaTile = Tile<CHROMA_PITCH, CHROMA_PLANE_BYTES>;

// A tile's place: superblock column k, row t; xb the band's boundary (k >
// 0), [s_lo, c_hi) the strip's columns, [c_lo, c_hi) the stored ones.
struct Place {
  int k, t, xb, s_lo, c_lo, c_hi;
};

// Whether a split block lies among the mask's blocks (row0 + i, col0 + j),
// i < rows, j < 3, around a tile: where none does, the tile's edges at the
// 16 offsets (luma) and 8 offsets (chroma) do not exist outside the strip,
// and its lanes for them are not started.
__device__ __forceinline__ bool any_split(const Split& Sp, int rows) {
  bool any = false;
  for (int i = 0; i < rows; ++i)
    any = any || Sp.sp[4 * i] || Sp.sp[4 * i + 1] || Sp.sp[4 * i + 2];
  return any;
}

// ---- a luma tile: superblock column k, row t ----
// ALL16: the tile's 16-offset edges may exist (a split block or the strip's
// rows); without, only the 32 grid's lanes are started.
template <bool ALL16>
__device__ __forceinline__ void luma_levels(const Params& P, const Filt& F,
                                            const Split& Sp,
                                            const LumaTile& T,
                                            const Place& L) {
  constexpr int NV = ALL16 ? 3 : 1, STEP = ALL16 ? 16 : 32;
  // 1. the strip's verticals at xb + 16, 32, 48; HM left; V rows [56, 64)
  int base = 0;
  constexpr int N1 = NV * LUMA_ROWS;
  for (int i = first_lane(base, N1); i < N1; i += THREADS) {
    const int e = ALL16 ? i / LUMA_ROWS : 1, y = T.r0 + i % LUMA_ROWS;
    const int x = L.xb + 16 * (e + 1);
    if (y < T.r1)
      edge_lane(T.at(0, y, x), 1, luma_v_width(P, Sp, x, y), F);
  }
  if (L.k > 0) {
    h_group<1, NV, STEP, 8, false>(P, F, Sp, T, base,
                                   64 * L.t + (ALL16 ? 16 : 32), L.xb - 8, 8);
    v_group<1, 64, 56, 64, 2, false>(P, F, Sp, T, base, L.xb, L.t - 1);
  }
  __syncthreads();
  // 2. HT left, V rows [8, 56), the strip's horizontals
  base = 0;
  if (L.k > 0) {
    h_group<1, 1, 16, 8, false>(P, F, Sp, T, base, 64 * L.t, L.xb - 8, 8);
    v_group<1, 64, 8, 56, 1, false>(P, F, Sp, T, base, L.xb, L.t);
  }
  h_group<1, 64 / STEP, STEP, 48, false>(P, F, Sp, T, base, 64 * L.t, L.s_lo,
                                         L.c_hi - L.s_lo);
  __syncthreads();
  if (L.k > 0) {
    base = 0;  // 3. V rows [0, 8)
    v_group<1, 64, 0, 8, 1, false>(P, F, Sp, T, base, L.xb, L.t);
    __syncthreads();
    base = 0;  // 4. the right half's edges
    h_group<1, 64 / STEP, STEP, 8, false>(P, F, Sp, T, base, 64 * L.t,
                                          L.xb, 8);
    __syncthreads();
  }
}

// The thresholds of the frame's level, read from the step's row; a level
// of 0 (the filter off) gives thresh -1, and the CTA then only copies.
__device__ __forceinline__ Filt filt(const Params& P) {
  const int lvl = __ldg(P.sc + step_row::kLfLvl);
  return {lvl > 0 ? lvl >> 4 : -1, __ldg(P.sc + step_row::kLfLim),
          __ldg(P.sc + step_row::kLfMblim)};
}

__device__ __forceinline__ void luma_cta(const Params& P, uint8_t* smem,
                                         int k, int t) {
  const Place L{k, t, 64 * k, k == 0 ? 0 : 64 * k + 8,
                k == 0 ? 0 : 64 * k - 8,
                k == P.ncol - 1 ? P.pad_w : 64 * k + 56};
  const LumaTile T{smem + SPLIT_BYTES, t == 0 ? 0 : 64 * t - 8,
                   t == P.nrow - 1 ? P.pad_h : 64 * t + 56, L.xb - 16};
  const Split Sp{smem, 2 * t - 1, 2 * k - 1};
  load_split(smem, P, Sp.row0, Sp.col0);
  load_tile<1, LUMA_CHUNKS, LUMA_ROWS>(T, P.in, P.pad_w);
  __syncthreads();
  const Filt F = filt(P);
  if (F.thresh >= 0) {
    if (T.r1 > P.strip_y || any_split(Sp, 3))
      luma_levels<true>(P, F, Sp, T, L);
    else
      luma_levels<false>(P, F, Sp, T, L);
  }
  store_tile<1, LUMA_CHUNKS, LUMA_ROWS>(T, P.out, P.pad_w, T.r0, T.r1,
                                        L.c_lo, L.c_hi);
}

// ---- the chroma tiles of u and v: superblock column k, row t ----
// SPLIT: a split block lies around the tile (the halo rows are loaded and
// filtered, the chroma edges at 16j + 8 exist).
template <int SPLIT>
__device__ __forceinline__ void chroma_levels(const Params& P,
                                              const Filt& F,
                                              const Split& Sp,
                                              const ChromaTile& T,
                                              const Place& C) {
  const int k = C.k, t = C.t, xb = C.xb;
  // 0. the verticals at xb - 8, + 8, + 16, + 24, from unfiltered pixels but
  //    the one at xb + 16: at width 16 it reads what the width-8 edge at xb
  //    + 8 (of another block) wrote, so one lane does both. Without a split
  //    block the edges at xb -+ 8 and xb + 24 exist in the strip's rows
  //    only, where all four are of width 8 and disjoint: a lane a row.
  int base = 0;
  if (SPLIT) {
    constexpr int N = 2 * 3 * CHROMA_ROWS;
    for (int i = first_lane(base, N); i < N; i += THREADS) {
      const int pl = i / (3 * CHROMA_ROWS), e = i / CHROMA_ROWS % 3;
      const int y = T.r0 + i % CHROMA_ROWS, x = xb - 8 + 16 * e;
      if (y >= T.r1) continue;
      edge_lane(T.at(pl, y, x), 1, chroma_v_width(P, Sp, x, y), F);
      if (e == 1)
        edge_lane(T.at(pl, y, x + 8), 1, chroma_v_width(P, Sp, x + 8, y),
                  F);
    }
  } else {
    constexpr int N = 2 * CHROMA_OWN_ROWS;
    for (int i = first_lane(base, N); i < N; i += THREADS) {
      const int pl = i / CHROMA_OWN_ROWS, y = T.r0 + i % CHROMA_OWN_ROWS;
      if (y >= T.r1) continue;
      if (y >= P.strip_y >> 1) {
#pragma unroll
        for (int x = xb - 8; x <= xb + 24; x += 16)
          edge_lane(T.at(pl, y, x), 1, chroma_v_width(P, Sp, x, y), F);
      }
      edge_lane(T.at(pl, y, xb + 16), 1,
                chroma_v_width(P, Sp, xb + 16, y), F);
    }
  }
  __syncthreads();
  if (SPLIT) {
    base = 0;  // 1. HA left, the strip's HA
    if (k > 0)
      h_group<2, 4, 16, 8, true>(P, F, Sp, T, base, 32 * t - 24, xb - 8, 8);
    h_group<2, 4, 16, 16, true>(P, F, Sp, T, base, 32 * t - 24, C.s_lo,
                                C.c_hi - C.s_lo);
    __syncthreads();
  }
  base = 0;  // 2. HM left, V rows [24, 32), the strip's edges at 16j
  if (k > 0) {
    h_group<2, 2, 32, 8, true>(P, F, Sp, T, base, 32 * t - 16, xb - 8, 8);
    v_group<2, 32, 24, 32, 2, true>(P, F, Sp, T, base, xb, t - 1);
  }
  h_group<2, 3, 16, 16, true>(P, F, Sp, T, base, 32 * t - 16, C.s_lo,
                              C.c_hi - C.s_lo);
  __syncthreads();
  if (k > 0) {
    base = 0;  // 3. HT left, V rows [8, 24)
    h_group<2, 1, 32, 8, true>(P, F, Sp, T, base, 32 * t, xb - 8, 8);
    v_group<2, 32, 8, 24, 2, true>(P, F, Sp, T, base, xb, t - 1);
    __syncthreads();
    base = 0;  // 4. V rows [0, 8)
    v_group<2, 32, 0, 8, 2, true>(P, F, Sp, T, base, xb, t - 1);
    __syncthreads();
    if (SPLIT) {
      base = 0;  // 5. HA right
      h_group<2, 4, 16, 8, true>(P, F, Sp, T, base, 32 * t - 24, xb, 8);
      __syncthreads();
    }
    base = 0;  // 6. HM and HT right
    h_group<2, 3, 16, 8, true>(P, F, Sp, T, base, 32 * t - 16, xb, 8);
    __syncthreads();
  }
}

template <int SPLIT>
__device__ __forceinline__ void chroma_cta(const Params& P, uint8_t* smem,
                                           int k, int t) {
  const int H = P.pad_h >> 1, W = P.pad_w >> 1;
  const Place C{k, t, 32 * k, k == 0 ? 0 : 32 * k + 8,
                k == 0 ? 0 : 32 * k - 8, k == P.ncol - 1 ? W : 32 * k + 24};
  const int own_lo = t == 0 ? 0 : 32 * t - 8;
  const int own_hi = t == P.nrow - 1 ? H : 32 * t + 24;
  const ChromaTile T{smem + SPLIT_BYTES,
                     max(0, own_lo - (SPLIT ? CHROMA_TOP : 0)),
                     min(H, own_hi + (SPLIT ? CHROMA_BOTTOM : 0)),
                     C.xb - 16};
  const Split Sp{smem, 2 * t - 2, 2 * k - 1};
  load_split(smem, P, Sp.row0, Sp.col0);
  load_tile<2, CHROMA_CHUNKS, CHROMA_ROWS>(T, P.in + 1, W);
  __syncthreads();
  const Filt F = filt(P);
  if (F.thresh >= 0) {
    // with no split block around the tile (block rows 2t - 2 .. 2t + 1),
    // its own rows are filtered as without a mask: no halo is needed
    if (SPLIT && any_split(Sp, 4))
      chroma_levels<1>(P, F, Sp, T, C);
    else
      chroma_levels<0>(P, F, Sp, T.rows(own_lo, own_hi), C);
  }
  store_tile<2, CHROMA_CHUNKS, CHROMA_OWN_ROWS>(T, P.out + 1, W, own_lo,
                                                own_hi, C.c_lo, C.c_hi);
}

// The chroma CTAs first (the longer), then the luma ones: one of each kind
// per superblock column k and row t (parts: bit 0 the luma CTAs, bit 1 the
// chroma ones). SPLIT: a split mask is given (the chroma halos and the
// chroma edges at 16j + 8).
// (__grid_constant__: the device functions take the parameters by
// reference, which would otherwise copy them to each thread's stack)
template <int SPLIT>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
loop_filter_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n = P.ncol * P.nrow;
  if (blockIdx.x < n) {
    if (P.parts & 2)
      chroma_cta<SPLIT>(P, smem, blockIdx.x % P.ncol, blockIdx.x / P.ncol);
  } else if (P.parts & 1) {
    const int i = blockIdx.x - n;
    luma_cta(P, smem, i % P.ncol, i / P.ncol);
  }
}

Params make_params(const void* y, const void* u, const void* v, void* out_y,
                   void* out_u, void* out_v, const void* split,
                   const void* sc, int pad_h, int pad_w, int h_mi, int w_mi,
                   int strip_y, int rows32, int cols32, int parts) {
  Params P;
  P.in[0] = static_cast<const uint8_t*>(y);
  P.in[1] = static_cast<const uint8_t*>(u);
  P.in[2] = static_cast<const uint8_t*>(v);
  P.out[0] = static_cast<uint8_t*>(out_y);
  P.out[1] = static_cast<uint8_t*>(out_u);
  P.out[2] = static_cast<uint8_t*>(out_v);
  P.split = static_cast<const int*>(split);
  P.pad_h = pad_h;
  P.pad_w = pad_w;
  P.h_mi = h_mi;
  P.w_mi = w_mi;
  P.strip_y = strip_y;
  P.rows32 = rows32;
  P.cols32 = cols32;
  P.sc = static_cast<const int*>(sc);
  P.ncol = pad_w / 64;
  P.nrow = pad_h / 64;
  P.parts = parts;
  return P;
}

}  // namespace

// y, u, v: uint8 planes of (pad_h, pad_w) and twice (pad_h / 2, pad_w / 2),
// contiguous, on the device, starting on 16-byte boundaries; out_*: planes
// of the same shapes and alignment that do not overlap them; split:
// (rows32, cols32) int32 0/1 or null; sc: the step's row (step_scalars.cuh)
// whose lvl (0 <= lvl <= 63, checked on the host), lim and mblim words the
// kernel reads. The caller has checked pad_w % 64 == 0, pad_h % 64 == 0,
// h_mi <= min(pad_h, strip_y + 16), w_mi <= pad_w with pad_w - w_mi < 64,
// strip_y == pad_h or (no mask) the strip's top. parts is 3; a
// measurement passes 1 (luma tiles) or 2 (chroma tiles) to time one kind
// of CTA alone (the others return at once and their planes of the output
// stay unwritten). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int loop_filter_launch(const void* y, const void* u,
                                  const void* v, void* out_y, void* out_u,
                                  void* out_v, const void* split,
                                  const void* sc, int pad_h, int pad_w,
                                  int h_mi, int w_mi, int strip_y,
                                  int rows32, int cols32, int parts,
                                  void* stream) {
  const Params P = make_params(y, u, v, out_y, out_u, out_v, split, sc,
                               pad_h, pad_w, h_mi, w_mi, strip_y, rows32,
                               cols32, parts);
  const int grid = 2 * P.ncol * P.nrow;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split != nullptr)
    loop_filter_kernel<1><<<grid, THREADS, SMEM_BYTES, st>>>(P);
  else
    loop_filter_kernel<0><<<grid, THREADS, SMEM_BYTES, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// The CTAs of THREADS threads an SM holds at once, and the dynamic shared
// memory each asks for, of the kernel with (split 1) or without a split
// mask.
extern "C" int loop_filter_occupancy(int split, int* ctas_per_sm,
                                     int* smem) {
  *smem = SMEM_BYTES;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm,
      split ? loop_filter_kernel<1> : loop_filter_kernel<0>, THREADS,
      SMEM_BYTES));
}
