// The exact VP9 loop filter of the realtime P-frame step, all three planes
// in one launch.
//
// Replaces the XLA stage tpu_vp9/pipeline/tpu_encdec.py:loop_filter_device
// (with _lf_mixed, _lf_vert_gather, _lf_horz_gather, _lf_horz_regular and
// the _band_* helpers around it): the 32 grid without a strip, every edge of
// width 16 (tx32 luma, tx16 chroma), and with a split mask the 16x16
// children's edges (luma width 16 at the 16 offsets inside split blocks;
// chroma width 8 on the 8 grid over split blocks). The filter's order is
// libvpx's: superblocks in raster order, in each all vertical edges, then
// all horizontal ones. The plain version beside the wrapper
// (pipeline/tpu_encdec.py:loop_filter_ref) is held to it bit for bit.
//
// What bounds it on an H100: neither bytes nor operations. A 1080p frame is
// 3.1 MB in and 3.1 MB out (1.9 us at HBM speed) and under 1e8 integer
// operations. What takes the time is latency: the order of the edges leaves
// a few levels of dependent edge filters, each a run of byte loads from
// shared memory, some hundred dependent integer operations and byte
// stores, with a barrier between levels; and a column of the picture
// (a band, a chroma strip) is one CTA's work from its load to its store.
//
// The design, from the decomposition the JAX package proves:
//   - columns fall into bands (the 16 columns around each interior
//     superblock-boundary column: luma x = 64k-8 .. 64k+7, chroma 32k-8 ..
//     32k+7) and the strips between them. No edge of a strip reads or
//     writes a band column and the reverse, with one exception below. Every
//     CTA reads its columns of the input planes into shared memory
//     (asynchronous 4-byte copies, all of a thread's in flight), filters
//     there as bytes, and writes its columns of the output planes: no CTA
//     waits for another, so one launch does.
//   - a luma strip is cut into tiles of 64 rows that start at rows = 8 mod
//     16: horizontal windows are [16j-8, 16j+8), so a tile has no halo. In
//     a tile: vertical edges (a thread per row and edge), a barrier,
//     horizontal edges (a thread per column and edge).
//   - a chroma strip keeps its whole height in one CTA, because with a
//     split mask the width-8 horizontal edge at 16j+8 writes rows that the
//     width-16 edge at 16j+16 reads: vertical edges, barrier, the 8-offset
//     horizontals, barrier, the 16-multiples.
//   - a band is one CTA. The JAX package and the plain version walk down
//     its superblock rows one after the other; here all of them run at
//     once, in six levels (four for luma), because the dependences between
//     a band's edges reach no further than the next superblock row (see
//     "the bands" below).
//   - the exception: with a split mask the chroma width-8 vertical edges at
//     x_b - 8 and x_b + 8 straddle band and strip (each writes three band
//     columns). They read only unfiltered pixels of their row, so the band's
//     CTA and the strip's CTA both compute them from the input, each on a
//     window four columns wider than what it stores, and each stores its
//     own columns.
//   - an edge lane keeps its taps in registers: 4 a side for a width of 8,
//     8 for 16; widths come from the split mask's two columns that a CTA can
//     meet, which it keeps in shared memory as bytes.
//   - rows >= h_mi and columns >= w_mi pass through; lvl 0 copies.
// Shared-memory pitches are an odd number of words, so a warp whose lanes
// take consecutive rows of one vertical edge hits 32 banks.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_ROWS = 64;                // luma strip tile height
constexpr int PITCH_LUMA_BAND = 20;          // 16 columns
constexpr int PITCH_LUMA_TILE = 68;          // up to 64 columns
constexpr int PITCH_CHROMA_BAND = 28;        // 24 columns
constexpr int PITCH_CHROMA_STRIP = 36;       // up to 32 columns

struct Params {
  const uint8_t* in[3];
  uint8_t* out[3];
  const int* split;  // (rows32, cols32) 0/1, or null
  int pad_h, pad_w;  // luma plane; chroma planes are half in both
  int h_mi, w_mi;    // the coded luma size: nothing is filtered beyond it
  int rows32, cols32;
  int on;            // lvl > 0
  int thresh, lim, blim;
  int nb;            // bands of a plane (strips: nb + 1)
  int tiles;         // tiles of a luma strip
  int tile_off;      // the tile's offset in dynamic shared memory
  int parts;         // which kinds of CTA work (bits: luma bands, chroma
                     // bands, chroma strips, luma tiles); 15 but when a
                     // measurement times one kind alone
};

__device__ __forceinline__ int c8(int x) { return min(127, max(-128, x)); }

__device__ __forceinline__ int absdiff(int a, int b) { return abs(a - b); }

// One lane of one edge, in place: q0 points at the first pixel after the
// edge, pixel k before it is q0[-(k + 1) * stride], pixel k after it
// q0[k * stride]. TAPS = 4 serves widths up to 8, TAPS = 8 all widths.
// This is _lf_mixed of the plain version: the mask, filter4 with or
// without high edge variance, filter8 where flat and width >= 8, filter16
// where flat2 and width >= 16. A lane takes the shortest path its class
// allows (the outer four taps are read only where filter16 can apply); a
// form that computed all three filters beside the decisions and selected
// at the end, to shorten the dependent path, was no faster on an H100.
template <int TAPS>
__device__ __forceinline__ void edge_lane(uint8_t* q0, int stride, int width,
                                          const Params& P) {
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
  if (m > P.lim ||
      absdiff(p[0], q[0]) * 2 + (absdiff(p[1], q[1]) >> 1) > P.blim)
    return;
  const int flat = max(max(max(dp0, absdiff(p[2], p[0])),
                           max(dq0, absdiff(q[2], q[0]))),
                       max(absdiff(p[3], p[0]), absdiff(q[3], q[0])));
  if (width >= 8 && flat <= 1) {
    if constexpr (TAPS == 8) {
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
  const bool hev = max(dp0, dq0) > P.thresh;
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

// One 4-byte asynchronous copy from global to shared memory.
__device__ __forceinline__ void copy_word_async(uint8_t* dst,
                                                const uint8_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

// Copy rows [r0, r0 + rows) x columns [c0, c1) of a plane (c0 and c1
// multiples of 4) from global memory into a shared-memory tile whose first
// column is plane column c0, as 4-byte asynchronous copies: a thread has
// all of its words in flight at once. The caller waits (tile_arrived).
__device__ __forceinline__ void load_tile(uint8_t* s, int pitch,
                                          const uint8_t* g, int gpitch,
                                          int r0, int rows, int c0, int c1) {
  const int wpr = (c1 - c0) >> 2;
  for (int i = threadIdx.x; i < rows * wpr; i += THREADS) {
    const int r = i / wpr, w = i - r * wpr;
    copy_word_async(s + r * pitch + 4 * w,
                    g + static_cast<size_t>(r0 + r) * gpitch + c0 + 4 * w);
  }
}

// Wait for this thread's asynchronous copies, then for the CTA's.
__device__ __forceinline__ void tile_arrived() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                   : "memory");
  __syncthreads();
}

// Write rows x columns [c0, c1) of a tile (first column: plane column
// col0) to global memory at row r0, as 32-bit words.
__device__ __forceinline__ void store_tile(const uint8_t* s, int pitch,
                                           int col0, uint8_t* g, int gpitch,
                                           int r0, int rows, int c0, int c1) {
  const int wpr = (c1 - c0) >> 2;
  for (int i = threadIdx.x; i < rows * wpr; i += THREADS) {
    const int r = i / wpr, w = i - r * wpr;
    *reinterpret_cast<uint32_t*>(
        g + static_cast<size_t>(r0 + r) * gpitch + c0 + 4 * w) =
        *reinterpret_cast<const uint32_t*>(s + r * pitch + (c0 - col0) +
                                           4 * w);
  }
}

// The split mask's columns c and c + 1 as bytes sp[0][r], sp[1][r] (0 where
// there is no mask or no such column).
__device__ __forceinline__ void load_split(uint8_t* sp, const Params& P,
                                           int c) {
  for (int i = threadIdx.x; i < 2 * P.rows32; i += THREADS) {
    const int half = i / P.rows32, r = i - half * P.rows32;
    const int col = c + half;
    sp[i] = (P.split != nullptr && col >= 0 && col < P.cols32 &&
             P.split[r * P.cols32 + col] != 0)
                ? 1
                : 0;
  }
}

// ---- a tile of a luma strip: strip k, rows [64 t - 8, 64 t + 56) ----
__device__ void luma_tile(const Params& P, uint8_t* smem, int k, int t) {
  uint8_t* sp = smem;
  uint8_t* s = smem + P.tile_off;
  constexpr int pitch = PITCH_LUMA_TILE;
  const int x_lo = k == 0 ? 0 : 64 * k + 8;
  const int x_hi = k == P.nb ? P.pad_w : 64 * k + 56;
  const int r_lo = max(0, t * TILE_ROWS - 8);
  const int r_hi = min(P.pad_h, (t + 1) * TILE_ROWS - 8);
  const int rows = r_hi - r_lo, cols = x_hi - x_lo;
  load_split(sp, P, 2 * k);
  load_tile(s, pitch, P.in[0], P.pad_w, r_lo, rows, x_lo, x_hi);
  tile_arrived();
  // vertical edges at 64k + 16, + 32, + 48: the middle one always, the
  // others inside split blocks
  for (int i = threadIdx.x; i < 3 * rows; i += THREADS) {
    const int e = i / rows, r = i - e * rows;
    const int y = r_lo + r, x = 64 * k + 16 * (e + 1);
    if (y >= P.h_mi || x >= P.w_mi) continue;
    const int width =
        16 * P.on * (e == 1 ? 1 : sp[(e >> 1) * P.rows32 + (y >> 5)]);
    edge_lane<8>(s + r * pitch + (x - x_lo), 1, width, P);
  }
  __syncthreads();
  // horizontal edges at the multiples of 16 whose window the tile holds
  const int y_first = ((r_lo + 8 + 15) >> 4) << 4;
  const int n_edges = y_first + 8 > r_hi ? 0 : (r_hi - 8 - y_first) / 16 + 1;
  for (int i = threadIdx.x; i < n_edges * cols; i += THREADS) {
    const int e = i / cols, c = i - e * cols;
    const int y = y_first + 16 * e, x = x_lo + c;
    if (y >= P.h_mi || x >= P.w_mi) continue;
    const int width =
        16 * P.on *
        ((y & 16) ? sp[((x >> 5) - 2 * k) * P.rows32 + (y >> 5)] : 1);
    edge_lane<8>(s + (y - r_lo) * pitch + c, pitch, width, P);
  }
  __syncthreads();
  store_tile(s, pitch, x_lo, P.out[0], P.pad_w, r_lo, rows, x_lo, x_hi);
}

// ---- a chroma strip: plane pl, strip k, the whole height ----
__device__ void chroma_strip(const Params& P, uint8_t* smem, int pl, int k) {
  uint8_t* sp = smem;
  uint8_t* s = smem + P.tile_off;
  constexpr int pitch = PITCH_CHROMA_STRIP;
  const int H = P.pad_h >> 1, W = P.pad_w >> 1;
  const int hc = P.h_mi >> 1, wc = P.w_mi >> 1;
  const bool last = k == P.nb;
  const int s_lo = k == 0 ? 0 : 32 * k + 8;    // the columns it stores
  const int s_hi = last ? W : 32 * k + 24;
  const int w_lo = k == 0 ? 0 : 32 * k + 4;    // the columns it reads
  const int w_hi = last ? W : 32 * k + 28;
  const bool split = P.split != nullptr;
  load_split(sp, P, 2 * k);
  load_tile(s, pitch, P.in[pl], W, 0, H, w_lo, w_hi);
  tile_arrived();
  // vertical edges of a row, in raster order where they can meet: the
  // width-8 edges at 32k + 8 and 32k + 24 (split blocks only), then the
  // edge at 32k + 16
  for (int y = threadIdx.x; y < hc; y += THREADS) {
    uint8_t* row = s + y * pitch - w_lo;
    const int s0 = sp[y >> 4], s1 = sp[P.rows32 + (y >> 4)];
    if (split) {
      if (32 * k + 8 < wc)
        edge_lane<4>(row + 32 * k + 8, 1, 8 * P.on * s0, P);
      if (32 * k + 24 < wc)
        edge_lane<4>(row + 32 * k + 24, 1, 8 * P.on * s1, P);
    }
    if (32 * k + 16 < wc)
      edge_lane<8>(row + 32 * k + 16, 1, P.on * (s1 ? 8 : 16), P);
  }
  __syncthreads();
  const int cols = s_hi - s_lo;
  if (split) {
    // horizontal edges at 16j + 8, width 8 over split blocks
    const int n_a = (hc + 7) >> 4;
    for (int i = threadIdx.x; i < n_a * cols; i += THREADS) {
      const int e = i / cols, c = i - e * cols;
      const int y = 16 * e + 8, x = s_lo + c;
      if (x >= wc) continue;
      const int width =
          8 * P.on * sp[((x >> 4) - 2 * k) * P.rows32 + (y >> 4)];
      edge_lane<4>(s + y * pitch + (x - w_lo), pitch, width, P);
    }
    __syncthreads();
  }
  // horizontal edges at 16j: width 8 over a split block, else 16
  const int n_b = (hc - 1) >> 4;
  for (int i = threadIdx.x; i < n_b * cols; i += THREADS) {
    const int e = i / cols, c = i - e * cols;
    const int y = 16 * (e + 1), x = s_lo + c;
    if (x >= wc) continue;
    const int width =
        P.on * (sp[((x >> 4) - 2 * k) * P.rows32 + (y >> 4)] ? 8 : 16);
    edge_lane<8>(s + y * pitch + (x - w_lo), pitch, width, P);
  }
  __syncthreads();
  store_tile(s, pitch, w_lo, P.out[pl], W, 0, H, s_lo, s_hi);
}

// ---- the bands ----
//
// A band's edges in libvpx's order, per superblock row r: the left half's
// horizontal edges H_l(r), the boundary vertical edge V(r), the right
// half's horizontal edges H_r(r). Written as that loop it is a chain of
// 17 rows at 1080p, but the dependences are short. With S the superblock's
// rows (64 luma, 32 chroma), a horizontal edge at S r touches rows
// [S r - 8, S r + 8), the others rows [S r + 8, S r + S - 8), and:
//   - a row of V(r) must follow the left-half edges that touch it and
//     precede the one of the next superblock row that does (the edge at
//     S (r + 1) touches this row's last 8 rows);
//   - of two horizontal edges of one column, only a width-8 edge at 16j + 8
//     (chroma, split blocks) and a width-16 edge at the next multiple of 16
//     share pixels, and the first comes first;
//   - the right half's edges follow V on the rows they touch.
// So every superblock row runs at once, in six levels with a barrier
// between them (HA: chroma edges at 16j + 8; HM: the other edges inside a
// superblock; HT: the edge at its top; V rows by their place in it):
//   1. HA left          2. HM left, V rows [S-8, S)
//   3. HT left, V rows [8, S-8)             4. V rows [0, 8)
//   5. HA right         6. HM and HT right
// (luma has no HA: four levels).

// One column of one horizontal band edge: half 0 is x_b-8..x_b-1, half 1
// x_b..x_b+7; col_l is the tile's offset of column x_b-8.
template <bool CHROMA>
__device__ __forceinline__ void band_h_lane(const Params& P, uint8_t* s,
                                            const uint8_t* sp, int pitch,
                                            int col_l, int h, int half, int y,
                                            int c) {
  if (y <= 0 || y >= h) return;
  uint8_t* q0 = s + y * pitch + col_l + 8 * half + c;
  if constexpr (CHROMA) {
    const int sv = sp[half * P.rows32 + (y >> 4)];
    if (y & 8)
      edge_lane<4>(q0, pitch, 8 * P.on * sv, P);
    else
      edge_lane<8>(q0, pitch, P.on * (sv ? 8 : 16), P);
  } else {
    const int sv = (y & 16) ? sp[half * P.rows32 + (y >> 5)] : 1;
    edge_lane<8>(q0, pitch, 16 * P.on * sv, P);
  }
}

// The horizontal edges at S r + dy_of(j), j < nj, of every superblock row,
// on one half: a lane per edge and column.
template <bool CHROMA, class DyOf>
__device__ __forceinline__ void band_h_level(const Params& P, uint8_t* s,
                                             const uint8_t* sp, int pitch,
                                             int col_l, int h, int half,
                                             int nj, DyOf dy_of) {
  constexpr int S = CHROMA ? 32 : 64;
  const int n_sbr = (h + S - 1) / S;
  for (int i = threadIdx.x; i < n_sbr * nj * 8; i += THREADS) {
    const int c = i & 7, t = i >> 3;
    const int r = t / nj, j = t - r * nj;
    band_h_lane<CHROMA>(P, s, sp, pitch, col_l, h, half, S * r + dy_of(j), c);
  }
}

// Rows [lo, hi) of every superblock row's boundary vertical edge: width 16,
// or (chroma) 8 where the block to its right is split.
template <bool CHROMA>
__device__ __forceinline__ void band_v_level(const Params& P, uint8_t* s,
                                             const uint8_t* sp, int pitch,
                                             int col_l, int h, int lo,
                                             int hi) {
  constexpr int S = CHROMA ? 32 : 64;
  const int n_sbr = (h + S - 1) / S, n = hi - lo;
  for (int i = threadIdx.x; i < n_sbr * n; i += THREADS) {
    const int r = i / n, y = S * r + lo + (i - r * n);
    if (y >= h) continue;
    const int width =
        CHROMA ? P.on * (sp[P.rows32 + (y >> 4)] ? 8 : 16) : 16 * P.on;
    edge_lane<8>(s + y * pitch + col_l + 8, 1, width, P);
  }
}

template <bool CHROMA>
__device__ __forceinline__ void band_levels(const Params& P, uint8_t* s,
                                            const uint8_t* sp, int pitch,
                                            int col_l, int h) {
  constexpr int S = CHROMA ? 32 : 64;
  // chroma HA: 8, 24; HM: 16, then HT: 0. Luma HM: 16, 32, 48, then HT: 0
  auto ha = [](int j) { return 8 + 16 * j; };
  auto hm_ht = [](int j) { return CHROMA ? 16 * (1 - j) : 16 * ((j + 1) & 3); };
  auto ht = [](int) { return 0; };
  constexpr int n_hm = CHROMA ? 1 : 3;
  if constexpr (CHROMA) {
    band_h_level<CHROMA>(P, s, sp, pitch, col_l, h, 0, 2, ha);
    __syncthreads();
  }
  band_h_level<CHROMA>(P, s, sp, pitch, col_l, h, 0, n_hm, hm_ht);
  band_v_level<CHROMA>(P, s, sp, pitch, col_l, h, S - 8, S);
  __syncthreads();
  band_h_level<CHROMA>(P, s, sp, pitch, col_l, h, 0, 1, ht);
  band_v_level<CHROMA>(P, s, sp, pitch, col_l, h, 8, S - 8);
  __syncthreads();
  band_v_level<CHROMA>(P, s, sp, pitch, col_l, h, 0, 8);
  __syncthreads();
  if constexpr (CHROMA) {
    band_h_level<CHROMA>(P, s, sp, pitch, col_l, h, 1, 2, ha);
    __syncthreads();
  }
  band_h_level<CHROMA>(P, s, sp, pitch, col_l, h, 1, n_hm + 1, hm_ht);
  __syncthreads();
}

// ---- a luma band around x_b = 64 k ----
__device__ void luma_band(const Params& P, uint8_t* smem, int k) {
  uint8_t* sp = smem;
  uint8_t* s = smem + P.tile_off;
  constexpr int pitch = PITCH_LUMA_BAND;
  const int x0 = 64 * k - 8;
  load_split(sp, P, 2 * k - 1);
  load_tile(s, pitch, P.in[0], P.pad_w, 0, P.pad_h, x0, x0 + 16);
  tile_arrived();
  band_levels<false>(P, s, sp, pitch, 0, P.h_mi);
  store_tile(s, pitch, x0, P.out[0], P.pad_w, 0, P.pad_h, x0, x0 + 16);
}

// ---- a chroma band around x_b = 32 k of plane pl ----
__device__ void chroma_band(const Params& P, uint8_t* smem, int pl, int k) {
  uint8_t* sp = smem;
  uint8_t* s = smem + P.tile_off;
  constexpr int pitch = PITCH_CHROMA_BAND;
  const int H = P.pad_h >> 1, W = P.pad_w >> 1;
  const int hc = P.h_mi >> 1;
  const int xb = 32 * k, w_lo = xb - 12;
  load_split(sp, P, 2 * k - 1);
  load_tile(s, pitch, P.in[pl], W, 0, H, w_lo, xb + 12);
  tile_arrived();
  if (P.split != nullptr) {
    // the width-8 vertical edges at x_b - 8 and x_b + 8, which write the
    // band's outer three columns on each side, from unfiltered pixels
    for (int i = threadIdx.x; i < 2 * hc; i += THREADS) {
      const int e = i / hc, y = i - e * hc;
      edge_lane<4>(s + y * pitch + (e ? 20 : 4), 1,
                   8 * P.on * sp[e * P.rows32 + (y >> 4)], P);
    }
    __syncthreads();
  }
  band_levels<true>(P, s, sp, pitch, 4, hc);
  store_tile(s, pitch, w_lo, P.out[pl], W, 0, H, xb - 8, xb + 8);
}

// CTAs in the order of their length: the bands and the chroma strips (a
// whole column each) first, then the luma tiles.
// (__grid_constant__: the device functions take the parameters by
// reference, which would otherwise copy them to each thread's stack)
__global__ void __launch_bounds__(THREADS)
loop_filter_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) uint8_t smem[];
  int i = blockIdx.x;
  if (i < P.nb) {
    if (P.parts & 1) luma_band(P, smem, i + 1);
    return;
  }
  i -= P.nb;
  if (i < 2 * P.nb) {
    if (P.parts & 2) chroma_band(P, smem, 1 + i / P.nb, i % P.nb + 1);
    return;
  }
  i -= 2 * P.nb;
  const int ns = P.nb + 1;
  if (i < 2 * ns) {
    if (P.parts & 4) chroma_strip(P, smem, 1 + i / ns, i % ns);
    return;
  }
  i -= 2 * ns;
  if (P.parts & 8) luma_tile(P, smem, i % ns, i / ns);
}

}  // namespace

// y, u, v: uint8 planes of (pad_h, pad_w) and twice (pad_h / 2, pad_w / 2),
// contiguous, on the device; out_*: planes of the same shapes that do not
// overlap them; split: (rows32, cols32) int32 0/1 or null. The caller has
// checked pad_w % 64 == 0, pad_h % 64 == 0, h_mi <= min(pad_h, 32 rows32),
// w_mi <= pad_w with pad_w - w_mi < 64, 0 <= lvl <= 63. parts is 15; a
// measurement passes fewer bits to time one kind of CTA alone (the others
// return at once and their columns of the output stay unwritten). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int loop_filter_launch(const void* y, const void* u,
                                  const void* v, void* out_y, void* out_u,
                                  void* out_v, const void* split, int pad_h,
                                  int pad_w, int h_mi, int w_mi, int rows32,
                                  int cols32, int lvl, int lim, int blim,
                                  int parts, void* stream) {
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
  P.rows32 = rows32;
  P.cols32 = cols32;
  P.on = lvl > 0 ? 1 : 0;
  P.thresh = lvl >> 4;
  P.lim = lim;
  P.blim = blim;
  P.parts = parts;
  P.nb = pad_w / 64 - 1;
  P.tiles = (pad_h + 8 + TILE_ROWS - 1) / TILE_ROWS;
  P.tile_off = (2 * rows32 + 15) / 16 * 16;
  const int tile_bytes =
      std::max({pad_h * PITCH_LUMA_BAND, (pad_h / 2) * PITCH_CHROMA_STRIP,
                (TILE_ROWS + 8) * PITCH_LUMA_TILE});
  const int smem = P.tile_off + tile_bytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        loop_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int ns = P.nb + 1;
  const int grid = 3 * P.nb + 2 * ns + ns * P.tiles;
  loop_filter_kernel<<<grid, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
