// The device keyframe's closed-loop intra encode: the whole 32x32 grid in
// one launch, a CTA per block row, each row handing its blocks' bottom
// rows to the row below.
//
// Replaces the XLA stage tpu_vp9/pipeline/tpu_encdec.py:kframe_step (its
// lax.scan over anti-diagonals, wave_plane and the static permutation
// after it) for geometries without the 16-pixel strip. A block (r, c)
// predicts from the recon of (r, c-1), (r-1, c-1) and (r-1, c) only: the
// above-right samples repeat above[n-1]. So a CTA walks its block row
// from left to right and waits for nothing but the row above. Per block:
//   - reference samples as ops/intra.py builds them: 127 above the frame,
//     129 left of it (and at the above-left corner of column 0 below the
//     first row), above-right repeating above[n-1], the left column clamped
//     to the last visible row;
//   - the 10 luma predictions (DC with availability, V, H, TM, and the six
//     diagonals from ops/intra.py's index and weight maps), their SSE in
//     int32, the cost sse + bias[m] * lam, and the first mode of least
//     cost;
//   - luma at 32 and both chroma planes at 16 with that mode: forward DCT
//     in float64, quantizer, dequantizer, the exact integer inverse, recon
//     and eob (txfm_common.cuh).
// The plain version (pipeline/tpu_encdec.py:kframe_wave_ref) gives the
// same modes, levels, eobs and recon unless a coefficient's |c| / q + 0.38
// lies within about 1e-12 of an integer.
//
// What bounds it on an H100: the chain. The frame's work (3.3e8 float64
// operations, some 3.3e8 integer ones, 12.6 MB moved) would take the card
// about 0.01 ms, but block (r, c) cannot start before (r-1, c) and
// (r, c-1) are done, so the frame takes rows + cols - 1 block latencies
// (93 at 1080p) and at most one CTA per block row (34) works at a time.
// The design cuts that latency and the cost of each handoff:
//   - one persistent launch: a CTA takes its block row from an atomicAdd
//     ticket (not from blockIdx), so a CTA that waits for row r-1 waits
//     for one that is already running, whatever order the CTAs start in;
//   - the handoff: as soon as a block's column inverse has made its bottom
//     rows (32 + 16 + 16 bytes), they go to the edge buffer as 16 64-bit
//     words, four bytes and a tag each, stored relaxed at the card's
//     scope; a 64-bit store is single-copy atomic, so the row below polls
//     the words themselves (16 lanes of one warp, __nanosleep between
//     polls) and has the bytes when it sees the tags: one L2 round trip,
//     no release fence, no separate flag; and it reads the next block's
//     words ahead, at the end of the block before, so that the row above
//     is most often found done without a wait. The left column and the
//     above-left corner of the next block stay in the CTA; the recon
//     planes, levels, eobs and mode are written after the words. A wait
//     gives up after max_polls polls and sets the error word, which the
//     wrapper hands on and the caller reads; a CTA that finds the word set
//     stops. The wrapper zeroes the tags, the ticket and the word for every
//     keyframe;
//   - the constant tables (F_col at 32 and 16, the directional maps as
//     each mode's distinct packed words and each pixel's index into them,
//     the inverse scans) are staged in shared memory once per CTA, and the
//     next block's source is loaded while the CTA waits and works;
//   - the predictions: per block, each mode's distinct words are filtered
//     once (1,536 values for the three planes); a pixel's prediction is
//     then a byte lookup. The 10 SSEs are warp sums, added across warps
//     by every warp for itself; the warp sums, the mode's minimum and the
//     eob's maximum are redux.sync reductions;
//   - the forward transform on the float64 tensor cores in the m16n8k16
//     shape (twice m8n8k4's rate on an H100): luma's two 16-row strips on
//     two warps each (each warp T's half that is the second product's
//     k-block, then the pair adds its partial sums through shared memory),
//     u and v a warp each; the quantizer (txfm::quantize_rcp's decision)
//     on all of a lane's coefficients in registers at once, the eob a
//     maximum over the inverse scan, reduced after the handoff;
//   - the inverse by rows, then by columns with the recon: each luma line
//     split into its even half (an idct16) on warp 0 and its odd half on
//     warp 1, joined through shared memory; both chroma planes a thread
//     per line on warp 2, beside them;
//   - every phase issues its shared-memory loads before its stores, which
//     the compiler cannot reorder.
// Seven CTA barriers a block.

#include <cstdint>
#include <cuda_runtime.h>

#include "intra_pred.cuh"
#include "txfm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
using intra_pred::kModes;
using intra_pred::dc_of;
using intra_pred::filt;
using intra_pred::mode_bias;
using intra_pred::tm_pred;
using intra_pred::warp_max;
using intra_pred::warp_min;
using intra_pred::warp_sum;
// pixels of a block's three planes: luma 32x32, then u and v 16x16
constexpr int kPix = 1024 + 2 * 256;
// a block's bottom rows in the edge buffer: 16 words of 64 bits, four
// bytes each (luma's 32 in words 0-7, u's 16 in 8-11, v's in 12-15) and a
// tag in the high half, set when the bytes are there
constexpr int kEdgeWords = 16;
// the reference vectors [left n, above-left, above and above-right 2n] of
// the three planes lie one after the other: luma at 0, u at 97, v at 146
// the integer work planes at an odd pitch (33, 17): a thread per row or per
// column walks them without bank conflicts (luma at 0, u at 1056, v at
// 1328)
constexpr int kIntU = 32 * 33, kIntAll = kIntU + 2 * 16 * 17;
// the constant tables (ops/cuda_kernels.py:_kf_tables_on): float64 F_col
// of n = 32 then 16; int32 words: per block size (32, then 16) the
// distinct packed words of each of the 8 directional modes (V, H and the
// six diagonals: kU32 and kU16 a mode, padded), then per size each pixel's
// index into its mode's list for the 8 modes (a byte each, 8 a pixel),
// then the inverse scans (raster place -> scan place) of 32 and 16
constexpr int kU32 = 96, kU16 = 48;
constexpr int kTabUniq16 = 8 * kU32, kTabIdx32 = kTabUniq16 + 8 * kU16;
constexpr int kTabIdx16 = kTabIdx32 + 1024 * 2;
constexpr int kTabIscan32 = kTabIdx16 + 256 * 2;
constexpr int kTabIscan16 = kTabIscan32 + 1024, kTabs = kTabIscan16 + 256;
// a block's filtered directional values, bytes: luma's 8 x kU32, then u's
// and v's 8 x kU16
constexpr int kVals = 8 * kU32 + 2 * 8 * kU16;
// the sync words (the wrapper zeroes them and the edge buffer for every
// keyframe): the ticket and the error word
constexpr int kTicket = 0, kErr = 1;
// the CTA's small words
constexpr int kRow = 0, kAbort = 1, kDc = 2, kMisc = 8;

// dynamic shared memory, in bytes
constexpr int kOffFc32 = 0;                       // double[1024]
constexpr int kOffFc16 = kOffFc32 + 1024 * 8;     // double[256]
constexpr int kOffRes = kOffFc16 + 256 * 8;       // double[kPix], residual
constexpr int kOffTabs = kOffRes + kPix * 8;      // int[kTabs]
constexpr int kOffInt = kOffTabs + kTabs * 4;     // int[kIntAll]
constexpr int kOffRef = kOffInt + kIntAll * 4;    // int[97 + 2 * 49], padded
constexpr int kOffSse = kOffRef + 196 * 4;        // int[kWarps][kModes]
constexpr int kOffTop = kOffSse + kWarps * kModes * 4;  // int[6][32]
constexpr int kOffMisc = kOffTop + 6 * 32 * 4;   // int[kMisc]
constexpr int kOffSrc = kOffMisc + kMisc * 4;     // uint8[2][kPix]
constexpr int kOffPred = kOffSrc + 2 * kPix;      // uint8[kPix], then recon
constexpr int kOffVal = kOffPred + kPix;          // uint8[kVals]
constexpr int kOffLeft = kOffVal + kVals;         // uint8[64]
// the luma warp pairs' exchange of partial sums: per warp two n-tiles of
// 16 x 8 float64, lane-major
constexpr int kOffXch = kOffLeft + 64;            // double[4][2][128]
constexpr int kSmem = kOffXch + 4 * 2 * 128 * 8;
static_assert(kOffTabs % 16 == 0 && kOffSrc % 16 == 0 && kOffXch % 16 == 0 &&
                  kOffPred % 16 == 0 && kTabs % 4 == 0 && kTabIdx32 % 2 == 0,
              "16-byte units of shared memory stay aligned");

struct Params {
  const uint8_t* src[3];  // padded source planes
  uint8_t* rec[3];        // recon planes, (rows*32, cols*32) and halves
  int* mode;              // (rows*cols,)
  int16_t* lv[3];         // (rows*cols, n, n)
  int* eob;               // (3, rows*cols)
  const double* mats;     // F_col of 32 and 16
  const int* tabs;        // directional words, inverse scans
  unsigned long long* edge;  // (rows*cols, kEdgeWords) tagged words
  int* sync;              // ticket, error word
  int src_pitch;          // luma; chroma is half
  int height;             // visible luma height
  int rows, cols;
  int dc_q, ac_q, lam;
  int max_polls;          // polls of a wait before it gives up
  int vec;                // src planes 16-byte aligned: vector loads
};

// The row-to-row handoff: loads and stores at the scope of the whole card
// that no cache of one SM answers; a 64-bit one is single-copy atomic, so
// a tagged word's tag and bytes arrive together. A build of the sources
// off the card (a stand-in header that defines KF_SYNC_STANDIN) supplies
// its own.
#ifndef KF_SYNC_STANDIN
__device__ __forceinline__ int ld_relaxed_gpu(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed_gpu(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned long long ld_relaxed_gpu64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed_gpu64(unsigned long long* p,
                                                 unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}
// a barrier of `count` threads (whole warps) of the CTA, number id (0 is
// __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}
#endif

// 16 bytes of block (r, c)'s source: unit u < 64 is half a luma row (row
// u >> 1), 64..79 a u row, 80..95 a v row; in s_src the unit lies at 16 u
__device__ __forceinline__ const uint8_t* src_unit(const Params& P, int r,
                                                   int c, int u) {
  if (u < 64) {
    return P.src[0] + static_cast<int64_t>(r * 32 + (u >> 1)) * P.src_pitch +
           c * 32 + 16 * (u & 1);
  }
  const int p = u < 80 ? 1 : 2;
  return P.src[p] +
         static_cast<int64_t>(r * 16 + ((u - 64) & 15)) * (P.src_pitch >> 1) +
         c * 16;
}

__device__ __forceinline__ uint4 load_src(const Params& P, int r, int c,
                                          int u) {
  const uint8_t* s = src_unit(P, r, c, u);
  if (P.vec) return __ldg(reinterpret_cast<const uint4*>(s));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    w[e / 4] |= static_cast<uint32_t>(__ldg(s + e)) << (8 * (e % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the same unit of the recon planes
__device__ __forceinline__ uint8_t* rec_unit(const Params& P, int r, int c,
                                             int u) {
  if (u < 64) {
    return P.rec[0] + static_cast<int64_t>(r * 32 + (u >> 1)) * P.cols * 32 +
           c * 32 + 16 * (u & 1);
  }
  const int p = u < 80 ? 1 : 2;
  return P.rec[p] +
         static_cast<int64_t>(r * 16 + ((u - 64) & 15)) * P.cols * 16 +
         c * 16;
}

// Lanes 0-15 of a warp hold the 16 tagged words of a block's bottom rows
// as read ahead (w), and poll those whose tag is not set yet until every
// tag is; `word` gets the lane's four bytes. False if the wait gave up
// after max_polls polls (the error word then holds row + 1) or found the
// error word set by another row.
__device__ bool poll_edge(const unsigned long long* words,
                          unsigned long long w, int lane, int* err,
                          int max_polls, int row, uint32_t& word) {
  bool ok = lane >= kEdgeWords || (w >> 32) != 0;
  for (int polls = 0; !__all_sync(0xffffffffu, ok); ++polls) {
    if (polls >= max_polls) {
      if (lane == 0) st_relaxed_gpu(err, row + 1);
      return false;
    }
    if ((polls & 31) == 31) {
      const int e = lane == 0 ? ld_relaxed_gpu(err) : 0;
      if (__shfl_sync(0xffffffffu, e, 0) != 0) return false;
      __nanosleep(64);
    }
    if (!ok) {
      w = ld_relaxed_gpu64(words + lane);
      ok = (w >> 32) != 0;
    }
  }
  word = static_cast<uint32_t>(w);
  return true;
}

// Lane `lane` (< 16) of warp 0 reads ahead its tagged word of block bi's
// bottom rows; 0 (no tag) for the other lanes and outside the grid
__device__ __forceinline__ unsigned long long read_edge(const Params& P,
                                                        int bi, bool valid,
                                                        int lane) {
  return valid && lane < kEdgeWords
             ? ld_relaxed_gpu64(P.edge + static_cast<int64_t>(bi) * kEdgeWords +
                                lane)
             : 0ull;
}

// The column pass of the inverse and the recon, as txfm::idct_col_recon
// computes them, with every load (the column, then the prediction's
// bytes) before the first store, so that the loads overlap
template <int N>
__device__ __forceinline__ void col_recon(const int* x, int stride,
                                          uint8_t* p, int pstride) {
  int in[N], out[N], pred[N];
#pragma unroll
  for (int k = 0; k < N; ++k) in[k] = x[k * stride];
#pragma unroll
  for (int k = 0; k < N; ++k) pred[k] = p[k * pstride];
  txfm::idct_n<N>(in, out);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    p[k * pstride] = txfm::recon_pixel(pred[k], out[k], N);
  }
}

// One idct32 line split across two warps: warp 0 holds the line's even
// inputs and warp 1 its odd inputs (in), lane l of both the same line.
// Warp 0 computes the even half (idct16), warp 1 the odd half
// (txfm::idct32_odd); they swap halves through `scratch` (two planes of 32
// lines at pitch 33), and on return warp 0's half[k] is output k and warp
// 1's output 31 - k (k < 16). Warps 0 and 1 meet at named barrier 1; the
// scratch is free again after the next CTA barrier.
__device__ __forceinline__ void join_halves(const int (&in)[16],
                                            int (&half)[16], int* scratch,
                                            int warp, int lane) {
  int mine[16];
  if (warp == 0) {
    txfm::idct16(in, mine);
  } else {
    txfm::idct32_odd(in, mine);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) scratch[warp * 1056 + lane * 33 + k] = mine[k];
  bar_sync(1, 64);
  const int* other = scratch + (1 - warp) * 1056 + lane * 33;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    // o[k] = e[k] + odd[15 - k], o[31 - k] = e[k] - odd[15 - k]
    half[k] = warp == 0 ? mine[k] + other[15 - k] : other[k] - mine[15 - k];
  }
}

// the quantizer of one block size: steps, q_eff (q / 2 at n = 32) and
// their reciprocals
struct Quant {
  int dc, ac;
  double qe_dc, qe_ac, r_dc, r_ac;
};

__device__ __forceinline__ Quant make_quant(int dc_q, int ac_q, int n) {
  Quant q;
  q.dc = dc_q;
  q.ac = ac_q;
  q.qe_dc = n == 32 ? 0.5 * dc_q : dc_q;
  q.qe_ac = n == 32 ? 0.5 * ac_q : ac_q;
  q.r_dc = 1.0 / q.qe_dc;
  q.r_ac = 1.0 / q.qe_ac;
  return q;
}

// The forward products on the tensor cores (m16n8k16), in the fragment
// layout of txfm::mma_f64_16x8x16 (g = lane >> 2, t = lane & 3). fc is
// F_col (txfm::fwd_mat_at), r the residual (txfm::fwd_res_at), both
// float64 in shared memory; F_row^T is F_col^T / 64 exactly (the scale is
// applied at the end and changes no bit). T = F_col @ R is exact in any
// order. T's accumulators are the second product's A fragments as they
// stand: lane (g, t) holds T's columns 2 t, 2 t + 1 of two 8-column tiles,
// so the second product takes its k-slot t + 4 v as column
// 2 t + (v & 1) + 8 (v >> 1) of its 16, and the B fragments to match.

// T's tiles jj = 0, 1 (columns c0 + 8 jj ...) of rows y0 .. y0 + 15:
// t_acc[jj][e] = T[y0 + g + 8 (e >> 1)][c0 + 8 jj + 2 t + (e & 1)]
template <int N>
__device__ __forceinline__ void fwd_t(const double* fc, const double* r,
                                      int y0, int c0, int lane,
                                      double (&t_acc)[2][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) t_acc[jj][e] = 0.0;
  }
#pragma unroll
  for (int kb = 0; kb < N / 16; ++kb) {
    double a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a[i] = fc[txfm::fwd_mat_at<N>(y0 + g + 8 * (i & 1),
                                    16 * kb + t + 4 * (i >> 1))];
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      double b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b[i] = r[txfm::fwd_res_at<N>(16 * kb + t + 4 * i, c0 + 8 * jj + g)];
      }
      txfm::mma_f64_16x8x16(t_acc[jj], a, b);
    }
  }
}

// (T's columns k0 .. k0 + 15 for rows y0 ..) @ F_row^T's rows k0 ..: the
// partial X of n-tiles jn = 0 .. NT-1 (columns 8 jn ...), unscaled
template <int N, int NT>
__device__ __forceinline__ void fwd_x(const double* fc,
                                      const double (&t_acc)[2][4], int k0,
                                      int lane, double (&x)[NT][4]) {
  const int g = lane >> 2, t = lane & 3;
  double a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int v = i >> 1;
    a[i] = t_acc[v >> 1][2 * (i & 1) + (v & 1)];
  }
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[jn][e] = 0.0;
    double b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[i] = fc[txfm::fwd_mat_at<N>(8 * jn + g,
                                    k0 + 2 * t + (i & 1) + 8 * (i >> 1))];
    }
    txfm::mma_f64_16x8x16(x[jn], a, b);
  }
}

// The quantizer on a lane's 8 coefficients x[jj][e] = X[y0 + 8 (e >> 1)]
// [8 (jc0 + jj) + 2 t + (e & 1)] of an N x N block (y0 holds g):
// txfm::quantize_rcp on all of them side by side (the fast path, then the
// rounded quotient for those whose |c| / q_eff + 0.38 lies near an integer:
// rare, so one branch for all), the dequantized levels into the integer
// plane (pitch N + 1), the levels as int16 pairs (pairs[2 jj + (e >> 1)]).
// Returns the lane's eob candidate: the last nonzero level's place in scan
// order plus one.
template <int N>
__device__ __forceinline__ int quant8(const double (&x)[2][4], int y0,
                                      int jc0, int lane, const Quant& q,
                                      int* plane, const int* iscan,
                                      uint32_t (&pairs)[4]) {
  const int t = lane & 3;
  double v[8];
  unsigned near = 0;  // bit i: v[i] lies near an integer, below the clip
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int jj = i >> 2, e = i & 3;
    const bool dc = y0 + 8 * (e >> 1) == 0 && 8 * (jc0 + jj) + 2 * t + (e & 1) == 0;
    v[i] = __dadd_rn(__dmul_rn(fabs(x[jj][e]), dc ? q.r_dc : q.r_ac),
                     txfm::kQBias);
    // rint(v) by the 1.5 * 2^52 addition (0 <= v < 2^51), both tests
    // evaluated, so that the eight chains run side by side
    const double rn = __dadd_rn(v[i], 0x1.8p52) - 0x1.8p52;
    near |= static_cast<unsigned>((v[i] < 8192.0) &
                                  (fabs(v[i] - rn) < 0x1p-20))
            << i;
  }
  if (near != 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if ((near >> i) & 1) {
        const int jj = i >> 2, e = i & 3;
        const bool dc = y0 + 8 * (e >> 1) == 0 &&
                        8 * (jc0 + jj) + 2 * t + (e & 1) == 0;
        const double a = fabs(x[jj][e]);
        v[i] = __dadd_rn(txfm::div_rn_from_rcp(
                             a, dc ? q.qe_dc : q.qe_ac,
                             __dmul_rn(a, dc ? q.r_dc : q.r_ac)),
                         txfm::kQBias);
      }
    }
  }
  // the levels; then every scan place's load; then the stores
  int level[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // floor(v) in the low word of v + 2^52 rounded down (0 <= v < 2^52)
    const int mag = min(__double2loint(__dadd_rd(v[i], 0x1p52)),
                        txfm::kMaxLevel);
    level[i] = x[i >> 2][i & 3] < 0.0 ? -mag : mag;
  }
  int top = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int jj = i >> 2, e = i & 3;
    const int y = y0 + 8 * (e >> 1), xx = 8 * (jc0 + jj) + 2 * t + (e & 1);
    if (level[i] != 0) top = max(top, iscan[y * N + xx] + 1);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int jj = i >> 2, e = i & 3;
    const int y = y0 + 8 * (e >> 1), xx = 8 * (jc0 + jj) + 2 * t + (e & 1);
    plane[y * (N + 1) + xx] =
        txfm::dequant(level[i], y == 0 && xx == 0 ? q.dc : q.ac, N);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {  // p = 2 jj + (e >> 1); the pair e & 1
    const int i = 4 * (p >> 1) + 2 * (p & 1);
    pairs[p] = static_cast<uint32_t>(static_cast<uint16_t>(level[i])) |
               static_cast<uint32_t>(static_cast<uint16_t>(level[i + 1]))
                   << 16;
  }
  return top;
}

__global__ void __launch_bounds__(kThreads, 1)
    kframe_wave_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_fc32 = reinterpret_cast<double*>(smem + kOffFc32);
  double* s_fc16 = reinterpret_cast<double*>(smem + kOffFc16);
  double* s_res = reinterpret_cast<double*>(smem + kOffRes);
  int* s_tabs = reinterpret_cast<int*>(smem + kOffTabs);
  int* s_int = reinterpret_cast<int*>(smem + kOffInt);
  int* s_ref = reinterpret_cast<int*>(smem + kOffRef);
  int* s_sse = reinterpret_cast<int*>(smem + kOffSse);
  int* s_misc = reinterpret_cast<int*>(smem + kOffMisc);
  int* s_top = reinterpret_cast<int*>(smem + kOffTop);  // eob candidates
  uint8_t* s_src = smem + kOffSrc;
  uint8_t* s_pred = smem + kOffPred;
  uint8_t* s_val = smem + kOffVal;
  // the inverse's exchange of halves, over the residual (dead by then)
  int* s_half = reinterpret_cast<int*>(smem + kOffRes);
  double* s_xch = reinterpret_cast<double*>(smem + kOffXch);
  uint8_t* s_left = smem + kOffLeft;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // 0. the tables, once; the block row from the ticket
  for (int i = tid; i < 1024; i += kThreads) {
    s_fc32[txfm::fwd_mat_at<32>(i >> 5, i & 31)] = P.mats[i];
  }
  for (int i = tid; i < 256; i += kThreads) {
    s_fc16[txfm::fwd_mat_at<16>(i >> 4, i & 15)] = P.mats[1024 + i];
  }
  for (int i = tid; i < kTabs / 4; i += kThreads) {
    reinterpret_cast<uint4*>(s_tabs)[i] =
        __ldg(reinterpret_cast<const uint4*>(P.tabs) + i);
  }
  if (tid == 0) {
    s_misc[kRow] = atomicAdd(P.sync + kTicket, 1);
    s_misc[kAbort] = 0;
  }
  __syncthreads();
  const int r = s_misc[kRow];
  if (r >= P.rows) return;
  const int cols = P.cols, nblk = P.rows * cols;
  const bool ha = r >= 1;
  const Quant q32 = make_quant(P.dc_q, P.ac_q, 32);
  const Quant q16 = make_quant(P.dc_q, P.ac_q, 16);
  // the last visible row of this block row, luma and chroma (the left
  // column that the next block reads is clamped to it)
  const int last_y = max(P.height - 1 - 32 * r, 0);
  const int last_c = max(((P.height + 1) >> 1) - 1 - 16 * r, 0);
  const uint8_t* s_idx32 =
      reinterpret_cast<const uint8_t*>(s_tabs + kTabIdx32);
  const uint8_t* s_idx16 =
      reinterpret_cast<const uint8_t*>(s_tabs + kTabIdx16);
  // warp 0's above-left samples of the next block: this block's above[n-1]
  int corner_y = 129, corner_u = 129, corner_v = 129;
  // warp 0's words of the block above, read ahead (the row above is most
  // often done with it by the time this row asks)
  unsigned long long ahead =
      read_edge(P, r * cols - cols, ha && warp == 0, lane);
  // the first block's source
  if (tid >= 32 && tid < 128) {
    *reinterpret_cast<uint4*>(s_src + 16 * (tid - 32)) =
        load_src(P, r, 0, tid - 32);
  }

  for (int c = 0; c < cols; ++c) {
    const uint8_t* s_cur = s_src + (c & 1) * kPix;
    const int bi = r * cols + c;
    const bool hl = c >= 1;

    // 1. the next block's source into registers on warps 1-3 (stored at
    // the end of this block); on warp 0 the wait for block (r-1, c)'s
    // bottom rows, then the reference vectors and the DCs of the planes
    const bool prefetch = c + 1 < cols && tid >= 32 && tid < 128;
    uint4 next = make_uint4(0, 0, 0, 0);
    if (prefetch) next = load_src(P, r, c + 1, tid - 32);
    if (warp == 0) {
      uint32_t word = 0x7f7f7f7fu;  // above the frame
      if (ha && !poll_edge(P.edge + static_cast<int64_t>(bi - cols) *
                                        kEdgeWords,
                           ahead, lane, P.sync + kErr, P.max_polls, r,
                           word)) {
        if (lane == 0) s_misc[kAbort] = 1;
      } else {
        // luma's above sample `lane`, and chroma's (u 0-15, v 16-31)
        const int sh = 8 * (lane & 3);
        const int above_y =
            (__shfl_sync(0xffffffffu, word, lane >> 2) >> sh) & 255;
        const int above_c =
            (__shfl_sync(0xffffffffu, word, 8 + (lane >> 2)) >> sh) & 255;
        const int left_y = hl ? s_left[lane] : 129;
        const int left_c = hl ? s_left[32 + lane] : 129;
        s_ref[lane] = left_y;
        s_ref[33 + lane] = above_y;
        s_ref[65 + lane] = __shfl_sync(0xffffffffu, above_y, 31);
        const int h = lane >> 4, x = lane & 15;
        int* ref = s_ref + 97 + 49 * h;
        ref[x] = left_c;
        ref[17 + x] = above_c;
        ref[33 + x] = __shfl_sync(0xffffffffu, above_c, lane | 15);
        // above-left: the previous block's above[n - 1]
        if (lane == 0) {
          s_ref[32] = !ha ? 127 : (hl ? corner_y : 129);
          s_ref[97 + 16] = !ha ? 127 : (hl ? corner_u : 129);
          s_ref[146 + 16] = !ha ? 127 : (hl ? corner_v : 129);
        }
        corner_y = __shfl_sync(0xffffffffu, above_y, 31);
        corner_u = __shfl_sync(0xffffffffu, above_c, 15);
        corner_v = __shfl_sync(0xffffffffu, above_c, 31);
        const int sum_y =
            warp_sum((hl ? left_y : 0) + (ha ? above_y : 0));
        const int own_c = (hl ? left_c : 0) + (ha ? above_c : 0);
        const int sum_c = warp_sum(h == 0 ? own_c : 0) * (1 - h) +
                          warp_sum(h == 1 ? own_c : 0) * h;
        if (lane == 0) s_misc[kDc] = dc_of(sum_y, ha, hl, 5);
        if (x == 0) s_misc[kDc + 1 + h] = dc_of(sum_c, ha, hl, 4);
      }
    }
    __syncthreads();
    if (s_misc[kAbort]) return;

    // 2. the directional modes' filtered values: each distinct packed
    // word of each mode, for the three planes
    static_assert(kVals == 6 * kThreads && 8 * kU32 == 3 * kThreads &&
                      8 * kU16 == 3 * kThreads / 2,
                  "luma's values are the CTA's first three rounds");
    {
      int val[6];  // all loads first, then the stores
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const int e = tid + kThreads * k;
        if (k < 3) {
          val[k] = filt(static_cast<unsigned>(s_tabs[e]), s_ref);
        } else {
          const int f = e - 8 * kU32, h = f >= 8 * kU16 ? 1 : 0;
          val[k] = filt(
              static_cast<unsigned>(s_tabs[kTabUniq16 + f - 8 * kU16 * h]),
              s_ref + 97 + 49 * h);
        }
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        s_val[tid + kThreads * k] = static_cast<uint8_t>(val[k]);
      }
    }
    __syncthreads();

    // 3. the 10 luma predictions of four pixels a thread and their SSE,
    // summed over the warp
    {
      const int dc0 = s_misc[kDc];
      int acc[kModes];
#pragma unroll
      for (int m = 0; m < kModes; ++m) acc[m] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = tid + kThreads * k, y = i >> 5, x = i & 31;
        const int s = s_cur[i];
        const uint2 ix = *reinterpret_cast<const uint2*>(s_idx32 + 8 * i);
#pragma unroll
        for (int m = 0; m < kModes; ++m) {
          int p;
          if (m == 0) {
            p = dc0;
          } else if (m == kModes - 1) {
            p = tm_pred(s_ref, 32, y, x);
          } else {
            const unsigned w = m <= 4 ? ix.x : ix.y;
            p = s_val[(m - 1) * kU32 + ((w >> (8 * ((m - 1) & 3))) & 255)];
          }
          const int e = s - p;
          acc[m] += e * e;
        }
      }
#pragma unroll
      for (int m = 0; m < kModes; ++m) {
        const int t = warp_sum(acc[m]);
        if (lane == 0) s_sse[warp * kModes + m] = t;
      }
    }
    __syncthreads();

    // 4. the mode (every warp finds it: the first of least cost), the
    // chosen predictions and the residuals of the three planes
    int mode;
    {
      int key = 0x7fffffff;
      if (lane < kModes) {
        int sse = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sse += s_sse[w * kModes + lane];
        // a cost below 2^27 (KF_MAX_LAM): the key keeps the order of
        // costs, then of modes
        key = ((sse + mode_bias(lane) * P.lam) << 4) | lane;
      }
      mode = warp_min(key) & 15;
    }
    // every load of the phase before its first store, so that the loads
    // overlap (shared memory the compiler cannot tell apart stays in order)
    {
      // the thread's pixels: k < 4 luma pixel tid + 256 k, k = 4, 5
      // chroma pixel tid of u, v; the mode's branch taken once for all
      int pred[6], src[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        src[k] = s_cur[k < 4 ? tid + kThreads * k : 1024 + 256 * (k - 4) + tid];
      }
      if (mode == 0) {
#pragma unroll
        for (int k = 0; k < 6; ++k) pred[k] = s_misc[kDc + (k < 4 ? 0 : k - 3)];
      } else if (mode == kModes - 1) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const int i = tid + kThreads * k;
          pred[k] = k < 4 ? tm_pred(s_ref, 32, i >> 5, i & 31)
                          : tm_pred(s_ref + 97 + 49 * (k - 4), 16, tid >> 4,
                                    tid & 15);
        }
      } else {
        // the directional modes: the pixel's index, then its value
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const int i = tid + kThreads * k;
          pred[k] = k < 4 ? s_val[(mode - 1) * kU32 + s_idx32[8 * i + mode - 1]]
                          : s_val[8 * kU32 + 8 * kU16 * (k - 4) +
                                  (mode - 1) * kU16 +
                                  s_idx16[8 * tid + mode - 1]];
        }
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        if (k < 4) {
          const int i = tid + kThreads * k;
          s_pred[i] = static_cast<uint8_t>(pred[k]);
          s_res[txfm::fwd_res_at<32>(i >> 5, i & 31)] =
              static_cast<double>(src[k] - pred[k]);
        } else {
          const int h = k - 4;
          s_pred[1024 + 256 * h + tid] = static_cast<uint8_t>(pred[k]);
          s_res[1024 + 256 * h + txfm::fwd_res_at<16>(tid >> 4, tid & 15)] =
              static_cast<double>(src[k] - pred[k]);
        }
      }
    }
    __syncthreads();

    // 5. the forward transform and the quantizer. Luma's rows 16 sl ..
    // 16 sl + 15 on warps 2 sl and 2 sl + 1: warp hf computes T's columns
    // 16 hf .. 16 hf + 15, which are the second product's k-block hf, and
    // its partial X over it for all four n-tiles; the pair swaps the
    // n-tiles the other keeps (warp hf keeps 2 hf and 2 hf + 1) through
    // shared memory and adds them. u and v a warp each (warps 4, 5).
    uint32_t pairs[4];
    if (warp < 6) {
      double x[2][4];
      int y0, jc0;
      if (warp < 4) {
        const int sl = warp >> 1, hf = warp & 1;
        double t_acc[2][4], part[4][4];
        fwd_t<32>(s_fc32, s_res, 16 * sl, 16 * hf, lane, t_acc);
        fwd_x<32, 4>(s_fc32, t_acc, 16 * hf, lane, part);
        double* mine = s_xch + ((2 * sl + hf) * 2) * 128;
        const double* theirs = s_xch + ((2 * sl + 1 - hf) * 2) * 128;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mine[jj * 128 + e * 32 + lane] =
                hf ? part[jj][e] : part[2 + jj][e];
          }
        }
        if (sl == 0) {
          bar_sync(1, 64);
        } else {
          bar_sync(2, 64);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[jj][e] = ((hf ? part[2 + jj][e] : part[jj][e]) +
                        theirs[jj * 128 + e * 32 + lane]) *
                       (1.0 / 64);
          }
        }
        y0 = 16 * sl + (lane >> 2);
        jc0 = 2 * hf;
      } else {
        const int h = warp - 4;
        double t_acc[2][4];
        fwd_t<16>(s_fc16, s_res + 1024 + 256 * h, 0, 0, lane, t_acc);
        fwd_x<16, 2>(s_fc16, t_acc, 0, lane, x);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) x[jj][e] *= 1.0 / 64;
        }
        y0 = lane >> 2;
        jc0 = 0;
      }
      const int top =
          warp < 4
              ? quant8<32>(x, y0, jc0, lane, q32, s_int, s_tabs + kTabIscan32,
                           pairs)
              : quant8<16>(x, y0, jc0, lane, q16,
                           s_int + kIntU + 272 * (warp - 4),
                           s_tabs + kTabIscan16, pairs);
      s_top[warp * 32 + lane] = top;  // the eob is reduced after the flag
    }
    __syncthreads();

    // 6. the inverse by rows: for luma's row `lane`, the even half (an
    // idct16 of the even inputs) on warp 0 and the odd half on warp 1,
    // joined through shared memory; u's and v's 16 rows on warp 2 (the two
    // planes lie one after the other at pitch 17)
    if (warp < 2) {
      int* row = s_int + lane * 33;
      int in[16], half[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) in[k] = row[2 * k + warp];
      join_halves(in, half, s_half, warp, lane);
#pragma unroll
      for (int k = 0; k < 16; ++k) row[warp == 0 ? k : 31 - k] = half[k];
    } else if (warp == 2) {
      txfm::idct_line<16>(s_int + kIntU + lane * 17, 1);
    }
    __syncthreads();

    // 7. by columns, the same way, with the recon into the prediction's
    // bytes; then the bottom rows (luma's from warp 1) to the edge buffer,
    // four bytes and the tag a word, for the row below
    unsigned long long* edge = P.edge + static_cast<int64_t>(bi) * kEdgeWords;
    if (warp < 2) {
      const int* col = s_int + lane;
      int in[16], half[16], pred[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) in[k] = col[(2 * k + warp) * 33];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        pred[k] = s_pred[(warp == 0 ? k : 31 - k) * 32 + lane];
      }
      join_halves(in, half, s_half, warp, lane);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        s_pred[(warp == 0 ? k : 31 - k) * 32 + lane] =
            txfm::recon_pixel(pred[k], half[k], 32);
      }
      __syncwarp();
      if (warp == 1 && lane < 8) {
        st_relaxed_gpu64(edge + lane,
                         (1ull << 32) | *reinterpret_cast<const uint32_t*>(
                                            s_pred + 31 * 32 + 4 * lane));
      }
    } else if (warp == 2) {
      const int h = lane >> 4, x = lane & 15;
      col_recon<16>(s_int + kIntU + 272 * h + x, 17,
                    s_pred + 1024 + 256 * h + x, 16);
      __syncwarp();
      if (lane < 8) {
        st_relaxed_gpu64(
            edge + 8 + lane,
            (1ull << 32) | *reinterpret_cast<const uint32_t*>(
                               s_pred + 1024 + 256 * (lane >> 2) + 15 * 16 +
                               4 * (lane & 3)));
      }
    }
    __syncthreads();

    // 8. the rest of the block: the next block's left column (clamped to
    // the last visible row), the recon, levels, eobs and mode, and the next
    // block's source
    if (warp == 0) {  // warp 0 reads them, lane by lane, before a barrier
      s_left[lane] = s_pred[min(lane, last_y) * 32 + 31];
      s_left[32 + lane] = s_pred[1024 + 256 * (lane >> 4) +
                                 min(lane & 15, last_c) * 16 + 15];
    }
    if (prefetch) *reinterpret_cast<uint4*>(
        s_src + ((c + 1) & 1) * kPix + 16 * (tid - 32)) = next;
    if (tid >= 128 && tid < 224) {
      const int u = tid - 128;
      *reinterpret_cast<uint4*>(rec_unit(P, r, c, u)) =
          *reinterpret_cast<const uint4*>(s_pred + 16 * u);
    }
    if (warp < 6) {
      const int p = warp < 4 ? 0 : warp - 3, n = p == 0 ? 32 : 16;
      const int y0 = (warp < 4 ? 16 * (warp >> 1) : 0) + (lane >> 2);
      const int jc0 = warp < 4 ? 2 * (warp & 1) : 0;
      int16_t* lv = P.lv[p] + static_cast<int64_t>(bi) * n * n;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        *reinterpret_cast<uint32_t*>(
            lv + (y0 + 8 * (q & 1)) * n + 8 * (jc0 + (q >> 1)) +
            2 * (lane & 3)) = pairs[q];
      }
    }
    if (warp == 7) {  // the eobs: the maxima of the lanes' candidates
      const int* tp = s_top + lane;
      const int ey = warp_max(max(max(tp[0], tp[32]), max(tp[64], tp[96])));
      const int eu = warp_max(tp[128]), ev = warp_max(tp[160]);
      if (lane == 0) {
        P.eob[bi] = ey;
        P.eob[nblk + bi] = eu;
        P.eob[2 * nblk + bi] = ev;
      }
    }
    if (tid == 255) P.mode[bi] = mode;
    if (warp == 0) ahead = read_edge(P, bi + 1 - cols, ha && c + 1 < cols, lane);
  }
}

Params make_params(const void* src_y, const void* src_u, const void* src_v,
                   void* rec_y, void* rec_u, void* rec_v, void* mode,
                   void* lv_y, void* lv_u, void* lv_v, void* eob,
                   const void* mats, const void* tabs, void* edge,
                   void* sync, int src_pitch, int height, int rows, int cols,
                   int dc_q, int ac_q, int lam, int max_polls) {
  Params P;
  P.src[0] = static_cast<const uint8_t*>(src_y);
  P.src[1] = static_cast<const uint8_t*>(src_u);
  P.src[2] = static_cast<const uint8_t*>(src_v);
  P.rec[0] = static_cast<uint8_t*>(rec_y);
  P.rec[1] = static_cast<uint8_t*>(rec_u);
  P.rec[2] = static_cast<uint8_t*>(rec_v);
  P.mode = static_cast<int*>(mode);
  P.lv[0] = static_cast<int16_t*>(lv_y);
  P.lv[1] = static_cast<int16_t*>(lv_u);
  P.lv[2] = static_cast<int16_t*>(lv_v);
  P.eob = static_cast<int*>(eob);
  P.mats = static_cast<const double*>(mats);
  P.tabs = static_cast<const int*>(tabs);
  P.edge = static_cast<unsigned long long*>(edge);
  P.sync = static_cast<int*>(sync);
  P.src_pitch = src_pitch;
  P.height = height;
  P.rows = rows;
  P.cols = cols;
  P.dc_q = dc_q;
  P.ac_q = ac_q;
  P.lam = lam;
  P.max_polls = max_polls;
  P.vec = ((reinterpret_cast<uintptr_t>(src_y) |
            reinterpret_cast<uintptr_t>(src_u) |
            reinterpret_cast<uintptr_t>(src_v)) & 15) == 0 &&
          src_pitch % 32 == 0;
  return P;
}

// The resident CTAs per SM at the kernel's dynamic shared memory, once per
// device (the attribute that lets a CTA have more than 48 KB is set there)
cudaError_t prepare(int* ctas_per_sm) {
  constexpr int kMaxDevices = 64;
  static int ctas[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ctas[dev] == 0) {
    err = cudaFuncSetAttribute(kframe_wave_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kframe_wave_kernel, kThreads, kSmem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    ctas[dev] = per_sm;
  }
  *ctas_per_sm = ctas[dev];
  return cudaSuccess;
}

}  // namespace

// Encodes the rows x cols grid of 32x32 blocks in one launch of `rows`
// CTAs. The recon planes must be 16-byte aligned with a pitch of cols * n;
// edge is (rows * cols, 16) 64-bit words and sync two int32, all zeroed
// before the launch: after it, sync[1] is 0, or the block row + 1 of a
// wait that gave up after max_polls polls (the outputs are then
// incomplete). Returns cudaGetLastError() after the launch.
extern "C" int kframe_wave_launch(
    const void* src_y, const void* src_u, const void* src_v, void* rec_y,
    void* rec_u, void* rec_v, void* mode, void* lv_y, void* lv_u,
    void* lv_v, void* eob, const void* mats, const void* tabs, void* edge,
    void* sync, int src_pitch, int height, int rows, int cols, int dc_q,
    int ac_q, int lam, int max_polls, void* stream) {
  if (rows < 1 || cols < 1 || max_polls < 1 ||
      ((reinterpret_cast<uintptr_t>(rec_y) |
        reinterpret_cast<uintptr_t>(rec_u) |
        reinterpret_cast<uintptr_t>(rec_v) |
        reinterpret_cast<uintptr_t>(tabs)) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(edge) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int per_sm = 0;
  const cudaError_t err = prepare(&per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params P = make_params(src_y, src_u, src_v, rec_y, rec_u, rec_v,
                               mode, lv_y, lv_u, lv_v, eob, mats, tabs, edge,
                               sync, src_pitch, height, rows, cols, dc_q,
                               ac_q, lam, max_polls);
  kframe_wave_kernel<<<rows, kThreads, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// The kernel on the current device: *ctas_per_sm the CTAs of 256 threads
// an SM holds at once, *smem_bytes the dynamic shared memory each asks
// for. Returns the CUDA error of the query (0 if none).
extern "C" int kframe_wave_occupancy(int* ctas_per_sm, int* smem_bytes) {
  *smem_bytes = kSmem;
  return static_cast<int>(prepare(ctas_per_sm));
}
