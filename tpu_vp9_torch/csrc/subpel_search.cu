// The realtime P-frame step's quarter-pel search: for every block, the 16
// phase planes of its (n+8)^2 window around the full-pel winner and the
// SSE against the source at the 7 x 7 quarter-pel offsets in +-6/8 pel.
//
// Replaces the XLA stage tpu_vp9/pipeline/tpu_encdec.py:_subpel_exhaustive
// (:510); its contract is the plain version beside the step,
// tpu_vp9_torch/pipeline/tpu_encdec.py:subpel_search_ref. Per block b:
//   - the window loc = wins[b, dy+r : dy+r+n+8, dx+r : dx+r+n+8];
//   - the H pass at the x-phases 0, 4, 8, 12: (n+8) x (n+1) pixels each,
//     then the V pass at the four y-phases over each: 16 planes of
//     (n+1)^2, every output clamp((acc + 64) >> 7, 0, 255) (convolve8.cuh,
//     the taps of the EIGHTTAP table uploaded by the wrapper);
//   - the SSE of offset (oy, ox), oy and ox in -6, -4, ..., 6 (q3 units),
//     against the plane of phase (qy & 15, qx & 15) at (qy >> 4) + 1,
//     (qx >> 4) + 1, qy = 2 oy and qx = 2 ox, in int32 (at n = 32 at most
//     32 * 32 * 255^2 < 2^26);
//   - the first minimum in oy-major order, returned as (dy * 8 + oy,
//     dx * 8 + ox, sse).
// All of it is integer arithmetic, so the kernel equals the plain version
// bit for bit.
//
// What bounds it on an H100: operations (the yardstick, chip_smoke.py's
// _sp_bound, counts 5.1e5 integer operations a block at n = 32 and 1.4e5
// at n = 16: 0.0157 and 0.0042 ms for the path's 2040 blocks of each at
// 67 Top/s; the bytes take a tenth of that). Written plainly, the work is
// shared-memory traffic instead: an 8-tap output reads eight taps and
// eight pixels, a quarter of the H and V outputs are phase 0's copies, and
// 16 planes and 49 x n row sums would pass through shared memory to a
// serial minimum. This design, per block:
//   - the window, the source (transposed: a word holds four rows of a
//     column) and the packed taps of the phases 4, 8 and 12 in shared
//     memory; every thread keeps the taps in six registers;
//   - the H pass: a thread takes a column and four rows, reads each row's
//     eight pixels as two words (aligned loads and funnel shifts), and
//     writes the three filtered phases and the copy of phase 0 transposed,
//     four rows to a word;
//   - the V pass fused with the SSEs: a thread of x-phase px takes a
//     column x and source rows 4g..4g+3. It reads its H column's words
//     g..g+2 (rows 4g..4g+11), makes plane rows 4g..4g+4 at each y-phase
//     but 0 (two dp4a an output; y-phase 0 is H rows 4g+4..4g+7, the word
//     g+1), packs them as rows 4g..4g+3 (start 0) and 4g+1..4g+4 (start
//     1), and adds the squared byte differences (vabsdiff, then dp4a of
//     the difference with itself) against the source columns x (start 0)
//     and x-1 (start 1) into 16 registers: y-phase, y start, x start. No
//     plane and no row sum goes through shared memory;
//   - the lanes of an x-phase sum their 16 registers in a reduce-scatter
//     of shuffles (the candidates of an x-phase are its own, so no sum is
//     shared between phases), and one warp keeps the first minimum: the
//     least of the keys (sse << 6) | k, which is exact and breaks ties to
//     the lowest k (oy-major order).
// A CTA is 128 threads: one block at n = 32 (a warp per x-phase), four at
// n = 16 (a warp per block, eight lanes per x-phase); the last CTA of a B
// that is not a multiple of four has idle warps.

#include <cstdint>
#include <cuda_runtime.h>

#include "convolve8.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kOffs = 7;                // q3 offsets -6, -4, ..., 6 per axis
constexpr int kCands = kOffs * kOffs;   // 49, oy-major
constexpr int kSums = 16;               // a thread's sums: py, sy, sx
constexpr unsigned kFull = 0xffffffffu;

template <int N>
struct Shape {
  static constexpr int kL = N + 8;              // the window's side
  static constexpr int kP = N + 1;              // a phase plane's side
  static constexpr int kPer = N == 32 ? 1 : 4;  // blocks per CTA
  static constexpr int kTb = kThreads / kPer;   // threads per block
  static constexpr int kG = kTb / 4;            // lanes per x-phase
  static constexpr int kRowW = kL / 4;          // words of a window row
  static constexpr int kHw = kL / 4;            // words of an H column
  static constexpr int kHp = kHw + 1;           // its pitch, odd
  static constexpr int kSw = N / 4;             // words of a source column
  static constexpr int kSp = kSw + 1;           // its pitch, odd
  // a block's words: the window and one word past its last row (read, not
  // used, by the H pass at x = n), the H columns of the four x-phases, the
  // source's columns, the 49 sums
  static constexpr int kWinW = kL * kRowW + 1;
  static constexpr int kHtW = 4 * kP * kHp;
  static constexpr int kSrcW = N * kSp;
  static constexpr int kBlkW = kWinW + kHtW + kSrcW + kCands;
  static constexpr int kTapW = 8;               // 6 packed tap words
  static constexpr int kSmem = 4 * (kTapW + kPer * kBlkW);
  // the minimum's key (sse << 6) | k needs sse < 2^26
  static_assert(static_cast<long long>(N) * N * 255 * 255 < (1LL << 26),
                "the SSE does not fit the key");
  static_assert(kL % 4 == 0 && N % 4 == 0 && kG % 8 == 0, "layout");
};

// Sums each of v[0..M) over the G lanes of an aligned group of a warp
// (reduce-scatter): at the end v[0..max(M / G, 1)) hold the sums
// first..first+max(M / G, 1)-1, where first is the return value (if G > M,
// lanes that differ only in their low bits hold the same sum).
template <int G, int M>
__device__ __forceinline__ int group_sums(int (&v)[kSums], int lane) {
  if constexpr (G == 1) {
    return 0;
  } else if constexpr (M == 1) {
#pragma unroll
    for (int d = G / 2; d >= 1; d /= 2) {
      v[0] += __shfl_xor_sync(kFull, v[0], d);
    }
    return 0;
  } else {
    constexpr int kD = G / 2, kH = M / 2;
    const bool up = (lane & kD) != 0;
#pragma unroll
    for (int i = 0; i < kH; ++i) {
      const int send = up ? v[i] : v[i + kH];
      const int keep = up ? v[i + kH] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, kD);
    }
    return (up ? kH : 0) + group_sums<kD, kH>(v, lane);
  }
}

// acc += the sum of the squared differences of the four byte pairs of a
// and b whose bytes of mask are set (mask is all ones or zero).
__device__ __forceinline__ void add_sse(int& acc, uint32_t a, uint32_t b,
                                        uint32_t mask) {
  const uint32_t d = __vabsdiffu4(a, b) & mask;
  acc = static_cast<int>(conv8::dp4a_uu(d, d, static_cast<uint32_t>(acc)));
}

template <int N>
__global__ void __launch_bounds__(kThreads) subpel_search_kernel(
    const uint8_t* __restrict__ wins, const uint8_t* __restrict__ src,
    const int* __restrict__ dy, const int* __restrict__ dx,
    const int* __restrict__ filters, int* __restrict__ mv_r,
    int* __restrict__ mv_c, int* __restrict__ sse_out, int nblk, int r) {
  using S = Shape<N>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_taps = reinterpret_cast<uint32_t*>(smem);
  const int tid = threadIdx.x;
  const int slot = tid / S::kTb;  // the CTA's block this thread works on
  const int t = tid % S::kTb;
  const int b = blockIdx.x * S::kPer + slot;
  const bool live = b < nblk;  // uniform over each warp
  uint32_t* s_win = s_taps + S::kTapW + slot * S::kBlkW;
  uint32_t* s_ht = s_win + S::kWinW;
  uint32_t* s_src = s_ht + S::kHtW;
  int* s_sse = reinterpret_cast<int*>(s_src + S::kSrcW);

  // 1. the packed taps of the phases 4, 8, 12; the window; the source,
  // transposed (byte y of column x at x * 4 kSp + y)
  if (tid < 3) {
    conv8::pack_taps(filters + (tid + 1) * 4 * conv8::kTaps,
                     s_taps[2 * tid], s_taps[2 * tid + 1]);
  }
  if (live) {
    const int sw = N + 2 * r + 8;
    // dy and dx lie in [-r, r] by contract; the clamp only keeps the reads
    // inside the block's window
    const int y0 = min(max(dy[b], -r), r) + r;
    const int x0 = min(max(dx[b], -r), r) + r;
    const uint8_t* win =
        wins + static_cast<int64_t>(b) * sw * sw + y0 * sw + x0;
    uint8_t* w8 = reinterpret_cast<uint8_t*>(s_win);
    for (int i = t; i < S::kL * S::kL; i += S::kTb) {
      w8[i] = win[(i / S::kL) * sw + i % S::kL];
    }
    const uint8_t* sb = src + static_cast<int64_t>(b) * N * N;
    uint8_t* s8 = reinterpret_cast<uint8_t*>(s_src);
    for (int i = t; i < N * N; i += S::kTb) {
      s8[(i % N) * 4 * S::kSp + i / N] = sb[i];
    }
  }
  __syncthreads();

  uint32_t t_lo[3], t_hi[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    t_lo[p] = s_taps[2 * p];
    t_hi[p] = s_taps[2 * p + 1];
  }

  // 2. the H pass: column x, rows 4g..4g+3 of the four x-phases, each
  // stored as one word of the transposed H planes
  if (live) {
    for (int i = t; i < S::kP * S::kHw; i += S::kTb) {
      const int x = i % S::kP, g = i / S::kP;
      const uint32_t* w = s_win + 4 * g * S::kRowW + x / 4;
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t* row = w + k * S::kRowW;
        conv8::bytes8(row[0], row[1], row[2], x & 3, lo[k], hi[k]);
      }
      uint32_t* col = s_ht + x * S::kHp + g;
      // x-phase 0 is the window's pixel under tap 3
      col[0] = conv8::pack4(lo[0] >> 24, lo[1] >> 24, lo[2] >> 24,
                            lo[3] >> 24);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        col[(p + 1) * S::kP * S::kHp] = conv8::pack4(
            conv8::tap8_packed(lo[0], hi[0], t_lo[p], t_hi[p]),
            conv8::tap8_packed(lo[1], hi[1], t_lo[p], t_hi[p]),
            conv8::tap8_packed(lo[2], hi[2], t_lo[p], t_hi[p]),
            conv8::tap8_packed(lo[3], hi[3], t_lo[p], t_hi[p]));
      }
    }
  }
  __syncthreads();

  // 3. the V pass and the SSEs: sums[4 py + 2 sy + sx], py the y-phase
  // index (0, 4, 8, 12), sy and sx the plane starts
  const int px = t / S::kG;  // the x-phase index of this thread's lanes
  const int lane = t % S::kG;
  int sums[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) sums[i] = 0;
  if (live) {
    const uint32_t* ht = s_ht + px * S::kP * S::kHp;
    for (int j = lane; j < S::kP * S::kSw; j += S::kG) {
      const int x = j % S::kP, g = j / S::kP;
      const uint32_t* col = ht + x * S::kHp + g;
      const uint32_t h0 = col[0], h1 = col[1], h2 = col[2];
      // the source's rows 4g..4g+3 in its columns x (against a plane start
      // of 0) and x - 1 (start 1), where they exist
      const uint32_t s0 = s_src[min(x, N - 1) * S::kSp + g];
      const uint32_t s1 = s_src[max(x - 1, 0) * S::kSp + g];
      const uint32_t m0 = x < N ? kFull : 0u;
      const uint32_t m1 = x > 0 ? kFull : 0u;
      // y-phase 0 (start 1 only): plane rows 4g+1..4g+4 are H rows
      // 4g+4..4g+7
      add_sse(sums[2], h1, s0, m0);
      add_sse(sums[3], h1, s1, m1);
      // H rows 4g+k..4g+k+7 for the plane rows 4g+k, k = 0..4
      uint32_t lo[5], hi[5];
      lo[0] = h0;
      hi[0] = h1;
#pragma unroll
      for (int k = 1; k < 4; ++k) conv8::bytes8(h0, h1, h2, k, lo[k], hi[k]);
      lo[4] = h1;
      hi[4] = h2;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        int o[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          o[k] = conv8::tap8_packed(lo[k], hi[k], t_lo[p], t_hi[p]);
        }
        const uint32_t p0 = conv8::pack4(o[0], o[1], o[2], o[3]);
        const uint32_t p1 = __byte_perm(p0, o[4], 0x4321);
        add_sse(sums[4 * p + 4], p0, s0, m0);
        add_sse(sums[4 * p + 5], p0, s1, m1);
        add_sse(sums[4 * p + 6], p1, s0, m0);
        add_sse(sums[4 * p + 7], p1, s1, m1);
      }
    }
    // 4. each x-phase's sums over its lanes, and the 14 (7 at x-phase 0)
    // that are candidates: y-phase 0 and x-phase 0 have start 1 only
    constexpr int kHeld = kSums / S::kG > 0 ? kSums / S::kG : 1;
    const int first = group_sums<S::kG, kSums>(sums, lane);
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int idx = first + i;
      const int py = idx >> 2, sy = (idx >> 1) & 1, sx = idx & 1;
      if ((py != 0 || sy) && (px != 0 || sx)) {
        const int iy = sy ? py + 3 : py - 1;
        const int ix = sx ? px + 3 : px - 1;
        s_sse[iy * kOffs + ix] = sums[i];
      }
    }
  }
  __syncthreads();

  // 5. the first minimum in oy-major order, by the block's first warp
  if (live && t < 32) {
    uint32_t key = ~0u;
    for (int k = t; k < kCands; k += 32) {
      key = min(key, (static_cast<uint32_t>(s_sse[k]) << 6) |
                         static_cast<uint32_t>(k));
    }
#pragma unroll
    for (int d = 16; d >= 1; d /= 2) {
      key = min(key, __shfl_xor_sync(kFull, key, d));
    }
    if (t == 0) {
      const int best = static_cast<int>(key & 63u);
      mv_r[b] = dy[b] * 8 + 2 * (best / kOffs) - 6;
      mv_c[b] = dx[b] * 8 + 2 * (best % kOffs) - 6;
      sse_out[b] = static_cast<int>(key >> 6);
    }
  }
}

template <int N>
cudaError_t launch(const void* wins, const void* src, const void* dy,
                   const void* dx, const void* filters, void* mv_r,
                   void* mv_c, void* sse, int nblk, int r,
                   cudaStream_t stream) {
  using S = Shape<N>;
  const int grid = (nblk + S::kPer - 1) / S::kPer;
  subpel_search_kernel<N><<<grid, kThreads, S::kSmem, stream>>>(
      static_cast<const uint8_t*>(wins), static_cast<const uint8_t*>(src),
      static_cast<const int*>(dy), static_cast<const int*>(dx),
      static_cast<const int*>(filters), static_cast<int*>(mv_r),
      static_cast<int*>(mv_c), static_cast<int*>(sse), nblk, r);
  return cudaGetLastError();
}

template <int N>
int occupancy(int* ctas_per_sm, int* smem_bytes) {
  *smem_bytes = Shape<N>::kSmem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, subpel_search_kernel<N>, kThreads, Shape<N>::kSmem));
}

}  // namespace

// nblk blocks of n x n (n = 16 or 32): wins (nblk, n+2r+8, n+2r+8)
// uint8, src (nblk, n, n) uint8, dy and dx (nblk,) int32 in [-r, r],
// filters the (16, 8) int32 EIGHTTAP table (row 0 the identity, every tap
// of the rows 4, 8 and 12 a signed byte); mv_r, mv_c and sse (nblk,)
// int32 out. Returns cudaGetLastError() after the launch.
extern "C" int subpel_search_launch(const void* wins, const void* src,
                                    const void* dy, const void* dx,
                                    const void* filters, void* mv_r,
                                    void* mv_c, void* sse, int nblk, int n,
                                    int r, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 32:
      return static_cast<int>(launch<32>(wins, src, dy, dx, filters, mv_r,
                                         mv_c, sse, nblk, r, s));
    case 16:
      return static_cast<int>(launch<16>(wins, src, dy, dx, filters, mv_r,
                                         mv_c, sse, nblk, r, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The kernel of block size n on the current device: *ctas_per_sm the CTAs
// of 128 threads an SM holds at once, *smem_bytes the dynamic shared
// memory each asks for. Returns the CUDA error of the query (0 if none).
extern "C" int subpel_search_occupancy(int n, int* ctas_per_sm,
                                       int* smem_bytes) {
  switch (n) {
    case 32:
      return occupancy<32>(ctas_per_sm, smem_bytes);
    case 16:
      return occupancy<16>(ctas_per_sm, smem_bytes);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
