// Open-loop intra mode decision of every 32x32 block of a source plane:
// the keyframe mode hints of the host route at enc_mode 8 and 9.
//
// Replaces the XLA stage tpu_vp9/pipeline/tpu_intra.py:decide_modes_openloop
// (openloop_refs, ops/intra.py's predict_all_modes, the SSE and the
// argmin). For block (r, c) of an (H, W) uint8 plane, H and W multiples of
// 32:
//   - the reference vector [left 32, above-left, above 32, above-right 32]
//     from the *source* plane (open loop): the row above the block (127
//     above the frame), the column left of it (129 left of the frame), the
//     corner (127 without a row above, else 129 without a column to the
//     left), above-right repeating above[31];
//   - the 10 predictions (DC with the edges' availability, TM, and the
//     eight directional modes of ops/intra.py's maps), their SSE against
//     the source in int32, exactly;
//   - the cost sse + bias[m] * lam (lam = qindex^2 / 64 + 1, the bias
//     intra_pred::mode_bias) and the first mode of least cost, a strict '<'
//     in mode order (the key (cost << 4) | m, whose least value is that
//     mode: a cost stays below 2^27).
// It is integer-exact: the modes, SSEs and costs equal the plain version's
// (ops/cuda_kernels.py:openloop_modes_ref) and the JAX function's bit for
// bit.
//
// The SSE by expansion. sum (s - p)^2 = sum s^2 + sum (p^2 - 2 s p) over a
// block's 1,024 pixels, and every prediction is constant on classes of
// pixels: DC on the block, V on its columns, H on its rows, and each
// directional mode on lines of slope 0, 1, 2 or 1/2, or -1, -2, -1/2.
// So sum (p^2 - 2 s p) = sum_j v_j (n_j v_j - 2 S_j) over the classes j,
// with v_j the class's filtered value, n_j its pixel count and S_j the sum
// of the source over it. A warp takes a block, a lane a row of it (two
// 16-byte loads, the left pixel beside them): the row sums R come from
// dp4a, the column sums C from a reduce-scatter of packed 16-bit pairs
// across the warp, and DC, V, H and TM (where no clamp bites: min L + min A
// - al >= 0 and max L + max A - al <= 255) are closed forms in sum s,
// sum s^2, R, C, L and A. The six diagonals are sweeps over the 32
// columns: at column k a lane adds its pixel to an accumulator that stands
// for the pixel's class, and the accumulators then move one or two lanes
// up or down (a shuffle), so that after the move each lane again holds the
// class of its next pixel; a class that leaves the warp's edge is complete
// and goes into the upper 16 bits of the register that comes in there (the
// sums stay below 2^13, so two share a register). D153 and D207 keep one
// register for even columns and one for odd, each moving every other
// column. At the end each lane folds its classes, and those D117 and D63
// completed by column 15, into v (n v - 2 S): the table made on the host by
// running the same sweep over the maps (ops/cuda_kernels.py:
// _ol_slot_tables, 16 folds a lane) gives each class's count n and its
// filter as four weights on four neighbouring bytes of the reference,
// kept with the left column reversed so that every filter's taps are
// neighbours: v is one dp4a. D63's pixels (0, 31) and (1, 31), whose word
// differs from their line's, are folded apart in lanes 0 and 1's empty
// upper halves. Where TM clamps the block takes it pixel by pixel. Every
// partial sum is exact in int32 modular arithmetic and the final SSE lies
// in [0, 1024 * 255^2].
//
// What bounds it on an H100: the rate at which an SM dispatches its integer,
// shuffle and shared-memory work, and the read of the plane, which every
// block starts with at once (one wave). Per block and lane: 32 columns of a
// byte extract and 6 adds, 154 moves of a shuffle and a predicated shift; 16
// folds of a table load, 2 shared-memory word loads, a dp4a and about 9
// integer operations; the column sums' 16 shuffles and 65 integer
// operations; 16 dp4a for the row sums; 16 warp reductions. That is about
// 650 integer operations, 186 shuffles and reductions, 32 dp4a and 51 loads
// a lane, against the first form's 2,450 warp instructions a block (7 a
// pixel and mode), and 1.1 KB of the plane read and 48 bytes written. A CTA
// of 128 threads takes four blocks with no CTA barrier, so the 3,600 blocks
// of a 2560x1440 plane are 900 CTAs, one wave at 8 CTAs per SM (64
// registers). On an H100 80GB HBM3 at 700 W (utils/ol_phases.py) such a
// block takes about 14,200 SM cycles: the loads about 30%, the row and
// column sums 20%, the sweeps 29%, the folds 20%; the table in shared
// memory, the rows staged through shared memory by whole 128-byte lines, two
// blocks a warp with the second's rows fetched ahead, and shuffles in place
// of the warp reductions were each no faster there.

#include <cstdint>
#include <cuda_runtime.h>

#include "intra_pred.cuh"

namespace {

using intra_pred::dc_of;
using intra_pred::kModes;
using intra_pred::mode_bias;
using intra_pred::warp_max;
using intra_pred::warp_min;
using intra_pred::warp_sum;

constexpr int kN = 32;
constexpr int kWarps = 4;  // blocks a CTA
constexpr int kThreads = 32 * kWarps;
// the reference vector as bytes, one per warp
constexpr int kRefLen = 3 * kN + 1;
constexpr int kRefBytes = 128;
static_assert(kRefLen <= kRefBytes, "the reference fits its slot");
constexpr int kSmem = kWarps * kRefBytes;
// the 16 folds of a lane (ops/cuda_kernels.py:OL_SLOTS and
// _ol_slot_tables, in this order): D117 and D63's classes completed by
// column 15; D45, D135, D117 and D63 (lower, upper; D63's held pixels in
// lanes 0 and 1's upper halves); D153 and D207 lower (even columns, odd);
// D153 (lanes 0-15) or D207 (16-31) upper (even, odd)
constexpr int kMid = 15;  // the column after which the first two fold

// byte k of a lane's row words, zero-extended
__device__ __forceinline__ unsigned pixel(const unsigned (&w)[8], int k) {
  return __byte_perm(w[k >> 2], 0, 0x4440 | (k & 3));
}

// an accumulator register after its move: where a completed class came
// in, it goes to the upper half and a new class starts in the lower one
__device__ __forceinline__ unsigned moved(unsigned a, int src, bool edge) {
  const unsigned m = __shfl_sync(0xffffffffu, a, src);
  return edge ? m << 16 : m;
}

// v (n v - 2 S) of one of the lane's classes, S its sum: the table gives
// the weights of four neighbouring bytes of the reference, the first
// one's place o and the count n (y = o | n << 8); v = (their weighted sum
// + 2) >> 2, one dp4a on the four bytes (two word loads and a funnel shift)
__device__ __forceinline__ int fold(const uint2* __restrict__ tabs, int slot,
                                    int lane, unsigned sum,
                                    const unsigned* ref32) {
  const uint2 t = __ldg(tabs + slot * 32 + lane);
  const int o = static_cast<int>(t.y & 255u), n = static_cast<int>(t.y >> 8);
  const unsigned four = __funnelshift_r(ref32[o >> 2], ref32[(o >> 2) + 1],
                                        8 * (o & 3));
  const int v = static_cast<int>(__dp4a(four, t.x, 2u)) >> 2;
  return v * (n * v - 2 * static_cast<int>(sum));
}

__global__ void __launch_bounds__(kThreads, 8)
openloop_modes_kernel(const uint8_t* __restrict__ plane, int pitch, int rows,
                      int cols, int lam, const uint2* __restrict__ tabs,
                      int* __restrict__ modes, int* __restrict__ sse,
                      int* __restrict__ best) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= rows * cols) return;
  // the reference vector with the left column reversed (L31 .. L0, al,
  // above, above-right), so that each filter's taps are neighbours
  uint8_t* ref = smem + warp * kRefBytes;
  const unsigned* ref32 = reinterpret_cast<const unsigned*>(ref);
  const int r = b / cols, c = b - (b / cols) * cols;
  const bool ha = r > 0, hl = c > 0;
  const uint8_t* blk =
      plane + static_cast<int64_t>(r) * kN * pitch + c * kN;
  const uint8_t* row = blk + static_cast<int64_t>(lane) * pitch;

  // 1. the lane's row (two 16-byte loads) and its left pixel; the pixel
  // above its column; the reference vector in shared memory
  unsigned w[8];
  {
    const uint4 lo = __ldg(reinterpret_cast<const uint4*>(row));
    const uint4 hi = __ldg(reinterpret_cast<const uint4*>(row) + 1);
    w[0] = lo.x, w[1] = lo.y, w[2] = lo.z, w[3] = lo.w;
    w[4] = hi.x, w[5] = hi.y, w[6] = hi.z, w[7] = hi.w;
  }
  const int left = hl ? row[-1] : 129;
  const int above = ha ? blk[lane - pitch] : 127;
  const int al = !ha ? 127 : (hl ? blk[-pitch - 1] : 129);
  ref[kN - 1 - lane] = static_cast<uint8_t>(left);
  ref[kN + 1 + lane] = static_cast<uint8_t>(above);
  ref[2 * kN + 1 + lane] =
      static_cast<uint8_t>(__shfl_sync(0xffffffffu, above, kN - 1));
  if (lane == 0) ref[kN] = static_cast<uint8_t>(al);
  __syncwarp();

  // 2. the row's sum and sum of squares (dp4a), the column sums (the
  // lane's column: a reduce-scatter of 16-bit pairs), the edges' sums and
  // extremes
  int rsum = 0, rsq = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    rsum = static_cast<int>(__dp4a(w[k], 0x01010101u,
                                   static_cast<unsigned>(rsum)));
    rsq = static_cast<int>(__dp4a(w[k], w[k], static_cast<unsigned>(rsq)));
  }
  int csum;
  {
    // pair j holds columns 2j (lower half) and 2j + 1 (upper half)
    unsigned pr[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      pr[2 * k] = __byte_perm(w[k], 0, 0x4140);
      pr[2 * k + 1] = __byte_perm(w[k], 0, 0x4342);
    }
    // halve the pairs held at each step: a lane keeps the upper half of
    // them where its lane bit is set, and adds its partner's copy
#pragma unroll
    for (int h = 8; h >= 1; h >>= 1) {
      const bool up = (lane & (2 * h)) != 0;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const unsigned give = up ? pr[i] : pr[i + h];
        const unsigned keep = up ? pr[i + h] : pr[i];
        pr[i] = keep + __shfl_xor_sync(0xffffffffu, give, 2 * h);
      }
    }
    // lanes 2j and 2j + 1 now hold pair j over half the rows each
    const unsigned all = pr[0] + __shfl_xor_sync(0xffffffffu, pr[0], 1);
    csum = static_cast<int>((lane & 1) ? all >> 16 : all & 0xffffu);
  }
  const int s1 = warp_sum(rsum), s2 = warp_sum(rsq);
  const int sla = warp_sum(left | above << 16);  // each below 2^13
  const int sl = sla & 0xffff, sa = sla >> 16;
  const bool tm_exact = warp_min(left) + warp_min(above) - al >= 0 &&
                        warp_max(left) + warp_max(above) - al <= 255;
  // V and H: n v^2 - 2 v S over the lane's column and row
  const int ev = above * (kN * above - 2 * csum);
  const int eh = left * (kN * left - 2 * rsum);
  __syncwarp();

  // 3. the sweeps of the six diagonals over the columns; the classes of
  // D117 and D63 completed by column kMid folded there
  const bool top = lane == kN - 1, bottom = lane == 0;
  const bool top2 = lane >= kN - 2, bottom2 = lane < 2;
  unsigned a45 = 0, a135 = 0, a117 = 0, a63 = 0;
  unsigned a153[2] = {0, 0}, a207[2] = {0, 0};
  int e117 = 0, e63 = 0;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const unsigned s = pixel(w, k);
    a45 += s;
    a135 += s;
    a117 += s;
    a63 += (k == kN - 1 && bottom2) ? 0u : s;
    a153[k & 1] += s;
    a207[k & 1] += s;
    if (k < kN - 1) {
      // the classes r + k, k - r, (r & 1, k - r / 2), (r & 1, k + r / 2)
      a45 = moved(a45, lane + 1, top);
      a135 = moved(a135, lane - 1, bottom);
      a117 = moved(a117, lane - 2, bottom2);
      a63 = moved(a63, lane + 2, top2);
    }
    if (k + 2 < kN) {
      // the classes (k & 1, r - k / 2), (k & 1, r + k / 2)
      a153[k & 1] = moved(a153[k & 1], lane - 1, bottom);
      a207[k & 1] = moved(a207[k & 1], lane + 1, top);
    }
    if (k == kMid) {
      e117 = fold(tabs, 0, lane, a117 >> 16, ref32);
      e63 = fold(tabs, 1, lane, a63 >> 16, ref32);
      a117 &= 0xffffu;
      a63 &= 0xffffu;
    }
  }
  __syncwarp();

  // 4. every class folded; the SSEs, costs and the first mode of least
  // cost
  if (bottom2) a63 |= pixel(w, kN - 1) << 16;  // the held pixels
  const int e45 = fold(tabs, 2, lane, a45 & 0xffffu, ref32) +
                  fold(tabs, 3, lane, a45 >> 16, ref32);
  const int e135 = fold(tabs, 4, lane, a135 & 0xffffu, ref32) +
                   fold(tabs, 5, lane, a135 >> 16, ref32);
  e117 += fold(tabs, 6, lane, a117 & 0xffffu, ref32) +
          fold(tabs, 7, lane, a117 >> 16, ref32);
  e63 += fold(tabs, 8, lane, a63 & 0xffffu, ref32) +
         fold(tabs, 9, lane, a63 >> 16, ref32);
  int e153 = 0, e207 = 0;
  const bool low = lane < kN / 2;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    e153 += fold(tabs, 10 + q, lane, a153[q] & 0xffffu, ref32);
    e207 += fold(tabs, 12 + q, lane, a207[q] & 0xffffu, ref32);
    const int up = fold(tabs, 14 + q, lane,
                        (low ? a153[q] : a207[q]) >> 16, ref32);
    e153 += low ? up : 0;
    e207 += low ? 0 : up;
  }
  const int dc = dc_of((hl ? sl : 0) + (ha ? sa : 0), ha, hl, 5);
  const int sv = s2 + warp_sum(ev), sh = s2 + warp_sum(eh);
  int stm;
  if (tm_exact) {
    stm = sv + sh - s2 + 2 * sl * sa - 2 * kN * al * (sl + sa) +
          kN * kN * al * al + 2 * al * s1;
  } else {
    const int base = left - al;
    int acc = 0;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      int p = base + ref[kN + 1 + k];
      p = p < 0 ? 0 : (p > 255 ? 255 : p);
      const int d = static_cast<int>(pixel(w, k)) - p;
      acc += d * d;
    }
    stm = warp_sum(acc);
  }
  // lane m takes mode m's SSE (IntraMode order)
  int mine = s2 - 2 * dc * s1 + kN * kN * dc * dc;
  {
    const int e[6] = {e45, e135, e117, e153, e207, e63};
    if (lane == 1) mine = sv;
    if (lane == 2) mine = sh;
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      const int t = s2 + warp_sum(e[m]);
      if (lane == 3 + m) mine = t;
    }
    if (lane == kModes - 1) mine = stm;
  }
  int key = 0x7fffffff;
  if (lane < kModes) {
    key = ((mine + mode_bias(lane) * lam) << 4) | lane;
    sse[static_cast<int64_t>(b) * kModes + lane] = mine;
  }
  const int least = warp_min(key);
  if (lane == 0) {
    modes[b] = least & 15;
    best[b] = least >> 4;
  }
}

}  // namespace

// plane: (rows * 32, cols * 32) uint8 with row pitch `pitch` bytes, 16-byte
// aligned, pitch a multiple of 16; tabs: ops/cuda_kernels.py:
// _ol_tables_on's words (OL_SLOTS x 32 pairs of taps and count), 8-byte
// aligned; modes, best: (rows * cols,) int32; sse: (rows * cols, 10)
// int32. The caller has checked rows, cols >= 1 and 0 <= lam < 2^20.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int openloop_modes_launch(const void* plane, const void* tabs,
                                     void* modes, void* sse, void* best,
                                     int pitch, int rows, int cols, int lam,
                                     void* stream) {
  if (rows < 1 || cols < 1 || pitch < cols * kN || pitch % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(plane) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(tabs) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (rows * cols + kWarps - 1) / kWarps;
  openloop_modes_kernel<<<grid, kThreads, kSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(plane), pitch, rows, cols, lam,
      static_cast<const uint2*>(tabs), static_cast<int*>(modes),
      static_cast<int*>(sse), static_cast<int*>(best));
  return static_cast<int>(cudaGetLastError());
}

// The kernel on the current device: *ctas_per_sm the CTAs of 128 threads
// (four blocks) an SM holds at once, *smem_bytes the dynamic shared memory
// each asks for. Returns the CUDA error of the query (0 if none).
extern "C" int openloop_modes_occupancy(int* ctas_per_sm, int* smem_bytes) {
  *smem_bytes = kSmem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, openloop_modes_kernel, kThreads, kSmem));
}
