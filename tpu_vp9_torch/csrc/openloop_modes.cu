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
//   - the 10 predictions (intra_pred.cuh: DC with the edges' availability,
//     TM, and the eight directional modes from their packed words), their
//     SSE against the source in int32, exactly;
//   - the cost sse + bias[m] * lam (lam = qindex^2 / 64 + 1, the bias
//     intra_pred::mode_bias) and the first mode of least cost, a strict '<'
//     in mode order (the key (cost << 4) | m, whose least value is that
//     mode: a cost stays below 2^27).
// It is integer-exact: the modes, SSEs and costs equal the plain version's
// (ops/cuda_kernels.py:openloop_modes_ref) and the JAX function's bit for
// bit.
//
// What bounds it on an H100: integer work, about 8e4 operations a block
// (10 predictions, differences, squares and sums of 1,024 pixels) against
// about 1.1 KB of the plane read and 48 bytes written; at 2560x1440 (3,600
// blocks) that is some 2.9e8 operations, a few microseconds at the card's
// integer rate, and the launch itself costs about as much. The design is
// the simple one: a CTA of 256 threads per block, four pixels a thread
// held in registers; the reference vector, each directional mode's
// distinct words filtered once (768 bytes, the keyframe kernel's lists,
// ops/cuda_kernels.py:_kf_tables_on) and the warps' partial SSEs in shared
// memory; each pixel's index into its mode's list read through the read-only
// cache; the 10 SSEs warp sums (redux.sync), added across warps by warp 0,
// which takes the minimum.

#include <cstdint>
#include <cuda_runtime.h>

#include "intra_pred.cuh"

namespace {

using intra_pred::dc_of;
using intra_pred::filt;
using intra_pred::kModes;
using intra_pred::mode_bias;
using intra_pred::tm_pred;
using intra_pred::warp_min;
using intra_pred::warp_sum;

constexpr int kN = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRefLen = 3 * kN + 1;
// the constant words (ops/cuda_kernels.py:_kf_tables_on): the 8
// directional modes' distinct packed words at 32, kU32 a mode, first;
// each pixel's index bytes into its mode's list (8 a pixel) from
// kTabIdx32 on, after the lists of 16
constexpr int kU32 = 96, kU16 = 48;
constexpr int kTabIdx32 = 8 * kU32 + 8 * kU16;
static_assert(8 * kU32 == 3 * kThreads, "three words a thread");

// dynamic shared memory, in bytes
constexpr int kOffRef = 0;                         // int[kRefLen], padded
constexpr int kOffSse = kOffRef + 100 * 4;         // int[kWarps][kModes]
constexpr int kOffDc = kOffSse + kWarps * kModes * 4;  // int[4]
constexpr int kOffVal = kOffDc + 4 * 4;            // uint8[8 * kU32]
constexpr int kSmem = kOffVal + 8 * kU32;

__global__ void __launch_bounds__(kThreads)
openloop_modes_kernel(const uint8_t* __restrict__ plane, int pitch, int cols,
                      int lam, const int* __restrict__ tabs,
                      int* __restrict__ modes, int* __restrict__ sse,
                      int* __restrict__ best) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_ref = reinterpret_cast<int*>(smem + kOffRef);
  int* s_sse = reinterpret_cast<int*>(smem + kOffSse);
  int* s_dc = reinterpret_cast<int*>(smem + kOffDc);
  uint8_t* s_val = smem + kOffVal;

  const int b = blockIdx.x;
  const int r = b / cols, c = b - (b / cols) * cols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool ha = r > 0, hl = c > 0;
  const uint8_t* blk =
      plane + static_cast<int64_t>(r) * kN * pitch + c * kN;

  // 1. the reference vector, and the thread's four source pixels
  if (tid < kRefLen) {
    int v;
    if (tid < kN) {
      v = hl ? blk[static_cast<int64_t>(tid) * pitch - 1] : 129;
    } else if (tid == kN) {
      v = !ha ? 127 : (hl ? blk[-pitch - 1] : 129);
    } else {
      const int x = tid - kN - 1 < kN ? tid - kN - 1 : kN - 1;
      v = ha ? blk[x - pitch] : 127;
    }
    s_ref[tid] = v;
  }
  int src[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = tid + kThreads * k;
    src[k] = blk[static_cast<int64_t>(i >> 5) * pitch + (i & 31)];
  }
  __syncthreads();

  // 2. DC on warp 0; each directional mode's distinct words filtered
  if (warp == 0) {
    const int sum = warp_sum((hl ? s_ref[lane] : 0) +
                             (ha ? s_ref[kN + 1 + lane] : 0));
    if (lane == 0) s_dc[0] = dc_of(sum, ha, hl, 5);
  }
  {
    int val[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      val[k] = filt(static_cast<unsigned>(__ldg(tabs + tid + kThreads * k)),
                    s_ref);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s_val[tid + kThreads * k] = static_cast<uint8_t>(val[k]);
    }
  }
  __syncthreads();

  // 3. the 10 predictions of the thread's pixels and their SSE, summed
  // over the warp
  {
    const int dc = s_dc[0];
    const uint2* idx = reinterpret_cast<const uint2*>(tabs + kTabIdx32);
    int acc[kModes];
#pragma unroll
    for (int m = 0; m < kModes; ++m) acc[m] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = tid + kThreads * k, y = i >> 5, x = i & 31;
      const uint2 ix = __ldg(idx + i);
#pragma unroll
      for (int m = 0; m < kModes; ++m) {
        int p;
        if (m == 0) {
          p = dc;
        } else if (m == kModes - 1) {
          p = tm_pred(s_ref, kN, y, x);
        } else {
          const unsigned w = m <= 4 ? ix.x : ix.y;
          p = s_val[(m - 1) * kU32 + ((w >> (8 * ((m - 1) & 3))) & 255)];
        }
        const int e = src[k] - p;
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

  // 4. warp 0: each mode's SSE and cost, the first mode of least cost
  if (warp == 0) {
    int total = 0, key = 0x7fffffff;
    if (lane < kModes) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total += s_sse[w * kModes + lane];
      key = ((total + mode_bias(lane) * lam) << 4) | lane;
      sse[static_cast<int64_t>(b) * kModes + lane] = total;
    }
    const int least = warp_min(key);
    if (lane == 0) {
      modes[b] = least & 15;
      best[b] = least >> 4;
    }
  }
}

}  // namespace

// plane: (rows * 32, cols * 32) uint8 with row pitch `pitch` bytes; tabs:
// ops/cuda_kernels.py:_kf_tables_on's int32 words, 8-byte aligned; modes,
// best: (rows * cols,) int32; sse: (rows * cols, 10) int32. The caller has
// checked rows, cols >= 1 and 0 <= lam < 2^20. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int openloop_modes_launch(const void* plane, const void* tabs,
                                     void* modes, void* sse, void* best,
                                     int pitch, int rows, int cols, int lam,
                                     void* stream) {
  if (rows < 1 || cols < 1 || pitch < cols * kN ||
      (reinterpret_cast<uintptr_t>(tabs) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  openloop_modes_kernel<<<rows * cols, kThreads, kSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(plane), pitch, cols, lam,
      static_cast<const int*>(tabs), static_cast<int*>(modes),
      static_cast<int*>(sse), static_cast<int*>(best));
  return static_cast<int>(cudaGetLastError());
}

// The kernel on the current device: *ctas_per_sm the CTAs of 256 threads
// an SM holds at once, *smem_bytes the dynamic shared memory each asks
// for. Returns the CUDA error of the query (0 if none).
extern "C" int openloop_modes_occupancy(int* ctas_per_sm, int* smem_bytes) {
  *smem_bytes = kSmem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, openloop_modes_kernel, kThreads, kSmem));
}
