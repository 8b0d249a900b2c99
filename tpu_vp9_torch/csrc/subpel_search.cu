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
//     32 * 32 * 255^2 < 2^31);
//   - the first minimum in oy-major order (a strict < in order), returned
//     as (dy * 8 + oy, dx * 8 + ox, sse).
// All of it is integer arithmetic, so the kernel equals the plain version
// bit for bit.
//
// What bounds it on an H100: operations. At the main path's shapes (B =
// 2040 at n = 32, r = 4, and the children's B = 2040 at n = 16, r = 8) a
// block takes 5.1e5 and 1.4e5 integer operations (the two passes' 8-tap
// sums, the 49 SSEs), 1.05e9 and 2.8e8 in all, 0.0157 and 0.0042 ms at 67
// Top/s; the bytes (its window, the source, three words out) take a
// tenth of that. The design is the simple one: one CTA of 256 threads per
// block; the window, the source, the H planes and the 16 phase planes in
// shared memory as bytes; each phase deals its pixels, or for the SSE its
// (offset, row) pairs, to the threads in a strided loop between barriers
// (so it also runs right with one thread); the 49 sums of rows, then one
// thread keeps the first minimum.

#include <cstdint>
#include <cuda_runtime.h>

#include "convolve8.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kOffs = 7;                // q3 offsets -6, -4, ..., 6 per axis
constexpr int kCands = kOffs * kOffs;   // 49, oy-major
constexpr int kPhaseStep = 4;           // the phases 0, 4, 8, 12 of 16

// The phase plane (y-phase index, x-phase index into 0, 4, 8, 12) and the
// start (0 or 1) of candidate offset index o (0 .. 6) along one axis.
__device__ __forceinline__ int cand_phase(int o) {
  const int q = 2 * (2 * o - 6);  // quarter-pel offset in sixteenths
  return (q & 15) / kPhaseStep;
}
__device__ __forceinline__ int cand_start(int o) {
  const int q = 2 * (2 * o - 6);
  return (q >> 4) + 1;
}

template <int N>
__global__ void __launch_bounds__(kThreads) subpel_search_kernel(
    const uint8_t* __restrict__ wins, const uint8_t* __restrict__ src,
    const int* __restrict__ dy, const int* __restrict__ dx,
    const int* __restrict__ filters, int* __restrict__ mv_r,
    int* __restrict__ mv_c, int* __restrict__ sse_out, int r) {
  constexpr int kL = N + 8;  // the window's side
  constexpr int kP = N + 1;  // a phase plane's side
  __shared__ uint8_t s_loc[kL * kL];
  __shared__ uint8_t s_src[N * N];
  __shared__ uint8_t s_h[4 * kL * kP];       // by x-phase
  __shared__ uint8_t s_pl[16 * kP * kP];     // by (y-phase, x-phase)
  __shared__ int s_taps[4 * conv8::kTaps];   // phases 0, 4, 8, 12
  __shared__ int s_rows[kCands * N];         // SSE of one row of a candidate
  __shared__ int s_sse[kCands];

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int b = blockIdx.x;
  const int sw = N + 2 * r + 8;
  // dy and dx lie in [-r, r] by contract; the clamp only keeps the reads
  // inside the block's window
  const int y0 = min(max(dy[b], -r), r) + r;
  const int x0 = min(max(dx[b], -r), r) + r;
  const uint8_t* win =
      wins + static_cast<int64_t>(b) * sw * sw + y0 * sw + x0;

  // 1. the window, the source and the taps
  for (int i = tid; i < kL * kL; i += nthr) {
    s_loc[i] = win[(i / kL) * sw + i % kL];
  }
  for (int i = tid; i < N * N; i += nthr) {
    s_src[i] = src[static_cast<int64_t>(b) * N * N + i];
  }
  for (int i = tid; i < 4 * conv8::kTaps; i += nthr) {
    s_taps[i] = filters[(i / conv8::kTaps) * kPhaseStep * conv8::kTaps +
                        i % conv8::kTaps];
  }
  __syncthreads();

  // 2. the H pass: (n+8) x (n+1) outputs at each x-phase
  for (int i = tid; i < 4 * kL * kP; i += nthr) {
    const int px = i / (kL * kP), q = i % (kL * kP);
    s_h[i] = conv8::tap8(s_loc + (q / kP) * kL + q % kP, 1,
                         s_taps + px * conv8::kTaps);
  }
  __syncthreads();

  // 3. the V pass: (n+1)^2 outputs of each x-phase's H plane at each
  // y-phase
  for (int i = tid; i < 16 * kP * kP; i += nthr) {
    const int pl = i / (kP * kP), q = i % (kP * kP);
    const int py = pl / 4, px = pl % 4;
    s_pl[i] = conv8::tap8(s_h + px * kL * kP + (q / kP) * kP + q % kP, kP,
                          s_taps + py * conv8::kTaps);
  }
  __syncthreads();

  // 4. the SSE of every candidate, a row at a time
  for (int t = tid; t < kCands * N; t += nthr) {
    const int k = t / N, y = t % N;
    const int iy = k / kOffs, ix = k % kOffs;
    const uint8_t* row = s_pl +
                         (cand_phase(iy) * 4 + cand_phase(ix)) * kP * kP +
                         (cand_start(iy) + y) * kP + cand_start(ix);
    const uint8_t* s = s_src + y * N;
    int acc = 0;
#pragma unroll 8
    for (int x = 0; x < N; ++x) {
      const int d = static_cast<int>(row[x]) - static_cast<int>(s[x]);
      acc += d * d;
    }
    s_rows[t] = acc;
  }
  __syncthreads();
  for (int k = tid; k < kCands; k += nthr) {
    int acc = 0;
    for (int y = 0; y < N; ++y) acc += s_rows[k * N + y];
    s_sse[k] = acc;
  }
  __syncthreads();

  // 5. the first minimum in oy-major order
  if (tid == 0) {
    int best = 0;
    for (int k = 1; k < kCands; ++k) {
      if (s_sse[k] < s_sse[best]) best = k;
    }
    mv_r[b] = dy[b] * 8 + 2 * (best / kOffs) - 6;
    mv_c[b] = dx[b] * 8 + 2 * (best % kOffs) - 6;
    sse_out[b] = s_sse[best];
  }
}

template <int N>
cudaError_t launch(const void* wins, const void* src, const void* dy,
                   const void* dx, const void* filters, void* mv_r,
                   void* mv_c, void* sse, int nblk, int r,
                   cudaStream_t stream) {
  subpel_search_kernel<N><<<nblk, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(wins), static_cast<const uint8_t*>(src),
      static_cast<const int*>(dy), static_cast<const int*>(dx),
      static_cast<const int*>(filters), static_cast<int*>(mv_r),
      static_cast<int*>(mv_c), static_cast<int*>(sse), r);
  return cudaGetLastError();
}

}  // namespace

// nblk blocks of n x n (n = 16 or 32): wins (nblk, n+2r+8, n+2r+8)
// uint8, src (nblk, n, n) uint8, dy and dx (nblk,) int32 in [-r, r],
// filters the (16, 8) int32 EIGHTTAP table; mv_r, mv_c and sse (nblk,)
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
