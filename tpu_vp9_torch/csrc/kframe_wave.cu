// The device keyframe's closed-loop intra encode: one anti-diagonal of the
// 32x32 grid per launch.
//
// Replaces the XLA stage tpu_vp9/pipeline/tpu_encdec.py:kframe_step (its
// lax.scan over anti-diagonals, wave_plane and the static permutation
// after it) for geometries without the 16-pixel strip. A block (r, c)
// predicts from the reconstruction of its neighbours above, to the left and
// above-left, which lie on the two diagonals before its own; blocks of one
// diagonal do not depend on each other. The wrapper
// (ops/cuda_kernels.py:kframe_wave) launches d = 0 .. rows + cols - 2 in
// stream order, so a launch reads the recon that the earlier launches
// wrote, and one CTA encodes block (r0 + blockIdx.x, d - r0 - blockIdx.x):
//   - reference samples from the recon planes, as ops/intra.py builds them:
//     127 above the frame, 129 left of it, above-right repeating
//     above[n-1], the left column clamped to the last visible row;
//   - the 10 luma predictions (DC with availability, TM, and V, H and the
//     six diagonals from ops/intra.py's index and weight maps, packed one
//     word per mode and pixel by the wrapper), their SSE in int32, the cost
//     sse + bias[m] * lam, and the first mode of least cost;
//   - luma at 32 and both chroma planes at 16 with that mode: forward DCT
//     in float64, quantizer, dequantizer, the exact integer inverse, recon
//     and eob (txfm_common.cuh), written in place into the recon planes.
// The plain version beside the wrapper (ops/cuda_kernels.py:
// kframe_wave_ref) gives the same modes, levels, eobs and recon unless a
// coefficient's |c| / q + 0.38 lies within about 1e-12 of an integer.
//
// What bounds it on an H100: the chain. At 1080p (34 x 60 blocks) the
// frame is 93 dependent launches of at most 34 CTAs, so at most a quarter of
// the SMs work and each launch's time is one block's latency: the loads of
// its reference samples, a barrier-separated pipeline of phases (mode
// costs, two float64 products, quantizer, row and column inverses), each
// short. The whole frame's work (2.4e8 float64 operations, some 5e8
// integer operations, 12 MB moved) would take the card 10-20 us; the
// design does not chase that. It is the simple form: every phase deals its
// rows, columns or pixels to the CTA's 256 threads, the 1-D inverses run a
// thread per row or column (64 of the 256 busy), and reductions go through
// warp shuffles and shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "txfm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kModes = 10;
// pixels of a block's three planes: luma 32x32, then u and v 16x16
constexpr int kPix = 1024 + 2 * 256;
// the reference vectors [left n, above-left, above and above-right 2n] of
// the three planes, one after the other
constexpr int kRefAll = 97 + 2 * 49;
// the integer work planes at an odd pitch (33, 17): a thread per row or per
// column walks them without bank conflicts
constexpr int kIntAll = 32 * 33 + 2 * 16 * 17;

// Offsets by plane (0 luma, 1 u, 2 v): the pixels of s_src, s_pred, s_t
// and s_c; the reference vectors; the integer work planes.
__device__ __forceinline__ int pix_off(int p) {
  return p == 0 ? 0 : (p == 1 ? 1024 : 1280);
}
__device__ __forceinline__ int ref_off(int p) {
  return p == 0 ? 0 : (p == 1 ? 97 : 146);
}
__device__ __forceinline__ int int_off(int p) {
  return p == 0 ? 0 : (p == 1 ? 32 * 33 : 32 * 33 + 16 * 17);
}
__device__ __forceinline__ int plane_of(int i) {
  return i < 1024 ? 0 : (i < 1280 ? 1 : 2);
}

// Offsets into the constant tables (ops/cuda_kernels.py:_kf_tables_on) by
// block size: float64 F_col and F_row^T of n = 32 and 16; int32 packed
// directional maps and inverse scans (raster place -> scan place).
__device__ __forceinline__ int mat_fcol(int n) { return n == 32 ? 0 : 2048; }
__device__ __forceinline__ int mat_frowt(int n) {
  return n == 32 ? 1024 : 2304;
}
__device__ __forceinline__ int tab_dir(int n) { return n == 32 ? 0 : 8192; }
__device__ __forceinline__ int tab_iscan(int n) {
  return n == 32 ? 10240 : 11264;
}

struct Params {
  const uint8_t* src[3];  // padded source planes
  uint8_t* rec[3];        // recon planes, (rows*32, cols*32) and halves
  int* mode;              // (rows*cols,)
  int16_t* lv[3];         // (rows*cols, n, n)
  int* eob;               // (3, rows*cols)
  const double* mats;     // forward matrices
  const int* tabs;        // packed directional maps, inverse scans
  int src_pitch;          // luma; chroma is half
  int height;             // visible luma height
  int rows, cols;
  int d, r0;
  int dc_q, ac_q, lam;
};

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Entry k of plane p's reference vector for block (r, c).
__device__ int ref_sample(const Params& P, int p, int r, int c, int k) {
  const int n = p == 0 ? 32 : 16;
  const int pitch = P.cols * n;
  const int vis = p == 0 ? P.height : (P.height + 1) >> 1;
  const uint8_t* rec = P.rec[p];
  const bool ha = r >= 1, hl = c >= 1;
  if (k < n) {  // left, clamped to the last visible row
    if (!hl) return 129;
    const int last = max(vis - 1 - n * r, 0);
    return rec[(r * n + min(k, last)) * pitch + c * n - 1];
  }
  if (k == n) {  // above-left
    if (!ha) return 127;
    return hl ? rec[(r * n - 1) * pitch + c * n - 1] : 129;
  }
  if (!ha) return 127;  // above; above-right repeats above[n-1]
  return rec[(r * n - 1) * pitch + c * n + min(k - n - 1, n - 1)];
}

// Mode m's prediction of pixel (y, x) of an n x n block.
__device__ __forceinline__ int predict(int m, const int* ref, int n, int y,
                                       int x, int dc, const int* dir) {
  if (m == 0) return dc;
  if (m == kModes - 1) {
    const int v = ref[y] + ref[n + 1 + x] - ref[n];
    return v < 0 ? 0 : (v > 255 ? 255 : v);
  }
  const unsigned w = static_cast<unsigned>(dir[(m - 1) * n * n + y * n + x]);
  const int sum = static_cast<int>((w >> 21) & 7) * ref[w & 127] +
                  static_cast<int>((w >> 24) & 7) * ref[(w >> 7) & 127] +
                  static_cast<int>((w >> 27) & 7) * ref[(w >> 14) & 127];
  return (sum + 2) >> 2;
}

__global__ void __launch_bounds__(kThreads)
    kframe_wave_kernel(const __grid_constant__ Params P) {
  __shared__ uint8_t s_src[kPix];
  __shared__ uint8_t s_pred[kPix];
  __shared__ int s_ref[kRefAll];
  __shared__ int s_int[kIntAll];    // residual, then dequantized, inverse
  __shared__ double s_t[kPix];      // F_col @ R
  __shared__ double s_c[kPix];      // coefficients
  __shared__ int s_sse[kWarps][kModes];
  __shared__ int s_dc[3];
  __shared__ int s_eob[3];
  __shared__ int s_mode;

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int r = P.r0 + blockIdx.x;
  const int c = P.d - r;
  const int bi = r * P.cols + c;

  // 1. the source block and the reference vectors
  for (int i = tid; i < kPix; i += nthr) {
    const int p = plane_of(i), n = p == 0 ? 32 : 16;
    const int q = i - pix_off(p), y = q / n, x = q % n;
    const int pitch = p == 0 ? P.src_pitch : P.src_pitch >> 1;
    s_src[i] = P.src[p][(r * n + y) * pitch + c * n + x];
  }
  for (int i = tid; i < kRefAll; i += nthr) {
    const int p = i < ref_off(1) ? 0 : (i < ref_off(2) ? 1 : 2);
    s_ref[i] = ref_sample(P, p, r, c, i - ref_off(p));
  }
  for (int p = tid; p < 3; p += nthr) s_eob[p] = 0;
  __syncthreads();

  // 2. DC of each plane, with availability
  for (int p = tid; p < 3; p += nthr) {
    const int n = p == 0 ? 32 : 16, lg = p == 0 ? 5 : 4;
    const int* ref = s_ref + ref_off(p);
    int sum_l = 0, sum_a = 0;
    for (int k = 0; k < n; ++k) {
      sum_l += ref[k];
      sum_a += ref[n + 1 + k];
    }
    const bool ha = r >= 1, hl = c >= 1;
    s_dc[p] = ha && hl ? (sum_a + sum_l + n) >> (lg + 1)
              : ha     ? (sum_a + (n >> 1)) >> lg
              : hl     ? (sum_l + (n >> 1)) >> lg
                       : 128;
  }
  __syncthreads();

  // 3. the luma mode: SSE of every mode, then the first of least cost
  {
    int acc[kModes];
#pragma unroll
    for (int m = 0; m < kModes; ++m) acc[m] = 0;
    const int* dir32 = P.tabs + tab_dir(32);
    for (int i = tid; i < 1024; i += nthr) {
      const int y = i >> 5, x = i & 31, s = s_src[i];
#pragma unroll
      for (int m = 0; m < kModes; ++m) {
        const int e = s - predict(m, s_ref, 32, y, x, s_dc[0], dir32);
        acc[m] += e * e;
      }
    }
#pragma unroll
    for (int m = 0; m < kModes; ++m) {
      const int v = warp_sum(acc[m]);
      if (lane == 0) s_sse[warp][m] = v;
    }
  }
  __syncthreads();
  if (tid == 0) {
    const int bias[kModes] = {0, 1, 1, 3, 3, 3, 3, 3, 3, 1};
    const int nw = (nthr + 31) >> 5;
    int best = 0, best_cost = 0;
    for (int m = 0; m < kModes; ++m) {
      int sse = 0;
      for (int w = 0; w < nw; ++w) sse += s_sse[w][m];
      const int cost = sse + bias[m] * P.lam;
      if (m == 0 || cost < best_cost) {
        best = m;
        best_cost = cost;
      }
    }
    s_mode = best;
    P.mode[bi] = best;
  }
  __syncthreads();

  // 4. the chosen mode's prediction of the three planes, and the residual
  const int mode = s_mode;
  for (int i = tid; i < kPix; i += nthr) {
    const int p = plane_of(i), n = p == 0 ? 32 : 16;
    const int q = i - pix_off(p), y = q / n, x = q % n;
    const int pred = predict(mode, s_ref + ref_off(p), n, y, x, s_dc[p],
                             P.tabs + tab_dir(n));
    s_pred[i] = static_cast<uint8_t>(pred);
    s_int[int_off(p) + y * (n + 1) + x] = s_src[i] - pred;
  }
  __syncthreads();

  // 5. forward transform, columns: T = F_col @ R
  for (int i = tid; i < kPix; i += nthr) {
    const int p = plane_of(i);
    const int q = i - pix_off(p);
    if (p == 0) {
      s_t[i] = txfm::fwd_cols<32>(P.mats + mat_fcol(32), s_int, 33, q >> 5,
                                  q & 31);
    } else {
      s_t[i] = txfm::fwd_cols<16>(P.mats + mat_fcol(16), s_int + int_off(p),
                                  17, q >> 4, q & 15);
    }
  }
  __syncthreads();

  // 6. forward transform, rows: C = T @ F_row^T
  for (int i = tid; i < kPix; i += nthr) {
    const int p = plane_of(i);
    const int q = i - pix_off(p);
    if (p == 0) {
      s_c[i] = txfm::fwd_rows<32>(s_t, P.mats + mat_frowt(32), q >> 5,
                                  q & 31);
    } else {
      s_c[i] = txfm::fwd_rows<16>(s_t + pix_off(p), P.mats + mat_frowt(16),
                                  q >> 4, q & 15);
    }
  }
  __syncthreads();

  // 7. quantize (levels out), dequantize (for the inverse), eob: the last
  // nonzero level's place in scan order, plus one. Every thread runs the
  // same number of iterations and a warp never straddles two planes, so
  // the warp reductions see one plane.
  const int nblk = P.rows * P.cols;
  for (int i = tid; i < kPix; i += nthr) {
    const int p = plane_of(i), n = p == 0 ? 32 : 16;
    const int q = i - pix_off(p), y = q / n, x = q % n;
    const int step = txfm::coef_q(y, x, P.dc_q, P.ac_q);
    const int level = txfm::quantize(s_c[i], step, n);
    P.lv[p][static_cast<int64_t>(bi) * n * n + q] =
        static_cast<int16_t>(level);
    s_int[int_off(p) + y * (n + 1) + x] = txfm::dequant(level, step, n);
    const int pos = level != 0 ? P.tabs[tab_iscan(n) + q] + 1 : 0;
    const int top = warp_max(pos);
    if (lane == 0 && top > 0) atomicMax(&s_eob[p], top);
  }
  __syncthreads();
  for (int p = tid; p < 3; p += nthr) P.eob[p * nblk + bi] = s_eob[p];

  // 8. the inverse: rows (luma 0-31, u 32-47, v 48-63), then columns
  for (int t = tid; t < 64; t += nthr) {
    if (t < 32) {
      txfm::idct_line<32>(s_int + t * 33, 1);
    } else {
      const int p = t < 48 ? 1 : 2;
      txfm::idct_line<16>(s_int + int_off(p) + (t & 15) * 17, 1);
    }
  }
  __syncthreads();
  for (int t = tid; t < 64; t += nthr) {
    if (t < 32) {
      txfm::idct_line<32>(s_int + t, 33);
    } else {
      const int p = t < 48 ? 1 : 2;
      txfm::idct_line<16>(s_int + int_off(p) + (t & 15), 17);
    }
  }
  __syncthreads();

  // 9. recon into the planes that the next diagonals read
  for (int i = tid; i < kPix; i += nthr) {
    const int p = plane_of(i), n = p == 0 ? 32 : 16;
    const int q = i - pix_off(p), y = q / n, x = q % n;
    P.rec[p][(r * n + y) * (P.cols * n) + c * n + x] = txfm::recon_pixel(
        s_pred[i], s_int[int_off(p) + y * (n + 1) + x], n);
  }
}

}  // namespace

// Encodes the nblk blocks of anti-diagonal d that start at block row r0.
// Returns cudaGetLastError() after the launch.
extern "C" int kframe_wave_launch(
    const void* src_y, const void* src_u, const void* src_v, void* rec_y,
    void* rec_u, void* rec_v, void* mode, void* lv_y, void* lv_u,
    void* lv_v, void* eob, const void* mats, const void* tabs,
    int src_pitch, int height, int rows, int cols, int d, int r0, int nblk,
    int dc_q, int ac_q, int lam, void* stream) {
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
  P.src_pitch = src_pitch;
  P.height = height;
  P.rows = rows;
  P.cols = cols;
  P.d = d;
  P.r0 = r0;
  P.dc_q = dc_q;
  P.ac_q = ac_q;
  P.lam = lam;
  kframe_wave_kernel<<<nblk, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
