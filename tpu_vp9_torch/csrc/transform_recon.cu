// The realtime P-frame step's transform stage: for a batch of n x n blocks
// (n = 8, 16 or 32), the residual src - pred, the forward DCT in float64,
// the dead-zone quantizer, the dequantizer, the exact integer inverse, the
// recon and the eob.
//
// Replaces the XLA stage tpu_vp9/pipeline/tpu_encdec.py:transform_recon
// (with _quantize:796 and _dequantize:807) for DCT_DCT blocks; its
// contract is the plain version beside the step,
// tpu_vp9_torch/pipeline/tpu_encdec.py:transform_recon_ref, whose forward
// half is float64 (txfm.fwd_txfm2d_f64, txfm.quantize_f64) and whose
// integer half is recon_from_levels. The pieces are those of
// txfm_common.cuh, which the keyframe's kernel shares, so levels, eob and
// recon equal the plain version's unless a coefficient's |c| / q + 0.38
// lies within about 1e-12 of an integer (the float64 products sum in
// another order than torch's matmul).
//
// What bounds it on an H100: at the main path's largest shape (B = 2040
// blocks of 32x32) it moves about 10.4 MB (src and pred in, int16 levels,
// recon and eob out: 0.0031 ms at 3.35 TB/s) and does 2.7e8 float64
// operations in the two forward products (0.0040 ms at 67 TFLOP/s), so the
// float64 work bounds it. The design is the simple one: a CTA of 256
// threads takes 1024 pixels (one 32x32 block, four 16x16 or sixteen 8x8
// ones); every phase deals its coefficients, lines or pixels to the threads
// in a strided loop between barriers (so it also runs right with one
// thread): residual into shared memory, T = F_col @ R, X = T @ F_row^T
// (a thread per coefficient, a chain of n float64 multiply-adds, the
// matrices read through the cache), quantize and dequantize, the inverse
// by rows then columns (a thread per line), recon. The eob is the largest
// scan place of a nonzero level, plus one: a warp maximum over the
// uploaded inverse scan (raster place -> scan place), then one shared
// maximum per block.

#include <cstdint>
#include <cuda_runtime.h>

#include "txfm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 1024;  // pixels of one CTA

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Place of pixel i of the CTA (block i / N^2, raster place q in it) in the
// integer work planes, one per block at an odd pitch of N + 1: a thread per
// row or per column walks them without bank conflicts.
template <int N>
__device__ __forceinline__ int work_at(int i) {
  const int b = i / (N * N), q = i % (N * N);
  return b * N * (N + 1) + (q / N) * (N + 1) + q % N;
}

template <int N>
__global__ void __launch_bounds__(kThreads) transform_recon_kernel(
    const uint8_t* __restrict__ src, const uint8_t* __restrict__ pred,
    const double* __restrict__ f_col, const double* __restrict__ f_row_t,
    const int* __restrict__ iscan, int16_t* __restrict__ levels,
    int* __restrict__ eob, uint8_t* __restrict__ recon, int nblk, int dc_q,
    int ac_q) {
  constexpr int kNN = N * N;
  constexpr int kPer = kPix / kNN;  // blocks of one CTA
  constexpr int kPitch = N + 1;
  __shared__ int s_int[kPer * N * kPitch];  // residual, then dequantized
  __shared__ double s_t[kPix];              // F_col @ R
  __shared__ double s_c[kPix];              // coefficients
  __shared__ uint8_t s_pred[kPix];
  __shared__ int s_eob[kPer];

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  // the CTA's pixels are pixels base .. base + 1023 of the batch; those
  // at or past `total` belong to no block (the last CTA may be partial)
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kPix;
  const int64_t total = static_cast<int64_t>(nblk) * kNN;

  // 1. the residual and the prediction
  for (int b = tid; b < kPer; b += nthr) s_eob[b] = 0;
  for (int i = tid; i < kPix; i += nthr) {
    const bool ok = base + i < total;
    const int p = ok ? pred[base + i] : 0;
    const int s = ok ? src[base + i] : 0;
    s_pred[i] = static_cast<uint8_t>(p);
    s_int[work_at<N>(i)] = s - p;
  }
  __syncthreads();

  // 2. forward transform, columns: T = F_col @ R
  for (int i = tid; i < kPix; i += nthr) {
    const int b = i / kNN, q = i % kNN;
    s_t[i] = txfm::fwd_cols<N>(f_col, s_int + b * N * kPitch, kPitch, q / N,
                               q % N);
  }
  __syncthreads();

  // 3. forward transform, rows: X = T @ F_row^T
  for (int i = tid; i < kPix; i += nthr) {
    const int b = i / kNN, q = i % kNN;
    s_c[i] = txfm::fwd_rows<N>(s_t + b * kNN, f_row_t, q / N, q % N);
  }
  __syncthreads();

  // 4. quantize (levels out), dequantize (for the inverse), eob. Every
  // thread runs the same number of iterations, and 32 consecutive pixels
  // lie in one block (N^2 >= 64), so a warp's maximum is one block's.
  for (int i = tid; i < kPix; i += nthr) {
    const int b = i / kNN, q = i % kNN, y = q / N, x = q % N;
    const bool ok = base + i < total;
    const int step = txfm::coef_q(y, x, dc_q, ac_q);
    const int level = txfm::quantize(s_c[i], step, N);
    if (ok) levels[base + i] = static_cast<int16_t>(level);
    s_int[work_at<N>(i)] = txfm::dequant(level, step, N);
    const int pos = ok && level != 0 ? iscan[q] + 1 : 0;
    const int top = warp_max(pos);
    if (lane == 0 && top > 0) atomicMax(&s_eob[b], top);
  }
  __syncthreads();

  // 5. the inverse: every block's rows, then its columns, a thread a line
  for (int t = tid; t < kPer * N; t += nthr) {
    txfm::idct_line<N>(s_int + (t / N) * N * kPitch + (t % N) * kPitch, 1);
  }
  __syncthreads();
  for (int t = tid; t < kPer * N; t += nthr) {
    txfm::idct_line<N>(s_int + (t / N) * N * kPitch + t % N, kPitch);
  }
  __syncthreads();

  // 6. recon and eob
  for (int i = tid; i < kPix; i += nthr) {
    if (base + i < total) {
      recon[base + i] = txfm::recon_pixel(s_pred[i], s_int[work_at<N>(i)], N);
    }
  }
  for (int b = tid; b < kPer; b += nthr) {
    const int64_t g = static_cast<int64_t>(blockIdx.x) * kPer + b;
    if (g < nblk) eob[g] = s_eob[b];
  }
}

template <int N>
cudaError_t launch(const void* src, const void* pred, const void* f_col,
                   const void* f_row_t, const void* iscan, void* levels,
                   void* eob, void* recon, int nblk, int dc_q, int ac_q,
                   cudaStream_t stream) {
  constexpr int kPer = kPix / (N * N);
  const int grid = (nblk + kPer - 1) / kPer;
  transform_recon_kernel<N><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(pred),
      static_cast<const double*>(f_col), static_cast<const double*>(f_row_t),
      static_cast<const int*>(iscan), static_cast<int16_t*>(levels),
      static_cast<int*>(eob), static_cast<uint8_t*>(recon), nblk, dc_q, ac_q);
  return cudaGetLastError();
}

}  // namespace

// nblk blocks of n x n (n = 8, 16 or 32): src, pred, levels (int16) and
// recon are (nblk, n, n) contiguous, eob (nblk,) int32; f_col and f_row_t
// the float64 forward matrices of n, n x n row-major; iscan (n * n,) int32
// each raster place's place in the DCT_DCT scan. Returns
// cudaGetLastError() after the launch.
extern "C" int transform_recon_launch(const void* src, const void* pred,
                                      const void* f_col, const void* f_row_t,
                                      const void* iscan, void* levels,
                                      void* eob, void* recon, int nblk,
                                      int n, int dc_q, int ac_q,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 32:
      return static_cast<int>(launch<32>(src, pred, f_col, f_row_t, iscan,
                                         levels, eob, recon, nblk, dc_q,
                                         ac_q, s));
    case 16:
      return static_cast<int>(launch<16>(src, pred, f_col, f_row_t, iscan,
                                         levels, eob, recon, nblk, dc_q,
                                         ac_q, s));
    case 8:
      return static_cast<int>(launch<8>(src, pred, f_col, f_row_t, iscan,
                                        levels, eob, recon, nblk, dc_q, ac_q,
                                        s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
