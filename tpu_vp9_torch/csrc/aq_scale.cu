// The adaptive lambda of tune SQ on the card: a zone's per-block rate
// lambda, lam_bits times the block's variance-adaptive scale, from the
// exact int32 sums of its n x n source blocks.
//
// Replaces tpu_vp9/pipeline/tpu_encdec.py: _sb_lambda_scale (:226), which
// XLA runs inside the JAX step, and the lam_bits product of its callers.
// The contract is the plain version beside the step,
// tpu_vp9_torch/pipeline/tpu_encdec.py: aq_scale_ref (the host chain
// _sb_lambda_scale, then the product), bit for bit:
//   mean = f32(sum) / f32(n^2); var = max(f32(sum2) / f32(n^2) - mean *
//   mean, 0); logv = f32(log(f64(var + 16))); mean_log = f32(sum of the
//   logv in float64) / f32(B); scale = clip(f32(exp(f64((logv - mean_log)
//   * 0.25))), 0.5, 2); out = scale * lam_bits,
// every float32 step rounded on its own (__fmul_rn, __fdiv_rn, __fsub_rn,
// __fadd_rn: no contraction), log and exp taken in float64 and rounded to
// float32 once. The card's float64 log and exp are within an ulp of the
// correctly rounded value, the host's too, so a float32 result can differ
// only where the float64 value lies within an ulp or two of a float32
// rounding boundary (about one value in 2^28).
//
// The sum of the logs is exact in float64 whatever its order: every logv
// is a float32 of at least log(16) > 2, so a multiple of 2^-22, and B of
// them below 2^26 sum to less than 2^53 such units. The host's numpy sum
// and this kernel's tree therefore give the same bits.
//
// Shape: one CTA of 1024 threads covers a whole zone (B <= 8,040 at 4K;
// B = 80 on a 720p strip): each thread sums the logs of blocks tid, tid +
// 1024, ... in float64, a tree in shared memory adds the 1024 partial
// sums, and each thread then recomputes its blocks' logs (the same bits)
// for the scale. The kernel is bound by its launch: it reads 8 bytes and
// writes 4 a block, and its float64 log and exp are a few microseconds of
// one SM at B = 8,040.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

// block i's f32(log(f64(var + 16))) from its sums
__device__ __forceinline__ float log_var(const int* __restrict__ src_sum,
                                         const int* __restrict__ src2,
                                         int i, float nn) {
  const float mean = __fdiv_rn(__int2float_rn(__ldg(src_sum + i)), nn);
  const float var =
      fmaxf(__fsub_rn(__fdiv_rn(__int2float_rn(__ldg(src2 + i)), nn),
                      __fmul_rn(mean, mean)),
            0.0f);
  return __double2float_rn(log(static_cast<double>(__fadd_rn(var, 16.0f))));
}

__global__ void __launch_bounds__(kThreads, 1)
    aq_scale_kernel(const int* __restrict__ src_sum,
                    const int* __restrict__ src2,
                    const int* __restrict__ lam_bits_word,
                    float* __restrict__ out, int b, int n) {
  extern __shared__ __align__(16) double part[];
  const int tid = threadIdx.x;
  const float nn = __int2float_rn(n * n);
  double sum = 0.0;
  for (int i = tid; i < b; i += kThreads) {
    sum += static_cast<double>(log_var(src_sum, src2, i, nn));
  }
  part[tid] = sum;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (tid < half) part[tid] = __dadd_rn(part[tid], part[tid + half]);
    __syncthreads();
  }
  const float mean_log =
      __fdiv_rn(__double2float_rn(part[0]), __int2float_rn(b));
  const float lam_bits = __int_as_float(__ldg(lam_bits_word));
  for (int i = tid; i < b; i += kThreads) {
    const float d = __fmul_rn(
        __fsub_rn(log_var(src_sum, src2, i, nn), mean_log), 0.25f);
    const float scale =
        fminf(fmaxf(__double2float_rn(exp(static_cast<double>(d))), 0.5f),
              2.0f);
    out[i] = __fmul_rn(scale, lam_bits);
  }
}

}  // namespace

// b blocks of n x n: src_sum, src2 (b,) int32 the exact sums of their
// pixels and of their squares; lam_bits the word of the frame's lam_bits
// (float32 bits) in the rate tables' scalars row; out (b,) float32 the
// blocks' rate lambdas. One CTA, whatever b (nothing is launched at b =
// 0). Returns cudaGetLastError() after the launch.
extern "C" int aq_scale_launch(const void* src_sum, const void* src2,
                               const void* lam_bits, void* out, int b, int n,
                               void* stream) {
  if (b < 0 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaSuccess);
  aq_scale_kernel<<<1, kThreads, kThreads * sizeof(double),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src_sum), static_cast<const int*>(src2),
      static_cast<const int*>(lam_bits), static_cast<float*>(out), b, n);
  return static_cast<int>(cudaGetLastError());
}

// On the current device: *ctas_per_sm the CTAs of 1024 threads an SM holds
// at once, *smem_bytes the dynamic shared memory each asks for. Returns the
// CUDA error of the query (0 if none).
extern "C" int aq_scale_occupancy(int* ctas_per_sm, int* smem_bytes) {
  *smem_bytes = kThreads * sizeof(double);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, aq_scale_kernel, kThreads, kThreads * sizeof(double)));
}
