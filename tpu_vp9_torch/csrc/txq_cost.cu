// Float DCT-II + dead-zone quantizer + distortion and rate proxies per
// block, one CUDA block per residual block.
//
// Replaces the Pallas kernel tpu_vp9/ops/pallas_kernels.py:txq_cost (body
// _txq_cost_kernel). For each of B residual blocks x of n x n float32 it
// computes
//   coeffs = D x D^T            (D the orthonormal DCT-II matrix, given)
//   level  = trunc(coeffs / q + sign(coeffs) * 0.38)
//            with q = dc_q at (0, 0) and ac_q elsewhere
//   dist   = sum((coeffs - level * q)^2)
//   rate   = sum over level != 0 of 1.5 + log2(1 + |level|)
// and returns (dist, rate) as float32. Both matrix products are computed
// here, in the kernel's own body, with float32 fused multiply-adds.
//
// What bounds it on an H100: operations, narrowly. At B=2040, n=32 a call
// reads 8.4 MB (2.5 us at HBM speed) and does 4 n^3 = 131072 multiply-adds'
// worth of flops per block, 0.27 GFLOP in all (4 us at the float32 rate
// outside the tensor cores). The design is the simple one:
//   - one CTA per block, up to 256 threads, each thread owning n*n/256
//     output elements of each product;
//   - D, x and the intermediate D x live in shared memory (12.4 KB at
//     n=32). D and D x are stored with a row pitch of n+1 floats: in the
//     second product neighbouring threads read D[j][k] for neighbouring j,
//     which without the pad would all fall into one bank;
//   - the k loop runs in ascending order with fmaf, so the result does not
//     depend on the launch; it does differ from a library's product in the
//     last bits, hence the wrapper's stated tolerance;
//   - the quantizer keeps a true division (not a multiply by a reciprocal)
//     and separate multiply and subtract for level * q, so that the set of
//     coefficients that sit on a rounding boundary is the reference's;
//   - a warp shuffle reduction, then the warps' partial sums through
//     shared memory, for the two sums.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// threads of a CTA: one per coefficient up to 256, and at least a warp
template <int N>
struct Threads {
  static constexpr int value =
      N * N >= 256 ? 256 : (N * N < 32 ? 32 : N * N);
};

template <int N>
__global__ void __launch_bounds__(Threads<N>::value)
txq_cost_kernel(const float* __restrict__ resid,
                const float* __restrict__ dmat, float dc_q, float ac_q,
                float* __restrict__ out_dist, float* __restrict__ out_rate) {
  constexpr int T = Threads<N>::value;
  constexpr int NN = N * N;
  constexpr int P = N + 1;  // padded row pitch
  __shared__ float sd[N * P];
  __shared__ float sc[N * P];
  __shared__ float sx[NN];
  __shared__ float part[2][T / 32];

  const int tid = threadIdx.x;
  const float* x = resid + static_cast<size_t>(blockIdx.x) * NN;
  for (int e = tid; e < NN; e += T) {
    sx[e] = x[e];
    sd[(e / N) * P + (e % N)] = dmat[e];
  }
  __syncthreads();

  // c = D x
  for (int e = tid; e < NN; e += T) {
    const int i = e / N, j = e % N;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) acc = fmaf(sd[i * P + k], sx[k * N + j], acc);
    sc[i * P + j] = acc;
  }
  __syncthreads();

  // coeffs = c D^T, then the quantizer and the two sums
  float dist = 0.0f, rate = 0.0f;
  for (int e = tid; e < NN; e += T) {
    const int i = e / N, j = e % N;
    float c = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) c = fmaf(sc[i * P + k], sd[j * P + k], c);
    const float q = e == 0 ? dc_q : ac_q;
    const float sign = c > 0.0f ? 1.0f : (c < 0.0f ? -1.0f : 0.0f);
    const float level = truncf(__fadd_rn(__fdiv_rn(c, q),
                                         __fmul_rn(sign, 0.38f)));
    const float err = __fsub_rn(c, __fmul_rn(level, q));
    dist = __fadd_rn(dist, __fmul_rn(err, err));
    const float mag = fabsf(level);
    if (mag > 0.0f) rate += 1.5f + log2f(1.0f + mag);
  }
  for (int off = 16; off > 0; off >>= 1) {
    dist += __shfl_down_sync(0xffffffffu, dist, off);
    rate += __shfl_down_sync(0xffffffffu, rate, off);
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) {
    part[0][warp] = dist;
    part[1][warp] = rate;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < T / 32; ++w) {
      dist += part[0][w];
      rate += part[1][w];
    }
    out_dist[blockIdx.x] = dist;
    out_rate[blockIdx.x] = rate;
  }
}

template <int N>
int launch(const float* resid, const float* dmat, float dc_q, float ac_q,
           float* out_dist, float* out_rate, int b, cudaStream_t stream) {
  txq_cost_kernel<N><<<b, Threads<N>::value, 0, stream>>>(
      resid, dmat, dc_q, ac_q, out_dist, out_rate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// resid: (b, n, n) float32, contiguous on the device; dmat: (n, n) float32
// DCT-II matrix; out_dist, out_rate: (b,) float32. The caller has checked
// n in {4, 8, 16, 32} and b >= 1. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int txq_cost_launch(const void* resid, const void* dmat,
                               void* out_dist, void* out_rate, float dc_q,
                               float ac_q, int b, int n, void* stream) {
  const float* r = static_cast<const float*>(resid);
  const float* d = static_cast<const float*>(dmat);
  float* od = static_cast<float*>(out_dist);
  float* orr = static_cast<float*>(out_rate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4: return launch<4>(r, d, dc_q, ac_q, od, orr, b, s);
    case 8: return launch<8>(r, d, dc_q, ac_q, od, orr, b, s);
    case 16: return launch<16>(r, d, dc_q, ac_q, od, orr, b, s);
    case 32: return launch<32>(r, d, dc_q, ac_q, od, orr, b, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
