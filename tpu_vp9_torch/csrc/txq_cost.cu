// Float DCT-II + dead-zone quantizer + distortion and rate proxies per
// residual block, with a register tile per thread.
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
// here, in the kernel's own body, with float32 fused multiply-adds off the
// tensor cores: TF32 would move coefficients across the trunc boundary.
//
// What bounds it on an H100: operations at n=32 (B=2040: 8.4 MB, 2.5 us at
// HBM speed, against 4 n^3 multiply-adds' worth of flops per block, 4.3 us
// at the float32 rate), bytes at n=16 and below. The first form of this
// kernel took a CTA per block and read two shared-memory words per fmaf, so
// it ran at shared-memory speed, about eight times under the float32 rate,
// and at n=16 it launched 8160 CTAs of 16-long dot products. This form:
//   - a thread owns a tile of each product's output in registers: 8 x 4 at
//     n=32, 4 x 4 below. In D x a k step takes D^T[k][i0..] and
//     x[k][j0..j0+3] as 16-byte shared-memory loads (three for 32 fmaf at
//     n=32, two for 16 below); in (D x) D^T it takes a word of D x per tile
//     row (rows of an odd pitch, so the rows a warp reads lie in different
//     banks) and one 16-byte load of D^T[k][j0..j0+3]. D is kept transposed
//     for that;
//   - a residual block therefore takes 32 threads at n=32, 16 at n=16, 4 at
//     n=8, 1 at n=4: a warp holds 1, 2, 8 or 32 blocks and synchronises on
//     its own (__syncwarp), no CTA-wide barrier once D is in place;
//   - CTAs are persistent: a warp walks over the blocks with the grid's
//     stride, so D is read once per CTA, and while one warp waits for its
//     residuals (16 bytes a load, all of a thread's in flight) the others
//     compute. At B=2040 n=32 the card holds every block at once, and the
//     8 x 4 tile's fewer shared-memory loads win (13.2 us against 16.3 for
//     4 x 4 on an H100); at four times the batch, where occupancy counts,
//     4 x 4 is ahead (43 against 54 us);
//   - each output's k loop runs in ascending order with fmaf from 0, as the
//     first form's did, so every coefficient and level has the same bits;
//     only the order of the two final sums differs (a thread's terms, then
//     a butterfly over the block's threads), inside the wrapper's stated
//     tolerance;
//   - the quantizer keeps a true division (not a multiply by a reciprocal)
//     and separate multiply and subtract for level * q, so that the set of
//     coefficients that sit on a rounding boundary is the reference's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS_PER_SM = 32;  // the grid's cap

template <int N>
struct Cfg {
  static constexpr int TM = N == 32 ? 8 : 4;  // tile rows
  static constexpr int TR = N / TM, TC = N / 4;      // tiles per side
  static constexpr int G = TR * TC;  // threads per residual block: <= 32
  static constexpr int BPW = 32 / G;            // blocks a warp holds
  static constexpr int CTA = N == 32 ? 128 : 256;
  static constexpr int WARPS = CTA / 32;
  static constexpr int LOADS = N * N / 4 / G;   // 16-byte loads a thread
  static constexpr int PC = N + 1;              // row pitch of D x
};

template <int N>
__global__ void __launch_bounds__(Cfg<N>::CTA)
txq_cost_kernel(const float* __restrict__ resid,
                const float* __restrict__ dmat, float dc_q, float ac_q,
                float* __restrict__ out_dist, float* __restrict__ out_rate,
                int b) {
  using C = Cfg<N>;
  constexpr int NN = N * N, TM = C::TM;
  __shared__ __align__(16) float dt[NN];  // dt[k][i] = D[i][k]
  __shared__ __align__(16) float xs[C::WARPS * C::BPW * NN];
  __shared__ float c1[C::WARPS * C::BPW * N * C::PC];

  const int tid = threadIdx.x;
  for (int e = tid; e < NN; e += C::CTA) dt[(e % N) * N + e / N] = dmat[e];
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int slot = lane / C::G, lt = lane % C::G;
  const int i0 = TM * (lt / C::TC), j0 = 4 * (lt % C::TC);
  float* x = xs + (warp * C::BPW + slot) * NN;
  float* c = c1 + (warp * C::BPW + slot) * N * C::PC;
  const float4* resid4 = reinterpret_cast<const float4*>(resid);

  for (int base = (blockIdx.x * C::WARPS + warp) * C::BPW; base < b;
       base += gridDim.x * C::WARPS * C::BPW) {
    const int blk = base + slot;
    const bool active = blk < b;
    // the block's residuals, 16 bytes a load, all of a thread's in flight
    float4 v[C::LOADS];
#pragma unroll
    for (int m = 0; m < C::LOADS; ++m)
      v[m] = active ? __ldg(resid4 + static_cast<size_t>(blk) * (NN / 4) +
                            lt + C::G * m)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int m = 0; m < C::LOADS; ++m)
      reinterpret_cast<float4*>(x)[lt + C::G * m] = v[m];
    __syncwarp();

    // D x: acc[r][s] = sum_k D[i0 + r][k] x[k][j0 + s]
    float acc[TM][4];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float a[TM];
#pragma unroll
      for (int m = 0; m < TM / 4; ++m) {
        const float4 a4 =
            *reinterpret_cast<const float4*>(dt + k * N + i0 + 4 * m);
        a[4 * m] = a4.x;
        a[4 * m + 1] = a4.y;
        a[4 * m + 2] = a4.z;
        a[4 * m + 3] = a4.w;
      }
      const float4 b4 = *reinterpret_cast<const float4*>(x + k * N + j0);
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(a[r], bb[s], acc[r][s]);
    }
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) c[(i0 + r) * C::PC + j0 + s] = acc[r][s];
    __syncwarp();

    // coeffs = (D x) D^T: acc[r][s] = sum_k (D x)[i0 + r][k] D[j0 + s][k]
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float4 b4 = *reinterpret_cast<const float4*>(dt + k * N + j0);
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float a = c[(i0 + r) * C::PC + k];
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(a, bb[s], acc[r][s]);
      }
    }

    // the quantizer and this thread's share of the two sums
    float dist = 0.0f, rate = 0.0f;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float cf = acc[r][s];
        const float q = (i0 + r == 0 && j0 + s == 0) ? dc_q : ac_q;
        const float sign = cf > 0.0f ? 1.0f : (cf < 0.0f ? -1.0f : 0.0f);
        const float level =
            truncf(__fadd_rn(__fdiv_rn(cf, q), __fmul_rn(sign, 0.38f)));
        const float err = __fsub_rn(cf, __fmul_rn(level, q));
        dist = __fadd_rn(dist, __fmul_rn(err, err));
        const float mag = fabsf(level);
        if (mag > 0.0f) rate += 1.5f + log2f(1.0f + mag);
      }
    }
    // a butterfly over the block's threads (aligned groups of G lanes)
#pragma unroll
    for (int off = C::G / 2; off > 0; off >>= 1) {
      dist += __shfl_xor_sync(0xffffffffu, dist, off);
      rate += __shfl_xor_sync(0xffffffffu, rate, off);
    }
    if (lt == 0 && active) {
      out_dist[blk] = dist;
      out_rate[blk] = rate;
    }
  }
}

template <int N>
int launch(const float* resid, const float* dmat, float dc_q, float ac_q,
           float* out_dist, float* out_rate, int b, cudaStream_t stream) {
  using C = Cfg<N>;
  static int sm_count[64] = {};  // per device, asked once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = dev < 64 ? sm_count[dev] : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) sm_count[dev] = sms;
  }
  const int per_cta = C::WARPS * C::BPW;
  const int want = (b + per_cta - 1) / per_cta;
  const int cap = sms * WARPS_PER_SM / (C::CTA / 32);
  txq_cost_kernel<N><<<want < cap ? want : cap, C::CTA, 0, stream>>>(
      resid, dmat, dc_q, ac_q, out_dist, out_rate, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// resid: (b, n, n) float32, contiguous on the device and 16-byte aligned;
// dmat: (n, n) float32 DCT-II matrix; out_dist, out_rate: (b,) float32. The
// caller has checked n in {4, 8, 16, 32} and b >= 1. Returns
// cudaGetLastError() after the launch (0 on success).
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
