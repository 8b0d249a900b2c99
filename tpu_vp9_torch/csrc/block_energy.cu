// Per-block SSE and SAD of src - pred, one CUDA block per image block.
//
// Replaces the Pallas kernel tpu_vp9/ops/pallas_kernels.py:block_energy
// (body _block_energy_kernel). For each of B blocks of n x n uint8 pixels
// it returns sse = sum((src - pred)^2) and sad = sum(|src - pred|), both
// int32 (the largest SSE, 64*64*255^2, fits). The realtime P-frame step
// calls it for the ZERO candidate's SSE (source against the co-located
// reference block) and for the per-block recon distortion.
//
// What bounds it on an H100: memory. A 1080p call (B=2040, n=32) reads
// 4 MB and does 2e6 differences, a few microseconds at HBM speed, so the
// launch itself is most of its time. The design:
//   - one CTA of 64 threads per block; each thread loads 16 source and 16
//     prediction bytes at a time as uint4 (the wrapper checks that both
//     tensors start on a 16-byte boundary; n*n is a multiple of 64, so
//     every block does too);
//   - per 4-byte word, __vabsdiffu4 gives the four |differences|,
//     __vsadu4 sums them for the SAD, and __dp4a multiplies each by itself
//     and adds the four squares in 32 bits for the SSE;
//   - a warp shuffle reduction, then the two warps' partial sums through
//     shared memory. Integer sums are exact in any order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ void accumulate(uint32_t a, uint32_t b,
                                           unsigned int& sse,
                                           unsigned int& sad) {
  const unsigned int d = __vabsdiffu4(a, b);
  sad += __vsadu4(a, b);
  sse = __dp4a(d, d, sse);
}

__global__ void __launch_bounds__(kThreads)
block_energy_kernel(const uint8_t* __restrict__ src,
                    const uint8_t* __restrict__ pred, int nn,
                    int32_t* __restrict__ out_sse,
                    int32_t* __restrict__ out_sad) {
  __shared__ unsigned int part[2][kThreads / 32];
  const int blk = blockIdx.x;
  const uint4* s = reinterpret_cast<const uint4*>(
      src + static_cast<size_t>(blk) * nn);
  const uint4* p = reinterpret_cast<const uint4*>(
      pred + static_cast<size_t>(blk) * nn);
  unsigned int sse = 0, sad = 0;
  for (int i = threadIdx.x; i < nn / 16; i += kThreads) {
    const uint4 a = s[i];
    const uint4 b = p[i];
    accumulate(a.x, b.x, sse, sad);
    accumulate(a.y, b.y, sse, sad);
    accumulate(a.z, b.z, sse, sad);
    accumulate(a.w, b.w, sse, sad);
  }
  for (int off = 16; off > 0; off >>= 1) {
    sse += __shfl_down_sync(0xffffffffu, sse, off);
    sad += __shfl_down_sync(0xffffffffu, sad, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = sse;
    part[1][warp] = sad;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      sse += part[0][w];
      sad += part[1][w];
    }
    out_sse[blk] = static_cast<int32_t>(sse);
    out_sad[blk] = static_cast<int32_t>(sad);
  }
}

}  // namespace

// src, pred: (b, n, n) uint8, contiguous on the device, 16-byte aligned;
// out_sse, out_sad: (b,) int32. The caller has checked n in
// {8, 16, 32, 64} and b >= 1. Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int block_energy_launch(const void* src, const void* pred,
                                   void* out_sse, void* out_sad, int b,
                                   int n, void* stream) {
  if (n != 8 && n != 16 && n != 32 && n != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  block_energy_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(pred),
      n * n, static_cast<int32_t*>(out_sse), static_cast<int32_t*>(out_sad));
  return static_cast<int>(cudaGetLastError());
}
