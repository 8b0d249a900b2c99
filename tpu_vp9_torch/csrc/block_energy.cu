// Per-block SSE and SAD of src - pred, in two forms: the prediction as
// (B, n, n) blocks, or read in place out of a plane at per-block starts
// for several candidate position sets at once.
//
// Replaces the Pallas kernel tpu_vp9/ops/pallas_kernels.py:block_energy
// (body _block_energy_kernel). For each of B blocks of n x n uint8 pixels
// it returns sse = sum((src - pred)^2) and sad = sum(|src - pred|), both
// int32 (the largest SSE, 64*64*255^2, fits). The realtime P-frame step
// calls the block form for the recon distortion and the positioned form
// for the candidates that need no interpolation: ZERO (the co-located
// reference block) and a previous MV rounded to full pel, on LAST or
// GOLDEN; the two GOLDEN candidates are one launch with C = 2.
//
// What bounds it on an H100: memory, and before that the launch. A 1080p
// call (B=2040, n=32) reads 4 MB and does 2e6 differences, a microsecond
// or two at HBM speed; a reference plane with its borders is 2.4 MB and
// stays in L2. So the design spends nothing on arithmetic and keeps every
// lane loading:
//   - work is dealt by bytes, not by blocks: a block is n*n/16 pieces of
//     16 bytes (8 at n=8) and a warp gives each block min(32, pieces)
//     lanes, so at n <= 16 a warp takes 2 to 8 blocks and no lane idles; a
//     CTA is 8 warps;
//   - the positioned form needs no gathered copy of the prediction: a
//     lane computes its piece's address from the plane's pitch and the
//     block's start, loads the aligned 4-byte words around it and brings
//     them into place with a funnel shift (a start has any alignment);
//   - per 4-byte word, __vabsdiffu4 gives the four |differences|,
//     __vsadu4 sums them for the SAD, and __dp4a multiplies each by itself
//     and adds the four squares in 32 bits for the SSE;
//   - a shuffle reduction inside the lanes of one block. Integer sums are
//     exact in any order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void accumulate(uint32_t a, uint32_t b,
                                           unsigned int& sse,
                                           unsigned int& sad) {
  const unsigned int d = __vabsdiffu4(a, b);
  sad += __vsadu4(a, b);
  sse = __dp4a(d, d, sse);
}

// Sum over the LPB neighbouring lanes that share one block.
template <int LPB>
__device__ __forceinline__ void group_sum(unsigned int& sse,
                                          unsigned int& sad) {
#pragma unroll
  for (int off = LPB / 2; off > 0; off >>= 1) {
    sse += __shfl_xor_sync(0xffffffffu, sse, off);
    sad += __shfl_xor_sync(0xffffffffu, sad, off);
  }
}

// LPB lanes per block: min(32, n*n/16).
template <int LPB>
__global__ void __launch_bounds__(kThreads)
block_energy_kernel(const uint8_t* __restrict__ src,
                    const uint8_t* __restrict__ pred, int nn, int b,
                    int32_t* __restrict__ out_sse,
                    int32_t* __restrict__ out_sad) {
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int blk = gwarp * (32 / LPB) + lane / LPB;
  const int l = lane % LPB;
  unsigned int sse = 0, sad = 0;
  if (blk < b) {
    const uint4* s = reinterpret_cast<const uint4*>(
        src + static_cast<size_t>(blk) * nn);
    const uint4* p = reinterpret_cast<const uint4*>(
        pred + static_cast<size_t>(blk) * nn);
    for (int i = l; i < nn / 16; i += LPB) {
      const uint4 a = s[i];
      const uint4 c = p[i];
      accumulate(a.x, c.x, sse, sad);
      accumulate(a.y, c.y, sse, sad);
      accumulate(a.z, c.z, sse, sad);
      accumulate(a.w, c.w, sse, sad);
    }
  }
  group_sum<LPB>(sse, sad);
  if (l == 0 && blk < b) {
    out_sse[blk] = static_cast<int32_t>(sse);
    out_sad[blk] = static_cast<int32_t>(sad);
  }
}

// The positioned form. An item is (candidate set c, block): item = c * b +
// block, and its prediction is the n x n region of the plane at
// (y0[item], x0[item]). A piece is U = min(n, 16) bytes of one row.
template <int N>
__global__ void __launch_bounds__(kThreads)
block_energy_at_kernel(const uint8_t* __restrict__ src,
                       const uint8_t* __restrict__ plane, int pitch,
                       const int32_t* __restrict__ y0,
                       const int32_t* __restrict__ x0, int b, int items,
                       int32_t* __restrict__ out_sse,
                       int32_t* __restrict__ out_sad) {
  constexpr int U = N < 16 ? N : 16;
  constexpr int WORDS = U / 4;
  constexpr int PIECES = N * N / U;
  constexpr int LPB = PIECES < 32 ? PIECES : 32;
  constexpr int PER_ROW = N / U;
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int item = gwarp * (32 / LPB) + lane / LPB;
  const int l = lane % LPB;
  unsigned int sse = 0, sad = 0;
  if (item < items) {
    const int blk = item % b;
    const uint8_t* s_blk = src + static_cast<size_t>(blk) * N * N;
    const uint8_t* p_blk = plane + static_cast<size_t>(y0[item]) * pitch
                           + x0[item];
#pragma unroll
    for (int it = 0; it < PIECES / LPB; ++it) {
      const int i = it * LPB + l;
      const int row = i / PER_ROW;
      const int col = (i % PER_ROW) * U;
      // the source piece is U-aligned
      uint32_t a[WORDS];
      if constexpr (U == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(s_blk + row * N + col);
        a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(s_blk + row * N + col);
        a[0] = v.x; a[1] = v.y;
      }
      // the prediction piece is not: the aligned words that hold it, the
      // last one only where the piece reaches into it (so no word is read
      // that holds no byte of the plane)
      const uintptr_t addr = reinterpret_cast<uintptr_t>(
          p_blk + static_cast<size_t>(row) * pitch + col);
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(
          addr & ~static_cast<uintptr_t>(3));
      const unsigned int sh = static_cast<unsigned int>(addr & 3) * 8;
      uint32_t w[WORDS + 1];
#pragma unroll
      for (int k = 0; k < WORDS; ++k) w[k] = wp[k];
      w[WORDS] = sh != 0 ? wp[WORDS] : 0u;
#pragma unroll
      for (int k = 0; k < WORDS; ++k)
        accumulate(a[k], __funnelshift_r(w[k], w[k + 1], sh), sse, sad);
    }
  }
  group_sum<LPB>(sse, sad);
  if (l == 0 && item < items) {
    out_sse[item] = static_cast<int32_t>(sse);
    out_sad[item] = static_cast<int32_t>(sad);
  }
}

template <int LPB>
void launch_blocks(const uint8_t* src, const uint8_t* pred, int32_t* sse,
                   int32_t* sad, int b, int nn, cudaStream_t st) {
  const int per_cta = kWarps * (32 / LPB);
  block_energy_kernel<LPB><<<(b + per_cta - 1) / per_cta, kThreads, 0, st>>>(
      src, pred, nn, b, sse, sad);
}

template <int N>
void launch_at(const uint8_t* src, const uint8_t* plane, int pitch,
               const int32_t* y0, const int32_t* x0, int32_t* sse,
               int32_t* sad, int b, int c, cudaStream_t st) {
  constexpr int U = N < 16 ? N : 16;
  constexpr int PIECES = N * N / U;
  constexpr int LPB = PIECES < 32 ? PIECES : 32;
  const int per_cta = kWarps * (32 / LPB);
  const int items = b * c;
  block_energy_at_kernel<N><<<(items + per_cta - 1) / per_cta, kThreads, 0,
                              st>>>(src, plane, pitch, y0, x0, b, items, sse,
                                    sad);
}

}  // namespace

// src, pred: (b, n, n) uint8, contiguous on the device, 16-byte aligned;
// out_sse, out_sad: (b,) int32. n in {8, 16, 32, 64}, b >= 1. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int block_energy_launch(const void* src, const void* pred,
                                   void* out_sse, void* out_sad, int b,
                                   int n, void* stream) {
  auto* s = static_cast<const uint8_t*>(src);
  auto* p = static_cast<const uint8_t*>(pred);
  auto* sse = static_cast<int32_t*>(out_sse);
  auto* sad = static_cast<int32_t*>(out_sad);
  auto st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: launch_blocks<4>(s, p, sse, sad, b, 64, st); break;
    case 16: launch_blocks<16>(s, p, sse, sad, b, 256, st); break;
    case 32: launch_blocks<32>(s, p, sse, sad, b, 1024, st); break;
    case 64: launch_blocks<32>(s, p, sse, sad, b, 4096, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// src: (b, n, n) uint8, contiguous, 16-byte aligned; plane: uint8 rows of
// `pitch` bytes, its first byte 4-byte aligned; y0, x0: (c, b) int32
// starts, each with 0 <= start <= size - n (the caller's duty: nothing is
// checked here); out_sse, out_sad: (c, b) int32. n in {8, 16, 32, 64},
// b >= 1, c >= 1. Returns cudaGetLastError() after the launch.
extern "C" int block_energy_at_launch(const void* src, const void* plane,
                                      const void* y0, const void* x0,
                                      void* out_sse, void* out_sad, int b,
                                      int c, int n, int pitch,
                                      void* stream) {
  auto* s = static_cast<const uint8_t*>(src);
  auto* p = static_cast<const uint8_t*>(plane);
  auto* ys = static_cast<const int32_t*>(y0);
  auto* xs = static_cast<const int32_t*>(x0);
  auto* sse = static_cast<int32_t*>(out_sse);
  auto* sad = static_cast<int32_t*>(out_sad);
  auto st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: launch_at<8>(s, p, pitch, ys, xs, sse, sad, b, c, st); break;
    case 16: launch_at<16>(s, p, pitch, ys, xs, sse, sad, b, c, st); break;
    case 32: launch_at<32>(s, p, pitch, ys, xs, sse, sad, b, c, st); break;
    case 64: launch_at<64>(s, p, pitch, ys, xs, sse, sad, b, c, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
