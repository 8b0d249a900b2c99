// Exhaustive full-pel SAD motion search, one CUDA block per image block.
//
// Replaces the Pallas kernel tpu_vp9/ops/pallas_kernels.py:sad_full_search
// (body _sad_search_kernel). For each of B blocks it evaluates every
// displacement (dy, dx) in [-r, r]^2 of an n x n source block against its
// (n+2r) x (n+2r) reference window, where displacement (0, 0) sits at
// window offset (r, r), and returns the best (dy, dx, sad). Ties go to the
// first candidate in dy-major order, as the Pallas kernel's per-row argmin
// followed by a strict '<' across rows does.
//
// What bounds it on an H100: integer ALU work on shared-memory operands.
// At 1080p with n=32, r=16 a frame has 1980 blocks x 1089 candidates x
// 1024 pixels, about 2.2e9 absolute differences, against about 10 MB of
// uint8 input (source blocks plus windows). The tensor cores (wgmma) do
// not apply: SAD is not a product. The design:
//   - one CTA per block; the source block and its window are copied once
//     into shared memory (5 KB at n=32, r=16), window rows padded to whole
//     32-bit words with one spare word;
//   - threads stride over the (2r+1)^2 candidates; each builds unaligned
//     4-byte window words with __funnelshift_r from two aligned shared
//     words and sums four absolute differences at once with __vsadu4,
//     accumulating in 32-bit (the largest SAD, 64*64*255, fits);
//   - a block reduction takes the minimum of the key (sad << 32 | index),
//     whose smallest value is the first minimum in dy-major order.
// Fusing the window gather into the kernel, and sharing source rows across
// candidates in registers, are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads)
sad_search_kernel(const uint8_t* __restrict__ src,
                  const uint8_t* __restrict__ reg, int r,
                  int32_t* __restrict__ out_dy, int32_t* __restrict__ out_dx,
                  int32_t* __restrict__ out_sad) {
  extern __shared__ uint32_t smem[];
  __shared__ unsigned long long warp_best[kThreads / 32];

  const int blk = blockIdx.x;
  const int win = N + 2 * r;
  const int d = 2 * r + 1;
  const int row_words = (win + 3) / 4 + 1;  // one spare word per row
  const int row_bytes = row_words * 4;

  uint32_t* s_src = smem;                    // N rows of N/4 words
  uint32_t* s_win = smem + N * (N / 4);      // win rows of row_words words
  uint8_t* s_src_b = reinterpret_cast<uint8_t*>(s_src);
  uint8_t* s_win_b = reinterpret_cast<uint8_t*>(s_win);

  const uint8_t* g_src = src + static_cast<size_t>(blk) * N * N;
  const uint8_t* g_reg = reg + static_cast<size_t>(blk) * win * win;
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) s_src_b[i] = g_src[i];
  for (int i = threadIdx.x; i < win * row_bytes; i += blockDim.x) {
    const int y = i / row_bytes;
    const int x = i - y * row_bytes;
    s_win_b[i] = x < win ? g_reg[y * win + x] : 0;
  }
  __syncthreads();

  unsigned long long best = ~0ull;
  for (int c = threadIdx.x; c < d * d; c += blockDim.x) {
    const int dy = c / d;
    const int dx = c - dy * d;
    const unsigned int shift = (dx & 3) * 8;
    unsigned int sad = 0;
    for (int y = 0; y < N; ++y) {
      const uint32_t* wrow = s_win + (dy + y) * row_words + (dx >> 2);
      const uint32_t* srow = s_src + y * (N / 4);
      uint32_t lo = wrow[0];
#pragma unroll
      for (int k = 0; k < N / 4; ++k) {
        const uint32_t hi = wrow[k + 1];
        sad += __vsadu4(__funnelshift_r(lo, hi, shift), srow[k]);
        lo = hi;
      }
    }
    const unsigned long long key =
        (static_cast<unsigned long long>(sad) << 32) | static_cast<unsigned>(c);
    best = key < best ? key : best;
  }

  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_down_sync(0xffffffffu, best, off);
    best = other < best ? other : best;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w)
      best = warp_best[w] < best ? warp_best[w] : best;
    const int idx = static_cast<int>(best & 0xffffffffu);
    out_dy[blk] = idx / d - r;
    out_dx[blk] = idx % d - r;
    out_sad[blk] = static_cast<int32_t>(best >> 32);
  }
}

template <int N>
void launch(const uint8_t* src, const uint8_t* reg, int32_t* dy, int32_t* dx,
            int32_t* sad, int b, int r, cudaStream_t stream) {
  const int win = N + 2 * r;
  const size_t smem = static_cast<size_t>(N) * N +
                      static_cast<size_t>(win) * (((win + 3) / 4 + 1) * 4);
  sad_search_kernel<N><<<b, kThreads, smem, stream>>>(src, reg, r, dy, dx, sad);
}

}  // namespace

// src: (b, n, n) uint8, reg: (b, n+2r, n+2r) uint8, both contiguous on the
// device; out_dy, out_dx, out_sad: (b,) int32. The caller has checked
// n in {8, 16, 32, 64}, 1 <= r <= 32 and b >= 1. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int sad_full_search_launch(const void* src, const void* reg,
                                      void* out_dy, void* out_dx,
                                      void* out_sad, int b, int n, int r,
                                      void* stream) {
  const auto* s = static_cast<const uint8_t*>(src);
  const auto* g = static_cast<const uint8_t*>(reg);
  auto* dy = static_cast<int32_t*>(out_dy);
  auto* dx = static_cast<int32_t*>(out_dx);
  auto* sad = static_cast<int32_t*>(out_sad);
  auto st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: launch<8>(s, g, dy, dx, sad, b, r, st); break;
    case 16: launch<16>(s, g, dy, dx, sad, b, r, st); break;
    case 32: launch<32>(s, g, dy, dx, sad, b, r, st); break;
    case 64: launch<64>(s, g, dy, dx, sad, b, r, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
