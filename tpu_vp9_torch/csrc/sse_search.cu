// Exhaustive full-pel SSE motion search with an optional relative-SSE map,
// one CUDA block per image block.
//
// Replaces tpu_vp9/pipeline/tpu_encdec.py:_full_search_sse_mxu, the XLA
// search that both levels of hier_search run: the 2x-decimated level
// (windows summed over 2x2, values <= 1020, int16; n=16, r=18, D=37) and
// the full-resolution refine (uint8; n=32, r=4, D=9). For each of B
// blocks it evaluates every displacement (dy, dx) in [-r, r]^2 of an
// n x n source block against its window. A window is (n+2r+8)^2 and its
// search area starts at offset (4, 4), so displacement (0, 0) sits at
// (r+4, r+4). It returns the first minimum in dy-major order, and, when
// asked, the (B, D, D) int32 relative-SSE map sum(reg^2) - 2 sum(src*reg),
// which is the true SSE minus the block's sum(src^2).
//
// Exactness: every sum is an integer sum. The true SSE of a candidate is
// at most n*n*1020^2 < 2^31 and is never negative, so the CTA reduces the
// unsigned key (sse << 32) | flat_index, whose minimum is the first
// minimum; the relative SSE, often negative, is only ever written to the
// map (sse - sum(src^2)), never fed to the key.
//
// What bounds it on an H100: integer multiply-adds on shared-memory
// operands. At 1080p the half-res level is 2040*37^2*16^2 = 7.1e8 and the
// refine 2040*9^2*32^2 = 1.7e8 multiply-adds, on under 20 MB of input.
// The TPU version packs dy shifts into f32 matmuls for its matrix unit;
// that is not carried over: half-res values need 10 bits, past wgmma's
// 8-bit integer inputs, and this first kernel stays on the integer ALU.
// The design:
//   - the source block and the search area are copied once into shared
//     memory as int32 (at most 48 KB; the wrapper checks it);
//   - threads stride over the D*D candidates, so neighbouring threads read
//     neighbouring area words (no bank conflicts) and the same source word
//     (a broadcast);
//   - sum(src^2) is reduced with one shared atomic per warp before the
//     candidates, so each thread can write its map entries directly;
//   - a block reduction takes the minimum key, as csrc/sad_search.cu does.
// Sharing source rows across candidates in registers, and fusing the
// window gather, are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

template <typename T, int N>
__global__ void __launch_bounds__(kMaxThreads)
sse_search_kernel(const T* __restrict__ src, const T* __restrict__ wins,
                  int r, int sw, int32_t* __restrict__ out_dy,
                  int32_t* __restrict__ out_dx,
                  int32_t* __restrict__ out_map) {
  extern __shared__ int32_t smem[];
  __shared__ unsigned long long warp_best[kMaxThreads / 32];
  __shared__ unsigned int s_src2;

  const int blk = blockIdx.x;
  const int w = N + 2 * r;
  const int d = 2 * r + 1;
  int32_t* s_src = smem;           // N x N
  int32_t* s_area = smem + N * N;  // w x w

  if (threadIdx.x == 0) s_src2 = 0;
  __syncthreads();

  const T* g_src = src + static_cast<size_t>(blk) * N * N;
  const T* g_win = wins + static_cast<size_t>(blk) * sw * sw;
  unsigned int sq = 0;
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int v = static_cast<int>(g_src[i]);
    s_src[i] = v;
    sq += static_cast<unsigned int>(v * v);
  }
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
    const int y = i / w;
    const int x = i - y * w;
    s_area[i] = static_cast<int>(g_win[(y + 4) * sw + x + 4]);
  }
  for (int off = 16; off > 0; off >>= 1)
    sq += __shfl_down_sync(0xffffffffu, sq, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s_src2, sq);
  __syncthreads();
  const unsigned int src2 = s_src2;

  unsigned long long best = ~0ull;
  for (int c = threadIdx.x; c < d * d; c += blockDim.x) {
    const int dy = c / d;
    const int dx = c - dy * d;
    unsigned int sse = 0;
    for (int y = 0; y < N; ++y) {
      const int32_t* a = s_area + (dy + y) * w + dx;
      const int32_t* s = s_src + y * N;
#pragma unroll
      for (int x = 0; x < N; ++x) {
        const int e = a[x] - s[x];
        sse += static_cast<unsigned int>(e * e);
      }
    }
    if (out_map != nullptr)
      out_map[static_cast<size_t>(blk) * d * d + c] =
          static_cast<int32_t>(sse - src2);
    const unsigned long long key =
        (static_cast<unsigned long long>(sse) << 32) | static_cast<unsigned>(c);
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
    for (int i = 1; i < static_cast<int>(blockDim.x) / 32; ++i)
      best = warp_best[i] < best ? warp_best[i] : best;
    const int idx = static_cast<int>(best & 0xffffffffu);
    out_dy[blk] = idx / d - r;
    out_dx[blk] = idx % d - r;
  }
}

template <typename T, int N>
void launch(const void* src, const void* wins, int32_t* dy, int32_t* dx,
            int32_t* map, int b, int r, int sw, cudaStream_t stream) {
  const int w = N + 2 * r;
  const int d = 2 * r + 1;
  int threads = (d * d + 31) / 32 * 32;
  threads = threads < kMaxThreads ? threads : kMaxThreads;
  const size_t smem = static_cast<size_t>(N * N + w * w) * sizeof(int32_t);
  sse_search_kernel<T, N><<<b, threads, smem, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(wins), r, sw, dy, dx,
      map);
}

template <typename T>
int dispatch(const void* src, const void* wins, int32_t* dy, int32_t* dx,
             int32_t* map, int b, int n, int r, int sw, cudaStream_t st) {
  switch (n) {
    case 8: launch<T, 8>(src, wins, dy, dx, map, b, r, sw, st); break;
    case 16: launch<T, 16>(src, wins, dy, dx, map, b, r, sw, st); break;
    case 32: launch<T, 32>(src, wins, dy, dx, map, b, r, sw, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: (b, n, n), wins: (b, sw, sw) with sw = n + 2r + 8, both contiguous
// on the device and of one element type: uint8 (elem_bytes 1) or int16
// holding values in [0, 1020] (elem_bytes 2). out_dy, out_dx: (b,) int32;
// out_map: (b, 2r+1, 2r+1) int32, or null to skip the map. The caller has
// checked n in {8, 16, 32}, the shared-memory size and b >= 1. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int sse_map_search_launch(const void* src, const void* wins,
                                     void* out_dy, void* out_dx,
                                     void* out_map, int b, int n, int r,
                                     int sw, int elem_bytes, void* stream) {
  auto* dy = static_cast<int32_t*>(out_dy);
  auto* dx = static_cast<int32_t*>(out_dx);
  auto* map = static_cast<int32_t*>(out_map);
  auto st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    return dispatch<uint8_t>(src, wins, dy, dx, map, b, n, r, sw, st);
  if (elem_bytes == 2)
    return dispatch<int16_t>(src, wins, dy, dx, map, b, n, r, sw, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
