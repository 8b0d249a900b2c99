// Stand-ins for the CUDA names a kernel of tpu_vp9_torch/csrc uses, so that
// g++ can build its device code for the host and run it: every CUDA thread
// of a CTA is a std::thread, the CTAs of a grid run one after another,
// __syncthreads is a barrier of the CTA and __syncwarp one of the warp, and
// a warp's shuffles and float64 mma (txfm::mma_f64_8x8x4, in the PTX
// fragment layout of m8n8k4) go through an exchange area and a barrier of
// the warp. The byte intrinsics (__byte_perm, __funnelshift_r,
// __vabsdiffu4) and dp4a (conv8::dp4a_us, conv8::dp4a_uu) are written out
// from their definitions in the PTX and CUDA manuals. Shared memory is one
// static buffer (the CTAs do not overlap), filled with 0xA5 before each
// CTA, so that a read of a place the CTA did not write shows.
// Build with -std=c++20 (for std::barrier), -fwrapv (int32 arithmetic
// wraps as on the card) and -ffp-contract=off (no fused multiply-add the
// source did not write).
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define TXFM_MMA_STANDIN 1
#define CONV8_DP4A_STANDIN 1
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __restrict__ __restrict

using std::fabs;
using std::floor;
using std::fma;
using std::fmin;
using std::max;
using std::min;
using std::rint;

struct uint4 { unsigned x, y, z, w; };
struct uchar4 { unsigned char x, y, z, w; };
struct alignas(16) double2 { double x, y; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline double2 make_double2(double a, double b) { return {a, b}; }
template <class T>
T __ldg(const T* p) { return *p; }

// one rounding each, as the intrinsics promise
inline double __dmul_rn(double a, double b) {
  volatile double r = a * b;
  return r;
}
inline double __dadd_rn(double a, double b) {
  volatile double r = a + b;
  return r;
}
inline long long __double_as_longlong(double d) {
  long long v;
  std::memcpy(&v, &d, 8);
  return v;
}
inline double __longlong_as_double(long long v) {
  double d;
  std::memcpy(&d, &v, 8);
  return d;
}

struct StandinDim { unsigned x = 1, y = 1, z = 1; };
inline thread_local StandinDim threadIdx, blockIdx;
inline StandinDim gridDim;

constexpr int kStandinSmemBytes = 1 << 17;
alignas(16) inline unsigned char standin_smem[kStandinSmemBytes];

struct StandinCta {
  std::unique_ptr<std::barrier<>> cta;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  double xa[32][32], xb[32][32];
  int xi[32][32];
};
inline StandinCta* standin_cta;

inline void __syncthreads() { standin_cta->cta->arrive_and_wait(); }
inline void standin_warp_sync(int w) { standin_cta->warp[w]->arrive_and_wait(); }

inline void __syncwarp() { standin_warp_sync(threadIdx.x / 32); }

template <class T>
T __shfl_xor_sync(unsigned, T v, int off) {
  static_assert(sizeof(T) == 4, "a 32-bit value");
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  std::memcpy(&standin_cta->xi[w][l], &v, 4);
  standin_warp_sync(w);
  T r;
  std::memcpy(&r, &standin_cta->xi[w][l ^ off], 4);
  standin_warp_sync(w);
  return r;
}

// byte n of the result is byte ((s >> 4n) & 7) of y:x (x bytes 0-3)
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t in = (static_cast<uint64_t>(y) << 32) | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n) {
    r |= static_cast<unsigned>((in >> (8 * ((s >> (4 * n)) & 7))) & 255)
         << (8 * n);
  }
  return r;
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  const uint64_t in = (static_cast<uint64_t>(hi) << 32) | lo;
  return static_cast<unsigned>(in >> (shift & 31));
}
inline unsigned __vabsdiffu4(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int n = 0; n < 4; ++n) {
    const int d = static_cast<int>((a >> (8 * n)) & 255) -
                  static_cast<int>((b >> (8 * n)) & 255);
    r |= static_cast<unsigned>(d < 0 ? -d : d) << (8 * n);
  }
  return r;
}

namespace conv8 {
// c + the products of the unsigned bytes of a and the signed bytes of b
inline int dp4a_us(uint32_t a, uint32_t b, int c) {
  for (int n = 0; n < 4; ++n) {
    c += static_cast<int>((a >> (8 * n)) & 255) *
         static_cast<int>(static_cast<int8_t>((b >> (8 * n)) & 255));
  }
  return c;
}
inline uint32_t dp4a_uu(uint32_t a, uint32_t b, uint32_t c) {
  for (int n = 0; n < 4; ++n) {
    c += ((a >> (8 * n)) & 255) * ((b >> (8 * n)) & 255);
  }
  return c;
}
}  // namespace conv8

namespace txfm {
// d += A @ B for an 8x8x4 tile, one lane's part: a = A[l >> 2][l & 3],
// b = B[l & 3][l >> 2], (d0, d1) = D[l >> 2][2 (l & 3) + {0, 1}]
inline void mma_f64_8x8x4(double& d0, double& d1, double a, double b) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  standin_cta->xa[w][l] = a;
  standin_cta->xb[w][l] = b;
  standin_warp_sync(w);
  const int g = l >> 2, c = l & 3;
  double* d[2] = {&d0, &d1};
  for (int e = 0; e < 2; ++e) {
    double acc = *d[e];
    for (int k = 0; k < 4; ++k) {
      acc += standin_cta->xa[w][4 * g + k] *
             standin_cta->xb[w][4 * (2 * c + e) + k];
    }
    *d[e] = acc;
  }
  standin_warp_sync(w);
}
}  // namespace txfm

typedef int cudaError_t;
typedef void* cudaStream_t;
inline cudaError_t cudaGetLastError() { return 0; }

// Run body() as `grid` CTAs of `threads` threads (a multiple of 32, at
// most 1024), one CTA after another.
template <class F>
void standin_launch(int grid, int threads, F body) {
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {
    StandinCta cta;
    cta.cta = std::make_unique<std::barrier<>>(threads);
    for (int w = 0; w < threads / 32; ++w) {
      cta.warp.push_back(std::make_unique<std::barrier<>>(32));
    }
    standin_cta = &cta;
    std::memset(standin_smem, 0xA5, kStandinSmemBytes);
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) {
      pool.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        body();
      });
    }
    for (auto& th : pool) th.join();
  }
}
