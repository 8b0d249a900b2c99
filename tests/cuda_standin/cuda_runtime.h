// Stand-ins for the CUDA names a kernel of tpu_vp9_torch/csrc uses, so that
// g++ can build its device code for the host and run it: every CUDA thread
// of a CTA is a std::thread, __syncthreads is a barrier of the CTA and
// __syncwarp one of the warp, and a warp's shuffles and float64 mma
// (txfm::mma_f64_8x8x4, in the PTX fragment layout of m8n8k4) go through an
// exchange area and a barrier of the warp. The byte intrinsics
// (__byte_perm, __funnelshift_r, __vabsdiffu4) and dp4a (__dp4a,
// conv8::dp4a_us, conv8::dp4a_uu) are written out from their definitions
// in the PTX and CUDA manuals; the float32 intrinsics that round once
// (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn, the integer and float64
// conversions) as single IEEE operations, and __trap as a recorded failure. standin_launch runs
// the CTAs of a grid one after another; standin_launch_all runs them all at once (each with its
// own shared buffer and exchange area), for a kernel whose CTAs wait on
// each other:
// the relaxed loads and stores at the card's scope (KF_SYNC_STANDIN) and
// atomicAdd are C++ atomics, __nanosleep a yield, bar_sync (bar.sync with
// a barrier number) a barrier of that many threads of the CTA, and the
// redux.sync reductions and the float64 mma of m16n8k16 go through the
// warp's exchange area like the shuffles. Shared memory (standin_smem,
// the running thread's CTA's buffer) is filled with 0xA5 before each CTA,
// so that a read of a place the CTA did not write shows.
// The runtime calls a launcher makes (cudaGetDevice, cudaDeviceGetAttribute,
// cudaFuncSetAttribute, the occupancy query; cudaMemsetAsync sets the
// bytes at once) answer from a few settable
// globals (standin_device, standin_smem_optin, standin_set_attribute_error),
// and standin_kernel_launch stands for a <<<grid, threads, smem>>> launch:
// it refuses, as the runtime does, dynamic shared memory past 48 KB that
// the kernel was not opted in to, and cudaGetLastError reports that.
// Build with -std=c++20 (for std::barrier), -fwrapv (int32 arithmetic
// wraps as on the card) and -ffp-contract=off (no fused multiply-add the
// source did not write).
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define TXFM_MMA_STANDIN 1
#define CONV8_DP4A_STANDIN 1
#define KF_SYNC_STANDIN 1
#define __global__
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __restrict__ __restrict
#define __grid_constant__

using std::fabs;
using std::floor;
using std::fma;
using std::fmin;
using std::max;
using std::min;
using std::rint;

struct uint2 { unsigned x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
struct uchar4 { unsigned char x, y, z, w; };
struct alignas(16) double2 { double x, y; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
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
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}
inline float __fsub_rn(float a, float b) {
  volatile float r = a - b;
  return r;
}
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fdiv_rn(float a, float b) {
  volatile float r = a / b;
  return r;
}
// integer to float32, rounded to nearest even (the default mode)
inline float __int2float_rn(int v) { return static_cast<float>(v); }
// float64 to float32, rounded to nearest even
inline float __double2float_rn(double v) { return static_cast<float>(v); }
inline float __ll2float_rn(long long v) { return static_cast<float>(v); }
// a + b rounded toward minus infinity
inline double __dadd_rd(double a, double b) {
  std::fesetround(FE_DOWNWARD);
  volatile double r = a + b;
  std::fesetround(FE_TONEAREST);
  return r;
}
inline int __double2loint(double d) {
  uint64_t v;
  std::memcpy(&v, &d, 8);
  return static_cast<int>(static_cast<uint32_t>(v));
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
inline StandinDim gridDim, blockDim;

inline unsigned __float_as_uint(float f) {
  unsigned v;
  std::memcpy(&v, &f, 4);
  return v;
}
inline float __int_as_float(int v) {
  float f;
  std::memcpy(&f, &v, 4);
  return f;
}

constexpr int kStandinSmemBytes = 1 << 17;

struct StandinCta {
  std::unique_ptr<std::barrier<>> cta;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  double xa[32][32], xb[32][32];
  double xa8[32][32][8], xb4[32][32][4];
  int xi[32][32];
  unsigned long long xl[32][32];
  alignas(16) unsigned char smem[kStandinSmemBytes];
  // named barriers 1-15, each made at its first use with its count
  std::unique_ptr<std::barrier<>> named[16];
  std::mutex named_mu;
};
// the running thread's CTA and its shared memory
inline thread_local StandinCta* standin_cta;
inline thread_local unsigned char* standin_smem;

inline void __syncthreads() { standin_cta->cta->arrive_and_wait(); }
inline void standin_warp_sync(int w) { standin_cta->warp[w]->arrive_and_wait(); }

inline void __syncwarp() { standin_warp_sync(threadIdx.x / 32); }

// bar.sync id, count: a barrier of `count` threads of the CTA
inline void bar_sync(int id, int count) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lock(standin_cta->named_mu);
    auto& slot = standin_cta->named[id];
    if (!slot) slot = std::make_unique<std::barrier<>>(count);
    b = slot.get();
  }
  b->arrive_and_wait();
}

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

// redux.sync: the warp's sum, maximum or minimum of a 32-bit int
template <class F>
inline int standin_reduce(int v, F op) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  standin_cta->xi[w][l] = v;
  standin_warp_sync(w);
  int r = standin_cta->xi[w][0];
  for (int k = 1; k < 32; ++k) r = op(r, standin_cta->xi[w][k]);
  standin_warp_sync(w);
  return r;
}
inline int __reduce_add_sync(unsigned, int v) {
  return standin_reduce(v, [](int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
  });
}
inline int __reduce_max_sync(unsigned, int v) {
  return standin_reduce(v, [](int a, int b) { return a > b ? a : b; });
}
inline int __reduce_min_sync(unsigned, int v) {
  return standin_reduce(v, [](int a, int b) { return a < b ? a : b; });
}

inline bool __all_sync(unsigned, bool v) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  standin_cta->xi[w][l] = v;
  standin_warp_sync(w);
  bool all = true;
  for (int k = 0; k < 32; ++k) all = all && standin_cta->xi[w][k] != 0;
  standin_warp_sync(w);
  return all;
}

// lane l gets lane l + off's value, its own where l + off is past the warp
template <class T>
T __shfl_down_sync(unsigned, T v, int off) {
  static_assert(sizeof(T) <= 8, "a value of at most 64 bits");
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  std::memcpy(&standin_cta->xl[w][l], &v, sizeof(T));
  standin_warp_sync(w);
  T r;
  std::memcpy(&r, &standin_cta->xl[w][l + off < 32 ? l + off : l],
              sizeof(T));
  standin_warp_sync(w);
  return r;
}

template <class T>
T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) == 4, "a 32-bit value");
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  std::memcpy(&standin_cta->xi[w][l], &v, 4);
  standin_warp_sync(w);
  T r;
  std::memcpy(&r, &standin_cta->xi[w][src & 31], 4);
  standin_warp_sync(w);
  return r;
}

// the kernels' global-memory synchronisation, as C++ atomics
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
inline int ld_relaxed_gpu(const int* p) {
  return std::atomic_ref<int>(*const_cast<int*>(p))
      .load(std::memory_order_relaxed);
}
inline void st_relaxed_gpu(int* p, int v) {
  std::atomic_ref<int>(*p).store(v, std::memory_order_relaxed);
}
inline unsigned long long ld_relaxed_gpu64(const unsigned long long* p) {
  return std::atomic_ref<unsigned long long>(
             *const_cast<unsigned long long*>(p))
      .load(std::memory_order_relaxed);
}
inline void st_relaxed_gpu64(unsigned long long* p, unsigned long long v) {
  std::atomic_ref<unsigned long long>(*p).store(v,
                                                std::memory_order_relaxed);
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

// dp4a on unsigned bytes: c + the products of the four bytes of a and b
inline unsigned __dp4a(unsigned a, unsigned b, unsigned c) {
  for (int n = 0; n < 4; ++n) {
    c += ((a >> (8 * n)) & 255) * ((b >> (8 * n)) & 255);
  }
  return c;
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

// d += A @ B for a 16x8x16 tile, one lane's part: g = l >> 2, t = l & 3,
// a[i] = A[g + 8 (i & 1)][t + 4 (i >> 1)], b[i] = B[t + 4 i][g],
// d[e] = D[g + 8 (e >> 1)][2 t + (e & 1)]; the 16 products summed in order
inline void mma_f64_16x8x16(double (&d)[4], const double (&a)[8],
                            const double (&b)[4]) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  std::memcpy(standin_cta->xa8[w][l], a, sizeof(a));
  std::memcpy(standin_cta->xb4[w][l], b, sizeof(b));
  standin_warp_sync(w);
  const int g = l >> 2, t = l & 3;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    double acc = d[e];
    for (int k = 0; k < 16; ++k) {
      acc += standin_cta->xa8[w][4 * (row & 7) + (k & 3)]
                             [(row >> 3) + 2 * (k >> 2)] *
             standin_cta->xb4[w][4 * col + (k & 3)][k >> 2];
    }
    d[e] = acc;
  }
  standin_warp_sync(w);
}
}  // namespace txfm

typedef int cudaError_t;
typedef void* cudaStream_t;
enum : int {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorInvalidDevice = 101,
  cudaErrorLaunchFailure = 719,
};

// __trap: on the card the launch fails (the next synchronisation reports
// it); here the call is recorded for standin_take_trap and the kernel
// returns after it, as the sources' do
inline std::atomic<int> standin_trapped{0};
inline void __trap() { standin_trapped.store(1); }
// cudaErrorLaunchFailure if a kernel trapped since the last call, else 0
inline cudaError_t standin_take_trap() {
  return standin_trapped.exchange(0) ? cudaErrorLaunchFailure : cudaSuccess;
}
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97,
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

// the device a launcher finds current, its sharedMemPerBlockOptin (an
// H100's 227 KB), what cudaFuncSetAttribute returns (0: it sets the
// attribute) and how often it was called, each kernel's opted-in dynamic
// shared memory, and the error the next cudaGetLastError reports
inline int standin_device = 0;
inline int standin_smem_optin = 227 * 1024;
inline int standin_set_attribute_error = 0;
inline int standin_set_attribute_calls = 0;
inline std::map<const void*, int> standin_allowed_smem;
inline cudaError_t standin_last_error = 0;

inline cudaError_t cudaGetLastError() {
  const cudaError_t e = standin_last_error;
  standin_last_error = 0;
  return e;
}
// the stream's memset, done at once (the stand-in's launches are
// synchronous, so it is ordered before the next one as on the stream)
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = standin_device;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr attr, int) {
  *v = attr == cudaDevAttrMaxSharedMemoryPerBlockOptin ? standin_smem_optin
                                                       : 132;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F* kernel, cudaFuncAttribute, int bytes) {
  ++standin_set_attribute_calls;
  if (standin_set_attribute_error) return standin_set_attribute_error;
  if (bytes > standin_smem_optin) return cudaErrorInvalidValue;
  standin_allowed_smem[reinterpret_cast<const void*>(kernel)] = bytes;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* ctas, F*, int,
                                                          size_t) {
  *ctas = 1;
  return cudaSuccess;
}

// One CTA's threads, started: each sets its thread and block index and
// its CTA, then runs body().
template <class F>
void standin_start(StandinCta& cta, int b, int threads, F& body,
                   std::vector<std::thread>& pool) {
  cta.cta = std::make_unique<std::barrier<>>(threads);
  for (int w = 0; w < threads / 32; ++w) {
    cta.warp.push_back(std::make_unique<std::barrier<>>(32));
  }
  std::memset(cta.smem, 0xA5, kStandinSmemBytes);
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&cta, &body, b, t] {
      threadIdx.x = t;
      blockIdx.x = b;
      standin_cta = &cta;
      standin_smem = cta.smem;
      body();
    });
  }
}

// Run body() as `grid` CTAs of `threads` threads (a multiple of 32, at
// most 1024), one CTA after another.
template <class F>
void standin_launch(int grid, int threads, F body) {
  gridDim.x = grid;
  blockDim.x = threads;
  for (int b = 0; b < grid; ++b) {
    auto cta = std::make_unique<StandinCta>();
    std::vector<std::thread> pool;
    standin_start(*cta, b, threads, body, pool);
    for (auto& th : pool) th.join();
  }
}

// Run body() as `grid` CTAs of `threads` threads, all at once.
template <class F>
void standin_launch_all(int grid, int threads, F body) {
  gridDim.x = grid;
  blockDim.x = threads;
  std::vector<std::unique_ptr<StandinCta>> ctas;
  std::vector<std::thread> pool;
  for (int b = 0; b < grid; ++b) {
    ctas.push_back(std::make_unique<StandinCta>());
    standin_start(*ctas.back(), b, threads, body, pool);
  }
  for (auto& th : pool) th.join();
}

// kernel<<<grid, threads, smem>>>(...) with body() the kernel's call:
// refused (the error for the next cudaGetLastError, nothing run) where
// smem is past the 48 KB a kernel has without asking and past what the
// kernel was opted in to; else standin_launch
template <class K, class F>
void standin_kernel_launch(K* kernel, int grid, int threads, size_t smem,
                           F body) {
  const auto it =
      standin_allowed_smem.find(reinterpret_cast<const void*>(kernel));
  const size_t allowed =
      std::max<size_t>(48 * 1024, it == standin_allowed_smem.end()
                                      ? 0 : static_cast<size_t>(it->second));
  if (smem > allowed || smem > static_cast<size_t>(kStandinSmemBytes)) {
    standin_last_error = cudaErrorInvalidValue;
    return;
  }
  standin_launch(grid, threads, body);
}
