// The 8-tap subpel filter of VP9's inter prediction as __device__
// functions, shared by the kernels that interpolate reference pixels:
// csrc/subpel_search.cu's phase planes (the phases 0, 4, 8 and 12) and
// csrc/mc_predict.cu's motion compensation (every phase, 0 to 15).
// One output is libvpx's convolve: the eight taps of a phase of
// bitstream/tables.py:subpel_filters (they sum to 128) against eight
// neighbours along a row or a column, then clamp((acc + 64) >> 7, 0, 255),
// in int32; an H pass into 8-bit intermediates, then a V pass over them,
// as tpu_vp9_torch/pipeline/tpu_encdec.py:_conv8 computes it.
//
// A phase's taps are held in two registers of signed bytes (every tap of
// the 8-tap kinds but phase 0's 128 lies in [-24, 127]; each kernel's
// wrapper checks the phases it filters, ops/cuda_kernels.py:
// _eighttap_taps), and eight pixels as two words of four bytes, so that
// one output is two dp4a (four byte products summed into an int32, exact)
// with no load of a tap. Phase 0 is [0, 0, 0, 128, 0, 0, 0, 0], whose
// output is the pixel under tap 3: a caller reads it, it does not filter.
#pragma once

#include <cstdint>

namespace conv8 {

constexpr int kTaps = 8;
constexpr int kRound = 64;  // libvpx's rounding of a sum back to a pixel
constexpr int kShift = 7;

// c + the four products of the bytes of a (unsigned) and b (signed), and
// c + those of two unsigned words. A build of the sources off the card (a
// stand-in header that defines CONV8_DP4A_STANDIN) supplies its own.
#ifndef CONV8_DP4A_STANDIN
__device__ __forceinline__ int dp4a_us(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t dp4a_uu(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("dp4a.u32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
#endif

// The low bytes of a, b, c, d as one word, a in byte 0.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// A phase's eight taps as two words of signed bytes: taps 0-3, taps 4-7.
__device__ __forceinline__ void pack_taps(const int* taps, uint32_t& lo,
                                          uint32_t& hi) {
  lo = pack4(taps[0], taps[1], taps[2], taps[3]);
  hi = pack4(taps[4], taps[5], taps[6], taps[7]);
}

// The eight bytes that start sh bytes (0..3) into the aligned words
// w0, w1, w2, as two words: lo holds bytes 0-3, hi bytes 4-7.
__device__ __forceinline__ void bytes8(uint32_t w0, uint32_t w1, uint32_t w2,
                                       int sh, uint32_t& lo, uint32_t& hi) {
  lo = __funnelshift_r(w0, w1, 8 * sh);
  hi = __funnelshift_r(w1, w2, 8 * sh);
}

// One output of the 8-tap filter on eight packed pixels (lo: pixels 0-3,
// hi: 4-7, pixel k in byte k % 4) and a phase's packed taps, as an int in
// [0, 255].
__device__ __forceinline__ int tap8_packed(uint32_t lo, uint32_t hi,
                                           uint32_t taps_lo,
                                           uint32_t taps_hi) {
  const int v = dp4a_us(hi, taps_hi, dp4a_us(lo, taps_lo, kRound)) >> kShift;
  return min(max(v, 0), 255);
}

}  // namespace conv8
