// The 8-tap subpel filter of VP9's inter prediction as __device__
// functions, shared by the kernels that interpolate reference pixels
// (csrc/subpel_search.cu's phase planes; the step's motion compensation,
// pipeline/tpu_encdec.py:mc_predict_from_wins, is to include it too).
// One output is libvpx's convolve: the eight taps of a phase of
// bitstream/tables.py:subpel_filters (they sum to 128) against eight
// neighbours along a row or a column, then clamp((acc + 64) >> 7, 0, 255),
// in int32; an H pass into 8-bit intermediates, then a V pass over them,
// as tpu_vp9_torch/pipeline/tpu_encdec.py:_conv8 computes it.
#pragma once

#include <cstdint>

namespace conv8 {

constexpr int kTaps = 8;
constexpr int kRound = 64;
constexpr int kShift = 7;

// libvpx's rounding of a filter sum back to a pixel.
__device__ __forceinline__ uint8_t round_clip(int acc) {
  const int v = (acc + kRound) >> kShift;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// One output of the 8-tap filter: taps[k] against x[k * stride], k = 0..7
// (stride 1 along a row, the row pitch along a column).
__device__ __forceinline__ uint8_t tap8(const uint8_t* x, int stride,
                                        const int* taps) {
  int acc = 0;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    acc += static_cast<int>(x[k * stride]) * taps[k];
  }
  return round_clip(acc);
}

}  // namespace conv8
