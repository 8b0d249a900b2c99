// The port's intra predictors and mode prior as __device__ functions,
// shared by the kernels that choose intra modes: csrc/kframe_wave.cu (the
// keyframe's closed-loop wavefront, from the recon) and
// csrc/openloop_modes.cu (the open-loop keyframe hints, from the source).
// They compute what tpu_vp9_torch/ops/intra.py computes on a block's
// reference vector [left n, above-left, above n, above-right n]: DC with
// the edges' availability, TM, and the eight directional modes (V, H and
// the six diagonals) from packed words of that module's index and weight
// maps (ops/cuda_kernels.py:_kf_dir_words). The caller deals pixels and
// words to its threads; the warp reductions sum and compare a mode's
// numbers across a warp.
#pragma once

namespace intra_pred {

// the intra modes of a block, in IntraMode order (DC, V, H, D45, D135,
// D117, D153, D207, D63, TM)
constexpr int kModes = 10;

// warp reductions of int32 on one redux.sync each (sm_80 and later)
__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(0xffffffffu, v);
}
__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(0xffffffffu, v);
}
__device__ __forceinline__ int warp_min(int v) {
  return __reduce_min_sync(0xffffffffu, v);
}

// the keyframe's mode prior in lambda units (ops/cuda_kernels.py:
// KF_MODE_BIAS): 0 for DC, 1 for V, H and TM, 3 for the diagonals
__device__ __forceinline__ int mode_bias(int m) {
  return m == 0 ? 0 : (m == 1 || m == 2 || m == kModes - 1 ? 1 : 3);
}

// DC of an n x n block (n = 1 << lg) from the sum of its available edges
__device__ __forceinline__ int dc_of(int sum, bool ha, bool hl, int lg) {
  const int n = 1 << lg;
  if (ha && hl) return (sum + n) >> (lg + 1);
  if (ha || hl) return (sum + (n >> 1)) >> lg;
  return 128;
}

// A directional mode's prediction from its packed word w: the three taps'
// indices into the reference vector in bits 0-6, 7-13, 14-20, their
// weights in bits 21-23, 24-26, 27-29
__device__ __forceinline__ int filt(unsigned w, const int* ref) {
  const int sum = static_cast<int>((w >> 21) & 7) * ref[w & 127] +
                  static_cast<int>((w >> 24) & 7) * ref[(w >> 7) & 127] +
                  static_cast<int>((w >> 27) & 7) * ref[(w >> 14) & 127];
  return (sum + 2) >> 2;
}

// TM's prediction of pixel (y, x) of an n x n block from its reference
// vector
__device__ __forceinline__ int tm_pred(const int* ref, int n, int y, int x) {
  const int v = ref[y] + ref[n + 1 + x] - ref[n];
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

}  // namespace intra_pred
