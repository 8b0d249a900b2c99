// The step's per-frame scalars as the kernels read them: one int32 row on
// the device (pipeline/tpu_encdec.py: step_scalars; ops/cuda_kernels.py:
// STEP_SCALARS names the same words in the same order), which the caller
// refills in place on the step's stream before each frame. A kernel takes
// the row's pointer where it took these values as launch arguments, so
// that every launch word of a step is the same from frame to frame. The
// values are checked on the host while they are still host ints; a kernel
// reads them as they are.
#pragma once

namespace step_row {

constexpr int kDcQ = 0;      // the DC quantizer step
constexpr int kAcQ = 1;      // the AC quantizer step
constexpr int kLam = 2;      // the mode decisions' lambda
constexpr int kLfLvl = 3;    // the loop filter's level, 0 leaves it off
constexpr int kLfLim = 4;    // its interior limit
constexpr int kLfMblim = 5;  // its edge limit
constexpr int kWords = 6;

}  // namespace step_row
