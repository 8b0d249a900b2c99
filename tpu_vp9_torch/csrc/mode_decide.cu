// The mode decision of one zone of the realtime P-frame step as a launch
// of its own: LAST's five candidates, GOLDEN's two, ALTREF's two and the
// reference choice (decide.cuh: decide::zone, which mc_predict.cu's zone
// instance runs at the head of its motion compensation; the step launches
// that one), a warp per block, four a CTA.
//
// Replaces the XLA stages of tpu_vp9/pipeline/tpu_encdec.py: _ssem_gather
// (:1390), _candidate_decide (:1407) and the GOLDEN and ALTREF blocks of
// encode_zone (:1661-1756). The contract is the plain version beside the
// step, tpu_vp9_torch/pipeline/tpu_encdec.py: mode_decide_ref.
//
// What bounds it on an H100: the launch. At 1080p M8 (B = 2040) it reads
// about 50 bytes a block besides one map entry for each of PREV, LEFT and
// ABOVE (each its own 32-byte sector) and writes 9: about 0.3 MB, 0.1 us
// at HBM speed. The rate scalars come from the device row that
// upload_rate_tabs writes once a frame, so the launch takes no copy.

#include <cstdint>
#include <cuda_runtime.h>

#include "decide.cuh"

namespace {

constexpr int kWarps = 4;  // a warp per block (decide::zone), four a CTA
constexpr int kThreads = 32 * kWarps;

// The decision's inputs (decide.cuh) and the launch's outputs.
struct MdArgs : decide::Zone {
  int* mv;          // (2, B): rows, then columns
  int8_t* ref_sel;  // (B,)
};

__global__ void __launch_bounds__(kThreads) mode_decide_kernel(MdArgs a) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  if (i >= a.b) return;  // the whole warp
  const decide::Choice ch = decide::zone(a, i, lane);
  if (!ch.ok || lane != 0) return;
  a.mv[i] = ch.r;
  a.mv[a.b + i] = ch.c;
  a.ref_sel[i] = static_cast<int8_t>(ch.ref);
}

cudaError_t launch_md(const MdArgs& a, cudaStream_t s) {
  const int grid = (a.b + kWarps - 1) / kWarps;
  mode_decide_kernel<<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// A zone of b = rows x cols blocks: ssem (b, 2 r_map + 1, 2 r_map + 1),
// src2m, sse_zero, sse_new, new_r, new_c (b,), prev_mv (b, 2) int32;
// left_edge (rows, 2) int32 or null; gold_sse (2, b) int32 or null;
// alt_sse0, alt_sse1, alt_new_r, alt_new_c (b,) int32, all four or none
// (with rates only); with_rates 1: scalars (9,), joint_cost (4,), nmv_row
// and nmv_col (2 mv_cost_max + 1,) int32 and lam_vec (b,) float32 or null;
// with_rates 0: the proxies rz, rp, rs, new_bits (n_new_bits,) float32
// and lam, the word of the step's row step (step_scalars.cuh). Out mv (2, b) int32 and ref_sel (b,) int8. Returns
// cudaGetLastError() after the launch.
extern "C" int mode_decide_launch(
    const void* ssem, const void* src2m, const void* sse_zero,
    const void* sse_new, const void* new_r, const void* new_c,
    const void* prev_mv, const void* left_edge, const void* gold_sse,
    const void* alt_sse0, const void* alt_sse1, const void* alt_new_r,
    const void* alt_new_c, const void* scalars, const void* joint_cost,
    const void* nmv_row, const void* nmv_col, const void* lam_vec,
    const void* new_bits, const void* step, void* mv, void* ref_sel,
    float rz, float rp, float rs, int b, int rows, int cols, int r_map,
    int q3_shift, int sse_scale, int with_rates, int n_new_bits,
    void* stream) {
  MdArgs a;
  a.mv = static_cast<int*>(mv);
  a.ref_sel = static_cast<int8_t*>(ref_sel);
  if (!decide::zone_args(a, ssem, src2m, sse_zero, sse_new, new_r, new_c,
                         prev_mv, left_edge, gold_sse, alt_sse0, alt_sse1,
                         alt_new_r, alt_new_c, scalars, joint_cost, nmv_row,
                         nmv_col, lam_vec, new_bits, step, rz, rp, rs, b,
                         rows, cols, r_map, q3_shift, sse_scale, with_rates,
                         n_new_bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_md(a, static_cast<cudaStream_t>(stream)));
}

// On the current device: *ctas_per_sm the CTAs of the kernel an SM holds
// at once, *smem_bytes the dynamic shared memory each asks for (none).
// Returns the CUDA error of the query (0 if none).
extern "C" int mode_decide_occupancy(int* ctas_per_sm, int* smem_bytes) {
  *smem_bytes = 0;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, mode_decide_kernel, kThreads, 0));
}
