// The mode decision of one zone of the realtime P-frame step: LAST's five
// candidates, GOLDEN's two, ALTREF's two and the reference choice, a
// thread per block, one launch.
//
// Replaces the XLA stages of tpu_vp9/pipeline/tpu_encdec.py: _ssem_gather
// (:1390), _candidate_decide (:1407) and the GOLDEN and ALTREF blocks of
// encode_zone (:1661-1756). The contract is the plain version beside the
// step, tpu_vp9_torch/pipeline/tpu_encdec.py: mode_decide_ref.
//
// Block i = row * cols + col of the zone:
//  1. LAST: ZERO and NEW at their exact SSEs; PREV (the block's MV in the
//     previous frame), LEFT and ABOVE (the neighbours' NEW MVs, zero
//     outside the zone; LEFT at column 0 from left_edge, the previous
//     column shard's last NEW MVs, where one is given) scored at their
//     rounded entry of the search's SSE map (q3 >> q3_shift, clamped to
//     the map), plus src2m, times sse_scale, in uint32 so that it wraps
//     as torch's int32 does.
//  2. Costs. With the frame's rate tables: f32(sse) + (lam_bits *
//     f32(rate)) / 256, the rates the mode tree's (ZERO mode 2, NEW mode
//     3 plus its mvd bits against LEFT, the rest mode 0), the mvd bits the
//     joint's and the two component LUTs' entries, the components clipped
//     to +-mv_cost_max. Without: f32(sse) + f32(lam) * rate, the proxies
//     (rz, new_bits[|dr| + |dc|], rp, rs, rs). The first minimum wins: a
//     strict < in candidate order.
//  3. GOLDEN (gold_sse given): ZERO and PREV at their SSEs, rates mode 2
//     and mode 0 (proxies rz and rp); its first minimum plus GOLDEN's
//     signalling cost replaces LAST's best plus LAST's on a strict <.
//  4. ALTREF (alt given; rate tables only): ZERO and NEW of its own
//     search, NEW's mvd against zero; its first minimum plus ALTREF's
//     signalling cost replaces the best so far on a strict <.
//  The signalling costs: f32(ref_cost) * lam_bits / 256 with the tables,
//  0, 2 lam, 2 lam without. lam_bits is the frame's (the word of the
//  scalars row) or, at tune SQ, the block's own (lam_vec).
// Every product, quotient and sum rounds on its own (__fmul_rn, __fdiv_rn,
// __fadd_rn: nvcc would contract a*b + c into an FMA), int32 to float32 by
// round-to-nearest (__int2float_rn: a 32x32 SSE passes 2^24), in the plain
// version's order. An mvd past new_bits traps, as torch's indexing of the
// plain version fails there.
//
// What bounds it on an H100: the launch. At 1080p M8 (B = 2040) it reads
// about 50 bytes a block besides one map entry for each of PREV, LEFT and
// ABOVE (each its own 32-byte sector) and writes 9: about 0.3 MB, 0.1 us
// at HBM speed. Written as PyTorch ops it was about a hundred small
// launches and two host-to-device copies a zone. The rate scalars come
// from the device row that upload_rate_tabs writes once a frame, so the
// launch takes no copy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// the scalars row (ops/cuda_kernels.py: RATE_SCALARS)
constexpr int kModeCost = 0;  // four mode-tree costs
constexpr int kRefCost = 4;   // LAST, GOLDEN, ALTREF signalling
constexpr int kMvCostMax = 7;
constexpr int kLamBits = 8;   // the float32 bits of lam_bits

struct MdArgs {
  const int* ssem;       // (B, d, d) the search's relative-SSE maps
  const int* src2m;      // (B,) each
  const int* sse_zero;
  const int* sse_new;
  const int* new_r;      // LAST's NEW MV, q3
  const int* new_c;
  const int* prev_mv;    // (B, 2)
  const int* left_edge;  // (rows, 2) or null: zeros
  const int* gold_sse;   // (2, B) or null: no GOLDEN
  const int* alt_sse0;   // (B,) each, or null: no ALTREF
  const int* alt_sse1;
  const int* alt_new_r;
  const int* alt_new_c;
  const int* scalars;     // (9,) with rates
  const int* joint_cost;  // (4,) with rates
  const int* nmv_row;     // (2 * mv_cost_max + 1,) with rates
  const int* nmv_col;
  const float* lam_vec;   // (B,) at tune SQ, else null
  const float* new_bits;  // (n_new_bits,) the NEW proxy by mvd
  int* mv;                // (2, B): rows, then columns
  int8_t* ref_sel;        // (B,)
  float rz, rp, rs;       // the proxies of ZERO, PREV, LEFT and ABOVE
  int b, rows, cols, r_map, q3_shift, sse_scale, lam, with_rates,
      n_new_bits;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// f32(sse) + (lam_bits * f32(rate)) / 256, each step rounded on its own
__device__ __forceinline__ float table_cost(int sse, int rate,
                                            float lam_bits) {
  return __fadd_rn(
      __int2float_rn(sse),
      __fdiv_rn(__fmul_rn(lam_bits, __int2float_rn(rate)), 256.0f));
}

// f32(sse) + lam * rate
__device__ __forceinline__ float proxy_cost(int sse, float lam, float rate) {
  return __fadd_rn(__int2float_rn(sse), __fmul_rn(lam, rate));
}

// NEWMV's mvd bits against a predictor: the joint's cost and the two
// components' LUT entries, clipped to the LUTs' reach
__device__ __forceinline__ int mvd_bits(const MdArgs& a, int m, int dr,
                                        int dc) {
  return a.joint_cost[2 * (dr != 0) + (dc != 0)] +
         a.nmv_row[clampi(dr, -m, m) + m] + a.nmv_col[clampi(dc, -m, m) + m];
}

// (ssem entry at the MV's rounded position + src2m) * sse_scale, wrapping
__device__ __forceinline__ int map_score(const MdArgs& a, const int* map,
                                         int src2m, int mr, int mc) {
  const int r = a.r_map, d = 2 * r + 1;
  const int half = 1 << (a.q3_shift - 1);
  const int fy = clampi((mr + half) >> a.q3_shift, -r, r) + r;
  const int fx = clampi((mc + half) >> a.q3_shift, -r, r) + r;
  const uint32_t v = static_cast<uint32_t>(map[fy * d + fx]) +
                     static_cast<uint32_t>(src2m);
  return static_cast<int>(v * static_cast<uint32_t>(a.sse_scale));
}

__global__ void __launch_bounds__(kThreads) mode_decide_kernel(MdArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.b) return;
  const int row = i / a.cols, col = i - row * a.cols;
  const int new_r = a.new_r[i], new_c = a.new_c[i];
  int left_r = 0, left_c = 0, above_r = 0, above_c = 0;
  if (col > 0) {
    left_r = a.new_r[i - 1];
    left_c = a.new_c[i - 1];
  } else if (a.left_edge != nullptr) {
    left_r = a.left_edge[2 * row];
    left_c = a.left_edge[2 * row + 1];
  }
  if (row > 0) {
    above_r = a.new_r[i - a.cols];
    above_c = a.new_c[i - a.cols];
  }
  const int prev_r = a.prev_mv[2 * i], prev_c = a.prev_mv[2 * i + 1];
  const int d = 2 * a.r_map + 1;
  const int* map = a.ssem + static_cast<int64_t>(i) * d * d;
  const int s2 = a.src2m[i];
  const int sse[5] = {a.sse_zero[i], a.sse_new[i],
                      map_score(a, map, s2, prev_r, prev_c),
                      map_score(a, map, s2, left_r, left_c),
                      map_score(a, map, s2, above_r, above_c)};
  const int cand_r[5] = {0, new_r, prev_r, left_r, above_r};
  const int cand_c[5] = {0, new_c, prev_c, left_c, above_c};

  float lam_bits = 0.0f, lam = 0.0f;
  int mode[4] = {0, 0, 0, 0}, m = 0;
  float cost[5];
  const int dr = new_r - left_r, dc = new_c - left_c;
  if (a.with_rates) {
    for (int k = 0; k < 4; ++k) mode[k] = a.scalars[kModeCost + k];
    m = a.scalars[kMvCostMax];
    lam_bits = a.lam_vec != nullptr ? a.lam_vec[i]
                                    : __int_as_float(a.scalars[kLamBits]);
    const int rate[5] = {mode[2], mode[3] + mvd_bits(a, m, dr, dc), mode[0],
                         mode[0], mode[0]};
    for (int k = 0; k < 5; ++k) cost[k] = table_cost(sse[k], rate[k], lam_bits);
  } else {
    const int mvd = (dr < 0 ? -dr : dr) + (dc < 0 ? -dc : dc);
    if (mvd < 0 || mvd >= a.n_new_bits) {  // past the table: the launch fails
      __trap();
      return;
    }
    lam = __int2float_rn(a.lam);
    const float rate[5] = {a.rz, a.new_bits[mvd], a.rp, a.rs, a.rs};
    for (int k = 0; k < 5; ++k) cost[k] = proxy_cost(sse[k], lam, rate[k]);
  }
  // LAST's first minimum: a strict < in candidate order
  int best = 0;
  for (int k = 1; k < 5; ++k) {
    if (cost[k] < cost[best]) best = k;
  }
  int mv_r = cand_r[best], mv_c = cand_c[best];
  int8_t ref = 0;
  if (a.gold_sse != nullptr || a.alt_sse0 != nullptr) {
    // the references' signalling costs
    float extra[3];
    if (a.with_rates) {
      for (int k = 0; k < 3; ++k) {
        extra[k] = __fdiv_rn(
            __fmul_rn(__int2float_rn(a.scalars[kRefCost + k]), lam_bits),
            256.0f);
      }
    } else {
      extra[0] = 0.0f;
      extra[1] = extra[2] = __fmul_rn(2.0f, lam);
    }
    float best_cost = __fadd_rn(cost[best], extra[0]);
    if (a.gold_sse != nullptr) {
      const int g0 = a.gold_sse[i], g1 = a.gold_sse[a.b + i];
      float c0, c1;
      if (a.with_rates) {
        c0 = table_cost(g0, mode[2], lam_bits);
        c1 = table_cost(g1, mode[0], lam_bits);
      } else {
        c0 = proxy_cost(g0, lam, a.rz);
        c1 = proxy_cost(g1, lam, a.rp);
      }
      const bool prev = c1 < c0;
      const float g_cost = __fadd_rn(prev ? c1 : c0, extra[1]);
      if (g_cost < best_cost) {
        best_cost = g_cost;
        ref = 1;
        mv_r = prev ? prev_r : 0;
        mv_c = prev ? prev_c : 0;
      }
    }
    if (a.alt_sse0 != nullptr) {  // rate tables only (the wrapper checks)
      const int an_r = a.alt_new_r[i], an_c = a.alt_new_c[i];
      const float c0 = table_cost(a.alt_sse0[i], mode[2], lam_bits);
      const float c1 = table_cost(a.alt_sse1[i],
                                  mode[3] + mvd_bits(a, m, an_r, an_c),
                                  lam_bits);
      const bool use_new = c1 < c0;
      if (__fadd_rn(use_new ? c1 : c0, extra[2]) < best_cost) {
        ref = 2;
        mv_r = use_new ? an_r : 0;
        mv_c = use_new ? an_c : 0;
      }
    }
  }
  a.mv[i] = mv_r;
  a.mv[a.b + i] = mv_c;
  a.ref_sel[i] = ref;
}

cudaError_t launch_md(const MdArgs& a, cudaStream_t s) {
  const int grid = (a.b + kThreads - 1) / kThreads;
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
// with_rates 0: lam and the proxies rz, rp, rs, new_bits (n_new_bits,)
// float32. Out mv (2, b) int32 and ref_sel (b,) int8. Returns
// cudaGetLastError() after the launch.
extern "C" int mode_decide_launch(
    const void* ssem, const void* src2m, const void* sse_zero,
    const void* sse_new, const void* new_r, const void* new_c,
    const void* prev_mv, const void* left_edge, const void* gold_sse,
    const void* alt_sse0, const void* alt_sse1, const void* alt_new_r,
    const void* alt_new_c, const void* scalars, const void* joint_cost,
    const void* nmv_row, const void* nmv_col, const void* lam_vec,
    const void* new_bits, void* mv, void* ref_sel, float rz, float rp,
    float rs, int b, int rows, int cols, int r_map, int q3_shift,
    int sse_scale, int lam, int with_rates, int n_new_bits, void* stream) {
  MdArgs a;
  a.ssem = static_cast<const int*>(ssem);
  a.src2m = static_cast<const int*>(src2m);
  a.sse_zero = static_cast<const int*>(sse_zero);
  a.sse_new = static_cast<const int*>(sse_new);
  a.new_r = static_cast<const int*>(new_r);
  a.new_c = static_cast<const int*>(new_c);
  a.prev_mv = static_cast<const int*>(prev_mv);
  a.left_edge = static_cast<const int*>(left_edge);
  a.gold_sse = static_cast<const int*>(gold_sse);
  a.alt_sse0 = static_cast<const int*>(alt_sse0);
  a.alt_sse1 = static_cast<const int*>(alt_sse1);
  a.alt_new_r = static_cast<const int*>(alt_new_r);
  a.alt_new_c = static_cast<const int*>(alt_new_c);
  a.scalars = static_cast<const int*>(scalars);
  a.joint_cost = static_cast<const int*>(joint_cost);
  a.nmv_row = static_cast<const int*>(nmv_row);
  a.nmv_col = static_cast<const int*>(nmv_col);
  a.lam_vec = static_cast<const float*>(lam_vec);
  a.new_bits = static_cast<const float*>(new_bits);
  a.mv = static_cast<int*>(mv);
  a.ref_sel = static_cast<int8_t*>(ref_sel);
  a.rz = rz;
  a.rp = rp;
  a.rs = rs;
  a.b = b;
  a.rows = rows;
  a.cols = cols;
  a.r_map = r_map;
  a.q3_shift = q3_shift;
  a.sse_scale = sse_scale;
  a.lam = lam;
  a.with_rates = with_rates;
  a.n_new_bits = n_new_bits;
  const bool alt = alt_sse0 != nullptr;
  if (rows <= 0 || cols <= 0 || b != rows * cols || r_map < 0 ||
      q3_shift < 1 ||
      (alt && (alt_sse1 == nullptr || alt_new_r == nullptr ||
               alt_new_c == nullptr || !with_rates)) ||
      (with_rates && (scalars == nullptr || joint_cost == nullptr ||
                      nmv_row == nullptr || nmv_col == nullptr)) ||
      (!with_rates && new_bits == nullptr)) {
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
