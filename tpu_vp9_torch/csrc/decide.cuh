// The P-frame step's candidate decisions as device functions of one block:
// the zone's (LAST, GOLDEN, ALTREF and the reference choice) and the
// split16 children's ({ZERO, NEW, PARENT}). mode_decide.cu launches the
// zone's a warp per block, descent.cu the children's a thread per child;
// mc_predict.cu's decided instances run them at the head of each warp,
// before the block's motion compensation. This is their one copy.
//
// Replaces the XLA stages of tpu_vp9/pipeline/tpu_encdec.py: _ssem_gather
// (:1390), _candidate_decide (:1407), the GOLDEN and ALTREF blocks of
// encode_zone (:1661-1756) and encode_children_masked's candidate decision
// (:1902); the contracts are the plain versions beside the step,
// tpu_vp9_torch/pipeline/tpu_encdec.py: mode_decide_ref and
// descent_decide_ref.
//
// The zone's block i = row * cols + col:
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
//  scalars row) or, at tune SQ, the block's own (lam_vec); lam is the
//  step's row's (step_scalars.cuh), read without the tables.
// The children's child c: ZERO, NEW and PARENT. PARENT's SSE is its
// rounded full-pel entry of the child's 17 x 17 map (clamped to the map)
// plus sum(src^2); NEW's MV is (s - 32) * 8 plus the quarter-pel winner.
// With the rate tables the cost is f32(sse) + (lam_bits * f32(rate)) /
// 256, NEW's rate the mode's plus its mvd bits against PARENT; without,
// f32(sse) + f32(lam) * rate, NEW's rate new_bits[|dr| + |dc|]. The first
// minimum wins. lam_bits and the mode costs come from the scalars row,
// lam from the step's row: no per-frame value is a launch argument.
// Every product, quotient and sum rounds on its own (__fmul_rn, __fdiv_rn,
// __fadd_rn: nvcc would contract a*b + c into an FMA), int32 to float32 by
// round-to-nearest (__int2float_rn: a 32x32 SSE passes 2^24), in the plain
// version's order. An mvd past new_bits traps, as torch's indexing of the
// plain version fails there; the function then answers ok = false and the
// caller writes nothing. Every input is read through the read-only cache
// (__ldg), the loads that depend on nothing issued first. The zone's
// decision is a whole warp's, its nine candidates spread over the lanes
// (zone): its Y, U and V warps in mc_predict.cu each make it, and a
// sequential decision's instructions would then be most of a chroma warp's.

#pragma once

#include "step_scalars.cuh"
#include <cstdint>
#include <cuda_runtime.h>

namespace decide {

// the scalars row (ops/cuda_kernels.py: RATE_SCALARS)
constexpr int kModeCost = 0;  // four mode-tree costs
constexpr int kRefCost = 4;   // LAST, GOLDEN, ALTREF signalling
constexpr int kMvCostMax = 7;
constexpr int kLamBits = 8;   // the float32 bits of lam_bits
// the children's full-pel reach and their maps
constexpr int kChildReach = 8;
constexpr int kChildSide = 2 * kChildReach + 1;  // 17
constexpr int kChildMap = kChildSide * kChildSide;

// A block's decision: its q3 MV, its reference (0 LAST, 1 GOLDEN, 2
// ALTREF) and whether it was made (false after a trap).
struct Choice {
  int r, c, ref;
  bool ok;
};

// What the zone's decision reads.
struct Zone {
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
  const int* step;        // the step's row (its lam read without rates)
  float rz, rp, rs;       // the proxies of ZERO, PREV, LEFT and ABOVE
  int b, rows, cols, r_map, q3_shift, sse_scale, with_rates, n_new_bits;
};

// What the children's decision reads (its rate scalars through
// child_rates).
struct Children {
  const int* ssem;      // (nch, 17, 17) the children's relative-SSE maps
  const int* sse_zero;  // (nch,) each
  const int* sse_new;
  const int* sub_r;     // the quarter-pel winner in the window, q3
  const int* sub_c;
  const int* src2;
  const int* base_y;    // the map centre's displacement
  const int* base_x;
  const int* par_r;     // the parent's MV, q3
  const int* par_c;
  const float* new_bits;    // (n_new_bits,) NEW's rate proxy by mvd
  const int* scalars;       // (9,) with rates: the scalars row
  const int* joint_cost;    // (4,) with rates
  const int* nmv_row;       // (2 * mv_cost_max + 1,) with rates
  const int* nmv_col;
  const int* step;          // the step's row (its lam read without rates)
  float rate_zero, rate_parent;  // the proxies, without rates
  int with_rates, n_new_bits;
};

// The children's rate scalars: lam_bits and the mode costs of ZERO, NEW
// and PARENT, and the LUTs' reach.
struct ChildRates {
  float lam_bits;
  int mode_zero, mode_new, mode_parent, m;
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
// components' LUT entries, clipped to the LUTs' reach m
__device__ __forceinline__ int mvd_bits(const int* joint, const int* row,
                                        const int* col, int m, int dr,
                                        int dc) {
  return __ldg(joint + 2 * (dr != 0) + (dc != 0)) +
         __ldg(row + clampi(dr, -m, m) + m) +
         __ldg(col + clampi(dc, -m, m) + m);
}

// |dr| + |dc|
__device__ __forceinline__ int mvd_l1(int dr, int dc) {
  return (dr < 0 ? -dr : dr) + (dc < 0 ? -dc : dc);
}

// (ssem entry at the MV's rounded position + src2m) * sse_scale, wrapping
__device__ __forceinline__ int map_score(const Zone& a, const int* map,
                                         int src2m, int mr, int mc) {
  const int r = a.r_map, d = 2 * r + 1;
  const int half = 1 << (a.q3_shift - 1);
  const int fy = clampi((mr + half) >> a.q3_shift, -r, r) + r;
  const int fx = clampi((mc + half) >> a.q3_shift, -r, r) + r;
  const uint32_t v = static_cast<uint32_t>(__ldg(map + fy * d + fx)) +
                     static_cast<uint32_t>(src2m);
  return static_cast<int>(v * static_cast<uint32_t>(a.sse_scale));
}

// A group's first minimum over the eight lanes of its segment: (cost, k)
// of the lane whose cost is least, the least k among equal costs (the
// sequential strict < in candidate order); every lane of the segment gets
// it.
__device__ __forceinline__ void segment_min(float& cost, int& k) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    const float oc = __shfl_xor_sync(0xffffffffu, cost, off);
    const int ok = __shfl_xor_sync(0xffffffffu, k, off);
    if (oc < cost || (oc == cost && ok < k)) {
      cost = oc;
      k = ok;
    }
  }
}

// The zone's decision of block i by a whole warp (lane: the caller's
// lane; every lane returns the same choice). The candidates are spread over
// the lanes, eight a group: lanes 0-4 LAST's ZERO, NEW, PREV, LEFT and
// ABOVE, lanes 8 and 9 GOLDEN's ZERO and PREV, lanes 16 and 17 ALTREF's
// ZERO and NEW; each lane costs its own candidate, each group's first
// minimum comes by shuffles (segment_min), and the references are taken in
// order. Every lane loads the block's words (one broadcast each).
__device__ __forceinline__ Choice zone(const Zone& a, int i, int lane) {
  const int row = i / a.cols, col = i - row * a.cols;
  const int grp = lane >> 3, k = lane & 7;
  // the block's own words and its neighbours' NEW MVs, all at once
  const int new_r = __ldg(a.new_r + i), new_c = __ldg(a.new_c + i);
  const int prev_r = __ldg(a.prev_mv + 2 * i);
  const int prev_c = __ldg(a.prev_mv + 2 * i + 1);
  int left_r = 0, left_c = 0, above_r = 0, above_c = 0;
  if (col > 0) {
    left_r = __ldg(a.new_r + i - 1);
    left_c = __ldg(a.new_c + i - 1);
  } else if (a.left_edge != nullptr) {
    left_r = __ldg(a.left_edge + 2 * row);
    left_c = __ldg(a.left_edge + 2 * row + 1);
  }
  if (row > 0) {
    above_r = __ldg(a.new_r + i - a.cols);
    above_c = __ldg(a.new_c + i - a.cols);
  }
  const bool gold = a.gold_sse != nullptr, alt = a.alt_sse0 != nullptr;
  int an_r = 0, an_c = 0;
  if (alt) {
    an_r = __ldg(a.alt_new_r + i);
    an_c = __ldg(a.alt_new_c + i);
  }
  // this lane's candidate: its MV, whether it exists, its exact SSE (or
  // its map entry's)
  int mr = 0, mc = 0, sse = 0;
  bool mine = false, mapped = false;
  if (grp == 0 && k < 5) {
    mine = true;
    mapped = k >= 2;
    mr = k == 1 ? new_r : k == 2 ? prev_r : k == 3 ? left_r
                                               : k == 4 ? above_r : 0;
    mc = k == 1 ? new_c : k == 2 ? prev_c : k == 3 ? left_c
                                               : k == 4 ? above_c : 0;
    if (k < 2) sse = __ldg((k == 0 ? a.sse_zero : a.sse_new) + i);
  } else if (grp == 1 && k < 2 && gold) {
    mine = true;
    mr = k == 1 ? prev_r : 0;
    mc = k == 1 ? prev_c : 0;
    sse = __ldg(a.gold_sse + k * a.b + i);
  } else if (grp == 2 && k < 2 && alt) {
    mine = true;
    mr = k == 1 ? an_r : 0;
    mc = k == 1 ? an_c : 0;
    sse = __ldg((k == 0 ? a.alt_sse0 : a.alt_sse1) + i);
  }
  if (mapped) {
    const int d = 2 * a.r_map + 1;
    sse = map_score(a, a.ssem + static_cast<int64_t>(i) * d * d,
                    __ldg(a.src2m + i), mr, mc);
  }
  // NEW's mvd against LEFT (LAST), or against zero (ALTREF)
  const int dr = new_r - left_r, dc = new_c - left_c;
  const bool is_new = (grp == 0 || grp == 2) && k == 1;
  float cost = __int_as_float(0x7f800000);  // +inf: no candidate here
  float lam_bits = 0.0f, lam = 0.0f;
  if (a.with_rates) {
    lam_bits = a.lam_vec != nullptr
                   ? __ldg(a.lam_vec + i)
                   : __int_as_float(__ldg(a.scalars + kLamBits));
    // the mode tree's: ZERO mode 2, NEW mode 3 plus its mvd bits, the
    // rest mode 0
    int rate = __ldg(a.scalars + kModeCost + (k == 0 ? 2 : is_new ? 3 : 0));
    if (is_new) {
      rate += mvd_bits(a.joint_cost, a.nmv_row, a.nmv_col,
                       __ldg(a.scalars + kMvCostMax), grp == 0 ? dr : an_r,
                       grp == 0 ? dc : an_c);
    }
    if (mine) cost = table_cost(sse, rate, lam_bits);
  } else {
    const int mvd = mvd_l1(dr, dc);
    if (mvd < 0 || mvd >= a.n_new_bits) {  // past the table: the launch fails
      __trap();
      return {0, 0, 0, false};
    }
    lam = __int2float_rn(__ldg(a.step + step_row::kLam));
    // the proxies: rz, new_bits[mvd], rp, rs, rs; GOLDEN's rz, rp
    const float rate = k == 0   ? a.rz
                       : k == 1 ? (grp == 0 ? __ldg(a.new_bits + mvd) : a.rp)
                       : k == 2 ? a.rp
                                : a.rs;
    if (mine) cost = proxy_cost(sse, lam, rate);
  }
  // each group's first minimum, then its total with the reference's
  // signalling cost at the group's lane 0
  int best = k;
  segment_min(cost, best);
  if (k == 0 && (gold || alt)) {
    float extra;
    if (a.with_rates) {
      extra = __fdiv_rn(
          __fmul_rn(__int2float_rn(__ldg(a.scalars + kRefCost + grp)),
                    lam_bits),
          256.0f);
    } else {
      extra = grp == 0 ? 0.0f : __fmul_rn(2.0f, lam);
    }
    cost = __fadd_rn(cost, extra);
  }
  const int b_last = __shfl_sync(0xffffffffu, best, 0);
  Choice out = {b_last == 1 ? new_r : b_last == 2 ? prev_r
                : b_last == 3 ? left_r : b_last == 4 ? above_r : 0,
                b_last == 1 ? new_c : b_last == 2 ? prev_c
                : b_last == 3 ? left_c : b_last == 4 ? above_c : 0,
                0, true};
  const float c_last = __shfl_sync(0xffffffffu, cost, 0);
  const float c_gold = __shfl_sync(0xffffffffu, cost, 8);
  const int b_gold = __shfl_sync(0xffffffffu, best, 8);
  const float c_alt = __shfl_sync(0xffffffffu, cost, 16);
  const int b_alt = __shfl_sync(0xffffffffu, best, 16);
  float best_cost = c_last;
  if (gold && c_gold < best_cost) {
    best_cost = c_gold;
    out = {b_gold == 1 ? prev_r : 0, b_gold == 1 ? prev_c : 0, 1, true};
  }
  if (alt && c_alt < best_cost) {
    out = {b_alt == 1 ? an_r : 0, b_alt == 1 ? an_c : 0, 2, true};
  }
  return out;
}

// The children's rate scalars out of the device row ``scalars`` that
// upload_rate_tabs writes once a frame (the frame's lam_bits).
__device__ __forceinline__ ChildRates child_rates(const int* scalars) {
  return {__int_as_float(__ldg(scalars + kLamBits)),
          __ldg(scalars + kModeCost + 2), __ldg(scalars + kModeCost + 3),
          __ldg(scalars + kModeCost + 0), __ldg(scalars + kMvCostMax)};
}

// The children's decision of child c (ref always 0: LAST); ``r`` is read
// with rates only.
__device__ __forceinline__ Choice child(const Children& a,
                                        const ChildRates& r, int c) {
  const int base_y = __ldg(a.base_y + c), base_x = __ldg(a.base_x + c);
  const int par_r = __ldg(a.par_r + c), par_c = __ldg(a.par_c + c);
  const int sub_r = __ldg(a.sub_r + c), sub_c = __ldg(a.sub_c + c);
  const int sse0 = __ldg(a.sse_zero + c), sse1 = __ldg(a.sse_new + c);
  const int src2 = __ldg(a.src2 + c);
  const int new_r = base_y * 8 + sub_r;
  const int new_c = base_x * 8 + sub_c;
  // PARENT at its rounded full-pel entry of the map (>> is arithmetic)
  const int fy = clampi(((par_r + 4) >> 3) - base_y, -kChildReach,
                        kChildReach) + kChildReach;
  const int fx = clampi(((par_c + 4) >> 3) - base_x, -kChildReach,
                        kChildReach) + kChildReach;
  const int sse2 = __ldg(a.ssem + c * kChildMap + fy * kChildSide + fx) + src2;
  const int dr = new_r - par_r, dc = new_c - par_c;
  float c0, c1, c2;
  if (a.with_rates) {
    const int bits = mvd_bits(a.joint_cost, a.nmv_row, a.nmv_col, r.m, dr,
                              dc);
    c0 = table_cost(sse0, r.mode_zero, r.lam_bits);
    c1 = table_cost(sse1, r.mode_new + bits, r.lam_bits);
    c2 = table_cost(sse2, r.mode_parent, r.lam_bits);
  } else {
    const int mvd = mvd_l1(dr, dc);
    if (mvd >= a.n_new_bits) {  // past the table: the launch fails
      __trap();
      return {0, 0, 0, false};
    }
    const float lam = __int2float_rn(__ldg(a.step + step_row::kLam));
    c0 = proxy_cost(sse0, lam, a.rate_zero);
    c1 = proxy_cost(sse1, lam, __ldg(a.new_bits + mvd));
    c2 = proxy_cost(sse2, lam, a.rate_parent);
  }
  // the first minimum: a strict < in candidate order
  Choice out = {0, 0, 0, true};
  float best = c0;
  if (c1 < best) {
    best = c1;
    out.r = new_r;
    out.c = new_c;
  }
  if (c2 < best) {
    out.r = par_r;
    out.c = par_c;
  }
  return out;
}

// The zone's decision arguments as a launcher takes them (mode_decide.cu:
// mode_decide_launch documents them; ``b`` blocks of a rows x cols zone):
// false where they are refused.
inline bool zone_args(Zone& d, const void* ssem, const void* src2m,
                      const void* sse_zero, const void* sse_new,
                      const void* new_r, const void* new_c,
                      const void* prev_mv, const void* left_edge,
                      const void* gold_sse, const void* alt_sse0,
                      const void* alt_sse1, const void* alt_new_r,
                      const void* alt_new_c, const void* scalars,
                      const void* joint_cost, const void* nmv_row,
                      const void* nmv_col, const void* lam_vec,
                      const void* new_bits, const void* step, float rz,
                      float rp, float rs, int b, int rows, int cols,
                      int r_map, int q3_shift, int sse_scale,
                      int with_rates, int n_new_bits) {
  d.ssem = static_cast<const int*>(ssem);
  d.src2m = static_cast<const int*>(src2m);
  d.sse_zero = static_cast<const int*>(sse_zero);
  d.sse_new = static_cast<const int*>(sse_new);
  d.new_r = static_cast<const int*>(new_r);
  d.new_c = static_cast<const int*>(new_c);
  d.prev_mv = static_cast<const int*>(prev_mv);
  d.left_edge = static_cast<const int*>(left_edge);
  d.gold_sse = static_cast<const int*>(gold_sse);
  d.alt_sse0 = static_cast<const int*>(alt_sse0);
  d.alt_sse1 = static_cast<const int*>(alt_sse1);
  d.alt_new_r = static_cast<const int*>(alt_new_r);
  d.alt_new_c = static_cast<const int*>(alt_new_c);
  d.scalars = static_cast<const int*>(scalars);
  d.joint_cost = static_cast<const int*>(joint_cost);
  d.nmv_row = static_cast<const int*>(nmv_row);
  d.nmv_col = static_cast<const int*>(nmv_col);
  d.lam_vec = static_cast<const float*>(lam_vec);
  d.new_bits = static_cast<const float*>(new_bits);
  d.step = static_cast<const int*>(step);
  d.rz = rz;
  d.rp = rp;
  d.rs = rs;
  d.b = b;
  d.rows = rows;
  d.cols = cols;
  d.r_map = r_map;
  d.q3_shift = q3_shift;
  d.sse_scale = sse_scale;
  d.with_rates = with_rates;
  d.n_new_bits = n_new_bits;
  const bool alt = alt_sse0 != nullptr;
  return !(rows <= 0 || cols <= 0 || b != rows * cols || r_map < 0 ||
           q3_shift < 1 ||
           (alt && (alt_sse1 == nullptr || alt_new_r == nullptr ||
                    alt_new_c == nullptr || !with_rates)) ||
           (with_rates && (scalars == nullptr || joint_cost == nullptr ||
                           nmv_row == nullptr || nmv_col == nullptr)) ||
           (!with_rates && (new_bits == nullptr || step == nullptr)));
}

// The children's decision arguments as a launcher takes them (descent.cu:
// descent_decide_launch documents them): false where they are refused.
inline bool children_args(Children& d, const void* ssem,
                          const void* sse_zero, const void* sse_new,
                          const void* sub_r, const void* sub_c,
                          const void* src2, const void* base_y,
                          const void* base_x, const void* par_r,
                          const void* par_c, const void* new_bits,
                          const void* scalars, const void* joint_cost,
                          const void* nmv_row, const void* nmv_col,
                          const void* step, float rate_zero,
                          float rate_parent, int with_rates,
                          int n_new_bits) {
  d.ssem = static_cast<const int*>(ssem);
  d.sse_zero = static_cast<const int*>(sse_zero);
  d.sse_new = static_cast<const int*>(sse_new);
  d.sub_r = static_cast<const int*>(sub_r);
  d.sub_c = static_cast<const int*>(sub_c);
  d.src2 = static_cast<const int*>(src2);
  d.base_y = static_cast<const int*>(base_y);
  d.base_x = static_cast<const int*>(base_x);
  d.par_r = static_cast<const int*>(par_r);
  d.par_c = static_cast<const int*>(par_c);
  d.new_bits = static_cast<const float*>(new_bits);
  d.scalars = static_cast<const int*>(scalars);
  d.joint_cost = static_cast<const int*>(joint_cost);
  d.nmv_row = static_cast<const int*>(nmv_row);
  d.nmv_col = static_cast<const int*>(nmv_col);
  d.step = static_cast<const int*>(step);
  d.rate_zero = rate_zero;
  d.rate_parent = rate_parent;
  d.with_rates = with_rates;
  d.n_new_bits = n_new_bits;
  return !(with_rates ? (scalars == nullptr || joint_cost == nullptr ||
                         nmv_row == nullptr || nmv_col == nullptr)
                      : (new_bits == nullptr || step == nullptr));
}

}  // namespace decide
