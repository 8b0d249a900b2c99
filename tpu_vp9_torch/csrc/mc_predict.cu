// The realtime P-frame step's motion compensation: for every block, its
// Y, U and V predictions read in place out of the border-extended
// reference planes, with libvpx's UMV clamp of the motion vector, the
// window clamp of the reference step and its 8-tap convolve.
//
// Replaces the XLA stage tpu_vp9/pipeline/tpu_encdec.py:
// mc_predict_from_wins (:359), with its clamp _clamp_mv_umv (:126), and
// the MC windows the JAX step cuts for it (:1768-1797); its contract is
// the plain version beside the step, tpu_vp9_torch/pipeline/tpu_encdec.py:
// mc_predict_planes_ref: the windows cut by _extract_search_windows, then
// mc_predict_ref. Per block b and plane p (Y at n, U and V at n / 2;
// ss = 0 for Y, 1 for U and V):
//   - the plane position (pos_y[b] >> ss, pos_x[b] >> ss), the window
//     offset (off_y[b] >> ss, off_x[b] >> ss) (0 without offsets);
//   - the q3 MV clamped to the UMV border (vp9_reconinter.c:68) and scaled
//     to the plane's q4 units, added to the position's q4: y_q4, x_q4;
//   - the read start s = clamp((q4 >> 4) - pos + win_r + 1 + off, 0,
//     SW - (n + 7)) in the block's window, and the phase q4 & 15 (both
//     floor and two's complement on int32, as in the plain version);
//   - the window: window w = win_idx[b] (b without win_idx; a child reads
//     its parent's) of the zone's grid in reference ref_sel[b] (0 LAST, 1
//     GOLDEN, 2 ALTREF; LAST where there is no ref_sel or that reference
//     has no planes). Window w = (row, col) of the grid covers the SW x SW
//     square at (y0 + step row, x0 + step col) of its plane, each plane's
//     (step, SW, y0, x0) as the step's _window_spec gives them (the
//     grid's step is the zone's block size, 32 for the children, so it is
//     kept apart from n; the wrapper checks that every window lies inside
//     its plane). The region is read at the window's origin + s, so the
//     kernel reads the bytes the window would have held, whatever the MV,
//     and no window is cut;
//   - libvpx's convolve over its (n + 7)^2 region: the H pass into 8-bit
//     intermediates, then the V pass, each output clamp((acc + 64) >> 7,
//     0, 255) (convolve8.cuh). Phase 0 is [0, 0, 0, 128, 0, 0, 0, 0]: its
//     output is the pixel under tap 3, which the kernel copies.
// All of it is integer arithmetic, so the kernel equals the plain version
// bit for bit.
//
// What bounds it on an H100: bytes. A block reads its three (n + 7)^2
// regions and writes its three predictions (about 4.1 KB a 32 block),
// against about 2.8e4 multiply-adds; the 1080p zone's 2040 blocks move
// 8.4 MB, about 2.5 us at HBM speed. So the design keeps the card's
// memory busy with few instructions a byte and no CTA-wide barrier: a
// warp per block and plane, four warps a CTA (gridDim.y the plane, each
// warp its own block and its own shared memory), and
//   - each region row read as the aligned 16-byte chunks that hold it
//     (any start, any pitch; a chunk is read only where it holds a byte of
//     the row), a lane a chunk, into the warp's shared memory (16-byte
//     loads: a quarter of the load instructions of 32-bit words, whose
//     staging was half of a warp's cycles, utils/mc_phases.py);
//   - the H pass four outputs a lane from the row's words, realigned with
//     __funnelshift_r (conv8::bytes8, two dp4a an output), the
//     intermediates stored transposed, a column's n + 7 rows contiguous;
//   - the V pass the same way down the columns, the prediction written a
//     byte a lane, neighbouring lanes on neighbouring columns;
//   - __syncwarp between the phases.
//
// The decided instances. The step's two MC sites each consume a decision
// that nothing else reads first: the zone's (decide.cuh: decide::zone,
// LAST, GOLDEN, ALTREF and the reference choice, the JAX package's
// _candidate_decide and encode_zone's GOLDEN and ALTREF blocks) and the
// children's (decide::child, encode_children_masked's). Their launches,
// mc_predict_zone_launch and mc_predict_children_launch, make the decision
// at the head of every warp, on the warp's own block: each of the block's
// Y, U and V warps (in three CTAs) decides it from the same inputs, about
// 50 bytes and three map entries a block, the second and third reads from
// L2; the warp then compensates with the decided (mv, ref) where the plain
// instance reads mv_r, mv_c and ref_sel. Only the plane-0 warp writes the
// decision out: mv (2, B) int32, mv16 (B, 2) int16 and, for the zone,
// ref_sel (B,) int8. Their contracts are the plain compositions beside the
// step, tpu_vp9_torch/pipeline/tpu_encdec.py: mode_decide_mc_ref and
// descent_decide_mc_ref (the decision's plain version, then
// mc_predict_planes_ref); the standalone launches of the decisions
// (mode_decide.cu, descent.cu) stay for their checks, and the step no
// longer makes them.

#include <cstdint>
#include <cuda_runtime.h>

#include "convolve8.cuh"
#include "decide.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPlanes = 3;  // Y, U, V
constexpr int kRefs = 3;    // LAST, GOLDEN, ALTREF

// What a launch reads and writes; plane[p][r] is null where reference r
// has no planes (ref 0, LAST, always has them).
struct McArgs {
  const uint8_t* plane[kPlanes][kRefs];
  uint8_t* out[kPlanes];
  const int8_t* ref_sel;  // (B,) or null: every block LAST
  const int* win_idx;     // (B,) or null: block b reads window b
  const int* pos_y;       // (B,) luma positions
  const int* pos_x;
  const int* mv_r;        // (B,) q3 luma MVs
  const int* mv_c;
  const int* off_y;       // (B,) luma offsets inside the window, or null
  const int* off_x;
  const int* filters;     // (16, 8) EIGHTTAP
  int nblk;
  int pitch[kPlanes];     // each plane's row length (its references' too)
  // each plane's window grid: first window's origin, step, side, reach
  int y0[kPlanes], x0[kPlanes], step[kPlanes], sw[kPlanes], win_r[kPlanes];
  int cols;               // the grid's columns
  int nwin;               // its windows
  int mi_rows, mi_cols;
  // the decided instances: the decision's inputs, and its outputs, which
  // the plane-0 warp of a block writes
  decide::Zone zone;        // kZone
  decide::Children child;   // kChildren
  int* mv_out;              // (2, B) int32
  int16_t* mv16_out;        // (B, 2) int16
  int8_t* ref_out;          // (B,) int8, kZone
};

// What a launch decides before its MC: nothing (the MVs and ref_sel are
// given), the zone's decision or the children's.
constexpr int kPlain = 0;
constexpr int kZone = 1;
constexpr int kChildren = 2;

// A plane of block size NP: the region's side; the 16-byte chunks a row
// of the region spans from the aligned chunk that holds its first byte
// (which may start up to 15 bytes before it), and their words; the
// transposed intermediates' pitch in bytes (a column's last byte is
// padding, read by the V pass at the last output and not used); a warp's
// shared bytes: the region's chunks, then the intermediates.
template <int NP>
struct Plane {
  static constexpr int kL = NP + 7;
  static constexpr int kRc = (kL + 14) / 16 + 1;  // 16-byte chunks a row
  static constexpr int kRw = 4 * kRc;
  static constexpr int kP = NP + 8;
  static constexpr int kPw = kP / 4;
  static constexpr int kRawBytes = kL * kRw * 4;
  static constexpr int kBytes = kRawBytes + NP * kP;
  static_assert(NP % 4 == 0 && kP % 4 == 0, "layout");
};

// A warp's shared memory at luma size N (the chroma planes' is smaller),
// 16-byte aligned, and a CTA's.
template <int N>
constexpr int kWarpSmem = (Plane<N>::kBytes + 15) / 16 * 16;
template <int N>
constexpr int kSmem = kWarps * kWarpSmem<N>;

// Block b's prediction in plane p (of block size NP) at the q3 MV (mv_r,
// mv_c) out of reference ref into a.out[p], by one warp (lane its lane), in
// the warp's shared memory smem.
template <int NP>
__device__ __forceinline__ void predict(const McArgs& a, int b, int p,
                                        int lane, unsigned char* smem,
                                        int mv_r, int mv_c, int ref) {
  using S = Plane<NP>;
  const int ss = p > 0 ? 1 : 0;
  const int pos_y = a.pos_y[b] >> ss;
  const int pos_x = a.pos_x[b] >> ss;
  const int off_y = a.off_y != nullptr ? a.off_y[b] >> ss : 0;
  const int off_x = a.off_x != nullptr ? a.off_x[b] >> ss : 0;

  // _clamp_mv_umv: the q3 MV clamped to the UMV border in plane q4 units
  const int mi_r = (pos_y << ss) >> 3;
  const int mi_c = (pos_x << ss) >> 3;
  const int spel_left = (4 + NP) << 4;
  const int spel_right = spel_left - 16;
  const int spel_top = (4 + NP) << 4;
  const int spel_bottom = spel_top - 16;
  const int scale = 1 << (1 - ss);
  const int mb_l = -(mi_c * 8) * 8;
  const int mb_r = ((a.mi_cols - (NP << ss) / 8) - mi_c) * 64;
  const int mb_t = -(mi_r * 8) * 8;
  const int mb_b = ((a.mi_rows - (NP << ss) / 8) - mi_r) * 64;
  const int row = min(max(mv_r * scale, mb_t * scale - spel_top),
                      mb_b * scale + spel_bottom);
  const int col = min(max(mv_c * scale, mb_l * scale - spel_left),
                      mb_r * scale + spel_right);
  const int y_q4 = (pos_y << 4) + row;
  const int x_q4 = (pos_x << 4) + col;
  const int sw = a.sw[p];
  const int s_y = min(max((y_q4 >> 4) - pos_y + a.win_r[p] + 1 + off_y, 0),
                      sw - S::kL);
  const int s_x = min(max((x_q4 >> 4) - pos_x + a.win_r[p] + 1 + off_x, 0),
                      sw - S::kL);
  const int ph_y = y_q4 & 15;
  const int ph_x = x_q4 & 15;

  // the block's window in its reference's plane
  const uint8_t* pl = a.plane[p][0];
  if (ref == 1 && a.plane[p][1] != nullptr) pl = a.plane[p][1];
  if (ref == 2 && a.plane[p][2] != nullptr) pl = a.plane[p][2];
  const int w_idx = a.win_idx != nullptr ? a.win_idx[b] : b;
  if (w_idx < 0 || w_idx >= a.nwin) {
    __trap();  // a window past the grid: the wrapper cannot see it
    return;
  }
  const int w_row = w_idx / a.cols;
  const int w_col = w_idx - w_row * a.cols;
  const int64_t pitch = a.pitch[p];
  const uint8_t* src =
      pl + (a.y0[p] + a.step[p] * w_row + s_y) * pitch + a.x0[p] +
      a.step[p] * w_col + s_x;
  const uintptr_t src_at = reinterpret_cast<uintptr_t>(src);
  const int pitch_sh = static_cast<int>(pitch & 15);

  // 1. the region's rows as aligned 16-byte chunks: chunk j of row r
  // holds the row's bytes 16j - sh .. 16j - sh + 15 (sh: the row's first
  // byte's place in its chunk); one without a byte of the row is not read
  uint4* raw4 = reinterpret_cast<uint4*>(smem);
  for (int i = lane; i < S::kL * S::kRc; i += 32) {
    const int r = i / S::kRc, j = i - r * S::kRc;
    const uintptr_t at = src_at + r * pitch;
    const int sh = static_cast<int>(at & 15);
    raw4[i] = 16 * j - sh < S::kL
                  ? *reinterpret_cast<const uint4*>((at & ~uintptr_t{15}) +
                                                    16 * j)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
  const uint32_t* raw = reinterpret_cast<const uint32_t*>(smem);
  uint32_t t_lo = 0, t_hi = 0, v_lo = 0, v_hi = 0;
  if (ph_x != 0) {
    conv8::pack_taps(a.filters + ph_x * conv8::kTaps, t_lo, t_hi);
  }
  if (ph_y != 0) {
    conv8::pack_taps(a.filters + ph_y * conv8::kTaps, v_lo, v_hi);
  }
  __syncwarp();

  // 2. the H pass: row r, columns 4cw..4cw+3, from the row's region words
  // cw..cw+2 (realigned from its raw words q+cw..q+cw+3, q the word of
  // the row's first byte in its chunk); stored transposed
  uint8_t* inter = smem + S::kRawBytes;  // column c at c * kP
  const int sh0 = static_cast<int>(src_at & 15);
  for (int i = lane; i < S::kL * (NP / 4); i += 32) {
    const int r = i / (NP / 4), cw = i - r * (NP / 4);
    const int shr = (sh0 + r * pitch_sh) & 15;
    const unsigned sh = 8u * (shr & 3);
    const uint32_t* w = raw + r * S::kRw + (shr >> 2) + cw;
    const uint32_t w0 = __funnelshift_r(w[0], w[1], sh);
    const uint32_t w1 = __funnelshift_r(w[1], w[2], sh);
    const uint32_t w2 = __funnelshift_r(w[2], w[3], sh);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t lo, hi;
      conv8::bytes8(w0, w1, w2, k, lo, hi);
      // phase 0: the pixel under tap 3
      const int v = ph_x == 0 ? static_cast<int>(lo >> 24)
                              : conv8::tap8_packed(lo, hi, t_lo, t_hi);
      inter[(4 * cw + k) * S::kP + r] = static_cast<uint8_t>(v);
    }
  }
  __syncwarp();

  // 3. the V pass: column c, rows 4rw..4rw+3, from the column's words
  // rw..rw+2
  const uint32_t* inter_w = reinterpret_cast<const uint32_t*>(inter);
  uint8_t* out = a.out[p] + static_cast<int64_t>(b) * NP * NP;
  for (int i = lane; i < NP * (NP / 4); i += 32) {
    const int c = i % NP, rw = i / NP;
    const uint32_t* w = inter_w + c * S::kPw + rw;
    const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t lo, hi;
      conv8::bytes8(w0, w1, w2, k, lo, hi);
      const int v = ph_y == 0 ? static_cast<int>(lo >> 24)
                              : conv8::tap8_packed(lo, hi, v_lo, v_hi);
      out[(4 * rw + k) * NP + c] = static_cast<uint8_t>(v);
    }
  }
}

// N: the luma block size (the chroma planes' is N / 2); D: what it
// decides first (kPlain, kZone, kChildren). Warp w of CTA x predicts block
// kWarps x + w in plane blockIdx.y.
template <int N, int D>
__global__ void __launch_bounds__(kThreads) mc_predict_kernel(McArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarps + warp;
  const int p = blockIdx.y;
  if (b >= a.nblk) return;
  int mv_r, mv_c, ref;
  if constexpr (D == kPlain) {
    mv_r = a.mv_r[b];
    mv_c = a.mv_c[b];
    ref = a.ref_sel != nullptr ? a.ref_sel[b] : 0;
  } else {
    decide::Choice ch;
    if constexpr (D == kZone) {
      ch = decide::zone(a.zone, b, lane);
    } else {
      decide::ChildRates r = {0.0f, 0, 0, 0, 0};
      if (a.child.with_rates) r = decide::child_rates(a.child.scalars);
      ch = decide::child(a.child, r, b);
    }
    if (!ch.ok) return;  // a trap: the whole warp leaves
    mv_r = ch.r;
    mv_c = ch.c;
    ref = ch.ref;
    if (p == 0 && lane == 0) {  // the decision out, once a block
      a.mv_out[b] = mv_r;
      a.mv_out[a.nblk + b] = mv_c;
      a.mv16_out[2 * b] = static_cast<int16_t>(mv_r);
      a.mv16_out[2 * b + 1] = static_cast<int16_t>(mv_c);
      if constexpr (D == kZone) a.ref_out[b] = static_cast<int8_t>(ref);
    }
  }
  unsigned char* mine = smem + warp * kWarpSmem<N>;
  if (p == 0) {
    predict<N>(a, b, p, lane, mine, mv_r, mv_c, ref);
  } else {
    predict<N / 2>(a, b, p, lane, mine, mv_r, mv_c, ref);
  }
}

// The MC part of a launch's arguments (mc_predict_launch documents them);
// false where they are refused.
bool mc_args(McArgs& a, const void* const planes[kPlanes][kRefs],
             const void* pos_y, const void* pos_x, const void* filters,
             void* out_y, void* out_u, void* out_v, int nblk, int n,
             int rows, int cols, const int geom[kPlanes][4], int win_r_y,
             int win_r_c, const int pitches[kPlanes], int mi_rows,
             int mi_cols) {
  for (int p = 0; p < kPlanes; ++p) {
    for (int r = 0; r < kRefs; ++r) {
      a.plane[p][r] = static_cast<const uint8_t*>(planes[p][r]);
    }
  }
  a.out[0] = static_cast<uint8_t*>(out_y);
  a.out[1] = static_cast<uint8_t*>(out_u);
  a.out[2] = static_cast<uint8_t*>(out_v);
  a.pos_y = static_cast<const int*>(pos_y);
  a.pos_x = static_cast<const int*>(pos_x);
  a.filters = static_cast<const int*>(filters);
  a.nblk = nblk;
  a.cols = cols;
  a.nwin = rows * cols;
  a.mi_rows = mi_rows;
  a.mi_cols = mi_cols;
  for (int p = 0; p < kPlanes; ++p) {
    a.pitch[p] = pitches[p];
    a.step[p] = geom[p][0];
    a.sw[p] = geom[p][1];
    a.y0[p] = geom[p][2];
    a.x0[p] = geom[p][3];
    a.win_r[p] = p > 0 ? win_r_c : win_r_y;
    if (a.step[p] < 1 || a.sw[p] < (n >> (p > 0 ? 1 : 0)) + 7 ||
        a.y0[p] < 0 || a.x0[p] < 0) {
      return false;
    }
  }
  return nblk >= 0 && rows >= 1 && cols >= 1;
}

template <int N, int D>
cudaError_t launch(const McArgs& a, cudaStream_t stream) {
  const dim3 grid((a.nblk + kWarps - 1) / kWarps, kPlanes);
  mc_predict_kernel<N, D><<<grid, kThreads, kSmem<N>, stream>>>(a);
  return cudaGetLastError();
}

template <int N, int D>
int occupancy(int* ctas_per_sm, int* smem_bytes) {
  *smem_bytes = kSmem<N>;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, mc_predict_kernel<N, D>, kThreads, kSmem<N>));
}

}  // namespace

// nblk blocks of luma size n (16 or 32; chroma n / 2) predicted out of
// the border-extended planes y*, u*, v* of LAST, GOLDEN and ALTREF (uint8,
// rows of pitch_y, pitch_u, pitch_v bytes, any start; GOLDEN's and
// ALTREF's may be null), whose windows form the zone's grid of rows x
// cols windows: plane p's (step, sw, y0, x0) in geom[4 p .. 4 p + 3]
// (every window inside its plane: the wrapper checks), reach win_r_y (Y)
// and win_r_c (U, V); ref_sel (nblk,) int8 or null, win_idx (nblk,) int32
// or null (then the grid has nblk windows), pos_y, pos_x, mv_r, mv_c
// (nblk,) int32, off_y, off_x (nblk,) int32 or both null, filters the
// (16, 8) int32 EIGHTTAP table (row 0 the identity, every tap of the rows
// 1-15 a signed byte); out_y (nblk, n, n) and out_u, out_v (nblk, n/2,
// n/2) uint8 out. A window index past the grid traps. Returns
// cudaGetLastError() after the launch.
extern "C" int mc_predict_launch(
    const void* y0, const void* y1, const void* y2, const void* u0,
    const void* u1, const void* u2, const void* v0, const void* v1,
    const void* v2, const void* ref_sel, const void* win_idx,
    const void* pos_y, const void* pos_x, const void* mv_r, const void* mv_c,
    const void* off_y, const void* off_x, const void* filters, void* out_y,
    void* out_u, void* out_v, int nblk, int n, int rows, int cols,
    int step_y, int sw_y, int y0_y, int x0_y, int step_u, int sw_u, int y0_u,
    int x0_u, int step_v, int sw_v, int y0_v, int x0_v, int win_r_y,
    int win_r_c, int pitch_y, int pitch_u, int pitch_v, int mi_rows,
    int mi_cols, void* stream) {
  McArgs a;
  const void* planes[kPlanes][kRefs] = {
      {y0, y1, y2}, {u0, u1, u2}, {v0, v1, v2}};
  const int pitches[kPlanes] = {pitch_y, pitch_u, pitch_v};
  const int geom[kPlanes][4] = {{step_y, sw_y, y0_y, x0_y},
                                {step_u, sw_u, y0_u, x0_u},
                                {step_v, sw_v, y0_v, x0_v}};
  if (!mc_args(a, planes, pos_y, pos_x, filters, out_y, out_u, out_v, nblk,
               n, rows, cols, geom, win_r_y, win_r_c, pitches, mi_rows,
               mi_cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.ref_sel = static_cast<const int8_t*>(ref_sel);
  a.win_idx = static_cast<const int*>(win_idx);
  a.mv_r = static_cast<const int*>(mv_r);
  a.mv_c = static_cast<const int*>(mv_c);
  a.off_y = static_cast<const int*>(off_y);
  a.off_x = static_cast<const int*>(off_x);
  if (nblk == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 32:
      return static_cast<int>(launch<32, kPlain>(a, s));
    case 16:
      return static_cast<int>(launch<16, kPlain>(a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A decided launcher's words, read in order (one ctypes array: sixty-odd
// arguments cost the host more a call than the array).
struct Words {
  const int64_t* w;
  int at;
  const void* ptr() { return reinterpret_cast<const void*>(w[at++]); }
  void* out() { return reinterpret_cast<void*>(w[at++]); }
  int i() { return static_cast<int>(w[at++]); }
};

// MC's ints in a decided launcher's words (nblk, n, rows, cols, each
// plane's step, sw, y0 and x0, win_r_y, win_r_c, pitch_y, pitch_u,
// pitch_v, mi_rows, mi_cols) into ``a`` with the pointers read before
// them: false where they are refused, as mc_predict_launch refuses them.
static bool mc_ints(McArgs& a, Words& w,
                    const void* const planes[kPlanes][kRefs],
                    const void* pos_y, const void* pos_x,
                    const void* filters, void* out_y, void* out_u,
                    void* out_v, int& nblk, int& n, int& rows, int& cols) {
  nblk = w.i();
  n = w.i();
  rows = w.i();
  cols = w.i();
  int geom[kPlanes][4];
  for (int p = 0; p < kPlanes; ++p) {
    for (int k = 0; k < 4; ++k) geom[p][k] = w.i();
  }
  const int win_r_y = w.i();
  const int win_r_c = w.i();
  int pitches[kPlanes];
  for (int p = 0; p < kPlanes; ++p) pitches[p] = w.i();
  const int mi_rows = w.i();
  const int mi_cols = w.i();
  return mc_args(a, planes, pos_y, pos_x, filters, out_y, out_u, out_v,
                 nblk, n, rows, cols, geom, win_r_y, win_r_c, pitches,
                 mi_rows, mi_cols);
}

// The zone's decision and its MC in one launch: nblk = rows x cols blocks
// in raster order, block b reading window b. ``words`` (int64): the
// pointers y0, y1, y2, u0, u1, u2, v0, v1, v2 (LAST's, GOLDEN's and
// ALTREF's planes as mc_predict_launch takes them), pos_y, pos_x, filters,
// out_y, out_u, out_v; ssem, src2m, sse_zero, sse_new, new_r, new_c,
// prev_mv, left_edge, gold_sse, alt_sse0, alt_sse1, alt_new_r, alt_new_c,
// scalars, joint_cost, nmv_row, nmv_col, lam_vec, new_bits, step (as
// mode_decide_launch, mode_decide.cu, takes them; 0 for null); out mv (2,
// nblk) int32, ref_sel (nblk,) int8, mv16 (nblk, 2) int16; then the ints
// nblk, n, rows, cols, each plane's step, sw, y0, x0, win_r_y, win_r_c,
// pitch_y, pitch_u, pitch_v, mi_rows, mi_cols, r_map, q3_shift, sse_scale,
// with_rates, n_new_bits; the proxies rz, rp, rs apart. The ints are the
// same from frame to frame: lam is read from the step's row. An mvd past
// new_bits and a window index past the grid trap. Returns
// cudaGetLastError() after the launch.
extern "C" int mc_predict_zone_launch(const int64_t* words, float rz,
                                      float rp, float rs, void* stream) {
  Words w = {words, 0};
  McArgs a = {};
  const void* planes[kPlanes][kRefs];
  for (int p = 0; p < kPlanes; ++p) {
    for (int r = 0; r < kRefs; ++r) planes[p][r] = w.ptr();
  }
  const void* pos_y = w.ptr();
  const void* pos_x = w.ptr();
  const void* filters = w.ptr();
  void* out_y = w.out();
  void* out_u = w.out();
  void* out_v = w.out();
  const void* d[20];  // ssem .. new_bits, step
  for (int k = 0; k < 20; ++k) d[k] = w.ptr();
  a.mv_out = static_cast<int*>(w.out());
  a.ref_out = static_cast<int8_t*>(w.out());
  a.mv16_out = static_cast<int16_t*>(w.out());
  int nblk, n, rows, cols;
  if (!mc_ints(a, w, planes, pos_y, pos_x, filters, out_y, out_u, out_v,
               nblk, n, rows, cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int r_map = w.i();
  const int q3_shift = w.i();
  const int sse_scale = w.i();
  const int with_rates = w.i();
  const int n_new_bits = w.i();
  if (!decide::zone_args(a.zone, d[0], d[1], d[2], d[3], d[4], d[5], d[6],
                         d[7], d[8], d[9], d[10], d[11], d[12], d[13], d[14],
                         d[15], d[16], d[17], d[18], d[19], rz, rp, rs, nblk,
                         rows, cols, r_map, q3_shift, sse_scale, with_rates,
                         n_new_bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 32:
      return static_cast<int>(launch<32, kZone>(a, s));
    case 16:
      return static_cast<int>(launch<16, kZone>(a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The children's decision and their MC in one launch: nblk = 4K children
// of luma size n = 16 in LAST's planes, the grid's windows their parents'
// by win_idx. ``words`` (int64): the pointers y, u, v (LAST's planes),
// win_idx, pos_y, pos_x, off_y, off_x, filters, out_y, out_u, out_v; ssem,
// sse_zero, sse_new, sub_r, sub_c, src2, base_y, base_x, par_r, par_c,
// new_bits, scalars, joint_cost, nmv_row, nmv_col, step (as
// descent_decide_launch, descent.cu, takes them: with rates lam_bits and
// the mode costs come from the device row scalars (9,) int32 that
// upload_rate_tabs writes, RATE_SCALARS, without lam from the step's row);
// out mv (2, nblk) int32, mv16 (nblk, 2) int16; then the ints nblk, n,
// rows, cols, each plane's step, sw, y0, x0, win_r_y, win_r_c, pitch_y,
// pitch_u, pitch_v, mi_rows, mi_cols, with_rates, n_new_bits; the proxies
// of ZERO and PARENT apart. An mvd past new_bits and a window index past the grid trap.
// Returns cudaGetLastError() after the launch.
extern "C" int mc_predict_children_launch(const int64_t* words,
                                          float rate_zero, float rate_parent,
                                          void* stream) {
  Words w = {words, 0};
  McArgs a = {};
  const void* planes[kPlanes][kRefs] = {};
  for (int p = 0; p < kPlanes; ++p) planes[p][0] = w.ptr();
  a.win_idx = static_cast<const int*>(w.ptr());
  const void* pos_y = w.ptr();
  const void* pos_x = w.ptr();
  a.off_y = static_cast<const int*>(w.ptr());
  a.off_x = static_cast<const int*>(w.ptr());
  const void* filters = w.ptr();
  void* out_y = w.out();
  void* out_u = w.out();
  void* out_v = w.out();
  const void* d[16];  // ssem .. nmv_col, step
  for (int k = 0; k < 16; ++k) d[k] = w.ptr();
  a.mv_out = static_cast<int*>(w.out());
  a.mv16_out = static_cast<int16_t*>(w.out());
  int nblk, n, rows, cols;
  if (!mc_ints(a, w, planes, pos_y, pos_x, filters, out_y, out_u, out_v,
               nblk, n, rows, cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int with_rates = w.i();
  const int n_new_bits = w.i();
  if (n != 16 ||
      !decide::children_args(a.child, d[0], d[1], d[2], d[3], d[4], d[5],
                             d[6], d[7], d[8], d[9], d[10], d[11], d[12],
                             d[13], d[14], d[15], rate_zero, rate_parent,
                             with_rates, n_new_bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nblk == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(
      launch<16, kChildren>(a, static_cast<cudaStream_t>(stream)));
}

// The kernel of luma block size n deciding `decided` first (0 nothing, 1
// the zone's decision, 2 the children's, at n = 16 only) on the current
// device: *ctas_per_sm the CTAs of 128 threads an SM holds at once,
// *smem_bytes the dynamic shared memory each asks for. Returns the CUDA
// error of the query (0 if none).
extern "C" int mc_predict_occupancy(int n, int decided, int* ctas_per_sm,
                                    int* smem_bytes) {
  switch (4 * n + decided) {
    case 4 * 32 + kPlain:
      return occupancy<32, kPlain>(ctas_per_sm, smem_bytes);
    case 4 * 16 + kPlain:
      return occupancy<16, kPlain>(ctas_per_sm, smem_bytes);
    case 4 * 32 + kZone:
      return occupancy<32, kZone>(ctas_per_sm, smem_bytes);
    case 4 * 16 + kZone:
      return occupancy<16, kZone>(ctas_per_sm, smem_bytes);
    case 4 * 16 + kChildren:
      return occupancy<16, kChildren>(ctas_per_sm, smem_bytes);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
