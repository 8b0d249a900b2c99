// The realtime P-frame step's motion compensation: for every block, its
// Y, U and V predictions out of per-block reference windows, with libvpx's
// UMV clamp of the motion vector and its 8-tap convolve.
//
// Replaces the XLA stage tpu_vp9/pipeline/tpu_encdec.py:
// mc_predict_from_wins (:359), with its clamp _clamp_mv_umv (:126); its
// contract is the plain version beside the step, tpu_vp9_torch/pipeline/
// tpu_encdec.py:mc_predict_ref. Per block b and plane p (Y at n, U and V
// at n / 2; ss = 0 for Y, 1 for U and V):
//   - the plane position (pos_y[b] >> ss, pos_x[b] >> ss), the window
//     offset (off_y[b] >> ss, off_x[b] >> ss) (0 without offsets);
//   - the q3 MV clamped to the UMV border (vp9_reconinter.c:68) and scaled
//     to the plane's q4 units, added to the position's q4: y_q4, x_q4;
//   - the read start s = clamp((q4 >> 4) - pos + win_r + 1 + off, 0,
//     SW - (n + 7)) in the block's window (SW the window tensor's own
//     side), and the phase q4 & 15 (both floor and two's complement on
//     int32, as in the plain version);
//   - the window: reference ref_sel[b] (0 LAST, 1 GOLDEN, 2 ALTREF; LAST
//     where there is no ref_sel or that reference has no windows), window
//     win_idx[b] of it (b without win_idx): a child reads its parent's
//     window in place, and no merged or repeated window tensor is built;
//   - libvpx's convolve over its (n + 7)^2 region: the H pass into 8-bit
//     intermediates, then the V pass, each output clamp((acc + 64) >> 7,
//     0, 255) (convolve8.cuh). Phase 0 is [0, 0, 0, 128, 0, 0, 0, 0]: its
//     output is the pixel under tap 3, which the kernel copies.
// All of it is integer arithmetic, so the kernel equals the plain version
// bit for bit.
//
// What bounds it on an H100: bytes, and before them the launch. A block
// reads its three (n + 7)^2 regions and writes its three predictions
// (about 4.1 KB a 32 block), against about 2.8e4 multiply-adds; the 1080p
// zone's 2040 blocks move 8.4 MB, about 2.5 us at HBM speed. Written as
// PyTorch ops it is about forty small launches a call and whole window
// tensors merged and repeated before it. This design is the plain one: one
// launch a call site for the three planes and every reference, a CTA of 64
// threads per block and plane (gridDim.y the plane), which
//   - stages the region in shared memory a byte at a time (any start, any
//     alignment; a row's pitch n + 8 bytes, the last byte zero);
//   - runs the H pass four outputs a thread from three aligned words of a
//     row (conv8::bytes8, two dp4a an output), and stores the
//     intermediates transposed, a column's n + 7 rows contiguous;
//   - runs the V pass the same way down the columns and writes the
//     prediction a byte a thread, neighbouring threads on neighbouring
//     columns.
// Making it fast (several blocks a CTA, word loads, the three planes of a
// block in one CTA) is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "convolve8.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kPlanes = 3;  // Y, U, V
constexpr int kRefs = 3;    // LAST, GOLDEN, ALTREF

// What a launch reads and writes; win[p][r] is null where reference r has
// no windows (ref 0, LAST, always has them).
struct McArgs {
  const uint8_t* win[kPlanes][kRefs];
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
  int sw[kPlanes];        // each plane's window side
  int win_r[kPlanes];     // each plane's window reach
  int mi_rows, mi_cols;
};

// A plane of block size NP: the region's and the transposed
// intermediates' pitch in bytes (a row's or a column's last byte is
// padding, read by the passes at the last output and not used), and the
// region's bytes, after which the intermediates start.
template <int NP>
struct Plane {
  static constexpr int kL = NP + 7;       // the region's side
  static constexpr int kP = NP + 8;       // pitch, a multiple of 4
  static constexpr int kPw = kP / 4;      // pitch in words
  static constexpr int kRegBytes = kL * kP;
  static_assert(NP % 4 == 0 && kRegBytes % 4 == 0, "layout");
};

// The dynamic shared memory of a launch of luma size N: its luma plane's
// region and intermediates (the chroma planes' are smaller).
template <int N>
constexpr int kSmem = Plane<N>::kRegBytes + N * Plane<N>::kP;

// The block's prediction in plane p (of block size NP) into a.out[p].
template <int NP>
__device__ __forceinline__ void predict(const McArgs& a, int b, int p,
                                        unsigned char* smem) {
  using S = Plane<NP>;
  const int tid = threadIdx.x;
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
  const int row = min(max(a.mv_r[b] * scale, mb_t * scale - spel_top),
                      mb_b * scale + spel_bottom);
  const int col = min(max(a.mv_c[b] * scale, mb_l * scale - spel_left),
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

  // the block's window, read in place
  const int ref = a.ref_sel != nullptr ? a.ref_sel[b] : 0;
  const uint8_t* win = a.win[p][0];
  if (ref == 1 && a.win[p][1] != nullptr) win = a.win[p][1];
  if (ref == 2 && a.win[p][2] != nullptr) win = a.win[p][2];
  const int w_idx = a.win_idx != nullptr ? a.win_idx[b] : b;
  const uint8_t* src = win + static_cast<int64_t>(w_idx) * sw * sw +
                       static_cast<int64_t>(s_y) * sw + s_x;

  // 1. the (n+7)^2 region, a row's padding byte zero
  uint8_t* reg = smem;
  uint8_t* inter = smem + S::kRegBytes;  // transposed: column c at c * kP
  for (int i = tid; i < S::kL * S::kL; i += kThreads) {
    const int r = i / S::kL, c = i % S::kL;
    reg[r * S::kP + c] = src[static_cast<int64_t>(r) * sw + c];
  }
  for (int r = tid; r < S::kL; r += kThreads) reg[r * S::kP + S::kL] = 0;
  for (int c = tid; c < NP; c += kThreads) inter[c * S::kP + S::kL] = 0;
  uint32_t t_lo = 0, t_hi = 0, v_lo = 0, v_hi = 0;
  if (ph_x != 0) {
    conv8::pack_taps(a.filters + ph_x * conv8::kTaps, t_lo, t_hi);
  }
  if (ph_y != 0) {
    conv8::pack_taps(a.filters + ph_y * conv8::kTaps, v_lo, v_hi);
  }
  __syncthreads();

  // 2. the H pass: row r, columns 4cw..4cw+3, from the row's words
  // cw..cw+2; stored transposed
  const uint32_t* reg_w = reinterpret_cast<const uint32_t*>(reg);
  for (int i = tid; i < S::kL * (NP / 4); i += kThreads) {
    const int r = i / (NP / 4), cw = i % (NP / 4);
    const uint32_t* w = reg_w + r * S::kPw + cw;
    const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
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
  __syncthreads();

  // 3. the V pass: column c, rows 4rw..4rw+3, from the column's words
  // rw..rw+2
  const uint32_t* inter_w = reinterpret_cast<const uint32_t*>(inter);
  uint8_t* out = a.out[p] + static_cast<int64_t>(b) * NP * NP;
  for (int i = tid; i < NP * (NP / 4); i += kThreads) {
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

// N: the luma block size (the chroma planes' is N / 2). blockIdx.x the
// block, blockIdx.y the plane.
template <int N>
__global__ void __launch_bounds__(kThreads) mc_predict_kernel(McArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int p = blockIdx.y;
  if (b >= a.nblk) return;
  if (p == 0) {
    predict<N>(a, b, p, smem);
  } else {
    predict<N / 2>(a, b, p, smem);
  }
}

template <int N>
cudaError_t launch(const McArgs& a, cudaStream_t stream) {
  const dim3 grid(a.nblk, kPlanes);
  mc_predict_kernel<N><<<grid, kThreads, kSmem<N>, stream>>>(a);
  return cudaGetLastError();
}

template <int N>
int occupancy(int* ctas_per_sm, int* smem_bytes) {
  *smem_bytes = kSmem<N>;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, mc_predict_kernel<N>, kThreads, kSmem<N>));
}

}  // namespace

// nblk blocks of luma size n (16 or 32; chroma n / 2): the windows wy*,
// wu*, wv* of LAST, GOLDEN and ALTREF ((W, sw, sw) uint8 per plane, sw_y
// for Y and sw_c for U and V; GOLDEN's and ALTREF's may be null), ref_sel
// (nblk,) int8 or null, win_idx (nblk,) int32 or null (then W = nblk),
// pos_y, pos_x, mv_r, mv_c (nblk,) int32, off_y, off_x (nblk,) int32 or
// both null, filters the (16, 8) int32 EIGHTTAP table (row 0 the
// identity, every tap of the rows 1-15 a signed byte); out_y (nblk, n, n)
// and out_u, out_v (nblk, n/2, n/2) uint8 out. win_r_y and win_r_c: the
// windows' reach (their origin is the block minus win_r + 4). Returns
// cudaGetLastError() after the launch.
extern "C" int mc_predict_launch(
    const void* wy0, const void* wy1, const void* wy2, const void* wu0,
    const void* wu1, const void* wu2, const void* wv0, const void* wv1,
    const void* wv2, const void* ref_sel, const void* win_idx,
    const void* pos_y, const void* pos_x, const void* mv_r, const void* mv_c,
    const void* off_y, const void* off_x, const void* filters, void* out_y,
    void* out_u, void* out_v, int nblk, int n, int sw_y, int sw_c,
    int win_r_y, int win_r_c, int mi_rows, int mi_cols, void* stream) {
  McArgs a;
  const void* wins[kPlanes][kRefs] = {
      {wy0, wy1, wy2}, {wu0, wu1, wu2}, {wv0, wv1, wv2}};
  for (int p = 0; p < kPlanes; ++p) {
    for (int r = 0; r < kRefs; ++r) {
      a.win[p][r] = static_cast<const uint8_t*>(wins[p][r]);
    }
  }
  a.out[0] = static_cast<uint8_t*>(out_y);
  a.out[1] = static_cast<uint8_t*>(out_u);
  a.out[2] = static_cast<uint8_t*>(out_v);
  a.ref_sel = static_cast<const int8_t*>(ref_sel);
  a.win_idx = static_cast<const int*>(win_idx);
  a.pos_y = static_cast<const int*>(pos_y);
  a.pos_x = static_cast<const int*>(pos_x);
  a.mv_r = static_cast<const int*>(mv_r);
  a.mv_c = static_cast<const int*>(mv_c);
  a.off_y = static_cast<const int*>(off_y);
  a.off_x = static_cast<const int*>(off_x);
  a.filters = static_cast<const int*>(filters);
  a.nblk = nblk;
  a.sw[0] = sw_y;
  a.sw[1] = a.sw[2] = sw_c;
  a.win_r[0] = win_r_y;
  a.win_r[1] = a.win_r[2] = win_r_c;
  a.mi_rows = mi_rows;
  a.mi_cols = mi_cols;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 32:
      return static_cast<int>(launch<32>(a, s));
    case 16:
      return static_cast<int>(launch<16>(a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The kernel of luma block size n on the current device: *ctas_per_sm the
// CTAs of 64 threads an SM holds at once, *smem_bytes the dynamic shared
// memory each asks for. Returns the CUDA error of the query (0 if none).
extern "C" int mc_predict_occupancy(int n, int* ctas_per_sm,
                                    int* smem_bytes) {
  switch (n) {
    case 32:
      return occupancy<32>(ctas_per_sm, smem_bytes);
    case 16:
      return occupancy<16>(ctas_per_sm, smem_bytes);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
