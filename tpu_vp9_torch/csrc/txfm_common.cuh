// The port's transform pieces as __device__ functions, shared by the
// kernels that encode blocks (csrc/kframe_wave.cu, the keyframe's, and
// csrc/transform_recon.cu, the P-frame step's). Each is what
// tpu_vp9_torch/ops/txfm.py and pipeline/tpu_encdec.py:transform_recon_ref
// compute, for the DCT_DCT blocks of the device steps:
//   - the forward transform in float64, X = F_col @ R @ F_row^T, on the
//     port's float32 matrices widened (txfm.fwd_matrices): a coefficient
//     differs from the plain version's (torch's float64 matmul) only in the
//     order of its sums, by about 1e-13 relative. fwd_cols and fwd_rows
//     take one coefficient a thread on the CUDA cores (kframe_wave);
//     fwd_strip_mma takes eight rows of a block a warp on the float64
//     tensor cores (transform_recon);
//   - the quantizer of txfm.quantize_f64: floor(|c| / q + 0.38f), clipped
//     to 8191, q halved at n = 32, sign restored; quantize by a true
//     float64 division, quantize_rcp by a reciprocal multiply that takes
//     the rounded quotient wherever the floor could depend on it (the same
//     levels); so a level differs from the plain version's only where
//     |c| / q + 0.38 lies within about 1e-12 of an integer;
//   - the dequantizer of txfm.dequant_block and the exact integer inverse of
//     txfm.inv_txfm2d (the idct8/idct16/idct32 butterflies of libvpx, rows
//     then columns, no rounding between the passes, then (x + 16) >> 5 at
//     n = 8 and (x + 32) >> 6 above), in int32 arithmetic that wraps as
//     torch's int32 tensors do: products and sums of int wrap on the card
//     (mul.lo and add of 32 bits), and >> of a negative int is arithmetic.
// Each function works on one row, column or coefficient, or (fwd_strip_mma)
// one warp's strip: the caller deals the work to its threads.
#pragma once

#include <cstdint>

namespace txfm {

// cospi_k_64 = round(16384 * cos(k * pi / 64))
enum : int {
  c1 = 16364, c2 = 16305, c3 = 16207, c4 = 16069, c5 = 15893, c6 = 15679,
  c7 = 15426, c8 = 15137, c9 = 14811, c10 = 14449, c11 = 14053,
  c12 = 13623, c13 = 13160, c14 = 12665, c15 = 12140, c16 = 11585,
  c17 = 11003, c18 = 10394, c19 = 9760, c20 = 9102, c21 = 8423, c22 = 7723,
  c23 = 7005, c24 = 6270, c25 = 5520, c26 = 4756, c27 = 3981, c28 = 3196,
  c29 = 2404, c30 = 1606, c31 = 804
};

constexpr int kMaxLevel = (1 << 13) - 1;
// the JAX package's dead-zone bias is float32 0.38; the float64 quantizer
// adds that same value
constexpr double kQBias = static_cast<double>(0.38f);

// dct_const_round_shift
__device__ __forceinline__ int rs(int x) { return (x + 8192) >> 14; }

__device__ __forceinline__ void idct4(const int* x, int* o) {
  const int s0 = rs((x[0] + x[2]) * c16);
  const int s1 = rs((x[0] - x[2]) * c16);
  const int s2 = rs(x[1] * c24 - x[3] * c8);
  const int s3 = rs(x[1] * c8 + x[3] * c24);
  o[0] = s0 + s3;
  o[1] = s1 + s2;
  o[2] = s1 - s2;
  o[3] = s0 - s3;
}

__device__ __forceinline__ void idct8(const int* x, int* o) {
  const int s4 = rs(x[1] * c28 - x[7] * c4);
  const int s7 = rs(x[1] * c4 + x[7] * c28);
  const int s5 = rs(x[5] * c12 - x[3] * c20);
  const int s6 = rs(x[5] * c20 + x[3] * c12);
  const int ein[4] = {x[0], x[2], x[4], x[6]};
  int e[4];
  idct4(ein, e);
  const int t4 = s4 + s5;
  const int t5 = s4 - s5;
  const int t6 = -s6 + s7;
  const int t7 = s6 + s7;
  const int u5 = rs((t6 - t5) * c16);
  const int u6 = rs((t5 + t6) * c16);
  o[0] = e[0] + t7;
  o[1] = e[1] + u6;
  o[2] = e[2] + u5;
  o[3] = e[3] + t4;
  o[4] = e[3] - t4;
  o[5] = e[2] - u5;
  o[6] = e[1] - u6;
  o[7] = e[0] - t7;
}

__device__ __forceinline__ void idct16(const int* x, int* o) {
  // stage 2 (odd rotations on inputs 1, 9, 5, 13, 3, 11, 7, 15)
  const int s8 = rs(x[1] * c30 - x[15] * c2);
  const int s15 = rs(x[1] * c2 + x[15] * c30);
  const int s9 = rs(x[9] * c14 - x[7] * c18);
  const int s14 = rs(x[9] * c18 + x[7] * c14);
  const int s10 = rs(x[5] * c22 - x[11] * c10);
  const int s13 = rs(x[5] * c10 + x[11] * c22);
  const int s11 = rs(x[13] * c6 - x[3] * c26);
  const int s12 = rs(x[13] * c26 + x[3] * c6);
  // stage 3
  const int t8 = s8 + s9;
  const int t9 = s8 - s9;
  const int t10 = -s10 + s11;
  const int t11 = s10 + s11;
  const int t12 = s12 + s13;
  const int t13 = s12 - s13;
  const int t14 = -s14 + s15;
  const int t15 = s14 + s15;
  // even part: idct8 of the even inputs
  int ein[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) ein[k] = x[2 * k];
  int e[8];
  idct8(ein, e);
  // stage 4 (odd)
  const int u9 = rs(-t9 * c8 + t14 * c24);
  const int u14 = rs(t9 * c24 + t14 * c8);
  const int u10 = rs(-t10 * c24 - t13 * c8);
  const int u13 = rs(-t10 * c8 + t13 * c24);
  // stage 5 (odd)
  const int v8 = t8 + t11;
  const int v9 = u9 + u10;
  const int v10 = u9 - u10;
  const int v11 = t8 - t11;
  const int v12 = -t12 + t15;
  const int v13 = -u13 + u14;
  const int v14 = u13 + u14;
  const int v15 = t12 + t15;
  // stage 6 (odd)
  const int w10 = rs((-v10 + v13) * c16);
  const int w13 = rs((v10 + v13) * c16);
  const int w11 = rs((-v11 + v12) * c16);
  const int w12 = rs((v11 + v12) * c16);
  const int odd[8] = {v8, v9, w10, w11, w12, w13, v14, v15};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    o[k] = e[k] + odd[7 - k];
    o[15 - k] = e[k] - odd[7 - k];
  }
}

__device__ __forceinline__ void idct32(const int* x, int* o) {
  // stage 1: odd-half rotations
  const int s16 = rs(x[1] * c31 - x[31] * c1);
  const int s31 = rs(x[1] * c1 + x[31] * c31);
  const int s17 = rs(x[17] * c15 - x[15] * c17);
  const int s30 = rs(x[17] * c17 + x[15] * c15);
  const int s18 = rs(x[9] * c23 - x[23] * c9);
  const int s29 = rs(x[9] * c9 + x[23] * c23);
  const int s19 = rs(x[25] * c7 - x[7] * c25);
  const int s28 = rs(x[25] * c25 + x[7] * c7);
  const int s20 = rs(x[5] * c27 - x[27] * c5);
  const int s27 = rs(x[5] * c5 + x[27] * c27);
  const int s21 = rs(x[21] * c11 - x[11] * c21);
  const int s26 = rs(x[21] * c21 + x[11] * c11);
  const int s22 = rs(x[13] * c19 - x[19] * c13);
  const int s25 = rs(x[13] * c13 + x[19] * c19);
  const int s23 = rs(x[29] * c3 - x[3] * c29);
  const int s24 = rs(x[29] * c29 + x[3] * c3);
  // stage 2 (odd butterflies)
  const int t16 = s16 + s17;
  const int t17 = s16 - s17;
  const int t18 = -s18 + s19;
  const int t19 = s18 + s19;
  const int t20 = s20 + s21;
  const int t21 = s20 - s21;
  const int t22 = -s22 + s23;
  const int t23 = s22 + s23;
  const int t24 = s24 + s25;
  const int t25 = s24 - s25;
  const int t26 = -s26 + s27;
  const int t27 = s26 + s27;
  const int t28 = s28 + s29;
  const int t29 = s28 - s29;
  const int t30 = -s30 + s31;
  const int t31 = s30 + s31;
  // stage 3 (odd rotations)
  const int u17 = rs(-t17 * c4 + t30 * c28);
  const int u30 = rs(t17 * c28 + t30 * c4);
  const int u18 = rs(-t18 * c28 - t29 * c4);
  const int u29 = rs(-t18 * c4 + t29 * c28);
  const int u21 = rs(-t21 * c20 + t26 * c12);
  const int u26 = rs(t21 * c12 + t26 * c20);
  const int u22 = rs(-t22 * c12 - t25 * c20);
  const int u25 = rs(-t22 * c20 + t25 * c12);
  // stage 4 (odd butterflies)
  const int v16 = t16 + t19;
  const int v17 = u17 + u18;
  const int v18 = u17 - u18;
  const int v19 = t16 - t19;
  const int v20 = -t20 + t23;
  const int v21 = -u21 + u22;
  const int v22 = u21 + u22;
  const int v23 = t20 + t23;
  const int v24 = t24 + t27;
  const int v25 = u25 + u26;
  const int v26 = u25 - u26;
  const int v27 = t24 - t27;
  const int v28 = -t28 + t31;
  const int v29 = -u29 + u30;
  const int v30 = u29 + u30;
  const int v31 = t28 + t31;
  // stage 5 (odd rotations)
  const int w18 = rs(-v18 * c8 + v29 * c24);
  const int w29 = rs(v18 * c24 + v29 * c8);
  const int w19 = rs(-v19 * c8 + v28 * c24);
  const int w28 = rs(v19 * c24 + v28 * c8);
  const int w20 = rs(-v20 * c24 - v27 * c8);
  const int w27 = rs(-v20 * c8 + v27 * c24);
  const int w21 = rs(-v21 * c24 - v26 * c8);
  const int w26 = rs(-v21 * c8 + v26 * c24);
  // stage 6 (odd butterflies)
  const int a16 = v16 + v23;
  const int a17 = v17 + v22;
  const int a18 = w18 + w21;
  const int a19 = w19 + w20;
  const int a20 = w19 - w20;
  const int a21 = w18 - w21;
  const int a22 = v17 - v22;
  const int a23 = v16 - v23;
  const int a24 = -v24 + v31;
  const int a25 = -v25 + v30;
  const int a26 = -w26 + w29;
  const int a27 = -w27 + w28;
  const int a28 = w27 + w28;
  const int a29 = w26 + w29;
  const int a30 = v25 + v30;
  const int a31 = v24 + v31;
  // stage 7 (odd rotations)
  const int b20 = rs((-a20 + a27) * c16);
  const int b27 = rs((a20 + a27) * c16);
  const int b21 = rs((-a21 + a26) * c16);
  const int b26 = rs((a21 + a26) * c16);
  const int b22 = rs((-a22 + a25) * c16);
  const int b25 = rs((a22 + a25) * c16);
  const int b23 = rs((-a23 + a24) * c16);
  const int b24 = rs((a23 + a24) * c16);
  const int odd[16] = {a16, a17, a18, a19, b20, b21, b22, b23,
                       b24, b25, b26, b27, a28, a29, a30, a31};
  // even half: idct16 of the even inputs
  int ein[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) ein[k] = x[2 * k];
  int e[16];
  idct16(ein, e);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    o[k] = e[k] + odd[15 - k];
    o[31 - k] = e[k] - odd[15 - k];
  }
}

// The 1-D inverse of length N (8, 16 or 32): out = idctN(in).
template <int N>
__device__ __forceinline__ void idct_n(const int* in, int* out) {
  static_assert(N == 8 || N == 16 || N == 32, "idct_n: N is 8, 16 or 32");
  if constexpr (N == 32) {
    idct32(in, out);
  } else if constexpr (N == 16) {
    idct16(in, out);
  } else {
    idct8(in, out);
  }
}

// One 1-D inverse of length N (8, 16 or 32) in place on x[0], x[stride],
// ...
template <int N>
__device__ __forceinline__ void idct_line(int* x, int stride) {
  int in[N], out[N];
#pragma unroll
  for (int k = 0; k < N; ++k) in[k] = x[k * stride];
  idct_n<N>(in, out);
#pragma unroll
  for (int k = 0; k < N; ++k) x[k * stride] = out[k];
}

// Element (i, j) of F_col @ R: f_col is N x N row-major, R int N x N at a
// pitch of rp. The sum runs k = 0 .. N-1.
template <int N>
__device__ __forceinline__ double fwd_cols(const double* __restrict__ f_col,
                                           const int* r, int rp, int i,
                                           int j) {
  double acc = 0.0;
#pragma unroll 8
  for (int k = 0; k < N; ++k) {
    acc += f_col[i * N + k] * static_cast<double>(r[k * rp + j]);
  }
  return acc;
}

// Element (i, j) of T @ F_row^T: t is N x N row-major, f_row_t the
// transposed row matrix, N x N row-major.
template <int N>
__device__ __forceinline__ double fwd_rows(const double* t,
                                           const double* __restrict__ f_row_t,
                                           int i, int j) {
  double acc = 0.0;
#pragma unroll 8
  for (int k = 0; k < N; ++k) acc += t[i * N + k] * f_row_t[k * N + j];
  return acc;
}

// d += A @ B for one 8x8x4 tile on the float64 tensor cores (mma.sync
// m8n8k4 .f64), a warp at a time. The PTX fragment layout, per lane:
// a = A[lane >> 2][lane & 3], b = B[lane & 3][lane >> 2], and
// (d0, d1) = D[lane >> 2][2 * (lane & 3) + {0, 1}]. A build of the
// sources off the card (a stand-in header that defines TXFM_MMA_STANDIN)
// supplies its own, with the same layout.
#ifndef TXFM_MMA_STANDIN
__device__ __forceinline__ void mma_f64_8x8x4(double& d0, double& d1,
                                              double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}
#endif

// Where element (row, col) of an N x N float64 plane that the tensor cores
// read lies in shared memory: row after row with no padding, each row's
// columns permuted (an XOR of the column index), so that the operand
// fragments of fwd_strip_mma meet no bank conflict. The residual R
// (fwd_res_at) is read four rows by eight columns (a lane each), and keeps
// four columns from a multiple of four together and in order; F_col
// (fwd_mat_at) is read eight rows by four neighbouring columns and, as
// F_row^T, eight rows by every other column.
template <int N>
__device__ __forceinline__ int fwd_res_at(int row, int col) {
  const int swz = N == 8 ? 4 * ((row >> 1) & 1) : 4 * (row & 3);
  return row * N + (col ^ swz);
}
template <int N>
__device__ __forceinline__ int fwd_mat_at(int row, int col) {
  const int swz = N == 8 ? 5 * ((row >> 1) & 1)
                         : 5 * (row & 1) + 8 * ((row >> 1) & 1);
  return row * N + (col ^ swz);
}

// Rows 8 s .. 8 s + 7 of X = F_col @ R @ F_row^T for one n x n block on
// the tensor cores, by one warp; f_col (fwd_mat_at) and R (fwd_res_at) are
// float64 planes in shared memory. F_row^T is F_col^T / 2^shift exactly
// (shift 5 at n = 8, 6 above: both are the inverse's matrix inverted, one
// scaled by the inverse's final shift), so the second product reads F_col
// transposed and scales X by a power of two at the end, which changes no
// bit. On return the lane holds x[J][e] = X[8 s + (lane >> 2)][8 J + 2
// (lane & 3) + e]. T = F_col @ R is exact in any order (the products and
// sums of the float32 matrices' values with 9-bit integers need at most 41
// bits); only the second product's order differs from a plain matrix
// product's. T's accumulator fragments (two neighbouring columns a lane)
// are the second product's operand fragments as they stand: its terms are
// taken in the order k = 8 K + 2 (lane & 3) + h, the B fragments to match.
template <int N>
__device__ __forceinline__ void fwd_strip_mma(const double* f_col,
                                              const double* r, int s,
                                              int lane, double (&x)[N / 8][2]) {
  constexpr int kTiles = N / 8;
  constexpr double kRowScale = N == 8 ? 1.0 / 32 : 1.0 / 64;
  const int g = lane >> 2, c = lane & 3;
  double t[kTiles][2];
#pragma unroll
  for (int j = 0; j < kTiles; ++j) t[j][0] = t[j][1] = 0.0;
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const double a = f_col[fwd_mat_at<N>(8 * s + g, 4 * k + c)];
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      mma_f64_8x8x4(t[j][0], t[j][1], a,
                    r[fwd_res_at<N>(4 * k + c, 8 * j + g)]);
    }
  }
#pragma unroll
  for (int j = 0; j < kTiles; ++j) x[j][0] = x[j][1] = 0.0;
#pragma unroll
  for (int k = 0; k < kTiles; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        mma_f64_8x8x4(x[j][0], x[j][1], t[k][h],
                      f_col[fwd_mat_at<N>(8 * j + g, 8 * k + 2 * c + h)]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    x[j][0] *= kRowScale;
    x[j][1] *= kRowScale;
  }
}

// The step of coefficient (i, j): dc_q at (0, 0), else ac_q.
__device__ __forceinline__ int coef_q(int i, int j, int dc_q, int ac_q) {
  return (i == 0 && j == 0) ? dc_q : ac_q;
}

// floor(|c| / q_eff + 0.38f), clipped to kMaxLevel, with c's sign; q_eff
// is q / 2 at n = 32.
__device__ __forceinline__ int quantize(double c, int q, int n) {
  const double qe = n == 32 ? static_cast<double>(q) * 0.5
                            : static_cast<double>(q);
  double v = floor(fabs(c) / qe + kQBias);
  v = fmin(v, static_cast<double>(kMaxLevel));
  const int level = static_cast<int>(v);
  return c < 0.0 ? -level : level;
}

// a / qe rounded to nearest, for a >= 0 and qe an integer or half of one
// (a quantizer step), from d = a * r, r = 1 / qe rounded (d is within
// 2.0001 ulps of the quotient): of d and its two neighbours on either side,
// the one whose residual a - t * qe (one fma each) is least in magnitude.
// No quotient lies halfway between two doubles: such a quotient is an odd
// 54-bit integer M times a power of two, and a = M qe would then have an
// odd part of 54 bits or more, which no double holds. So the least
// residual is the rounded quotient's. No division and no call.
__device__ __forceinline__ double div_rn_from_rcp(double a, double qe,
                                                  double d) {
  double best = d, err = fabs(fma(-d, qe, a));
  const long long bits = __double_as_longlong(d);
#pragma unroll
  for (int k = -2; k <= 2; ++k) {
    if (k == 0) continue;
    const double t = __longlong_as_double(bits + k);
    const double e = fabs(fma(-t, qe, a));
    if (e < err) {
      best = t;
      err = e;
    }
  }
  return best;
}

// quantize(c, q, n) from q_eff (q, or q / 2 at n = 32) and its reciprocal
// r = 1 / q_eff, without a division. |c| * r + 0.38f, each step rounded
// once, lies within about 1e-11 of the exact |c| / q_eff + 0.38f below
// 8192 (|c| * r is within 2.0001 ulps of |c| / q_eff, itself within half
// an ulp of the rounded quotient), so it has the same floor unless it lies
// within 2^-20 of an integer; there, and only there below the clip, the
// rounded quotient decides (div_rn_from_rcp). At or above 8192 both clip
// to kMaxLevel. The multiply and the add are kept unfused.
__device__ __forceinline__ int quantize_rcp(double c, double qe, double r) {
  const double a = fabs(c);
  const double d = __dmul_rn(a, r);
  double v = __dadd_rn(d, kQBias);
  if (v < 8192.0 && fabs(v - rint(v)) < 0x1p-20) {
    v = __dadd_rn(div_rn_from_rcp(a, qe, d), kQBias);
  }
  const int level = static_cast<int>(fmin(floor(v),
                                          static_cast<double>(kMaxLevel)));
  return c < 0.0 ? -level : level;
}

// Normative dequantization: |level| * q, >> 1 at n = 32, sign restored.
__device__ __forceinline__ int dequant(int level, int q, int n) {
  int mag = (level < 0 ? -level : level) * q;
  if (n == 32) mag >>= 1;
  return level < 0 ? -mag : mag;
}

// The recon of one pixel of an n x n block from the inverse's output x and
// the prediction: the final shift is 5 at n = 8 and 6 at n = 16 and 32.
__device__ __forceinline__ uint8_t recon_pixel(int pred, int x, int n) {
  const int shift = n == 8 ? 5 : 6;
  const int v = pred + ((x + (1 << (shift - 1))) >> shift);
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// The column pass of the inverse and the recon in one: the 1-D inverse of
// length N on x[0], x[stride], ..., then pixel k of the column, p[k *
// pstride], from the prediction it holds to the recon (recon_pixel).
template <int N>
__device__ __forceinline__ void idct_col_recon(const int* x, int stride,
                                               uint8_t* p, int pstride) {
  int in[N], out[N];
#pragma unroll
  for (int k = 0; k < N; ++k) in[k] = x[k * stride];
  idct_n<N>(in, out);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    p[k * pstride] = recon_pixel(p[k * pstride], out[k], N);
  }
}

}  // namespace txfm
