// The realtime P-frame step's transform stage: for a batch of n x n blocks
// (n = 8, 16 or 32), the residual src - pred, the forward DCT in float64,
// the dead-zone quantizer, the dequantizer, the exact integer inverse, the
// recon and the eob.
//
// Replaces the XLA stage tpu_vp9/pipeline/tpu_encdec.py:transform_recon
// (with _quantize:796 and _dequantize:807) for DCT_DCT blocks; its
// contract is the plain version beside the step,
// tpu_vp9_torch/pipeline/tpu_encdec.py:transform_recon_ref, whose forward
// half is float64 (txfm.fwd_txfm2d_f64, txfm.quantize_f64) and whose
// integer half is recon_from_levels. Levels, eob and recon equal the plain
// version's unless a coefficient's |c| / q + 0.38 lies within about 1e-12
// of an integer: T = F_col @ R is exact in any order, X = T @ F_row^T sums
// in another order than torch's matmul, and the quantizer keeps every bit
// of the true division (txfm::quantize_rcp).
//
// What bounds it on an H100: at the main path's largest shape (B = 2040
// blocks of 32x32) it moves about 10.4 MB (src and pred in, int16 levels,
// recon and eob out: 0.0031 ms at 3.35 TB/s) and does 2.7e8 float64
// operations in the two forward products (0.0040 ms at the float64 tensor
// cores' 67 TFLOP/s, 0.0079 ms at the CUDA cores' 34), so the float64 work
// bounds it, with the integer inverse (about 1e8 operations) beside it.
//
// The design. A warp takes 32 / n blocks at a time (one 32x32, two 16x16,
// four 8x8), so that in the inverse each of its lanes owns one line in
// each pass, and runs them through every phase on its own: between phases
// it waits for its own lanes only (__syncwarp), never for the CTA. The
// warps walk the batch in a grid-stride loop; a CTA of four warps stages
// F_col in shared memory once (the one CTA barrier), and at n = 32 an SM
// holds four CTAs, so that all 2040 blocks of a 1080p plane are in flight
// at once. Per group of a warp:
//   1. src and pred in 16-byte loads to shared bytes; the residual
//      converted to float64 once, four pixels a lane;
//   2. for each 8-row strip of each block, T = F_col @ R and X = T @
//      F_row^T on the tensor cores (mma.sync m8n8k4 f64;
//      txfm::fwd_strip_mma), T staying in registers as the second
//      product's operand and F_row^T read as F_col transposed; the
//      quantizer on X in registers (a reciprocal multiply, the rounded
//      quotient where a level could depend on it; txfm::quantize_rcp), the
//      levels to shared memory in 16-byte units permuted per row, the eob a
//      warp maximum over the uploaded inverse scan;
//   3. the inverse by rows (a lane reads its row's levels in 16-byte units
//      and dequantizes them) then by columns, a lane a line, on the int32
//      butterflies of txfm_common.cuh, in int32 planes that take the
//      residual's place; the column pass makes the recon in the
//      prediction's bytes;
//   4. levels and recon out in 16-byte stores.
// The kernel is launched with 128 threads and no other count.

#include <cstdint>
#include <cuda_runtime.h>

#include "txfm_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <int N>
struct Shape {
  static constexpr int kBlocks = 32 / N;     // blocks of a warp: 32 lines
  static constexpr int kPer = kWarps * kBlocks;  // blocks of a CTA
  static constexpr int kNN = N * N;
  static constexpr int kWarpPix = kBlocks * kNN;  // pixels of a warp
  static constexpr int kTiles = N / 8;       // also 16-byte units a row
  // 16-byte vectors of src (and of pred) a lane loads for its warp
  static constexpr int kVecs = (kWarpPix / 16 + 31) / 32;
  // dynamic shared memory, in bytes: F_col, then per block of the CTA its
  // residual plane (float64, later its inverse's int32 plane at a pitch of
  // n + 1), its bytes (src, later the levels as int16) and its pred bytes
  // (later the recon)
  static constexpr int kFcol = kNN * 8;
  static constexpr int kRes = kNN * 8;
  static constexpr int kBytes = kNN * 2;
  static constexpr int kSmem = kFcol + kPer * (kRes + kBytes + kNN);
  // CTAs an SM should hold: at n = 32 four (53,248 bytes of shared memory
  // each, at most 128 registers a thread), so that all 2040 blocks of a
  // 1080p plane are resident at once on 132 SMs
  static constexpr int kMinCtas = N == 32 ? 4 : 1;
  // a block's int32 plane starts b N words into its residual's place (b
  // its place among the warp's blocks), so that the passes, a lane a line
  // over the warp's blocks, meet no bank conflict
  static_assert((kBlocks - 1) * N + N * (N + 1) <= kRes / 4,
                "the inverse's plane fits the residual's place");
};

// Where level (y, x) of a block lies in its level plane: raster order,
// but the 16-byte units (eight levels) of row y permuted, unit u at
// u ^ f(y), so that the row pass (a lane a row, a unit at a time) and the
// quantizer's stores (eight rows by four pairs) meet no bank conflict.
template <int N>
__device__ __forceinline__ int level_at(int y, int x) {
  const int f = N == 32 ? (y >> 1) & 3 : (N == 16 ? (y >> 2) & 1 : 0);
  return y * N + 8 * ((x >> 3) ^ f) + (x & 7);
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// 16 bytes of global memory: one vector load when they are 16-byte
// aligned, else byte by byte
__device__ __forceinline__ uint4 load16(const uint8_t* src, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    w[e / 4] |= static_cast<uint32_t>(src[e]) << (8 * (e % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// F_col into shared memory (txfm::fwd_mat_at), by the whole CTA, and a
// barrier
template <int N>
__device__ __forceinline__ void stage_fcol(double* s_fc,
                                           const double* __restrict__ f_col,
                                           int tid) {
  for (int i = tid; i < N * N; i += kThreads) {
    s_fc[txfm::fwd_mat_at<N>(i / N, i % N)] = f_col[i];
  }
  __syncthreads();
}

template <int N>
__global__ void __launch_bounds__(kThreads, Shape<N>::kMinCtas)
transform_recon_kernel(const uint8_t* __restrict__ src,
                       const uint8_t* __restrict__ pred,
                       const double* __restrict__ f_col,
                       const int* __restrict__ iscan,
                       int16_t* __restrict__ levels, int* __restrict__ eob,
                       uint8_t* __restrict__ recon, int nblk, int dc_q,
                       int ac_q, int vec) {
  using S = Shape<N>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const double qe_dc = N == 32 ? 0.5 * dc_q : dc_q;
  const double qe_ac = N == 32 ? 0.5 * ac_q : ac_q;
  const double r_dc = 1.0 / qe_dc, r_ac = 1.0 / qe_ac;

  // the warp's planes: block b (of its kBlocks) has its residual at
  // s_r + b kNN (its int32 plane at s_int(b)), its bytes at s_src + b
  // kBytes (the levels at s_lv + b kNN), its pred bytes at s_pred + b kNN
  double* s_fc = reinterpret_cast<double*>(smem);
  double* s_r = reinterpret_cast<double*>(smem + S::kFcol) +
                warp * S::kBlocks * S::kNN;
  uint8_t* s_src = smem + S::kFcol + S::kPer * S::kRes +
                   warp * S::kBlocks * S::kBytes;
  int16_t* s_lv = reinterpret_cast<int16_t*>(s_src);
  uint8_t* s_pred = smem + S::kFcol + S::kPer * (S::kRes + S::kBytes) +
                    warp * S::kWarpPix;
  auto s_int = [&](int b) {
    return reinterpret_cast<int*>(s_r + b * S::kNN) + b * N;
  };

  // Each warp takes kBlocks blocks at a time ("its group"), in a grid-
  // stride loop over the warps of the grid; only the staging of F_col is
  // shared by the CTA. At n = 8 and 16 every warp fetches its first
  // group's src and pred before F_col is staged, so that the two wait on
  // memory together; at n = 32 F_col comes first (holding those loads
  // across the staging takes registers past the 128 that four CTAs an SM
  // leave, and ptxas spills).
  constexpr bool kStageFirst = N == 32;
  if (kStageFirst) stage_fcol<N>(s_fc, f_col, tid);
  const int ngroups = (nblk + S::kBlocks - 1) / S::kBlocks;
  const int stride = gridDim.x * kWarps;
  const int64_t total = static_cast<int64_t>(nblk) * S::kNN;
  for (int grp = blockIdx.x * kWarps + warp, pass = 0;; grp += stride,
           ++pass) {
    // the group's pixels are pixels pix0 .. pix0 + kWarpPix - 1 of the
    // batch; those at or past `total` belong to no block
    const int64_t blk0 = static_cast<int64_t>(grp) * S::kBlocks;
    const int64_t pix0 = blk0 * S::kNN;

    // 1. src and pred, 16 bytes a lane (a block's pixels are a multiple
    // of 16, so a vector lies in one block), then the residual in float64
    uint4 sv[S::kVecs], pv[S::kVecs];
#pragma unroll
    for (int v = 0; v < S::kVecs; ++v) {
      const int i = 16 * (lane + 32 * v);
      sv[v] = pv[v] = make_uint4(0, 0, 0, 0);
      if (grp < ngroups && i < S::kWarpPix && pix0 + i < total) {
        sv[v] = load16(src + pix0 + i, vec);
        pv[v] = load16(pred + pix0 + i, vec);
      }
    }
    if (!kStageFirst && pass == 0) stage_fcol<N>(s_fc, f_col, tid);
    if (grp >= ngroups) break;
#pragma unroll
    for (int v = 0; v < S::kVecs; ++v) {
      const int i = 16 * (lane + 32 * v);
      if (i < S::kWarpPix) {
        const int b = i / S::kNN, q = i % S::kNN;
        *reinterpret_cast<uint4*>(s_src + b * S::kBytes + q) = sv[v];
        *reinterpret_cast<uint4*>(s_pred + i) = pv[v];
      }
    }
    __syncwarp();
    for (int i = 4 * lane; i < S::kWarpPix; i += 4 * 32) {
      const int b = i / S::kNN, q = i % S::kNN;
      const uchar4 s4 =
          *reinterpret_cast<const uchar4*>(s_src + b * S::kBytes + q);
      const uchar4 p4 = *reinterpret_cast<const uchar4*>(s_pred + i);
      double2* out = reinterpret_cast<double2*>(
          s_r + b * S::kNN + txfm::fwd_res_at<N>(q / N, q % N));
      out[0] = make_double2(static_cast<int>(s4.x) - p4.x,
                            static_cast<int>(s4.y) - p4.y);
      out[1] = make_double2(static_cast<int>(s4.z) - p4.z,
                            static_cast<int>(s4.w) - p4.w);
    }
    __syncwarp();

    // 2. the forward transform and the quantizer, strip by strip; the
    // levels to their planes (over the source bytes), two a word
#pragma unroll
    for (int b = 0; b < S::kBlocks; ++b) {
      int top = 0;
#pragma unroll
      for (int s = 0; s < S::kTiles; ++s) {
        double x[S::kTiles][2];
        txfm::fwd_strip_mma<N>(s_fc, s_r + b * S::kNN, s, lane, x);
        const int y = 8 * s + g;
#pragma unroll
        for (int j = 0; j < S::kTiles; ++j) {
          uint32_t pair = 0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int xx = 8 * j + 2 * c + e;
            const bool dc = y == 0 && xx == 0;
            const int level = txfm::quantize_rcp(
                x[j][e], dc ? qe_dc : qe_ac, dc ? r_dc : r_ac);
            pair |= static_cast<uint32_t>(static_cast<uint16_t>(level))
                    << (16 * e);
            if (level != 0) top = max(top, __ldg(iscan + y * N + xx) + 1);
          }
          *reinterpret_cast<uint32_t*>(
              s_lv + b * S::kNN + level_at<N>(y, 8 * j + 2 * c)) = pair;
        }
      }
      top = warp_max(top);
      if (lane == 0 && blk0 + b < nblk) eob[blk0 + b] = top;
    }
    __syncwarp();

    // 3. the inverse, a lane a line: the rows of the warp's blocks (from
    // the levels, dequantized), then their columns and the recon
    {
      const int b = lane / N, y = lane % N;
      int in[N], out[N];
#pragma unroll
      for (int u = 0; u < S::kTiles; ++u) {
        const uint4 w = *reinterpret_cast<const uint4*>(
            s_lv + b * S::kNN + level_at<N>(y, 8 * u));
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int x = 8 * u + e;
          const int level =
              static_cast<int16_t>(words[e / 2] >> (16 * (e % 2)));
          in[x] = txfm::dequant(level, txfm::coef_q(y, x, dc_q, ac_q), N);
        }
      }
      txfm::idct_n<N>(in, out);
      int* row = s_int(b) + y * (N + 1);
#pragma unroll
      for (int x = 0; x < N; ++x) row[x] = out[x];
    }
    __syncwarp();
    {
      const int b = lane / N, x = lane % N;
      txfm::idct_col_recon<N>(s_int(b) + x, N + 1, s_pred + b * S::kNN + x,
                              N);
    }
    __syncwarp();

    // 4. levels and recon out: 16 pixels a lane, two units of levels
    for (int i = 16 * lane; i < S::kWarpPix; i += 16 * 32) {
      if (pix0 + i < total) {
        const int b = i / S::kNN, q = i % S::kNN;
        *reinterpret_cast<uint4*>(recon + pix0 + i) =
            *reinterpret_cast<const uint4*>(s_pred + i);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int qh = q + 8 * h;
          *reinterpret_cast<uint4*>(levels + pix0 + i + 8 * h) =
              *reinterpret_cast<const uint4*>(
                  s_lv + b * S::kNN + level_at<N>(qh / N, qh % N));
        }
      }
    }
    __syncwarp();  // the next group writes the planes again
  }
}

// The resident CTAs per SM at the kernel's dynamic shared memory, and
// the largest grid worth launching, once per instance and device (the
// attribute that lets a CTA have more than 48 KB is set there too)
template <int N>
cudaError_t prepare(int* ctas_per_sm, int* max_grid) {
  constexpr int kMaxDevices = 64;
  static int ctas[kMaxDevices], grid[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (grid[dev] == 0) {
    err = cudaFuncSetAttribute(transform_recon_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Shape<N>::kSmem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, transform_recon_kernel<N>, kThreads, Shape<N>::kSmem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    ctas[dev] = per_sm;
    grid[dev] = per_sm * sms;
  }
  *ctas_per_sm = ctas[dev];
  *max_grid = grid[dev];
  return cudaSuccess;
}

template <int N>
cudaError_t launch(const void* src, const void* pred, const void* f_col,
                   const void* iscan, void* levels, void* eob, void* recon,
                   int nblk, int dc_q, int ac_q, cudaStream_t stream) {
  int per_sm = 0, max_grid = 0;
  const cudaError_t err = prepare<N>(&per_sm, &max_grid);
  if (err != cudaSuccess) return err;
  const int ctas = (nblk + Shape<N>::kPer - 1) / Shape<N>::kPer;
  const int grid = ctas < max_grid ? ctas : max_grid;
  const int vec = ((reinterpret_cast<uintptr_t>(src) |
                    reinterpret_cast<uintptr_t>(pred)) & 15) == 0;
  transform_recon_kernel<N><<<grid, kThreads, Shape<N>::kSmem, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(pred),
      static_cast<const double*>(f_col), static_cast<const int*>(iscan),
      static_cast<int16_t*>(levels), static_cast<int*>(eob),
      static_cast<uint8_t*>(recon), nblk, dc_q, ac_q, vec);
  return cudaGetLastError();
}

template <int N>
int occupancy(int* ctas_per_sm, int* smem_bytes) {
  int max_grid = 0;
  *smem_bytes = Shape<N>::kSmem;
  return static_cast<int>(prepare<N>(ctas_per_sm, &max_grid));
}

}  // namespace

// nblk blocks of n x n (n = 8, 16 or 32): src, pred, levels (int16) and
// recon are (nblk, n, n) contiguous (levels and recon 16-byte aligned),
// eob (nblk,) int32; f_col the float64 forward column matrix of n, n x n
// row-major (the row matrix is its transpose over 2^5 at n = 8, 2^6
// above); iscan (n * n,) int32 each raster place's place in the DCT_DCT
// scan. Returns cudaGetLastError() after the launch.
extern "C" int transform_recon_launch(const void* src, const void* pred,
                                      const void* f_col, const void* iscan,
                                      void* levels, void* eob, void* recon,
                                      int nblk, int n, int dc_q, int ac_q,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 32:
      return static_cast<int>(launch<32>(src, pred, f_col, iscan, levels,
                                         eob, recon, nblk, dc_q, ac_q, s));
    case 16:
      return static_cast<int>(launch<16>(src, pred, f_col, iscan, levels,
                                         eob, recon, nblk, dc_q, ac_q, s));
    case 8:
      return static_cast<int>(launch<8>(src, pred, f_col, iscan, levels,
                                        eob, recon, nblk, dc_q, ac_q, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The kernel of block size n on the current device: *ctas_per_sm the CTAs
// of 128 threads an SM holds at once, *smem_bytes the dynamic shared
// memory each asks for. Returns the CUDA error of the query (0 if none).
extern "C" int transform_recon_occupancy(int n, int* ctas_per_sm,
                                         int* smem_bytes) {
  switch (n) {
    case 32:
      return occupancy<32>(ctas_per_sm, smem_bytes);
    case 16:
      return occupancy<16>(ctas_per_sm, smem_bytes);
    case 8:
      return occupancy<8>(ctas_per_sm, smem_bytes);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
