// Byte gathers of the realtime P-frame step: the search windows of a
// zone, and the border extension of a recon, each one launch.
//
// Replaces the XLA stages of tpu_vp9/pipeline/tpu_encdec.py:
// _extract_search_windows (:296) and extend_borders_device (:112); the
// contracts are the plain versions beside the step,
// tpu_vp9_torch/pipeline/tpu_encdec.py: _extract_search_windows and
// extend_borders_device.
//
//  1. extract_windows: up to kMaxJobs window sets of one zone of rows x
//     cols blocks, each out of its own border-extended plane: window b =
//     (row, col) of a set is the (sw, sw) region at (y0 + n row, x0 + n
//     col), sw = n + 2r + 8, stored contiguously, window after window.
//     The call sites cut LAST's luma windows (the search) and ALTREF's
//     (its search); motion compensation reads the planes in place
//     (csrc/mc_predict.cu). A CTA of 256 threads per window (blockIdx.x)
//     and set (blockIdx.y), 16 rows at a time and 16 lanes a row: where
//     sw is a multiple of 8 (every window row 8-byte aligned) a lane
//     stores 8 bytes of a row at once, read as the aligned 32-bit words
//     that hold them (two where the row starts on a word, as every luma
//     window does: x0 + n col = 52 + n col, pitch W + 192; three realigned
//     with __funnelshift_r where it does not); any other sw a byte a lane.
//  2. extend_borders: up to kMaxJobs planes, each (H, W) into (H + 2
//     border, W + 2 border): out[i][j] = plane[clamp(i - border, 0,
//     crop_h - 1)][clamp(j - border, 0, crop_w - 1)], the visible crop
//     replicated outward (libvpx's extend_frame). A recon's three planes
//     are one launch, the jobs' output rows one grid: a warp per row,
//     kRowWarps rows a CTA, each warp finding its job among the rows'
//     prefix sums and its source row (the clamp) once. Where the output
//     and source rows start on 16-byte boundaries and the border is a
//     multiple of 16 (every plane of the real step: BORDER 96, widths
//     multiples of 32), a lane stores whole 16-byte words of the row: an
//     interior word whose 16 source bytes lie inside the crop is one
//     16-byte load, a word left of the crop the byte row[0] broadcast, one
//     right of it row[crop_w - 1] broadcast, and only the word that holds
//     column crop_w - 1 + border (crop_w no multiple of 16) byte by byte.
//     Other rows (chroma rows no multiple of 16, odd widths, a border no
//     multiple of 16) store the 16-byte words of the flat output that
//     start in the row, each gathered byte by byte (it may span the next
//     rows); the last word of an output whose size is no multiple of 16
//     byte by byte.
//
// What bounds them on an H100: bytes. A 1080p M8 P-frame's search site
// writes 2040 windows of 120 x 120, 29.4 MB, and reads about 4 MB of its
// plane (the windows overlap, so the reads hit in L2): 0.0095 ms at 3.35
// TB/s. A warp's stores are two window rows of 120 contiguous bytes. A
// 1080p recon's borders write 4.4 MB and read its 3.1 MB crop: 0.0022 ms;
// its 2,752 output rows are 344 CTAs, 2.6 per SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxJobs = 8;
constexpr int kThreads = 256;

// extract_windows: a window set
struct WinJob {
  const uint8_t* src;  // the plane
  uint8_t* out;        // (B, sw, sw), 16-byte aligned
  int pitch;           // the plane's row length
  int n, sw;           // the grid's step, the window's side
  int y0, x0;          // the zone's first window's origin in the plane
};

struct WinJobs {
  WinJob job[kMaxJobs];
  int cols;  // the zone's block columns
};

// extend_borders: a plane
struct Job {
  const uint8_t* src;  // the plane
  uint8_t* out;        // contiguous output, 16-byte aligned
  int64_t bytes;       // output bytes
  int row0;            // the job's first output row in the grid
  int pitch;           // the plane's row length
  // the output row length (W + 2 border), border, crop_w, crop_h
  int a, b, c, d;
  int aligned;         // rows in whole 16-byte words (ow, border, the
                       // plane's start and pitch multiples of 16)
};

struct Jobs {
  Job job[kMaxJobs];
  int n_jobs;
  int rows;  // all jobs' output rows
};

// extend_borders: a warp per output row
constexpr int kRowWarps = kThreads / 32;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The job that output row r of the grid belongs to
__device__ __forceinline__ int find_job(const Jobs& js, int r) {
  int j = 0;
  while (j + 1 < js.n_jobs && js.job[j + 1].row0 <= r) ++j;
  return j;
}

// Stores the len <= 16 bytes of a job's output from e0 on, next() giving
// them in order; a full word (16-byte aligned: the output is, and e0 is a
// multiple of 16) in one store.
template <class F>
__device__ __forceinline__ void store_word(uint8_t* out, int64_t e0, int len,
                                          F next) {
  if (len == 16) {
    uint32_t w[4];
    for (int q = 0; q < 4; ++q) {
      w[q] = 0;
      for (int k = 0; k < 4; ++k) {
        w[q] |= static_cast<uint32_t>(next()) << (8 * k);
      }
    }
    *reinterpret_cast<uint4*>(out + e0) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int k = 0; k < len; ++k) out[e0 + k] = next();
  }
}

// Window blockIdx.x of set blockIdx.y: thread t stores rows t / 16 + 16 k
// of it, lane t % 16 of a row.
__global__ void __launch_bounds__(kThreads)
    extract_windows_kernel(WinJobs js) {
  const WinJob& jb = js.job[blockIdx.y];
  const int w = blockIdx.x;
  const int row = w / js.cols;
  const int col = w - row * js.cols;
  const int64_t pitch = jb.pitch;
  const int sw = jb.sw;
  const uint8_t* src = jb.src + (jb.y0 + jb.n * row) * pitch + jb.x0 +
                       jb.n * col;
  uint8_t* out = jb.out + static_cast<int64_t>(w) * sw * sw;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  if (sw % 8 == 0) {
    // 8 bytes a store: the row's bytes 8q..8q+7 out of the aligned words
    // that hold them (the third only where the row starts inside a word)
    for (int r = ty; r < sw; r += 16) {
      const uintptr_t at = reinterpret_cast<uintptr_t>(src + r * pitch);
      const unsigned sh = 8u * static_cast<unsigned>(at & 3);
      const uint32_t* s =
          reinterpret_cast<const uint32_t*>(at & ~uintptr_t{3});
      uint2* o = reinterpret_cast<uint2*>(out + r * sw);
      for (int q = tx; q < sw / 8; q += 16) {
        const uint32_t w0 = s[2 * q], w1 = s[2 * q + 1];
        const uint32_t w2 = sh != 0 ? s[2 * q + 2] : 0u;
        o[q] = make_uint2(__funnelshift_r(w0, w1, sh),
                          __funnelshift_r(w1, w2, sh));
      }
    }
  } else {
    for (int r = ty; r < sw; r += 16) {
      const uint8_t* s = src + r * pitch;
      uint8_t* o = out + r * sw;
      for (int c = tx; c < sw; c += 16) o[c] = s[c];
    }
  }
}

// Output row blockIdx.x * kRowWarps + warp of the grid: its job's row i
// (__grid_constant__: the job found by index is read in place among the
// parameters, not copied to the thread's stack).
__global__ void __launch_bounds__(kThreads)
    extend_borders_kernel(const __grid_constant__ Jobs js) {
  const int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= js.rows) return;
  const int lane = threadIdx.x & 31;
  const Job& jb = js.job[find_job(js, r)];
  const int ow = jb.a, border = jb.b, crop_w = jb.c, crop_h = jb.d;
  const int pitch = jb.pitch;
  const int i = r - jb.row0;
  auto row_of = [&](int ii) {
    return jb.src + static_cast<int64_t>(clampi(ii - border, 0, crop_h - 1)) *
                        pitch;
  };
  const uint8_t* __restrict__ row = row_of(i);
  const int64_t e_row = static_cast<int64_t>(i) * ow;
  if (jb.aligned) {
    uint8_t* __restrict__ out = jb.out + e_row;
    const uint32_t lw = 0x01010101u * row[0];
    const uint32_t rw = 0x01010101u * row[crop_w - 1];
#pragma unroll 4
    for (int q = lane; q < ow / 16; q += 32) {
      const int c0 = 16 * q - border;  // the word's first source column
      uint4 v;
      if (c0 < 0) {  // c0 + 15 < 0 too: the border is a multiple of 16
        v = make_uint4(lw, lw, lw, lw);
      } else if (c0 >= crop_w - 1) {
        v = make_uint4(rw, rw, rw, rw);
      } else if (c0 + 16 <= crop_w) {
        v = *reinterpret_cast<const uint4*>(row + c0);
      } else {  // the word that holds column crop_w - 1
        uint32_t w[4];
        for (int p = 0; p < 4; ++p) {
          w[p] = 0;
          for (int b = 0; b < 4; ++b) {
            w[p] |= static_cast<uint32_t>(row[min(c0 + 4 * p + b,
                                                  crop_w - 1)])
                    << (8 * b);
          }
        }
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(out + 16 * q) = v;
    }
    return;
  }
  // the 16-byte words of the flat output that start in this row
  const int64_t w1 = (e_row + ow + 15) / 16;
  for (int64_t wd = (e_row + 15) / 16 + lane; wd < w1; wd += 32) {
    const int64_t e0 = 16 * wd;
    const int64_t left = jb.bytes - e0;
    int ii = i;
    int j = static_cast<int>(e0 - e_row);
    const uint8_t* rr = row;
    store_word(jb.out, e0, left < 16 ? static_cast<int>(left) : 16,
               [&]() -> uint8_t {
                 const uint8_t v = rr[clampi(j - border, 0, crop_w - 1)];
                 if (++j == ow) {
                   j = 0;
                   rr = row_of(++ii);
                 }
                 return v;
               });
  }
}

// Fills the jobs' first rows and their path; false if a job is refused.
bool plan(Jobs& js, int n_jobs) {
  if (n_jobs < 1 || n_jobs > kMaxJobs) return false;
  js.n_jobs = n_jobs;
  int64_t rows = 0;
  for (int j = 0; j < n_jobs; ++j) {
    Job& jb = js.job[j];
    if (jb.src == nullptr || jb.out == nullptr || jb.bytes < 0 ||
        reinterpret_cast<uintptr_t>(jb.out) % 16 != 0) {
      return false;
    }
    jb.row0 = static_cast<int>(rows);
    rows += jb.a > 0 ? jb.bytes / jb.a : 0;
    if (rows > 0x7fffffff - kRowWarps) return false;
    jb.aligned = jb.a % 16 == 0 && jb.b % 16 == 0 && jb.pitch % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(jb.src) % 16 == 0;
  }
  js.rows = static_cast<int>(rows);
  return true;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

cudaError_t launch_extract(const WinJobs& js, int n_win, int n_jobs,
                           cudaStream_t s) {
  if (n_win == 0) return cudaSuccess;
  extract_windows_kernel<<<dim3(n_win, n_jobs), kThreads, 0, s>>>(js);
  return cudaGetLastError();
}

cudaError_t launch_borders(const Jobs& js, cudaStream_t s) {
  if (js.rows == 0) return cudaSuccess;
  extend_borders_kernel<<<(js.rows + kRowWarps - 1) / kRowWarps, kThreads, 0,
                          s>>>(js);
  return cudaGetLastError();
}

}  // namespace

// n_jobs window sets of one zone of rows x cols blocks: jobs holds eight
// int64 a set: the plane (rows of `pitch` bytes, any start), the output
// (b, sw, sw) uint8 (16-byte aligned), the pitch, the plane's height, the
// block size n, the window side sw and the zone's first window's origin
// (y0, x0) in the plane. A set whose windows leave their plane is refused
// (cudaErrorInvalidValue, nothing launched). Returns cudaGetLastError()
// after the launch.
extern "C" int extract_windows_launch(const int64_t* jobs, int n_jobs,
                                      int rows, int cols, void* stream) {
  WinJobs js;
  if (n_jobs < 1 || n_jobs > kMaxJobs || rows < 0 || cols < 1 ||
      static_cast<int64_t>(rows) * cols > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int j = 0; j < n_jobs; ++j) {
    const int64_t* v = jobs + 8 * j;
    const int64_t pitch = v[2], height = v[3], n = v[4], sw = v[5];
    const int64_t y0 = v[6], x0 = v[7];
    if (v[0] == 0 || v[1] == 0 || v[1] % 16 != 0 || n < 1 || sw < 1 ||
        y0 < 0 || x0 < 0 || pitch > 0x7fffffff ||
        (rows > 0 && (y0 + (rows - 1) * n + sw > height ||
                      x0 + (cols - 1) * n + sw > pitch))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    WinJob& jb = js.job[j];
    jb.src = reinterpret_cast<const uint8_t*>(v[0]);
    jb.out = reinterpret_cast<uint8_t*>(v[1]);
    jb.pitch = static_cast<int>(pitch);
    jb.n = static_cast<int>(n);
    jb.sw = static_cast<int>(sw);
    jb.y0 = static_cast<int>(y0);
    jb.x0 = static_cast<int>(x0);
  }
  js.cols = cols;
  return static_cast<int>(launch_extract(js, rows * cols, n_jobs,
                                         static_cast<cudaStream_t>(stream)));
}

// n_jobs planes: plane j srcs[j] (hs[j], ws[j]) uint8, contiguous, its
// visible crop (crop_ws[j], crop_hs[j]) (1 <= crop <= the plane's side);
// out outs[j] (hs[j] + 2 border, ws[j] + 2 border), 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int extend_borders_launch(const void* const* srcs,
                                     void* const* outs, const int* hs,
                                     const int* ws, const int* crop_ws,
                                     const int* crop_hs, int n_jobs,
                                     int border, void* stream) {
  Jobs js;
  if (n_jobs < 1 || n_jobs > kMaxJobs || border < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int j = 0; j < n_jobs; ++j) {
    Job& jb = js.job[j];
    if (crop_ws[j] < 1 || crop_hs[j] < 1 || crop_ws[j] > ws[j] ||
        crop_hs[j] > hs[j]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    jb.src = static_cast<const uint8_t*>(srcs[j]);
    jb.out = static_cast<uint8_t*>(outs[j]);
    jb.pitch = ws[j];
    jb.a = ws[j] + 2 * border;
    jb.b = border;
    jb.c = crop_ws[j];
    jb.d = crop_hs[j];
    jb.bytes = static_cast<int64_t>(hs[j] + 2 * border) * jb.a;
  }
  if (!plan(js, n_jobs)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_borders(js, static_cast<cudaStream_t>(stream)));
}

// Kernel `which` (0 extract_windows, 1 extend_borders) on the current
// device: *ctas_per_sm the CTAs an SM holds at once, *smem_bytes the
// dynamic shared memory each asks for (none). Returns the CUDA error of
// the query (0 if none).
extern "C" int windows_occupancy(int which, int* ctas_per_sm,
                                 int* smem_bytes) {
  *smem_bytes = 0;
  switch (which) {
    case 0:
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, extract_windows_kernel, kThreads, 0));
    case 1:
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, extend_borders_kernel, kThreads, 0));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
