// Byte gathers of the realtime P-frame step: the search and MC windows of
// a zone, and the border extension of a recon, each one launch.
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
//     The call sites cut LAST's luma windows (the search), ALTREF's (its
//     search), and LAST's chroma with GOLDEN's three planes and ALTREF's
//     chroma (MC) in one launch each.
//  2. extend_borders: up to kMaxJobs planes, each (H, W) into (H + 2
//     border, W + 2 border): out[i][j] = plane[clamp(i - border, 0,
//     crop_h - 1)][clamp(j - border, 0, crop_w - 1)], the visible crop
//     replicated outward (libvpx's extend_frame). A recon's three planes
//     are one launch.
// Both treat each output as a flat array of bytes cut into 16-byte words,
// a thread a word: the thread gathers the word's 16 bytes (which may span
// two rows of a window, or two windows) with byte loads and stores them
// with one 16-byte store; only the last word of an output whose size is
// no multiple of 16 is stored byte by byte. The jobs' words follow each
// other in one grid; a CTA finds its job among the prefix sums (a CTA's
// words may span two jobs).
//
// What bounds them on an H100: bytes. A 1080p M8 P-frame's MC site writes
// 2040 windows of 120 x 120 (GOLDEN's luma) and four sets of 66 x 66
// (chroma), 65 MB, and reads about 5 MB of planes (the windows overlap,
// so the reads hit in L2): 0.021 ms at 3.35 TB/s. The source bytes of a
// warp's 32 words are 512 neighbouring bytes of a plane row (or two), so
// the loads coalesce; the stores are whole 16-byte words.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxJobs = 8;
constexpr int kThreads = 256;

struct Job {
  const uint8_t* src;  // the plane
  uint8_t* out;        // contiguous output
  int64_t bytes;       // output bytes
  int64_t word0;       // the job's first word in the grid
  int pitch;           // the plane's row length
  // windows: n, sw, the zone's (y0, x0) in the plane; borders: the output
  // row length (W + 2 border), border, crop_w, crop_h
  int a, b, c, d;
};

struct Jobs {
  Job job[kMaxJobs];
  int n_jobs;
  int cols;      // windows: the zone's block columns
  int64_t words;  // all jobs' words
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The job that word w of the grid belongs to
__device__ __forceinline__ int find_job(const Jobs& js, int64_t w) {
  int j = 0;
  while (j + 1 < js.n_jobs && js.job[j + 1].word0 <= w) ++j;
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

// The word of this thread: its job, its first byte and its length, or
// false past the last word
__device__ __forceinline__ bool my_word(const Jobs& js, const Job*& jb,
                                        int64_t& e0, int& len) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= js.words) return false;
  jb = &js.job[find_job(js, w)];
  e0 = (w - jb->word0) * 16;
  const int64_t left = jb->bytes - e0;
  len = left < 16 ? static_cast<int>(left) : 16;
  return true;
}

__global__ void __launch_bounds__(kThreads) extract_windows_kernel(Jobs js) {
  const Job* jb;
  int64_t e0;
  int len;
  if (!my_word(js, jb, e0, len)) return;
  const int n = jb->a, sw = jb->b, y0 = jb->c, x0 = jb->d;
  const int pitch = jb->pitch;
  const uint8_t* src = jb->src;
  const int cols = js.cols;
  // the first byte's window, row and column; then along the window
  const int64_t win = static_cast<int64_t>(sw) * sw;
  int64_t b = e0 / win;
  const int rem = static_cast<int>(e0 - b * win);
  int r = rem / sw, c = rem - r * sw;
  auto origin = [&](int64_t blk) {
    const int row = static_cast<int>(blk / cols);
    const int col = static_cast<int>(blk - static_cast<int64_t>(row) * cols);
    return src + static_cast<int64_t>(y0 + n * row) * pitch + x0 + n * col;
  };
  const uint8_t* at = origin(b) + static_cast<int64_t>(r) * pitch;
  store_word(jb->out, e0, len, [&]() -> uint8_t {
    const uint8_t v = at[c];
    if (++c == sw) {
      c = 0;
      at += pitch;
      if (++r == sw) {
        r = 0;
        at = origin(++b);
      }
    }
    return v;
  });
}

__global__ void __launch_bounds__(kThreads) extend_borders_kernel(Jobs js) {
  const Job* jb;
  int64_t e0;
  int len;
  if (!my_word(js, jb, e0, len)) return;
  const int ow = jb->a, border = jb->b, crop_w = jb->c, crop_h = jb->d;
  const int pitch = jb->pitch;
  const uint8_t* src = jb->src;
  int i = static_cast<int>(e0 / ow);
  int j = static_cast<int>(e0 - static_cast<int64_t>(i) * ow);
  auto row_of = [&](int ii) {
    return src + static_cast<int64_t>(clampi(ii - border, 0, crop_h - 1)) *
                     pitch;
  };
  const uint8_t* row = row_of(i);
  store_word(jb->out, e0, len, [&]() -> uint8_t {
    const uint8_t v = row[clampi(j - border, 0, crop_w - 1)];
    if (++j == ow) {
      j = 0;
      row = row_of(++i);
    }
    return v;
  });
}

// Fills the jobs' word offsets; false if a job is refused.
bool plan(Jobs& js, int n_jobs) {
  if (n_jobs < 1 || n_jobs > kMaxJobs) return false;
  js.n_jobs = n_jobs;
  int64_t words = 0;
  for (int j = 0; j < n_jobs; ++j) {
    Job& jb = js.job[j];
    if (jb.src == nullptr || jb.out == nullptr || jb.bytes < 0 ||
        reinterpret_cast<uintptr_t>(jb.out) % 16 != 0) {
      return false;
    }
    jb.word0 = words;
    words += (jb.bytes + 15) / 16;
  }
  js.words = words;
  return (words + kThreads - 1) / kThreads <= 0x7fffffff;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

cudaError_t launch_extract(const Jobs& js, cudaStream_t s) {
  if (js.words == 0) return cudaSuccess;
  const int grid = static_cast<int>((js.words + kThreads - 1) / kThreads);
  extract_windows_kernel<<<grid, kThreads, 0, s>>>(js);
  return cudaGetLastError();
}

cudaError_t launch_borders(const Jobs& js, cudaStream_t s) {
  if (js.words == 0) return cudaSuccess;
  const int grid = static_cast<int>((js.words + kThreads - 1) / kThreads);
  extend_borders_kernel<<<grid, kThreads, 0, s>>>(js);
  return cudaGetLastError();
}

}  // namespace

// n_jobs window sets of one zone of b = rows x cols blocks: for set j the
// plane srcs[j] (rows of pitches[j] bytes), the block size ns[j], the
// window side sws[j] and the zone's first window's origin (y0s[j],
// x0s[j]) in the plane (every window inside it: the wrapper checks),
// the output outs[j] (b, sws[j], sws[j]) uint8, 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int extract_windows_launch(const void* const* srcs,
                                      void* const* outs, const int* pitches,
                                      const int* ns, const int* sws,
                                      const int* y0s, const int* x0s,
                                      int n_jobs, int rows, int cols,
                                      void* stream) {
  Jobs js;
  if (n_jobs < 1 || n_jobs > kMaxJobs || rows < 0 || cols < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int j = 0; j < n_jobs; ++j) {
    Job& jb = js.job[j];
    jb.src = static_cast<const uint8_t*>(srcs[j]);
    jb.out = static_cast<uint8_t*>(outs[j]);
    jb.pitch = pitches[j];
    jb.a = ns[j];
    jb.b = sws[j];
    jb.c = y0s[j];
    jb.d = x0s[j];
    jb.bytes = static_cast<int64_t>(rows) * cols * sws[j] * sws[j];
    if (sws[j] < 1 || ns[j] < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  js.cols = cols;
  if (!plan(js, n_jobs)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_extract(js, static_cast<cudaStream_t>(stream)));
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
  js.cols = 1;
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
