// Exhaustive full-pel SSE motion search, one CUDA block per image block,
// in two entry points that share one search routine:
//   sse_map_search_launch  one level: +-r around the window's centre, with
//                          an optional relative-SSE map;
//   hier_search_launch     the whole two-level search of a 32x32 block in
//                          one launch: 2x2 decimation, +-18 at half
//                          resolution with its map, the refine centre, the
//                          +-4 refine at full resolution and the 48x48
//                          window that the quarter-pel stage reads.
//
// Replaces tpu_vp9/pipeline/tpu_encdec.py:_full_search_sse_mxu (the XLA
// search stage) and, for the fused entry, hier_search around it: on the
// TPU the levels are separate XLA ops with the decimated windows, the
// gathered refine windows and the centre in device memory between them.
// Here the refine centre of a block depends only on that block's own
// half-res winner, so one CTA does both levels out of one copy of the
// window in shared memory. The fused entry reads the step's (B, 120, 120)
// windows, not the border-extended plane: the step makes them anyway (the
// motion compensation reads them), their rows are 8-byte aligned and one
// block's window is one contiguous 14.4 KB read.
//
// A window is (n+2r+8)^2 and its search area starts at offset (4, 4), so
// displacement (0, 0) sits at (r+4, r+4). A level returns the first
// minimum in dy-major order and the (D, D) int32 relative-SSE map
// sum(reg^2) - 2 sum(src*reg), which is the true SSE minus the block's
// sum(src^2).
//
// What bounds it on an H100: operations. At 1080p the half-res level is
// 2040*37^2*16^2 = 7.1e8 multiply-adds and the refine 1.7e8, on 31 MB
// read and 16 MB written. Of the two routes considered, (a) register
// tiling off the tensor cores and (b) mma.sync, this is (a), in the
// correlation form:
//   - sum(reg^2) of every candidate is a box sum over the area: row sums
//     of squares (a thread squares a run of a row once and slides a sum
//     over 8 neighbouring dx), then column sums sliding over dy likewise:
//     O(w*D) work, not O(D^2*n^2);
//   - the cross term sum(src*reg) is float32 FMA, the card's fastest
//     arithmetic off the tensor cores (twice the int32 multiply-add
//     rate), and exact: operands are integers <= 1020 held as floats in
//     shared memory, and an accumulator starts at 2^23 and takes at most
//     8 products of 10-bit operands (8*1020^2 < 2^23) or a row of 8-bit
//     ones (32*255^2 < 2^23), so it stays in [2^23, 2^24), where every
//     integer is a float and the sum sits in the mantissa bits; the
//     accumulators of one row are then added to an integer total as bits
//     (one 3-input integer add per 16 or more FMAs, no conversion) and
//     the 2^23s are taken off once at the end;
//   - a thread owns a strip of TX = 8 or 9 neighbouring dx of one dy and
//     some of the block's rows: per 8 columns it loads 8 source values
//     (two 16-byte broadcasts) and 8 new area values, keeps TX-1 from the
//     chunk before, and does 8*TX FMAs from registers, so a shared-memory
//     word is read once for 8 or 9 products (the first kernel read two
//     words per product);
//   - neighbouring lanes take neighbouring dy, whose area rows are an odd
//     pitch apart: no bank conflicts;
//   - where D^2 is small (the refine's 81) the rows are dealt over
//     threads as well (1 row each at the refine), partial sums meeting in
//     a shared-memory atomic add, so all warps work at every level;
//   - the map is put together in shared memory and written out in one
//     coalesced pass, which also builds the keys for the minimum;
//   - the fused kernel loads the window as 16-byte words, decimates four
//     outputs a thread with byte pairs summed in 16-bit lanes, and writes
//     the refine window as 4-byte words.
// What holds it to its bound: the cross term takes about 160 issue
// slots per 128 FMAs (loads, integer adds, addresses), the strips
// overhang the 37 columns by 3, and the other phases (loads, box sums,
// map, the two minima, the refine with its atomics) are chains of short
// dependent steps between barriers that only other CTAs of the SM (3 fit:
// 56 registers x 384 threads) can hide. The tensor cores (route (b)) would
// lift the cross term's rate but are not used: the exact forms need an
// 8-bit split of the 10-bit operands and a Toeplitz copy of the source.
//
// Exactness: every sum is an integer sum, in any order. int32 holds all of
// them: a row sum of squares is at most 32*1020^2 = 3.3e7 (summed as
// floats over at most 16 columns of 10-bit operands, 16*1020^2 < 2^24,
// then as integers), sum(reg^2) of a candidate at most 32*32*1020^2 =
// 1.07e9 (2.66e8 at the half-res level), twice the cross term the same.
// The true SSE of a candidate, rel + sum(src^2), is never negative, so
// the CTA reduces the unsigned key (sse << 32) | flat_index, whose minimum
// is the first minimum; the relative SSE, often negative, is only ever
// written to the map.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 384;  // the fused kernel's CTA; the most of any
constexpr int kChunk = 8;      // columns between two looks at the sums
constexpr int kPad = 16;       // readable floats after an area's last row
constexpr float kMagic = 8388608.0f;       // 2^23
constexpr uint32_t kMagicBits = 0x4B000000u;  // its bits
// dynamic shared memory one level may ask for: the 48 KB a kernel has
// without asking, less the kernel's static words
constexpr size_t kLevelSmemMax = 48 * 1024 - 512;

// Minimum of `key` over the CTA, returned to every thread. s_warp: 32
// words of shared memory, free again on return.
__device__ unsigned long long block_min(unsigned long long key,
                                        unsigned long long* s_warp) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, key, off);
    key = o < key ? o : key;
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = key;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  key = s_warp[0];
  for (int i = 1; i < nwarps; ++i) key = s_warp[i] < key ? s_warp[i] : key;
  __syncthreads();
  return key;
}

// Bytes 0+1 and 2+3 of a word, as its two 16-bit halves.
__device__ __forceinline__ uint32_t pair_sums(uint32_t v) {
  return (v & 0x00ff00ffu) + ((v >> 8) & 0x00ff00ffu);
}

// Adds v to *total over the CTA (a shuffle, then one atomic per warp).
__device__ void block_add(unsigned int v, unsigned int* total) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(total, v);
}

// One search level on operands in shared memory, by the whole CTA.
//   s_src   N x N floats, 16-byte aligned, integer values
//   s_area  N+2r rows of `pitch` floats (pitch odd), integer values, with
//           kPad readable floats after the last row
//   rg      the N rows of a candidate are dealt over rg threads (a power
//           of two <= N)
//   s_rows  (N+2r) * (2r+1) ints of scratch
//   s_rel   (2r+1)^2 ints: on return the relative-SSE map
// WIDE: the operands need 10 bits (values <= 1020), else 8 (<= 255). It
// sets how many products a float may sum exactly: a cross-term accumulator
// (from 2^23) takes kChunk columns of wide operands or a whole row of
// narrow ones, a plain float sum of squares 16 wide ones (16*1020^2 <
// 2^24) or a whole row of narrow ones. Ends with a __syncthreads().
template <int N, int TX, bool WIDE>
__device__ void search_level(const float* s_src, const float* s_area,
                             int pitch, int r, int rg, int32_t* s_rows,
                             int32_t* s_rel) {
  constexpr int CHUNKS = N / kChunk;
  constexpr int NACC = WIDE ? CHUNKS : 1;   // accumulators a row needs
  constexpr int PER_ACC = CHUNKS / NACC;    // chunks into each
  constexpr int G = (WIDE && N > 16) ? 16 : N;  // columns a float sum takes
  static_assert(N % kChunk == 0 && N % G == 0, "chunking");
  const int d = 2 * r + 1;
  const int w = N + 2 * r;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int strips8 = (d + 7) / 8;

  // row sums of squares, s_rows[j][dx] = sum_x area[j][dx + x]^2, 8
  // neighbouring dx a thread: each square once, then a sliding sum.
  // Neighbouring lanes take neighbouring rows (an odd pitch apart).
  for (int i = tid; i < w * strips8; i += nt) {
    const int j = i % w;
    const int dx0 = (i / w) * 8;
    const float* a = s_area + j * pitch + dx0;
    uint32_t sums[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) sums[k] = 0;
#pragma unroll
    for (int g = 0; g < N / G; ++g) {
      float sq[G + 7];
#pragma unroll
      for (int x = 0; x < G + 7; ++x) {
        const float v = a[g * G + x];
        sq[x] = v * v;
      }
      float run = sq[0];
#pragma unroll
      for (int x = 1; x < G; ++x) run += sq[x];
      sums[0] += static_cast<uint32_t>(run);
#pragma unroll
      for (int k = 1; k < 8; ++k) {
        run += sq[G - 1 + k] - sq[k - 1];
        sums[k] += static_cast<uint32_t>(run);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (dx0 + k < d) s_rows[j * d + dx0 + k] = static_cast<int32_t>(sums[k]);
    }
  }
  __syncthreads();
  // column sums, s_rel[dy][dx] = sum(reg^2) of the candidate, 8
  // neighbouring dy a thread, sliding likewise
  for (int i = tid; i < d * strips8; i += nt) {
    const int dx = i % d;
    const int dy0 = (i / d) * 8;
    const int32_t* p = s_rows + dy0 * d + dx;
    int32_t run = 0;
#pragma unroll 8
    for (int y = 0; y < N; ++y) run += p[y * d];
    s_rel[dy0 * d + dx] = run;
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      if (dy0 + k < d) {
        run += p[(N - 1 + k) * d] - p[(k - 1) * d];
        s_rel[(dy0 + k) * d + dx] = run;
      }
    }
  }
  __syncthreads();

  // the cross term, subtracted twice from s_rel
  const int strips = (d + TX - 1) / TX;
  const int rows = N / rg;
  const int tiles = d * strips * rg;
  for (int t = tid; t < tiles; t += nt) {
    const int dy = t % d;
    const int q = t / d;
    const int dx0 = (q % strips) * TX;
    const int y0 = (q / strips) * rows;
    // sums of the accumulators' bits: each carries kMagicBits too much
    uint32_t corr[TX];
#pragma unroll
    for (int i = 0; i < TX; ++i) corr[i] = 0;
    for (int y = y0; y < y0 + rows; ++y) {
      const float* a_row = s_area + (dy + y) * pitch + dx0;
      const float4* s_row = reinterpret_cast<const float4*>(s_src + y * N);
      float a[kChunk + TX - 1];
      float acc[NACC][TX];
#pragma unroll
      for (int k = 0; k < NACC; ++k) {
#pragma unroll
        for (int i = 0; i < TX; ++i) acc[k][i] = kMagic;
      }
#pragma unroll
      for (int i = 0; i < TX - 1; ++i) a[i] = a_row[i];
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
#pragma unroll
        for (int x = 0; x < kChunk; ++x)
          a[TX - 1 + x] = a_row[c * kChunk + TX - 1 + x];
        const float4 s0 = s_row[2 * c];
        const float4 s1 = s_row[2 * c + 1];
        const float s[kChunk] = {s0.x, s0.y, s0.z, s0.w,
                                 s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int x = 0; x < kChunk; ++x) {
#pragma unroll
          for (int i = 0; i < TX; ++i)
            acc[c / PER_ACC][i] = fmaf(s[x], a[x + i], acc[c / PER_ACC][i]);
        }
#pragma unroll
        for (int i = 0; i < TX - 1; ++i) a[i] = a[i + kChunk];
      }
      // one integer add per row takes two accumulators (a 3-input add)
#pragma unroll
      for (int i = 0; i < TX; ++i) {
        uint32_t bits = __float_as_uint(acc[0][i]);
#pragma unroll
        for (int k = 1; k < NACC; ++k) bits += __float_as_uint(acc[k][i]);
        corr[i] += bits;
      }
    }
    const uint32_t excess = static_cast<uint32_t>(rows * NACC) * kMagicBits;
    // a strip may overhang the map (and have read past the row's end:
    // other rows, or the pad); those sums are dropped here
#pragma unroll
    for (int i = 0; i < TX; ++i) {
      if (dx0 + i < d)
        atomicAdd(&s_rel[dy * d + dx0 + i],
                  -2 * static_cast<int32_t>(corr[i] - excess));
    }
  }
  __syncthreads();
}

// The first minimum of a level's map, as its key, to every thread; writes
// the map to g_map unless null. src2: the block's sum(src^2).
__device__ unsigned long long level_min(const int32_t* s_rel, int dd,
                                        unsigned int src2, int32_t* g_map,
                                        unsigned long long* s_warp) {
  unsigned long long best = ~0ull;
  for (int c = threadIdx.x; c < dd; c += blockDim.x) {
    const int32_t rel = s_rel[c];
    if (g_map != nullptr) g_map[c] = rel;
    const unsigned int sse = static_cast<unsigned int>(rel) + src2;
    const unsigned long long key =
        (static_cast<unsigned long long>(sse) << 32) | static_cast<unsigned>(c);
    best = key < best ? key : best;
  }
  return block_min(best, s_warp);
}

// rows of a candidate dealt over this many threads: the largest power of
// two that keeps the tiles within one round of kThreads
int pick_rg(int n, int d, int tx) {
  const int strips = (d + tx - 1) / tx;
  int rg = 1;
  while (rg * 2 <= n && d * strips * rg * 2 <= kThreads) rg *= 2;
  return rg;
}

// ---------------------------------------------------------------------------
// One level
// ---------------------------------------------------------------------------

template <typename T, int N, int TX>
__global__ void __launch_bounds__(kThreads)
sse_search_kernel(const T* __restrict__ src, const T* __restrict__ wins,
                  int r, int sw, int rg, int32_t* __restrict__ out_dy,
                  int32_t* __restrict__ out_dx,
                  int32_t* __restrict__ out_map) {
  extern __shared__ float4 smem4[];
  __shared__ unsigned long long s_warp[32];
  __shared__ unsigned int s_src2;

  const int blk = blockIdx.x;
  const int w = N + 2 * r;
  const int d = 2 * r + 1;
  const int pitch = w + 1;  // w is even
  float* s_src = reinterpret_cast<float*>(smem4);  // N x N
  float* s_area = s_src + N * N;                   // w x pitch + kPad
  int32_t* s_rows = reinterpret_cast<int32_t*>(s_area + w * pitch + kPad);
  int32_t* s_rel = s_rows + w * d;                 // d x d

  if (threadIdx.x == 0) s_src2 = 0;
  __syncthreads();

  const T* g_src = src + static_cast<size_t>(blk) * N * N;
  const T* g_win = wins + static_cast<size_t>(blk) * sw * sw;
  unsigned int sq = 0;
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int v = static_cast<int>(g_src[i]);
    s_src[i] = static_cast<float>(v);
    sq += static_cast<unsigned int>(v * v);
  }
  for (int i = threadIdx.x; i < w * pitch + kPad; i += blockDim.x) {
    const int y = i / pitch;
    const int x = i - y * pitch;
    s_area[i] = (y < w && x < w)
        ? static_cast<float>(g_win[(y + 4) * sw + x + 4]) : 0.0f;
  }
  block_add(sq, &s_src2);
  __syncthreads();

  search_level<N, TX, sizeof(T) != 1>(s_src, s_area, pitch, r, rg, s_rows,
                                      s_rel);
  int32_t* g_map = out_map == nullptr
      ? nullptr : out_map + static_cast<size_t>(blk) * d * d;
  const unsigned long long best = level_min(s_rel, d * d, s_src2, g_map,
                                            s_warp);
  if (threadIdx.x == 0) {
    const int idx = static_cast<int>(best & 0xffffffffu);
    out_dy[blk] = idx / d - r;
    out_dx[blk] = idx % d - r;
  }
}

// Shared memory of one level, in bytes (ops/cuda_kernels.py holds the
// wrapper to the same formula).
size_t level_smem(int n, int r) {
  const int w = n + 2 * r;
  const int d = 2 * r + 1;
  return sizeof(float) * (static_cast<size_t>(n) * n + w * (w + 1) + kPad
                          + w * d + d * d);
}

template <typename T, int N, int TX>
void launch(const void* src, const void* wins, int32_t* dy, int32_t* dx,
            int32_t* map, int b, int r, int sw, cudaStream_t stream) {
  const int d = 2 * r + 1;
  const int rg = pick_rg(N, d, TX);
  int threads = (d * ((d + TX - 1) / TX) * rg + 31) / 32 * 32;
  threads = threads < 128 ? 128 : threads;
  threads = threads < kThreads ? threads : kThreads;
  sse_search_kernel<T, N, TX><<<b, threads, level_smem(N, r), stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(wins), r, sw, rg, dy,
      dx, map);
}

template <typename T, int N>
void launch_tx(const void* src, const void* wins, int32_t* dy, int32_t* dx,
               int32_t* map, int b, int r, int sw, cudaStream_t st) {
  // the strip width that overhangs the map's D columns the least
  const int d = 2 * r + 1;
  const int waste8 = (d + 7) / 8 * 8 - d;
  const int waste9 = (d + 8) / 9 * 9 - d;
  if (waste9 <= waste8)
    launch<T, N, 9>(src, wins, dy, dx, map, b, r, sw, st);
  else
    launch<T, N, 8>(src, wins, dy, dx, map, b, r, sw, st);
}

template <typename T>
int dispatch(const void* src, const void* wins, int32_t* dy, int32_t* dx,
             int32_t* map, int b, int n, int r, int sw, cudaStream_t st) {
  if (r < 1 || level_smem(n, r) > kLevelSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
    case 8: launch_tx<T, 8>(src, wins, dy, dx, map, b, r, sw, st); break;
    case 16: launch_tx<T, 16>(src, wins, dy, dx, map, b, r, sw, st); break;
    case 32: launch_tx<T, 32>(src, wins, dy, dx, map, b, r, sw, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Both levels of the hierarchical search in one launch
// ---------------------------------------------------------------------------

constexpr int kWinR = 40;   // reach of the windows (WIN_R)
constexpr int kHalfR = 18;  // HALF_R
constexpr int kRefR = 4;    // REFINE_R

template <int N>
struct Hier {
  static constexpr int SW = N + 2 * kWinR + 8;  // window: 120
  static constexpr int NH = N / 2;              // half-res block: 16
  static constexpr int WH = NH + 2 * kHalfR;    // half-res area: 52
  static constexpr int DH = 2 * kHalfR + 1;     // 37
  static constexpr int WR = N + 2 * kRefR;      // refine area: 40
  static constexpr int DR = 2 * kRefR + 1;      // 9
  static constexpr int LOC = WR + 8;            // refine window: 48
  static constexpr int REACH = kWinR - kRefR;   // 36
  static constexpr int AREA =
      (WH * (WH + 1) > WR * (WR + 1) ? WH * (WH + 1) : WR * (WR + 1)) + kPad;
  static constexpr int ROWS = WH * DH > WR * DR ? WH * DH : WR * DR;
};

template <int N>
__global__ void __launch_bounds__(kThreads)
hier_search_kernel(const uint8_t* __restrict__ src,
                   const uint8_t* __restrict__ wins, int b,
                   int32_t* __restrict__ out5, uint8_t* __restrict__ out_loc,
                   int32_t* __restrict__ out_map) {
  using H = Hier<N>;
  static_assert(H::SW * H::SW % 16 == 0 && N * N % 4 == 0, "vector loads");
  // 43.9 KB at N = 32, inside the 48 KB a kernel has without asking
  __shared__ __align__(16) uint8_t s_win[H::SW * H::SW];
  __shared__ __align__(16) float s_src[N * N];
  __shared__ __align__(16) float s_srch[H::NH * H::NH];
  __shared__ float s_area[H::AREA];  // the half-res area, then the refine's
  __shared__ int32_t s_rows[H::ROWS];
  __shared__ int32_t s_rel[H::DH * H::DH];
  __shared__ unsigned long long s_warp[32];
  __shared__ unsigned int s_sums[2];  // sum(src^2) at full and half res

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < 2) s_sums[tid] = 0;

  // the window as bytes, 16 at a time (it is one contiguous run of
  // memory), and the source as floats
  const uint4* g_win = reinterpret_cast<const uint4*>(
      wins + static_cast<size_t>(blk) * H::SW * H::SW);
  uint4* s_win16 = reinterpret_cast<uint4*>(s_win);
  for (int i = tid; i < H::SW * H::SW / 16; i += kThreads)
    s_win16[i] = g_win[i];
  const uint32_t* g_src = reinterpret_cast<const uint32_t*>(
      src + static_cast<size_t>(blk) * N * N);
  unsigned int sq = 0;
  for (int i = tid; i < N * N / 4; i += kThreads) {
    const uint32_t v = g_src[i];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned int px = (v >> (8 * k)) & 0xffu;
      s_src[4 * i + k] = static_cast<float>(px);
      sq += px * px;
    }
  }
  __syncthreads();
  block_add(sq, &s_sums[0]);

  // 2x2 sums: the half-res source and the half-res area, which is rows
  // and columns 4 .. 4 + WH of the decimated window
  sq = 0;
  for (int i = tid; i < H::NH * H::NH; i += kThreads) {
    const int y = i / H::NH;
    const int x = i - y * H::NH;
    const float* p = s_src + 2 * y * N + 2 * x;
    const float v = p[0] + p[1] + p[N] + p[N + 1];
    s_srch[i] = v;
    const unsigned int vi = static_cast<unsigned int>(v);
    sq += vi * vi;
  }
  block_add(sq, &s_sums[1]);
  // four outputs a thread: 8 bytes of two window rows, pairs of bytes
  // summed in 16-bit lanes
  constexpr int PH = H::WH + 1;
  static_assert(H::WH % 4 == 0 && H::SW % 8 == 0, "8-byte window loads");
  for (int i = tid; i < H::WH * (H::WH / 4); i += kThreads) {
    const int y = i / (H::WH / 4);
    const int x = (i - y * (H::WH / 4)) * 4;
    const uint8_t* p = s_win + 2 * (y + 4) * H::SW + 2 * (x + 4);
    const uint2 r0 = *reinterpret_cast<const uint2*>(p);
    const uint2 r1 = *reinterpret_cast<const uint2*>(p + H::SW);
    const uint32_t lo = pair_sums(r0.x) + pair_sums(r1.x);
    const uint32_t hi = pair_sums(r0.y) + pair_sums(r1.y);
    float* o = s_area + y * PH + x;
    o[0] = static_cast<float>(lo & 0xffffu);
    o[1] = static_cast<float>(lo >> 16);
    o[2] = static_cast<float>(hi & 0xffffu);
    o[3] = static_cast<float>(hi >> 16);
  }
  for (int i = tid; i < H::WH + kPad; i += kThreads)  // the pitch's column
    s_area[i < H::WH ? i * PH + H::WH : H::WH * PH + i - H::WH] = 0.0f;
  __syncthreads();

  // level 1: +-18 at half resolution, 8 of a candidate's 16 rows a thread
  search_level<H::NH, 8, true>(s_srch, s_area, PH, kHalfR, 2, s_rows, s_rel);
  const unsigned long long best_h = level_min(
      s_rel, H::DH * H::DH, s_sums[1],
      out_map + static_cast<size_t>(blk) * H::DH * H::DH, s_warp);
  const int idx_h = static_cast<int>(best_h & 0xffffffffu);
  const int c_y = min(max(2 * (idx_h / H::DH - kHalfR), -H::REACH), H::REACH);
  const int c_x = min(max(2 * (idx_h % H::DH - kHalfR), -H::REACH), H::REACH);

  // the refine window, whose origin in the window is centre + REACH, out
  // to device memory for the quarter-pel stage; its middle is the
  // refine's area
  const int oy = c_y + H::REACH;
  const int ox = c_x + H::REACH;
  uint8_t* g_loc = out_loc + static_cast<size_t>(blk) * H::LOC * H::LOC;
  static_assert(H::LOC % 4 == 0, "4-byte stores");
  uint32_t* g_loc4 = reinterpret_cast<uint32_t*>(g_loc);
  for (int i = tid; i < H::LOC * H::LOC / 4; i += kThreads) {
    const int y = i / (H::LOC / 4);
    const int x = (i - y * (H::LOC / 4)) * 4;
    const uint8_t* p = s_win + (oy + y) * H::SW + ox + x;  // any alignment
    g_loc4[i] = p[0] | (p[1] << 8) | (p[2] << 16)
                | (static_cast<uint32_t>(p[3]) << 24);
  }
  constexpr int PR = H::WR + 1;
  for (int i = tid; i < H::WR * PR + kPad; i += kThreads) {
    const int y = i / PR;
    const int x = i - y * PR;
    s_area[i] = (y < H::WR && x < H::WR)
        ? static_cast<float>(s_win[(oy + 4 + y) * H::SW + ox + 4 + x]) : 0.0f;
  }
  __syncthreads();

  // level 2: +-4 at full resolution, one of a candidate's rows a thread
  search_level<N, 9, false>(s_src, s_area, PR, kRefR, N, s_rows, s_rel);
  const unsigned long long best_r = level_min(s_rel, H::DR * H::DR,
                                              s_sums[0], nullptr, s_warp);
  if (tid == 0) {
    const int idx_r = static_cast<int>(best_r & 0xffffffffu);
    out5[blk] = c_y;
    out5[b + blk] = c_x;
    out5[2 * b + blk] = idx_r / H::DR - kRefR;
    out5[3 * b + blk] = idx_r % H::DR - kRefR;
    out5[4 * b + blk] = static_cast<int32_t>(s_sums[1]);
  }
}

}  // namespace

// src: (b, n, n), wins: (b, sw, sw) with sw = n + 2r + 8, both contiguous
// on the device and of one element type: uint8 (elem_bytes 1) or int16
// holding values in [0, 1020] (elem_bytes 2). out_dy, out_dx: (b,) int32;
// out_map: (b, 2r+1, 2r+1) int32, or null to skip the map. n in
// {8, 16, 32}, r >= 1 with 4 * (n^2 + w(w+1) + 16 + w d + d^2) <= 48 KB less
// 512 bytes of shared memory (w = n + 2r, d = 2r + 1), b >= 1. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int sse_map_search_launch(const void* src, const void* wins,
                                     void* out_dy, void* out_dx,
                                     void* out_map, int b, int n, int r,
                                     int sw, int elem_bytes, void* stream) {
  auto* dy = static_cast<int32_t*>(out_dy);
  auto* dx = static_cast<int32_t*>(out_dx);
  auto* map = static_cast<int32_t*>(out_map);
  auto st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    return dispatch<uint8_t>(src, wins, dy, dx, map, b, n, r, sw, st);
  if (elem_bytes == 2)
    return dispatch<int16_t>(src, wins, dy, dx, map, b, n, r, sw, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// src: (b, 32, 32) uint8, wins: (b, 120, 120) uint8, contiguous on the
// device, both starting on a 16-byte boundary. out5: (5, b) int32 rows
// c_y, c_x, dyr, dxr, src2_h; out_loc: (b, 48, 48) uint8; out_map:
// (b, 37, 37) int32. n must be 32, b >= 1. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int hier_search_launch(const void* src, const void* wins,
                                  void* out5, void* out_loc, void* out_map,
                                  int b, int n, void* stream) {
  if (n != 32) return static_cast<int>(cudaErrorInvalidValue);
  hier_search_kernel<32><<<b, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(wins), b,
      static_cast<int32_t*>(out5), static_cast<uint8_t*>(out_loc),
      static_cast<int32_t*>(out_map));
  return static_cast<int>(cudaGetLastError());
}
