// The split16 descent of the realtime P-frame step: the four stages around
// its searches, transforms and MC that were PyTorch ops, as four kernels.
//
// Replaces the XLA stages of tpu_vp9/pipeline/tpu_encdec.py:
// encode_children_masked (:1902) and pframe_step's split decision
// (:2116-2160); their contracts are the plain versions beside the step,
// tpu_vp9_torch/pipeline/tpu_encdec.py: descent_gather_ref,
// descent_decide_ref, descent_pack_ref and descent_split_ref. Child c of
// the K selected parents is c = 4k + 2i + j: parent sel[k], child row i,
// column j.
//
//  1. descent_gather (a CTA of 64 threads per child): the child's 40 x 40
//     search window cw, cut out of its parent's (SW, SW) LAST window in
//     place at (s_y + 16i, s_x + 16j), s = clamp(d + 36, 0, SW - 64) for
//     the parent's full-pel winner d (the 64 x 64 union slice around it);
//     its 16 x 16 luma and two 8 x 8 chroma source blocks out of the
//     padded planes; sum(src^2) as int32; and the int32 vectors the rest
//     of the descent reads: the map centre's displacement s - 32, the
//     child's position and its bordered start (+ BORDER, what
//     block_energy_at takes), its offset inside the parent's window, the
//     parent's window index sel[k] and the parent's final MV.
//  2. descent_decide (a thread per child): ZERO, NEW and PARENT. PARENT's
//     SSE is its rounded full-pel entry of the child's 17 x 17 map
//     (clamped to the map) plus sum(src^2); NEW's MV is (s - 32) * 8 plus
//     the quarter-pel winner. With the frame's rate tables the cost is
//     f32(sse) + (lam_bits * f32(rate)) / 256, NEW's rate the mode's plus
//     its mvd bits against PARENT (the joint's and the two component
//     LUTs', clipped to their reach); without, f32(sse) + f32(lam) * rate,
//     NEW's rate new_bits[|dr| + |dc|] out of the host's float32 table.
//     Each product, quotient and sum rounds on its own (__fmul_rn,
//     __fdiv_rn, __fadd_rn: nvcc would contract a*b + c into an FMA) in
//     the JAX package's order; the first minimum wins (a strict < in
//     candidate order). An mvd past the table traps, as torch's indexing
//     of the plain version fails there.
//  3. descent_pack (a CTA of 128 threads per parent, a warp per child):
//     skip (every plane's eob 0), the nonzero levels of the child's three
//     planes, the parent's sums of its children's distortion and nonzero
//     levels (int64, as torch's sums), and the four children's recon
//     merged into the parent's 32 x 32 luma and 16 x 16 chroma blocks.
//  4. descent_split (a CTA of 128 threads per block of the 32 zone):
//     the 32-against-4x16 decision and the recon merge in one launch with
//     a parent-to-slot map: each CTA scans sel for its block's slot (the
//     last k naming it), takes cost32 = f32(dist) + f32(lam) * f32(rate)
//     against cost16 = f32(dist4) + f32(lam) * (f32(rate4) + extra),
//     unfused, split on a strict <, never below the overhang limit's
//     rows, writes split32 and copies its 32 x 32 luma and two 16 x 16
//     chroma blocks into the new planes from the children's merged blocks
//     where it splits and from the zone's recon elsewhere. Every output
//     block is written by this one launch; the zone's planes are only
//     read.
// Every int32 step is the plain version's; the float32 ones round as its
// separate operations do. A parent index outside [0, B32) traps (the
// plain version's indexing raises past B32).
//
// What bounds them on an H100: the launch. At 1080p M8 (K = 510) the
// gather moves about 1.1 MB (the children's windows, blocks and words),
// the decide 0.8 MB of maps and words, the pack 1.3 MB and the split 6 MB
// (the zone's recon read and written), each 0.3-1.8 us at HBM speed, less
// than a launch. Written as PyTorch ops they were about eighty small
// launches and whole-window copies (the parents' 120 x 120 windows taken
// by index before a 64 x 64 slice of each). This design is the plain one:
// bytes a thread, a CTA per child or block, nothing staged in shared
// memory but the reductions. Folding block_energy and block_energy_at
// into the gather and the pack is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kReach = 8;                       // the children's reach
constexpr int kMapSide = 2 * kReach + 1;        // 17
constexpr int kMap = kMapSide * kMapSide;       // 289 entries a child
constexpr int kChildWin = 16 + 2 * kReach + 8;  // 40
constexpr int kUnion = 64;     // a parent's union slice
constexpr int kUnionOff = 36;  // the union starts at the winner + 36
constexpr int kCentre = 32;    // the map centre's offset in the union
constexpr int kGatherThreads = 64;
constexpr int kDecideThreads = 128;
constexpr int kPackThreads = 128;  // a warp per child
constexpr int kSplitThreads = 128;
constexpr int kWarps = kSplitThreads / 32;
constexpr int kSmemBytes = 64;  // the reductions' words

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// ---------------------------------------------------------------------------
// 1. descent_gather
// ---------------------------------------------------------------------------

// ints' rows, each (nch,) int32: sum(src^2), the map centre's
// displacement (y, x), the child's position (y, x), its bordered start
// (y, x), its offset in the parent's window (y, x), the window index, the
// parent's MV (row, column).
struct GatherArgs {
  const int* sel;        // (K,)
  const uint8_t* wins;   // (B32, sw, sw) the parents' LAST windows
  const int* dy;         // (B32,) the parents' full-pel winners
  const int* dx;
  const int* parent_mv;  // (B32, 2) the parents' final q3 MVs
  const uint8_t* src_y;  // padded planes, rows of pitch_y / pitch_c
  const uint8_t* src_u;
  const uint8_t* src_v;
  uint8_t* cw;      // (nch, 40, 40)
  uint8_t* csrc;    // (nch, 16, 16)
  uint8_t* csrc_u;  // (nch, 8, 8)
  uint8_t* csrc_v;
  int* ints;        // (12, nch)
  int nch, nb32, sw, cols32, pitch_y, pitch_c, border;
};

__global__ void __launch_bounds__(kGatherThreads)
    descent_gather_kernel(GatherArgs a) {
  extern __shared__ __align__(16) int smem[];
  const int c = blockIdx.x;
  if (c >= a.nch) return;
  const int tid = threadIdx.x;
  const int k = c >> 2, i = (c >> 1) & 1, j = c & 1;
  const int p = a.sel[k];
  if (p < 0 || p >= a.nb32) {  // every thread: the CTA leaves together
    __trap();
    return;
  }
  const int s_y = clampi(a.dy[p] + kUnionOff, 0, a.sw - kUnion);
  const int s_x = clampi(a.dx[p] + kUnionOff, 0, a.sw - kUnion);
  const int row = 2 * (p / a.cols32) + i;  // the child's 16-block row
  const int col = 2 * (p % a.cols32) + j;

  const uint8_t* win = a.wins + static_cast<int64_t>(p) * a.sw * a.sw +
                       static_cast<int64_t>(s_y + 16 * i) * a.sw + s_x +
                       16 * j;
  uint8_t* cw = a.cw + static_cast<int64_t>(c) * kChildWin * kChildWin;
  for (int e = tid; e < kChildWin * kChildWin; e += kGatherThreads) {
    cw[e] = win[(e / kChildWin) * a.sw + e % kChildWin];
  }
  const uint8_t* sy =
      a.src_y + static_cast<int64_t>(16 * row) * a.pitch_y + 16 * col;
  uint8_t* cs = a.csrc + static_cast<int64_t>(c) * 256;
  int sq = 0;
  for (int e = tid; e < 256; e += kGatherThreads) {
    const int v = sy[(e >> 4) * a.pitch_y + (e & 15)];
    cs[e] = static_cast<uint8_t>(v);
    sq += v * v;
  }
  for (int e = tid; e < 64; e += kGatherThreads) {
    const int64_t at =
        static_cast<int64_t>(8 * row + (e >> 3)) * a.pitch_c + 8 * col +
        (e & 7);
    a.csrc_u[static_cast<int64_t>(c) * 64 + e] = a.src_u[at];
    a.csrc_v[static_cast<int64_t>(c) * 64 + e] = a.src_v[at];
  }
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if ((tid & 31) == 0) smem[tid >> 5] = sq;
  __syncthreads();
  if (tid == 0) {
    int* out = a.ints + c;
    const int n = a.nch;
    out[0 * n] = smem[0] + smem[1];
    out[1 * n] = s_y - kCentre;
    out[2 * n] = s_x - kCentre;
    out[3 * n] = 16 * row;
    out[4 * n] = 16 * col;
    out[5 * n] = 16 * row + a.border;
    out[6 * n] = 16 * col + a.border;
    out[7 * n] = 16 * i;
    out[8 * n] = 16 * j;
    out[9 * n] = p;
    out[10 * n] = a.parent_mv[2 * p];
    out[11 * n] = a.parent_mv[2 * p + 1];
  }
}

// ---------------------------------------------------------------------------
// 2. descent_decide
// ---------------------------------------------------------------------------

struct DecideArgs {
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
  const int* joint_cost;    // (4,) with rates
  const int* nmv_row;       // (2 * mv_cost_max + 1,) with rates
  const int* nmv_col;
  int* mv;                  // (2, nch): rows, then columns
  int16_t* mv16;            // (nch, 2)
  float lam_bits, rate_zero, rate_parent;
  int nch, with_rates, lam, mode_zero, mode_new, mode_parent, mv_cost_max,
      n_new_bits;
};

// f32(sse) + (lam_bits * f32(rate)) / 256, each step rounded on its own
__device__ __forceinline__ float table_cost(int sse, int rate,
                                            float lam_bits) {
  return __fadd_rn(
      __int2float_rn(sse),
      __fdiv_rn(__fmul_rn(lam_bits, __int2float_rn(rate)), 256.0f));
}

__global__ void __launch_bounds__(kDecideThreads)
    descent_decide_kernel(DecideArgs a) {
  const int c = blockIdx.x * kDecideThreads + threadIdx.x;
  if (c >= a.nch) return;
  const int base_y = a.base_y[c], base_x = a.base_x[c];
  const int par_r = a.par_r[c], par_c = a.par_c[c];
  const int new_r = base_y * 8 + a.sub_r[c];
  const int new_c = base_x * 8 + a.sub_c[c];
  // PARENT at its rounded full-pel entry of the map (>> is arithmetic)
  const int fy = clampi(((par_r + 4) >> 3) - base_y, -kReach, kReach) +
                 kReach;
  const int fx = clampi(((par_c + 4) >> 3) - base_x, -kReach, kReach) +
                 kReach;
  const int sse0 = a.sse_zero[c], sse1 = a.sse_new[c];
  const int sse2 = a.ssem[c * kMap + fy * kMapSide + fx] + a.src2[c];
  const int dr = new_r - par_r, dc = new_c - par_c;
  float c0, c1, c2;
  if (a.with_rates) {
    const int m = a.mv_cost_max;
    const int bits = a.joint_cost[2 * (dr != 0) + (dc != 0)] +
                     a.nmv_row[clampi(dr, -m, m) + m] +
                     a.nmv_col[clampi(dc, -m, m) + m];
    c0 = table_cost(sse0, a.mode_zero, a.lam_bits);
    c1 = table_cost(sse1, a.mode_new + bits, a.lam_bits);
    c2 = table_cost(sse2, a.mode_parent, a.lam_bits);
  } else {
    const int mvd = (dr < 0 ? -dr : dr) + (dc < 0 ? -dc : dc);
    if (mvd >= a.n_new_bits) {  // past the table: the launch fails
      __trap();
      return;
    }
    const float lam = __int2float_rn(a.lam);
    c0 = __fadd_rn(__int2float_rn(sse0), __fmul_rn(lam, a.rate_zero));
    c1 = __fadd_rn(__int2float_rn(sse1), __fmul_rn(lam, a.new_bits[mvd]));
    c2 = __fadd_rn(__int2float_rn(sse2), __fmul_rn(lam, a.rate_parent));
  }
  // the first minimum: a strict < in candidate order
  int mv_r = 0, mv_c = 0;
  float best = c0;
  if (c1 < best) {
    best = c1;
    mv_r = new_r;
    mv_c = new_c;
  }
  if (c2 < best) {
    mv_r = par_r;
    mv_c = par_c;
  }
  a.mv[c] = mv_r;
  a.mv[a.nch + c] = mv_c;
  a.mv16[2 * c] = static_cast<int16_t>(mv_r);
  a.mv16[2 * c + 1] = static_cast<int16_t>(mv_c);
}

// ---------------------------------------------------------------------------
// 3. descent_pack
// ---------------------------------------------------------------------------

struct PackArgs {
  const int* eob_y;      // (nch,) each
  const int* eob_u;
  const int* eob_v;
  const int16_t* lv_y;   // (nch, 16, 16)
  const int16_t* lv_u;   // (nch, 8, 8)
  const int16_t* lv_v;
  const uint8_t* rec_y;  // (nch, 16, 16)
  const uint8_t* rec_u;  // (nch, 8, 8)
  const uint8_t* rec_v;
  const int* dist;       // (nch,) the children's recon SSE
  uint8_t* skip;         // (nch,) bool
  int64_t* dist4;        // (K,)
  int64_t* rate4;
  uint8_t* rec_y32;      // (K, 32, 32)
  uint8_t* rec_u16;      // (K, 16, 16)
  uint8_t* rec_v16;
  int k;
};

__global__ void __launch_bounds__(kPackThreads)
    descent_pack_kernel(PackArgs a) {
  extern __shared__ __align__(16) int smem[];
  const int k = blockIdx.x;
  if (k >= a.k) return;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int c = 4 * k + w;  // warp w's child
  int nz = 0;
  for (int e = lane; e < 256; e += 32) nz += a.lv_y[c * 256 + e] != 0;
  for (int e = lane; e < 64; e += 32) {
    nz += (a.lv_u[c * 64 + e] != 0) + (a.lv_v[c * 64 + e] != 0);
  }
  for (int o = 16; o > 0; o >>= 1) nz += __shfl_xor_sync(0xffffffffu, nz, o);
  if (lane == 0) {
    smem[w] = nz;
    a.skip[c] = a.eob_y[c] == 0 && a.eob_u[c] == 0 && a.eob_v[c] == 0;
  }
  // child (i, j) fills rows 16i.., columns 16j.. of the parent's block
  for (int e = tid; e < 1024; e += kPackThreads) {
    const int r = e >> 5, q = e & 31;
    const int child = 4 * k + 2 * (r >> 4) + (q >> 4);
    a.rec_y32[k * 1024 + e] = a.rec_y[child * 256 + (r & 15) * 16 + (q & 15)];
  }
  for (int e = tid; e < 256; e += kPackThreads) {
    const int r = e >> 4, q = e & 15;
    const int at = (4 * k + 2 * (r >> 3) + (q >> 3)) * 64 + (r & 7) * 8 +
                   (q & 7);
    a.rec_u16[k * 256 + e] = a.rec_u[at];
    a.rec_v16[k * 256 + e] = a.rec_v[at];
  }
  __syncthreads();
  if (tid == 0) {
    a.rate4[k] = static_cast<int64_t>(smem[0]) + smem[1] + smem[2] + smem[3];
    a.dist4[k] = static_cast<int64_t>(a.dist[4 * k]) + a.dist[4 * k + 1] +
                 a.dist[4 * k + 2] + a.dist[4 * k + 3];
  }
}

// ---------------------------------------------------------------------------
// 4. descent_split
// ---------------------------------------------------------------------------

struct SplitArgs {
  const int* sel;          // (K,)
  const int* dist_b;       // (B32,) the zone's recon SSE
  const int64_t* rate_b;   // (B32,) its nonzero levels
  const int64_t* dist4;    // (K,)
  const int64_t* rate4;
  const uint8_t* rec_y;    // the zone's recon planes (rows32 * 32,
  const uint8_t* rec_u;    // cols32 * 32) and (rows32 * 16, cols32 * 16)
  const uint8_t* rec_v;
  const uint8_t* rec_y32;  // (K, 32, 32) the children's merged blocks
  const uint8_t* rec_u16;  // (K, 16, 16)
  const uint8_t* rec_v16;
  int* split32;            // (B32,)
  uint8_t* out_y;          // the new planes, the zone's shapes
  uint8_t* out_u;
  uint8_t* out_v;
  float extra;             // the split's extra rate
  int k, nb32, cols32, lam, limit;  // limit: blocks from it never split
};

__global__ void __launch_bounds__(kSplitThreads)
    descent_split_kernel(SplitArgs a) {
  extern __shared__ __align__(16) int smem[];
  const int b = blockIdx.x;
  if (b >= a.nb32) return;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  // the slot of block b: the last k with sel[k] == b, or -1
  int slot = -1, bad = 0;
  for (int q = tid; q < a.k; q += kSplitThreads) {
    const int s = a.sel[q];
    bad |= s < 0 || s >= a.nb32;
    if (s == b) slot = q;
  }
  for (int o = 16; o > 0; o >>= 1) {
    slot = max(slot, __shfl_xor_sync(0xffffffffu, slot, o));
    bad |= __shfl_xor_sync(0xffffffffu, bad, o);
  }
  if (lane == 0) {
    smem[w] = slot;
    smem[kWarps + w] = bad;
  }
  __syncthreads();
  if (tid == 0) {
    int s = smem[0], any_bad = smem[kWarps];
    for (int q = 1; q < kWarps; ++q) {
      s = max(s, smem[q]);
      any_bad |= smem[kWarps + q];
    }
    int use = 0;
    if (s >= 0) {
      const float lam = __int2float_rn(a.lam);
      const float c32 = __fadd_rn(__int2float_rn(a.dist_b[b]),
                                  __fmul_rn(lam, __ll2float_rn(a.rate_b[b])));
      const float c16 = __fadd_rn(
          __ll2float_rn(a.dist4[s]),
          __fmul_rn(lam, __fadd_rn(__ll2float_rn(a.rate4[s]), a.extra)));
      use = c16 < c32 && b < a.limit;
    }
    smem[2 * kWarps] = use;
    smem[2 * kWarps + 1] = s;
    smem[2 * kWarps + 2] = any_bad;
    if (!any_bad) a.split32[b] = use;
  }
  __syncthreads();
  if (smem[2 * kWarps + 2]) {  // every thread: the CTA leaves together
    __trap();
    return;
  }
  const int use = smem[2 * kWarps], s = smem[2 * kWarps + 1];
  const int pr = b / a.cols32, pc = b % a.cols32;
  const int wy = a.cols32 * 32, wc = a.cols32 * 16;
  for (int e = tid; e < 1024; e += kSplitThreads) {
    const int64_t at =
        static_cast<int64_t>(32 * pr + (e >> 5)) * wy + 32 * pc + (e & 31);
    a.out_y[at] = use ? a.rec_y32[static_cast<int64_t>(s) * 1024 + e]
                      : a.rec_y[at];
  }
  for (int e = tid; e < 256; e += kSplitThreads) {
    const int64_t at =
        static_cast<int64_t>(16 * pr + (e >> 4)) * wc + 16 * pc + (e & 15);
    const int64_t from = static_cast<int64_t>(s) * 256 + e;
    a.out_u[at] = use ? a.rec_u16[from] : a.rec_u[at];
    a.out_v[at] = use ? a.rec_v16[from] : a.rec_v[at];
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

cudaError_t launch_gather(const GatherArgs& a, cudaStream_t s) {
  descent_gather_kernel<<<a.nch, kGatherThreads, kSmemBytes, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_decide(const DecideArgs& a, cudaStream_t s) {
  const int grid = (a.nch + kDecideThreads - 1) / kDecideThreads;
  descent_decide_kernel<<<grid, kDecideThreads, 0, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_pack(const PackArgs& a, cudaStream_t s) {
  descent_pack_kernel<<<a.k, kPackThreads, kSmemBytes, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_split(const SplitArgs& a, cudaStream_t s) {
  descent_split_kernel<<<a.nb32, kSplitThreads, kSmemBytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// nch = 4K children of the K parents sel (K,) int32 in [0, nb32): wins
// (nb32, sw, sw) uint8, dy, dx (nb32,) int32, parent_mv (nb32, 2) int32;
// the padded planes src_y (rows of pitch_y bytes) and src_u, src_v (rows
// of pitch_c), holding the 16-block grid of rows32 * 2 by cols32 * 2
// blocks; out cw (nch, 40, 40), csrc (nch, 16, 16), csrc_u, csrc_v (nch,
// 8, 8) uint8 and ints (12, nch) int32. Returns cudaGetLastError() after
// the launch.
extern "C" int descent_gather_launch(
    const void* sel, const void* wins, const void* dy, const void* dx,
    const void* parent_mv, const void* src_y, const void* src_u,
    const void* src_v, void* cw, void* csrc, void* csrc_u, void* csrc_v,
    void* ints, int nch, int nb32, int sw, int cols32, int pitch_y,
    int pitch_c, int border, void* stream) {
  GatherArgs a;
  a.sel = static_cast<const int*>(sel);
  a.wins = static_cast<const uint8_t*>(wins);
  a.dy = static_cast<const int*>(dy);
  a.dx = static_cast<const int*>(dx);
  a.parent_mv = static_cast<const int*>(parent_mv);
  a.src_y = static_cast<const uint8_t*>(src_y);
  a.src_u = static_cast<const uint8_t*>(src_u);
  a.src_v = static_cast<const uint8_t*>(src_v);
  a.cw = static_cast<uint8_t*>(cw);
  a.csrc = static_cast<uint8_t*>(csrc);
  a.csrc_u = static_cast<uint8_t*>(csrc_u);
  a.csrc_v = static_cast<uint8_t*>(csrc_v);
  a.ints = static_cast<int*>(ints);
  a.nch = nch;
  a.nb32 = nb32;
  a.sw = sw;
  a.cols32 = cols32;
  a.pitch_y = pitch_y;
  a.pitch_c = pitch_c;
  a.border = border;
  if (nch % 4 != 0 || sw < kUnion) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_gather(a, static_cast<cudaStream_t>(stream)));
}

// nch children: ssem (nch, 17, 17), sse_zero, sse_new, sub_r, sub_c, src2,
// base_y, base_x, par_r, par_c (nch,) int32; new_bits (n_new_bits,) float32
// (read without rates); joint_cost (4,), nmv_row and nmv_col (2 *
// mv_cost_max + 1,) int32 (read with rates, may be null without); out mv
// (2, nch) int32 and mv16 (nch, 2) int16. with_rates 1: lam_bits and the
// mode costs of ZERO, NEW and PARENT; 0: lam and the rate proxies of ZERO
// and PARENT. Returns cudaGetLastError() after the launch.
extern "C" int descent_decide_launch(
    const void* ssem, const void* sse_zero, const void* sse_new,
    const void* sub_r, const void* sub_c, const void* src2,
    const void* base_y, const void* base_x, const void* par_r,
    const void* par_c, const void* new_bits, const void* joint_cost,
    const void* nmv_row, const void* nmv_col, void* mv, void* mv16,
    float lam_bits, float rate_zero, float rate_parent, int nch,
    int with_rates, int lam, int mode_zero, int mode_new, int mode_parent,
    int mv_cost_max, int n_new_bits, void* stream) {
  DecideArgs a;
  a.ssem = static_cast<const int*>(ssem);
  a.sse_zero = static_cast<const int*>(sse_zero);
  a.sse_new = static_cast<const int*>(sse_new);
  a.sub_r = static_cast<const int*>(sub_r);
  a.sub_c = static_cast<const int*>(sub_c);
  a.src2 = static_cast<const int*>(src2);
  a.base_y = static_cast<const int*>(base_y);
  a.base_x = static_cast<const int*>(base_x);
  a.par_r = static_cast<const int*>(par_r);
  a.par_c = static_cast<const int*>(par_c);
  a.new_bits = static_cast<const float*>(new_bits);
  a.joint_cost = static_cast<const int*>(joint_cost);
  a.nmv_row = static_cast<const int*>(nmv_row);
  a.nmv_col = static_cast<const int*>(nmv_col);
  a.mv = static_cast<int*>(mv);
  a.mv16 = static_cast<int16_t*>(mv16);
  a.lam_bits = lam_bits;
  a.rate_zero = rate_zero;
  a.rate_parent = rate_parent;
  a.nch = nch;
  a.with_rates = with_rates;
  a.lam = lam;
  a.mode_zero = mode_zero;
  a.mode_new = mode_new;
  a.mode_parent = mode_parent;
  a.mv_cost_max = mv_cost_max;
  a.n_new_bits = n_new_bits;
  if (with_rates && (joint_cost == nullptr || nmv_row == nullptr ||
                     nmv_col == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_decide(a, static_cast<cudaStream_t>(stream)));
}

// K parents of four children each: eob_y, eob_u, eob_v (4K,) int32, lv_y
// (4K, 16, 16) and lv_u, lv_v (4K, 8, 8) int16, rec_y (4K, 16, 16) and
// rec_u, rec_v (4K, 8, 8) uint8, dist (4K,) int32; out skip (4K,) bool,
// dist4, rate4 (K,) int64, rec_y32 (K, 32, 32) and rec_u16, rec_v16 (K,
// 16, 16) uint8. Returns cudaGetLastError() after the launch.
extern "C" int descent_pack_launch(
    const void* eob_y, const void* eob_u, const void* eob_v,
    const void* lv_y, const void* lv_u, const void* lv_v, const void* rec_y,
    const void* rec_u, const void* rec_v, const void* dist, void* skip,
    void* dist4, void* rate4, void* rec_y32, void* rec_u16, void* rec_v16,
    int k, void* stream) {
  PackArgs a;
  a.eob_y = static_cast<const int*>(eob_y);
  a.eob_u = static_cast<const int*>(eob_u);
  a.eob_v = static_cast<const int*>(eob_v);
  a.lv_y = static_cast<const int16_t*>(lv_y);
  a.lv_u = static_cast<const int16_t*>(lv_u);
  a.lv_v = static_cast<const int16_t*>(lv_v);
  a.rec_y = static_cast<const uint8_t*>(rec_y);
  a.rec_u = static_cast<const uint8_t*>(rec_u);
  a.rec_v = static_cast<const uint8_t*>(rec_v);
  a.dist = static_cast<const int*>(dist);
  a.skip = static_cast<uint8_t*>(skip);
  a.dist4 = static_cast<int64_t*>(dist4);
  a.rate4 = static_cast<int64_t*>(rate4);
  a.rec_y32 = static_cast<uint8_t*>(rec_y32);
  a.rec_u16 = static_cast<uint8_t*>(rec_u16);
  a.rec_v16 = static_cast<uint8_t*>(rec_v16);
  a.k = k;
  return static_cast<int>(launch_pack(a, static_cast<cudaStream_t>(stream)));
}

// The zone's nb32 = rows32 x cols32 blocks, K of them descended (sel (K,)
// int32 in [0, nb32)): dist_b (nb32,) int32, rate_b (nb32,) int64, dist4,
// rate4 (K,) int64, the zone's recon planes rec_y (rows32 * 32, cols32 *
// 32) and rec_u, rec_v (rows32 * 16, cols32 * 16) uint8, the children's
// merged blocks rec_y32 (K, 32, 32), rec_u16, rec_v16 (K, 16, 16) uint8;
// out split32 (nb32,) int32 and out_y, out_u, out_v, the planes' shapes.
// extra: the split's extra rate; limit: no block from it on splits.
// Returns cudaGetLastError() after the launch.
extern "C" int descent_split_launch(
    const void* sel, const void* dist_b, const void* rate_b,
    const void* dist4, const void* rate4, const void* rec_y,
    const void* rec_u, const void* rec_v, const void* rec_y32,
    const void* rec_u16, const void* rec_v16, void* split32, void* out_y,
    void* out_u, void* out_v, float extra, int k, int nb32, int cols32,
    int lam, int limit, void* stream) {
  SplitArgs a;
  a.sel = static_cast<const int*>(sel);
  a.dist_b = static_cast<const int*>(dist_b);
  a.rate_b = static_cast<const int64_t*>(rate_b);
  a.dist4 = static_cast<const int64_t*>(dist4);
  a.rate4 = static_cast<const int64_t*>(rate4);
  a.rec_y = static_cast<const uint8_t*>(rec_y);
  a.rec_u = static_cast<const uint8_t*>(rec_u);
  a.rec_v = static_cast<const uint8_t*>(rec_v);
  a.rec_y32 = static_cast<const uint8_t*>(rec_y32);
  a.rec_u16 = static_cast<const uint8_t*>(rec_u16);
  a.rec_v16 = static_cast<const uint8_t*>(rec_v16);
  a.split32 = static_cast<int*>(split32);
  a.out_y = static_cast<uint8_t*>(out_y);
  a.out_u = static_cast<uint8_t*>(out_u);
  a.out_v = static_cast<uint8_t*>(out_v);
  a.extra = extra;
  a.k = k;
  a.nb32 = nb32;
  a.cols32 = cols32;
  a.lam = lam;
  a.limit = limit;
  if (cols32 <= 0 || nb32 % cols32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_split(a, static_cast<cudaStream_t>(stream)));
}

// Kernel `which` (0 gather, 1 decide, 2 pack, 3 split) on the current
// device: *ctas_per_sm the CTAs an SM holds at once, *smem_bytes the
// dynamic shared memory each asks for. Returns the CUDA error of the query
// (0 if none).
extern "C" int descent_occupancy(int which, int* ctas_per_sm,
                                 int* smem_bytes) {
  switch (which) {
    case 0:
      *smem_bytes = kSmemBytes;
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, descent_gather_kernel, kGatherThreads, kSmemBytes));
    case 1:
      *smem_bytes = 0;
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, descent_decide_kernel, kDecideThreads, 0));
    case 2:
      *smem_bytes = kSmemBytes;
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, descent_pack_kernel, kPackThreads, kSmemBytes));
    case 3:
      *smem_bytes = kSmemBytes;
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, descent_split_kernel, kSplitThreads, kSmemBytes));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
