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
//  1. descent_gather (a CTA of four warps per parent, a warp per child):
//     the parent's 56 x 56 region of its (SW, SW) LAST window at (s_y,
//     s_x), s = clamp(d + 36, 0, SW - 64) for its full-pel winner d (the
//     part of the 64 x 64 union slice around d that its children's
//     windows cover), staged once in shared memory from aligned 8-byte
//     words; each child's 40 x 40 search window cw out of it at (16i, 16j)
//     as 8-byte stores, one funnel shift serving all four (s_x is the
//     same for them); its 16 x 16 luma and two 8 x 8 chroma source blocks
//     out of the padded planes as 16- and 8-byte rows; sum(src^2) and the
//     ZERO SSE against the co-located block of the border-extended LAST
//     luma (at 16 row + border, 16 col + border) by dp4a over the same
//     registers, both exact int32; and the int32 vectors the rest of the
//     descent reads: the map centre's displacement s - 32, the child's
//     position, its offset inside the parent's window, the parent's window
//     index sel[k] and the parent's final MV.
//  2. descent_decide (a thread per child): ZERO, NEW and PARENT, the
//     decision of decide.cuh (decide::child, which mc_predict.cu's
//     children's instance runs at the head of their motion compensation;
//     the step launches that one), its rate scalars host numbers here.
//  3. descent_pack (a CTA of 128 threads per parent, a warp per child):
//     skip (every plane's eob 0), the nonzero levels of the child's three
//     planes counted on the int16 pairs of 16-byte words (lv_y a word a
//     lane, lv_u and lv_v 8 lanes each), the child's recon SSE against its
//     luma source (a 16-byte row of each a lane, __vabsdiffu4 and dp4a,
//     exact int32), the parent's sums of its children's SSE and nonzero
//     levels (int64, as torch's sums), and the four children's recon
//     merged into the parent's 32 x 32 luma and 16 x 16 chroma blocks by
//     the lanes that loaded it: 16-byte luma rows, 8-byte chroma rows.
//  4. descent_split (a warp per selected parent, four a CTA): the
//     32-against-4x16 decision of parent sel[k], read directly (sel is
//     distinct, descent_parents' sort): cost32 = f32(dist) + f32(lam) *
//     f32(rate) against cost16 = f32(dist4) + f32(lam) * (f32(rate4) +
//     extra), unfused, split on a strict <, never from the overhang
//     limit's block on; it writes split32 of its parent and, where it
//     splits, the children's merged 32 x 32 luma and two 16 x 16 chroma
//     blocks into the zone's planes in place as 16-byte stores (96 a
//     parent, 3 a lane). split32 is zeroed by a memset on the same stream
//     before the kernel; a parent that does not split writes nothing in
//     the planes.
// Every int32 step is the plain version's; the float32 ones round as its
// separate operations do. A parent index outside [0, B32) traps (the
// plain version's indexing raises past B32).
//
// What bounds them on an H100: the launch. At 1080p M8 (K = 510) the
// gather moves about 7.1 MB (per parent its 56 x 56 region, 3,136 bytes;
// four children's source, 4 x 384, and reference blocks, 4 x 256; the
// windows, blocks and eleven int32 words written, 4 x 2,028; 20 bytes of
// sel, winner and MV: 13,828 bytes), about 2.1 us at HBM speed; the decide
// 0.8 MB of maps and words, the pack 3.7 MB (7,236 bytes a parent: the
// children's eobs, levels, recon and luma source read, skip, the merged
// recon and two sums written), and the split at most 1.6 MB (the selected
// parents' scalars, 3,072 bytes read and written for each that splits),
// each 0.3-2 us, about a launch. Written as PyTorch ops they were about
// eighty small launches and whole-window copies (the parents' 120 x 120
// windows taken by index before a 64 x 64 slice of each). The decide is
// the plain design, a thread per child; the pack moves words, not bytes,
// and takes the children's recon SSE from the registers that merge their
// recon (the block_energy launch it replaces read rec_y again).

#include <cstdint>
#include <cuda_runtime.h>

#include "decide.cuh"

namespace {

constexpr int kReach = decide::kChildReach;     // the children's reach
constexpr int kChildWin = 16 + 2 * kReach + 8;  // 40
constexpr int kUnion = 64;     // a parent's union slice
constexpr int kUnionOff = 36;  // the union starts at the winner + 36
constexpr int kCentre = 32;    // the map centre's offset in the union
// the rows and columns of the union its children's windows cover
constexpr int kRegion = 16 + kChildWin;  // 56
// a staged region row: the 64 bytes from the 8-byte word at or below s_x
// (16 words), kept 18 words apart in shared memory
constexpr int kRegionWords = 16;
constexpr int kRegionPitch = 18;
constexpr int kGatherThreads = 128;  // a warp per child
constexpr int kGatherSmem = kRegion * kRegionPitch * 4;
constexpr int kDecideThreads = 128;
constexpr int kPackThreads = 128;  // a warp per child
constexpr int kSplitThreads = 128;  // a warp per selected parent
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSmemBytes = 32;  // the pack's eight reduction words

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// c + the squares of the four byte differences of s and r
__device__ __forceinline__ unsigned sq_diff4(unsigned s, unsigned r,
                                             unsigned c) {
  const unsigned d = __vabsdiffu4(s, r);
  return __dp4a(d, d, c);
}

// ---------------------------------------------------------------------------
// 1. descent_gather
// ---------------------------------------------------------------------------

// ints' rows, each (nch,) int32: sum(src^2), the ZERO SSE, the map
// centre's displacement (y, x), the child's position (y, x), its offset in
// the parent's window (y, x), the window index, the parent's MV (row,
// column).
struct GatherArgs {
  const int* sel;        // (K,)
  const uint8_t* wins;   // (B32, sw, sw) the parents' LAST windows
  const int* dy;         // (B32,) the parents' full-pel winners
  const int* dx;
  const int* parent_mv;  // (B32, 2) the parents' final q3 MVs
  const uint8_t* src_y;  // padded planes, rows of pitch_y / pitch_c
  const uint8_t* src_u;
  const uint8_t* src_v;
  const uint8_t* ref_y;  // LAST's border-extended luma, rows of pitch_r
  uint8_t* cw;      // (nch, 40, 40)
  uint8_t* csrc;    // (nch, 16, 16)
  uint8_t* csrc_u;  // (nch, 8, 8)
  uint8_t* csrc_v;
  int* ints;        // (11, nch)
  int k, nb32, sw, cols32, pitch_y, pitch_c, pitch_r, border;
};

__global__ void __launch_bounds__(kGatherThreads)
    descent_gather_kernel(GatherArgs a) {
  extern __shared__ __align__(16) int smem[];
  uint32_t* region = reinterpret_cast<uint32_t*>(smem);
  const int k = blockIdx.x;
  if (k >= a.k) return;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int p = a.sel[k];
  if (p < 0 || p >= a.nb32) {  // every thread: the CTA leaves together
    __trap();
    return;
  }
  const int s_y = clampi(a.dy[p] + kUnionOff, 0, a.sw - kUnion);
  const int s_x = clampi(a.dx[p] + kUnionOff, 0, a.sw - kUnion);
  // the region's rows from the aligned word at or below s_x: 64 bytes,
  // which end inside the window's row (s_x <= sw - 64)
  const int x0 = s_x & ~7;
  const uint8_t* win = a.wins + static_cast<int64_t>(p) * a.sw * a.sw +
                       static_cast<int64_t>(s_y) * a.sw + x0;
  for (int e = tid; e < kRegion * kRegionWords / 2; e += kGatherThreads) {
    const int r = e >> 3, q = e & 7;
    *reinterpret_cast<uint2*>(region + r * kRegionPitch + 2 * q) =
        *reinterpret_cast<const uint2*>(win + r * a.sw + 8 * q);
  }

  // warp w's child (i, j): its source blocks and the co-located reference
  // rows while the region is staged
  const int i = w >> 1, j = w & 1, c = 4 * k + w;
  const int row = 2 * (p / a.cols32) + i;  // the child's 16-block row
  const int col = 2 * (p % a.cols32) + j;
  unsigned sq = 0, zero = 0;
  if (lane < 16) {
    const uint4 s = *reinterpret_cast<const uint4*>(
        a.src_y + static_cast<int64_t>(16 * row + lane) * a.pitch_y +
        16 * col);
    const uint4 r = *reinterpret_cast<const uint4*>(
        a.ref_y + static_cast<int64_t>(16 * row + a.border + lane) *
                      a.pitch_r +
        16 * col + a.border);
    *reinterpret_cast<uint4*>(a.csrc + static_cast<int64_t>(c) * 256 +
                              16 * lane) = s;
    sq = __dp4a(s.w, s.w, __dp4a(s.z, s.z, __dp4a(s.y, s.y,
                                                  __dp4a(s.x, s.x, 0u))));
    zero = sq_diff4(s.w, r.w, sq_diff4(s.z, r.z, sq_diff4(
        s.y, r.y, sq_diff4(s.x, r.x, 0u))));
  } else {  // lanes 16-23 the U rows, 24-31 the V rows
    const int rr = lane & 7;
    const bool v = lane >= 24;
    *reinterpret_cast<uint2*>((v ? a.csrc_v : a.csrc_u) +
                              static_cast<int64_t>(c) * 64 + 8 * rr) =
        *reinterpret_cast<const uint2*>(
            (v ? a.src_v : a.src_u) +
            static_cast<int64_t>(8 * row + rr) * a.pitch_c + 8 * col);
  }
  for (int o = 16; o > 0; o >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
    zero += __shfl_xor_sync(0xffffffffu, zero, o);
  }
  if (lane == 0) {
    int* out = a.ints + c;
    const int n = 4 * a.k;
    out[0 * n] = static_cast<int>(sq);
    out[1 * n] = static_cast<int>(zero);
    out[2 * n] = s_y - kCentre;
    out[3 * n] = s_x - kCentre;
    out[4 * n] = 16 * row;
    out[5 * n] = 16 * col;
    out[6 * n] = 16 * i;
    out[7 * n] = 16 * j;
    out[8 * n] = p;
    out[9 * n] = a.parent_mv[2 * p];
    out[10 * n] = a.parent_mv[2 * p + 1];
  }

  // the child's window, rows 16i.., columns 16j.. of the region: five
  // 8-byte words a row; byte 16j + 8m of a region row is staged byte
  // (s_x & 7) + 16j + 8m, in word b0 + 2m shifted right by fs bits
  __syncthreads();
  const int fs = 8 * (s_x & 3), b0 = ((s_x & 7) >> 2) + 4 * j;
  uint8_t* cw = a.cw + static_cast<int64_t>(c) * kChildWin * kChildWin;
  for (int e = lane; e < kChildWin * kChildWin / 8; e += 32) {
    const int r = e / 5, m = e - 5 * r;
    const uint32_t* at = region + (16 * i + r) * kRegionPitch + b0 + 2 * m;
    const uint32_t w0 = at[0], w1 = at[1], w2 = at[2];
    *reinterpret_cast<uint2*>(cw + 8 * e) =
        make_uint2(__funnelshift_r(w0, w1, fs), __funnelshift_r(w1, w2, fs));
  }
}

// ---------------------------------------------------------------------------
// 2. descent_decide
// ---------------------------------------------------------------------------

// The decision's inputs (decide.cuh), its rate scalars from the host and
// the launch's outputs.
struct DecideArgs : decide::Children {
  int* mv;                   // (2, nch): rows, then columns
  int16_t* mv16;             // (nch, 2)
  int nch;
};

__global__ void __launch_bounds__(kDecideThreads)
    descent_decide_kernel(DecideArgs a) {
  const int c = blockIdx.x * kDecideThreads + threadIdx.x;
  if (c >= a.nch) return;
  decide::ChildRates r = {0.0f, 0, 0, 0, 0};
  if (a.with_rates) r = decide::child_rates(a.scalars);
  const decide::Choice ch = decide::child(a, r, c);
  if (!ch.ok) return;
  a.mv[c] = ch.r;
  a.mv[a.nch + c] = ch.c;
  a.mv16[2 * c] = static_cast<int16_t>(ch.r);
  a.mv16[2 * c + 1] = static_cast<int16_t>(ch.c);
}

// ---------------------------------------------------------------------------
// 3. descent_pack
// ---------------------------------------------------------------------------

struct PackArgs {
  const int* eob_y;      // (nch,) each
  const int* eob_u;
  const int* eob_v;
  const int16_t* lv_y;   // (nch, 16, 16), 16-byte aligned
  const int16_t* lv_u;   // (nch, 8, 8), 16-byte aligned
  const int16_t* lv_v;
  const uint8_t* rec_y;  // (nch, 16, 16), 16-byte aligned
  const uint8_t* rec_u;  // (nch, 8, 8), 8-byte aligned
  const uint8_t* rec_v;
  const uint8_t* csrc;   // (nch, 16, 16) the children's luma source, 16
  uint8_t* skip;         // (nch,) bool
  int64_t* dist4;        // (K,)
  int64_t* rate4;
  uint8_t* rec_y32;      // (K, 32, 32), 16-byte aligned
  uint8_t* rec_u16;      // (K, 16, 16), 8-byte aligned
  uint8_t* rec_v16;
  int k;
};

// the nonzero int16 halves of a 32-bit word
__device__ __forceinline__ int nonzero2(unsigned w) {
  return ((w & 0xffffu) != 0u) + ((w >> 16) != 0u);
}

// the nonzero int16 levels of a 16-byte word
__device__ __forceinline__ int nonzero8(uint4 v) {
  return nonzero2(v.x) + nonzero2(v.y) + nonzero2(v.z) + nonzero2(v.w);
}

__global__ void __launch_bounds__(kPackThreads)
    descent_pack_kernel(PackArgs a) {
  extern __shared__ __align__(16) int smem[];
  const int k = blockIdx.x;
  if (k >= a.k) return;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int c = 4 * k + w;  // warp w's child (i, j)
  const int i = w >> 1, j = w & 1;
  // the levels: lv_y's 512 bytes a word a lane, lv_u's and lv_v's 128
  // bytes on lanes 0-7 and 8-15
  int nz = nonzero8(reinterpret_cast<const uint4*>(a.lv_y)[
      static_cast<int64_t>(c) * 32 + lane]);
  if (lane < 16) {
    nz += nonzero8(reinterpret_cast<const uint4*>(lane < 8 ? a.lv_u : a.lv_v)[
        static_cast<int64_t>(c) * 8 + (lane & 7)]);
  }
  // the recon: lanes 0-15 a luma row, its SSE against the source row (exact:
  // at most 256 * 255^2 < 2^24 a child) and its 16-byte store into row 16i
  // + lane, column 16j of the parent's block; lanes 16-23 the U rows, 24-31
  // the V rows, 8 bytes each, into row 8i + r, column 8j
  unsigned sse = 0;
  if (lane < 16) {
    const int64_t at = static_cast<int64_t>(c) * 256 + 16 * lane;
    const uint4 r = *reinterpret_cast<const uint4*>(a.rec_y + at);
    const uint4 s = *reinterpret_cast<const uint4*>(a.csrc + at);
    sse = sq_diff4(r.w, s.w, sq_diff4(r.z, s.z, sq_diff4(
        r.y, s.y, sq_diff4(r.x, s.x, 0u))));
    *reinterpret_cast<uint4*>(a.rec_y32 + static_cast<int64_t>(k) * 1024 +
                              (16 * i + lane) * 32 + 16 * j) = r;
  } else {
    const int rr = lane & 7;
    const bool v = lane >= 24;
    *reinterpret_cast<uint2*>((v ? a.rec_v16 : a.rec_u16) +
                              static_cast<int64_t>(k) * 256 +
                              (8 * i + rr) * 16 + 8 * j) =
        *reinterpret_cast<const uint2*>((v ? a.rec_v : a.rec_u) +
                                        static_cast<int64_t>(c) * 64 + 8 * rr);
  }
  for (int o = 16; o > 0; o >>= 1) {
    nz += __shfl_xor_sync(0xffffffffu, nz, o);
    sse += __shfl_xor_sync(0xffffffffu, sse, o);
  }
  if (lane == 0) {
    smem[w] = nz;
    smem[4 + w] = static_cast<int>(sse);
    a.skip[c] = a.eob_y[c] == 0 && a.eob_u[c] == 0 && a.eob_v[c] == 0;
  }
  __syncthreads();
  if (tid == 0) {
    a.rate4[k] = static_cast<int64_t>(smem[0]) + smem[1] + smem[2] + smem[3];
    a.dist4[k] = static_cast<int64_t>(smem[4]) + smem[5] + smem[6] + smem[7];
  }
}

// ---------------------------------------------------------------------------
// 4. descent_split
// ---------------------------------------------------------------------------

struct SplitArgs {
  const int* sel;          // (K,) distinct
  const int* dist_b;       // (B32,) the zone's recon SSE
  const int64_t* rate_b;   // (B32,) its nonzero levels
  const int64_t* dist4;    // (K,)
  const int64_t* rate4;
  const uint8_t* rec_y32;  // (K, 32, 32) the children's merged blocks
  const uint8_t* rec_u16;  // (K, 16, 16)
  const uint8_t* rec_v16;
  int* split32;            // (B32,), zeroed before the launch
  uint8_t* rec_y;          // the zone's recon planes (rows32 * 32,
  uint8_t* rec_u;          // cols32 * 32) and (rows32 * 16, cols32 * 16),
  uint8_t* rec_v;          // written in place
  const int* step;         // the step's row: lam (step_scalars.cuh)
  float extra;             // the split's extra rate
  int k, nb32, cols32, limit;  // limit: blocks from it never split
};

__global__ void __launch_bounds__(kSplitThreads)
    descent_split_kernel(SplitArgs a) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kSplitWarps + (threadIdx.x >> 5);
  if (k >= a.k) return;
  const int b = a.sel[k];
  if (b < 0 || b >= a.nb32) {  // every lane: the warp leaves together
    __trap();
    return;
  }
  const float lam = __int2float_rn(__ldg(a.step + step_row::kLam));
  const float c32 = __fadd_rn(__int2float_rn(a.dist_b[b]),
                              __fmul_rn(lam, __ll2float_rn(a.rate_b[b])));
  const float c16 = __fadd_rn(
      __ll2float_rn(a.dist4[k]),
      __fmul_rn(lam, __fadd_rn(__ll2float_rn(a.rate4[k]), a.extra)));
  const bool use = c16 < c32 && b < a.limit;
  if (lane == 0) a.split32[b] = use;
  if (!use) return;
  // 96 16-byte rows: the luma block's 32 rows of two, then U's and V's 16
  const int pr = b / a.cols32, pc = b % a.cols32;
  const int64_t wy = a.cols32 * 32, wc = a.cols32 * 16;
  for (int e = lane; e < 96; e += 32) {
    const uint4* from;
    uint8_t* to;
    if (e < 64) {
      const int r = e >> 1, h = e & 1;
      from = reinterpret_cast<const uint4*>(
          a.rec_y32 + static_cast<int64_t>(k) * 1024 + 32 * r + 16 * h);
      to = a.rec_y + (32 * pr + r) * wy + 32 * pc + 16 * h;
    } else {
      const int r = e & 15;
      const bool v = e >= 80;
      from = reinterpret_cast<const uint4*>(
          (v ? a.rec_v16 : a.rec_u16) + static_cast<int64_t>(k) * 256 +
          16 * r);
      to = (v ? a.rec_v : a.rec_u) + (16 * pr + r) * wc + 16 * pc;
    }
    *reinterpret_cast<uint4*>(to) = *from;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

cudaError_t launch_gather(const GatherArgs& a, cudaStream_t s) {
  descent_gather_kernel<<<a.k, kGatherThreads, kGatherSmem, s>>>(a);
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
  const int grid = (a.k + kSplitWarps - 1) / kSplitWarps;
  descent_split_kernel<<<grid, kSplitThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The 4K children of the K parents sel (K,) int32 in [0, nb32): wins
// (nb32, sw, sw) uint8 (8-byte aligned, sw a multiple of 8), dy, dx (nb32,)
// int32, parent_mv (nb32, 2) int32; the padded planes src_y (rows of
// pitch_y bytes, 16-byte aligned) and src_u, src_v (rows of pitch_c,
// 8-byte aligned), holding the 16-block grid of rows32 * 2 by cols32 * 2
// blocks; ref_y, LAST's luma bordered by `border` (rows of pitch_r,
// 16-byte aligned, border a multiple of 16); out cw (4K, 40, 40) (8-byte
// aligned), csrc (4K, 16, 16) (16-byte aligned), csrc_u, csrc_v (4K, 8, 8)
// (8-byte aligned) uint8 and ints (11, 4K) int32. Returns
// cudaGetLastError() after the launch.
extern "C" int descent_gather_launch(
    const void* sel, const void* wins, const void* dy, const void* dx,
    const void* parent_mv, const void* src_y, const void* src_u,
    const void* src_v, const void* ref_y, void* cw, void* csrc,
    void* csrc_u, void* csrc_v, void* ints, int k, int nb32, int sw,
    int cols32, int pitch_y, int pitch_c, int pitch_r, int border,
    void* stream) {
  GatherArgs a;
  a.sel = static_cast<const int*>(sel);
  a.wins = static_cast<const uint8_t*>(wins);
  a.dy = static_cast<const int*>(dy);
  a.dx = static_cast<const int*>(dx);
  a.parent_mv = static_cast<const int*>(parent_mv);
  a.src_y = static_cast<const uint8_t*>(src_y);
  a.src_u = static_cast<const uint8_t*>(src_u);
  a.src_v = static_cast<const uint8_t*>(src_v);
  a.ref_y = static_cast<const uint8_t*>(ref_y);
  a.cw = static_cast<uint8_t*>(cw);
  a.csrc = static_cast<uint8_t*>(csrc);
  a.csrc_u = static_cast<uint8_t*>(csrc_u);
  a.csrc_v = static_cast<uint8_t*>(csrc_v);
  a.ints = static_cast<int*>(ints);
  a.k = k;
  a.nb32 = nb32;
  a.sw = sw;
  a.cols32 = cols32;
  a.pitch_y = pitch_y;
  a.pitch_c = pitch_c;
  a.pitch_r = pitch_r;
  a.border = border;
  if (k <= 0 || sw < kUnion || sw % 8 != 0 || pitch_y % 16 != 0 ||
      pitch_c % 8 != 0 || pitch_r % 16 != 0 || border % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_gather(a, static_cast<cudaStream_t>(stream)));
}

// nch children: ssem (nch, 17, 17), sse_zero, sse_new, sub_r, sub_c, src2,
// base_y, base_x, par_r, par_c (nch,) int32; new_bits (n_new_bits,) float32
// (read without rates); scalars (9,), joint_cost (4,), nmv_row and nmv_col
// (2 * mv_cost_max + 1,) int32 (read with rates, may be null without: the
// scalars row gives lam_bits, the mode costs of ZERO, NEW and PARENT and
// mv_cost_max); step the step's row (step_scalars.cuh: its lam read
// without rates, with the rate proxies of ZERO and PARENT); out mv (2,
// nch) int32 and mv16 (nch, 2) int16. Returns cudaGetLastError() after
// the launch.
extern "C" int descent_decide_launch(
    const void* ssem, const void* sse_zero, const void* sse_new,
    const void* sub_r, const void* sub_c, const void* src2,
    const void* base_y, const void* base_x, const void* par_r,
    const void* par_c, const void* new_bits, const void* scalars,
    const void* joint_cost, const void* nmv_row, const void* nmv_col,
    const void* step, void* mv, void* mv16, float rate_zero,
    float rate_parent, int nch, int with_rates, int n_new_bits,
    void* stream) {
  DecideArgs a;
  a.mv = static_cast<int*>(mv);
  a.mv16 = static_cast<int16_t*>(mv16);
  a.nch = nch;
  if (!decide::children_args(a, ssem, sse_zero, sse_new, sub_r, sub_c, src2,
                             base_y, base_x, par_r, par_c, new_bits, scalars,
                             joint_cost, nmv_row, nmv_col, step, rate_zero,
                             rate_parent, with_rates, n_new_bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_decide(a, static_cast<cudaStream_t>(stream)));
}

// K parents of four children each: eob_y, eob_u, eob_v (4K,) int32, lv_y
// (4K, 16, 16) and lv_u, lv_v (4K, 8, 8) int16, rec_y (4K, 16, 16) and
// rec_u, rec_v (4K, 8, 8) uint8, csrc (4K, 16, 16) uint8 the children's
// luma source; out skip (4K,) bool, dist4, rate4 (K,) int64, rec_y32 (K,
// 32, 32) and rec_u16, rec_v16 (K, 16, 16) uint8. The levels, rec_y, csrc
// and rec_y32 16-byte aligned, rec_u, rec_v, rec_u16 and rec_v16 8-byte
// aligned (else cudaErrorInvalidValue, nothing launched). Returns
// cudaGetLastError() after the launch.
extern "C" int descent_pack_launch(
    const void* eob_y, const void* eob_u, const void* eob_v,
    const void* lv_y, const void* lv_u, const void* lv_v, const void* rec_y,
    const void* rec_u, const void* rec_v, const void* csrc, void* skip,
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
  a.csrc = static_cast<const uint8_t*>(csrc);
  a.skip = static_cast<uint8_t*>(skip);
  a.dist4 = static_cast<int64_t*>(dist4);
  a.rate4 = static_cast<int64_t*>(rate4);
  a.rec_y32 = static_cast<uint8_t*>(rec_y32);
  a.rec_u16 = static_cast<uint8_t*>(rec_u16);
  a.rec_v16 = static_cast<uint8_t*>(rec_v16);
  a.k = k;
  const uintptr_t words16 =
      reinterpret_cast<uintptr_t>(lv_y) | reinterpret_cast<uintptr_t>(lv_u) |
      reinterpret_cast<uintptr_t>(lv_v) | reinterpret_cast<uintptr_t>(rec_y) |
      reinterpret_cast<uintptr_t>(csrc) | reinterpret_cast<uintptr_t>(rec_y32);
  const uintptr_t words8 =
      reinterpret_cast<uintptr_t>(rec_u) | reinterpret_cast<uintptr_t>(rec_v) |
      reinterpret_cast<uintptr_t>(rec_u16) |
      reinterpret_cast<uintptr_t>(rec_v16);
  if (k <= 0 || words16 % 16 != 0 || words8 % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_pack(a, static_cast<cudaStream_t>(stream)));
}

// The zone's nb32 = rows32 x cols32 blocks, K of them descended (sel (K,)
// int32, distinct, in [0, nb32)): dist_b (nb32,) int32, rate_b (nb32,)
// int64, dist4, rate4 (K,) int64, the children's merged blocks rec_y32 (K,
// 32, 32), rec_u16, rec_v16 (K, 16, 16) uint8; out split32 (nb32,) int32
// (zeroed here, on the stream, then each selected parent's) and, in place,
// the zone's recon planes rec_y (rows32 * 32, cols32 * 32) and rec_u,
// rec_v (rows32 * 16, cols32 * 16) uint8: a parent that splits takes its
// children's blocks. The byte tensors 16-byte aligned. step: the step's
// row (step_scalars.cuh), whose lam the kernel reads; extra: the split's
// extra rate; limit: no block from it on splits. Returns the memset's
// error or cudaGetLastError() after the launch (none at K = 0).
extern "C" int descent_split_launch(
    const void* sel, const void* dist_b, const void* rate_b,
    const void* dist4, const void* rate4, const void* rec_y32,
    const void* rec_u16, const void* rec_v16, void* split32, void* rec_y,
    void* rec_u, void* rec_v, const void* step, float extra, int k,
    int nb32, int cols32, int limit, void* stream) {
  SplitArgs a;
  a.sel = static_cast<const int*>(sel);
  a.dist_b = static_cast<const int*>(dist_b);
  a.rate_b = static_cast<const int64_t*>(rate_b);
  a.dist4 = static_cast<const int64_t*>(dist4);
  a.rate4 = static_cast<const int64_t*>(rate4);
  a.rec_y32 = static_cast<const uint8_t*>(rec_y32);
  a.rec_u16 = static_cast<const uint8_t*>(rec_u16);
  a.rec_v16 = static_cast<const uint8_t*>(rec_v16);
  a.split32 = static_cast<int*>(split32);
  a.rec_y = static_cast<uint8_t*>(rec_y);
  a.rec_u = static_cast<uint8_t*>(rec_u);
  a.rec_v = static_cast<uint8_t*>(rec_v);
  a.step = static_cast<const int*>(step);
  a.extra = extra;
  a.k = k;
  a.nb32 = nb32;
  a.cols32 = cols32;
  a.limit = limit;
  if (cols32 <= 0 || nb32 % cols32 != 0 || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(split32, 0, sizeof(int) * static_cast<size_t>(nb32), s);
  if (err != cudaSuccess || k == 0) return static_cast<int>(err);
  return static_cast<int>(launch_split(a, s));
}

// Kernel `which` (0 gather, 1 decide, 2 pack, 3 split) on the current
// device: *ctas_per_sm the CTAs an SM holds at once, *smem_bytes the
// dynamic shared memory each asks for. Returns the CUDA error of the query
// (0 if none).
extern "C" int descent_occupancy(int which, int* ctas_per_sm,
                                 int* smem_bytes) {
  switch (which) {
    case 0:
      *smem_bytes = kGatherSmem;
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, descent_gather_kernel, kGatherThreads, kGatherSmem));
    case 1:
      *smem_bytes = 0;
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, descent_decide_kernel, kDecideThreads, 0));
    case 2:
      *smem_bytes = kSmemBytes;
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, descent_pack_kernel, kPackThreads, kSmemBytes));
    case 3:
      *smem_bytes = 0;
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, descent_split_kernel, kSplitThreads, 0));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
