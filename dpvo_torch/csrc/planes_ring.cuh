// The correlation planes on a ring of bulk copies: the persistent kernel
// body shared by K2 (corr_fused.cu:corr_planes_ring) and the probes K5 and
// K8 (corr_probes.cu:probe_planes_ring). Per edge e, for each of its 9
// source-patch pixels p and every position q of two windows (WY1 x WX1 on
// fmap1 at (by1, bx1), WY2 x WX2 on fmap2 at (by2, bx2), row-major, level 1
// first) of the target frame j:
//
//   plane[e, p, q] = sum_ch g[p, ch] * fmap[j, by + q / wx, bx + q % wx, ch]
//
// rounded to bf16 (f32 accumulation), 0 where the pixel lies outside the
// map and for an edge whose source row or target frame is out of range.
// With kRoll (K5) each level of edge e is rolled by -sh[e] over its
// flattened plane: out[e, p, c] = plane[e, p, (c + sh[e]) mod N].
//
// What bounds it on an H100 is the stream of window rows from L2 to the SMs
// (256 B per position, each edge reading its own windows), so the design
// keeps that stream going and spends little else (PERF.md section 6, PR 7):
//   * a persistent grid: as many blocks as fit, each walking the edges with
//     a stride of the grid, so that one edge's stores drain while the next
//     edge's rows stream in. Each block has one producer warp and kWarps
//     consumer warps;
//   * the producer warp keeps a ring of stages full, each kRows window
//     positions (an edge is N / kRows stages), with 1-D bulk copies
//     (cp.async.bulk) that complete on the stage's "full" mbarrier: inside
//     the map a window row is wx contiguous channel rows of the
//     channels-last map, so lane r copies the part of window row r's
//     in-map run that falls in the stage, one copy, and the lanes of the
//     edge's rows issue together. The edge's 9 g rows, its window bases
//     (and rolls) ride in a double buffer with their own barriers;
//   * positions outside the map are not copied. Their slots hold stale
//     rows, whose products land in their own columns only (a column of an
//     mma product depends on its own B column alone), and the epilogue
//     writes those columns as zero. An edge whose source row or frame is out
//     of range copies no window row and writes zeros;
//   * the roll is done by the copies: ring slot c of a level receives the
//     window position (c + sh) mod N, so a row's run lands in at most two
//     pieces (split where it wraps), the products come out in output order,
//     and the epilogue tests the rolled position of each column;
//   * the consumers hold the g rows as the mma A operand, run each
//     8-position tile of a stage with B read from shared memory (rows
//     unswizzled at a 256-byte stride; odd lane groups read the 32-channel
//     chunks xor-swapped against the 2-way bank conflict,
//     mma_bf16.cuh:stage_b), release the stage on its "empty" mbarrier and
//     store the products as bf16 straight from registers. Each warp takes
//     two adjacent tiles at a time, and the lanes of a quad trade columns by
//     shuffles, so that each g row's 16 columns go out as one 32-byte store:
//     a whole sector, where a tile alone writes half of one.
//
// Block b takes edges b, b + grid, ...; its k-th stage fill (chunk k % (N /
// kRows) of its edge number k / (N / kRows), positions [chunk * kRows, +
// kRows)) goes to stage k % kStages and fills it for the (k /
// kStages)-th time: the consumers wait for the full barrier's phase of
// parity (k / kStages) & 1, the producer for the empty barrier's phase of
// the other parity. The block's i-th edge takes g slot i % 2 with parity
// (i / 2) & 1 in the same way (tests/test_torch_corr_planes_ring.py:
// ring_schedule states the same and checks it).
//
// A spec S of an instantiation names:
//   S::Ring              kStages, kRows, kWarps, kBlocksPerSm
//   S::kWY1 .. S::kWX2   the two windows
//   S::kRoll             rolled planes (K5) or planes
//   S::Args              the arguments: fmap1, fmap2, out1, out2 (bf16),
//                        E, F, H1, W1, H2, W2 and what S reads per edge
//   S::Edge, S::edge(a, e)  an edge's scalars, read one edge ahead
//   S::ok(a, x)          whether edge x names a source row and a frame
//   S::frame(x)          its target frame (when ok)
//   S::base(x)           its window bases (by1, bx1, by2, bx2)
//   S::shift(x)          its rolls, each in [0, N) of its level (kRoll)
//   S::g(a, x, e)        its 9 g rows (9 x 128 bf16, contiguous)
// and, optionally (K7; Opt below gives the others' defaults):
//   S::kPos1, S::kPos2   the ring's positions per level: the first ones of
//                        each flattened window (whole tile pairs); the
//                        producer copies nothing past them (nor past the
//                        tiles that hold the kept columns)
//   S::kKeep             the epilogue: the first kKeep columns of each
//                        level's plane row as f32, out (E * 9, kKeep) per
//                        level, instead of whole bf16 planes, each warp's
//                        tile pair staged in a slot of its own and written
//                        out as whole row runs; only the tiles that hold
//                        them are copied (a tile pair's second tile past
//                        them is computed on stale rows, never stored)
//   S::kStreams, S::Streams, S::streams(a, e, k), S::fold(st), S::sink(a, e, x)
//                        per-edge input streams that the producer's idle
//                        lanes (k = lane - window rows) read while the edge's
//                        copies are in flight, folded by xor into one word
//                        per edge; the planes never depend on them

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "ring.cuh"

namespace planes_ring {

using namespace corr_mma;   // kC, kP2, kRowU4, GFrag, tile_mma, stage_b
using namespace corr_ring;  // mbarriers, bulk copies

constexpr int kRowBytes = kC * 2;            // one bf16 channel row
constexpr int kGBytes = kP2 * kRowBytes;     // an edge's 9 g rows
// the window bases of an edge whose source row or frame is out of range:
// every row of its windows lies above the map
constexpr int kFar = -(1 << 28);

struct NoStreams {};

// The optional members of a spec: whole windows, bf16 planes and no
// streams (K2, K5, K8), or what a spec naming kKeep gives (K7).
template <class S, class = void>
struct Opt {
  static constexpr int kPos1 = S::kWY1 * S::kWX1, kPos2 = S::kWY2 * S::kWX2;
  static constexpr int kKeep = 0;
  static constexpr bool kStreams = false;
  using Streams = NoStreams;
};
template <class S>
struct Opt<S, std::void_t<decltype(S::kKeep)>> {
  static constexpr int kPos1 = S::kPos1, kPos2 = S::kPos2;
  static constexpr int kKeep = S::kKeep;
  static constexpr bool kStreams = S::kStreams;
  using Streams = typename S::Streams;
};

// The shapes that follow from a spec.
template <class S>
struct Geom {
  using O = Opt<S>;
  static constexpr int kN1 = O::kPos1;              // level-1 positions
  static constexpr int kN2 = O::kPos2;              // level-2 positions
  static constexpr int kN = kN1 + kN2;              // positions per edge
  static constexpr int kTiles1 = kN1 / 8;           // tiles of 8 at level 1
  // the window rows that hold those positions, level 1 first
  static constexpr int kRows1 = (kN1 + S::kWX1 - 1) / S::kWX1;
  static constexpr int kRows2 = (kN2 + S::kWX2 - 1) / S::kWX2;
  static constexpr int kWinRows = kRows1 + kRows2;
  // the positions of each level that are copied and computed: the tiles
  // that hold its kept columns (kKeep), else all of them
  static constexpr int kLive1 = O::kKeep ? (O::kKeep + 7) / 8 * 8 : kN1;
  static constexpr int kLive2 = O::kKeep ? (O::kKeep + 7) / 8 * 8 : kN2;
  static constexpr bool kPrefix = kLive1 < S::kWY1 * S::kWX1 ||
                                  kLive2 < S::kWY2 * S::kWX2;
  // a slot: the 9 g rows, the window bases (int4) and the rolls (int2,
  // padded to 16 bytes)
  static constexpr int kSlotBytes = kGBytes + (S::kRoll ? 32 : 16);
  using R = typename S::Ring;
  // the kKeep epilogue's slots: 9 x 16 f32 per consumer warp
  static constexpr int kPairBytes = O::kKeep ? R::kWarps * kP2 * 16 * 4 : 0;
  // dynamic shared memory: the stages, the g double buffer, the barriers
  // full[stages], empty[stages], g_full[2], g_empty[2], the kKeep slots
  static constexpr int kSmem = R::kStages * R::kRows * kRowBytes +
                               2 * kSlotBytes + 8 * (2 * R::kStages + 4) +
                               kPairBytes;
  static constexpr int kThreads = 32 * (R::kWarps + 1);
  static_assert(S::kWX1 % 8 == 0 && S::kWX2 % 8 == 0,
                "a tile of 8 positions lies in one window row");
  static_assert(kN1 % 16 == 0 && kN2 % 16 == 0,
                "a tile pair lies in one level");
  static_assert(kN1 <= S::kWY1 * S::kWX1 && kN2 <= S::kWY2 * S::kWX2,
                "positions of the windows");
  static_assert(O::kKeep <= kN1 && O::kKeep <= kN2, "kept columns computed");
  static_assert(kWinRows <= 32, "one producer lane per window row");
  static_assert(R::kRows % 16 == 0 && kN % R::kRows == 0,
                "stages of whole tile pairs");
  static_assert(!S::kRoll || !kPrefix, "a roll takes whole windows");
  static_assert((kSmem + 1024) * R::kBlocksPerSm <= 228 * 1024,
                "the ring's blocks fit an SM (1 KB reserved per block)");
};

// Window row r of an edge (r < kRows1: level-1 row r, else level-2 row
// r - kRows1) inside the map: the edge's positions [qa, qb) in that row
// whose pixels lie in the map (and among its level's first kLive1 /
// kLive2), and the map pixel of the first (qa >= qb: none).
struct RowRun {
  int qa, qb;
  const bf16* src;
};

template <class S>
__device__ __forceinline__ RowRun row_run(int r, int4 base, const bf16* f1,
                                          const bf16* f2, int H1, int W1,
                                          int H2, int W2) {
  using G = Geom<S>;
  const bool l2 = r >= G::kRows1;
  const int wy = l2 ? r - G::kRows1 : r, wx = l2 ? S::kWX2 : S::kWX1;
  const int y = (l2 ? base.z : base.x) + wy, bx = l2 ? base.w : base.y;
  const int W = l2 ? W2 : W1;
  const int x0 = max(bx, 0), x1 = min(bx + wx, W);
  if (r >= G::kWinRows || y < 0 || y >= (l2 ? H2 : H1) || x0 >= x1)
    return RowRun{0, 0, nullptr};
  // the position of map column x in this row is q0 + x
  const int q0 = (l2 ? G::kN1 : 0) + wy * wx - bx;
  int qb = q0 + x1;
  if constexpr (G::kPrefix) qb = min(qb, l2 ? G::kN1 + G::kLive2 : G::kLive1);
  return RowRun{q0 + x0, qb,
                (l2 ? f2 : f1) + (static_cast<size_t>(y) * W + x0) * kC};
}

// Whether window position q (of its level, row-major) lies in the map.
template <int WX>
__device__ __forceinline__ bool pos_in(int q, int by, int bx, int H, int W) {
  const int y = by + q / WX, x = bx + q % WX;
  return y >= 0 && y < H && x >= 0 && x < W;
}

// The columns 2t, 2t + 1 of tile tq whose pixels lie inside the map (with
// kRoll, the pixels of the rolled positions).
template <class S>
__device__ __forceinline__ void tile_cols_in(int tq, int4 base, int2 sh,
                                             int H1, int W1, int H2, int W2,
                                             bool& in0, bool& in1) {
  using G = Geom<S>;
  const int t = threadIdx.x & 3;
  const bool l2 = tq >= G::kTiles1;
  const int tl = l2 ? tq - G::kTiles1 : tq;
  if constexpr (S::kRoll) {
    const int n = l2 ? G::kN2 : G::kN1;
    int q = tl * 8 + 2 * t + (l2 ? sh.y : sh.x);
    if (q >= n) q -= n;
    const int q1 = q + 1 == n ? 0 : q + 1;
    if (l2) {
      in0 = pos_in<S::kWX2>(q, base.z, base.w, H2, W2);
      in1 = pos_in<S::kWX2>(q1, base.z, base.w, H2, W2);
    } else {
      in0 = pos_in<S::kWX1>(q, base.x, base.y, H1, W1);
      in1 = pos_in<S::kWX1>(q1, base.x, base.y, H1, W1);
    }
  } else {
    const int tpr = (l2 ? S::kWX2 : S::kWX1) / 8;
    const int y = (l2 ? base.z : base.x) + tl / tpr;
    const int x = (l2 ? base.w : base.y) + (tl % tpr) * 8 + 2 * t;
    const int W = l2 ? W2 : W1;
    const bool yin = y >= 0 && y < (l2 ? H2 : H1);
    in0 = yin && x >= 0 && x < W;
    in1 = yin && x + 1 >= 0 && x + 1 < W;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two adjacent tiles tq, tq + 1 (tq even, one level) of edge e as bf16:
// the lanes of a quad gather four consecutive columns each by shuffles, so
// that each g row's 16 columns go out as one 32-byte store.
template <class S>
__device__ __forceinline__ void store_planes_pair(
    const float (&d0)[4], const float (&d1)[4], int tq, int e, int4 base,
    int2 sh, int H1, int W1, int H2, int W2, bf16* __restrict__ plane1,
    bf16* __restrict__ plane2) {
  using G = Geom<S>;
  const int lane = threadIdx.x & 31, grp = lane >> 2, t = lane & 3;
  bool a0, a1, b0, b1;
  tile_cols_in<S>(tq, base, sh, H1, W1, H2, W2, a0, a1);
  tile_cols_in<S>(tq + 1, base, sh, H1, W1, H2, W2, b0, b1);
  const uint32_t ar = pack_bf16(a0 ? d0[0] : 0.f, a1 ? d0[1] : 0.f);
  const uint32_t a8 = pack_bf16(a0 ? d0[2] : 0.f, a1 ? d0[3] : 0.f);
  const uint32_t br = pack_bf16(b0 ? d1[0] : 0.f, b1 ? d1[1] : 0.f);
  const uint32_t b8 = pack_bf16(b0 ? d1[2] : 0.f, b1 ? d1[3] : 0.f);
  // lane t takes columns 4t .. 4t + 3 of the pair: from lanes 2t, 2t + 1
  // (mod 4) of its quad, of tile tq for t < 2, of tile tq + 1 else
  const int s0 = (lane & ~3) | ((2 * t) & 3);
  const uint32_t xa = __shfl_sync(0xffffffffu, ar, s0);
  const uint32_t ya = __shfl_sync(0xffffffffu, ar, s0 + 1);
  const uint32_t xb = __shfl_sync(0xffffffffu, br, s0);
  const uint32_t yb = __shfl_sync(0xffffffffu, br, s0 + 1);
  const uint32_t xa8 = __shfl_sync(0xffffffffu, a8, s0);
  const uint32_t ya8 = __shfl_sync(0xffffffffu, a8, s0 + 1);
  const uint32_t xb8 = __shfl_sync(0xffffffffu, b8, s0);
  const uint32_t yb8 = __shfl_sync(0xffffffffu, b8, s0 + 1);
  const bool l2 = tq >= G::kTiles1;
  const int tl = l2 ? tq - G::kTiles1 : tq;
  const int n = l2 ? G::kN2 : G::kN1;
  bf16* o = (l2 ? plane2 : plane1) + static_cast<size_t>(e) * kP2 * n +
            tl * 8 + 4 * t;
  *reinterpret_cast<uint2*>(o + grp * n) =
      t < 2 ? make_uint2(xa, ya) : make_uint2(xb, yb);
  if (grp == 0)
    *reinterpret_cast<uint2*>(o + 8 * n) =
        t < 2 ? make_uint2(xa8, ya8) : make_uint2(xb8, yb8);
}

// Two adjacent tiles tq, tq + 1 (tq even, one level) of edge e: the
// first kKeep columns of each g row as f32. The warp stages the pair's 9 x
// 16 products (columns outside the map zero) in its own slot wb, then
// writes each g row's run of kept columns (64 bytes) with 16 consecutive
// lanes, two rows per store: whole sectors, where 4-byte stores straight
// from registers wrote each sector in halves across 8 rows (rows of kKeep
// floats need not be 8-byte aligned, so the lanes cannot store pairs).
template <class S>
__device__ __forceinline__ void store_first_pair(
    const float (&d0)[4], const float (&d1)[4], int tq, int e, int4 base,
    int H1, int W1, int H2, int W2, float* wb, float* __restrict__ out1,
    float* __restrict__ out2) {
  using G = Geom<S>;
  constexpr int K = Opt<S>::kKeep;
  const int lane = threadIdx.x & 31, grp = lane >> 2, t = lane & 3;
  const bool l2 = tq >= G::kTiles1;
  const int c0 = (l2 ? tq - G::kTiles1 : tq) * 8;   // the pair's column
  if (c0 >= K) return;   // warp-uniform
  bool a0, a1, b0, b1;
  const int2 sh = make_int2(0, 0);
  tile_cols_in<S>(tq, base, sh, H1, W1, H2, W2, a0, a1);
  tile_cols_in<S>(tq + 1, base, sh, H1, W1, H2, W2, b0, b1);
  float* r = wb + grp * 16 + 2 * t;
  *reinterpret_cast<float2*>(r) =
      make_float2(a0 ? d0[0] : 0.f, a1 ? d0[1] : 0.f);
  *reinterpret_cast<float2*>(r + 8) =
      make_float2(b0 ? d1[0] : 0.f, b1 ? d1[1] : 0.f);
  if (grp == 0) {
    *reinterpret_cast<float2*>(r + 8 * 16) =
        make_float2(a0 ? d0[2] : 0.f, a1 ? d0[3] : 0.f);
    *reinterpret_cast<float2*>(r + 8 * 16 + 8) =
        make_float2(b0 ? d1[2] : 0.f, b1 ? d1[3] : 0.f);
  }
  __syncwarp();
  const int j = lane & 15, n = min(16, K - c0);
  float* o = (l2 ? out2 : out1) + static_cast<size_t>(e) * kP2 * K + c0 + j;
#pragma unroll
  for (int p = lane >> 4; p < kP2; p += 2)
    if (j < n) o[p * K] = wb[p * 16 + j];
  __syncwarp();
}

// The kernel body of spec S; its __global__ gives it the launch bounds
// (Geom<S>::kThreads, S::Ring::kBlocksPerSm) and Geom<S>::kSmem of dynamic
// shared memory.
template <class S>
__device__ __forceinline__ void ring_body(const typename S::Args& a) {
  using G = Geom<S>;
  constexpr int St = S::Ring::kStages, Q = S::Ring::kRows;
  constexpr int nw = S::Ring::kWarps;
  constexpr int chunks = G::kN / Q;
  constexpr int kSlotBytes = G::kSlotBytes;
  extern __shared__ __align__(128) uint4 smem[];
  unsigned char* slots =
      reinterpret_cast<unsigned char*>(smem + St * Q * kRowU4);
  const uint32_t ring0 = smem_u32(smem);
  const uint32_t slot0 = ring0 + St * Q * kRowBytes;
  const uint32_t full0 = slot0 + 2 * kSlotBytes, empty0 = full0 + 8 * St;
  const uint32_t gfull0 = empty0 + 8 * St, gempty0 = gfull0 + 16;
  using O = Opt<S>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int E = a.E, H1 = a.H1, W1 = a.W1, H2 = a.H2, W2 = a.W2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < St; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, nw);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(gfull0 + 8 * b, 1);
      mbar_init(gempty0 + 8 * b, nw);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == nw) {  // the producer: lane r copies window row r
    int stage = 0;
    uint32_t phase = 0;
    typename S::Edge next = S::edge(a, blockIdx.x);
    for (int e = blockIdx.x, i = 0; e < E; e += gridDim.x, ++i) {
      const typename S::Edge cur = next;
      if (e + gridDim.x < E) next = S::edge(a, e + gridDim.x);
      // block-uniform: an edge naming no source row or target frame copies
      // nothing and is all zero
      const bool ok = S::ok(a, cur);
      const int4 base = ok ? S::base(cur) : make_int4(kFar, 0, kFar, 0);
      int2 sh = make_int2(0, 0);
      if constexpr (S::kRoll) sh = S::shift(cur);
      // the idle lanes' loads of the edge's streams, folded after its copies
      typename O::Streams st{};
      if constexpr (O::kStreams) {
        if (lane >= G::kWinRows) st = S::streams(a, e, lane - G::kWinRows);
      }
      if (lane == 0) {
        const int sl = i & 1;
        const uint32_t gfull = gfull0 + 8 * sl;
        mbar_wait(gempty0 + 8 * sl, ((i >> 1) & 1) ^ 1);
        unsigned char* slot = slots + sl * kSlotBytes;
        *reinterpret_cast<int4*>(slot + kGBytes) = base;
        if constexpr (S::kRoll)
          *reinterpret_cast<int2*>(slot + kGBytes + 16) = sh;
        if (ok) {
          mbar_expect_tx(gfull, kGBytes);
          bulk_load(slot0 + sl * kSlotBytes, S::g(a, cur, e), kGBytes, gfull);
        } else {
          mbar_arrive(gfull);
        }
      }
      const size_t j = ok ? S::frame(cur) : 0;
      const RowRun run =
          row_run<S>(lane, base, a.fmap1 + j * H1 * W1 * kC,
                     a.fmap2 + j * H2 * W2 * kC, H1, W1, H2, W2);
      // the run lands in ring positions [pa, pa + na) and, where a roll
      // wraps it, [pb, pb + nb), whose first row is the run's row na
      int pa = run.qa, na = run.qb - run.qa, pb = 0, nb = 0;
      if constexpr (S::kRoll) {
        const bool l2 = lane >= G::kRows1;
        const int off = l2 ? G::kN1 : 0, n = l2 ? G::kN2 : G::kN1;
        pa -= l2 ? sh.y : sh.x;
        if (pa < off) pa += n;
        const int over = pa + na - (off + n);
        if (over > 0) {
          na -= over;
          pb = off;
          nb = over;
        }
      }
      for (int c = 0; c < chunks; ++c) {
        const uint32_t full = full0 + 8 * stage;
        // this lane's part of the stage's positions [c * Q, c * Q + Q)
        const int lo = max(pa, c * Q), n = min(pa + na, c * Q + Q) - lo;
        int lob = 0, m = 0;
        if constexpr (S::kRoll) {
          lob = max(pb, c * Q);
          m = min(pb + nb, c * Q + Q) - lob;
        }
        const uint32_t bytes = __reduce_add_sync(
            0xffffffffu, (n > 0 ? n * kRowBytes : 0) +
                             (m > 0 ? m * kRowBytes : 0));
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        if (lane == 0) mbar_expect_tx(full, bytes);
        __syncwarp();
        if (n > 0)
          bulk_load(ring0 + (stage * Q + lo - c * Q) * kRowBytes,
                    run.src + (lo - pa) * kC, n * kRowBytes, full);
        if (m > 0)
          bulk_load(ring0 + (stage * Q + lob - c * Q) * kRowBytes,
                    run.src + (na + lob - pb) * kC, m * kRowBytes, full);
        if (++stage == St) {
          stage = 0;
          phase ^= 1;
        }
      }
      if constexpr (O::kStreams) {
        const unsigned x = __reduce_xor_sync(
            0xffffffffu, lane >= G::kWinRows ? S::fold(st) : 0u);
        if (lane == 0) S::sink(a, e, x);
      }
    }
    return;
  }

  // the consumers: warp w takes the tile pairs (2w, 2w + 1), (2w + 2nw,
  // 2w + 2nw + 1), ... of every stage
  // the kKeep epilogue's slots, one per consumer warp: 9 x 16 f32
  float* wbuf = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(smem) + G::kSmem - G::kPairBytes);
  bf16* plane1 = nullptr;
  bf16* plane2 = nullptr;
  if constexpr (O::kKeep == 0) {
    plane1 = static_cast<bf16*>(a.out1);
    plane2 = static_cast<bf16*>(a.out2);
  }
  const int grp = lane >> 2;
  const int sw = grp & 1;
  int stage = 0;
  uint32_t phase = 0;
  for (int e = blockIdx.x, i = 0; e < E; e += gridDim.x, ++i) {
    const int sl = i & 1;
    mbar_wait(gfull0 + 8 * sl, (i >> 1) & 1);
    const unsigned char* slot = slots + sl * kSlotBytes;
    const GFrag g = load_gfrag(reinterpret_cast<const uint4*>(slot));
    const int4 base = *reinterpret_cast<const int4*>(slot + kGBytes);
    int2 sh = make_int2(0, 0);
    if constexpr (S::kRoll)
      sh = *reinterpret_cast<const int2*>(slot + kGBytes + 16);
    __syncwarp();
    if (lane == 0) mbar_arrive(gempty0 + 8 * sl);
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint4* st = smem + stage * Q * kRowU4;
      for (int tile = 2 * warp; tile < Q / 8; tile += 2 * nw) {
        uint4 b[kChunks];
        float d0[4], d1[4];
        stage_b(st + (tile * 8 + grp) * kRowU4, sw, b);
        tile_mma(g, b, d0);
        stage_b(st + (tile * 8 + 8 + grp) * kRowU4, sw, b);
        tile_mma(g, b, d1);
        const int tq = c * (Q / 8) + tile;
        if constexpr (O::kKeep == 0)
          store_planes_pair<S>(d0, d1, tq, e, base, sh, H1, W1, H2, W2,
                               plane1, plane2);
        else
          store_first_pair<S>(d0, d1, tq, e, base, H1, W1, H2, W2,
                              wbuf + warp * kP2 * 16,
                              static_cast<float*>(a.out1),
                              static_cast<float*>(a.out2));
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == St) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

}  // namespace planes_ring
