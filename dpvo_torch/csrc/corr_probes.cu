// The correlation probes (K4-K8), hand-written for Hopper (sm_90a). Each
// computes one variant of the per-edge correlation planes of K2
// (csrc/corr_fused.cu): for edge e, the dot of its 9 source-patch pixels
// g[e, p, :] with every pixel of a window of a target map, f32 accumulation.
// Built with nvcc into a shared library with plain C entries and bound from
// Python with ctypes (dpvo_torch/ops/corr_probes.py, which also holds the
// plain PyTorch version of each instantiation).
//
// The TPU kernels they replace, all Pallas calls in the probe scripts:
//   probe_pair_tiles<1>, <2> (with the binning kernels bin_*)
//                           scripts/micro_fused_v2.py:_plane_kernel_k2 (K4)
//   probe_planes_ring<kRollK5>
//                           scripts/micro_fused_v2.py:_plane_kernel_roll (K5)
//   probe_dots              scripts/micro_corr_floor.py:dot_kernel,
//                           dot_kernel2 (K6)
//   probe_slab_tiles (with the binning kernels bin_*)
//                           scripts/micro_corr_floor.py:fused_kernel (K6)
//   probe_planes_ring<kFirst49>, <kFirst49S>
//                           scripts/micro_onepass_dma.py:kernel (K7,
//                           STREAMS=0 / 1)
//   probe_planes_ring<kW12x16>, <kFixedW>
//                           scripts/micro_kernel_variants.py:make_kernel
//                           (K8; modes full / twodots / rank3 in one
//                           instantiation, fixedw in a second)
//
// What bounds them: memory. A plane entry costs 2 x 128 FLOPs and 2-4 bytes
// of output, so at the bf16 tensor-core peak (989 TFLOP/s) the FLOPs take
// 4-40x less time than moving the planes, g rows and maps at 3.35 TB/s.
//
// probe_dots (K6 dot_kernel, dot_kernel2) is a pure stream from device
// memory: each edge's window (98,304 B, or a 65,536 B prefix) is read once
// and nothing is reused, so only the DRAM rate bounds it (the operations
// take ~40x less time), and the design's one job is to keep enough bytes
// in flight at every moment and to spend nothing else. It is a persistent
// kernel: a grid of as many blocks as fit (one per SM for dots, three for
// dots2) walks the edges with a stride of the grid, so no block starts or
// ends between edges. Each block has one producer warp and 8 (dots) or 4
// (dots2) consumer warps:
//   * one lane of the producer keeps a ring of stages full, each `rows`
//     window rows, with 1-D bulk copies (cp.async.bulk, the copy engine;
//     an edge's rows are contiguous, so no tensor map is needed) that
//     complete on the stage's "full" mbarrier; the edge's 9 g rows ride in
//     a double buffer with their own barriers;
//   * the consumers hold the g rows as the mma A operand, run each 8-row
//     tile of a stage on the tensor cores with B read from shared memory,
//     release the stage on its "empty" mbarrier, and store their f32 (or
//     bf16) products straight from registers, which drain while the
//     producer already streams the next chunks;
//   * rows land unswizzled at a 256-byte stride, so lane groups grp and
//     grp + 1 read the same banks; odd groups read the 32-channel chunks
//     in xor-swapped order (the channels stay paired in A and B).
// The ring's shape (stages, rows, consumer warps, blocks per SM) is fixed
// at compile time for each instantiation (DotsRing). On an H100 the kernel
// runs at ~90% of the bytes bound, level with torch.bmm's cuBLAS kernel:
// once 64 KB or more per SM are in flight the time no longer depends on
// the ring (the rings within ~0.5% of each other, the spread of one
// measurement), nor on the copy path (bulk copies, cp.async with L2 fetch
// hints and 2-D tensor-map copies with L2 promotion measured alike).
//
// probe_planes_ring (K5, K7, K8) is K2's kernel for bf16 maps with other
// windows and epilogues: the body planes_ring.cuh:ring_body, one spec per
// instantiation (ProbeSpec, First49Spec), its ring fixed at compile time
// (ProbeRing). A persistent grid; a producer warp, lane r copying window
// row r's in-map run into a ring of stages with cp.async.bulk on mbarriers
// (K8's 24 rows of 16 positions, 4 KB each; K5's 22 rows of K2; K7's 7 rows
// of the first 64 positions of each level); consumer warps on mma.sync
// storing tile pairs from registers as whole 32-byte sectors (K7: its
// first 49 f32 columns). K5's roll is done by the copies: ring slot c of a
// level receives window position (c + sh) mod N, so its products come out
// in output order and its stores are K2's. K7's streams are read by the
// producer's idle lanes while the edge's copies are in flight. Each edge
// still reads its own windows from L2 (K5 114,688 B, K8 98,304 B, K7
// 32,768 B per edge), 4-5x the bytes bound.
//
// probe_pair_tiles (K4) is the step below that floor: the edges are binned
// by target tile on the device, and each tile's map rows are staged once
// per work item of up to 64 edges (the note at its definition).
//
// probe_slab_tiles (K6 fused_kernel) takes the same binning one step
// further: within a bin of one column base the edges are sorted by their
// row base, so that for each map row of a tile the edges whose windows hold
// it are one contiguous run, and the row's products are one small GEMM of
// the run's flattened g rows (m16 tiles that may span two edges) with the
// row's 16 positions (the note at its definition).
//
// Dropped, as TPU layout: the padded slabs and the phase-shifted copies of
// the maps (positions outside the map read as zero, which is what the
// padding held; a phase is bx + 4 * ph), the bit-packed SMEM scalar streams
// (plain int32 arrays), the 32-edge sequential grid with its target-slab DMA
// (persistent grids), and K4's off-diagonal products (each edge is dotted
// with its own window only).
//
// Layouts (all contiguous): g (E, 9, 128) bf16, one row block per edge;
// fmap1 (F, H1, W1, 128), fmap2 (F, H2, W2, 128) bf16; jj, by*, bx*, sh*
// (E,) int32; win (E, W, 128) bf16; slab map (H, W, 128) bf16. Outputs as
// each entry says.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <numeric>
#include <type_traits>

#include "mma_bf16.cuh"
#include "planes_ring.cuh"
#include "ring.cuh"

namespace {

using namespace corr_mma;   // GFrag, load_gfrag, mma_bf16, stage_b, ...
using namespace corr_ring;  // mbarriers, bulk copies

constexpr int kFirst = 49;              // K7 keeps 49 columns per level

struct PlaneArgs {
  const bf16 *g, *fmap1, *fmap2;
  const int *jj, *by1, *bx1, *by2, *bx2;
  const int *sh1, *sh2;                       // K5
  const int *s1, *s2;                         // K7's streams
  const float *fr1, *fr2, *S1, *S2;
  int nS1, nS2;
  unsigned* sink;
  void *out1, *out2;
  int E, F, H1, W1, H2, W2;
};

// K5, K7 and K8 on the ring of bulk copies (planes_ring.cuh:ring_body,
// K2's design): one spec per instantiation.
enum RingProbe {
  kRollK5 = 0,
  kW12x16 = 1,
  kFixedW = 2,
  kFirst49 = 3,
  kFirst49S = 4
};

// The ring of each: kStages stages of kRows window positions, kWarps
// consumer warps (+ 1 producer), and the blocks asked for on each SM (at
// most what fits). Chosen by a sweep (dpvo_torch/scripts/ring_sweep.py,
// PERF.md section 6).
template <int P>
struct ProbeRing;
template <>
struct ProbeRing<kRollK5> {  // planes_roll
  static constexpr int kStages = 3, kRows = 64, kWarps = 2, kBlocksPerSm = 4;
};
template <>
struct ProbeRing<kW12x16> {  // planes_w12x16
  static constexpr int kStages = 3, kRows = 64, kWarps = 2, kBlocksPerSm = 4;
};
template <>
struct ProbeRing<kFixedW> {  // planes_fixedw
  static constexpr int kStages = 3, kRows = 64, kWarps = 2, kBlocksPerSm = 4;
};
template <>
struct ProbeRing<kFirst49> {  // planes_first49
  static constexpr int kStages = 2, kRows = 128, kWarps = 4, kBlocksPerSm = 3;
};
template <>
struct ProbeRing<kFirst49S> {  // planes_first49_streams
  static constexpr int kStages = 2, kRows = 128, kWarps = 4, kBlocksPerSm = 3;
};

// K5: K2's windows, rolled by sh1 / sh2 (each taken modulo its level's
// positions; it may be negative or past them). K8: 12 x 16 windows at both
// levels, at (by, bx) or, for fixedw, at (0, 0) (by*, bx* unread). K7:
// K2's windows (First49Spec). The g rows are g[e]; an edge whose frame jj
// is out of range is all zero.
template <int P>
struct ProbeSpec {
  using Ring = ProbeRing<P>;
  static constexpr bool kRoll = P == kRollK5, kFixed = P == kFixedW;
  static constexpr bool kK2Windows = kRoll || P == kFirst49 || P == kFirst49S;
  static constexpr int kWY1 = 12, kWX1 = kK2Windows ? 24 : 16;
  static constexpr int kWY2 = kK2Windows ? 10 : 12, kWX2 = 16;
  using Args = PlaneArgs;
  struct Edge {
    int j;
    int4 base;
    int2 sh;
  };
  static __device__ __forceinline__ Edge edge(const Args& a, int e) {
    Edge x{a.jj[e], make_int4(0, 0, 0, 0), make_int2(0, 0)};
    if constexpr (!kFixed)
      x.base = make_int4(a.by1[e], a.bx1[e], a.by2[e], a.bx2[e]);
    if constexpr (kRoll) {
      constexpr int n1 = kWY1 * kWX1, n2 = kWY2 * kWX2;
      x.sh = make_int2(((a.sh1[e] % n1) + n1) % n1,
                       ((a.sh2[e] % n2) + n2) % n2);
    }
    return x;
  }
  static __device__ __forceinline__ bool ok(const Args& a, const Edge& x) {
    return x.j >= 0 && x.j < a.F;
  }
  static __device__ __forceinline__ int frame(const Edge& x) { return x.j; }
  static __device__ __forceinline__ int4 base(const Edge& x) { return x.base; }
  static __device__ __forceinline__ int2 shift(const Edge& x) { return x.sh; }
  static __device__ __forceinline__ const bf16* g(const Args& a, const Edge&,
                                                  int e) {
    return a.g + static_cast<size_t>(e) * kP2 * kC;
  }
};

// K7: the first 49 columns of each level's flattened plane row, f32, as
// (E * 9, 49) per level (row p of edge e at (e * 9 + p) * 49). The ring
// computes whole tile pairs, so the first 64 positions of each level: its 7
// window rows (level-1 rows 0-1 and 16 positions of row 2, level-2 rows
// 0-3), 2 stages of 64 per edge. kFirst49S also reads the probe's per-step
// input streams (STREAMS=1) with the producer's idle lanes: the edge's 9
// rows of s1, s2 (int32), fr1, fr2 (f32 pairs), and elements e * 32 ..
// e * 32 + 31 of S1 and S2 (and their repeats at strides of E * 32, so
// that the grid reads each element once), folded by xor into sink[e].
template <int P>
struct First49Spec : ProbeSpec<P> {
  using Args = PlaneArgs;
  static constexpr int kPos1 = 64, kPos2 = 64, kKeep = kFirst;
  static constexpr bool kStreams = P == kFirst49S;
  // the producer's lanes past the window rows: 32 - 3 - 4 = 25
  static constexpr int kIdle =
      32 - (kPos1 + ProbeSpec<P>::kWX1 - 1) / ProbeSpec<P>::kWX1 -
      (kPos2 + ProbeSpec<P>::kWX2 - 1) / ProbeSpec<P>::kWX2;
  static_assert(kIdle >= kP2 && 2 * kIdle >= 32, "two S elements a lane");
  struct Streams {
    unsigned w[10];
  };
  // idle lane k (0 .. kIdle - 1) of the producer: rows e * 9 + k (k < 9),
  // and the S1 / S2 elements j = k and k + kIdle (< 32) of the edge
  static __device__ __forceinline__ Streams streams(const Args& a, int e,
                                                    int k) {
    Streams s{};
    if (k < kP2) {
      const size_t r = static_cast<size_t>(e) * kP2 + k;
      const float2 f1 = reinterpret_cast<const float2*>(a.fr1)[r];
      const float2 f2 = reinterpret_cast<const float2*>(a.fr2)[r];
      s.w[0] = static_cast<unsigned>(a.s1[r]);
      s.w[1] = static_cast<unsigned>(a.s2[r]);
      s.w[2] = __float_as_uint(f1.x);
      s.w[3] = __float_as_uint(f1.y);
      s.w[4] = __float_as_uint(f2.x);
      s.w[5] = __float_as_uint(f2.y);
    }
    const size_t stride = static_cast<size_t>(a.E) * 32;
    int w = 6;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = k + kIdle * h;
      const size_t i = static_cast<size_t>(e) * 32 + j;
#pragma unroll
      for (int m = 0; m < 2; ++m, ++w) {
        const float* S = m ? a.S2 : a.S1;
        const size_t n = static_cast<size_t>(m ? a.nS2 : a.nS1);
        if (j < 32 && i < n) {
          s.w[w] = __float_as_uint(S[i]);
          for (size_t i2 = i + stride; i2 < n; i2 += stride)
            s.w[w] ^= __float_as_uint(S[i2]);
        }
      }
    }
    return s;
  }
  static __device__ __forceinline__ unsigned fold(const Streams& s) {
    unsigned x = 0;
#pragma unroll
    for (int i = 0; i < 10; ++i) x ^= s.w[i];
    return x;
  }
  static __device__ __forceinline__ void sink(const Args& a, int e,
                                              unsigned x) {
    a.sink[e] = x;
  }
};

// the spec of instantiation P
template <int P>
using SpecOf = std::conditional_t<P == kFirst49 || P == kFirst49S,
                                  First49Spec<P>, ProbeSpec<P>>;

template <int P>
__global__ void __launch_bounds__(planes_ring::Geom<SpecOf<P>>::kThreads,
                                  ProbeRing<P>::kBlocksPerSm)
probe_planes_ring(const PlaneArgs p) {
  planes_ring::ring_body<SpecOf<P>>(p);
}

// probe_planes_ring<P> for ring_shape
template <int P>
struct ProbeRingKernel {
  static const void* fn() {
    return reinterpret_cast<const void*>(probe_planes_ring<P>);
  }
  static constexpr int kThreads = planes_ring::Geom<SpecOf<P>>::kThreads;
  static constexpr int kSmem = planes_ring::Geom<SpecOf<P>>::kSmem;
  static constexpr int kBlocksPerSm = ProbeRing<P>::kBlocksPerSm;
};

// K6 dot_kernel / dot_kernel2 as a persistent streaming pipeline (the note
// at the head of this file).
constexpr int kRowBytes = kC * 2;            // one bf16 channel row
constexpr int kGBytes = kP2 * kRowBytes;     // an edge's 9 g rows

// The ring of the instantiation for N rows per edge: kStages stages of
// kRows window rows, kWarps consumer warps (+ 1 producer), and the blocks
// asked for on each SM (at most what fits). A tie within ~0.5% with the
// other rings measured, which is the spread of one measurement.
template <int N>
struct DotsRing;
template <>
struct DotsRing<384> {  // dots
  static constexpr int kStages = 2, kRows = 128, kWarps = 8, kBlocksPerSm = 1;
};
template <>
struct DotsRing<256> {  // dots2
  static constexpr int kStages = 4, kRows = 64, kWarps = 4, kBlocksPerSm = 3;
};

// dynamic shared memory of the ring for N: the stages, the g double
// buffer, the barriers full[stages], empty[stages], g_full[2], g_empty[2]
template <int N>
__host__ __device__ constexpr int dots_smem() {
  using R = DotsRing<N>;
  return R::kStages * R::kRows * kRowBytes + 2 * kGBytes +
         8 * (2 * R::kStages + 4);
}

// a tile's products (tile_mma's d) to positions q0 .. q0 + 7 of the rows of
// out[base ..] (9 x N), straight from registers
template <int N, bool kBf16Out>
__device__ __forceinline__ void store_tile(void* out, size_t base, int q0,
                                           const float (&d)[4]) {
  const int lane = threadIdx.x & 31, grp = lane >> 2, t = lane & 3;
  const size_t i = base + static_cast<size_t>(grp) * N + q0 + 2 * t;
  const size_t i8 = base + static_cast<size_t>(8) * N + q0 + 2 * t;
  if constexpr (kBf16Out) {
    bf16* o = static_cast<bf16*>(out);
    *reinterpret_cast<__nv_bfloat162*>(o + i) =
        __floats2bfloat162_rn(d[0], d[1]);
    if (grp == 0)
      *reinterpret_cast<__nv_bfloat162*>(o + i8) =
          __floats2bfloat162_rn(d[2], d[3]);
  } else {
    float* o = static_cast<float*>(out);
    *reinterpret_cast<float2*>(o + i) = make_float2(d[0], d[1]);
    if (grp == 0) *reinterpret_cast<float2*>(o + i8) = make_float2(d[2], d[3]);
  }
}

// Per edge e (block b takes e = b, b + grid, ...), g[e] (9, 128) times the
// first N rows of its window win[e] (W rows of 128). Out (E, 9, N), f32 or
// bf16. Dynamic shared memory (dots_smem): the ring [stages][rows][128]
// bf16, the g double buffer [2][9][128] bf16, then the barriers. The k-th
// chunk of a block goes to stage k % stages and fills it for the
// (k / stages)-th time: the phase of that parity (tests/
// test_torch_corr_probes.py:dots_schedule states the same and checks it).
template <int N, bool kBf16Out>
__global__ void __launch_bounds__(32 * (DotsRing<N>::kWarps + 1))
probe_dots(const bf16* __restrict__ g, const bf16* __restrict__ win,
           void* __restrict__ out, int E, int W) {
  constexpr int S = DotsRing<N>::kStages, R = DotsRing<N>::kRows;
  constexpr int nw = DotsRing<N>::kWarps;
  constexpr int chunks = N / R;
  static_assert(R % 8 == 0 && N % R == 0, "stages of whole tiles");
  static_assert((dots_smem<N>() + 1024) * DotsRing<N>::kBlocksPerSm <=
                    228 * 1024,
                "the ring's blocks fit an SM (1 KB reserved per block)");
  extern __shared__ __align__(128) uint4 smem[];
  const uint4* gbuf = smem + S * R * kRowU4;
  const uint32_t ring0 = smem_u32(smem);
  const uint32_t g0 = ring0 + S * R * kRowBytes;
  const uint32_t full0 = g0 + 2 * kGBytes, empty0 = full0 + 8 * S;
  const uint32_t gfull0 = empty0 + 8 * S, gempty0 = gfull0 + 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
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

  if (warp == nw) {  // the producer: its lane 0 issues every copy
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int e = blockIdx.x, i = 0; e < E; e += gridDim.x, ++i) {
      const uint32_t gb = 8 * (i & 1);
      mbar_wait(gempty0 + gb, ((i >> 1) & 1) ^ 1);
      mbar_expect_tx(gfull0 + gb, kGBytes);
      bulk_load(g0 + (i & 1) * kGBytes, g + static_cast<size_t>(e) * kP2 * kC,
                kGBytes, gfull0 + gb);
      const bf16* src = win + static_cast<size_t>(e) * W * kC;
      for (int c = 0; c < chunks; ++c, src += R * kC) {
        const uint32_t full = full0 + 8 * stage;
        const uint32_t dst = ring0 + stage * R * kRowBytes;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        mbar_expect_tx(full, R * kRowBytes);
        bulk_load(dst, src, R * kRowBytes, full);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warp w takes tiles w, w + nw, ... of every stage
  const int grp = lane >> 2;
  const int sw = grp & 1;
  int stage = 0;
  uint32_t phase = 0;
  for (int e = blockIdx.x, i = 0; e < E; e += gridDim.x, ++i) {
    const uint32_t gb = 8 * (i & 1);
    mbar_wait(gfull0 + gb, (i >> 1) & 1);
    const GFrag a = load_gfrag(gbuf + (i & 1) * kP2 * kRowU4);
    __syncwarp();
    if (lane == 0) mbar_arrive(gempty0 + gb);
    const size_t base = static_cast<size_t>(e) * kP2 * N;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint4* st = smem + stage * R * kRowU4;
      for (int tile = warp; tile < R / 8; tile += nw) {
        uint4 b[kChunks];
        float d[4];
        stage_b(st + (tile * 8 + grp) * kRowU4, sw, b);
        tile_mma(a, b, d);
        store_tile<N, kBf16Out>(out, base, c * R + tile * 8, d);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// ---- the binning by target tile (K4, K6 slab) ----
//
// K4 and the slab bin their edges by target tile on the device, with one
// chain of kernels on one stream and every count on the device:
//   1. bin_count: each edge's key at each level (a BinLevel), and the keys'
//      counts (atomics). A key is a fine bin inside a coarse bin (frame,
//      row bin of by, exact bx); K4's fine bin is the coarse one, the
//      slab's is the exact by inside it (kept bin-major, so that the sort
//      leaves each coarse bin's edges ordered by by). An edge whose frame
//      is out of range or whose window misses the map goes to the last
//      coarse bin, whose items write zeros;
//   2. bin_sums, bin_scan (one block per 1024 coarse bins): the exclusive
//      scan of the coarse bins' counts, each block adding the sums of the
//      blocks before it, the fine bins' first sorted positions, and the
//      work items: a coarse bin of n edges is ceil(n / cap) items of at
//      most cap edges, so that a skewed input still spreads;
//   3. bin_scatter: each edge's (id, by) to its fine bin's next position;
//   4. the tile kernel of each level (probe_pair_tiles<L>,
//      probe_slab_tiles): a persistent grid claims the items with an
//      atomic counter that the scan resets.

constexpr int kScanThreads = 1024;
// fine bins per coarse bin at most: an exact-by level's TY = R - WY + 1
// for tiles of at most 32 rows and windows of at least 16
constexpr int kMaxFine = 17;

// One level's binning (the note above), in the caller's int32 scratch.
struct BinLevel {
  int* count;    // [nbins] edges per fine bin (zeroed before the count)
  int* off;      // [nbins] first sorted position, then the scatter's cursor
  int* key;      // [E] each edge's fine bin
  int2* rec;     // [E] (edge, by) in bin order
  int4* items;   // [E] (first sorted position, edges, coarse bin, tile
                 // positions)
  int2* part;    // [nblocks] edges and items of each scan block's bins
  int* nitems;   // the number of items
  int* claim;    // the tile kernel's count of claimed items
  const int *jj, *by, *bx;   // jj nullptr: every edge on frame 0
  int F, H, W, WY, WX;       // maps (F, H, W), windows WY x WX
  int TY, NYB, NXB;          // window bases per row bin, row bins, columns
  int G;                     // fine bins per coarse bin: 1, or TY (exact by)
  int cap;                   // edges per item at most
  int ncoarse, nblocks;      // coarse bins (the last writes zeros), scan
                             // blocks
  long long items_at, nitems_at;   // the words of items and nitems
};

// The levels of one chain (n = 1 or 2), launched together.
struct BinLevels {
  BinLevel l[2];
  int n;
};

// Level b's shape for maps (F, H, W), windows WY x WX, tiles of at most R
// map rows and items of at most cap edges: the row bin TY (R - WY + 1
// bases per bin, so that a bin's windows span at most R rows; without
// `exact`, a map of at most R rows is one bin, every base whose window
// meets it, as only the in-map rows count), the coarse bins (frame, (by +
// WY - 1) / TY, bx + WX - 1) and the zero bin after them, and with `exact`
// TY fine bins (by + WY - 1) % TY per coarse bin. Returns the fine bins, or
// -1 past int32.
long long level_shape(BinLevel* b, int F, int H, int W, int WY, int WX,
                      int R, int cap, bool exact) {
  b->F = F;
  b->H = H;
  b->W = W;
  b->WY = WY;
  b->WX = WX;
  b->cap = cap;
  b->TY = H <= R && !exact ? H + WY - 1 : R - WY + 1;
  b->NYB = (H + WY - 1 + b->TY - 1) / b->TY;
  b->NXB = W + WX - 1;
  b->G = exact ? b->TY : 1;
  const long long nc = static_cast<long long>(F) * b->NYB * b->NXB + 1;
  const long long n = nc * b->G;
  if (b->G > kMaxFine || n >= (1ll << 31)) return -1;
  b->ncoarse = static_cast<int>(nc);
  return n;
}

// The tile of coarse bin z (not the zero bin) of a level for the window
// bases of its fine rows kf .. kl (K4: 0 .. TY - 1, the whole bin): frame
// j, the first window row ty0 and column bx of the bin's bases, and the
// rows y0 .. y0 + rows - 1 and columns x0 .. x0 + nx - 1 of those windows
// that lie in the map, which the tile kernel copies (rows, nx >= 1: the
// bin's windows meet the map).
struct BinRect {
  int j, ty0, bx, y0, rows, x0, nx;
};

// the first window row of coarse bin z's bases
__device__ __forceinline__ int bin_ty0(int z, int WY, int TY, int NYB,
                                       int NXB) {
  return (z / NXB % NYB) * TY - (WY - 1);
}

__device__ __forceinline__ BinRect bin_rect(int z, int WY, int WX, int TY,
                                            int NYB, int NXB, int H, int W,
                                            int kf, int kl) {
  BinRect t;
  const int r = z / NXB;
  t.bx = z - r * NXB - (WX - 1);
  t.ty0 = bin_ty0(z, WY, TY, NYB, NXB);
  t.j = r / NYB;
  t.y0 = max(t.ty0 + kf, 0);
  t.rows = min(t.ty0 + kl + WY, H) - t.y0;
  t.x0 = max(t.bx, 0);
  t.nx = min(t.bx + WX, W) - t.x0;
  return t;
}

// edge e's fine bin at level b
__device__ __forceinline__ int bin_key(const BinLevel& b, int e) {
  const int j = b.jj != nullptr ? b.jj[e] : 0;
  const int by = b.by[e], bx = b.bx[e];
  if (j < 0 || j >= b.F || by <= -b.WY || by >= b.H || bx <= -b.WX ||
      bx >= b.W)
    return (b.ncoarse - 1) * b.G;
  const int y = by + b.WY - 1, r = y / b.TY;
  return ((j * b.NYB + r) * b.NXB + bx + b.WX - 1) * b.G +
         (b.G > 1 ? y - r * b.TY : 0);
}

__global__ void bin_count(const BinLevels L, int E) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += gridDim.x * blockDim.x) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (l < L.n) {
        const int k = bin_key(L.l[l], e);
        L.l[l].key[e] = k;
        atomicAdd(L.l[l].count + k, 1);
      }
    }
  }
}

// The block's exclusive scan of v (kScanThreads threads); *total the sum.
__device__ __forceinline__ int block_excl_scan(int v, int* tmp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = tmp[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    tmp[lane] = w;
  }
  __syncthreads();
  const int out = x - v + (warp ? tmp[warp - 1] : 0);
  *total = tmp[31];
  __syncthreads();
  return out;
}

// The scan's blocks: kScanThreads coarse bins each, those of level 0 first.
__device__ __forceinline__ BinLevel scan_level(const BinLevels& L, int* blk) {
  const int k = blockIdx.x;
  *blk = k < L.l[0].nblocks ? k : k - L.l[0].nblocks;
  return k < L.l[0].nblocks ? L.l[0] : L.l[1];
}

// The inclusive prefix sums pre[0 .. G - 1] of coarse bin i's fine
// counts (zero past G, and for i past the bins), each count loaded at
// once, unrolled over kMaxFine; returns the bin's edges.
__device__ __forceinline__ int fine_prefix(const BinLevel& b, int i,
                                           int (&pre)[kMaxFine]) {
  int acc = 0;
#pragma unroll
  for (int k = 0; k < kMaxFine; ++k) {
    acc += k < b.G && i < b.ncoarse ? b.count[i * b.G + k] : 0;
    pre[k] = acc;
  }
  return acc;
}

// per scan block: the edges and items of its coarse bins
__global__ void __launch_bounds__(kScanThreads)
bin_sums(const BinLevels L) {
  __shared__ int tmp[32];
  int blk;
  const BinLevel b = scan_level(L, &blk);
  const int i = blk * kScanThreads + threadIdx.x;
  int pre[kMaxFine];
  const int c = fine_prefix(b, i, pre);
  int edges, items;
  block_excl_scan(c, tmp, &edges);
  block_excl_scan((c + b.cap - 1) / b.cap, tmp, &items);
  if (threadIdx.x == 0) b.part[blk] = make_int2(edges, items);
}

// per scan block: the sums of the blocks before it, then its fine bins'
// first sorted positions and its coarse bins' items
__global__ void __launch_bounds__(kScanThreads)
bin_scan(const BinLevels L) {
  __shared__ int tmp[32];
  int blk;
  const BinLevel b = scan_level(L, &blk);
  int pe = 0, pi = 0;
  for (int k = threadIdx.x; k < blk; k += kScanThreads) {
    const int2 q = b.part[k];
    pe += q.x;
    pi += q.y;
  }
  int before_edges, before_items, total_edges, total_items;
  block_excl_scan(pe, tmp, &before_edges);
  block_excl_scan(pi, tmp, &before_items);
  const int i = blk * kScanThreads + threadIdx.x;
  int pre[kMaxFine];
  const int c = fine_prefix(b, i, pre);
  const int eo = before_edges + block_excl_scan(c, tmp, &total_edges);
  int io = before_items +
           block_excl_scan((c + b.cap - 1) / b.cap, tmp, &total_items);
  if (i < b.ncoarse) {
#pragma unroll
    for (int k = 0; k < kMaxFine; ++k)
      if (k < b.G) b.off[i * b.G + k] = eo + (k ? pre[k - 1] : 0);
  }
  // each item with the positions of its tile (what it copies) where the
  // bin fixes them (G = 1: the bin's tile); a level of exact-by fine bins
  // copies the rows of each item's own edges' windows, and its tile kernel
  // writes them (probe_slab_tiles)
  int pos = 0;
  if (b.G == 1 && c > 0 && i != b.ncoarse - 1) {
    const BinRect t = bin_rect(i, b.WY, b.WX, b.TY, b.NYB, b.NXB, b.H, b.W,
                               0, b.TY - 1);
    pos = t.rows * t.nx;
  }
  for (int m = 0; m < c; m += b.cap)
    b.items[io++] = make_int4(eo + m, min(b.cap, c - m), i, pos);
  if (threadIdx.x == 0) {
    if (blk == b.nblocks - 1) *b.nitems = before_items + total_items;
    if (blk == 0) *b.claim = 0;
  }
}

__global__ void bin_scatter(const BinLevels L, int E) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += gridDim.x * blockDim.x) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (l < L.n) {
        const int p = atomicAdd(L.l[l].off + L.l[l].key[e], 1);
        L.l[l].rec[p] = make_int2(e, L.l[l].by[e]);
      }
    }
  }
}

// The levels' binning in `scratch` (int32; nullptr: sizes only), their
// shapes set (level_shape): the fine bins' counts of every level together
// (zeroed by the launch), then per level items [4E], rec [2E], part
// [2 nblocks], key [E], off [nbins], nitems, claim, padded to 16 bytes.
// Returns the words needed, or -1 past int32.
long long bin_plan(int E, BinLevels* L, int* scratch) {
  auto round4 = [](long long w) { return (w + 3) / 4 * 4; };
  long long nb[2] = {0, 0}, counts = 0;
  for (int l = 0; l < L->n; ++l) {
    nb[l] = static_cast<long long>(L->l[l].ncoarse) * L->l[l].G;
    counts += nb[l];
  }
  long long at = round4(counts), cat = 0;
  for (int l = 0; l < L->n; ++l) {
    BinLevel& x = L->l[l];
    x.nblocks = (x.ncoarse + kScanThreads - 1) / kScanThreads;
    x.items_at = at;
    x.nitems_at = at + 6ll * E + 2ll * x.nblocks + E + nb[l];
    if (scratch != nullptr) {
      x.count = scratch + cat;
      x.items = reinterpret_cast<int4*>(scratch + at);
      x.rec = reinterpret_cast<int2*>(scratch + at + 4ll * E);
      x.part = reinterpret_cast<int2*>(scratch + at + 6ll * E);
      x.key = scratch + at + 6ll * E + 2ll * x.nblocks;
      x.off = x.key + E;
      x.nitems = x.off + nb[l];
      x.claim = x.nitems + 1;
    }
    cat += nb[l];
    at += round4(7ll * E + 2ll * x.nblocks + nb[l] + 2);
  }
  return at < (1ll << 31) ? at : -1;
}

// The binning of L's levels (bin_plan's, in scratch) on stream s: the
// counts zeroed, then bin_count, bin_sums, bin_scan, bin_scatter.
cudaError_t launch_binning(const BinLevels& L, int E, cudaStream_t s) {
  long long counts = 0;
  for (int l = 0; l < L.n; ++l)
    counts += static_cast<long long>(L.l[l].ncoarse) * L.l[l].G;
  cudaError_t err = cudaMemsetAsync(
      L.l[0].count, 0, sizeof(int) * static_cast<size_t>(counts), s);
  if (err != cudaSuccess) return err;
  const int blocks = std::min((E + 255) / 256, 4096);
  const int scan_blocks = L.l[0].nblocks + (L.n > 1 ? L.l[1].nblocks : 0);
  bin_count<<<blocks, 256, 0, s>>>(L, E);
  bin_sums<<<scan_blocks, kScanThreads, 0, s>>>(L);
  bin_scan<<<scan_blocks, kScanThreads, 0, s>>>(L);
  bin_scatter<<<blocks, 256, 0, s>>>(L, E);
  return cudaGetLastError();
}


// ---- K4 (planes_pair) as target tiles ----
//
// K2's planes with g rows g[e]: per edge its 12 x 24 window at (by1, bx1) of
// fmap1 and its 10 x 16 window at (by2, bx2) of fmap2, frame jj. The binning
// above at two levels, then probe_pair_tiles<1>, <2>: per item the producer
// warp copies the bin's tile (the in-map part of kRows map rows x the
// window's columns; lane r one row, one cp.async.bulk) and streams each
// edge's g rows into a ring of slots; the consumer warps take the edges'
// units of work (runs of kUnit tile pairs) in turn, load the edge's g rows
// once per unit, run its tiles on mma.sync with B read from the tile at the
// edge's own rows, and store each lane's two columns of a tile as one bf16
// pair (a tile pair fills the 32-byte sectors).
// Each map row of a tile is read from L2 once per item instead of once per
// edge: at micro_fused_v2's sizes ~0.9 GB per call instead of 4.93.
constexpr int kCap = 64;   // edges per work item at most (two per lane)

// The tile of each level: at most kRows map rows (a row bin of kRows - WY
// + 1 window bases; a map of at most kRows rows is one bin), kWarps
// consumer warps (+ 1 producer), the blocks asked for on each SM (at most
// what fits), and the tile pairs of an edge's unit of work (a warp loads
// the edge's g rows once per unit). Chosen by a sweep
// (dpvo_torch/scripts/ring_sweep.py).
template <int L>
struct PairTile;
template <>
struct PairTile<1> {  // planes_pair level 1
  static constexpr int kRows = 15, kWarps = 4, kBlocksPerSm = 2, kUnit = 9;
};
template <>
struct PairTile<2> {  // planes_pair level 2
  static constexpr int kRows = 30, kWarps = 8, kBlocksPerSm = 1, kUnit = 10;
};

template <int L>
struct PairLevel {
  using T = PairTile<L>;
  static constexpr int kWY = L == 1 ? 12 : 10, kWX = L == 1 ? 24 : 16;
  static constexpr int kN = kWY * kWX;        // positions per edge
  static constexpr int kPairs = kN / 16;      // tile pairs per edge
  static constexpr int kUnits = kPairs / T::kUnit;   // units per edge
  // the ring of g slots: at least 4, and a multiple of the warps over
  // gcd(warps, units), so that every use of a slot belongs to the same
  // warps (edges gi and gi + kGSlots have the same unit owners), each of
  // which waits for all of its phases in order
  static constexpr int kGSlots =
      std::max(4, T::kWarps / std::gcd(T::kWarps, kUnits));
  static constexpr int kSlotBytes = kGBytes + 16;   // g rows, (edge, by)
  static constexpr int kTileBytes = T::kRows * kWX * kRowBytes;
  // dynamic shared memory: the tile, the g slots, the item (int4), the
  // barriers full, empty, g_full[slots], g_empty[slots]
  static constexpr int kSmem =
      kTileBytes + kGSlots * kSlotBytes + 16 + 8 * (2 + 2 * kGSlots);
  static constexpr int kThreads = 32 * (T::kWarps + 1);
  static_assert(kWX % 8 == 0 && kN % 16 == 0, "whole tile pairs");
  static_assert(kPairs % T::kUnit == 0 && kUnits <= T::kWarps &&
                    kUnits <= 3,
                "whole units (at most 3), each edge's on distinct warps");
  static_assert(2 * T::kUnit % (kWX / 8) == 0, "units of whole window rows");
  static_assert(kGSlots * kUnits % T::kWarps == 0,
                "a slot's uses have the same owners");
  static_assert(T::kRows >= kWY && T::kRows <= 32,
                "a window fits the tile; one producer lane per tile row");
  static_assert((kSmem + 1024) * T::kBlocksPerSm <= 228 * 1024,
                "the blocks fit an SM (1 KB reserved per block)");
};

struct PairTileArgs {
  const bf16 *g, *fmap;
  bf16* out;
  const int4* items;
  const int* nitems;
  int* claim;
  const int2* rec;
  int F, H, W, TY, NYB, NXB, zero;   // zero: the bin that writes zeros
};

// Unit U of an edge at level L: its tile pairs [U * kUnit, (U + 1) *
// kUnit), whole window rows of tpr = WX / 8 tiles each, walked row by row
// with the row's tiles at compile-time columns, so that a tile costs its
// loads, its mma and two stores (the issue of index, mask and swap
// arithmetic, not the tensor cores, bounded a first version that computed
// each tile's row, columns and masks at run time and traded columns by
// shuffles; PERF.md section 6). tile: this lane's B row in the tile (row
// grp); srow0: the edge's first window row in the tile; rows: bit wy set
// where the edge's window row wy lies in the map; cols: bit c set where
// this lane's window column 2t + c does; orow / orow8: this lane's output
// words of g rows grp and 8.
template <int L, int U>
__device__ __forceinline__ void pair_unit(const GFrag& g, const uint4* tile,
                                          int srow0, uint32_t rows,
                                          uint32_t cols, bf16* orow,
                                          bf16* orow8) {
  using P = PairLevel<L>;
  constexpr int WX = P::kWX, tpr = WX / 8, R = P::T::kRows;
  constexpr int wy0 = 2 * U * P::T::kUnit / tpr;
  constexpr int wy1 = 2 * (U + 1) * P::T::kUnit / tpr;
  const bool g0 = (threadIdx.x & 31) < 4;   // grp 0: also g row 8
  const int sw = (threadIdx.x >> 2) & 1;
#pragma unroll 2
  for (int wy = wy0; wy < wy1; ++wy) {
    const uint4* rb = tile + min(max(srow0 + wy, 0), R - 1) * WX * kRowU4;
    const uint32_t rc = (rows >> wy) & 1 ? cols : 0u;
#pragma unroll
    for (int x = 0; x < tpr; ++x) {
      uint4 b[kChunks];
      float d[4];
      stage_b(rb + 8 * x * kRowU4, sw, b);
      tile_mma(g, b, d);
      const bool in0 = (rc >> (8 * x)) & 1, in1 = (rc >> (8 * x + 1)) & 1;
      const int q = (wy * tpr + x) * 8;
      *reinterpret_cast<uint32_t*>(orow + q) =
          planes_ring::pack_bf16(in0 ? d[0] : 0.f, in1 ? d[1] : 0.f);
      if (g0)
        *reinterpret_cast<uint32_t*>(orow8 + q) =
            planes_ring::pack_bf16(in0 ? d[2] : 0.f, in1 ? d[3] : 0.f);
    }
  }
}

// Level L's planes, (E, 9, WY * WX) bf16, item by item (the note above).
// The item's tile holds map rows y0 .. y0 + rows - 1 (its in-map rows) at
// smem rows 0 .. rows - 1, columns bx .. bx + WX - 1 at 0 .. WX - 1; stale
// bytes (rows or columns outside the map, a zero item's tile and g slot)
// reach only the columns the epilogue writes as zero.
template <int L>
__global__ void __launch_bounds__(PairLevel<L>::kThreads,
                                  PairTile<L>::kBlocksPerSm)
probe_pair_tiles(const PairTileArgs a) {
  using P = PairLevel<L>;
  constexpr int WY = P::kWY, WX = P::kWX, N = P::kN, R = P::T::kRows;
  constexpr int nw = P::T::kWarps, NG = P::kGSlots, tpr = WX / 8;
  extern __shared__ __align__(128) uint4 smem[];
  unsigned char* slots = reinterpret_cast<unsigned char*>(smem) +
                         P::kTileBytes;
  int4* s_item = reinterpret_cast<int4*>(slots + NG * P::kSlotBytes);
  const uint32_t tile0 = smem_u32(smem);
  const uint32_t slot0 = tile0 + P::kTileBytes;
  const uint32_t full = slot0 + NG * P::kSlotBytes + 16, empty = full + 8;
  const uint32_t gfull0 = empty + 8, gempty0 = gfull0 + 8 * NG;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(empty, nw);
    for (int s = 0; s < NG; ++s) {
      mbar_init(gfull0 + 8 * s, 1);
      mbar_init(gempty0 + 8 * s, P::kUnits);   // the edge's unit owners
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == nw) {  // the producer: lane r copies tile row r
    const int nitems = *a.nitems;
    int gi = 0;      // the block's g slot fills so far
    for (int n = 0;; ++n) {
      int it = 0;
      if (lane == 0) it = atomicAdd(a.claim, 1);
      it = __shfl_sync(0xffffffffu, it, 0);
      const bool live = it < nitems;
      const int4 item = live ? a.items[it] : make_int4(0, -1, a.zero, 0);
      // lane k holds the item's records k and k + 32
      const int2 r0 =
          lane < item.y ? a.rec[item.x + lane] : make_int2(0, 0);
      const int2 r1 =
          lane + 32 < item.y ? a.rec[item.x + lane + 32] : make_int2(0, 0);
      const bool tiled = live && item.z != a.zero;
      BinRect t{0, 0, 0, 0, 0, 0, 0};
      if (tiled)
        t = bin_rect(item.z, WY, WX, a.TY, a.NYB, a.NXB, a.H, a.W, 0,
                     a.TY - 1);
      const int j = t.j, bx = t.bx, y0 = t.y0, rows = t.rows, x0 = t.x0,
                nx = t.nx;
      mbar_wait(empty, (n & 1) ^ 1);
      if (lane == 0) {
        *s_item = make_int4(item.y, y0, bx, tiled);
        if (rows > 0)
          mbar_expect_tx(full, rows * nx * kRowBytes);
        else
          mbar_arrive(full);
      }
      __syncwarp();
      if (lane < rows)
        bulk_load(tile0 + (lane * WX + x0 - bx) * kRowBytes,
                  a.fmap + ((static_cast<size_t>(j) * a.H + y0 + lane) *
                                a.W + x0) * kC,
                  nx * kRowBytes, full);
      if (!live) break;
      for (int k = 0; k < item.y; ++k, ++gi) {
        const int2 rk = k < 32 ? r0 : r1;
        const int e = __shfl_sync(0xffffffffu, rk.x, k & 31);
        const int by = __shfl_sync(0xffffffffu, rk.y, k & 31);
        if (lane == 0) {
          const int sl = gi % NG;
          const uint32_t gfull = gfull0 + 8 * sl;
          mbar_wait(gempty0 + 8 * sl, ((gi / NG) & 1) ^ 1);
          *reinterpret_cast<int2*>(slots + sl * P::kSlotBytes + kGBytes) =
              make_int2(e, by);
          if (tiled) {
            mbar_expect_tx(gfull, kGBytes);
            bulk_load(slot0 + sl * P::kSlotBytes,
                      a.g + static_cast<size_t>(e) * kP2 * kC, kGBytes,
                      gfull);
          } else {
            mbar_arrive(gfull);
          }
        }
      }
    }
    return;
  }

  // the consumers: the block's units of work (an edge's runs of kUnit tile
  // pairs), numbered over its edges, dealt round-robin to the warps (warp w
  // takes unit u of the block's gi-th edge where gi * kUnits + u = w mod
  // nw); only a unit's warp waits for the edge's g slot and releases it
  const int grp = lane >> 2, t = lane & 3;
  int gi = 0, first = warp;   // this warp's unit of edge gi
  for (int n = 0;; ++n) {
    mbar_wait(full, n & 1);
    const int4 item = *s_item;   // (edges or -1, y0, bx, tiled)
    if (item.x < 0) break;
    // this lane's window columns 2t + c that lie in the map (bit c)
    const int clo = max(0, -item.z), chi = min(WX, a.W - item.z);
    const uint32_t cols = item.w && chi > clo
                              ? ((((1u << chi) - 1u) >> clo) << clo) >> (2 * t)
                              : 0u;
    for (int k = 0; k < item.x; ++k, ++gi) {
      if (first < P::kUnits) {
        const int sl = gi % NG;
        mbar_wait(gfull0 + 8 * sl, (gi / NG) & 1);
        const unsigned char* slot = slots + sl * P::kSlotBytes;
        const GFrag g = load_gfrag(reinterpret_cast<const uint4*>(slot));
        const int2 eb = *reinterpret_cast<const int2*>(slot + kGBytes);
        __syncwarp();
        if (lane == 0) mbar_arrive(gempty0 + 8 * sl);
        // the edge's window rows wy with eb.y + wy in the map (bit wy)
        const int rlo = max(0, -eb.y), rhi = min(WY, a.H - eb.y);
        const uint32_t rows =
            rhi > rlo ? (((1u << rhi) - 1u) >> rlo) << rlo : 0u;
        bf16* o = a.out + static_cast<size_t>(eb.x) * kP2 * N + 2 * t;
        const uint4* tile = smem + grp * kRowU4;
        const int srow0 = eb.y - item.y;
        if (first == 0)
          pair_unit<L, 0>(g, tile, srow0, rows, cols, o + grp * N,
                          o + 8 * N);
        if constexpr (P::kUnits > 1) {
          if (first == 1)
            pair_unit<L, 1>(g, tile, srow0, rows, cols, o + grp * N,
                            o + 8 * N);
        }
        if constexpr (P::kUnits > 2) {
          if (first == 2)
            pair_unit<L, 2>(g, tile, srow0, rows, cols, o + grp * N,
                            o + 8 * N);
        }
      }
      first = ((first - P::kUnits) % nw + nw) % nw;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
  }
}

// probe_pair_tiles<L> for ring_shape
template <int L>
struct PairTileKernel {
  static const void* fn() {
    return reinterpret_cast<const void*>(probe_pair_tiles<L>);
  }
  static constexpr int kThreads = PairLevel<L>::kThreads;
  static constexpr int kSmem = PairLevel<L>::kSmem;
  static constexpr int kBlocksPerSm = PairTile<L>::kBlocksPerSm;
};

// K4's two levels (bin_plan, in scratch or sizes only with nullptr).
long long pair_plan(int E, int F, int H1, int W1, int H2, int W2,
                    int* scratch, BinLevels* L) {
  L->n = 2;
  if (level_shape(&L->l[0], F, H1, W1, PairLevel<1>::kWY, PairLevel<1>::kWX,
                  PairTile<1>::kRows, kCap, false) < 0 ||
      level_shape(&L->l[1], F, H2, W2, PairLevel<2>::kWY, PairLevel<2>::kWX,
                  PairTile<2>::kRows, kCap, false) < 0)
    return -1;
  return bin_plan(E, L, scratch);
}

template <int L>
cudaError_t pair_tiles_shape(int E, int device, RingShape* sh) {
  const cudaError_t err = ring_shape<PairTileKernel<L>>(E, device, sh);
  if (err != cudaSuccess) cudaGetLastError();  // see dots_setup
  return err;
}

template <int L>
cudaError_t launch_pair_tiles(const BinLevel& b, const bf16* g,
                              const bf16* fmap, bf16* out, int E, int F,
                              int H, int W, int device, cudaStream_t s) {
  RingShape sh;
  const cudaError_t err = pair_tiles_shape<L>(E, device, &sh);
  if (err != cudaSuccess) return err;
  const PairTileArgs a{g,     fmap, out,  b.items, b.nitems, b.claim,
                       b.rec, F,    H,    W,       b.TY,     b.NYB,
                       b.NXB, b.ncoarse - 1};
  probe_pair_tiles<L><<<sh.grid, sh.threads, sh.smem, s>>>(a);
  return cudaGetLastError();
}

// ---- K6 fused_kernel (slab) as target tiles over by-sorted edges ----
//
// One resident map (H, W, 128), a 16 x 16 window per edge at (by[e], bx[e]);
// out[e, p, q] = g[e, p] . map[by + q / 16, bx + q % 16], (E, 9, 256) bf16,
// zero outside the map. The binning above at one level of exact-by fine
// bins, so that an item's edges share bx and are sorted by by; then
// probe_slab_tiles, a persistent grid that claims the items:
//   * the producer warp copies the item's in-map tile rows (the map rows of
//     its edges' windows, at most kRows; lane r one 4 KB row, one
//     cp.async.bulk) and its edges' g rows one after another (a flattened
//     stage of 9 rows of 256 B per edge), and writes the (edge, by) of each
//     edge and, per group of kUnitRows tile rows y (one lane each), the run
//     lo .. hi - 1 of edges whose windows hold one of them (by <= y <= by
//     + 15: one run, as by is sorted) and the units of work it makes. Before
//     it waits for the consumers to free the stage it has claimed the next
//     item and asked L2 to prefetch its g rows;
//   * a group's products are one GEMM: A the run's flattened g rows lo * 9
//     .. hi * 9 - 1 in m16 tiles (a tile may span two edges), B the rows'
//     16 positions each (two n8 tiles a row), C row (e, p) of tile row y
//     exactly out[e, p, (y - by_e) * 16 ..] (32 contiguous bytes, one
//     sector written by 4 lanes), kept where 0 <= y - by_e <= 15. A unit is
//     a near-equal share (at most kUnit m-tiles) of a group's m-tiles; the
//     consumer warps claim units with a shared counter, load the group's B
//     once per unit and run its m-tiles kPass at a time, 2 x kUnitRows x
//     kPass independent mma chains in flight, then drop C rows past the
//     unit;
//   * tile rows outside the map are written as zeros, and columns outside
//     it (the same for every edge of an item, as bx is) are zero in the
//     tile, so that their products are. Edges whose windows miss the map
//     (the zero bin) write zeros.
// Each edge's output row is written once: its 16 window rows lie in the
// item's tile rows, and each group's run holds the edge once. The edges of
// a coarse bin past kCap split into further items; with random bases an
// item degenerates to one edge, and stays exact.
constexpr int kSlab = 16;                 // the 16 x 16 windows
constexpr int kSlabN = kSlab * kSlab;     // positions per edge

// The tile: at most kRows map rows (a row bin of kRows - 15 window bases),
// at most kCap edges per item (their g rows staged beside the tile),
// kWarps consumer warps (+ 1 producer), the blocks asked for on each SM (at
// most what fits), the tile rows of a unit (sharing its A loads), the m16
// tiles of a unit at most and of one pass (its independent chains: 2 n8
// tiles of each row). Chosen by a sweep (dpvo_torch/scripts/ring_sweep.py,
// PERF.md section 6): small tiles, so that two blocks fit an SM and one
// block's copies overlap the other's products (an item's stage is freed
// only when all its units are done), beat larger items with one block.
struct SlabTile {  // slab
  static constexpr int kRows = 18, kCap = 16, kWarps = 5, kBlocksPerSm = 2,
                       kUnitRows = 2, kUnit = 12, kPass = 2;
};

struct SlabGeom {
  using T = SlabTile;
  static constexpr int kTileBytes = T::kRows * kSlab * kRowBytes;
  static constexpr int kStageRows = T::kCap * kP2;   // flattened g rows
  // dynamic shared memory: the tile, the g stage, (edge, by) per edge
  // (int2), per row group (lo, hi, first unit, end unit) (int4), the item
  // (2 x int4), the units' claim counter (padded to 16 bytes), the
  // barriers full, empty
  static constexpr int kSmem = kTileBytes + kStageRows * kRowBytes +
                               8 * T::kCap + 16 * T::kRows + 32 + 16 + 16;
  static constexpr int kThreads = 32 * (T::kWarps + 1);
  static_assert(T::kRows > kSlab && T::kRows <= 32,
                "a window fits the tile; one producer lane per tile row");
  static_assert(T::kCap >= 2 && T::kCap <= 64 && T::kCap % 2 == 0,
                "two records a lane; the row table 16-byte aligned");
  static_assert(T::kUnitRows >= 1 && T::kUnitRows <= 2 &&
                    T::kUnit >= T::kPass && T::kPass >= 1 && T::kPass <= 4,
                "units of 1-2 rows and of passes of 1-4 m-tiles");
  static_assert((kSmem + 1024) * T::kBlocksPerSm <= 228 * 1024,
                "the blocks fit an SM (1 KB reserved per block)");
};

struct SlabArgs {
  const bf16 *g, *fmap;
  bf16* out;
  int4* items;   // each item's tile positions written back (.w)
  const int* nitems;
  int* claim;
  const int2* rec;
  int H, W, TY, NYB, NXB, zero;   // zero: the bin that writes zeros
};

// Chunks 2h and 2h + 1 (16-byte words) of this lane's channel row `row`,
// read in stage_b's order (odd lane groups xor-swapped, so that the groups
// of neighbouring rows read different banks) and swapped back.
__device__ __forceinline__ void load_chunks(const uint4* row, int h, int sw,
                                            uint4& c0, uint4& c1) {
  const int t = threadIdx.x & 3;
  const uint4 r0 = row[4 * ((2 * h) ^ sw) + t];
  const uint4 r1 = row[4 * ((2 * h + 1) ^ sw) + t];
  c0 = sw ? r1 : r0;
  c1 = sw ? r0 : r1;
}

// One pass: M m-tiles of flattened g rows f .. f + 16 M - 1 (stage rows
// past the stage clamped: their C rows are dropped) times B of the unit's
// tile rows (b[r][n]: n8 tile n of row y0 + r, positions 8n + grp), then
// this lane's C rows below f_stop stored where their edge's window holds
// the row: the products for a row in the map (in[r]; its columns outside
// the map are zero in the tile), else zeros.
template <int M>
__device__ __forceinline__ void slab_pass(
    const uint4* stage, const uint4 (&b)[SlabTile::kUnitRows][2][kChunks],
    int f, int f_stop, int y0, const bool (&in)[SlabTile::kUnitRows],
    const int2* s_rec, bf16* out) {
  constexpr int K = SlabTile::kUnitRows;
  constexpr int kLast = SlabGeom::kStageRows - 1;
  const int lane = threadIdx.x & 31, grp = lane >> 2, t = lane & 3;
  const int sw = grp & 1;
  float d[M][K][2][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int r = 0; r < K; ++r)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        d[m][r][n][0] = d[m][r][n][1] = d[m][r][n][2] = d[m][r][n][3] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint4 a[M][2][2];   // [m-tile][row grp, grp + 8][chunk 2h, 2h + 1]
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        load_chunks(stage + min(f + 16 * m + 8 * i + grp, kLast) * kRowU4,
                    h, sw, a[m][i][0], a[m][i][1]);
    // k-step by k-step, so that the 2 K M chains' mma interleave
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int r = 0; r < K; ++r)
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma_bf16(d[m][r][n], a[m][0][c].x, a[m][1][c].x, a[m][0][c].y,
                     a[m][1][c].y, b[r][n][2 * h + c].x, b[r][n][2 * h + c].y);
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int r = 0; r < K; ++r)
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma_bf16(d[m][r][n], a[m][0][c].z, a[m][1][c].z, a[m][0][c].w,
                     a[m][1][c].w, b[r][n][2 * h + c].z, b[r][n][2 * h + c].w);
    }
  }
  // the stores: a C row's 16 columns are held 2 + 2 per lane of a quad
  // (columns 2t, 2t + 1 of each n8 tile); two xor shuffles give lane t the
  // columns 4t .. 4t + 3, so that the quad writes the row's 32 bytes as one
  // sector with one 8-byte store each
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int fr = f + 16 * m + 8 * i + grp;
      const int k = fr / kP2, p = fr - kP2 * k;
      const int2 eb = s_rec[min(k, SlabTile::kCap - 1)];
      bf16* o = out + (static_cast<size_t>(eb.x) * kP2 + p) * kSlabN + 4 * t;
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const uint32_t av =
            in[r] ? planes_ring::pack_bf16(d[m][r][0][2 * i],
                                           d[m][r][0][2 * i + 1])
                  : 0u;
        const uint32_t bv =
            in[r] ? planes_ring::pack_bf16(d[m][r][1][2 * i],
                                           d[m][r][1][2 * i + 1])
                  : 0u;
        // lanes 0, 1 keep tile 0's columns, 2, 3 tile 1's: (lo, hi) =
        // the columns 2t', 2t' + 1 of lanes t' = t & 1 and (t & 1) + 2
        const uint32_t keep = t < 2 ? av : bv;
        const uint32_t got =
            __shfl_xor_sync(0xffffffffu, t < 2 ? bv : av, 2);
        const uint32_t lo = t < 2 ? keep : got, hi = t < 2 ? got : keep;
        const uint32_t x = __shfl_xor_sync(0xffffffffu, t & 1 ? lo : hi, 1);
        const int q = y0 + r - eb.y;   // the edge's window row
        if (fr < f_stop && q >= 0 && q < kSlab)
          *reinterpret_cast<uint2*>(o + q * kSlab) =
              t & 1 ? make_uint2(x, hi) : make_uint2(lo, x);
      }
    }
}

// the pass of the unit's last m < kPass m-tiles
template <int M>
__device__ __forceinline__ void slab_tail(
    int m, const uint4* stage,
    const uint4 (&b)[SlabTile::kUnitRows][2][kChunks], int f, int f_stop,
    int y0, const bool (&in)[SlabTile::kUnitRows], const int2* s_rec,
    bf16* out) {
  if constexpr (M >= 1) {
    if (m == M)
      slab_pass<M>(stage, b, f, f_stop, y0, in, s_rec, out);
    else
      slab_tail<M - 1>(m, stage, b, f, f_stop, y0, in, s_rec, out);
  }
}

// The slab's planes, item by item (the note above). The item's tile holds
// map rows y0 .. y0 + rows - 1 (its in-map rows) at smem rows 0 .. rows -
// 1, columns bx .. bx + 15 at 0 .. 15, those outside the map zeroed by the
// producer; stale bytes (stage rows past the item's edges) reach only C
// rows that are dropped.
__global__ void __launch_bounds__(SlabGeom::kThreads,
                                  SlabTile::kBlocksPerSm)
probe_slab_tiles(const SlabArgs a) {
  using T = SlabTile;
  constexpr int nw = T::kWarps, R = T::kRows, K = T::kUnitRows;
  extern __shared__ __align__(128) uint4 smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const uint4* stage =
      reinterpret_cast<const uint4*>(base + SlabGeom::kTileBytes);
  int2* s_rec = reinterpret_cast<int2*>(
      base + SlabGeom::kTileBytes + SlabGeom::kStageRows * kRowBytes);
  int4* s_rows = reinterpret_cast<int4*>(s_rec + T::kCap);
  int4* s_item = s_rows + R;
  int* s_next = reinterpret_cast<int*>(s_item + 2);   // units claimed
  const uint32_t tile0 = smem_u32(smem);
  const uint32_t stage0 = tile0 + SlabGeom::kTileBytes;
  const uint32_t full = smem_u32(s_item + 3), empty = full + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(empty, nw);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == nw) {  // the producer
    const int nitems = *a.nitems;
    for (int n = 0;; ++n) {
      int it = 0;
      if (lane == 0) it = atomicAdd(a.claim, 1);
      it = __shfl_sync(0xffffffffu, it, 0);
      const bool live = it < nitems;
      const int4 item = live ? a.items[it] : make_int4(0, -1, a.zero, 0);
      const int ne = max(item.y, 0);
      // lane k holds the item's records k and k + 32
      const int2 r0 = lane < ne ? a.rec[item.x + lane] : make_int2(0, 0);
      const int2 r1 = T::kCap > 32 && lane + 32 < ne
                          ? a.rec[item.x + lane + 32]
                          : make_int2(0, 0);
      const bool tiled = live && item.z != a.zero;
      if (tiled) {   // its g rows towards L2 while the stage is in use
        if (lane < ne)
          bulk_prefetch_l2(a.g + static_cast<size_t>(r0.x) * kP2 * kC,
                           kGBytes);
        if (T::kCap > 32 && lane + 32 < ne)
          bulk_prefetch_l2(a.g + static_cast<size_t>(r1.x) * kP2 * kC,
                           kGBytes);
      }
      // the window rows by_first .. by_last + 15 of the item; lane j the
      // row group y = by_first + K j .. + K - 1, its edges lo .. hi - 1
      const int last = max(ne - 1, 0);
      const int by_first = __shfl_sync(0xffffffffu, r0.y, 0);
      const int by_last =
          __shfl_sync(0xffffffffu, last < 32 ? r0.y : r1.y, last & 31);
      BinRect t{0, 0, 0, 0, 0, 0, 0};
      if (tiled) {
        const int ty0 = bin_ty0(item.z, kSlab, a.TY, a.NYB, a.NXB);
        t = bin_rect(item.z, kSlab, kSlab, a.TY, a.NYB, a.NXB, a.H, a.W,
                     by_first - ty0, by_last - ty0);
      }
      const int y = by_first + K * lane;
      int lo = 0, hi = 0;
      for (int k = 0; k < ne; ++k) {
        const int byk =
            __shfl_sync(0xffffffffu, k < 32 ? r0.y : r1.y, k & 31);
        lo += byk < y - (kSlab - 1);
        hi += byk <= y + K - 1;
      }
      const bool group = tiled && y <= by_last + kSlab - 1;
      const int mt = (9 * (hi - lo) + 15) / 16;
      const int units = group ? (mt + T::kUnit - 1) / T::kUnit : 0;
      int uend = units;
#pragma unroll
      for (int dd = 1; dd < 32; dd <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, uend, dd);
        if (lane >= dd) uend += v;
      }
      const int total = __shfl_sync(0xffffffffu, uend, 31);
      if (lane == 0 && live)   // the positions its tile copies
        a.items[it].w = t.rows * t.nx;
      mbar_wait(empty, (n & 1) ^ 1);
      if (lane < ne) s_rec[lane] = r0;
      if (T::kCap > 32 && lane + 32 < ne) s_rec[lane + 32] = r1;
      if (lane < R) s_rows[lane] = make_int4(lo, hi, uend - units, uend);
      if (tiled && t.nx < kSlab) {   // the tile's columns outside the map
        const int c0 = t.x0 - t.bx, nz = (kSlab - t.nx) * kRowU4;
        for (int w = lane; w < t.rows * nz; w += 32) {
          const int row = w / nz, c = (w - row * nz) / kRowU4;
          smem[(row * kSlab + (c < c0 ? c : c + t.nx)) * kRowU4 +
               w % kRowU4] = make_uint4(0, 0, 0, 0);
        }
      }
      if (lane == 0) {
        s_item[0] = make_int4(item.y, by_first, t.bx, tiled);
        s_item[1] = make_int4(t.y0, t.rows, total, 0);
        *s_next = 0;
      }
      __threadfence_block();
      __syncwarp();
      const uint32_t bytes =
          tiled ? (t.rows * t.nx + ne * kP2) * kRowBytes : 0u;
      if (lane == 0) {
        if (bytes)
          mbar_expect_tx(full, bytes);
        else
          mbar_arrive(full);
      }
      __syncwarp();
      if (tiled) {
        if (lane < t.rows)
          bulk_load(tile0 + (lane * kSlab + t.x0 - t.bx) * kRowBytes,
                    a.fmap + (static_cast<size_t>(t.y0 + lane) * a.W + t.x0) *
                                 kC,
                    t.nx * kRowBytes, full);
        if (lane < ne)
          bulk_load(stage0 + lane * kGBytes,
                    a.g + static_cast<size_t>(r0.x) * kP2 * kC, kGBytes,
                    full);
        if (T::kCap > 32 && lane + 32 < ne)
          bulk_load(stage0 + (lane + 32) * kGBytes,
                    a.g + static_cast<size_t>(r1.x) * kP2 * kC, kGBytes,
                    full);
      }
      if (!live) break;
    }
    return;
  }

  // the consumers: each warp claims the item's units until none is left
  const int grp = lane >> 2, sw = grp & 1;
  for (int n = 0;; ++n) {
    mbar_wait(full, n & 1);
    const int4 h0 = s_item[0];   // (edges or -1, by_first, bx, tiled)
    const int4 h1 = s_item[1];   // (y0, in-map rows, units, 0)
    if (h0.x < 0) break;
    if (!h0.w) {   // the zero bin: every entry of its edges zero
      constexpr int kWords = kP2 * kSlabN / 8;   // 16-byte words per edge
      for (int i = threadIdx.x; i < h0.x * kWords; i += 32 * nw)
        reinterpret_cast<uint4*>(a.out)[static_cast<size_t>(
                                            s_rec[i / kWords].x) *
                                            kWords +
                                        i % kWords] = make_uint4(0, 0, 0, 0);
    } else {
      const int uend = s_rows[lane < R ? lane : R - 1].w;
      for (;;) {
        int u = 0;
        if (lane == 0) u = atomicAdd(s_next, 1);
        u = __shfl_sync(0xffffffffu, u, 0);
        if (u >= h1.z) break;
        const int j = __popc(__ballot_sync(0xffffffffu, lane < R && uend <= u));
        const int4 rw = s_rows[j];   // (lo, hi, first unit, end unit)
        // the unit's near-equal share of the group's m-tiles
        const int mt = (9 * (rw.y - rw.x) + 15) / 16, nu = rw.w - rw.z;
        const int k = u - rw.z;
        int f = rw.x * kP2 + 16 * (k * mt / nu);
        const int f_stop =
            min(rw.x * kP2 + 16 * ((k + 1) * mt / nu), rw.y * kP2);
        const int y0 = h0.y + K * j;
        uint4 b[K][2][kChunks];
        bool in[K];
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const int s = y0 + r - h1.x;   // the row in the tile
          in[r] = s >= 0 && s < h1.y;
          const uint4* rb = smem + ((in[r] ? s : 0) * kSlab + grp) * kRowU4;
          stage_b(rb, sw, b[r][0]);
          stage_b(rb + 8 * kRowU4, sw, b[r][1]);
        }
        for (; f_stop - f > 16 * (T::kPass - 1); f += 16 * T::kPass)
          slab_pass<T::kPass>(stage, b, f, f_stop, y0, in, s_rec, a.out);
        if (f < f_stop)
          slab_tail<T::kPass - 1>((f_stop - f + 15) / 16, stage, b, f,
                                  f_stop, y0, in, s_rec, a.out);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
  }
}

// probe_slab_tiles for ring_shape
struct SlabTileKernel {
  static const void* fn() {
    return reinterpret_cast<const void*>(probe_slab_tiles);
  }
  static constexpr int kThreads = SlabGeom::kThreads;
  static constexpr int kSmem = SlabGeom::kSmem;
  static constexpr int kBlocksPerSm = SlabTile::kBlocksPerSm;
};

// The slab's one level (bin_plan, in scratch or sizes only with nullptr).
long long slab_plan(int E, int H, int W, int* scratch, BinLevels* L) {
  L->n = 1;
  if (level_shape(&L->l[0], 1, H, W, kSlab, kSlab, SlabTile::kRows,
                  SlabTile::kCap, true) < 0)
    return -1;
  return bin_plan(E, L, scratch);
}

cudaError_t slab_tiles_shape(int E, int device, RingShape* sh) {
  const cudaError_t err = ring_shape<SlabTileKernel>(E, device, sh);
  if (err != cudaSuccess) cudaGetLastError();  // see dots_setup
  return err;
}

PlaneArgs plane_args(const void* g, const void* fmap1, const void* fmap2,
                     const void* jj, const void* by1, const void* bx1,
                     const void* by2, const void* bx2, void* out1, void* out2,
                     int E, int F, int H1, int W1, int H2, int W2) {
  PlaneArgs p{};
  p.g = static_cast<const bf16*>(g);
  p.fmap1 = static_cast<const bf16*>(fmap1);
  p.fmap2 = static_cast<const bf16*>(fmap2);
  p.jj = static_cast<const int*>(jj);
  p.by1 = static_cast<const int*>(by1);
  p.bx1 = static_cast<const int*>(bx1);
  p.by2 = static_cast<const int*>(by2);
  p.bx2 = static_cast<const int*>(bx2);
  p.out1 = out1;
  p.out2 = out2;
  p.E = E;
  p.F = F;
  p.H1 = H1;
  p.W1 = W1;
  p.H2 = H2;
  p.W2 = W2;
  return p;
}

int set_device(int device) { return static_cast<int>(cudaSetDevice(device)); }

// probe_dots' rows per edge for (variant, W), 0 for a pair it refuses
int dots_rows(int variant, int W) {
  if (variant == 0 && W == 384) return 384;
  if (variant == 1 && W >= 256) return 256;
  return 0;
}

// probe_dots<N, kBf16Out> for ring_shape: the kernel, its threads, its
// dynamic shared memory and the blocks per SM its ring asks for
template <int N, bool kBf16Out>
struct DotsKernel {
  static const void* fn() {
    return reinterpret_cast<const void*>(probe_dots<N, kBf16Out>);
  }
  static constexpr int kThreads = 32 * (DotsRing<N>::kWarps + 1);
  static constexpr int kSmem = dots_smem<N>();
  static constexpr int kBlocksPerSm = DotsRing<N>::kBlocksPerSm;
};

// Validates (variant, W), selects the device and fills the shape of the
// instantiation they select; returns its N (0 on an error, in *err).
int dots_setup(int variant, int W, int E, int device, RingShape* sh,
               cudaError_t* err) {
  const int N = dots_rows(variant, W);
  if (N == 0) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  *err = cudaSetDevice(device);
  if (*err == cudaSuccess)
    *err = N == 384 ? ring_shape<DotsKernel<384, false>>(E, device, sh)
                    : ring_shape<DotsKernel<256, true>>(E, device, sh);
  if (*err == cudaSuccess) return N;
  cudaGetLastError();  // a refused attribute must not fail a later launch
  return 0;
}

// the ring of N as (stages, rows per stage, consumer warps)
template <int N>
void ring_fields(int* f) {
  f[0] = DotsRing<N>::kStages;
  f[1] = DotsRing<N>::kRows;
  f[2] = DotsRing<N>::kWarps;
}

// probe_planes_ring<P>'s launch shape for E edges on `device` (the current
// device), and its ring as (stages, positions per stage, consumer warps)
template <int P>
cudaError_t probe_ring_shape(int E, int device, RingShape* sh, int* ring) {
  ring[0] = ProbeRing<P>::kStages;
  ring[1] = ProbeRing<P>::kRows;
  ring[2] = ProbeRing<P>::kWarps;
  const cudaError_t err = ring_shape<ProbeRingKernel<P>>(E, device, sh);
  if (err != cudaSuccess) cudaGetLastError();  // see dots_setup
  return err;
}

cudaError_t ring_probe_shape(int which, int E, int device, RingShape* sh,
                             int* ring) {
  switch (which) {
    case kRollK5:
      return probe_ring_shape<kRollK5>(E, device, sh, ring);
    case kW12x16:
      return probe_ring_shape<kW12x16>(E, device, sh, ring);
    case kFixedW:
      return probe_ring_shape<kFixedW>(E, device, sh, ring);
    case kFirst49:
      return probe_ring_shape<kFirst49>(E, device, sh, ring);
    case kFirst49S:
      return probe_ring_shape<kFirst49S>(E, device, sh, ring);
    default:
      return cudaErrorInvalidValue;
  }
}

// probe_planes_ring<P> on the persistent grid
template <int P>
cudaError_t launch_ring(const PlaneArgs& p, int device, cudaStream_t s) {
  RingShape sh;
  int ring[3];
  const cudaError_t err = probe_ring_shape<P>(p.E, device, &sh, ring);
  if (err != cudaSuccess) return err;
  probe_planes_ring<P><<<sh.grid, sh.threads, sh.smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Each entry enqueues its kernel on `stream` of CUDA device `device` and
// returns cudaGetLastError() (0 on a successful launch; this library carries
// its own CUDA runtime, so it selects the tensors' device first). E <= 0
// launches nothing.

// K4. plane1 (E, 9, 288), plane2 (E, 9, 160) bf16: the chain of the
// target-tile design (bin_count, bin_sums, bin_scan, bin_scatter at both
// levels, probe_pair_tiles<1>, <2>) on `stream`, no synchronize. scratch:
// int32 of at least probe_planes_pair_scratch(E, F, H1, W1, H2, W2) words,
// any contents (the launch zeroes what it must).
extern "C" int probe_planes_pair_launch(
    const void* g, const void* fmap1, const void* fmap2, const void* jj,
    const void* by1, const void* bx1, const void* by2, const void* bx2,
    void* plane1, void* plane2, void* scratch, int E, int F, int H1, int W1,
    int H2, int W2, int device, void* stream) {
  if (E <= 0) return 0;
  if (const int err = set_device(device)) return err;
  BinLevels L;
  if (pair_plan(E, F, H1, W1, H2, W2, static_cast<int*>(scratch), &L) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* bases[2][2] = {{by1, bx1}, {by2, bx2}};
  for (int l = 0; l < 2; ++l) {
    L.l[l].jj = static_cast<const int*>(jj);
    L.l[l].by = static_cast<const int*>(bases[l][0]);
    L.l[l].bx = static_cast<const int*>(bases[l][1]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_binning(L, E, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* gp = static_cast<const bf16*>(g);
  err = launch_pair_tiles<1>(L.l[0], gp, static_cast<const bf16*>(fmap1),
                             static_cast<bf16*>(plane1), E, F, H1, W1, device,
                             s);
  if (err == cudaSuccess)
    err = launch_pair_tiles<2>(L.l[1], gp, static_cast<const bf16*>(fmap2),
                               static_cast<bf16*>(plane2), E, F, H2, W2,
                               device, s);
  return static_cast<int>(err);
}

// The int32 scratch words probe_planes_pair_launch needs (-1: the maps'
// bins pass int32).
extern "C" int probe_planes_pair_scratch(int E, int F, int H1, int W1,
                                         int H2, int W2) {
  BinLevels L;
  return static_cast<int>(pair_plan(std::max(E, 0), F, H1, W1, H2, W2,
                                    nullptr, &L));
}

// Where a launch left each level's work items in its scratch, in int32
// words from its start: info[2 * l] the items (int4: first sorted
// position, edges, bin, the positions of its tile in the map), info[2 * l
// + 1] their number, for level l + 1. Returns -1 where the scratch entry
// does.
extern "C" int probe_planes_pair_items(int E, int F, int H1, int W1, int H2,
                                       int W2, int* info) {
  BinLevels L;
  if (pair_plan(std::max(E, 0), F, H1, W1, H2, W2, nullptr, &L) < 0)
    return -1;
  for (int l = 0; l < 2; ++l) {
    info[2 * l] = static_cast<int>(L.l[l].items_at);
    info[2 * l + 1] = static_cast<int>(L.l[l].nitems_at);
  }
  return 0;
}

// The launch shape of K4's tile kernel of `level` (1 or 2) for E edges on
// `device`: info[0 .. 4] = grid, threads, dynamic shared memory bytes,
// registers per thread, blocks per SM; info[5 .. 8] = the tile's map rows,
// consumer warps, edges per item at most and tile pairs per unit. Any
// other level returns an error.
extern "C" int probe_planes_pair_shape(int level, int E, int device,
                                       int* info) {
  if (const int err = set_device(device)) return err;
  RingShape sh;
  cudaError_t err;
  if (level == 1) {
    err = pair_tiles_shape<1>(E, device, &sh);
    info[5] = PairTile<1>::kRows;
    info[6] = PairTile<1>::kWarps;
    info[8] = PairTile<1>::kUnit;
  } else if (level == 2) {
    err = pair_tiles_shape<2>(E, device, &sh);
    info[5] = PairTile<2>::kRows;
    info[6] = PairTile<2>::kWarps;
    info[8] = PairTile<2>::kUnit;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[5] = {sh.grid, sh.threads, sh.smem, sh.regs,
                       sh.blocks_per_sm};
  for (int k = 0; k < 5; ++k) info[k] = vals[k];
  info[7] = kCap;
  return 0;
}

// K5. out1 (E, 9, 288), out2 (E, 9, 160) bf16, rolled by sh1 / sh2.
extern "C" int probe_planes_roll_launch(
    const void* g, const void* fmap1, const void* fmap2, const void* jj,
    const void* by1, const void* bx1, const void* by2, const void* bx2,
    const void* sh1, const void* sh2, void* out1, void* out2, int E, int F,
    int H1, int W1, int H2, int W2, int device, void* stream) {
  if (E <= 0) return 0;
  if (const int err = set_device(device)) return err;
  PlaneArgs p = plane_args(g, fmap1, fmap2, jj, by1, bx1, by2, bx2, out1,
                           out2, E, F, H1, W1, H2, W2);
  p.sh1 = static_cast<const int*>(sh1);
  p.sh2 = static_cast<const int*>(sh2);
  return static_cast<int>(
      launch_ring<kRollK5>(p, device, static_cast<cudaStream_t>(stream)));
}

// K7. out1, out2 (E * 9, 49) f32. streams = 1 also reads s1, s2 (E * 9)
// int32, fr1, fr2 (E * 9, 2) f32, S1 (nS1) and S2 (nS2) f32, and writes
// sink (E) uint32; streams = 0 ignores those pointers.
extern "C" int probe_planes_first49_launch(
    const void* g, const void* fmap1, const void* fmap2, const void* jj,
    const void* by1, const void* bx1, const void* by2, const void* bx2,
    const void* s1, const void* fr1, const void* s2, const void* fr2,
    const void* S1, const void* S2, int nS1, int nS2, void* sink, void* out1,
    void* out2, int E, int F, int H1, int W1, int H2, int W2, int streams,
    int device, void* stream) {
  if (E <= 0) return 0;
  if (const int err = set_device(device)) return err;
  PlaneArgs p = plane_args(g, fmap1, fmap2, jj, by1, bx1, by2, bx2, out1,
                           out2, E, F, H1, W1, H2, W2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (streams) {
    p.s1 = static_cast<const int*>(s1);
    p.s2 = static_cast<const int*>(s2);
    p.fr1 = static_cast<const float*>(fr1);
    p.fr2 = static_cast<const float*>(fr2);
    p.S1 = static_cast<const float*>(S1);
    p.S2 = static_cast<const float*>(S2);
    p.nS1 = nS1;
    p.nS2 = nS2;
    p.sink = static_cast<unsigned*>(sink);
    return static_cast<int>(launch_ring<kFirst49S>(p, device, s));
  }
  return static_cast<int>(launch_ring<kFirst49>(p, device, s));
}

// K8. out1, out2 (E, 9, 192) bf16 from 12 x 16 windows at both levels;
// fixed = 1 puts every window at (0, 0) of its frame (by*, bx* unread).
extern "C" int probe_planes_w12x16_launch(
    const void* g, const void* fmap1, const void* fmap2, const void* jj,
    const void* by1, const void* bx1, const void* by2, const void* bx2,
    void* out1, void* out2, int E, int F, int H1, int W1, int H2, int W2,
    int fixed, int device, void* stream) {
  if (E <= 0) return 0;
  if (const int err = set_device(device)) return err;
  const PlaneArgs p = plane_args(g, fmap1, fmap2, jj, by1, bx1, by2, bx2,
                                 out1, out2, E, F, H1, W1, H2, W2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(fixed ? launch_ring<kFixedW>(p, device, s)
                                : launch_ring<kW12x16>(p, device, s));
}

// The launch shape probe_planes_roll_launch (which = 0),
// probe_planes_w12x16_launch (1: fixed = 0, 2: fixed = 1) or
// probe_planes_first49_launch (3: streams = 0, 4: streams = 1) takes for E
// edges on `device`: info[0 .. 4] = grid, threads, dynamic shared memory bytes,
// registers per thread, blocks per SM; info[5 .. 7] = the ring's stages,
// window positions per stage and consumer warps. Any other `which` returns
// an error.
extern "C" int probe_planes_ring_shape(int which, int E, int device,
                                       int* info) {
  if (const int err = set_device(device)) return err;
  RingShape sh;
  const cudaError_t err = ring_probe_shape(which, E, device, &sh, info + 5);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[5] = {sh.grid, sh.threads, sh.smem, sh.regs,
                       sh.blocks_per_sm};
  for (int k = 0; k < 5; ++k) info[k] = vals[k];
  return 0;
}

// K6 dots. variant 0: out (E, 9, 384) f32 from all 384 rows of each window
// (W must be 384); variant 1: out (E, 9, 256) bf16 from the first 256 rows
// (W >= 256). Any other variant or W returns an error.
extern "C" int probe_dots_launch(const void* g, const void* win, void* out,
                                 int E, int W, int variant, int device,
                                 void* stream) {
  if (E <= 0) return 0;
  RingShape sh;
  cudaError_t err;
  const int N = dots_setup(variant, W, E, device, &sh, &err);
  if (N == 0) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* gp = static_cast<const bf16*>(g);
  const bf16* wp = static_cast<const bf16*>(win);
  if (N == 384)
    probe_dots<384, false><<<sh.grid, sh.threads, sh.smem, s>>>(gp, wp, out,
                                                                E, W);
  else
    probe_dots<256, true><<<sh.grid, sh.threads, sh.smem, s>>>(gp, wp, out,
                                                               E, W);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape probe_dots_launch takes for (variant, W, E) on `device`:
// info[0 .. 4] = grid, threads, dynamic shared memory bytes, registers per
// thread, blocks per SM; info[5 .. 7] = the ring's stages, rows per stage
// and consumer warps.
extern "C" int probe_dots_shape(int variant, int W, int E, int device,
                                int* info) {
  RingShape sh;
  cudaError_t err;
  const int N = dots_setup(variant, W, E, device, &sh, &err);
  if (N == 0) return static_cast<int>(err);
  const int vals[5] = {sh.grid, sh.threads, sh.smem, sh.regs,
                       sh.blocks_per_sm};
  for (int k = 0; k < 5; ++k) info[k] = vals[k];
  if (N == 384)
    ring_fields<384>(info + 5);
  else
    ring_fields<256>(info + 5);
  return 0;
}

// K6 slab. out (E, 9, 256) bf16: the chain of the target-tile design
// (bin_count, bin_sums, bin_scan, bin_scatter at one level of exact-by fine
// bins, probe_slab_tiles) on `stream`, no synchronize. scratch: int32 of at
// least probe_slab_scratch(E, H, W) words, any contents (the launch zeroes
// what it must).
extern "C" int probe_slab_launch(const void* g, const void* fmap,
                                 const void* by, const void* bx, void* out,
                                 void* scratch, int E, int H, int W,
                                 int device, void* stream) {
  if (E <= 0) return 0;
  if (const int err = set_device(device)) return err;
  BinLevels L;
  if (slab_plan(E, H, W, static_cast<int*>(scratch), &L) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BinLevel& b = L.l[0];
  b.jj = nullptr;
  b.by = static_cast<const int*>(by);
  b.bx = static_cast<const int*>(bx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_binning(L, E, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  RingShape sh;
  if ((err = slab_tiles_shape(E, device, &sh)) != cudaSuccess)
    return static_cast<int>(err);
  const SlabArgs a{static_cast<const bf16*>(g), static_cast<const bf16*>(fmap),
                   static_cast<bf16*>(out), b.items, b.nitems, b.claim,
                   b.rec, H, W, b.TY, b.NYB, b.NXB, b.ncoarse - 1};
  probe_slab_tiles<<<sh.grid, sh.threads, sh.smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The int32 scratch words probe_slab_launch needs (-1: the map's bins pass
// int32).
extern "C" int probe_slab_scratch(int E, int H, int W) {
  BinLevels L;
  return static_cast<int>(slab_plan(std::max(E, 0), H, W, nullptr, &L));
}

// Where a launch left its work items in its scratch, in int32 words from
// its start: info[0] the items (int4: first sorted position, edges, coarse
// bin, the positions of its tile in the map), info[1] their number.
// Returns -1 where the scratch entry does.
extern "C" int probe_slab_items(int E, int H, int W, int* info) {
  BinLevels L;
  if (slab_plan(std::max(E, 0), H, W, nullptr, &L) < 0) return -1;
  info[0] = static_cast<int>(L.l[0].items_at);
  info[1] = static_cast<int>(L.l[0].nitems_at);
  return 0;
}

// The launch shape of the slab's tile kernel for E edges on `device`:
// info[0 .. 4] = grid, threads, dynamic shared memory bytes, registers per
// thread, blocks per SM; info[5 .. 10] = the tile's map rows, edges per
// item at most, consumer warps, tile rows per unit, m16 tiles per unit at
// most and per pass.
extern "C" int probe_slab_shape(int E, int device, int* info) {
  if (const int err = set_device(device)) return err;
  RingShape sh;
  const cudaError_t err = slab_tiles_shape(E, device, &sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[11] = {sh.grid,          sh.threads,
                        sh.smem,          sh.regs,
                        sh.blocks_per_sm, SlabTile::kRows,
                        SlabTile::kCap,   SlabTile::kWarps,
                        SlabTile::kUnitRows, SlabTile::kUnit,
                        SlabTile::kPass};
  for (int k = 0; k < 11; ++k) info[k] = vals[k];
  return 0;
}
