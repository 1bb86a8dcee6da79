// The correlation probes (K4-K8), hand-written for Hopper (sm_90a). Each
// computes one variant of the per-edge correlation planes of K2
// (csrc/corr_fused.cu): for edge e, the dot of its 9 source-patch pixels
// g[e, p, :] with every pixel of a window of a target map, f32 accumulation.
// Built with nvcc into a shared library with plain C entries and bound from
// Python with ctypes (dpvo_torch/ops/corr_probes.py, which also holds the
// plain PyTorch version of each instantiation).
//
// The TPU kernels they replace, all Pallas calls in the probe scripts:
//   probe_planes_pair       scripts/micro_fused_v2.py:_plane_kernel_k2 (K4)
//   probe_planes<kRoll>     scripts/micro_fused_v2.py:_plane_kernel_roll (K5)
//   probe_dots              scripts/micro_corr_floor.py:dot_kernel,
//                           dot_kernel2 (K6)
//   probe_slab              scripts/micro_corr_floor.py:fused_kernel (K6)
//   probe_planes<kFirst49>  scripts/micro_onepass_dma.py:kernel (K7)
//   probe_planes<kPlanes>   scripts/micro_kernel_variants.py:make_kernel
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
// The other probes: the dots run on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 accumulate; the building blocks are in mma_bf16.cuh,
// shared with K1's bf16 kernel), so the arithmetic stays far below the
// memory time, and every byte goes through a coalesced path:
//   * the 9 g rows of an edge are staged once in shared memory and held by
//     every warp as the A operand (rows 9-15 zero) in 32 registers;
//   * the B operand, 8 window positions x 16 channels, is read straight
//     from the channels-last map: each lane loads 16 contiguous bytes (8
//     channels) of its position's row, and the channels are permuted
//     identically in A and B so that one 16-byte load feeds two k-steps;
//   * the 9 x N f32 result of an edge is staged in shared memory and the
//     epilogue (bf16 rounding, per-edge roll, first-49 columns) writes it
//     out contiguously.
// Dropped, as TPU layout: the padded slabs and the phase-shifted copies of
// the maps (positions outside the map read as zero, which is what the
// padding held; a phase is bx + 4 * ph), the bit-packed SMEM scalar streams
// (plain int32 arrays), the 32-edge sequential grid with its target-slab DMA
// (one block per edge, all in parallel; a persistent grid for probe_dots),
// and K4's off-diagonal products (each edge is dotted with its own window
// only).
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
#include <mutex>

#include "mma_bf16.cuh"

namespace {

using namespace corr_mma;   // GFrag, load_gfrag, tile_dot, stage_tile, ...

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;   // one edge per 128 threads
constexpr int kFirst = 49;              // K7 keeps 49 columns per level

enum Epilogue { kPlanes = 0, kRoll = 1, kFirst49 = 2 };

// A window of wx columns at (by, bx) of one frame; position q is row q / wx,
// column q % wx. Positions outside the map (or a missing frame) read zero.
struct Window {
  const bf16* frame;
  int H, W, by, bx, wx;
  __device__ __forceinline__ const bf16* operator()(int q) const {
    const int y = by + q / wx, x = bx + q % wx;
    return (frame != nullptr && y >= 0 && y < H && x >= 0 && x < W)
               ? frame + (static_cast<size_t>(y) * W + x) * kC
               : nullptr;
  }
};

__device__ __forceinline__ Window edge_window(const bf16* fmap, int j, int F,
                                              int H, int W, int by, int bx,
                                              int wx) {
  const bf16* frame =
      (j >= 0 && j < F) ? fmap + static_cast<size_t>(j) * H * W * kC : nullptr;
  return Window{frame, H, W, by, bx, wx};
}

// Tiles [0, T1) of level 1 and [0, T2) of level 2, dealt round-robin to the
// warps; each level's f32 products land in its stage ([9][8 * T]).
template <int T1, int T2>
__device__ __forceinline__ void two_level_tiles(const GFrag& a,
                                                const Window& w1,
                                                const Window& w2, float* st1,
                                                float* st2, int warp,
                                                int nwarps) {
  const int grp = (threadIdx.x & 31) >> 2;
  for (int tile = warp; tile < T1 + T2; tile += nwarps) {
    float d[4];
    if (tile < T1) {
      tile_dot(a, w1(tile * 8 + grp), d);
      stage_tile(d, st1, 8 * T1, tile * 8);
    } else {
      const int tl = tile - T1;
      tile_dot(a, w2(tl * 8 + grp), d);
      stage_tile(d, st2, 8 * T2, tl * 8);
    }
  }
}

// n (even) bf16 values val(0 .. n-1) to dst, two per 4-byte store
template <class Val>
__device__ __forceinline__ void store_bf16(bf16* dst, int n, int tid, int nthr,
                                           Val val) {
  for (int i = 2 * tid; i < n; i += 2 * nthr)
    *reinterpret_cast<__nv_bfloat162*>(dst + i) =
        __floats2bfloat162_rn(val(i), val(i + 1));
}

struct PlaneArgs {
  const bf16 *g, *fmap1, *fmap2;
  const int *jj, *by1, *bx1, *by2, *bx2;
  const int *sh1, *sh2;                       // kRoll
  const int *s1, *s2;                         // K7's streams
  const float *fr1, *fr2, *S1, *S2;
  int nS1, nS2;
  unsigned* sink;
  void *out1, *out2;
  int E, F, H1, W1, H2, W2;
};

// K7's per-step input streams: the block's 9 rows of s1, fr1, s2, fr2 and
// its share of the S1 / S2 blocks (all of them read once over the grid),
// folded by xor into sink[e]. The planes never depend on them; the store
// keeps the loads in the compiled kernel. Warp 0 only.
__device__ void read_streams(const PlaneArgs& p, int e) {
  const int lane = threadIdx.x;
  unsigned x = 0;
  if (lane < kP2) {
    const size_t r = static_cast<size_t>(e) * kP2 + lane;
    const float2 f1 = reinterpret_cast<const float2*>(p.fr1)[r];
    const float2 f2 = reinterpret_cast<const float2*>(p.fr2)[r];
    x = static_cast<unsigned>(p.s1[r]) ^ static_cast<unsigned>(p.s2[r]) ^
        __float_as_uint(f1.x) ^ __float_as_uint(f1.y) ^
        __float_as_uint(f2.x) ^ __float_as_uint(f2.y);
  }
  const int stride = gridDim.x * 32;
  for (int i = e * 32 + lane; i < p.nS1; i += stride)
    x ^= __float_as_uint(p.S1[i]);
  for (int i = e * 32 + lane; i < p.nS2; i += stride)
    x ^= __float_as_uint(p.S2[i]);
  x = __reduce_xor_sync(0xffffffffu, x);
  if (lane == 0) p.sink[e] = x;
}

// K4: two edges per block, 4 warps each. The 18 g rows of the pair are
// staged together; each edge is dotted with its own 12 x 24 / 10 x 16
// windows only. Out: plane1 (E, 9, 288), plane2 (E, 9, 160) bf16.
constexpr int kPairN1 = 12 * 24, kPairN2 = 10 * 16;

__global__ void __launch_bounds__(2 * kThreads)
probe_planes_pair(const PlaneArgs p) {
  __shared__ uint4 s_g[2][kP2 * kRowU4];
  __shared__ float s_p1[2][kP2 * kPairN1];
  __shared__ float s_p2[2][kP2 * kPairN2];
  const int half = threadIdx.x / kThreads;
  const int tid = threadIdx.x % kThreads;
  const int e = 2 * blockIdx.x + half;
  const bool live = e < p.E;
  if (live)
    stage_g(p.g + static_cast<size_t>(e) * kP2 * kC, s_g[half], tid,
            kThreads);
  __syncthreads();
  if (live) {
    const GFrag a = load_gfrag(s_g[half]);
    const int j = p.jj[e];
    const Window w1 = edge_window(p.fmap1, j, p.F, p.H1, p.W1, p.by1[e],
                                  p.bx1[e], 24);
    const Window w2 = edge_window(p.fmap2, j, p.F, p.H2, p.W2, p.by2[e],
                                  p.bx2[e], 16);
    two_level_tiles<kPairN1 / 8, kPairN2 / 8>(a, w1, w2, s_p1[half],
                                              s_p2[half], tid / 32, kWarps);
  }
  __syncthreads();
  if (live) {
    const float* st1 = s_p1[half];
    const float* st2 = s_p2[half];
    store_bf16(static_cast<bf16*>(p.out1) +
                   static_cast<size_t>(e) * kP2 * kPairN1,
               kP2 * kPairN1, tid, kThreads, [&](int i) { return st1[i]; });
    store_bf16(static_cast<bf16*>(p.out2) +
                   static_cast<size_t>(e) * kP2 * kPairN2,
               kP2 * kPairN2, tid, kThreads, [&](int i) { return st2[i]; });
  }
}

// K5, K7, K8: one edge per block, windows WY1 x WX1 / WY2 x WX2 (by, bx at
// (0, 0) of the frame with kFixed). Epilogue:
//   kPlanes   bf16 planes (E, 9, WY*WX) per level;
//   kRoll     the same, each edge's level rolled by -sh over the flattened
//             plane: out[e, p, c] = plane[e, p, (c + sh[e]) mod (WY*WX)];
//   kFirst49  f32, the first 49 columns of each flattened plane row, as
//             (E * 9, 49) per level (only those positions are computed).
template <int WY1, int WX1, int WY2, int WX2, int Epi, bool kStreams,
          bool kFixed>
__global__ void __launch_bounds__(kThreads) probe_planes(const PlaneArgs p) {
  constexpr int N1 = WY1 * WX1, N2 = WY2 * WX2;
  constexpr int T1 = Epi == kFirst49 ? (kFirst + 7) / 8 : N1 / 8;
  constexpr int T2 = Epi == kFirst49 ? (kFirst + 7) / 8 : N2 / 8;
  static_assert(N1 % 8 == 0 && N2 % 8 == 0, "windows of whole tiles");
  __shared__ uint4 s_g[kP2 * kRowU4];
  __shared__ float s_p1[kP2 * 8 * T1];
  __shared__ float s_p2[kP2 * 8 * T2];
  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  stage_g(p.g + static_cast<size_t>(e) * kP2 * kC, s_g, tid, kThreads);
  if constexpr (kStreams) {
    if (tid < 32) read_streams(p, e);
  }
  __syncthreads();
  const GFrag a = load_gfrag(s_g);
  const int j = p.jj[e];
  const Window w1 = edge_window(p.fmap1, j, p.F, p.H1, p.W1,
                                kFixed ? 0 : p.by1[e], kFixed ? 0 : p.bx1[e],
                                WX1);
  const Window w2 = edge_window(p.fmap2, j, p.F, p.H2, p.W2,
                                kFixed ? 0 : p.by2[e], kFixed ? 0 : p.bx2[e],
                                WX2);
  two_level_tiles<T1, T2>(a, w1, w2, s_p1, s_p2, tid / 32, kWarps);
  __syncthreads();

  if constexpr (Epi == kFirst49) {
    const size_t base = static_cast<size_t>(e) * kP2 * kFirst;
    float* o1 = static_cast<float*>(p.out1) + base;
    float* o2 = static_cast<float*>(p.out2) + base;
    for (int i = tid; i < kP2 * kFirst; i += kThreads) {
      const int r = i / kFirst, c = i % kFirst;
      o1[i] = s_p1[r * 8 * T1 + c];
      o2[i] = s_p2[r * 8 * T2 + c];
    }
  } else {
    int sh1 = 0, sh2 = 0;
    if constexpr (Epi == kRoll) {
      sh1 = ((p.sh1[e] % N1) + N1) % N1;
      sh2 = ((p.sh2[e] % N2) + N2) % N2;
    }
    store_bf16(static_cast<bf16*>(p.out1) + static_cast<size_t>(e) * kP2 * N1,
               kP2 * N1, tid, kThreads, [&](int i) {
                 const int r = i / N1;
                 int c = i % N1 + sh1;
                 if (c >= N1) c -= N1;
                 return s_p1[r * N1 + c];
               });
    store_bf16(static_cast<bf16*>(p.out2) + static_cast<size_t>(e) * kP2 * N2,
               kP2 * N2, tid, kThreads, [&](int i) {
                 const int r = i / N2;
                 int c = i % N2 + sh2;
                 if (c >= N2) c -= N2;
                 return s_p2[r * N2 + c];
               });
  }
}

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` from the copy engine
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` on the copy
// engine, completing on barrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// B of one tile from this lane's row of a stage (16-byte words): the words
// of the four 32-channel chunks. Odd lane groups (sw = 1) read them in the
// order 1, 0, 3, 2, so that groups grp and grp + 1, whose rows start on
// the same bank, read different banks, and swap them back.
__device__ __forceinline__ void stage_b(const uint4* row, int sw,
                                        uint4 (&b)[kChunks]) {
  const int t = threadIdx.x & 3;
  uint4 r[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) r[k] = row[4 * (k ^ sw) + t];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) b[c] = sw ? r[c ^ 1] : r[c];
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// K6 fused_kernel: one resident map (H, W, 128), a 16 x 16 window per edge
// at (by[e], bx[e]). Out (E, 9, 256) bf16.
constexpr int kSlab = 16;

__global__ void __launch_bounds__(kThreads)
probe_slab(const bf16* __restrict__ g, const bf16* __restrict__ fmap,
           const int* __restrict__ by, const int* __restrict__ bx,
           bf16* __restrict__ out, int H, int W) {
  constexpr int N = kSlab * kSlab;
  __shared__ uint4 s_g[kP2 * kRowU4];
  __shared__ float s_p[kP2 * N];
  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const int grp = (tid & 31) >> 2;
  stage_g(g + static_cast<size_t>(e) * kP2 * kC, s_g, tid, kThreads);
  __syncthreads();
  const GFrag a = load_gfrag(s_g);
  const Window w{fmap, H, W, by[e], bx[e], kSlab};
  for (int tile = tid / 32; tile < N / 8; tile += kWarps) {
    float d[4];
    tile_dot(a, w(tile * 8 + grp), d);
    stage_tile(d, s_p, N, tile * 8);
  }
  __syncthreads();
  store_bf16(out + static_cast<size_t>(e) * kP2 * N, kP2 * N, tid, kThreads,
             [&](int i) { return s_p[i]; });
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

// A launch shape of probe_dots: grid, threads, dynamic shared memory,
// registers and blocks per SM.
struct DotsShape {
  int grid, threads, smem, regs, blocks_per_sm;
};

// The full shape of probe_dots<N, ...> on `device` (the current device),
// from the runtime: the blocks per SM that fit, at most the ring's, times
// the SMs make the grid. Opts in to the ring's dynamic shared memory.
template <int N, bool kBf16Out>
cudaError_t dots_query(int device, DotsShape* sh) {
  const void* fn = reinterpret_cast<const void*>(probe_dots<N, kBf16Out>);
  sh->threads = 32 * (DotsRing<N>::kWarps + 1);
  sh->smem = dots_smem<N>();
  // above 48 KB of dynamic shared memory only after opting in
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, sh->smem);
  if (err != cudaSuccess) return err;
  int fit = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, fn, sh->threads,
                                                      sh->smem);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attrs;
  err = cudaFuncGetAttributes(&attrs, fn);
  if (err != cudaSuccess) return err;
  sh->regs = attrs.numRegs;
  sh->blocks_per_sm = std::min(fit, DotsRing<N>::kBlocksPerSm);
  sh->grid = sh->blocks_per_sm * sms;
  return cudaSuccess;
}

constexpr int kMaxDevices = 64;

// dots_query's shape on `device` (the current device), queried once per
// instantiation and device (std::call_once, so threads launching at once
// share one query), its grid cut to E blocks when E is smaller.
template <int N, bool kBf16Out>
cudaError_t dots_shape(int E, int device, DotsShape* sh) {
  static std::once_flag once[kMaxDevices];
  static DotsShape shape[kMaxDevices];
  static cudaError_t status[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[device], [device] {
    status[device] = dots_query<N, kBf16Out>(device, &shape[device]);
  });
  if (status[device] != cudaSuccess) return status[device];
  *sh = shape[device];
  sh->grid = std::max(1, std::min(E, sh->grid));
  return cudaSuccess;
}

// Validates (variant, W), selects the device and fills the shape of the
// instantiation they select; returns its N (0 on an error, in *err).
int dots_setup(int variant, int W, int E, int device, DotsShape* sh,
               cudaError_t* err) {
  const int N = dots_rows(variant, W);
  if (N == 0) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  *err = cudaSetDevice(device);
  if (*err == cudaSuccess)
    *err = N == 384 ? dots_shape<384, false>(E, device, sh)
                    : dots_shape<256, true>(E, device, sh);
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

}  // namespace

// Each entry enqueues its kernel on `stream` of CUDA device `device` and
// returns cudaGetLastError() (0 on a successful launch; this library carries
// its own CUDA runtime, so it selects the tensors' device first). E <= 0
// launches nothing.

// K4. plane1 (E, 9, 288), plane2 (E, 9, 160) bf16.
extern "C" int probe_planes_pair_launch(
    const void* g, const void* fmap1, const void* fmap2, const void* jj,
    const void* by1, const void* bx1, const void* by2, const void* bx2,
    void* plane1, void* plane2, int E, int F, int H1, int W1, int H2, int W2,
    int device, void* stream) {
  if (E <= 0) return 0;
  if (const int err = set_device(device)) return err;
  const PlaneArgs p = plane_args(g, fmap1, fmap2, jj, by1, bx1, by2, bx2,
                                 plane1, plane2, E, F, H1, W1, H2, W2);
  probe_planes_pair<<<(E + 1) / 2, 2 * kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
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
  probe_planes<12, 24, 10, 16, kRoll, false, false>
      <<<E, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
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
    probe_planes<12, 24, 10, 16, kFirst49, true, false>
        <<<E, kThreads, 0, s>>>(p);
  } else {
    probe_planes<12, 24, 10, 16, kFirst49, false, false>
        <<<E, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
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
  if (fixed)
    probe_planes<12, 16, 12, 16, kPlanes, false, true>
        <<<E, kThreads, 0, s>>>(p);
  else
    probe_planes<12, 16, 12, 16, kPlanes, false, false>
        <<<E, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K6 dots. variant 0: out (E, 9, 384) f32 from all 384 rows of each window
// (W must be 384); variant 1: out (E, 9, 256) bf16 from the first 256 rows
// (W >= 256). Any other variant or W returns an error.
extern "C" int probe_dots_launch(const void* g, const void* win, void* out,
                                 int E, int W, int variant, int device,
                                 void* stream) {
  if (E <= 0) return 0;
  DotsShape sh;
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
  DotsShape sh;
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

// K6 slab. out (E, 9, 256) bf16.
extern "C" int probe_slab_launch(const void* g, const void* fmap,
                                 const void* by, const void* bx, void* out,
                                 int E, int H, int W, int device,
                                 void* stream) {
  if (E <= 0) return 0;
  if (const int err = set_device(device)) return err;
  probe_slab<<<E, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(fmap),
      static_cast<const int*>(by), static_cast<const int*>(bx),
      static_cast<bf16*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}
