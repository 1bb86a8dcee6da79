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
// What the design does about it: the dots run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate), so the arithmetic stays far
// below the memory time, and every byte goes through a coalesced path:
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
// (one block per edge, all in parallel), and K4's off-diagonal products
// (each edge is dotted with its own window only).
//
// Layouts (all contiguous): g (E, 9, 128) bf16, one row block per edge;
// fmap1 (F, H1, W1, 128), fmap2 (F, H2, W2, 128) bf16; jj, by*, bx*, sh*
// (E,) int32; win (E, W, 128) bf16; slab map (H, W, 128) bf16. Outputs as
// each entry says.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kC = 128;                 // channels
constexpr int kP2 = 9;                  // 3 x 3 patch pixels
constexpr int kRowU4 = kC / 8;          // 16-byte words per channel row
constexpr int kChunks = kC / 32;        // 32 channels: two mma k-steps
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;   // one edge per 128 threads
constexpr int kFirst = 49;              // K7 keeps 49 columns per level

enum Epilogue { kPlanes = 0, kRoll = 1, kFirst49 = 2 };

// A operand of m16n8k16: this lane's words of g rows (lane / 4) and 8, for
// each 32-channel chunk. Lane (grp, t) holds channels 32c + 8t .. + 7.
struct GFrag {
  uint4 lo[kChunks];
  uint4 hi[kChunks];
};

__device__ __forceinline__ void stage_g(const bf16* __restrict__ g,
                                        uint4* s_g, int tid, int nthr) {
  const uint4* src = reinterpret_cast<const uint4*>(g);
  for (int i = tid; i < kP2 * kRowU4; i += nthr) s_g[i] = __ldg(src + i);
}

__device__ __forceinline__ GFrag load_gfrag(const uint4* s_g) {
  const int lane = threadIdx.x & 31, grp = lane >> 2, t = lane & 3;
  GFrag a;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    a.lo[c] = s_g[grp * kRowU4 + 4 * c + t];
    a.hi[c] = grp == 0 ? s_g[8 * kRowU4 + 4 * c + t] : make_uint4(0, 0, 0, 0);
  }
  return a;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The dot of the 9 g rows with 8 channel rows, one per lane group; `row` is
// this lane's (nullptr reads as zeros). k-step h of chunk c takes, in its
// slots 2t, 2t + 1 / 2t + 8, 2t + 9, the channels 32c + 8t + 4h + {0, 1} /
// {2, 3}, in A and B alike. Out: d[0], d[1] = g row grp at positions 2t,
// 2t + 1; d[2], d[3] = g row 8 there (grp 0; zero rows elsewhere).
__device__ __forceinline__ void tile_dot(const GFrag& a, const bf16* row,
                                         float (&d)[4]) {
  const int t = threadIdx.x & 3;
  d[0] = d[1] = d[2] = d[3] = 0.f;
  uint4 b[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    b[c] = row ? __ldg(reinterpret_cast<const uint4*>(row) + 4 * c + t)
               : make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    mma_bf16(d, a.lo[c].x, a.hi[c].x, a.lo[c].y, a.hi[c].y, b[c].x, b[c].y);
    mma_bf16(d, a.lo[c].z, a.hi[c].z, a.lo[c].w, a.hi[c].w, b[c].z, b[c].w);
  }
}

// stage: f32 [9][ns], positions q0 .. q0 + 7 of this tile
__device__ __forceinline__ void stage_tile(const float (&d)[4], float* stage,
                                           int ns, int q0) {
  const int lane = threadIdx.x & 31, grp = lane >> 2, t = lane & 3;
  stage[grp * ns + q0 + 2 * t] = d[0];
  stage[grp * ns + q0 + 2 * t + 1] = d[1];
  if (grp == 0) {
    stage[8 * ns + q0 + 2 * t] = d[2];
    stage[8 * ns + q0 + 2 * t + 1] = d[3];
  }
}

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

// K6 dot_kernel / dot_kernel2: per edge, g[e] (9, 128) times the first N
// rows of its pre-gathered window win[e] (W rows of 128). Out (E, 9, N),
// f32 or bf16.
template <int N, bool kBf16Out>
__global__ void __launch_bounds__(kThreads)
probe_dots(const bf16* __restrict__ g, const bf16* __restrict__ win,
           void* __restrict__ out, int W) {
  __shared__ uint4 s_g[kP2 * kRowU4];
  __shared__ float s_p[kP2 * N];
  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const int grp = (tid & 31) >> 2;
  stage_g(g + static_cast<size_t>(e) * kP2 * kC, s_g, tid, kThreads);
  __syncthreads();
  const GFrag a = load_gfrag(s_g);
  const bf16* base = win + static_cast<size_t>(e) * W * kC;
  for (int tile = tid / 32; tile < N / 8; tile += kWarps) {
    float d[4];
    tile_dot(a, base + static_cast<size_t>(tile * 8 + grp) * kC, d);
    stage_tile(d, s_p, N, tile * 8);
  }
  __syncthreads();
  if constexpr (kBf16Out) {
    store_bf16(static_cast<bf16*>(out) + static_cast<size_t>(e) * kP2 * N,
               kP2 * N, tid, kThreads, [&](int i) { return s_p[i]; });
  } else {
    float* o = static_cast<float*>(out) + static_cast<size_t>(e) * kP2 * N;
    for (int i = tid; i < kP2 * N; i += kThreads) o[i] = s_p[i];
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
// (W >= 256). Any other variant returns cudaErrorInvalidValue.
extern "C" int probe_dots_launch(const void* g, const void* win, void* out,
                                 int E, int W, int variant, int device,
                                 void* stream) {
  if (E <= 0) return 0;
  if (const int err = set_device(device)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* gp = static_cast<const bf16*>(g);
  const bf16* wp = static_cast<const bf16*>(win);
  if (variant == 0 && W == 384)
    probe_dots<384, false><<<E, kThreads, 0, s>>>(gp, wp, out, W);
  else if (variant == 1 && W >= 256)
    probe_dots<256, true><<<E, kThreads, 0, s>>>(gp, wp, out, W);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
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
