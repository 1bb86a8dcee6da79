// Fused two-level patch correlation for DPVO in two passes, hand-written for
// Hopper (sm_90a). Built with nvcc into a shared library with plain C
// entries and bound from Python with ctypes (dpvo_torch/ops/corr_fused.py,
// which also holds the plain PyTorch version of each kernel and the window
// rule that feeds them).
//
// ---------------------------------------------------------------------------
// K2, the correlation planes. Replaces the TPU kernel
// dpvo_tpu/ops/corr_fused.py:_plane_kernel (the Pallas call of
// _planes_fused). Per edge e, for each of its 9 source-patch pixels p and
// every pixel (y, x) of a fixed window of the target frame jj[e]:
//
//   plane1[e, p, wy, wx] = sum_ch g[kk[e], p, ch] * fmap1[jj[e], by1 + wy,
//                                                     bx1 + wx, ch]
//   (wy < 12, wx < 24; level 2 the same on fmap2 with by2 / bx2, 10 x 16)
//
// rounded to bf16 (f32 accumulation), 0 where (y, x) lies outside the map
// and for an edge whose kk or jj is out of range. The windows and their
// bases are the TPU kernel's (ops/corr_fused.py:window_base): they decide
// which taps the select pass zeroes, so they are kept exactly. Dropped, as
// TPU workarounds: the padded slabs and the level-2 phase pair (positions
// outside the image read as zero here, which is what the padding held), the
// bit-packed SMEM scalar streams (jj, by1, bx1, by2, bx2 arrive as plain
// int32 arrays), and the 32-edge sequential grid with its target-slab DMA.
//
// bf16 maps (MIXED_PRECISION, the default): corr_planes_ring. With the dots
// on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate; the 9 g
// rows padded to 16, ~90 GFLOP per call at E = 49,152, ~0.09 ms at the bf16
// peak) what bounds it is the stream of window rows from L2 to the SMs: 448
// channel rows of 256 B per edge, 114,688 B, 5.64 GB per call at E =
// 49,152, each edge reading its own windows (a target frame's maps, 5.2 MB
// at 640x480, stay in L2 while the edges, sorted by target, read them; the
// bytes bound of the maps themselves is ~13x lower). Its body is
// planes_ring.cuh:ring_body, shared with the probes K5 and K8 (the design is
// described there): a persistent grid; a producer warp, lane r copying
// window row r's in-map run into a ring of stages with cp.async.bulk on
// mbarriers; consumer warps on mma.sync that zero the columns outside the
// map and store tile pairs as whole 32-byte sectors. The ring's shape
// (PlanesRing) is fixed at compile time. Once the copies of each stage are
// in flight, what limits it on an H100 is the round trip of a stage (copy,
// mma, release), not the bytes: the time per edge barely moves between
// windows mostly outside the map and windows inside it, so the rings with
// the most stages in flight per SM led (PERF.md section 6).
//
// f32 maps (MIXED_PRECISION off, and the parity runs): corr_planes_kernel,
// the first port of the TPU kernel, unchanged. 9 x 448 x 128 multiply-adds
// per edge, ~50.7 GFLOP per call at E = 49,152 -- at least 0.76 ms on the
// card's f32 FMA units (67 TFLOP/s); the tensor cores take f32 only as
// TF32, which would miss the 1e-5 * max|plain| parity bound. One block of
// 224 threads per edge stages the edge's nine g rows in shared memory, and
// each thread owns two window positions, so one broadcast shared-memory read
// of 8 g channels feeds 16 FMAs; each window row is read by one thread in
// 16-byte steps, neighbouring threads reading neighbouring pixels.
//
// ---------------------------------------------------------------------------
// K3, corr_select_kernel. Replaces the TPU kernel
// dpvo_tpu/ops/corr_select.py:_sel_kernel (the Pallas call of
// select_taps_tpu). Per edge e, patch pixel p and tap (dy, dx) of the 7 x 7
// output: the 8 x 8 integer-tap block of pixel p starts at window offset
// (oy, ox); with validity-folded bilinear weights
//   ay = (1 - fy) * [ty in image],  by = fy * [ty + 1 in image],
//   ty = yi - 3 + dy  (and ax, bx the same in x),
//   t(c) = ay * plane[oy + dy, c] + by * plane[oy + dy + 1, c]
//   out[e, dx, dy, p] = ax * t(ox + dx) + bx * t(ox + dx + 1)
// in f32, written in the reference layout (E, 7, 7, 3, 3) = [dx, dy, py,
// px]. A pixel whose block does not fit the window (oy > Wy - 8 or
// ox > Wx - 8: its patch spread overflows the window budget) gets zeros, as
// the TPU kernel's masked shifts give it. The TPU kernel resolved the
// dynamic offset as a sum of 18 masked static shifts because dynamic gathers
// do not vectorise there; here each thread indexes the plane directly.
//
// What bounds it: memory. One read of the planes (~396 MB of bf16 for both
// levels at E = 49,152) and ~173 MB of f32 taps written: ~0.17 ms at
// 3.35 TB/s. One thread per output tap, numbered in output order, so the
// stores are fully coalesced; the four plane reads of a thread fall in its
// edge's 9 planes (5.2 KB at level 1), which the 441 threads of that edge
// share through L1. Multiplies and adds are written with __fmul_rn /
// __fadd_rn so that nothing is contracted into an FMA: the kernel rounds
// exactly where its plain version does.
//
// Layouts (all contiguous): g (Ng, 9, 128), fmap1 (F, H1, W1, 128), fmap2
// (F, H2, W2, 128) channels-last, bf16 or f32 (one dtype for all three);
// kk, jj, by1, bx1, by2, bx2 (E,) int32; plane1 (E, 9, 12, 24), plane2
// (E, 9, 10, 16) bf16. Select: plane (E, 9, Wy, Wx) bf16; yi, xi, oy, ox
// (E, 9) int32; fy, fx (E, 9) f32; out (E, 7, 7, 3, 3) f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "planes_ring.cuh"
#include "ring.cuh"

namespace {

using namespace corr_mma;   // bf16, kC, kP2
using namespace corr_ring;  // RingShape, ring_shape

constexpr int kWY1 = 12, kWX1 = 24;          // level-1 window
constexpr int kWY2 = 10, kWX2 = 16;          // level-2 window
constexpr int kN1 = kWY1 * kWX1;             // 288 positions
constexpr int kN2 = kWY2 * kWX2;             // 160 positions
constexpr int kN = kN1 + kN2;                // 448 positions per edge
constexpr int kPlaneThreads = kN / 2;        // 224: two positions each
constexpr int kR = 3;                        // radius
constexpr int kd = 2 * kR + 1;               // 7 outputs per axis
constexpr int kSelOut = kd * kd * kP2;       // 441 outputs per edge
constexpr int kSelThreads = 256;

// 8 consecutive channels as two float4
__device__ __forceinline__ void load8(const float* p, float4& a, float4& b) {
  a = __ldg(reinterpret_cast<const float4*>(p));
  b = __ldg(reinterpret_cast<const float4*>(p) + 1);
}

__device__ __forceinline__ float dot8(const float4& ga, const float4& gb,
                                      const float4& fa, const float4& fb,
                                      float acc) {
  acc = fmaf(ga.x, fa.x, acc);
  acc = fmaf(ga.y, fa.y, acc);
  acc = fmaf(ga.z, fa.z, acc);
  acc = fmaf(ga.w, fa.w, acc);
  acc = fmaf(gb.x, fb.x, acc);
  acc = fmaf(gb.y, fb.y, acc);
  acc = fmaf(gb.z, fb.z, acc);
  return fmaf(gb.w, fb.w, acc);
}

template <typename T>
__global__ void __launch_bounds__(kPlaneThreads)
corr_planes_kernel(const T* __restrict__ g, const T* __restrict__ fmap1,
                   const T* __restrict__ fmap2, const int* __restrict__ kk,
                   const int* __restrict__ jj, const int* __restrict__ by1,
                   const int* __restrict__ bx1, const int* __restrict__ by2,
                   const int* __restrict__ bx2,
                   __nv_bfloat16* __restrict__ plane1,
                   __nv_bfloat16* __restrict__ plane2, int Ng, int F, int H1,
                   int W1, int H2, int W2) {
  __shared__ float4 s_g[kP2][kC / 4];

  const int e = blockIdx.x;
  const int k = kk[e];
  const int j = jj[e];
  // block-uniform: an edge naming no source row or target frame is all zero
  const bool ok = k >= 0 && k < Ng && j >= 0 && j < F;
  for (int i = threadIdx.x; i < kP2 * kC / 8; i += kPlaneThreads) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (ok) load8(g + static_cast<size_t>(k) * kP2 * kC + i * 8, a, b);
    s_g[i / (kC / 8)][2 * (i % (kC / 8))] = a;
    s_g[i / (kC / 8)][2 * (i % (kC / 8)) + 1] = b;
  }
  __syncthreads();

  // this thread's two window positions q = tid and tid + 224 (q < 288:
  // level 1, row-major in its 12 x 24 window; else level 2, 10 x 16)
  const T* row[2];
  bool in[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = threadIdx.x + s * kPlaneThreads;
    const bool l2 = q >= kN1;
    const int qq = l2 ? q - kN1 : q;
    const int wx = l2 ? kWX2 : kWX1;
    const int H = l2 ? H2 : H1;
    const int W = l2 ? W2 : W1;
    const int y = (l2 ? by2[e] : by1[e]) + qq / wx;
    const int x = (l2 ? bx2[e] : bx1[e]) + qq % wx;
    in[s] = ok && y >= 0 && y < H && x >= 0 && x < W;
    row[s] = (l2 ? fmap2 : fmap1) +
             ((static_cast<size_t>(in[s] ? j : 0) * H + (in[s] ? y : 0)) * W +
              (in[s] ? x : 0)) * kC;
  }

  float acc0[kP2], acc1[kP2];
#pragma unroll
  for (int p = 0; p < kP2; ++p) acc0[p] = acc1[p] = 0.f;

#pragma unroll 2
  for (int c = 0; c < kC; c += 8) {
    float4 f0a = make_float4(0.f, 0.f, 0.f, 0.f), f0b = f0a, f1a = f0a,
           f1b = f0a;
    if (in[0]) load8(row[0] + c, f0a, f0b);
    if (in[1]) load8(row[1] + c, f1a, f1b);
#pragma unroll
    for (int p = 0; p < kP2; ++p) {
      const float4 ga = s_g[p][c / 4];
      const float4 gb = s_g[p][c / 4 + 1];
      acc0[p] = dot8(ga, gb, f0a, f0b, acc0[p]);
      acc1[p] = dot8(ga, gb, f1a, f1b, acc1[p]);
    }
  }

#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = threadIdx.x + s * kPlaneThreads;
    const bool l2 = q >= kN1;
    const int n = l2 ? kN2 : kN1;
    __nv_bfloat16* dst = (l2 ? plane2 : plane1) +
                         static_cast<size_t>(e) * kP2 * n + (l2 ? q - kN1 : q);
#pragma unroll
    for (int p = 0; p < kP2; ++p)
      dst[p * n] = __float2bfloat16_rn(s ? acc1[p] : acc0[p]);
  }
}

// ---- K2 for bf16 maps: corr_planes_ring (the body in planes_ring.cuh) ----

// The ring: kStages stages of kRows window positions, kWarps consumer warps
// (+ 1 producer), and the blocks asked for on each SM (at most what fits).
struct PlanesRing {
  static constexpr int kStages = 3, kRows = 64, kWarps = 4, kBlocksPerSm = 4;
};

// K2 as a spec of planes_ring::ring_body: K2's windows, g rows g[kk[e]]
// (an edge whose kk or jj is out of range is all zero), per-edge bases.
struct K2Planes {
  using Ring = PlanesRing;
  static constexpr int kWY1 = ::kWY1, kWX1 = ::kWX1;
  static constexpr int kWY2 = ::kWY2, kWX2 = ::kWX2;
  static constexpr bool kRoll = false;
  struct Args {
    const bf16 *g, *fmap1, *fmap2;
    const int *kk, *jj, *by1, *bx1, *by2, *bx2;
    bf16 *out1, *out2;
    int E, Ng, F, H1, W1, H2, W2;
  };
  struct Edge {
    int k, j;
    int4 base;
  };
  static __device__ __forceinline__ Edge edge(const Args& a, int e) {
    return Edge{a.kk[e], a.jj[e],
                make_int4(a.by1[e], a.bx1[e], a.by2[e], a.bx2[e])};
  }
  static __device__ __forceinline__ bool ok(const Args& a, const Edge& x) {
    return x.k >= 0 && x.k < a.Ng && x.j >= 0 && x.j < a.F;
  }
  static __device__ __forceinline__ int frame(const Edge& x) { return x.j; }
  static __device__ __forceinline__ int4 base(const Edge& x) { return x.base; }
  static __device__ __forceinline__ const bf16* g(const Args& a,
                                                  const Edge& x, int) {
    return a.g + static_cast<size_t>(x.k) * kP2 * kC;
  }
};

__global__ void __launch_bounds__(32 * (PlanesRing::kWarps + 1),
                                  PlanesRing::kBlocksPerSm)
corr_planes_ring(const bf16* __restrict__ g, const bf16* __restrict__ fmap1,
                 const bf16* __restrict__ fmap2, const int* __restrict__ kk,
                 const int* __restrict__ jj, const int* __restrict__ by1,
                 const int* __restrict__ bx1, const int* __restrict__ by2,
                 const int* __restrict__ bx2, bf16* __restrict__ plane1,
                 bf16* __restrict__ plane2, int E, int Ng, int F, int H1,
                 int W1, int H2, int W2) {
  planes_ring::ring_body<K2Planes>(K2Planes::Args{
      g, fmap1, fmap2, kk, jj, by1, bx1, by2, bx2, plane1, plane2, E, Ng, F,
      H1, W1, H2, W2});
}

// corr_planes_ring for ring_shape
struct PlanesKernel {
  static const void* fn() {
    return reinterpret_cast<const void*>(corr_planes_ring);
  }
  static constexpr int kThreads = planes_ring::Geom<K2Planes>::kThreads;
  static constexpr int kSmem = planes_ring::Geom<K2Planes>::kSmem;
  static constexpr int kBlocksPerSm = PlanesRing::kBlocksPerSm;
};

template <int Wy, int Wx>
__global__ void __launch_bounds__(kSelThreads)
corr_select_kernel(const __nv_bfloat16* __restrict__ plane,
                   const int* __restrict__ yi, const int* __restrict__ xi,
                   const float* __restrict__ fy, const float* __restrict__ fx,
                   const int* __restrict__ oy, const int* __restrict__ ox,
                   float* __restrict__ out, int total, int H, int W) {
  const int idx = blockIdx.x * kSelThreads + threadIdx.x;
  if (idx >= total) return;
  // output order (e, dx, dy, p)
  const int p = idx % kP2;
  int r = idx / kP2;
  const int dy = r % kd;
  r /= kd;
  const int dx = r % kd;
  const int e = r / kd;
  const int pix = e * kP2 + p;

  const int oyv = oy[pix];
  const int oxv = ox[pix];
  if (oyv < 0 || oyv > Wy - 8 || oxv < 0 || oxv > Wx - 8) {
    out[idx] = 0.f;
    return;
  }
  const int ty = yi[pix] - kR + dy;
  const int tx = xi[pix] - kR + dx;
  const float fyv = fy[pix];
  const float fxv = fx[pix];
  const float ay = __fmul_rn(__fadd_rn(1.f, -fyv),
                             (ty >= 0 && ty < H) ? 1.f : 0.f);
  const float by = __fmul_rn(fyv, (ty + 1 >= 0 && ty + 1 < H) ? 1.f : 0.f);
  const float ax = __fmul_rn(__fadd_rn(1.f, -fxv),
                             (tx >= 0 && tx < W) ? 1.f : 0.f);
  const float bx = __fmul_rn(fxv, (tx + 1 >= 0 && tx + 1 < W) ? 1.f : 0.f);

  const __nv_bfloat16* pl =
      plane + static_cast<size_t>(pix) * Wy * Wx + (oyv + dy) * Wx + oxv + dx;
  const float lo0 = __bfloat162float(pl[0]);
  const float lo1 = __bfloat162float(pl[1]);
  const float hi0 = __bfloat162float(pl[Wx]);
  const float hi1 = __bfloat162float(pl[Wx + 1]);
  const float t0 = __fadd_rn(__fmul_rn(ay, lo0), __fmul_rn(by, hi0));
  const float t1 = __fadd_rn(__fmul_rn(ay, lo1), __fmul_rn(by, hi1));
  out[idx] = __fadd_rn(__fmul_rn(ax, t0), __fmul_rn(bx, t1));
}

// The arguments of corr_planes_launch.
struct PlanesArgs {
  const void *g, *fmap1, *fmap2, *kk, *jj, *by1, *bx1, *by2, *bx2;
  void *plane1, *plane2;
  int E, Ng, F, H1, W1, H2, W2;
};

// f32 maps: one block per edge
cudaError_t launch_planes_f32(const PlanesArgs& a, cudaStream_t stream) {
  corr_planes_kernel<float><<<a.E, kPlaneThreads, 0, stream>>>(
      static_cast<const float*>(a.g), static_cast<const float*>(a.fmap1),
      static_cast<const float*>(a.fmap2), static_cast<const int*>(a.kk),
      static_cast<const int*>(a.jj), static_cast<const int*>(a.by1),
      static_cast<const int*>(a.bx1), static_cast<const int*>(a.by2),
      static_cast<const int*>(a.bx2), static_cast<bf16*>(a.plane1),
      static_cast<bf16*>(a.plane2), a.Ng, a.F, a.H1, a.W1, a.H2, a.W2);
  return cudaGetLastError();
}

// bf16 maps: the persistent ring on `device` (the current device)
cudaError_t launch_planes_ring(const PlanesArgs& a, int device,
                               cudaStream_t stream) {
  RingShape sh;
  const cudaError_t err = ring_shape<PlanesKernel>(a.E, device, &sh);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused attribute must not fail a later launch
    return err;
  }
  corr_planes_ring<<<sh.grid, sh.threads, sh.smem, stream>>>(
      static_cast<const bf16*>(a.g), static_cast<const bf16*>(a.fmap1),
      static_cast<const bf16*>(a.fmap2), static_cast<const int*>(a.kk),
      static_cast<const int*>(a.jj), static_cast<const int*>(a.by1),
      static_cast<const int*>(a.bx1), static_cast<const int*>(a.by2),
      static_cast<const int*>(a.bx2), static_cast<bf16*>(a.plane1),
      static_cast<bf16*>(a.plane2), a.E, a.Ng, a.F, a.H1, a.W1, a.H2, a.W2);
  return cudaGetLastError();
}

template <int Wy, int Wx>
void launch_select(const void* plane, const void* yi, const void* xi,
                   const void* fy, const void* fx, const void* oy,
                   const void* ox, void* out, int E, int H, int W,
                   cudaStream_t stream) {
  const int total = E * kSelOut;
  corr_select_kernel<Wy, Wx>
      <<<(total + kSelThreads - 1) / kSelThreads, kSelThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(plane),
          static_cast<const int*>(yi), static_cast<const int*>(xi),
          static_cast<const float*>(fy), static_cast<const float*>(fx),
          static_cast<const int*>(oy), static_cast<const int*>(ox),
          static_cast<float*>(out), total, H, W);
}

}  // namespace

// Each entry enqueues its kernel on `stream` of CUDA device `device` and
// returns cudaGetLastError() (0 on a successful launch; this library carries
// its own CUDA runtime, so it selects the tensors' device first).

// in_bf16 selects bf16 (1: corr_planes_ring) or f32 (0: corr_planes_kernel)
// for g, fmap1 and fmap2.
extern "C" int corr_planes_launch(const void* g, const void* fmap1,
                                  const void* fmap2, const void* kk,
                                  const void* jj, const void* by1,
                                  const void* bx1, const void* by2,
                                  const void* bx2, void* plane1, void* plane2,
                                  int E, int Ng, int F, int H1, int W1, int H2,
                                  int W2, int in_bf16, int device,
                                  void* stream) {
  if (E <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const PlanesArgs a{g,      fmap1,  fmap2, kk, jj, by1, bx1, by2, bx2,
                     plane1, plane2, E,     Ng, F,  H1,  W1,  H2,  W2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(in_bf16 ? launch_planes_ring(a, device, s)
                                  : launch_planes_f32(a, s));
}

// The launch shape corr_planes_launch takes for bf16 maps and E edges on
// `device`: info[0 .. 4] = grid, threads, dynamic shared memory bytes,
// registers per thread, blocks per SM; info[5 .. 7] = the ring's stages,
// positions per stage and consumer warps.
extern "C" int corr_planes_shape(int E, int device, int* info) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  RingShape sh;
  const cudaError_t err = ring_shape<PlanesKernel>(E, device, &sh);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const int vals[8] = {sh.grid,          sh.threads,
                       sh.smem,          sh.regs,
                       sh.blocks_per_sm, PlanesRing::kStages,
                       PlanesRing::kRows, PlanesRing::kWarps};
  for (int k = 0; k < 8; ++k) info[k] = vals[k];
  return 0;
}

// level 1 selects the 12 x 24 window, level 2 the 10 x 16 one; any other
// value returns cudaErrorInvalidValue without launching.
extern "C" int corr_select_launch(const void* plane, const void* yi,
                                  const void* xi, const void* fy,
                                  const void* fx, const void* oy,
                                  const void* ox, void* out, int E, int H,
                                  int W, int level, int device, void* stream) {
  if (E <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (level == 1)
    launch_select<kWY1, kWX1>(plane, yi, xi, fy, fx, oy, ox, out, E, H, W, s);
  else if (level == 2)
    launch_select<kWY2, kWX2>(plane, yi, xi, fy, fx, oy, ox, out, E, H, W, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
