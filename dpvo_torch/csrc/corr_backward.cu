// Gradient of the two-level local patch correlation (the function of
// csrc/corr_onepass.cu, K1) with respect to gmap, fmap1 and fmap2,
// hand-written for Hopper (sm_90a). Built with nvcc into a shared library
// with a plain C entry and bound from Python with ctypes
// (dpvo_torch/ops/corr_grad.py:corr_backward).
//
// No TPU kernel to replace: dpvo_tpu takes this gradient by XLA autodiff of
// the plain gather form (dpvo_tpu/train/trainer.py:220 differentiates
// ops/corr.py:corr). It computes what dpvo_torch/ops/corr_grad.py:
// corr_backward_plain computes:
//
//   for each edge e and level L (fmap1 at coords, fmap2 at coords / 4), for
//   each patch pixel p = (py, px) with window origin (x0, y0) = floor(c) -
//   3 (clamped to +-(dim + 16) first, NaN to -16, as K1 does) and
//   fractions (fx, fy):
//     dtap[ty][tx] = the output gradient go[dx, dy, p, L] spread bilinearly
//       onto the 8 x 8 integer taps (the transpose of K1's blend);
//     for each tap inside the map, with f = fmap[jj[e], y0 + ty, x0 + tx]:
//       dgmap[kk[e], p] += dtap * f,   dfmap[jj[e], y0 + ty, x0 + tx] +=
//       dtap * gmap[kk[e], p].
//   Edges whose kk or jj is out of range get no gradient (K1 writes zeros
//   for them).
//
// Design (a simple right kernel; PERF.md has its time beside its bound):
// one 128-thread block per (edge, level), one thread per channel. The
// block first forms the 9 x 64 tap gradients in shared memory (four
// weighted output gradients each, zero outside the map), then walks the
// nine pixels: each thread reads its channel of every in-map tap row (128
// consecutive channels: one coalesced row per tap) and adds dtap * g to the
// map's gradient with a fire-and-forget atomic (red.global.add.f32), while
// summing dtap * f in a register; one atomic per channel and pixel then
// adds that sum to dgmap[kk], since edges share patches. What bounds it is
// the atomics: 9 x 64 x 128 per edge and level, ~1.3e9 per level at E =
// 18,000, against ~0.15 GB of map gradient that the bytes bound counts. A
// later pass accumulates each edge's union box (at most 12 x 12 rows,
// ops/corr_onepass.py:BOX) in shared memory first, ~4x fewer atomics.
//
// Layout: gmap (Ng, 3, 3, 128), fmap1 (F, H1, W1, 128), fmap2 (F, H2, W2,
// 128), all channels-last and contiguous, bf16 or f32 (one dtype); coords
// (E, 3, 3, 2) f32 [x, y] at level-1 scale; kk, jj (E,) int32; grad_out
// (E, 7, 7, 3, 3, 2) f32 [dx, dy, py, px, lvl]; dgmap, dfmap1, dfmap2 f32
// in the maps' shapes, zeroed by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 3;                    // radius
constexpr int kD = 2 * kR + 2;           // 8 integer taps per axis
constexpr int kTaps = kD * kD;           // 64
constexpr int kd = 2 * kR + 1;           // 7 outputs per axis
constexpr int kP2 = 9;                   // patch pixels
constexpr int kC = 128;                  // channels
constexpr int kOut = kd * kd * kP2 * 2;  // 882 outputs per edge
constexpr int kThreads = kC;             // one thread per channel

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// K1's window origin on one axis (csrc/corr_onepass.cu:window_origin)
__device__ __forceinline__ int window_origin(float vf, int dim) {
  return static_cast<int>(fminf(fmaxf(vf, -16.f), dim + 16.f)) - kR;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_backward_kernel(const T* __restrict__ gmap, const T* __restrict__ fmap1,
                     const T* __restrict__ fmap2,
                     const float* __restrict__ coords,
                     const int* __restrict__ kk, const int* __restrict__ jj,
                     const float* __restrict__ grad_out,
                     float* __restrict__ dgmap, float* __restrict__ dfmap1,
                     float* __restrict__ dfmap2, int Ng, int F, int H1,
                     int W1, int H2, int W2) {
  __shared__ float s_dtap[kP2][kTaps];
  __shared__ int s_org[kP2][2];

  const int e = blockIdx.x >> 1;
  const int lvl = blockIdx.x & 1;
  const int k = kk[e];
  const int j = jj[e];
  // block-uniform: every thread of the block takes the same branch
  if (k < 0 || k >= Ng || j < 0 || j >= F) return;
  const int H = lvl ? H2 : H1;
  const int W = lvl ? W2 : W1;

  // the tap gradients of all nine pixels: item i = (pixel, tap)
  const float* go = grad_out + static_cast<size_t>(e) * kOut + lvl;
  for (int i = threadIdx.x; i < kP2 * kTaps; i += kThreads) {
    const int p = i / kTaps, ty = (i % kTaps) / kD, tx = i % kD;
    const float2 c =
        reinterpret_cast<const float2*>(coords)[static_cast<size_t>(e) * kP2 +
                                                p];
    const float x = lvl ? c.x / 4.f : c.x;
    const float y = lvl ? c.y / 4.f : c.y;
    const float xf = floorf(x), yf = floorf(y);
    const int x0 = window_origin(xf, W), y0 = window_origin(yf, H);
    const int yy = y0 + ty, xx = x0 + tx;
    float v = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const float fx = x - xf, fy = y - yf;
      // output (dy, dx) blends taps (dy, dx), (dy, dx + 1), (dy + 1, dx),
      // (dy + 1, dx + 1); item [dx, dy, p] at ((dx * 7 + dy) * 9 + p) * 2
      auto g = [&](int dy, int dx) {
        return go[((dx * kd + dy) * kP2 + p) * 2];
      };
      if (ty < kd && tx < kd) v += (1.f - fx) * (1.f - fy) * g(ty, tx);
      if (ty < kd && tx >= 1) v += fx * (1.f - fy) * g(ty, tx - 1);
      if (ty >= 1 && tx < kd) v += (1.f - fx) * fy * g(ty - 1, tx);
      if (ty >= 1 && tx >= 1) v += fx * fy * g(ty - 1, tx - 1);
    }
    s_dtap[p][ty * kD + tx] = v;
    if (ty == 0 && tx == 0) {
      s_org[p][0] = x0;
      s_org[p][1] = y0;
    }
  }
  __syncthreads();

  const int ch = threadIdx.x;
  const size_t frame = static_cast<size_t>(j) * H * W * kC;
  const T* fm = (lvl ? fmap2 : fmap1) + frame + ch;
  float* dfm = (lvl ? dfmap2 : dfmap1) + frame + ch;
#pragma unroll 1
  for (int p = 0; p < kP2; ++p) {
    const size_t grow = (static_cast<size_t>(k) * kP2 + p) * kC + ch;
    const float g = load(gmap + grow);
    const int x0 = s_org[p][0], y0 = s_org[p][1];
    float dg = 0.f;
#pragma unroll 1
    for (int ty = 0; ty < kD; ++ty) {
      const int yy = y0 + ty;
      if (yy < 0 || yy >= H) continue;
#pragma unroll
      for (int tx = 0; tx < kD; ++tx) {
        const int xx = x0 + tx;
        if (xx < 0 || xx >= W) continue;
        const float dt = s_dtap[p][ty * kD + tx];
        const size_t off = (static_cast<size_t>(yy) * W + xx) * kC;
        dg += dt * load(fm + off);
        atomicAdd(dfm + off, dt * g);
      }
    }
    atomicAdd(dgmap + grow, dg);
  }
}

struct Args {
  const void *gmap, *fmap1, *fmap2, *coords, *kk, *jj, *grad_out;
  float *dgmap, *dfmap1, *dfmap2;
  int E, Ng, F, H1, W1, H2, W2;
};

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  corr_backward_kernel<T><<<2 * a.E, kThreads, 0, stream>>>(
      static_cast<const T*>(a.gmap), static_cast<const T*>(a.fmap1),
      static_cast<const T*>(a.fmap2), static_cast<const float*>(a.coords),
      static_cast<const int*>(a.kk), static_cast<const int*>(a.jj),
      static_cast<const float*>(a.grad_out), a.dgmap, a.dfmap1, a.dfmap2,
      a.Ng, a.F, a.H1, a.W1, a.H2, a.W2);
  return cudaGetLastError();
}

}  // namespace

// Enqueues the kernel on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on a successful launch). in_bf16 selects bf16 (1)
// or f32 (0) maps; the gradients are f32 either way.
extern "C" int corr_backward_launch(const void* gmap, const void* fmap1,
                                    const void* fmap2, const void* coords,
                                    const void* kk, const void* jj,
                                    const void* grad_out, void* dgmap,
                                    void* dfmap1, void* dfmap2, int E, int Ng,
                                    int F, int H1, int W1, int H2, int W2,
                                    int in_bf16, int device, void* stream) {
  if (E <= 0) return 0;
  // this library carries its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Args a{gmap,
               fmap1,
               fmap2,
               coords,
               kk,
               jj,
               grad_out,
               static_cast<float*>(dgmap),
               static_cast<float*>(dfmap1),
               static_cast<float*>(dfmap2),
               E,
               Ng,
               F,
               H1,
               W1,
               H2,
               W2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = in_bf16 ? launch<__nv_bfloat16>(a, s)
                                  : launch<float>(a, s);
  return static_cast<int>(err);
}
