// Two-level local patch correlation for DPVO, hand-written for Hopper
// (sm_90a). Built with nvcc into a shared library with a plain C entry and
// bound from Python with ctypes (dpvo_torch/ops/corr_onepass.py).
//
// Replaces the TPU kernel dpvo_tpu/ops/corr_onepass.py:_onepass_kernel (the
// Pallas call of _onepass_call). It computes what dpvo_torch/ops/corr.py
// computes for both pyramid levels in one launch:
//
//   for each edge e < nv and each patch pixel (py, px), at level L1
//   (fmap1, coords) and L2 (fmap2, coords / 4):
//     c[ty][tx] = sum_ch gmap[kk[e], py, px, ch] *
//                        fmap[jj[e], y0 + ty, x0 + tx, ch]     (0 outside)
//     with (x0, y0) = floor(coords) - 3 and ty, tx in [0, 8);
//     out[e, dx, dy, py, px, lvl] = bilinear blend of the four taps
//     c[dy][dx], c[dy][dx+1], c[dy+1][dx], c[dy+1][dx+1] by frac(coords).
//   Edges e >= nv write exact zeros.
//
// Unlike the TPU kernel there is no window budget, no padded phase-pair
// slab and no block-contiguity assumption on kk: every edge names its own
// source row and target frame, and every tap is bounds-checked.
//
// What bounds it. Each (edge, pixel, level) reads an 8 x 8 window of
// 128-channel rows: E * 9 * 2 * 64 * 256 B = ~14.5 GB per call at the
// 640x480 default (E = 49,152, bf16 maps) before any cache reuse, for
// ~14.5 GFLOP of f32 dot products -- 1 FLOP per byte, far below what the
// card's FMA units could use per byte of device memory: a memory / L2
// bound kernel unless the windows come from cache. The design
// leans on reuse instead of bandwidth: one block handles one edge, its nine
// warps (one per patch pixel) read windows that overlap almost entirely,
// so most window rows come from L1; consecutive blocks share the target
// frame (pairs are sorted by target, runtime/device_vo.py:_compact_pairs),
// so the frame's two maps (4.9 MB + 0.3 MB at 640x480) stay in L2.
// Loads are coalesced: a warp reads each 256 B row as 32 x 8 B (bf16).
// wgmma / TMA staging of the window are left for later work.
//
// Layout: gmap (Ng, 3, 3, 128), fmap1 (F, H1, W1, 128), fmap2 (F, H2, W2,
// 128), all channels-last and contiguous, bf16 or f32 (one dtype for all
// three); coords (E, 3, 3, 2) f32 [x, y] at level-1 scale; kk, jj (E,)
// int32; nv a device int32 scalar; out (E, 7, 7, 3, 3, 2) f32 or bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;                    // channels
constexpr int kP2 = 9;                     // 3 x 3 patch pixels
constexpr int kR = 3;                      // radius
constexpr int kD = 2 * kR + 2;             // 8 integer taps per axis
constexpr int kTaps = kD * kD;             // 64
constexpr int kd = 2 * kR + 1;             // 7 outputs per axis
constexpr int kOut = kd * kd * kP2 * 2;    // 882 outputs per edge
constexpr int kThreads = 32 * kP2;         // one warp per patch pixel

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // 4 bf16 = 8 bytes; bf16 -> f32 is exact (the high half of the word)
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One butterfly step of a warp reduce-scatter: lanes with bit `Off` set keep
// the upper half of `acc`, the others the lower half, and each adds the
// partner lane's copy of the half it keeps. After the steps for Off = 16, 8,
// 4, 2, 1 lane l holds the warp-wide sums of taps 2l and 2l+1 in acc[0..1].
template <int Half, int Off>
__device__ __forceinline__ void reduce_step(float* acc, int lane) {
  const bool upper = (lane & Off) != 0;
#pragma unroll
  for (int i = 0; i < Half; ++i) {
    const float send = upper ? acc[i] : acc[i + Half];
    const float keep = upper ? acc[i + Half] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, Off);
  }
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads)
corr_onepass_kernel(const T* __restrict__ gmap, const T* __restrict__ fmap1,
                    const T* __restrict__ fmap2,
                    const float* __restrict__ coords,
                    const int* __restrict__ kk, const int* __restrict__ jj,
                    const int* __restrict__ nv_ptr, OutT* __restrict__ out,
                    int Ng, int F, int H1, int W1, int H2, int W2) {
  __shared__ float s_taps[kP2][kTaps];
  __shared__ float s_out[kOut];

  const int e = blockIdx.x;
  OutT* oe = out + static_cast<size_t>(e) * kOut;
  const int k = kk[e];
  const int j = jj[e];
  // block-uniform: every thread of the block takes the same branch
  if (e >= *nv_ptr || k < 0 || k >= Ng || j < 0 || j >= F) {
    for (int i = threadIdx.x; i < kOut; i += kThreads) store(oe + i, 0.f);
    return;
  }

  const int pix = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float cx = coords[(static_cast<size_t>(e) * kP2 + pix) * 2 + 0];
  const float cy = coords[(static_cast<size_t>(e) * kP2 + pix) * 2 + 1];
  const float4 g =
      load4(gmap + (static_cast<size_t>(k) * kP2 + pix) * kC + lane * 4);

#pragma unroll 1
  for (int lvl = 0; lvl < 2; ++lvl) {
    const T* fm = lvl ? fmap2 : fmap1;
    const int H = lvl ? H2 : H1;
    const int W = lvl ? W2 : W1;
    const float x = lvl ? cx / 4.f : cx;
    const float y = lvl ? cy / 4.f : cy;
    const float xf = floorf(x);
    const float yf = floorf(y);
    // clamp before the int conversion: past +-(dim + 16) every tap lies
    // outside the map either way (NaN clamps too, to all-outside)
    const int x0 = static_cast<int>(fminf(fmaxf(xf, -16.f), W + 16.f)) - kR;
    const int y0 = static_cast<int>(fminf(fmaxf(yf, -16.f), H + 16.f)) - kR;
    const T* base = fm + static_cast<size_t>(j) * H * W * kC + lane * 4;

    float acc[kTaps];
#pragma unroll
    for (int ty = 0; ty < kD; ++ty) {
      const int yy = y0 + ty;
      const bool yin = yy >= 0 && yy < H;
#pragma unroll
      for (int tx = 0; tx < kD; ++tx) {
        const int xx = x0 + tx;
        float v = 0.f;
        if (yin && xx >= 0 && xx < W) {
          const float4 f =
              load4(base + (static_cast<size_t>(yy) * W + xx) * kC);
          v = g.x * f.x + g.y * f.y + g.z * f.z + g.w * f.w;
        }
        acc[ty * kD + tx] = v;
      }
    }
    reduce_step<32, 16>(acc, lane);
    reduce_step<16, 8>(acc, lane);
    reduce_step<8, 4>(acc, lane);
    reduce_step<4, 2>(acc, lane);
    reduce_step<2, 1>(acc, lane);
    s_taps[pix][2 * lane] = acc[0];
    s_taps[pix][2 * lane + 1] = acc[1];
    __syncwarp();

    const float fx = x - xf;
    const float fy = y - yf;
    for (int o = lane; o < kd * kd; o += 32) {
      const int dy = o / kd;
      const int dx = o % kd;
      const float* c = &s_taps[pix][dy * kD + dx];
      const float v = (1.f - fx) * (1.f - fy) * c[0] + fx * (1.f - fy) * c[1] +
                      (1.f - fx) * fy * c[kD] + fx * fy * c[kD + 1];
      s_out[((dx * kd + dy) * kP2 + pix) * 2 + lvl] = v;
    }
    __syncwarp();   // s_taps[pix] is rewritten by the next level
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kOut; i += kThreads) store(oe + i, s_out[i]);
}

template <typename T, typename OutT>
void launch(const void* gmap, const void* fmap1, const void* fmap2,
            const void* coords, const void* kk, const void* jj,
            const void* nv, void* out, int E, int Ng, int F, int H1, int W1,
            int H2, int W2, cudaStream_t stream) {
  corr_onepass_kernel<T, OutT><<<E, kThreads, 0, stream>>>(
      static_cast<const T*>(gmap), static_cast<const T*>(fmap1),
      static_cast<const T*>(fmap2), static_cast<const float*>(coords),
      static_cast<const int*>(kk), static_cast<const int*>(jj),
      static_cast<const int*>(nv), static_cast<OutT*>(out), Ng, F, H1, W1,
      H2, W2);
}

}  // namespace

// Enqueues the kernel on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on a successful launch). in_bf16 / out_bf16 select
// bf16 (1) or f32 (0).
extern "C" int corr_onepass_launch(const void* gmap, const void* fmap1,
                                   const void* fmap2, const void* coords,
                                   const void* kk, const void* jj,
                                   const void* nv, void* out, int E, int Ng,
                                   int F, int H1, int W1, int H2, int W2,
                                   int in_bf16, int out_bf16, int device,
                                   void* stream) {
  if (E <= 0) return 0;
  // this library carries its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(gmap, fmap1, fmap2, coords, kk, jj,
                                         nv, out, E, Ng, F, H1, W1, H2, W2, s);
  else if (in_bf16)
    launch<__nv_bfloat16, float>(gmap, fmap1, fmap2, coords, kk, jj, nv, out,
                                 E, Ng, F, H1, W1, H2, W2, s);
  else if (out_bf16)
    launch<float, __nv_bfloat16>(gmap, fmap1, fmap2, coords, kk, jj, nv, out,
                                 E, Ng, F, H1, W1, H2, W2, s);
  else
    launch<float, float>(gmap, fmap1, fmap2, coords, kk, jj, nv, out, E, Ng,
                         F, H1, W1, H2, W2, s);
  return static_cast<int>(cudaGetLastError());
}
