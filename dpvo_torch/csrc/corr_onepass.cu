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
//   Edges e >= nv, or whose kk / jj is out of range, write exact zeros.
//
// Unlike the TPU kernel there is no window budget, no padded phase-pair
// slab and no block-contiguity assumption on kk: every edge names its own
// source row and target frame, and every tap is bounds-checked.
//
// bf16 maps (the MIXED_PRECISION path of config/default.yaml):
// corr_box_kernel. What bounds it is the traffic from L2 to the SMs: a
// window of 128-channel rows per (edge, pixel, level), 9 x 2 x 64 x 256 B =
// 295 KB per edge if every pixel read its own window, ~11.8 GB per call at
// E = 40,013 live edges -- 5-6x the rows that edge needs, since the nine
// windows of a patch overlap almost entirely (a patch's pixels share one
// inverse depth). The design reads each row once per edge and level:
//   * one 128-thread block per edge. Every warp reads the 9 coords, kk, jj
//     and nv itself and computes each level's union box -- the min / max of
//     the nine window origins, capped at kBox x kBox rows -- so the first
//     copies are issued before the block's first barrier and no per-edge
//     scalar is loaded after it;
//   * the g rows and a level's box rows are copied into shared memory with
//     cp.async (16 B, .cg); rows outside the map read as zero through the
//     copy's zero-fill form, which is where the border rule lives. Each
//     row's 16-byte chunks are swizzled by the row's parity, so the B-operand
//     reads below are free of bank conflicts;
//   * the tap dots run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulate; mma_bf16.cuh): the 9 g rows (padded to 16) against every
//     box position, ~1.9x the 9 x 64 dots needed, into f32 [9][box] in
//     shared memory;
//   * a pixel whose window does not fit the capped box (a spread of more
//     than kBox - 8 px at a level) takes the exact per-pixel loop from
//     global memory (window_taps, one warp per pixel) inside the same
//     kernel, into its own row of the taps;
//   * each thread blends its outputs from four taps and writes both levels
//     of one output with one store, in output order.
// The bytes staged per live edge are the g rows plus the two boxes,
// ~46-52 KB at small spreads (chip_smoke.py phase 3 prints them: ~2.0 GB
// per call at E = 40,013), read from L2, since the pairs are sorted by
// target frame (runtime/device_vo.py:_compact_pairs) and a frame's maps
// (4.9 MB + 0.3 MB at 640x480) stay there. What limits it is latency, not
// that rate: each block waits on a chain of its own loads, copies and
// barriers, so the kernel runs as fast as enough blocks overlap. Hence the
// two levels take turns in one box buffer (level 2's copy in flight during
// level 1's overflow pixels and blend), and one taps buffer serves both: 44
// KB a block, five blocks per SM. One box per level (91 KB, two blocks per
// SM, level 2's copy in flight during level 1's dots) ran slower on an H100
// (PERF.md).
//
// f32 maps (MIXED_PRECISION off, and the parity runs): corr_onepass_kernel,
// the first port of the TPU kernel, unchanged: one block per edge, one warp
// per patch pixel, every lane reading 4 channels of every tap of its
// pixel's window (coalesced 16-byte loads), a butterfly reduce-scatter of
// the 64 taps, f32 FMAs. The tensor cores take f32 only as TF32, which
// would miss the 1e-5 * max|plain| parity bound.
//
// Layout: gmap (Ng, 3, 3, 128), fmap1 (F, H1, W1, 128), fmap2 (F, H2, W2,
// 128), all channels-last and contiguous, bf16 or f32 (one dtype for all
// three); coords (E, 3, 3, 2) f32 [x, y] at level-1 scale; kk, jj (E,)
// int32; nv a device int32 scalar; out (E, 7, 7, 3, 3, 2) f32 or bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace corr_mma;   // kC, kP2, kRowU4, kChunks, GFrag, tile_mma, ...

constexpr int kR = 3;                      // radius
constexpr int kD = 2 * kR + 2;             // 8 integer taps per axis
constexpr int kTaps = kD * kD;             // 64
constexpr int kd = 2 * kR + 1;             // 7 outputs per axis
constexpr int kOut = kd * kd * kP2 * 2;    // 882 outputs per edge
constexpr int kThreads = 32 * kP2;         // f32: one warp per patch pixel

// bf16: the union box of a level is at most kBox x kBox rows
// (ops/corr_onepass.py:BOX states the same rule)
constexpr int kBox = 12;
constexpr int kBoxU4 = kBox * kBox * kRowU4;    // one box, in 16-byte words
constexpr int kBoxWarps = 4;
constexpr int kBoxThreads = 32 * kBoxWarps;
constexpr int kBoxTaps = kP2 * kBox * kBox;     // f32 taps [9][<= 144]
constexpr int kItems = kOut / 2;                // (dx, dy, pix): both levels
constexpr int kItemsPerThread = (kItems + kBoxThreads - 1) / kBoxThreads;
constexpr size_t kBoxSmem =
    (kBoxU4 + kP2 * kRowU4) * sizeof(uint4) + kBoxTaps * sizeof(float);
// an overflowing pixel's 64 taps go to its own row of the taps, which holds
// at least 8 x kBox positions whenever a pixel of the level overflows
static_assert(kD * kBox >= kTaps, "overflow taps fit a row of the taps");

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  // 4 bf16 = 8 bytes; bf16 -> f32 is exact (the high half of the word)
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// two adjacent outputs (both levels of one tap) in one store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The window origin on one axis: floor(v) - R, clamped first: past
// +-(dim + 16) every tap lies outside the map either way (NaN clamps too,
// to all-outside).
__device__ __forceinline__ int window_origin(float vf, int dim) {
  return static_cast<int>(fminf(fmaxf(vf, -16.f), dim + 16.f)) - kR;
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

// The 8 x 8 integer taps of one pixel's window at (x0, y0) of `frame`
// (H x W x 128), by one warp: lane l holds channels 4l .. 4l + 3 of the
// pixel's g row and reads them of every tap row; taps outside the map are
// 0. Lane l writes taps[2l], taps[2l + 1] (row-major ty * 8 + tx).
template <typename T>
__device__ __forceinline__ void window_taps(const float4 g, const T* frame,
                                            int H, int W, int x0, int y0,
                                            int lane, float* taps) {
  const T* base = frame + lane * 4;
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
        const float4 f = load4(base + (static_cast<size_t>(yy) * W + xx) * kC);
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
  taps[2 * lane] = acc[0];
  taps[2 * lane + 1] = acc[1];
}

// f32 maps: one warp per patch pixel, the whole window from global memory.
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
    window_taps(g, fm + static_cast<size_t>(j) * H * W * kC, H, W,
                window_origin(xf, W), window_origin(yf, H), lane,
                s_taps[pix]);
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

// ---- bf16 maps: union boxes in shared memory, dots on the tensor cores ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-byte chunk c of box row q: chunks swizzled by the row's parity, so the
// 8 lanes of one LDS.128 phase (rows q, q + 1; chunks 4c' + t) hit 8
// distinct bank groups
__device__ __forceinline__ int box_chunk(int q, int c) {
  return q * kRowU4 + (c ^ ((q & 1) << 2));
}

// The bw x bh rows of one level's box at (bx, by) of `frame`, row q =
// (q / bw, q % bw); rows outside the map are zero-filled by the copy.
__device__ __forceinline__ void stage_box(uint4* box, const bf16* frame,
                                          int H, int W, int bx, int by,
                                          int bw, int bh) {
  for (int i = threadIdx.x; i < bw * bh * kRowU4; i += kBoxThreads) {
    const int q = i / kRowU4, c = i % kRowU4;
    const int y = by + q / bw, x = bx + q % bw;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const bf16* src =
        in ? frame + (static_cast<size_t>(y) * W + x) * kC + c * 8 : frame;
    cp_async16(box + box_chunk(q, c), src, in ? 16 : 0);
  }
}

// Every position of a staged box dotted with the 9 g rows: tiles of 8
// positions dealt round-robin to the warps; taps f32 [9][8 * nt]. Positions
// past the box's bw * bh hold stale rows; their columns are never read.
__device__ __forceinline__ void box_tiles(const GFrag& a, const uint4* box,
                                          float* taps, int nt, int warp) {
  const int lane = threadIdx.x & 31, grp = lane >> 2, t = lane & 3;
  for (int tile = warp; tile < nt; tile += kBoxWarps) {
    const int q = tile * 8 + grp;
    uint4 b[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) b[c] = box[box_chunk(q, 4 * c + t)];
    float d[4];
    tile_mma(a, b, d);
    stage_tile(d, taps, 8 * nt, tile * 8);
  }
}

// Where the epilogue finds one (pixel, level)'s 8 x 8 taps: c[ty * stride
// + tx] in shared memory; (x0, y0) its window origin; (fx, fy) the
// fractional part of its coords.
struct PixTaps {
  float* c;
  int x0, y0, stride;
  float fx, fy;
};

// A level's union box at (bx, by), bw x bh rows, nt tiles of 8 positions.
struct Box {
  int bx, by, bw, bh, nt;
};

// One level's prologue, run by every warp on its own: the window origin of
// this lane's pixel (lanes 0-8; x, y its coords at this level's scale), the
// union box of the nine, capped at kBox x kBox, which pixels overflow it
// (*ovf, bit p), and the level's PixTaps (written by warp 0). Pixel p's
// taps are row p of taps ([9][8 * nt]): at its window's place in the box if
// it fits, else its own 8 x 8 from global memory at the row's start.
__device__ __forceinline__ Box level_box(float x, float y, int H, int W,
                                         float* taps, PixTaps* pix,
                                         unsigned* ovf) {
  const int lane = threadIdx.x & 31;
  const bool live = lane < kP2;
  const float xf = floorf(x);
  const float yf = floorf(y);
  const int x0 = window_origin(xf, W);
  const int y0 = window_origin(yf, H);
  const int bx = __reduce_min_sync(0xffffffffu, live ? x0 : 0x7fffffff);
  const int by = __reduce_min_sync(0xffffffffu, live ? y0 : 0x7fffffff);
  const int mx = __reduce_max_sync(0xffffffffu, live ? x0 : -0x7fffffff);
  const int my = __reduce_max_sync(0xffffffffu, live ? y0 : -0x7fffffff);
  const int bw = min(kBox, mx - bx + kD);
  const int bh = min(kBox, my - by + kD);
  const bool fits = x0 - bx <= kBox - kD && y0 - by <= kBox - kD;
  *ovf = __ballot_sync(0xffffffffu, live && !fits);
  const int nt = (bw * bh + 7) / 8;
  if (threadIdx.x < kP2)
    pix[lane] = PixTaps{
        taps + lane * 8 * nt + (fits ? (y0 - by) * bw + (x0 - bx) : 0), x0,
        y0, fits ? bw : kD, x - xf, y - yf};
  return Box{bx, by, bw, bh, nt};
}

// The taps of a level's overflowing pixels (bits of ovf), exact from
// global memory, one warp per pixel.
__device__ __forceinline__ void overflow_taps(unsigned ovf,
                                              const PixTaps* pix,
                                              const bf16* grow,
                                              const bf16* frame, int H,
                                              int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int idx = 0;
  for (unsigned m = ovf; m != 0; m &= m - 1, ++idx) {
    if (idx % kBoxWarps != warp) continue;
    const int p = __ffs(m) - 1;
    const float4 g = load4(grow + p * kC + lane * 4);
    window_taps(g, frame, H, W, pix[p].x0, pix[p].y0, lane, pix[p].c);
  }
}

// Output item i = (dx * 7 + dy) * 9 + pix of one level: the bilinear blend
// of four taps.
__device__ __forceinline__ float blend(const PixTaps* pix, int i) {
  const int p = i % kP2, dy = (i / kP2) % kd, dx = i / (kP2 * kd);
  const PixTaps px = pix[p];
  const float* c = px.c + dy * px.stride + dx;
  const float fx = px.fx, fy = px.fy;
  return (1.f - fx) * (1.f - fy) * c[0] + fx * (1.f - fy) * c[1] +
         (1.f - fx) * fy * c[px.stride] + fx * fy * c[px.stride + 1];
}

// The shared memory lets kBoxBlocks blocks share an SM; the registers are
// held to match (65,536 / (5 x 128) = 102 a thread).
constexpr int kBoxBlocks = 5;

template <typename OutT>
__global__ void __launch_bounds__(kBoxThreads, kBoxBlocks)
corr_box_kernel(const bf16* __restrict__ gmap, const bf16* __restrict__ fmap1,
                const bf16* __restrict__ fmap2,
                const float* __restrict__ coords, const int* __restrict__ kk,
                const int* __restrict__ jj, const int* __restrict__ nv_ptr,
                OutT* __restrict__ out, int Ng, int F, int H1, int W1, int H2,
                int W2) {
  extern __shared__ uint4 smem[];
  uint4* s_box = smem;                  // one level's box at a time
  uint4* s_g = smem + kBoxU4;
  float* s_taps = reinterpret_cast<float*>(s_g + kP2 * kRowU4);
  __shared__ PixTaps s_pix[2][kP2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.x;
  OutT* oe = out + static_cast<size_t>(e) * kOut;
  const int k = kk[e];
  const int j = jj[e];
  // this lane's patch pixel (lanes 0-8 of every warp)
  float cx = 0.f, cy = 0.f;
  if (lane < kP2) {
    const float2 c =
        reinterpret_cast<const float2*>(coords)[static_cast<size_t>(e) * kP2 +
                                                lane];
    cx = c.x;
    cy = c.y;
  }
  // block-uniform: every thread of the block takes the same branch
  if (e >= *nv_ptr || k < 0 || k >= Ng || j < 0 || j >= F) {
    for (int i = tid; i < kItems; i += kBoxThreads)
      store2(oe + 2 * i, 0.f, 0.f);
    return;
  }

  // the g rows and the level-1 box: one copy group
  const bf16* grow = gmap + static_cast<size_t>(k) * kP2 * kC;
  for (int i = tid; i < kP2 * kRowU4; i += kBoxThreads)
    cp_async16(s_g + i, grow + i * 8, 16);
  const bf16* frame1 = fmap1 + static_cast<size_t>(j) * H1 * W1 * kC;
  const bf16* frame2 = fmap2 + static_cast<size_t>(j) * H2 * W2 * kC;
  unsigned ovf1, ovf2;   // bit p: pixel p overflows the level's box
  const Box b1 = level_box(cx, cy, H1, W1, s_taps, s_pix[0], &ovf1);
  stage_box(s_box, frame1, H1, W1, b1.bx, b1.by, b1.bw, b1.bh);
  cp_async_commit();
  const Box b2 =
      level_box(cx / 4.f, cy / 4.f, H2, W2, s_taps, s_pix[1], &ovf2);
  cp_async_wait<0>();
  __syncthreads();

  box_tiles(load_gfrag(s_g), s_box, s_taps, b1.nt, warp);
  __syncthreads();      // the level-1 box is read: level 2's copy goes in
  stage_box(s_box, frame2, H2, W2, b2.bx, b2.by, b2.bw, b2.bh);
  cp_async_commit();
  overflow_taps(ovf1, s_pix[0], grow, frame1, H1, W1);
  __syncthreads();
  float v1[kItemsPerThread];
#pragma unroll
  for (int n = 0; n < kItemsPerThread; ++n) {
    const int i = tid + n * kBoxThreads;
    v1[n] = i < kItems ? blend(s_pix[0], i) : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();      // the level-2 box is in; level 1's taps are read

  // the A fragments again: not held in registers across level 1's
  // overflow loop
  box_tiles(load_gfrag(s_g), s_box, s_taps, b2.nt, warp);
  __syncthreads();
  overflow_taps(ovf2, s_pix[1], grow, frame2, H2, W2);
  __syncthreads();
  // out[e, dx, dy, pix, lvl]: both levels of item i in one store
#pragma unroll
  for (int n = 0; n < kItemsPerThread; ++n) {
    const int i = tid + n * kBoxThreads;
    if (i < kItems) store2(oe + 2 * i, v1[n], blend(s_pix[1], i));
  }
}

struct Args {
  const void *gmap, *fmap1, *fmap2, *coords, *kk, *jj, *nv;
  void* out;
  int E, Ng, F, H1, W1, H2, W2;
};

template <typename T, typename OutT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  corr_onepass_kernel<T, OutT><<<a.E, kThreads, 0, stream>>>(
      static_cast<const T*>(a.gmap), static_cast<const T*>(a.fmap1),
      static_cast<const T*>(a.fmap2), static_cast<const float*>(a.coords),
      static_cast<const int*>(a.kk), static_cast<const int*>(a.jj),
      static_cast<const int*>(a.nv), static_cast<OutT*>(a.out), a.Ng, a.F,
      a.H1, a.W1, a.H2, a.W2);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_box(const Args& a, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory only after opting in
  const cudaError_t attr = cudaFuncSetAttribute(
      corr_box_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBoxSmem));
  if (attr != cudaSuccess) return attr;
  corr_box_kernel<OutT><<<a.E, kBoxThreads, kBoxSmem, stream>>>(
      static_cast<const bf16*>(a.gmap), static_cast<const bf16*>(a.fmap1),
      static_cast<const bf16*>(a.fmap2), static_cast<const float*>(a.coords),
      static_cast<const int*>(a.kk), static_cast<const int*>(a.jj),
      static_cast<const int*>(a.nv), static_cast<OutT*>(a.out), a.Ng, a.F,
      a.H1, a.W1, a.H2, a.W2);
  return cudaGetLastError();
}

}  // namespace

// Enqueues the kernel on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on a successful launch). in_bf16 / out_bf16 select
// bf16 (1) or f32 (0); bf16 maps take corr_box_kernel, f32 maps
// corr_onepass_kernel.
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
  const Args a{gmap, fmap1, fmap2, coords, kk, jj, nv, out,
               E,    Ng,    F,     H1,     W1, H2, W2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16 && out_bf16)
    err = launch_box<bf16>(a, s);
  else if (in_bf16)
    err = launch_box<float>(a, s);
  else if (out_bf16)
    err = launch<float, bf16>(a, s);
  else
    err = launch<float, float>(a, s);
  return static_cast<int>(err);
}

// The launch shape of the kernel that (in_bf16, out_bf16) selects on CUDA
// device `device`: threads and shared memory per block (static + dynamic)
// and the blocks one SM holds at once. Returns a CUDA error code.
extern "C" int corr_onepass_occupancy(int in_bf16, int out_bf16, int device,
                                      int* threads, int* smem_bytes,
                                      int* blocks_per_sm) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const void* fn;
  int nthr;
  size_t dyn = 0;
  if (in_bf16) {
    fn = out_bf16 ? reinterpret_cast<const void*>(corr_box_kernel<bf16>)
                  : reinterpret_cast<const void*>(corr_box_kernel<float>);
    nthr = kBoxThreads;
    dyn = kBoxSmem;
    const cudaError_t attr = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kBoxSmem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  } else {
    fn = out_bf16
             ? reinterpret_cast<const void*>(corr_onepass_kernel<float, bf16>)
             : reinterpret_cast<const void*>(corr_onepass_kernel<float, float>);
    nthr = kThreads;
  }
  cudaFuncAttributes attrs;
  cudaError_t err = cudaFuncGetAttributes(&attrs, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, nthr,
                                                      dyn);
  *threads = nthr;
  *smem_bytes = static_cast<int>(attrs.sharedSizeBytes + dyn);
  return static_cast<int>(err);
}
