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
// Design: target tiles over binned edges. The map gradients are summed by
// the one block that owns each tile and written once, so no global atomic
// touches dfmap1 or dfmap2. Three kernels on one stream, no host
// synchronize:
//   1. bw_prep, one warp per edge, lane = (level, pixel): the nine window
//      origins and fractions, K1's union box (corr_onepass.py:_level_boxes)
//      and which pixels fit it (box_fits: origin - box corner <= 4 on both
//      axes), in one 128-byte record per level. An edge level adds nothing,
//      and is dropped here, when kk or jj is out of range, when its 441
//      output-gradient values are all zero (exact: it adds 0 x finite map
//      values; the trainer's backward edge dropout makes 80% of them so),
//      and, pixel by pixel, where a window has no tap in the map. A live
//      level's 9 x 64 tap gradients (the output gradient spread bilinearly
//      onto the taps, K1's blend transposed, zero outside the map) go to
//      the scratch. An edge with a pixel left gets the frame key jj, else
//      -1; the frames' counts by atomics (counts do not depend on order).
//   2. bw_frames, one block per frame: the frame's edges in edge order
//      (ballots in runs of the keys, then a block scan: the same list from
//      run to run), with both levels' record heads beside them.
//   3. bw_tiles, one 256-thread block per tile of TH x TW map positions of
//      one frame at one level (the shapes are arguments; level-2 tiles
//      first). The block stages the map tile with
//      cp.async and walks its frame's list in rounds of 4 x 256 edges, the
//      heads read coalesced: each edge makes the tile's entries, the box
//      entry (its fitting pixels over the bounding box of their windows, a
//      part of K1's union box) where that box meets the tile, and one
//      entry per overflow pixel whose own 8 x 8 window meets it; a block
//      scan packs them in list order into a batch of at most 256 (a round
//      ends at the first edge whose entries do not fit; the next starts
//      there). Entries are pipelined with one barrier each: in the step of
//      entry i the block copies entry i + 3 (record, tap gradients, 9 g
//      rows; 4 slots), builds entry i + 1's rows of tap gradients at its
//      positions in the tile (items (position, pixel) dealt to all
//      threads) and sums entry i.
//      - bf16 maps, on the tensor cores (mma.sync m16n8k16, f32
//        accumulate): the tap gradients as bf16 hi + lo (exact to 2^-16),
//        warp w holds channels 16 w .. + 15 and every position; per m16
//        tile of the entry's positions the df product (hi + lo) x G is
//        formed from zero and added once, in f32, to the block's shared
//        f32 accumulator (a running sum in C would be added with the
//        tensor cores' truncating alignment at every entry), and the dg
//        product (hi + lo)^T x F (A transposed in registers by movmatrix)
//        is summed over the entry's positions in the C fragments.
//      - f32 maps, on the CUDA cores: warp (pg, cs) takes channels
//        32 cs .. + 31 of positions 8 i + 4 pg + lane / 8, four channels
//        a lane; acc[q] += sum_p dtq[q][p] g[p], dg[p] += dtq[q][p] f[q]
//        (pixels with no tap at the warp's 4 positions skipped), dg
//        reduced over the positions by shuffles and over the 2 position
//        groups in shared memory.
//      dg goes to dgmap[kk] with one f32 atomic (a float4 on the tensor
//      path) per (entry, pixel with a tap in the tile, channel). Last, the
//      block writes its tile of dfmap once, in the maps' dtype, with plain
//      stores; tiles that no edge touches are written as zeros, so the
//      gradients need no fill.
//
// Which sums are deterministic: dfmap1 and dfmap2 are. Each position's
// channel is owned by one thread of one block, which adds the entries in
// frame-list order, each entry's terms in a fixed order, so the result is
// bit-identical from run to run. dgmap is not: its f32 atomics from
// different tiles arrive in an order that changes.
//
// What bounds it: per entry (an edge's box or overflow pixel in one tile,
// ~35 positions) a barrier step of the whole block: the build, the shared
// accumulator's read-modify-write (1 KB a position) and the dependent
// shared loads and mma of the sum, with 2 blocks (16 warps) an SM; the
// dgmap atomics; the record and tap-gradient pass. PERF.md has its time
// beside its bound.
//
// Layout: gmap (Ng, 3, 3, 128), fmap1 (F, H1, W1, 128), fmap2 (F, H2, W2,
// 128), all channels-last and contiguous, bf16 or f32 (one dtype); coords
// (E, 3, 3, 2) f32 [x, y] at level-1 scale; kk, jj (E,) int32; grad_out
// (E, 7, 7, 3, 3, 2) f32 [dx, dy, py, px, lvl]; dgmap f32 (Ng, 3, 3, 128),
// zeroed by the caller; dfmap1, dfmap2 in the maps' shapes and dtype,
// written whole by the kernel; scratch as corr_backward_plan sizes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kR = 3;                    // radius
constexpr int kD = 2 * kR + 2;           // 8 integer taps per axis
constexpr int kd = 2 * kR + 1;           // 7 outputs per axis
constexpr int kP2 = 9;                   // patch pixels
constexpr int kC = 128;                  // channels
constexpr int kGo = kd * kd * kP2;       // 441 output values per level
constexpr int kOut = kGo * 2;            // 882 outputs per edge
constexpr int kTaps = kP2 * kD * kD;     // 576 tap gradients per level
constexpr int kBox = 12;                 // K1's union box side cap (kBox)
constexpr int kFit = kBox - kD;          // a window fits at <= 4 from the corner
constexpr int kQS = 12;                  // floats per dtq row (9 used)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCap = 256;                // entries per batch
constexpr int kScan = 4;                 // frame-list edges a thread tests
constexpr int kSlots = 4;                // copy slots: entries 3 ahead
constexpr int kBoxCode = 15;             // an entry's code: box, or pixel p
constexpr int kPrepThreads = 256;
constexpr int kFrameThreads = 1024;
constexpr int kMaxSmem = 232448;         // a block's shared memory limit

// One (edge, level): 128 bytes, copied whole with cp.async.
struct __align__(16) Rec {
  short x0, x1, y0, y1;   // the box entry's positions [x0, x1) x [y0, y1)
  int masks;              // bits 0-8 the box entry's pixels, 9-17 the
                          // overflow pixels (each with a tap in the map)
  int kk;
  short2 org[kP2];        // window origins (x0, y0)
  float2 frac[kP2];       // fractions (fx, fy)
};
static_assert(sizeof(Rec) == 128, "Rec is copied as 8 chunks of 16 bytes");

// K1's window origin on one axis (csrc/corr_onepass.cu:window_origin)
__device__ __forceinline__ int window_origin(float vf, int dim) {
  return static_cast<int>(fminf(fmaxf(vf, -16.f), dim + 16.f)) - kR;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block's exclusive scan of v (NW warps); *total the sum.
template <int NW>
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
    int w = lane < NW ? tmp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < NW) tmp[lane] = w;
  }
  __syncthreads();
  const int out = x - v + (warp ? tmp[warp - 1] : 0);
  *total = tmp[NW - 1];
  __syncthreads();
  return out;
}

// ---- 1. the records ----

__global__ void __launch_bounds__(kPrepThreads)
bw_prep(const float* __restrict__ coords, const int* __restrict__ kk,
        const int* __restrict__ jj, const float* __restrict__ go,
        Rec* __restrict__ rec, float* __restrict__ dt, int* __restrict__ key,
        int* __restrict__ fcnt, int E, int Ng, int F, int H1, int W1, int H2,
        int W2) {
  const int lane = threadIdx.x & 31;
  const int e = (blockIdx.x * kPrepThreads + threadIdx.x) >> 5;
  if (e >= E) return;   // warp-uniform
  const int k = kk[e], j = jj[e];
  const bool ok = k >= 0 && k < Ng && j >= 0 && j < F;
  // any nonzero (or NaN) output gradient at each level
  bool nz0 = false, nz1 = false;
  const float2* g2 =
      reinterpret_cast<const float2*>(go) + static_cast<size_t>(e) * kGo;
  for (int i = lane; i < kGo; i += 32) {
    const float2 v = g2[i];
    nz0 |= v.x != 0.f;
    nz1 |= v.y != 0.f;
  }
  nz0 = __any_sync(0xffffffffu, nz0);
  nz1 = __any_sync(0xffffffffu, nz1);
  // lane l: level l / 16, pixel l % 16 (pixels 0-8; the union box and
  // masks by shuffles and ballots within each half of the warp)
  const int lvl = lane >> 4, p = lane & 15;
  const bool px = p < kP2;
  const int H = lvl ? H2 : H1, W = lvl ? W2 : W1;
  const float2* c =
      reinterpret_cast<const float2*>(coords) + static_cast<size_t>(e) * kP2;
  const float2 v2 = c[px ? p : 0];
  const float x = lvl ? v2.x / 4.f : v2.x, y = lvl ? v2.y / 4.f : v2.y;
  const float xf = floorf(x), yf = floorf(y);
  const int ox = window_origin(xf, W), oy = window_origin(yf, H);
  auto half_min = [](int v) {
#pragma unroll
    for (int d = 1; d < 16; d <<= 1)
      v = min(v, __shfl_xor_sync(0xffffffffu, v, d));
    return v;
  };
  // K1's union box corner over all nine pixels, NaN and far-off ones too
  const int bx = half_min(px ? ox : INT_MAX), by = half_min(px ? oy : INT_MAX);
  const bool inmap = px && ox < W && ox + kD > 0 && oy < H && oy + kD > 0;
  const bool lv = ok && (lvl ? nz1 : nz0);
  const bool fit = ox - bx <= kFit && oy - by <= kFit;
  const bool boxed = lv && inmap && fit;
  const unsigned bmb = __ballot_sync(0xffffffffu, boxed);
  const unsigned omb = __ballot_sync(0xffffffffu, lv && inmap && !fit);
  // the box entry's rectangle: the fitting windows' bounding box, clipped
  const int x0 = half_min(boxed ? ox : INT_MAX);
  const int y0 = half_min(boxed ? oy : INT_MAX);
  const int x1 = -half_min(boxed ? -(ox + kD) : INT_MAX);
  const int y1 = -half_min(boxed ? -(oy + kD) : INT_MAX);
  const int bmask = (bmb >> (16 * lvl)) & 0x1ff;
  const int omask = (omb >> (16 * lvl)) & 0x1ff;
  Rec* r = rec + static_cast<size_t>(lvl) * E + e;
  if (px) {
    r->org[p] = make_short2(static_cast<short>(ox), static_cast<short>(oy));
    r->frac[p] = make_float2(x - xf, y - yf);
  }
  if (p == 0) {
    int4 h;
    h.x = bmask ? (max(x0, 0) & 0xffff) | (min(x1, W) << 16) : 0;
    h.y = bmask ? (max(y0, 0) & 0xffff) | (min(y1, H) << 16) : 0;
    h.z = bmask | omask << kP2;
    h.w = k;
    *reinterpret_cast<int4*>(r) = h;
  }
  const bool live0 = ((bmb | omb) & 0x1ffu) != 0;
  const bool live1 = ((bmb | omb) & (0x1ffu << 16)) != 0;
  const unsigned b = (live0 ? 1u : 0u) | (live1 ? 2u : 0u);
  if (lane == 0) {
    const bool any = b != 0;
    key[e] = any ? j : -1;
    if (any) atomicAdd(fcnt + j, 1);
  }
  // a live level's tap gradients dt[p][ty][tx]: the output gradient spread
  // bilinearly onto each pixel's 8 x 8 taps, zero outside the map
  const float* ge = go + static_cast<size_t>(e) * kOut;
#pragma unroll 1
  for (int l = 0; l < 2; ++l) {
    if (!((b >> l) & 1)) continue;
    const int Hl = l ? H2 : H1, Wl = l ? W2 : W1;
    float* out = dt + (static_cast<size_t>(l) * E + e) * kTaps;
    // per pixel (from its lane) its window and fractions, then lane t
    // takes taps (ty, tx) = (t / 8 + 4 h, t % 8), h = 0, 1
#pragma unroll 1
    for (int q = 0; q < kP2; ++q) {
      const int src = 16 * l + q;
      const int oyq = __shfl_sync(0xffffffffu, oy, src);
      const int oxq = __shfl_sync(0xffffffffu, ox, src);
      const float fx = __shfl_sync(0xffffffffu, x - xf, src);
      const float fy = __shfl_sync(0xffffffffu, y - yf, src);
      const float w00 = (1.f - fx) * (1.f - fy), w01 = fx * (1.f - fy);
      const float w10 = (1.f - fx) * fy, w11 = fx * fy;
      // item [dx, dy, p, lvl] at ((dx * 7 + dy) * 9 + p) * 2 + lvl
      const float* gp = ge + q * 2 + l;
      auto g = [&](int dy, int dx) { return gp[(dx * kd + dy) * kP2 * 2]; };
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ty = (lane >> 3) + 4 * hh, tx = lane & 7;
        const int yy = oyq + ty, xx = oxq + tx;
        // output (dy, dx) blends taps (dy, dx), (dy, dx + 1), (dy + 1,
        // dx), (dy + 1, dx + 1)
        float v = 0.f;
        if (yy >= 0 && yy < Hl && xx >= 0 && xx < Wl) {
          if (ty < kd && tx < kd) v += w00 * g(ty, tx);
          if (ty < kd && tx >= 1) v += w01 * g(ty, tx - 1);
          if (ty >= 1 && tx < kd) v += w10 * g(ty - 1, tx);
          if (ty >= 1 && tx >= 1) v += w11 * g(ty - 1, tx - 1);
        }
        out[q * 64 + ty * kD + tx] = v;
      }
    }
  }
}

// ---- 2. the frame lists ----

// Per frame its edges in edge order (list) and, at the same places, both
// levels' record heads (box, masks, kk), so that a tile reads its frame's
// heads coalesced.
__global__ void __launch_bounds__(kFrameThreads)
bw_frames(const int* __restrict__ key, const int* __restrict__ fcnt,
          const Rec* __restrict__ rec, int* __restrict__ fstart,
          int* __restrict__ list, int4* __restrict__ lhead, int E) {
  __shared__ int tmp[32];
  const int f = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = 0;
  for (int i = threadIdx.x; i < f; i += kFrameThreads) s += fcnt[i];
  int base;
  block_excl_scan<kFrameThreads / 32>(s, tmp, &base);
  // warp w takes a run of the keys: its frame-f edges, then their places
  // after the runs before it, in edge order
  const int seg = ((E + 31) / 32 + 31) / 32 * 32;
  const int lo = warp * seg, hi = min(E, lo + seg);
  int n = 0;
  for (int e = lo + lane; e - lane < hi; e += 32)
    n += __popc(__ballot_sync(0xffffffffu, e < hi && key[e] == f));
  int total;
  const int before = block_excl_scan<kFrameThreads / 32>(
      lane == 0 ? n : 0, tmp, &total);
  int o = base + __shfl_sync(0xffffffffu, before, 0);
  const unsigned below = (1u << lane) - 1u;
  for (int e = lo + lane; e - lane < hi; e += 32) {
    const bool flag = e < hi && key[e] == f;
    const unsigned m = __ballot_sync(0xffffffffu, flag);
    if (flag) {
      const int at = o + __popc(m & below);
      list[at] = e;
      lhead[at] = *reinterpret_cast<const int4*>(rec + e);
      lhead[E + at] = *reinterpret_cast<const int4*>(rec + E + e);
    }
    o += __popc(m);
  }
  if (threadIdx.x == 0) fstart[f] = base;
}

// ---- 3. the tiles ----

struct TileArgs {
  const void* gmap;
  const void* fmap[2];
  const float* dt;     // [level][edge][kTaps] tap gradients
  const Rec* rec;
  const int *fstart, *fcnt, *list;
  const int4* lhead;   // [level][list position] record heads
  float* dgmap;
  void* dfmap[2];
  int4* stats;   // per block: box entries, pixel entries, dg pixels, batches
  int E, tp, qmax;   // positions of the largest tile, of an entry at most
  int H[2], W[2], TH[2], TW[2], NTY[2], NTX[2], nt[2];
};

// bf16 maps sum on the tensor cores (mma.sync m16n8k16, f32 accumulate),
// f32 maps on the CUDA cores
template <typename T>
struct OnMma : std::is_same<T, bf16> {};

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// a dtq buffer's bytes: f32 maps qmax rows of kQS floats; bf16 maps the
// 16-padded rows' bf16 hi and lo parts (24 halves a row: ldmatrix reads
// 8 rows without bank conflicts) and each row's tile position
__host__ __device__ constexpr size_t dtq_bytes(int qmax, bool mma) {
  return mma ? static_cast<size_t>(round16(qmax)) * (2 * 48 + 4)
             : static_cast<size_t>(qmax) * kQS * 4;
}

// Shared memory: the f32 accumulator and the map tile (tp positions each;
// bf16 maps a zero row after it), two dtq buffers, kSlots copy slots
// (record, tap gradients, g rows), two halves of dg (f32 maps), the batch
// and a few words.
__host__ __device__ constexpr size_t tile_smem(int tp, int qmax, int elem) {
  return static_cast<size_t>(tp) * kC * (4 + elem)             // acc, tile
         + (elem == 2 ? kC * 2 : 0)                            // zero row
         + 2 * dtq_bytes(qmax, elem == 2)                      // dtq
         + kSlots * (sizeof(Rec) + kTaps * 4 + kP2 * kC * elem)    // slots
         + (elem == 2 ? 0 : 2 * kP2 * kC * 4)                  // dg halves
         + kCap * 8                                            // batch
         + 96 * 4;                                             // geo, scan
}

// the positions of an entry in a tile of TH x TW at most
__host__ __device__ constexpr int entry_positions(int TH, int TW) {
  return (TH < kBox ? TH : kBox) * (TW < kBox ? TW : kBox);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t movmatrix_t(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// bf16 maps: the 16-byte chunk c (of 16) of tile position t's map row,
// swizzled by t & 7 so that 8 rows read at one column (an ldmatrix) hit 8
// bank groups, and the 8-byte pair c (of 64) of its accumulator row,
// whose chunk pairs are swizzled by t & 3, so that the 32 bytes of 4 rows
// (a C fragment's half) hit 8 bank groups
__device__ __forceinline__ int ft_chunk(int t, int c) { return c ^ (t & 7); }
__device__ __forceinline__ int acc_pair(int t, int c) {
  return c ^ ((t & 3) << 2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bw_tiles(const TileArgs a) {
  constexpr bool kMma = OnMma<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tp = a.tp, qmax = a.qmax;
  float* acc = reinterpret_cast<float*>(smem);                   // [tp][kC]
  T* ft = reinterpret_cast<T*>(acc + static_cast<size_t>(tp) * kC);
  unsigned char* zrow = reinterpret_cast<unsigned char*>(
      ft + static_cast<size_t>(tp) * kC);                        // bf16 only
  unsigned char* dtqb = zrow + (kMma ? kC * 2 : 0);              // [2]
  const size_t dtqs = dtq_bytes(qmax, kMma);
  Rec* recs = reinterpret_cast<Rec*>(dtqb + 2 * dtqs);           // [kSlots]
  float* dts = reinterpret_cast<float*>(recs + kSlots);   // [kSlots][kTaps]
  T* gs = reinterpret_cast<T*>(dts + kSlots * kTaps);    // [kSlots][9 kC]
  float* dgx = reinterpret_cast<float*>(gs + kSlots * kP2 * kC);  // f32 maps
  int2* batch = reinterpret_cast<int2*>(dgx + (kMma ? 0 : 2 * kP2 * kC));
  int4* geo = reinterpret_cast<int4*>(batch + kCap);             // [2]
  int* misc = reinterpret_cast<int*>(geo + 2);   // [0, 8) scan, [8] cut,
                                                 // [9] nb,
                                                 // [16, 80) scan totals

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int b = blockIdx.x, L = 1;
  if (b >= a.nt[1]) {
    b -= a.nt[1];
    L = 0;
  }
  const int tile = b;
  const int H = a.H[L], W = a.W[L], ntx = a.NTX[L];
  const int per = a.NTY[L] * ntx;
  const int f = tile / per, r = tile - f * per;
  const int ty0 = (r / ntx) * a.TH[L], tx0 = (r % ntx) * a.TW[L];
  const int th = min(a.TH[L], H - ty0), tw = min(a.TW[L], W - tx0);
  const int ty1 = ty0 + th, tx1 = tx0 + tw, np = th * tw;
  const size_t frame = static_cast<size_t>(f) * H * W;
  const T* gm = static_cast<const T*>(a.gmap);
  const int first = a.fstart[f], nedges = a.fcnt[f];
  const Rec* rec = a.rec + static_cast<size_t>(L) * a.E;
  const int4* lhead = a.lhead + static_cast<size_t>(L) * a.E;

  for (int i = threadIdx.x; i < np * (kC / 4); i += kThreads)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kMma) {
    // the zero row and both dtq buffers (pixels 9-15 of a row stay zero)
    for (int i = threadIdx.x; i < (kC * 2 + 2 * dtqs) / 16; i += kThreads)
      reinterpret_cast<uint4*>(zrow)[i] = make_uint4(0, 0, 0, 0);
  }
  if (nedges > 0) {
    constexpr int kChunks = kC * static_cast<int>(sizeof(T)) / 16;
    const T* fm = static_cast<const T*>(a.fmap[L]) + frame * kC;
    for (int i = threadIdx.x; i < np * kChunks; i += kThreads) {
      const int q = i / kChunks, c = i - q * kChunks;
      const int y = ty0 + q / tw, x = tx0 + q % tw;
      const int cs = kMma ? ft_chunk(q, c) : c;
      cp16(reinterpret_cast<char*>(ft + q * kC) + cs * 16,
           reinterpret_cast<const char*>(fm + (static_cast<size_t>(y) * W +
                                               x) * kC) + c * 16);
    }
  }
  cp_commit();

  // an entry's record, tap gradients and g rows into slot sl (one commit
  // group per call, empty for n < 0); bf16 maps: chunk c of g row p at
  // c ^ (p & 7), so that the 8 rows of an ldmatrix hit 8 bank groups
  auto prefetch = [&](int n, int sl) {
    if (n >= 0) {
      const int2 en = batch[n];
      const int e = en.x >> 4;
      if (threadIdx.x < 8)
        cp16(reinterpret_cast<char*>(recs + sl) + 16 * threadIdx.x,
             reinterpret_cast<const char*>(rec + e) + 16 * threadIdx.x);
      const char* d0 = reinterpret_cast<const char*>(
          a.dt + (static_cast<size_t>(L) * a.E + e) * kTaps);
      for (int i = threadIdx.x; i < kTaps / 4; i += kThreads)
        cp16(reinterpret_cast<char*>(dts + sl * kTaps) + 16 * i, d0 + 16 * i);
      constexpr int kRow = kC * static_cast<int>(sizeof(T)) / 16;
      const char* src = reinterpret_cast<const char*>(
          gm + static_cast<size_t>(en.y) * kP2 * kC);
      char* dst = reinterpret_cast<char*>(gs + sl * kP2 * kC);
      for (int i = threadIdx.x; i < kP2 * kRow; i += kThreads) {
        const int pr = i / kRow, c = i - pr * kRow;
        cp16(dst + 16 * (pr * kRow + (kMma ? c ^ (pr & 7) : c)),
             src + 16 * i);
      }
    }
    cp_commit();
  };

  // entry n's tap gradients at its positions into dtq buffer db, and its
  // geometry (positions, pixels with a tap, kk) into geo[db]. The items
  // (position q, pixel p) are dealt to all threads, so that no warp
  // carries the build alone; bf16 maps write the rows up to the next 16,
  // as zeros past the entry's positions (pixels 9-15 stay zero from the
  // start).
  int n_box = 0, n_px = 0, n_dg = 0, n_batch = 0;
  auto build = [&](int n, int sl, int db) {
    const int2 en = batch[n];
    const int code = en.x & 15;
    const Rec& R = recs[sl];
    int mask, rx0, rx1, ry0, ry1;
    if (code == kBoxCode) {
      mask = R.masks & 0x1ff;
      rx0 = max(static_cast<int>(R.x0), tx0);
      rx1 = min(static_cast<int>(R.x1), tx1);
      ry0 = max(static_cast<int>(R.y0), ty0);
      ry1 = min(static_cast<int>(R.y1), ty1);
    } else {
      mask = 1 << code;
      const short2 o = R.org[code];
      rx0 = max(static_cast<int>(o.x), tx0);
      rx1 = min(o.x + kD, tx1);
      ry0 = max(static_cast<int>(o.y), ty0);
      ry1 = min(o.y + kD, ty1);
    }
    const int rw = rx1 - rx0, nq = rw * (ry1 - ry0);
    const int nrow = kMma ? round16(nq) : nq;
    const float inv_rw = 1.f / rw;
    unsigned char* dq = dtqb + db * dtqs;
    const float* dtp = dts + sl * kTaps;
    for (int it = threadIdx.x; it < nrow * kP2; it += kThreads) {
      const int q = it / kP2, p = it - q * kP2;
      float v = 0.f;
      int t = -1;
      if (q < nq) {
        // q / rw for q < 144, rw <= 12: exact through the reciprocal
        const int yy = __float2int_rz((q + 0.5f) * inv_rw);
        const int qy = ry0 + yy, qx = rx0 + q - yy * rw;
        t = (qy - ty0) * tw + qx - tx0;
        const int ty = qy - R.org[p].y, tx = qx - R.org[p].x;
        if (((mask >> p) & 1) && ty >= 0 && ty < kD && tx >= 0 && tx < kD)
          v = dtp[(p * kD + ty) * kD + tx];
      }
      if constexpr (kMma) {
        // v = hi + lo + (a residual below 2^-16 |v|), both bf16
        const bf16 h = __float2bfloat16_rn(v);
        const bf16 l = __float2bfloat16_rn(v - __bfloat162float(h));
        reinterpret_cast<bf16*>(dq + q * 48)[p] = h;
        reinterpret_cast<bf16*>(dq + round16(qmax) * 48 + q * 48)[p] = l;
        if (p == 0)
          reinterpret_cast<int*>(dq + 2 * round16(qmax) * 48)[q] = t;
      } else {
        float* row = reinterpret_cast<float*>(dq) + q * kQS;
        row[p] = v;
        if (p == 0) row[9] = __int_as_float(t);
      }
    }
    if (warp == 0) {
      // the pixels with a tap among the entry's positions
      bool tap = false;
      if (lane < kP2) {
        const short2 o = R.org[lane];
        tap = ((mask >> lane) & 1) && o.x < rx1 && o.x + kD > rx0 &&
              o.y < ry1 && o.y + kD > ry0;
      }
      const int pm = static_cast<int>(__ballot_sync(0xffffffffu, tap));
      if (lane == 0) {
        geo[db] = make_int4(nq, pm, en.y, 0);
        n_box += code == kBoxCode;
        n_px += code != kBoxCode;
        n_dg += __popc(pm);
      }
    }
  };

  // f32 maps: the roles of the CUDA-core loop, channels 32 cs + 4 qd .. + 3
  // of positions 8 i + 4 pg + s, and the dg of the last entry, held by the
  // pg = 0 warps until a barrier makes the pg = 1 warps' half visible
  const int cs = warp & 3, pg = warp >> 2, s = lane >> 3, qd = lane & 7;
  const int ch = cs * 32 + qd * 4;
  float prev[kP2];
  int prev_kk = 0, prev_pm = 0, prev_db = 0;
  auto flush = [&]() {
    if (!kMma && pg == 0 && prev_pm) {
      const float* x = dgx + prev_db * kP2 * kC + cs * 32 + lane;
      float* out = a.dgmap + static_cast<size_t>(prev_kk) * kP2 * kC + ch + s;
#pragma unroll
      for (int p = 0; p < kP2; ++p)
        if ((prev_pm >> p) & 1) atomicAdd(out + p * kC, prev[p] + x[p * kC]);
    }
    prev_pm = 0;
  };

  // bf16 maps: entry n (dtq buffer db, copy slot sl) on the tensor cores.
  // Warp w takes channels 16 w .. 16 w + 15 (two n8 tiles) and every
  // position: per m16 tile of positions, acc[q] += (hi + lo)[q] x G (the
  // accumulator rows loaded into the C fragments, the sum stored back) and
  // dg += (hi + lo)^T x F[q] (k = the positions), then dg's rows (pixels)
  // go to dgmap[kk] with one atomic per pixel with a tap and channel.
  auto accumulate_mma = [&](int sl, int db) {
    const int4 gq = geo[db];
    const int nq = gq.x;
    const int g4 = lane >> 2, t4 = lane & 3;
    const unsigned char* dq = dtqb + db * dtqs;
    const unsigned char* dh = dq;
    const unsigned char* dl = dq + round16(qmax) * 48;
    const int* tq = reinterpret_cast<const int*>(dq + 2 * round16(qmax) * 48);
    const unsigned char* gsl =
        reinterpret_cast<const unsigned char*>(gs + sl * kP2 * kC);
    // B of the df product: G (k = pixel, rows 9-15 zero), two n8 tiles
    uint32_t bg[4];
    {
      const int k = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int c = warp * 2 + (lane >> 4);   // 16-byte chunk of the row
      ldsm_x4_t(bg, k < kP2 ? gsl + k * kC * 2 + (c ^ (k & 7)) * 16 : zrow);
    }
    // dg in two sets of accumulators (even and odd m tiles: independent
    // mma chains), added at the end
    float dg[2][2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        dg[h][j][0] = dg[h][j][1] = dg[h][j][2] = dg[h][j][3] = 0.f;
    // one m16 tile of positions q0 .. q0 + 15 into dg set h
    auto mtile = [&](int q0, float (&dgh)[2][4]) {
      const int ta = tq[q0 + g4], tb = tq[q0 + g4 + 8];
      // the accumulator's rows first: their loads overlap the products
      float2 va[2], vb[2];
      float2* pa[2];
      float2* pb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = warp * 8 + j * 4 + t4;   // 8-byte pair of the row
        pa[j] = reinterpret_cast<float2*>(acc + max(ta, 0) * kC) +
                acc_pair(max(ta, 0), c);
        pb[j] = reinterpret_cast<float2*>(acc + max(tb, 0) * kC) +
                acc_pair(max(tb, 0), c);
        va[j] = ta >= 0 ? *pa[j] : make_float2(0.f, 0.f);
        vb[j] = tb >= 0 ? *pb[j] : make_float2(0.f, 0.f);
      }
      // A of the df product: rows q0 .. q0 + 15 of hi and lo
      uint32_t ah[4], al[4];
      {
        const int row = q0 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = (lane >> 4) * 16;
        ldsm_x4(ah, dh + row * 48 + col);
        ldsm_x4(al, dl + row * 48 + col);
      }
      // A of the dg product: the same rows transposed in registers (m =
      // pixel, k = q): its 8 x 8 blocks (0, 0), (1, 0), (0, 1), (1, 1) are
      // those of the df product's A at (0, 0), (0, 1), (1, 0), (1, 1)
      uint32_t th_[4], tl_[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int from = (k == 1) ? 2 : (k == 2) ? 1 : k;
        th_[k] = movmatrix_t(ah[from]);
        tl_[k] = movmatrix_t(al[from]);
      }
      // B of the dg product: F at the 16 positions (k), two n8 tiles
      uint32_t bf[4];
      {
        const int t = tq[q0 + (lane & 7) + ((lane >> 3) & 1) * 8];
        const int c = warp * 2 + (lane >> 4);
        ldsm_x4_t(bf, t >= 0 ? reinterpret_cast<const unsigned char*>(ft) +
                                   t * kC * 2 + ft_chunk(t, c) * 16
                             : zrow);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // the entry's sum on the tensor cores from zero, then one f32 add
        // to the accumulator (a running sum in C would be added with the
        // tensor cores' truncating alignment at every entry)
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        corr_mma::mma_bf16(d, ah[0], ah[1], ah[2], ah[3], bg[j * 2],
                           bg[j * 2 + 1]);
        corr_mma::mma_bf16(d, al[0], al[1], al[2], al[3], bg[j * 2],
                           bg[j * 2 + 1]);
        corr_mma::mma_bf16(dgh[j], th_[0], th_[1], th_[2], th_[3],
                           bf[j * 2], bf[j * 2 + 1]);
        corr_mma::mma_bf16(dgh[j], tl_[0], tl_[1], tl_[2], tl_[3],
                           bf[j * 2], bf[j * 2 + 1]);
        if (ta >= 0) *pa[j] = make_float2(va[j].x + d[0], va[j].y + d[1]);
        if (tb >= 0) *pb[j] = make_float2(vb[j].x + d[2], vb[j].y + d[3]);
      }
    };
    int q0 = 0;
    for (; q0 + 16 < nq; q0 += 32) {
      mtile(q0, dg[0]);
      mtile(q0 + 16, dg[1]);
    }
    if (q0 < nq) mtile(q0, dg[0]);
    // dg rows g4 (pixels 0-7) and 8 (g4 = 0), channels 16 w + 8 j + 2 t4:
    // lanes t4 and t4 ^ 1 trade pairs, so that an even t4 holds channels
    // 16 w + 2 t4 .. + 3 and an odd one 16 w + 8 + 2 (t4 - 1) .. + 3, one
    // float4 atomic per pixel with a tap
    float* out = a.dgmap + static_cast<size_t>(gq.z) * kP2 * kC;
    const bool odd = t4 & 1;
    const int c4 = warp * 16 + (odd ? 8 + 2 * (t4 - 1) : 2 * t4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // h = 0: row g4, h = 1: row 8
      const float x0 = dg[0][0][2 * h] + dg[1][0][2 * h];
      const float x1 = dg[0][0][2 * h + 1] + dg[1][0][2 * h + 1];
      const float y0 = dg[0][1][2 * h] + dg[1][1][2 * h];
      const float y1 = dg[0][1][2 * h + 1] + dg[1][1][2 * h + 1];
      // an even lane sends its j = 1 pair, an odd one its j = 0 pair
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? x0 : y0, 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? x1 : y1, 1);
      const float4 v = odd ? make_float4(s0, s1, y0, y1)
                           : make_float4(x0, x1, s0, s1);
      const int row = h ? 8 : g4;
      if ((h == 0 || g4 == 0) && ((gq.y >> row) & 1))
        atomicAdd(reinterpret_cast<float4*>(out + row * kC + c4), v);
    }
  };

  // f32 maps: entry n (dtq buffer db, copy slot sl) on the CUDA cores:
  // acc[q] += sum_p dtq[q][p] g[p], dg[p] += dtq[q][p] f[q], then dg over
  // the warp's positions
  auto accumulate_f32 = [&](int sl, int db) {
    const int4 gq = geo[db];
    const int nq = gq.x;
    float4 gv[kP2];
    const T* gr = gs + sl * kP2 * kC + ch;
#pragma unroll
    for (int p = 0; p < kP2; ++p) gv[p] = load4(gr + p * kC);
    float dg[kP2][4];
#pragma unroll
    for (int p = 0; p < kP2; ++p) dg[p][0] = dg[p][1] = dg[p][2] = dg[p][3] = 0.f;
    const float* dq = reinterpret_cast<const float*>(dtqb + db * dtqs);
    for (int q0 = 4 * pg; q0 < nq; q0 += 8) {
      const int qi = q0 + s;
      const int qr = qi < nq ? qi : nq - 1;
      const float4 d0 = *reinterpret_cast<const float4*>(dq + qr * kQS);
      const float4 d1 = *reinterpret_cast<const float4*>(dq + qr * kQS + 4);
      const float4 d2 = *reinterpret_cast<const float4*>(dq + qr * kQS + 8);
      const float dv[kP2] = {d0.x, d0.y, d0.z, d0.w, d1.x,
                             d1.y, d1.z, d1.w, d2.x};
      // the pixels with a nonzero tap gradient at any of the warp's 4
      // positions: the others add exact zeros and are skipped
      unsigned vm = 0;
#pragma unroll
      for (int p = 0; p < kP2; ++p) vm |= (dv[p] != 0.f) << p;
      const unsigned m = __reduce_or_sync(0xffffffffu, vm);
      if (qi < nq) {
        const int t = __float_as_int(d2.y);
        const float4 fv = load4(ft + t * kC + ch);
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int p = 0; p < kP2; ++p) {
          if (!((m >> p) & 1)) continue;
          sum.x += dv[p] * gv[p].x;
          sum.y += dv[p] * gv[p].y;
          sum.z += dv[p] * gv[p].z;
          sum.w += dv[p] * gv[p].w;
          dg[p][0] += dv[p] * fv.x;
          dg[p][1] += dv[p] * fv.y;
          dg[p][2] += dv[p] * fv.z;
          dg[p][3] += dv[p] * fv.w;
        }
        float4* ap = reinterpret_cast<float4*>(acc + t * kC + ch);
        float4 av = *ap;
        av.x += sum.x;
        av.y += sum.y;
        av.z += sum.z;
        av.w += sum.w;
        *ap = av;
      }
    }
    // dg over the warp's 4 positions: lane (s, qd) keeps channel ch + s
    const bool hi = lane & 16, odd = lane & 8;
    float red[kP2];
#pragma unroll
    for (int p = 0; p < kP2; ++p) {
      float k0 = hi ? dg[p][2] : dg[p][0], k1 = hi ? dg[p][3] : dg[p][1];
      const float s0 = hi ? dg[p][0] : dg[p][2];
      const float s1 = hi ? dg[p][1] : dg[p][3];
      k0 += __shfl_xor_sync(0xffffffffu, s0, 16);
      k1 += __shfl_xor_sync(0xffffffffu, s1, 16);
      const float keep = odd ? k1 : k0, send = odd ? k0 : k1;
      red[p] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
    if (pg == 1) {
      float* x = dgx + db * kP2 * kC + cs * 32 + lane;
#pragma unroll
      for (int p = 0; p < kP2; ++p) x[p * kC] = red[p];
    } else {
#pragma unroll
      for (int p = 0; p < kP2; ++p) prev[p] = red[p];
      prev_kk = gq.z;
      prev_pm = gq.y;
      prev_db = db;
    }
  };

  for (int pos = 0; pos < nedges;) {
    // the round: item (u, t) is list edge pos + 256 u + t, its entries
    // packed in list order (the heads read coalesced)
    int em[kScan], cnt[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int i = pos + u * kThreads + threadIdx.x;
      em[u] = 0;
      if (i < nedges) {
        const int4 h = lhead[first + i];
        const int bx0 = static_cast<short>(h.x & 0xffff), bx1 = h.x >> 16;
        const int by0 = static_cast<short>(h.y & 0xffff), by1 = h.y >> 16;
        int m = 0;
        if ((h.z & 0x1ff) && bx0 < tx1 && bx1 > tx0 && by0 < ty1 && by1 > ty0)
          m |= 1 << kP2;
        const int om = (h.z >> kP2) & 0x1ff;
        if (om) {
          const Rec* rp = rec + a.list[first + i];
          for (int mm = om; mm; mm &= mm - 1) {
            const int p = __ffs(mm) - 1;
            const short2 o = rp->org[p];
            if (o.x < tx1 && o.x + kD > tx0 && o.y < ty1 && o.y + kD > ty0)
              m |= 1 << p;
          }
        }
        em[u] = m;
      }
      cnt[u] = __popc(em[u]);
    }
    // the items' places in list order: per u a warp scan, the warps' and
    // the u rows' totals through shared memory
    int incl[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      int x = cnt[u];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      incl[u] = x;
      if (lane == 31) misc[16 + u * kWarps + warp] = x;
    }
    if (threadIdx.x == 0) misc[8] = misc[9] = INT_MAX;
    __syncthreads();
    int before = 0, total = 0, off[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      int wb = 0, ut = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int x = misc[16 + u * kWarps + w];
        wb += w < warp ? x : 0;
        ut += x;
      }
      off[u] = before + wb + incl[u] - cnt[u];
      before += ut;
    }
    total = before;
    // the cut: the first item in list order whose entries do not fit
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      if (off[u] + cnt[u] > kCap) {
        atomicMin(misc + 8, u * kThreads + threadIdx.x);
        atomicMin(misc + 9, off[u]);
      }
    }
    __syncthreads();
    const int cut = misc[8], nb = min(total, misc[9]);
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      if (u * kThreads + static_cast<int>(threadIdx.x) < cut && em[u]) {
        const int i = pos + u * kThreads + threadIdx.x;
        const int e = a.list[first + i], kk = lhead[first + i].w;
        int o = off[u];
        if ((em[u] >> kP2) & 1) batch[o++] = make_int2(e * 16 + kBoxCode, kk);
        for (int m = em[u] & 0x1ff; m; m &= m - 1)
          batch[o++] = make_int2(e * 16 + __ffs(m) - 1, kk);
      }
    }
    pos += min(nedges - pos, min(cut, kScan * kThreads));
    __syncthreads();
    ++n_batch;
    if (nb == 0) continue;

    // one barrier per entry: in step i, copy entry i + 3, build entry i +
    // 1's dtq and sum entry i; entry n in slot n % 4 and dtq buffer n % 2
    prefetch(0, 0);
    prefetch(nb > 1 ? 1 : -1, 1);
    prefetch(nb > 2 ? 2 : -1, 2);
    cp_wait_group<2>();
    __syncthreads();
    build(0, 0, 0);
    cp_wait_group<1>();
    __syncthreads();
    for (int i = 0; i < nb; ++i) {
      prefetch(i + 3 < nb ? i + 3 : -1, (i + 3) % kSlots);
      flush();
      if (i + 1 < nb) build(i + 1, (i + 1) % kSlots, (i + 1) & 1);
      if constexpr (kMma)
        accumulate_mma(i % kSlots, i & 1);
      else
        accumulate_f32(i % kSlots, i & 1);
      cp_wait_group<1>();
      __syncthreads();
    }
    flush();
  }
  cp_wait_group<0>();
  __syncthreads();

  // the tile of dfmap, once, in the maps' dtype; acc(q, c4): the float4 of
  // channels 4 c4 .. 4 c4 + 3 at tile position q
  auto acc4 = [&](int q, int c4) {
    if constexpr (kMma) {
      const float2* row = reinterpret_cast<const float2*>(acc + q * kC);
      const float2 x = row[acc_pair(q, 2 * c4)];
      const float2 y = row[acc_pair(q, 2 * c4 + 1)];
      return make_float4(x.x, x.y, y.x, y.y);
    } else {
      return reinterpret_cast<const float4*>(acc)[q * (kC / 4) + c4];
    }
  };
  T* dfm = static_cast<T*>(a.dfmap[L]) + frame * kC;
  for (int i = threadIdx.x; i < np * (kC / 4); i += kThreads) {
    const int q = i / (kC / 4), c = i - q * (kC / 4);
    const int y = ty0 + q / tw, x = tx0 + q % tw;
    store4(dfm + (static_cast<size_t>(y) * W + x) * kC + c * 4, acc4(q, c));
  }
  if (threadIdx.x == 0 && a.stats != nullptr)
    a.stats[blockIdx.x] = make_int4(n_box, n_px, n_dg, n_batch);
}

// ---- the plan and the launch ----

struct Plan {
  long long rec, dt, key, fcnt, fstart, list, lhead, stats, bytes;
  int tiles[2], tp, qmax;
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

// the scratch layout (byte offsets) and the tiles; false for a tile shape
// it cannot run
bool make_plan(int E, int F, const int* H, const int* W, const int* TH,
               const int* TW, int elem, Plan* p) {
  auto up = [](long long b) { return (b + 15) / 16 * 16; };
  p->tp = p->qmax = 0;
  for (int l = 0; l < 2; ++l) {
    if (TH[l] < 1 || TW[l] < 1) return false;
    p->tiles[l] = F * cdiv(H[l], TH[l]) * cdiv(W[l], TW[l]);
    p->tp = std::max(p->tp, TH[l] * TW[l]);
    p->qmax = std::max(p->qmax, entry_positions(TH[l], TW[l]));
  }
  if (tile_smem(p->tp, p->qmax, elem) > static_cast<size_t>(kMaxSmem))
    return false;
  p->rec = 0;
  p->dt = up(2ll * E * sizeof(Rec));
  p->key = p->dt + 2ll * E * kTaps * 4;
  p->fcnt = p->key + up(4ll * E);
  p->fstart = p->fcnt + up(4ll * F);
  p->list = p->fstart + up(4ll * F);
  p->lhead = p->list + up(4ll * E);
  p->stats = p->lhead + 32ll * E;
  p->bytes = p->stats + 16ll * (p->tiles[0] + p->tiles[1]);
  return true;
}

struct Args {
  const void *gmap, *fmap1, *fmap2, *coords, *kk, *jj, *grad_out;
  float* dgmap;
  void *dfmap1, *dfmap2;
  unsigned char* scratch;
  int E, Ng, F, H[2], W[2], TH[2], TW[2];
};

template <typename T>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t st) {
  const int elem = static_cast<int>(sizeof(T));
  Rec* rec = reinterpret_cast<Rec*>(a.scratch + p.rec);
  float* dt = reinterpret_cast<float*>(a.scratch + p.dt);
  int* key = reinterpret_cast<int*>(a.scratch + p.key);
  int* fcnt = reinterpret_cast<int*>(a.scratch + p.fcnt);
  int* fstart = reinterpret_cast<int*>(a.scratch + p.fstart);
  int* list = reinterpret_cast<int*>(a.scratch + p.list);
  int4* lhead = reinterpret_cast<int4*>(a.scratch + p.lhead);
  cudaError_t err = cudaMemsetAsync(fcnt, 0, 4 * static_cast<size_t>(a.F),
                                    st);
  if (err != cudaSuccess) return err;
  bw_prep<<<cdiv(a.E, kPrepThreads / 32), kPrepThreads, 0, st>>>(
      static_cast<const float*>(a.coords), static_cast<const int*>(a.kk),
      static_cast<const int*>(a.jj), static_cast<const float*>(a.grad_out),
      rec, dt, key, fcnt, a.E, a.Ng, a.F, a.H[0], a.W[0], a.H[1], a.W[1]);
  bw_frames<<<a.F, kFrameThreads, 0, st>>>(key, fcnt, rec, fstart, list,
                                           lhead, a.E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  TileArgs t;
  t.gmap = a.gmap;
  t.fmap[0] = a.fmap1;
  t.fmap[1] = a.fmap2;
  t.dt = dt;
  t.rec = rec;
  t.fstart = fstart;
  t.fcnt = fcnt;
  t.list = list;
  t.lhead = lhead;
  t.dgmap = a.dgmap;
  t.dfmap[0] = a.dfmap1;
  t.dfmap[1] = a.dfmap2;
  t.stats = reinterpret_cast<int4*>(a.scratch + p.stats);
  t.E = a.E;
  t.tp = p.tp;
  t.qmax = p.qmax;
  for (int l = 0; l < 2; ++l) {
    t.H[l] = a.H[l];
    t.W[l] = a.W[l];
    t.TH[l] = a.TH[l];
    t.TW[l] = a.TW[l];
    t.NTY[l] = cdiv(a.H[l], a.TH[l]);
    t.NTX[l] = cdiv(a.W[l], a.TW[l]);
    t.nt[l] = p.tiles[l];
  }
  const int blocks = p.tiles[0] + p.tiles[1];
  if (blocks == 0) return cudaSuccess;
  const size_t smem = tile_smem(p.tp, p.qmax, elem);
  // above 48 KB of dynamic shared memory only after opting in
  err = cudaFuncSetAttribute(bw_tiles<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bw_tiles<T><<<blocks, kThreads, smem, st>>>(t);
  return cudaGetLastError();
}

}  // namespace

// The scratch bytes and the tiles of a call: out[0] scratch bytes (16-byte
// aligned), out[1] / out[2] the tiles of level 1 / level 2, out[3] the
// stats' byte offset in the scratch (one int4 per tile, level-2 tiles
// first: box entries, pixel entries, dg pixels, batches), out[4] the
// records' (2 x E x 128 bytes, level 1 first), out[5] the tile kernel's
// shared bytes. (th1, tw1), (th2, tw2): the tiles' rows and columns at
// each level. Returns 0, or cudaErrorInvalidValue (1) for tiles that do
// not fit a block's shared memory.
extern "C" int corr_backward_plan(int E, int F, int H1, int W1, int H2,
                                  int W2, int th1, int tw1, int th2, int tw2,
                                  int in_bf16, long long* out) {
  const int H[2] = {H1, H2}, W[2] = {W1, W2}, TH[2] = {th1, th2},
            TW[2] = {tw1, tw2};
  const int elem = in_bf16 ? 2 : 4;
  Plan p;
  if (!make_plan(E, F, H, W, TH, TW, elem, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = p.bytes;
  out[1] = p.tiles[0];
  out[2] = p.tiles[1];
  out[3] = p.stats;
  out[4] = p.rec;
  out[5] = static_cast<long long>(tile_smem(p.tp, p.qmax, elem));
  return 0;
}

// Enqueues the three kernels on `stream` of CUDA device `device` and
// returns the first CUDA error (0 on successful launches). in_bf16 selects
// bf16 (1) or f32 (0) maps; dgmap is f32 and zeroed by the caller, dfmap1
// and dfmap2 are in the maps' dtype and written whole; scratch holds
// corr_backward_plan's bytes.
extern "C" int corr_backward_launch(const void* gmap, const void* fmap1,
                                    const void* fmap2, const void* coords,
                                    const void* kk, const void* jj,
                                    const void* grad_out, void* dgmap,
                                    void* dfmap1, void* dfmap2, void* scratch,
                                    int E, int Ng, int F, int H1, int W1,
                                    int H2, int W2, int th1, int tw1,
                                    int th2, int tw2, int in_bf16, int device,
                                    void* stream) {
  if (E <= 0 || F <= 0) return 0;
  // this library carries its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Args a{gmap, fmap1, fmap2, coords, kk, jj, grad_out,
         static_cast<float*>(dgmap), dfmap1, dfmap2,
         static_cast<unsigned char*>(scratch), E, Ng, F,
         {H1, H2}, {W1, W2}, {th1, th2}, {tw1, tw2}};
  Plan p;
  if (!make_plan(E, F, a.H, a.W, a.TH, a.TW, in_bf16 ? 2 : 4, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = in_bf16 ? launch<bf16>(a, p, s)
                                  : launch<float>(a, p, s);
  return static_cast<int>(err);
}

// The tile kernel's launch shape for these tiles and maps on CUDA device
// `device`: threads and shared memory per block and the blocks one SM
// holds at once. Returns a CUDA error code.
extern "C" int corr_backward_occupancy(int th1, int tw1, int th2, int tw2,
                                       int in_bf16, int device, int* threads,
                                       int* smem_bytes, int* blocks_per_sm) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int elem = in_bf16 ? 2 : 4;
  const int tp = std::max(th1 * tw1, th2 * tw2);
  const size_t dyn = tile_smem(
      tp, std::max(entry_positions(th1, tw1), entry_positions(th2, tw2)),
      elem);
  if (dyn > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = in_bf16 ? reinterpret_cast<const void*>(bw_tiles<bf16>)
                           : reinterpret_cast<const void*>(bw_tiles<float>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attrs;
  err = cudaFuncGetAttributes(&attrs, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                      kThreads, dyn);
  *threads = kThreads;
  *smem_bytes = static_cast<int>(attrs.sharedSizeBytes + dyn);
  return static_cast<int>(err);
}
