// Tensor-core building blocks shared by the correlation kernels
// (corr_onepass.cu, corr_fused.cu, corr_probes.cu): the dot of an edge's 9 g rows
// (3 x 3 patch pixels, 128 bf16 channels) with 8 channel rows at a time,
// as mma.sync m16n8k16 with bf16 inputs and f32 accumulation.
//
// A is the 9 g rows padded to 16 (rows 9-15 zero), held in registers for
// the whole kernel (GFrag). B is 8 channel rows (window positions) x 16
// channels per k-step. The channels are permuted identically in A and B,
// so that one 16-byte load of a row (8 channels) feeds two k-steps: lane
// (grp, t) = (lane / 4, lane % 4) holds, for each 32-channel chunk c, the
// channels 32c + 8t .. 32c + 8t + 7 of its row.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace corr_mma {

typedef __nv_bfloat16 bf16;

constexpr int kC = 128;                 // channels
constexpr int kP2 = 9;                  // 3 x 3 patch pixels
constexpr int kRowU4 = kC / 8;          // 16-byte words per channel row
constexpr int kChunks = kC / 32;        // 32 channels: two mma k-steps

// A operand of m16n8k16: this lane's words of g rows (lane / 4) and 8, for
// each 32-channel chunk. Lane (grp, t) holds channels 32c + 8t .. + 7.
struct GFrag {
  uint4 lo[kChunks];
  uint4 hi[kChunks];
};

// The A operand from the 9 g rows in shared memory, unpermuted.
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

// The dot of the 9 g rows with this lane group's channel row, given as its
// kChunks 16-byte words b[c] (channels 32c + 8t .. + 7). k-step h of chunk
// c takes, in its slots 2t, 2t + 1 / 2t + 8, 2t + 9, the channels
// 32c + 8t + 4h + {0, 1} / {2, 3}, in A and B alike. Out: d[0], d[1] = g
// row grp at positions 2t, 2t + 1; d[2], d[3] = g row 8 there (grp 0; zero
// rows elsewhere).
__device__ __forceinline__ void tile_mma(const GFrag& a,
                                         const uint4 (&b)[kChunks],
                                         float (&d)[4]) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    mma_bf16(d, a.lo[c].x, a.hi[c].x, a.lo[c].y, a.hi[c].y, b[c].x, b[c].y);
    mma_bf16(d, a.lo[c].z, a.hi[c].z, a.lo[c].w, a.hi[c].w, b[c].z, b[c].w);
  }
}

// B of one tile from this lane's row of a ring stage whose rows land
// unswizzled at a 256-byte stride (bulk copies; 16-byte words): the words
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

}  // namespace corr_mma
