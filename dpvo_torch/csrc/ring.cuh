// The pieces of a shared-memory ring fed by the copy engine, shared by the
// persistent streaming kernels (corr_probes.cu:probe_dots, corr_fused.cu:
// corr_planes_ring): mbarriers and 1-D bulk copies (cp.async.bulk) that
// complete on them. A producer arrives on a stage's "full" barrier with the
// bytes it expects and issues the copies; consumers wait for that phase,
// read the stage and arrive on its "empty" barrier, for which the producer
// waits before it fills the stage again.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace corr_ring {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the copy engine; one thread
// runs it after its inits, before the block's barrier
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// asks L2 to fetch `bytes` (a multiple of 16) from global `src` ahead of a
// later copy (cp.async.bulk.prefetch; no completion to wait for)
__device__ __forceinline__ void bulk_prefetch_l2(const void* src,
                                                 uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}

// ---- host: the launch shape of a persistent ring kernel ----

// grid, threads, dynamic shared memory, registers and blocks per SM
struct RingShape {
  int grid, threads, smem, regs, blocks_per_sm;
};

// The full shape of kernel K on `device` (the current device), from the
// runtime: the blocks per SM that fit, at most K::kBlocksPerSm, times the
// SMs make the grid. Opts in to K's dynamic shared memory. K names the
// kernel (K::fn()), its threads (K::kThreads), its dynamic shared memory
// (K::kSmem) and the blocks per SM its ring asks for (K::kBlocksPerSm).
template <class K>
cudaError_t ring_query(int device, RingShape* sh) {
  const void* fn = K::fn();
  sh->threads = K::kThreads;
  sh->smem = K::kSmem;
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
  sh->blocks_per_sm = std::min(fit, K::kBlocksPerSm);
  sh->grid = sh->blocks_per_sm * sms;
  return cudaSuccess;
}

constexpr int kMaxDevices = 64;

// ring_query's shape on `device` (the current device), queried once per
// kernel and device (std::call_once, so threads launching at once share
// one query), its grid cut to E blocks when E is smaller.
template <class K>
cudaError_t ring_shape(int E, int device, RingShape* sh) {
  static std::once_flag once[kMaxDevices];
  static RingShape shape[kMaxDevices];
  static cudaError_t status[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[device], [device] {
    status[device] = ring_query<K>(device, &shape[device]);
  });
  if (status[device] != cudaSuccess) return status[device];
  *sh = shape[device];
  sh->grid = std::max(1, std::min(E, sh->grid));
  return cudaSuccess;
}

}  // namespace corr_ring
