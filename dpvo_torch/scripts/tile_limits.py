"""What sets the time of K4's and K6 slab's target tiles and of K7, on the
card.

    python -m dpvo_torch.scripts.tile_limits [--out FILE]

Three measurements, each printed with the card's name and power limit
(the kernels with parts taken out are ring_sweep.py --ablate's):
  * the device time of each kernel of K4's chain (planes_pair: the four
    binning kernels and the two tile kernels), of K6 slab's (the binning
    and its tile kernel) and of K7 (planes_first49), from a torch.profiler
    trace of 10 calls on their probe scripts' inputs (micro_fused_v2,
    micro_corr_floor, micro_onepass_dma);
  * the card's mma.sync m16n8k16 (bf16 in, f32 accumulate) rate: a kernel
    that issues only independent chains of mma on registers, 132 blocks of
    4-16 warps with 1-8 chains each, as mma per SM per ns and TFLOP/s;
  * the instruction mix of the compiled tile kernels (K4's and the
    slab's) and of K7 (cuobjdump
    -sass of this checkout's build, where the toolkit has it): each
    kernel's instructions by opcode, static counts.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import torch

from dpvo_torch.ops import corr_probes as cp
from dpvo_torch.ops import cuda_lib
from dpvo_torch.scripts import _common as cm
from dpvo_torch.scripts import (micro_corr_floor, micro_fused_v2,
                                micro_onepass_dma)

BUILD = cuda_lib.BUILD_DIR / 'tile_limits'

_MMA_RATE = r'''
#include <cuda_runtime.h>
#include <stdint.h>
template <int CH>
__global__ void mma_chains(float* out, int iters) {
  float d[CH][4];
  uint32_t a0 = threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u, a3 = a0 * 7u;
  uint32_t b0 = a0 * 11u, b1 = a0 * 13u;
  for (int c = 0; c < CH; ++c) d[c][0] = d[c][1] = d[c][2] = d[c][3] = 0.f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// the time of `iters` mma per chain, `chains` chains per warp, `warps`
// warps per block, `blocks` blocks; returns ms (-1 on an error)
extern "C" float mma_chains_ms(int chains, int warps, int blocks,
                               int iters) {
  float* out;
  if (cudaMalloc(&out, sizeof(float) * blocks * warps * 32)) return -1.f;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float ms = -1.f;
  for (int rep = 0; rep < 2; ++rep) {   // the first run warms up
    cudaEventRecord(a);
    switch (chains) {
      case 1: mma_chains<1><<<blocks, warps * 32>>>(out, iters); break;
      case 2: mma_chains<2><<<blocks, warps * 32>>>(out, iters); break;
      case 4: mma_chains<4><<<blocks, warps * 32>>>(out, iters); break;
      default: mma_chains<8><<<blocks, warps * 32>>>(out, iters); break;
    }
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(&ms, a, b);
  }
  if (cudaGetLastError() != cudaSuccess) ms = -1.f;
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  cudaFree(out);
  return ms;
}
'''


def kernel_times(fn, reps=10):
    """{kernel name: mean device us} of reps calls of fn (profiler)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0 and e.count:
            m = re.search(r'::(\w+(?:<\d+>)?)\(', e.key)
            out[m.group(1) if m else e.key] = e.device_time_total / e.count
    return out


def mma_rate():
    """[{chains, warps, ms, mma_per_sm_ns, tflops}] of the mma kernel."""
    src = BUILD / 'mma_rate.cu'
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(_MMA_RATE)
    so = BUILD / 'libmma_rate.so'
    cuda_lib.compile_source(src, so)
    lib = ctypes.CDLL(str(so))
    lib.mma_chains_ms.argtypes = [ctypes.c_int] * 4
    lib.mma_chains_ms.restype = ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, iters = [], 4096
    for warps in (4, 8, 16):
        for chains in (1, 2, 4, 8):
            ms = lib.mma_chains_ms(chains, warps, sms, iters)
            if ms <= 0:
                raise RuntimeError('mma_chains failed')
            n = sms * warps * iters * chains
            rows.append(dict(chains=chains, warps=warps, ms=ms,
                             mma_per_sm_ns=n / sms / (ms * 1e6),
                             tflops=n * 4096 / (ms * 1e9)))
            print(f'  mma.sync rate: {warps} warps x {chains} chains per SM: '
                  f'{rows[-1]["mma_per_sm_ns"]!r} mma per SM per ns, '
                  f'{rows[-1]["tflops"]!r} TFLOP/s', flush=True)
    return rows


def sass_mix(so, names=('probe_pair_tilesILi1E', 'probe_pair_tilesILi2E',
                         'probe_slab_tiles', 'probe_planes_ringILi3E')):
    """{kernel: {opcode: static count}} of the kernels of `so` whose
    mangled names hold `names`, from cuobjdump -sass; None without it."""
    tool = shutil.which('cuobjdump') or str(
        Path(cuda_lib._nvcc()).with_name('cuobjdump'))
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, '-sass', str(so)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out = {}
    for part in sass.split('Function : ')[1:]:
        name = next((n for n in names if n in part.split()[0]), None)
        if name:
            ops = [m.group(1).split('.')[0] for m in re.finditer(
                r'/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)',
                part)]
            out[name] = dict(sorted(
                ((o, ops.count(o)) for o in set(ops)), key=lambda x: -x[1]))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', type=Path)
    a = ap.parse_args()
    dev = cm.device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f'tile_limits on {smi}', flush=True)
    res = {'card': smi}
    cp.build()
    a5 = micro_fused_v2.inputs(dev)['args']
    a6 = micro_corr_floor.slab_inputs(dev)
    a7 = micro_onepass_dma.inputs(dev)['args']
    res['kernels_us'] = {
        'planes_pair (K4)': kernel_times(lambda: cp.planes_pair(*a5)),
        'slab (K6)': kernel_times(lambda: cp.slab(*a6)),
        'planes_first49 (K7)': kernel_times(lambda: cp.planes_first49(*a7))}
    for k, v in res['kernels_us'].items():
        print(f'  {k} device us per call: {v}', flush=True)
    res['mma_rate'] = mma_rate()
    res['sass'] = sass_mix(cp.build())
    for k, v in (res['sass'] or {}).items():
        print(f'  {k}: {sum(v.values())} instructions, '
              f'{dict(list(v.items())[:12])}', flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(res, indent=1))


if __name__ == '__main__':
    main()
