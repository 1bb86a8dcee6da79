"""Smoke run of the PyTorch / CUDA port (dpvo_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. environment: a CUDA device must exist; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles dpvo_torch/csrc/corr_onepass.cu (K1),
     dpvo_torch/csrc/corr_fused.cu (K2 planes, K3 tap select),
     dpvo_torch/csrc/corr_probes.cu (the probes K4-K8) and
     dpvo_torch/csrc/corr_backward.cu (K1's gradient) with nvcc, one
     process per source, started together; prints ptxas's register and
     spill lines of each kernel, K1's threads, shared memory and blocks
     per SM for bf16 and f32 maps, and the persistent launch shapes (grid,
     threads, dynamic shared memory, registers, blocks per SM and ring) of
     K2 for bf16 maps, of K5, K7 and K8 (both each) on the planes ring, of
     K4's two tile kernels (with their tiles' map rows, consumer warps and
     edges per item at most), of K6 slab's tile kernel (its map rows, edges
     per item, consumer warps, tile rows and m16 tiles per unit, m16 tiles
     per pass) and of K6 dots;
  3. kernels vs plain, at the main paths' shapes (E = 49,152 edges, 36
     frames of 120x160 and 30x40 bf16 maps): K1 (plus the fast.yaml row
     layout, M = 48; the pixels per branch and level of its union-box rule,
     both branches must run, and the rows it stages), K2, K3 (also on the
     pixels whose spread overflows the window, which it must zero), and
     K2 + K3 against the exact correlation on edges whose spread fits the
     window, with the times of kernel and plain (CUDA events, median of 20)
     and each kernel's roofline bound, and K3's and K2's device times
     (back-to-back launches in turns); the bytes K1 stages and K2 copies
     per call, and their rates at the kernels' times;
  4. DeviceVO main path: dpvo_torch.runtime.DPVO with config/default.yaml at
     640x480 and the full-width VONet (artifacts/micro_vonet.npz), 40
     synthetic frames + terminate(); K1 must cover every update iteration;
     the frames after the bootstrap run under
     torch.cuda.set_sync_debug_mode and must make no host-device sync (the
     state machine's scalars and decisions stay on the card; the syncs per
     frame and their call sites are printed); wall, device busy, idle share
     and top kernels from a profiler trace, bytes uploaded per frame;
     colors() of the keyframes;
  5. hybrid main path: the same with CENTROID_SEL_STRAT=GRADIENT_BIAS
     (HybridVO) and DPVO_CORR_IMPL=fused_k, 40 frames + terminate(); K2 and
     K3 must cover every update iteration; the same measurements; then
     HybridVO again with onepass, its default (K1 must cover every update
     iteration), measured alike: wall, busy and idle, and K1 against K2 +
     K3 in device ms per frame;
  6. DeviceVO with DPVO_CORR_IMPL=fused_k, 12 frames + terminate() at
     640x480: K2 and K3 cover every update iteration there too, and the
     frames after the bootstrap make no host-device sync, as in phase 4;
  7. CUDA vs CPU: DeviceVO at 64x96 (K1 vs plain) and HybridVO at
     256x320 with onepass, its default (K1), and with fused_k (K2 + K3),
     each in f32 and in bf16 (MIXED_PRECISION: K1's box kernel, K2 / K3 on
     bf16 maps), each against its plain versions: poses agree and the CUDA
     run launched its kernels;
  8. correlation probes: the four entry points dpvo_torch.scripts.
     micro_fused_v2 (K4, K5), micro_corr_floor (K6), micro_onepass_dma (K7)
     and micro_kernel_variants (K8) at their scripts' sizes, launch counts
     set to 0 just before each and read just after; each probe kernel
     within its bound of its plain version, launched, timed beside its
     plain version, its bound and (K6 dots) one torch.bmm, timed in turns
     with the kernel (kernel / library ratio printed); K2 against K4 on
     micro_fused_v2's inputs (ratio printed); device times in turns of K5
     against K4, of K7 STREAMS=1 against STREAMS=0 and of K8 w12x16
     against K8 fixedw, with the bytes they copy from L2 per call and
     their rates; K4's work items and mean edges per item, read back from
     one call of its chain (corr_probes.pair_work) and checked: every
     edge in one item of at most PAIR_CAP, items in bin order, tiles
     within their bounds, at most 1.0 GB of them per call; K6 slab's
     device time (back-to-back launches) and its share of the bound, and
     its work items, read back likewise (corr_probes.slab_work) and
     checked: every edge in one item of at most SLAB_TILE's cap, tiles of
     at most its rows, at most 0.25 GB of them per call;
  9. DeviceVO on UPLOAD_FORMAT=yuv420 as in phase 4 (I420 planes packed
     on the host, turned into RGB on the device), per frame and through
     track_frames in chunks of 8: K1 must cover every update iteration of
     both, and neither may make a host-device sync after the bootstrap
     frame (phase 4's count, per frame and per chunk of 8), chunked poses
     within 1e-3 of per-frame ones, the first 10
     frames on CUDA and on the CPU within 1e-2; the host's rgb_to_i420
     time at 640x480; wall, device busy, idle share and bytes uploaded per
     frame of both, beside phase 4's rgb run, with the card's name and
     power limit;
 10. HybridVO on yuv420 at 256x320, bf16, onepass: CUDA vs CPU poses
     within 1e-2, K1 launched;
 11. accuracy on the card (dpvo_torch/accuracy.py), f32: trained weights
     (artifacts/micro_vonet.npz) on make_sequence(1234, T=25, 64x96) in
     rgb and yuv420 against seeded random weights: trained ATE < 0.15 x
     the path and < 0.5 x random, yuv420 < rgb + 0.05 x the path, K1
     launched; the oracle keyframe-removal scene: >= 3 removals, ATE <
     0.01 x the path;
 12. DPV-SLAM's learned loop closure (HybridVO with LOOP_CLOSURE):
     default.yaml + LOOP_CLOSURE at 640x480, the full-width VONet, bf16,
     onepass, on make_sequence(12, T=70, 480x640, loop=True) (an
     out-and-back path), KEYFRAME_THRESH -1 (keyframes kept, so the return
     leg meets the outbound frames inside MAX_EDGE_AGE): loop edges
     proposed, global BA run, K1 on every update iteration, finite poses;
     wall, busy and idle as in phases 4-5, global BA's ms per call (device
     busy from a profiler trace of the run's last call replayed) with its
     edges and window, the host ms per call of proximity_edges and of
     build_pair_tables, peak device memory. Then K1, and K2 + K3, against
     their plain versions on a 96,000-row gmap (the 1,000-frame ring at M =
     96) with kk over the whole ring; the LC runtime on CUDA against the
     CPU (accuracy.lc_cfg on make_sequence(950, T=40, loop=True): 96x128
     onepass in f32 and bf16, 256x320 fused_k in bf16; poses, the same
     loop edges and global-BA frames, kernels launched); the loop-closure
     ATE gates of
     dpvo_torch/accuracy.py in f32 (oracle and learned, as
     tests/test_torch_lc_ate.py holds them).
 13. training on the card (dpvo_torch/train/): the correlation backward
     kernel (csrc/corr_backward.cu) against corr_backward_plain on
     edge_schedule(15, 80, 18)'s final 18,000 edges, 15 frames of 120x160
     and 30x40 maps, Ng = 1,200, for f32 and bf16 maps, with its time
     alone and back to back, the plain version's and its bound; K1 against
     its plain version at the same training shapes (every edge live), bf16
     and f32 maps; one train step's loss and gradients on CUDA against the
     CPU (full-width VONet, f32, T = 8, M = 4, 64x96), with two CUDA runs'
     spread and two planted faults in the backward's output read against
     the same limits, then make_train_step's whole step; the
     reference training size (edge_schedule(15, 80, 18), batch 1, 480x640
     make_sequence frames, bf16 mixed precision): one structure-only step
     and 3 full steps, finite, K1 and the backward kernel 18 times per
     step; wall ms per step, device busy and idle share from a profiler
     trace of the last step, its top kernels, peak device memory.
 14. DPV-SLAM's classic loop closure (HybridVO with CLASSIC_LOOP_CLOSURE).
     It needs the cv2 module (a host without it fails the phase); the
     retrieval library (dpvo_torch/native/dpretrieval.cpp, the tf-idf BoW)
     builds with plain g++, ORB and matching run on cv2. Its first line
     gives cv2's version and the library. (a) default.yaml +
     CLASSIC_LOOP_CLOSURE at 640x480, the full-width VONet, bf16, onepass,
     on 48 frames of dpvo_torch.accuracy's out-and-back textured plane,
     KEYFRAME_THRESH -1 and classic_cfg's retrieval keys: retrieval
     proposes a candidate, K1 on every update iteration, finite poses;
     lc_count, wall / busy / idle per frame, per close_loop the host ms of
     the call (its stall) and of ORB + matching, the structure-only BA's
     device ms, RANSAC ms and the PGO worker's submission-to-result ms,
     peak device memory; (b) the oracle gate in f32 at 128x192 (lc_count
     >= 1, ATE < 0.05 x the path); (c) the same scene with the trained
     weights in bf16 and sync_pgo, CUDA against the CPU (poses 1e-2, the
     same loops and lc_count, K1 on every update iteration); (d) the
     structure-only BA on (b)'s first triplet, CUDA against the CPU
     (depths 1e-4). Each run prints its own K1 launches (the counts set to
     0 just before it); the kernels line keeps phase 4's, the main path's
     own count.
 15. the entry points on the card, with the card's name and power limit:
     40 PNG frames of phase 4's texture and a calib file written to a
     temporary directory, which is the working directory of the runs;
     (a) dpvo_torch.demo.main (its spawn reader process) on DeviceVO at
     640x480, default.yaml, the micro VONet, bf16: first with the motion
     probe as it is (whether it left bootstrap is printed; if not, the
     runs below force the probe on the runtime demo.run builds, and say
     so), then with --timeit and every writer (TUM file 40 x 8, ply,
     html, COLMAP, and --plot where matplotlib imports): K1 on every
     update iteration, per-frame wall beside phase 4's, the whole run's
     wall, then device busy per frame of a profiled run; (b) the same
     with --viz on HybridVO and the headless viewer (jpg frames and
     cloud.ply, 3D renders where matplotlib imports), K1 on every update
     iteration, wall per frame beside (a)'s and the viewer pushes' ms;
     DeviceVO built directly with viz=True, its pushes' ms; (e)
     evaluate_synthetic.main, one trial over scenes 900-904, trained and
     random weights: AVG ATE, trained below random; (c) in turns, two
     rounds (ABCD DCBA), each run between two host-pace probes (a fixed
     Python loop's ms, us per tiny launch, objects tracked by gc; also
     printed before phase 4): phase
     4's main path, (a)'s demo.main with --timeit, MultiStreamVO with 1
     and with 2 streams on cuda:0, 40 lockstep frames, each stream its own
     crop (K1 launches = streams x the update iterations, every stream
     out of bootstrap, poses finite and moved, wall per lockstep step and
     per stream-frame, busy and idle of 10 traced steps); (d)
     MultiStreamVO at 64x96 on CUDA against the CPU, the same draws: f32
     within 1e-3, bf16 within 1e-2, K1 launched. Each run prints its own
     K1 launches.
 16. the training and evaluation entry points on the card, with the card's
     name and power limit, in a temporary working directory holding a
     TartanAir layout (datasets/TartanAir: 2 scenes of 70 frames at
     480x640 rendered by dpvo_torch/data_readers/synthetic.py with
     TartanAir's camera, depth_left/*.npy, a NED pose_left.txt; 2
     validation scenes of their first 40 frames, which the reader
     reserves): (a) dpvo_torch.train.cli.main as a user runs it
     (--dataset tartan, n_frames 15, M = 80, batch 1, bf16, 480x640 crop),
     3 steps structure-only from the seeded weights, then 3 full steps
     from a --ckpt the port wrote: finite losses, the pose loss's aux only
     in the full run, K1 and corr_backward 18 times per step; wall ms per
     step, device busy and idle share of the traced third full step, the
     reader's host ms per item; (b) one batch of the same pipeline, the
     step through parallel/mesh.py over NCCL in a world of one against a
     plain step, beside two plain steps' spread, as the trainer runs
     (CUDA's atomic scatter sums make steps differ) and under
     torch.use_deterministic_algorithms, where the whole gradient must be
     within 1e-4 relative L2; (c) evaluate_tartan.evaluate over the
     2 validation scenes (default.yaml, artifacts/micro_vonet.npz, the
     motion probe forced): the results dict, wall per frame, K1 on every
     update iteration; (d) graft_entry.entry() run once: K1 launched.
     train_eval_on_card(..., H, W, n_frames, M, crop) shrinks it for a CPU
     rehearsal (the launch checks then fail by design).
 17. the geometry library (lie.py, projective.py) on the card against the
     CPU in f32, the same inputs: transform with its analytic Jacobians
     for SE3 and Sim3, flow_mag and point_cloud at E = 49,152 edges of 3x3
     patches, each group's class ops on 4,096 Random elements, finite
     gradients at the identity; every difference printed beside its
     bound, then one transform call's time and the phase's seconds.
 18. HybridVO with mirrors in flight (MIRROR_PIPELINE=2): (a) CUDA against
     the CPU at 256x320 as in phase 7 (onepass and fused_k, f32 within
     1e-3, bf16 within 1e-2), the same keyframe count on both, K1 (or K2
     once and K3 twice) on every update iteration; (b) phase 5's run with
     onepass (640x480, default.yaml + GRADIENT_BIAS, 40 frames) at k = 1
     and k = 2 in turns (ABBA), as configured and again with every
     keyframe kept (KEYFRAME_THRESH -1, where both k do the same work),
     beside the card's name and power limit:
     wall per frame over frames 10-29 as one segment (no synchronize per
     frame), device busy and idle over frames 30-39 (profiler), the
     host-device syncs per frame that torch.cuda.set_sync_debug_mode
     reports there with their call sites, and the read-back event waits
     per frame; K1 on every update iteration; (c) phase 12's LC runtime
     on CUDA against the CPU at k = 2, where no global BA on the card may
     sync or wait on a read-back and each one during the frames leaves
     its pose / depth read-back queued.
With --phases 14,16,17,18 (development; any of them) the script runs
phases 1, 2 and those named, then stops without the result lines.
Before the result lines, a summary gives each phase's seconds and
headline numbers on one line. The last two lines of stdout are a JSON
line with the kernels' numbers and {"ok": true, "device": {...}}.
"""
import collections
import contextlib
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N_PHASES = 18
CONFIG = os.path.join(REPO, 'config', 'default.yaml')
WEIGHTS = os.path.join(REPO, 'artifacts', 'micro_vonet.npz')


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'check failed: {msg}')


# the summary printed before the result lines: [phase, title, start time,
# headline numbers]; the output's tail is all a caller may see of a run
SUMMARY = []


def begin(n, title):
    """Start phase n: print its heading, open its summary line."""
    print(f'[{n}/{N_PHASES}] {title}', flush=True)
    SUMMARY.append([n, title, time.perf_counter(), []])


def note(text):
    """A headline number of the current phase, for the summary."""
    if SUMMARY:
        SUMMARY[-1][3].append(text)


def print_summary():
    """One short line per phase: its seconds and headline numbers."""
    print('summary:')
    for i, (n, title, t0, notes) in enumerate(SUMMARY):
        t1 = SUMMARY[i + 1][2] if i + 1 < len(SUMMARY) else \
            time.perf_counter()
        print(f'  [{n}] {title} ({t1 - t0:.1f} s): ' + '; '.join(notes),
              flush=True)


class SyncCounter:
    """The host-device synchronizations made inside `with` blocks, as
    torch.cuda.set_sync_debug_mode('warn') reports them: a blocking copy
    (.cpu(), a host-to-device copy from pageable memory), .item(), float()
    or bool() of a device value, a mask index, a synchronize. A wait on a
    CUDA event is not one of them. Counts them (n) and their call sites
    (sites: the Python file:line that made each)."""
    MSG = 'called a synchronizing CUDA operation'

    def __init__(self):
        self.n = 0
        self.sites = collections.Counter()

    def __enter__(self):
        import torch
        import warnings
        self._catch = warnings.catch_warnings(record=True)
        self._log = self._catch.__enter__()
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        for w in self._log:
            if self.MSG in str(w.message):
                self.n += 1
                self.sites[f'{os.path.relpath(w.filename, REPO)}:'
                           f'{w.lineno}'] += 1
        return False


def synthetic_frames(n, H, W, seed):
    """A seeded smooth RGB texture seen through a crop that moves 3 px right
    and 2 px down per frame."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    tex = gaussian_filter(rng.rand(H + 2 * n + 8, W + 3 * n + 8, 3),
                          (2.0, 2.0, 0))
    tex = (tex - tex.min()) / np.ptp(tex) * 255.0
    return [tex[2 * t:2 * t + H, 3 * t:3 * t + W].astype(np.uint8)
            for t in range(n)]


def corr_case(E, F, H1, W1, Ng, seed, kk=None):
    """Seeded f32 maps (callers round them to bf16) and coords covering the
    interior, all four borders, negative coords and coords far outside the
    map; 3x3 pixel grids with a jittered spread of up to ~3 px, except the
    first E // 16 (interior) edges, whose x and y spreads reach ~18 px: they
    overflow the fused correlation's windows (y spread > 4 px or x spread
    > 5 px at a level) at one level or both, and the select zeroes those
    pixels."""
    rng = np.random.RandomState(seed)
    gmap = rng.randn(Ng, 3, 3, 128).astype(np.float32)
    f1 = rng.randn(F, H1, W1, 128).astype(np.float32)
    f2 = rng.randn(F, H1 // 4, W1 // 4, 128).astype(np.float32)
    q = E // 6
    cx = np.concatenate([rng.uniform(4, W1 - 5, E - 5 * q),
                         rng.uniform(-6, 3, q), rng.uniform(W1 - 3, W1 + 6, q),
                         rng.uniform(4, W1 - 5, 2 * q),
                         rng.uniform(-3 * W1, 4 * W1, q)])
    cy = np.concatenate([rng.uniform(4, H1 - 5, E - 5 * q),
                         rng.uniform(4, H1 - 5, 2 * q),
                         rng.uniform(-6, 3, q), rng.uniform(H1 - 3, H1 + 6, q),
                         rng.uniform(-3 * H1, 4 * H1, q)])
    spx = rng.uniform(0.5, 1.5, (E, 1, 1))
    spy = spx.copy()
    n_ov = E // 16
    spx[:n_ov], spy[:n_ov] = rng.uniform(0.5, 9.0, (2, n_ov, 1, 1))
    off = np.linspace(-1.0, 1.0, 3)
    gx = cx[:, None, None] + spx * off[None, None, :] + \
        rng.uniform(-.3, .3, (E, 3, 3))
    gy = cy[:, None, None] + spy * off[None, :, None] + \
        rng.uniform(-.3, .3, (E, 3, 3))
    coords = np.stack([gx, gy], -1).astype(np.float32)
    if kk is None:
        kk = rng.randint(0, Ng, E)
    jj = np.sort(rng.randint(0, F, E))       # pairs arrive sorted by target
    return gmap, f1, f2, coords, kk.astype(np.int32), jj.astype(np.int32)


def kernel_vs_plain(dev, E, F, H1, W1, Ng, nv, seed, kk=None, timed=False,
                    dtype=None):
    """Kernel (bf16 maps unless dtype says otherwise: f32 maps take
    corr_onepass_kernel) vs the plain version on the same inputs, both with
    f32 output. Tolerance: |kernel - plain| <= 1e-4 * max|plain| -- both sum
    the same 128 f32 products per tap, in another order. Edges >= nv must be
    exact zeros. The bf16 output (the main path's) must be within one bf16
    rounding of it. Both of the kernel's branches (taps from the union box,
    taps from global memory for windows that overflow it; box_fits) must
    run on the live edges and be within the bound on their own. Returns
    (max_abs_err, kernel_ms, plain_ms, (bound_ms, side), staged bytes); the
    times and bound None unless timed."""
    import torch
    from dpvo_torch.ops import corr_onepass
    from dpvo_torch.ops.corr import corr_two_level as corr_plain
    gmap, f1, f2, coords, kk, jj = corr_case(E, F, H1, W1, Ng, seed, kk)
    maps = [torch.from_numpy(a).to(dev).to(dtype or torch.bfloat16)
            for a in (gmap, f1, f2)]
    co, kk_t, jj_t = (torch.from_numpy(a).to(dev) for a in (coords, kk, jj))

    out = corr_onepass.corr_two_level(*maps, co, kk_t, jj_t, nv=nv,
                                      out_dtype=torch.float32)
    ref = corr_plain(*maps, co, kk_t, jj_t, nv=nv, out_dtype=torch.float32)
    torch.cuda.synchronize()
    check(out.shape == (E, 7, 7, 3, 3, 2), f'kernel output shape {out.shape}')
    check(bool(torch.isfinite(out).all()), 'kernel output not finite')
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    check(err <= 1e-4 * scale, f'kernel vs plain: max |err| {err} > '
          f'1e-4 * {scale}')
    check(bool((out[nv:] == 0).all()), 'nonzero output past nv')
    fits = corr_onepass.box_fits(co[:nv], H1, W1, H1 // 4, W1 // 4)
    d = (out[:nv] - ref[:nv]).abs()
    for lvl in range(2):
        n_fit = int(fits[..., lvl].sum())
        n_ovf = fits[..., lvl].numel() - n_fit
        check(n_fit > 0 and n_ovf > 0, f'level {lvl + 1}: pixels in the box '
              f'{n_fit}, overflowing {n_ovf}: a branch did not run')
        errs = [d[..., lvl].masked_fill(~m[:, None, None], 0).max().item()
                for m in (fits[..., lvl], ~fits[..., lvl])]
        print(f'  level {lvl + 1}: {n_fit} live pixels from the union box '
              f'(max|kernel-plain| {errs[0]!r}), {n_ovf} overflowing it, '
              f'from global memory ({errs[1]!r})', flush=True)
    rows = corr_onepass.box_rows(co[:nv], H1, W1, H1 // 4, W1 // 4)
    staged = (int(rows.sum()) + nv * 9) * 128 * 2
    print(f'  rows staged in shared memory: {rows.float().mean(0).tolist()} '
          f'per live edge at L1 / L2, with the g rows {staged / nv / 1e3!r} '
          f'KB per live edge, {staged / 1e9!r} GB per call', flush=True)
    out16 = corr_onepass.corr_two_level(*maps, co, kk_t, jj_t, nv=nv,
                                        out_dtype=torch.bfloat16)
    err16 = (out16.float() - ref).abs() - 2 ** -8 * ref.abs()
    check(err16.max().item() <= 1e-4 * scale, 'bf16 output off by more '
          'than one rounding')
    print(f'  {maps[0].dtype} maps, E={E} F={F} L1={H1}x{W1} Ng={Ng} nv={nv}: '
          f'max|kernel-plain| = {err!r} '
          f'(max|plain| = {scale!r}, bound 1e-4 * max|plain|)', flush=True)
    if not timed:
        return err, None, None, None, staged
    from dpvo_torch.scripts._common import time_ms
    args = (*maps, co, kk_t, jj_t)
    k_ms = time_ms(lambda: corr_onepass.corr_two_level(
        *args, nv=nv, out_dtype=torch.bfloat16))
    p_ms = time_ms(lambda: corr_plain(*args, nv=nv, out_dtype=torch.bfloat16))
    bound = k1_bound(*maps, co, kk_t, jj_t, nv)
    print(f'  time (bf16 out, median of 20): kernel {k_ms!r} ms, '
          f'plain {p_ms!r} ms; bound {bound[0]!r} ms ({bound[1]})',
          flush=True)
    return err, k_ms, p_ms, bound, staged


def k1_bound(gmap, f1, f2, co, kk, jj, nv):
    """K1's roofline bound (ms, side) for this run: the g rows, map pixels
    (each pixel's 8x8 integer taps at both levels), coords, kk and jj of
    the nv live edges read once, the bf16 output of all E edges written
    once; the 8x8 tap dots and the bilinear combination of the live
    edges."""
    import torch
    from dpvo_torch.scripts import _common as cm
    E = co.shape[0]
    r = torch.arange(8, device=co.device) - 3
    nb = cm.nbytes(co[:nv], kk[:nv], jj[:nv]) + E * 7 * 7 * 9 * 2 * 2
    nb += len(set(kk[:nv].tolist())) * 9 * 128 * gmap.element_size()
    for fm, c in ((f1, co[:nv]), (f2, co[:nv] / 4.0)):
        xi = c[..., 0].floor().long().reshape(nv, 9, 1, 1)
        yi = c[..., 1].floor().long().reshape(nv, 9, 1, 1)
        nb += cm.map_bytes(jj[:nv], yi + r[:, None], xi + r, *fm.shape[:3])
    flops = 2 * nv * 9 * 64 * 128 * 2 + nv * 9 * 49 * 7 * 2
    return cm.bound_ms(nb, flops)


def fused_vs_plain(dev, E, F, H1, W1, Ng, seed):
    """K2 and K3 against their plain versions, and K2 + K3 against the
    exact correlation, on the same inputs (bf16 maps). Bounds:
      * K2 vs plain: both sum 128 f32 products per entry in another order,
        then round to bf16: |err| <= 2^-7 |plain| + 1e-5 max|plain| (the
        second term for entries that cancel to near zero);
      * K3 vs plain: the same f32 operations (no FMA contraction in either)
        on the same planes: <= 1e-6 max|plain|;
      * K2 + K3 vs the exact correlation (ops/corr.py, f32) on edges whose
        3x3 spread fits the windows: one bf16 rounding of the plane entries,
        <= 2^-8 max|plane| + 1e-5 max|exact|.
    Returns ((K2 err, ms, plain ms, bound), (K3 err, ms, plain ms, bound),
    bytes K2's bf16 kernel copies from L2), each bound (ms, side) for this
    run's bytes and operations."""
    import torch
    from dpvo_torch.ops import corr_fused as cf
    from dpvo_torch.ops.corr import corr_two_level as corr_exact
    gmap, f1, f2, coords, kk, jj = corr_case(E, F, H1, W1, Ng, seed)
    g, f1, f2 = (torch.from_numpy(a).to(dev).to(torch.bfloat16)
                 for a in (gmap, f1, f2))
    co, kk_t, jj_t = (torch.from_numpy(a).to(dev) for a in (coords, kk, jj))
    g9 = g.reshape(Ng, 9, 128)
    H2, W2 = f2.shape[1:3]
    w1 = cf.window_base(co, H1, W1, 8)
    w2 = cf.window_base(co / 4.0, H2, W2, 4)
    pargs = (g9, f1, f2, kk_t, jj_t, w1[4], w1[5], w2[4], w2[5])

    p1, p2 = cf.planes(*pargs)
    r1, r2 = cf.planes_plain(*pargs)
    torch.cuda.synchronize()
    err2 = 0.0
    for got, ref in ((p1, r1), (p2, r2)):
        got, ref = got.float(), ref.float()
        check(bool(torch.isfinite(got).all()), 'K2 output not finite')
        d = (got - ref).abs()
        bound = 2 ** -7 * ref.abs() + 1e-5 * ref.abs().max()
        check(bool((d <= bound).all()), f'K2 vs plain: {d.max().item()} '
              f'over the bound (max|plain| {ref.abs().max().item()})')
        err2 = max(err2, d.max().item())
    print(f'  K2 planes: max|kernel-plain| = {err2!r} (bound 2^-7 |plain| + '
          f'1e-5 max|plain|)', flush=True)

    def sel_args(plane, w, H, W):
        xi, yi, fx, fy, _, _, oy, ox = w
        return plane, yi, xi, fy, fx, oy, ox, H, W

    sargs = [sel_args(p1, w1, H1, W1), sel_args(p2, w2, H2, W2)]
    # pixels whose 8x8 tap block does not fit the window (oy, ox >= 0
    # always): K3's explicit zeroing branch
    over = [(w[6] > wy - 8) | (w[7] > wx - 8)
            for w, wy, wx in ((w1, cf.WY, cf.WX), (w2, cf.WY2, cf.WX2))]
    err3, scale3 = 0.0, 0.0
    sel = []
    for lvl, (a, ov) in enumerate(zip(sargs, over), 1):
        got = cf.select_taps(*a)
        ref = cf.select_plain(*a)
        torch.cuda.synchronize()
        check(got.shape == (E, 7, 7, 3, 3), f'K3 output shape {got.shape}')
        scale = ref.abs().max().item()
        d = (got - ref).abs().max().item()
        check(d <= 1e-6 * scale, f'K3 vs plain: {d} > 1e-6 * {scale}')
        # (E, dx, dy, py, px) -> (E, 9 pixels, 49 taps)
        per_pix = got.permute(0, 3, 4, 1, 2).reshape(E, 9, 49)
        ref_pix = ref.permute(0, 3, 4, 1, 2).reshape(E, 9, 49)
        n_ov = int(ov.sum())
        d_ov = (per_pix - ref_pix)[ov].abs().max().item()
        check(n_ov > 0, f'level {lvl}: no pixel overflows its window')
        check(d_ov <= 1e-6 * scale and not per_pix[ov].any(),
              f'level {lvl}: K3 does not zero the overflowing pixels '
              f'(max|kernel-plain| there {d_ov})')
        print(f'  K3 level {lvl}: {n_ov} of {E * 9} pixels overflow the '
              f'window, max|kernel-plain| on them = {d_ov!r} (all zero)',
              flush=True)
        err3, scale3 = max(err3, d), max(scale3, scale)
        sel.append(got)
    print(f'  K3 select (both levels): max|kernel-plain| = {err3!r} '
          f'(max|plain| = {scale3!r}, bound 1e-6 * max|plain|)', flush=True)

    # K2 + K3 against the exact correlation where every pixel's 8x8 block
    # fits its window at both levels
    fits = ~(over[0] | over[1]).any(1)
    c1, c2 = cf.corr_fused(g, f1, f2, co, kk_t, jj_t)
    ex = corr_exact(g, f1, f2, co, kk_t, jj_t, out_dtype=torch.float32)
    torch.cuda.synchronize()
    check(torch.equal(c1, sel[0]) and torch.equal(c2, sel[1]),
          'corr_fused differs from its own K2 + K3 launches')
    pmax = max(p1.float().abs().max().item(), p2.float().abs().max().item())
    emax = ex.abs().max().item()
    d = (torch.stack([c1, c2], -1) - ex)[fits].abs().max().item()
    bound = 2 ** -8 * pmax + 1e-5 * emax
    check(d <= bound, f'K2 + K3 vs exact: {d} > {bound}')
    print(f'  K2 + K3 vs exact correlation on {int(fits.sum())} of {E} '
          f'edges (spread fits the windows): max|err| = {d!r} (bound '
          f'2^-8 max|plane| + 1e-5 max|exact| = {bound!r})', flush=True)

    from dpvo_torch.scripts import _common as cm
    k2_ms = cm.time_ms(lambda: cf.planes(*pargs))
    p2_ms = cm.time_ms(lambda: cf.planes_plain(*pargs))
    k3_ms = cm.time_ms(lambda: [cf.select_taps(*a) for a in sargs])
    p3_ms = cm.time_ms(lambda: [cf.select_plain(*a) for a in sargs])
    n1, n2 = cf.WY * cf.WX, cf.WY2 * cf.WX2
    b2 = cm.bound_ms(
        len(set(kk)) * 9 * 128 * 2 + cm.nbytes(*pargs[3:], p1, p2) +
        cm.map_bytes(jj_t, *cm.window_yx(w1[4], w1[5], cf.WX, n1), F, H1, W1)
        + cm.map_bytes(jj_t, *cm.window_yx(w2[4], w2[5], cf.WX2, n2), F, H2,
                       W2), 2 * E * 9 * (n1 + n2) * 128)
    # K3: the planes, six per-pixel arrays per level, the f32 taps; per tap
    # the four validity-folded weights (6 operations) and the bilinear (6)
    b3 = cm.bound_ms(cm.nbytes(p1, p2, *sel) +
                     sum(cm.nbytes(*a[1:7]) for a in sargs),
                     2 * E * 441 * 12)
    print(f'  time (median of 20): K2 {k2_ms!r} ms, plain {p2_ms!r} ms, '
          f'bound {b2[0]!r} ms ({b2[1]}); K3 (both levels) {k3_ms!r} ms, '
          f'plain {p3_ms!r} ms, bound {b3[0]!r} ms ({b3[1]})', flush=True)
    # device time: back-to-back launches, K3 (both levels) in turns with K2
    k3_dev, k2_dev, _ = cm.time_paired(
        lambda: [cf.select_taps(*a) for a in sargs], lambda: cf.planes(*pargs))
    print(f'  device time in turns (back-to-back launches): K3 (both levels) '
          f'{k3_dev!r} ms, {b3[0] / k3_dev!r} of its bound; K2 {k2_dev!r} ms',
          flush=True)
    # what K2's ring copies: each edge's in-map window rows and its g rows
    rows = cf.window_rows(kk_t, jj_t, *pargs[5:], Ng, F, H1, W1, H2, W2)
    streamed = (int(rows.sum()) + E * 9) * 128 * 2
    print(f'  K2 window rows in the map: {rows.float().mean().item()!r} of '
          f'{cf.WY * cf.WX + cf.WY2 * cf.WX2} per edge; with the g rows '
          f'{streamed / E / 1e3!r} KB per edge copied from L2', flush=True)
    return (err2, k2_ms, p2_ms, b2), (err3, k3_ms, p3_ms, b3), streamed


def device_time(trace_path):
    """(busy ms, {kernel name: ms}, device op count) from a chrome trace:
    the union of GPU kernel / memcpy / memset intervals, the summed time of
    each name, and how many such ops ran."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('ph') == 'X' and e.get('cat') in
                  ('kernel', 'gpu_memcpy', 'gpu_memset')]
    by_name = {}
    for e in events:
        by_name[e['name']] = by_name.get(e['name'], 0.0) + e.get('dur', 0) / 1e3
    iv = sorted((e['ts'], e['ts'] + e.get('dur', 0)) for e in events)
    busy, lo, hi = 0.0, None, None
    for a, b in iv:
        if hi is None or a > hi:
            if hi is not None:
                busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    if hi is not None:
        busy += hi - lo
    return busy / 1e3, by_name, len(events)


def host_pace(dev, n=2000):
    """The host's pace, to tell a slower host from a slower path: ms of a
    fixed pure-Python loop, us per launch of n one-element kernels queued
    back to back on dev (median of 3 each), and the objects the Python
    garbage collector tracks (the process's heap)."""
    import gc
    import torch
    py, launch = [], []
    x = torch.zeros(1, device=dev)
    for _ in range(3):
        t0 = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc += i * i
        py.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            x.add_(1.0)
        torch.cuda.synchronize()
        launch.append(1e6 * (time.perf_counter() - t0) / n)
    return float(np.median(py)), float(np.median(launch)), \
        len(gc.get_objects())


def reset_launches():
    from dpvo_torch.ops import corr_fused, corr_onepass
    corr_onepass.launches = 0
    corr_fused.plane_launches = 0
    corr_fused.select_launches = 0


def read_launches():
    from dpvo_torch.ops import corr_fused, corr_onepass
    return dict(corr_onepass=corr_onepass.launches,
                corr_planes=corr_fused.plane_launches,
                corr_select=corr_fused.select_launches)


def make_slam(cfg, H, W, dev, corr_impl):
    """dpvo_torch.runtime.DPVO with DPVO_CORR_IMPL=corr_impl (read when the
    runtime is built), the motion probe forced (random / untrained weights
    never pass it)."""
    from dpvo_torch.runtime import DPVO, HybridVO
    old = os.environ.get('DPVO_CORR_IMPL')
    os.environ['DPVO_CORR_IMPL'] = corr_impl
    try:
        slam = DPVO(cfg, WEIGHTS, ht=H, wd=W, seed=0, device=dev)
    finally:
        if old is None:
            del os.environ['DPVO_CORR_IMPL']
        else:
            os.environ['DPVO_CORR_IMPL'] = old
    if isinstance(slam, HybridVO):
        slam.motion_probe = lambda: 100.0
    else:
        slam.force_accept = True
    return slam


# the correlation kernels of the bf16 main paths, by their names in a
# profiler trace
CORR_KERNELS = (('K1', 'corr_box_kernel'), ('K2', 'corr_planes_ring'),
                ('K3', 'corr_select_kernel'))


def main_path(dev, label, corr_impl, n_frames=40, measure=True, chunk=None,
              seq=None, **overrides):
    """DPVO at 640x480 with default.yaml (+ overrides) and the full-width
    VONet: n_frames + terminate() (or seq's frames and intrinsics, a
    make_sequence dict), launch counts set to 0 just before and read just
    after. Frames go one by one, or with chunk = K through
    DeviceVO.track_frames, K per call. With measure, the calls that start
    at frames 10 .. (the traced ones) give the wall time per frame and the
    calls from frame n-10 on (the first call starting there) a profiler
    trace. On DeviceVO the calls that start after the bootstrap frame (7,
    the probe forced) run under torch.cuda.set_sync_debug_mode: any
    host-device sync there fails the run, after its call sites are
    printed (the state machine keeps its decisions on the card). Returns
    (launches, update iterations, {poses; slam; h2d: bytes uploaded per
    frame (DeviceVO); syncs: per frame after the bootstrap (DeviceVO);
    with measure, wall, busy, idle: ms per frame and share; K1, K2, K3:
    the correlation kernels' device ms per frame})."""
    import torch
    from dpvo_torch.config import cfg as base_cfg

    H, W = 480, 640
    cfg = base_cfg.clone()
    cfg.merge_from_file(CONFIG)
    for k, v in overrides.items():
        cfg[k] = v
    if seq is None:
        frames = synthetic_frames(n_frames, H, W, seed=0)
        intr = np.array([460.0, 460.0, W / 2, H / 2], np.float32)
    else:
        frames, intr = seq['images'], seq['intrinsics']
        n_frames = len(frames)
    slam = make_slam(cfg, H, W, dev, corr_impl)
    print(f'  {label}: {type(slam).__name__}, DPVO_CORR_IMPL={corr_impl}'
          f'{f", chunks of {chunk} frames" if chunk else ""}', flush=True)
    from dpvo_torch.runtime import DeviceVO
    syncs = SyncCounter() if isinstance(slam, DeviceVO) else None
    steady = []                        # frames of the calls counted

    K = chunk or 1
    starts = range(0, n_frames, K)
    trace_start = (min(t for t in starts if t >= n_frames - 10) if measure
                   else n_frames)
    reset_launches()
    walls = []
    with tempfile.TemporaryDirectory() as tmp:
        from torch.profiler import ProfilerActivity, profile
        prof = None
        for t in starts:
            ts = list(range(t, min(t + K, n_frames)))
            if t == trace_start:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
                t_trace = time.perf_counter()
            t0 = time.perf_counter()
            with (syncs if syncs is not None and t >= 8 else
                  contextlib.nullcontext()):
                if chunk:
                    slam.track_frames(ts, np.stack(frames[t:t + K]), intr)
                else:
                    slam(t, frames[t], intr)
            torch.cuda.synchronize()
            walls.append((t, (time.perf_counter() - t0) / len(ts)))
            if syncs is not None and t >= 8:
                steady += ts
        if prof is not None:
            wall_trace = time.perf_counter() - t_trace
            prof.__exit__(None, None, None)
            path = f'{tmp}/trace.json'
            prof.export_chrome_trace(path)
            busy, by_name, n_ops = device_time(path)
        poses, tstamps = slam.terminate()
        torch.cuda.synchronize()
    launches = read_launches()

    expected = 12 + (n_frames - 8) + 12     # bootstrap + 1/frame + refine
    check(poses.shape == (n_frames, 7), f'poses shape {poses.shape}')
    check(np.isfinite(poses).all(), 'poses not finite')
    check(np.allclose(np.linalg.norm(poses[:, 3:], axis=-1), 1.0, atol=1e-3),
          'quaternions not unit')
    for name, t in slam.st.tensors().items():
        check(t.device.type == 'cuda', f'state.{name} on {t.device}')
    edges = f', live edges {len(slam.ii)}' if hasattr(slam, 'ii') else ''
    print(f'  {n_frames} frames + terminate(): keyframes n = {slam.n}'
          f'{edges}, launches {launches} (update iterations = {expected})')
    stats = dict(poses=poses, slam=slam, h2d=(slam.h2d_bytes / n_frames
                                   if hasattr(slam, 'h2d_bytes') else None),
                 syncs=None)
    if syncs is not None and steady:
        stats['syncs'] = syncs.n / len(steady)
        print(f'  host-device syncs after the bootstrap frame '
              f'(torch.cuda.set_sync_debug_mode, frames {steady[0]}..'
              f'{steady[-1]} in calls of {K}): {syncs.n}, '
              f'{stats["syncs"]!r} per frame; call sites '
              f'{dict(syncs.sites) or "none"}', flush=True)
        check(syncs.n == 0, f'{label}: {syncs.n} host-device syncs after '
              f'the bootstrap frame, at {dict(syncs.sites)}')
    if hasattr(slam, 'colors'):
        clr = slam.colors()
        check(clr.dtype == np.uint8 and clr.shape == (slam.n, slam.M, 3),
              f'colors() {clr.dtype} {clr.shape}')
    counts = ', '.join(f'{k} {v}' for k, v in launches.items() if v)
    if stats['syncs'] is not None:
        counts += f', syncs/frame {stats["syncs"]:.3g}'
    if not measure:
        note(f'{label} {corr_impl}: n = {slam.n}, launches {counts}')
        return launches, expected, stats

    # the calls from frame 10 to the trace start run without the profiler,
    # whose host-side tracing slows every launch: they give the wall time
    # and frames/s
    steady = [w for t, w in walls if 10 <= t < trace_start]
    wall_ms = 1e3 * float(np.median(steady))
    q25, q75 = (1e3 * float(q) for q in np.percentile(steady, [25, 75]))
    print(f'  steady-state wall per frame (median over the calls of frames '
          f'10..{trace_start - 1}, host clock with sync): '
          f'{wall_ms!r} ms (quartiles {q25!r}, {q75!r}) -> '
          f'{1e3 / wall_ms!r} frames/s')
    stats.update(wall=wall_ms, busy=None, idle=None)
    if busy > 0:
        nf = n_frames - trace_start
        busy_ms = busy / nf
        stats.update(busy=busy_ms, idle=1.0 - busy_ms / wall_ms)
        for key, name in CORR_KERNELS:
            stats[key] = sum(v for k, v in by_name.items() if name in k) / nf
        print(f'  device busy per frame (profiler, frames '
              f'{trace_start}..{n_frames - 1}): {busy_ms!r} ms; '
              f'idle share of the unprofiled wall {1.0 - busy_ms / wall_ms!r}; '
              f'traced wall per frame {1e3 * wall_trace / nf!r} ms; '
              f'{n_ops / nf!r} device ops per frame, '
              f'{len(by_name)} distinct names')
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        for k, v in top:
            print(f'    {v / nf:8.4f} ms/frame  {k[:100]}')
        sys.stdout.flush()
    else:
        print('  device busy per frame: not measured (no device events in '
              'the profiler trace)', flush=True)
    note(f'{label} {corr_impl}{f" chunks of {chunk}" if chunk else ""}: '
         f'wall {wall_ms:.4g} ms/frame, busy {stats["busy"] or 0:.4g}, '
         f'idle {stats["idle"] or 0:.3g}, launches {counts}')
    return launches, expected, stats


GB = dict(CENTROID_SEL_STRAT='GRADIENT_BIAS')
SMALL_RUNS = (('DeviceVO', (64, 96), 'onepass', {}, ('corr_onepass',)),
              ('HybridVO', (256, 320), 'onepass', GB, ('corr_onepass',)),
              ('HybridVO', (256, 320), 'fused_k', GB,
               ('corr_planes', 'corr_select')))


def small_cpu_vs_cuda(dev, runs=SMALL_RUNS, precisions=(False, True),
                      cover=False):
    """The runtimes on CUDA (kernels) and on the CPU (plain versions), f32,
    same frames and seed: the poses must agree, and the CUDA run must have
    launched its correlation kernels. DeviceVO at 64x96 (K1 vs ops/corr.py;
    both compute the same f32 ops with sums in another order, bound 1e-3);
    HybridVO at 256x320, M = 8, 16 frames, with onepass (its default: K1
    over the padded edge table) and with fused_k (L2 16x20, so K2 + K3 vs
    their plain versions; the planes may round to bf16 one step apart where
    the f32 sums differ in their last bits), bound 1e-3 as well. Each
    again in bf16 (MIXED_PRECISION), bound 1e-2: the network and the
    correlation maps in bf16 on both sides, with sums in another order.
    With cover, both runs must also end with the same keyframe count, and
    the CUDA run must have launched K1, or K2 once and K3 twice, per
    update iteration (the motion probe is forced: 12 bootstrap updates,
    one per tracked frame, 12 in terminate)."""
    from dpvo_torch.config import cfg as base_cfg

    for (label, (H, W), impl, extra, kernels), mixed in \
            itertools.product(runs, precisions):
        tol = 1e-2 if mixed else 1e-3
        cfg = base_cfg.clone()
        cfg.merge_from_file(CONFIG)
        cfg.PATCHES_PER_FRAME = 8
        cfg.BUFFER_SIZE = 64
        cfg.MIXED_PRECISION = mixed
        for k, v in extra.items():
            cfg[k] = v
        frames = synthetic_frames(16, H, W, seed=1)
        intr = np.array([W * 0.625, W * 0.625, W / 2, H / 2], np.float32)
        out, kf = [], []
        for d in (dev, 'cpu'):
            slam = make_slam(cfg, H, W, d, impl)
            reset_launches()
            for t, img in enumerate(frames):
                slam(t, img, intr)
            out.append(slam.terminate()[0])
            kf.append(slam.n)
            if d == dev:
                launches = read_launches()
        err = float(np.abs(out[0] - out[1]).max())
        prec = 'bf16' if mixed else 'f32'
        check(np.isfinite(out[0]).all(), f'{label}: poses not finite')
        if cover:
            iters = 12 + (len(frames) - 8) + 12
            need = dict(corr_onepass=iters, corr_planes=iters,
                        corr_select=2 * iters)
            check(kf[0] == kf[1], f'{label} {impl} {prec}: keyframes '
                  f'{kf[0]} on CUDA, {kf[1]} on the CPU')
            check(all(launches[k] >= need[k] for k in kernels),
                  f'{label} {impl} {prec} on CUDA: launches {launches}, '
                  f'{iters} update iterations')
        keys = ''.join(f' {k}={v}' for k, v in extra.items()
                       if k != 'CENTROID_SEL_STRAT')
        note(f'{label} {H}x{W} {impl} {prec}{keys} |CUDA - CPU| {err:.3g} '
             f'(n = {kf[0]})')
        check(err <= tol, f'{label} {prec}: CUDA vs CPU poses differ by '
              f'{err}')
        check(all(launches[k] > 0 for k in kernels),
              f'{label} {impl} on CUDA: launches {launches}')
        up = f', {extra["UPLOAD_FORMAT"]}' if 'UPLOAD_FORMAT' in extra else ''
        print(f'  {label} {H}x{W} {prec}, 16 frames, {impl}{up}: max |pose '
              f'CUDA - pose CPU| = {err!r} (bound {tol!r}; keyframes n = '
              f'{kf[0]} on CUDA, {kf[1]} on the CPU; CUDA launches '
              f'{launches})', flush=True)


def first_frames_poses(dev, n_frames=16, **overrides):
    """DeviceVO as in main_path, yuv420, the first n_frames on `dev`: the
    keyframe count and keyframe poses after them (no terminate())."""
    from dpvo_torch.config import cfg as base_cfg
    H, W = 480, 640
    cfg = base_cfg.clone()
    cfg.merge_from_file(CONFIG)
    for k, v in overrides.items():
        cfg[k] = v
    slam = make_slam(cfg, H, W, dev, 'onepass')
    intr = np.array([460.0, 460.0, W / 2, H / 2], np.float32)
    for t, img in enumerate(synthetic_frames(n_frames, H, W, seed=0)):
        slam(t, img, intr)
    return slam.n, slam.st.poses[:slam.n].cpu().numpy()


def ingest_and_chunks(dev, smi, rgb):
    """Phase 9: DeviceVO on yuv420 at 640x480, per frame and through
    track_frames in chunks of 8, each with K1 on every update iteration;
    chunked poses within 1e-3 of the per-frame ones (the same math frame
    by frame); the first 10 frames (the bootstrap and two tracked frames;
    the CPU's side takes ~7 s a frame at this size) on CUDA and on the CPU
    within 1e-2 (bf16, phase 7's bound). Prints wall, busy, idle and bytes uploaded
    per frame beside phase 4's rgb run (`rgb`) of this call."""
    yuv = dict(UPLOAD_FORMAT='yuv420')
    runs = {'rgb per frame (phase 4)': rgb}
    for label, chunk in (('yuv420 per frame', None),
                         ('yuv420 chunks of 8', 8)):
        launches, iters, st = main_path(dev, f'default.yaml, {label}',
                                        'onepass', chunk=chunk, **yuv)
        check(launches['corr_onepass'] >= iters, f'{label}: K1 launched '
              f'{launches["corr_onepass"]} times, expected >= {iters}')
        runs[label] = st
    err = float(np.abs(runs['yuv420 chunks of 8']['poses'] -
                       runs['yuv420 per frame']['poses']).max())
    check(err <= 1e-3, f'chunked vs per-frame poses differ by {err}')
    print(f'  yuv420: max |pose chunked - pose per frame| = {err!r} '
          f'(bound 1e-3)', flush=True)
    t0 = time.perf_counter()
    T = 10
    (n_gpu, p_gpu), (n_cpu, p_cpu) = (first_frames_poses(d, T, **yuv)
                                      for d in (dev, 'cpu'))
    err = float(np.abs(p_gpu - p_cpu).max()) if n_gpu == n_cpu else np.inf
    check(err <= 1e-2, f'yuv420 CUDA vs CPU over {T} frames: n {n_gpu} / '
          f'{n_cpu}, poses differ by {err}')
    print(f'  yuv420, first {T} frames, bf16: max |pose CUDA - pose CPU| = '
          f'{err!r} over {n_gpu} keyframes (bound 1e-2; '
          f'{time.perf_counter() - t0:.1f} s)', flush=True)
    from dpvo_torch.runtime.i420 import rgb_to_i420
    img = synthetic_frames(1, 480, 640, seed=0)[0]
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        rgb_to_i420(img)
        host.append(1e3 * (time.perf_counter() - t0))
    print(f'  host rgb_to_i420 at 640x480: {float(np.median(host))!r} ms '
          f'(median of 20; min {min(host)!r})', flush=True)
    print(f'  {smi}:')
    for label, st in runs.items():
        print(f'    {label}: wall {st["wall"]!r} ms/frame, device busy '
              f'{st["busy"]!r} ms/frame, idle share {st["idle"]!r}, '
              f'{st["h2d"]!r} bytes uploaded per frame, '
              f'{st["syncs"]!r} host-device syncs per frame after the '
              f'bootstrap', flush=True)


def accuracy_on_card(dev):
    """Phase 11: the accuracy gates of dpvo_torch.accuracy on CUDA in f32:
    the learned run (artifacts/micro_vonet.npz) on make_sequence(1234,
    T=25, 64x96) in rgb and in yuv420 against seeded random weights, K1
    launched in each trained run; then the oracle keyframe-removal scene
    (at least 3 removals, ATE < 0.01 x the path)."""
    from dpvo_torch import accuracy as acc
    from dpvo_torch.data_readers.synthetic import make_sequence
    seq = make_sequence(1234, T=25, H=64, W=96, step=0.12)
    ate = {}
    for net, up in ((WEIGHTS, 'rgb'), (WEIGHTS, 'yuv420'), (None, 'rgb')):
        reset_launches()
        ate[net, up], path = acc.learned_ate(net, seq, device=dev, upload=up)
        k1 = read_launches()['corr_onepass']
        check(k1 > 0, f'learned run {up}: K1 never launched')
        print(f'  learned ATE, {"trained" if net else "random"} weights, '
              f'{up}: {ate[net, up]!r} (path {path!r}; K1 launches {k1})',
              flush=True)
    trained, yuv, rand = (ate[WEIGHTS, 'rgb'], ate[WEIGHTS, 'yuv420'],
                          ate[None, 'rgb'])
    check(trained < 0.15 * path, f'trained ATE {trained} >= 0.15 x {path}')
    check(trained < 0.5 * rand, f'trained ATE {trained} >= 0.5 x {rand}')
    check(yuv < 0.15 * path and yuv < trained + 0.05 * path,
          f'yuv420 ATE {yuv} against rgb {trained}, path {path}')
    r = acc.oracle_removal(dev)
    removed = acc.ORACLE_FRAMES - r['keyframes']
    check(removed >= 3 and r['ate'] < 0.01 * r['path'],
          f'oracle removal: {removed} removed, ATE {r["ate"]} (path '
          f'{r["path"]})')
    print(f'  oracle keyframe removal: {removed} removals, ATE {r["ate"]!r} '
          f'(path {r["path"]!r}, bar {0.01 * r["path"]!r})', flush=True)
    note(f'learned ATE trained {trained:.4g} / yuv420 {yuv:.4g} / random '
         f'{rand:.4g} (path {path:.4g}); oracle removal ATE {r["ate"]:.3g}')


LC_RUNS = (((96, 128), 'onepass', False, ('corr_onepass',)),
           ((96, 128), 'onepass', True, ('corr_onepass',)),
           ((256, 320), 'fused_k', True, ('corr_planes', 'corr_select')))


def watch_global_ba(slam):
    """Wrap slam's global BA: each call counts the host-device syncs and
    read-back waits made inside it (both must stay 0 at MIRROR_PIPELINE >
    1). Returns the list of (syncs, waits, sites) per call."""
    calls, run = [], slam._run_global_ba

    def watched():
        reads = slam._readback.reads
        with SyncCounter() as sc:
            run()
        calls.append((sc.n, slam._readback.reads - reads, dict(sc.sites)))
    slam._run_global_ba = watched
    return calls


def lc_cpu_vs_cuda(dev, pipeline=1):
    """The LC runtime on CUDA (kernels) and on the CPU (plain versions),
    same frames, seed and weights: accuracy.lc_cfg on make_sequence(950,
    T=40, loop=True) with artifacts/micro_vonet.npz, at 96x128 (onepass,
    f32 and bf16) and at 256x320 (fused_k, bf16: L2 is 16x20, so K2 + K3
    run). The keyframe poses after the last frame and the poses terminate()
    returns within 1e-3 (f32) or 1e-2 (bf16), the same loop-edge count and
    global-BA frames, the CUDA run's kernels launched. (On
    tests/test_loop_closure.py's noise frames, which accept any loop
    candidate, terminate's 12 global BAs amplify bf16 rounding: the CPU
    tests hold that config on its discrete outputs.) With pipeline > 1
    (MIRROR_PIPELINE) no global BA on the card may block: no host-device
    sync and no read-back wait inside any call, and each one during the
    frames must leave its pose / depth read-back queued with its frame."""
    from dpvo_torch import accuracy as acc
    from dpvo_torch.data_readers.synthetic import make_sequence
    for (H, W), impl, mixed, kernels in LC_RUNS:
        tol = 1e-2 if mixed else 1e-3
        seq = make_sequence(950, T=40, H=H, W=W, step=0.12, loop=True)
        cfg = acc.lc_cfg(True)
        cfg.MIXED_PRECISION = mixed
        cfg.MIRROR_PIPELINE = pipeline
        out = []
        for d in (dev, 'cpu'):
            slam = make_slam(cfg, H, W, d, impl)
            if d == dev:
                gba = watch_global_ba(slam)
            queued = []
            reset_launches()
            for t, img in enumerate(seq['images']):
                before = slam.ran_global_ba.copy()
                tracking = slam.is_initialized
                slam(t, img, seq['intrinsics'])
                if tracking and (slam.ran_global_ba & ~before).any():
                    queued.append(bool(slam._deferred) and
                                  slam._deferred[-1][-1] is not None)
            slam._drain()
            if d == dev:
                queued_dev = queued
            kf = slam.st.poses[:slam.n].cpu().numpy().copy()
            out.append((kf, slam.terminate()[0], slam._n_loop_edges,
                        np.flatnonzero(slam.ran_global_ba).tolist(),
                        read_launches()))
        (kg, pg, lg, gg, launches), (kc, pc, lc, gc, _) = out
        err_kf = float(np.abs(kg - kc).max())
        err = float(np.abs(pg - pc).max())
        prec = 'bf16' if mixed else 'f32'
        check(np.isfinite(pg).all(), f'LC {H}x{W} {prec}: poses not finite')
        check(lg == lc and gg == gc and lg > 0, f'LC {H}x{W} {prec} {impl}: '
              f'loop edges {lg} / {lc}, global BA at {gg} / {gc}')
        check(err_kf <= tol and err <= tol, f'LC {H}x{W} {prec} {impl}: '
              f'CUDA vs CPU poses differ by {err_kf} (keyframes after the '
              f'frames), {err} (terminate)')
        check(all(launches[k] > 0 for k in kernels),
              f'LC {H}x{W} {impl} on CUDA: launches {launches}')
        print(f'  LC {H}x{W} {prec}, 40 frames, {impl}, MIRROR_PIPELINE='
              f'{pipeline}: max |pose CUDA - pose CPU| = {err_kf!r} '
              f'(keyframes after the frames), {err!r} (terminate) (bound '
              f'{tol!r}); {lg} loop edges and global BA at n = {gg} on both; '
              f'CUDA launches {launches}', flush=True)
        note(f'LC {H}x{W} {impl} {prec} k={pipeline} |CUDA - CPU| '
             f'{err:.3g}')
        if pipeline > 1:
            queued = queued_dev
            syncs = sum(c[0] for c in gba)
            waits = sum(c[1] for c in gba)
            print(f'  global BA on the card: {len(gba)} calls ({len(queued)} '
                  f'during the frames, each read-back queued: {queued}); '
                  f'syncs inside them {syncs}, read-back waits {waits}; '
                  f'sites {[c[2] for c in gba if c[2]]}', flush=True)
            check(len(queued) >= 1 and all(queued) and syncs == 0 and
                  waits == 0, f'LC {H}x{W} {impl} {prec}: a global BA '
                  f'blocked: {len(queued)} frames, queued {queued}, syncs '
                  f'{syncs}, waits {waits}')
            note(f'{len(gba)} global BAs, {syncs} syncs / {waits} waits in '
                 f'them')


def lc_gates_on_card(dev):
    """The loop-closure gates of dpvo_torch.accuracy on CUDA in f32
    (tests/test_torch_lc_ate.py's bars): oracle VO and LC ATE < 0.001 x
    the path, LC <= 2 x VO + 1e-4; learned (artifacts/micro_vonet.npz) LC
    <= 1.05 x VO + 1e-4, and < VO where VO drifts over 1% of the path, K1
    launched; loop edges proposed in both LC runs."""
    from dpvo_torch import accuracy as acc
    from dpvo_torch.data_readers.synthetic import make_sequence
    seq = make_sequence(950, T=40, H=64, W=96, step=0.12, loop=True)
    res = {}
    for kind, kw in (('oracle', dict(oracle=True)),
                     ('learned', dict(network=WEIGHTS))):
        for lc in (False, True):
            reset_launches()
            r = acc.lc_run(seq, lc, device=dev, **kw)
            k1 = read_launches()['corr_onepass']
            check(kind == 'oracle' or k1 > 0, f'{kind} run: K1 never '
                  f'launched')
            res[kind, lc] = r
            print(f'  {kind} {"LC" if lc else "VO"}: ATE {r["ate"]!r} (path '
                  f'{r["path"]!r}; loop edges {r["n_loop"]}; K1 launches '
                  f'{k1})', flush=True)
    (o_vo, o_lc), (l_vo, l_lc) = ((res[k, False], res[k, True])
                                  for k in ('oracle', 'learned'))
    path = o_lc['path']
    check(o_lc['n_loop'] > 0 and l_lc['n_loop'] > 0, 'no loop edges')
    check(o_vo['ate'] < 0.001 * path and o_lc['ate'] < 0.001 * path and
          o_lc['ate'] <= 2 * o_vo['ate'] + 1e-4,
          f'oracle gate: VO {o_vo["ate"]}, LC {o_lc["ate"]}, path {path}')
    check(l_lc['ate'] <= 1.05 * l_vo['ate'] + 1e-4 and
          (l_vo['ate'] <= 0.01 * path or l_lc['ate'] < l_vo['ate']),
          f'learned gate: VO {l_vo["ate"]}, LC {l_lc["ate"]}, path {path}')


def dpv_slam_on_card(dev, smi):
    """Phase 12 (see the module docstring)."""
    import torch
    from dpvo_torch import ba_global
    from dpvo_torch.data_readers.synthetic import make_sequence
    from dpvo_torch.loop_closure import proximity
    from dpvo_torch.runtime import dpvo as hybrid
    from dpvo_torch.scripts import _common as cm
    t_phase = time.perf_counter()

    seq = make_sequence(12, T=70, H=480, W=640, loop=True)
    over = dict(LOOP_CLOSURE=True, KEYFRAME_THRESH=-1.0)
    print(f'  make_sequence(12, T=70, 480x640, loop=True) in '
          f'{time.perf_counter() - t_phase:.1f} s; overrides of '
          f'default.yaml: {over} (MAX_EDGE_AGE, GLOBAL_OPT_FREQ and '
          f'BACKEND_THRESH at their defaults)', flush=True)
    calls = dict(proximity=[], tables=[], gba=[])
    orig = (proximity.proximity_edges, ba_global.build_pair_tables,
            hybrid.global_ba)

    def timed_proximity(slam):
        t0 = time.perf_counter()
        kk, jj = orig[0](slam)
        c = slam.cfg
        jf = len(range(max(slam.n - c.GLOBAL_OPT_FREQ, 0),
                       max(slam.n - c.KEYFRAME_INDEX, 0)))
        l = slam.n - c.REMOVAL_WINDOW
        kf = max(l, 0) - max(l - c.MAX_EDGE_AGE, 0)
        calls['proximity'].append((1e3 * (time.perf_counter() - t0),
                                   jf * kf * slam.M, len(kk)))
        return kk, jj

    def timed_tables(ii, *a, **k):
        t0 = time.perf_counter()
        out = orig[1](ii, *a, **k)
        calls['tables'].append((1e3 * (time.perf_counter() - t0), len(ii)))
        return out

    def timed_gba(*a, **k):
        args = [x.clone() if torch.is_tensor(x) else x for x in a]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig[2](*a, **k)
        torch.cuda.synchronize()
        calls['gba'].append((1e3 * (time.perf_counter() - t0), len(a[6]),
                             a[10] - a[9], args, k))
        return out

    proximity.proximity_edges = timed_proximity
    ba_global.build_pair_tables = timed_tables
    hybrid.global_ba = timed_gba
    try:
        torch.cuda.reset_peak_memory_stats()
        launches, iters, st = main_path(dev, 'default.yaml + LOOP_CLOSURE',
                                        'onepass', seq=seq, **over)
        peak = torch.cuda.max_memory_allocated()
    finally:
        proximity.proximity_edges, ba_global.build_pair_tables, \
            hybrid.global_ba = orig
    slam = st['slam']
    check(slam._n_loop_edges > 0, 'no loop edges proposed at 640x480')
    check(len(calls['gba']) > 0, 'global BA never ran at 640x480')
    check(launches['corr_onepass'] >= iters, f'LC: K1 launched '
          f'{launches["corr_onepass"]} times, expected >= {iters}')
    print(f'  loop edges {slam._n_loop_edges}, global BA calls '
          f'{len(calls["gba"])} (at n = '
          f'{np.flatnonzero(slam.ran_global_ba).tolist()} and in '
          f'terminate), inactive edges {len(slam.ii_inac)}, K1 launches '
          f'{launches["corr_onepass"]} of {iters} update iterations',
          flush=True)

    # global BA's device time: the run's last call replayed, timed alone
    # (host work included) and traced for the device's busy time
    _, E, nwin, args, kw = calls['gba'][-1]
    ms = cm.time_ms(lambda: ba_global.global_ba(*args, **kw), reps=5)
    with tempfile.TemporaryDirectory() as tmp:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ba_global.global_ba(*args, **kw)
            torch.cuda.synchronize()
        prof.export_chrome_trace(f'{tmp}/gba.json')
        busy, _, n_ops = device_time(f'{tmp}/gba.json')
    walls = [c[0] for c in calls['gba']]
    print(f'  global BA in the run: {len(walls)} calls, wall per call '
          f'(host clock, synchronized) median {float(np.median(walls))!r} '
          f'ms, max {max(walls)!r}; edges per call '
          f'{[c[1] for c in calls["gba"]]}, window frames '
          f'{sorted(set(c[2] for c in calls["gba"]))}', flush=True)
    print(f'  global BA, the last call replayed ({E} edges, {nwin} window '
          f'frames): {ms!r} ms per call (CUDA events, median of 5, host '
          f'work included), device busy {busy!r} ms in {n_ops} device ops '
          f'(profiler)', flush=True)
    for key, label in (('proximity', 'proximity_edges'),
                       ('tables', 'build_pair_tables')):
        t = [c[0] for c in calls[key]]
        print(f'  host {label}: {len(t)} calls, median {float(np.median(t))!r}'
              f' ms, max {max(t)!r} ms; per call ' +
              (f'candidates {[c[1] for c in calls[key]]}, edges returned '
               f'{[c[2] for c in calls[key]]}' if key == 'proximity' else
               f'edges {[c[1] for c in calls[key]]}'), flush=True)
    print(f'  {smi}: LC wall {st["wall"]!r} ms/frame, device busy '
          f'{st["busy"]!r} ms/frame, idle share {st["idle"]!r}; peak device '
          f'memory (max_memory_allocated) {peak / 2 ** 30!r} GiB; gmap '
          f'{slam.st.gmap.numel() * slam.st.gmap.element_size() / 1e6!r} MB',
          flush=True)

    print('  K1 and K2 + K3 at the LC ring (Ng = 96,000 g rows, kk over the '
          'whole ring):', flush=True)
    kernel_vs_plain(dev, E=49152, F=36, H1=120, W1=160, Ng=96000, nv=40013,
                    seed=12, timed=True)
    fused_vs_plain(dev, E=49152, F=36, H1=120, W1=160, Ng=96000, seed=13)

    print('  the LC runtime, CUDA vs CPU:', flush=True)
    lc_cpu_vs_cuda(dev)
    print('  the loop-closure ATE gates, f32:', flush=True)
    lc_gates_on_card(dev)
    print(f'  phase 12: {time.perf_counter() - t_phase:.1f} s', flush=True)


def backward_case(dev, dtype, seed):
    """Phase 13's backward inputs at the reference training size:
    edge_schedule(15, 80, 18)'s final 18,000 edges (its kk and jj), 15
    frames of 120x160 and 30x40 maps in `dtype`, Ng = 1,200, coords spread
    as corr_case spreads them (1/16 of the edges up to ~18 px), a N(0, 1)
    output gradient. Returns (corr_backward's arguments, kk as numpy)."""
    import torch
    from dpvo_torch.scripts import _common as cm
    from dpvo_torch.train.trainer import edge_schedule
    _, jj, kk, *_ = edge_schedule(15, 80, 18)[-1]
    E, F, H1, W1, Ng = len(kk), 15, 120, 160, 1200
    gmap, f1, f2, coords, _, _ = corr_case(E, F, H1, W1, Ng, seed, kk=kk)
    maps = [torch.from_numpy(a).to(dev).to(dtype) for a in (gmap, f1, f2)]
    co = torch.from_numpy(coords).to(dev)
    go = cm.normal(np.random.default_rng(seed), (E, 7, 7, 3, 3, 2), dev,
                   torch.float32)
    return (*maps, co, cm.ints(kk, dev), cm.ints(jj, dev), go), kk


def backward_kernels_us(fn, reps=10):
    """{kernel: mean device us per launch} of the kernels of reps calls of
    fn (corr_backward's bw_prep, bw_frames, bw_tiles by those names, the
    others by the first 40 characters of theirs), from a profiler trace:
    each name's device time over its own count of launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    tot, cnt = {}, {}
    for e in prof.key_averages():
        if e.device_time_total <= 0 or not e.count:
            continue
        m = re.search(r'(bw_\w+)', e.key)
        name = m.group(1) if m else e.key[:40]
        tot[name] = tot.get(name, 0.0) + e.device_time_total
        cnt[name] = cnt.get(name, 0) + e.count
    return {k: tot[k] / cnt[k] for k in tot}


def backward_vs_plain(dev, dtype, seed):
    """Phase 13: the correlation backward kernels against
    corr_backward_plain on backward_case's inputs. Tolerance: f32 maps
    1e-5 * max|plain| (another sum order; dgmap's atomics change it from
    run to run); bf16 maps, whose gradients are rounded once to bf16, one
    bf16 rounding more (2^-8 * |plain|). dfmap1 / dfmap2 must be
    bit-identical over two launches (each tile summed by one block in a
    fixed order). Prints the work the binning made (entries, batches,
    pixels summed with their box and on their own, dgmap atomics), the
    kernels' device us, and the device time with 80% of the output-gradient
    rows zero (the trainer's backward edge dropout), also held against
    plain. Returns (max_abs_err, kernel ms, plain ms, (bound ms, side),
    device ms)."""
    import torch
    from dpvo_torch.ops import corr_grad
    from dpvo_torch.ops.corr_grad import corr_backward, corr_backward_plain
    from dpvo_torch.scripts import _common as cm
    args, kk = backward_case(dev, dtype, seed)
    maps, (co, kk_t, jj_t, go) = args[:3], args[3:]
    E = co.shape[0]
    F, H1, W1 = maps[1].shape[:3]

    def against_plain(label, got, ref):
        err = 0.0
        for name, a, b in zip(('dgmap', 'dfmap1', 'dfmap2'), got, ref):
            check(a.shape == b.shape and a.dtype == dtype, f'{name} '
                  f'{tuple(a.shape)} {a.dtype}')
            check(bool(torch.isfinite(a).all()), f'{name} not finite')
            m = b.abs().max().item()
            d = (a.float() - b).abs()
            bound = 1e-5 * m + (2 ** -8 * b.abs() if dtype == torch.bfloat16
                                else 0.0)
            check(bool((d <= bound).all()), f'corr_backward {name} ({dtype}'
                  f', {label}) vs plain: max |err| {d.max().item()} at '
                  f'max|plain| {m}')
            err = max(err, d.max().item())
            print(f'  {name} ({label}): max|kernel - plain| '
                  f'{d.max().item()!r} at max|plain| {m!r}', flush=True)
        return err

    got = corr_backward(*args)
    again = corr_backward(*args)
    ref = corr_backward_plain(*args)
    torch.cuda.synchronize()
    err = against_plain('all rows', got, ref)
    same = [torch.equal(a, b) for a, b in zip(got[1:], again[1:])]
    check(all(same), f'dfmap1 / dfmap2 not bit-identical over two launches '
          f'({same})')
    dg_spread = (got[0].float() - again[0].float()).abs().max().item()
    print(f'  dfmap1, dfmap2 bit-identical over two launches; dgmap (f32 '
          f'atomics) differs by {dg_spread!r}', flush=True)
    del again, ref
    k_ms = cm.time_ms(lambda: corr_backward(*args))
    p_ms = cm.time_ms(lambda: corr_backward_plain(*args))
    dev_ms, _ = cm.device_ms(lambda: corr_backward(*args), rounds=3, reps=5)
    # bound: the g rows of the distinct kk, the map pixels the windows
    # touch, coords, kk, jj and the output gradient read once; the three
    # gradients written once, whole maps at the maps' element size (what
    # the wrapper returns); per in-map tap and channel dg += d * f and
    # df += d * g: 4 f32 operations on the CUDA cores (67 TFLOP/s; no
    # tensor-core work)
    r = torch.arange(8, device=dev) - 3
    el = maps[0].element_size()
    nb = cm.nbytes(co, kk_t, jj_t, go) + sum(m.numel() for m in maps) * el
    nb += len(set(kk.tolist())) * 9 * 128 * el
    taps = 0
    for fm, c in ((maps[1], co), (maps[2], co / 4.0)):
        xi = c[..., 0].floor().reshape(E, 9, 1, 1)
        yi = c[..., 1].floor().reshape(E, 9, 1, 1)
        xi, yi = (torch.nan_to_num(v, nan=-1e4).clamp(-1e4, 1e4).long()
                  for v in (xi, yi))
        y, x = yi + r[:, None], xi + r
        nb += cm.map_bytes(jj_t, y, x, *fm.shape[:3]) // 2 * el
        taps += int(((y >= 0) & (y < fm.shape[1]) & (x >= 0) &
                     (x < fm.shape[2])).sum())
    bound = cm.bound_ms(nb, 4 * 128 * taps, cm.F32_FLOP_PER_S)
    thr, smem, per_sm = corr_grad.occupancy(dtype)
    work = corr_grad.backward_work(*args)
    st, masks = work['stats'], work['masks']
    entries = int(st[:, 0].sum() + st[:, 1].sum())
    n_items = int(st[:, 3].sum())
    own = sum(int(((masks >> (9 + p)) & 1).sum()) for p in range(9))
    boxed = sum(int(((masks >> p) & 1).sum()) for p in range(9))
    us = backward_kernels_us(lambda: corr_backward(*args))
    print(f'  corr_backward ({dtype} maps, E = {E}, {F} frames of '
          f'{H1}x{W1} / {H1 // 4}x{W1 // 4}, Ng = {maps[0].shape[0]}): '
          f'kernels {k_ms!r} ms alone (median of 20), device {dev_ms!r} ms '
          f'(back-to-back), plain {p_ms!r} ms; bound {bound[0]!r} ms '
          f'({bound[1]}: {nb / 1e6:.1f} MB, {taps} in-map taps, '
          f'{4 * 128 * taps / 1e9:.2f} GFLOP f32)', flush=True)
    print(f'  tiles {corr_grad.TILES[dtype]} (level 1, level 2: rows x '
          f'columns), {work["tiles"]} blocks, {thr} threads, {smem} B '
          f'shared, {per_sm} blocks per SM; device us per call '
          f'{ {k: round(v, 3) for k, v in us.items()} }', flush=True)
    print(f'  binning: {entries} entries ({int(st[:, 0].sum())} box, '
          f'{int(st[:, 1].sum())} one pixel) in {n_items} batches of at '
          f'most 256 ({entries / max(n_items, 1):.2f} entries per batch, '
          f'at most {int((st[:, 0] + st[:, 1]).max())} entries in a tile); '
          f'edge pixels summed with their box {boxed}, on their own {own}; '
          f'dgmap atomics {128 * int(st[:, 2].sum())} (one per entry, pixel '
          f'with a tap in the tile and channel; the atomics design issued '
          f'{E * 2 * 9 * 128} on dgmap and {128 * taps} on the maps); '
          f'global atomics on dfmap1 / dfmap2: 0', flush=True)
    del work
    # the trainer's backward edge dropout: 80% of the rows zero
    keep = torch.from_numpy(np.random.RandomState(seed).rand(E) < 0.2)
    go80 = go * keep.to(dev)[:, None, None, None, None, None]
    args80 = (*maps, co, kk_t, jj_t, go80)
    against_plain('80% rows zero', corr_backward(*args80),
                  corr_backward_plain(*args80))
    z_ms, f_ms, ratios = cm.time_paired(lambda: corr_backward(*args80),
                                        lambda: corr_backward(*args))
    print(f'  80% of the output-gradient rows zero: device {z_ms!r} ms in '
          f'turns with all rows {f_ms!r} ms, ratio {z_ms / f_ms!r} (rounds '
          f'{min(ratios)!r} .. {max(ratios)!r})', flush=True)
    return err, k_ms, p_ms, bound, dev_ms


def train_cpu_vs_cuda(dev):
    """Phase 13: one train step's loss and parameter gradients, full-width
    VONet, f32, on CUDA (K1, the backward kernel) and on the CPU (plain
    versions): make_batch([11], T=8, M=4, 64x96), edge_schedule(8, 4, 2),
    the unroll tests/test_torch_trainer.py holds against dpvo_tpu. The loss
    within 1e-5 relative and the whole gradient within 1e-3 relative L2,
    its bounds; each parameter's gradient (above 1e-6 of the global norm)
    within 3e-3 relative L2, wider than the CPU test's 1e-3 because the
    backward's atomics change the sum order from run to run and the
    unrolled BA amplifies it: the step runs twice on the card and the two
    runs' spread is printed beside the limit. Each further unroll step
    amplifies f32 rounding more. The limit's other side: the step again
    with two planted faults in the backward kernel's output, dfmap2 zeroed
    (the gate must fail it) and dfmap1 scaled by 1.01 (printed). Then
    make_train_step's whole step on the card: finite, parameters moved."""
    import torch
    from dpvo_torch.data_readers.synthetic import make_batch
    from dpvo_torch.models.vonet import init_vonet
    from dpvo_torch.ops import corr_grad, corr_onepass
    from dpvo_torch.train import trainer as tt
    batch = make_batch([11], T=8, M=4, H=64, W=96)
    sched = tt.edge_schedule(8, 4, 2)

    def grads(d):
        net = init_vonet(None, d)
        args = [torch.from_numpy(batch[k][0]).to(d) for k in tt.SEQ_KEYS]
        k1, bw = corr_onepass.launches, corr_grad.backward_launches
        traj = tt.vonet_forward(net, *args, sched)
        loss, _ = tt.trajectory_loss(traj, args[1])
        loss.backward()
        n = (corr_onepass.launches - k1, corr_grad.backward_launches - bw)
        if d.type == 'cuda':
            check(n == (len(sched), len(sched)), f'K1 / corr_backward '
                  f'launched {n} times, expected {len(sched)} each')
        return loss.item(), {k: p.grad.detach().cpu()
                             for k, p in net.named_parameters()}

    def against(ref, got):
        """(loss rel, whole gradient rel L2, (worst per-parameter rel L2,
        its name), parameters held, parameters over 3e-3)."""
        (l_ref, g_ref), (l_got, g_got) = ref, got
        gnorm = float(torch.sqrt(sum((g ** 2).sum() for g in g_ref.values())))
        worst, held, over, d2 = (0.0, ''), 0, 0, 0.0
        for k, r in g_ref.items():
            check(bool(torch.isfinite(g_got[k]).all()), f'{k}: CUDA gradient '
                  f'not finite')
            d2 += float(((g_got[k] - r) ** 2).sum())
            n = float(r.norm())
            if n > 1e-6 * gnorm:
                e = float((g_got[k] - r).norm()) / n
                held, over = held + 1, over + (e > 3e-3)
                worst = max(worst, (e, k))
        return (abs(l_got - l_ref) / abs(l_ref), d2 ** 0.5 / gnorm, worst,
                held, over)

    def faulty(edit):
        orig = corr_grad.corr_backward
        corr_grad.corr_backward = lambda *a: edit(orig(*a))
        try:
            return grads(dev)
        finally:
            corr_grad.corr_backward = orig

    cpu, cuda = grads(torch.device('cpu')), grads(dev)
    rel, whole, worst, held, _ = against(cpu, cuda)
    spread = against(cuda, grads(dev))
    print(f'  train step CUDA vs CPU (f32, T=8, M=4, 64x96, 2 unroll '
          f'steps): loss {cuda[0]!r} vs {cpu[0]!r} (rel {rel!r}); the whole '
          f'gradient relative L2 {whole!r}; {held} parameters, worst '
          f'relative L2 {worst[0]!r} ({worst[1]}); two CUDA runs: loss rel '
          f'{spread[0]!r}, whole {spread[1]!r}, worst {spread[2][0]!r} '
          f'({spread[2][1]})', flush=True)
    check(rel <= 1e-5, f'loss CUDA vs CPU rel {rel}')
    check(whole <= 1e-3, f'gradient CUDA vs CPU: relative L2 {whole}')
    check(worst[0] <= 3e-3, f'gradients CUDA vs CPU: worst relative L2 '
          f'{worst}')
    for label, edit in (
            ('dfmap2 zeroed', lambda g: (g[0], g[1], torch.zeros_like(g[2]))),
            ('dfmap1 x 1.01', lambda g: (g[0], g[1] * 1.01, g[2]))):
        _, f_whole, f_worst, _, f_over = against(cpu, faulty(edit))
        print(f'  planted fault, {label}: the whole gradient relative L2 '
              f'{f_whole!r}, worst {f_worst[0]!r} ({f_worst[1]}), '
              f'{f_over} of {held} parameters over 3e-3', flush=True)
        if label == 'dfmap2 zeroed':
            check(f_whole > 1e-3 or f_worst[0] > 3e-3, 'the gradient gate '
                  'passes a backward that drops dfmap2')
    net = init_vonet(None, dev)
    before = [p.detach().clone() for p in net.parameters()]
    opt = tt.make_optimizer(net.parameters(), lr=1e-3, total_steps=100)
    step = tt.make_train_step(net, opt, sched, mixed_precision=False)
    loss, _ = step(batch)
    check(bool(torch.isfinite(loss)), 'make_train_step loss not finite')
    check(all(bool(torch.isfinite(p).all()) for p in net.parameters()) and
          any(not torch.equal(p, q) for p, q in zip(net.parameters(),
                                                   before)),
          'make_train_step left the parameters unmoved or not finite')


def train_reference_size(dev, smi, n_full=3):
    """Phase 13: the reference training size, as train.py runs it:
    edge_schedule(15, 80, 18), batch 1, 15 frames of make_sequence at
    480x640, bf16 mixed precision, the full-width VONet from seeded weights;
    one structure-only step, then n_full full steps, counts set to 0 just
    before and read just after: K1 and corr_backward 18 times per step.
    The last step runs under the profiler (device busy, idle share against
    the untraced steps' median wall, top kernels). Returns the launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dpvo_torch.data_readers.synthetic import make_batch_from, \
        make_sequence
    from dpvo_torch.models.vonet import init_vonet
    from dpvo_torch.ops import corr_grad, corr_onepass
    from dpvo_torch.train import trainer as tt
    t0 = time.perf_counter()
    seq = make_sequence(21, T=15, H=480, W=640)
    batch = make_batch_from([seq], np.random.RandomState(0), 80)
    sched = tt.edge_schedule(15, 80, 18)
    print(f'  make_sequence(21, T=15, 480x640) in '
          f'{time.perf_counter() - t0:.1f} s; edges per unroll step '
          f'{len(sched[0][0])} .. {len(sched[-1][0])}, '
          f'{sum(len(s[0]) for s in sched)} edge-steps', flush=True)
    net = init_vonet(None, dev)
    opt = tt.make_optimizer(net.parameters(), lr=8e-5, total_steps=240000)
    steps = [tt.make_train_step(net, opt, sched, structure_only=so,
                                mixed_precision=True)
             for so in (True, False)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    corr_onepass.launches = corr_grad.backward_launches = 0
    walls, losses = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(1 + n_full):
            traced = i == n_full
            if traced:
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
            ts = time.perf_counter()
            loss, aux = steps[min(i, 1)](batch)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - ts))
            losses.append(loss.item())
            grads_ok = all(bool(torch.isfinite(p).all())
                           for p in net.parameters())
            check(np.isfinite(losses[-1]) and grads_ok, f'step {i}: loss '
                  f'{losses[-1]}, parameters finite {grads_ok}')
            if traced:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(f'{tmp}/train.json')
                busy, by_name, n_ops = device_time(f'{tmp}/train.json')
    launches = dict(corr_onepass=corr_onepass.launches,
                    corr_backward=corr_grad.backward_launches)
    peak = torch.cuda.max_memory_allocated()
    n_steps = 1 + n_full
    check(launches == dict(corr_onepass=18 * n_steps,
                           corr_backward=18 * n_steps),
          f'launches {launches}, expected 18 per step of {n_steps}')
    wall = float(np.median(walls[1:-1])) if n_full > 1 else walls[-1]
    print(f'  {n_steps} steps (1 structure-only, {n_full} full): losses '
          f'{losses}; wall ms per step {walls} (the last traced); launches '
          f'{launches}', flush=True)
    print(f'  {smi}: full step wall {wall!r} ms (median of the untraced '
          f'full steps), device busy {busy!r} ms in {n_ops} device ops '
          f'(profiler, the last step), idle share {1.0 - busy / wall!r}; '
          f'traced step {walls[-1]!r} ms; peak device memory '
          f'(max_memory_allocated) {peak / 2 ** 30!r} GiB', flush=True)
    note(f'train step wall {wall:.5g} ms, busy {busy:.5g}, '
         f'{peak / 2 ** 30:.3g} GiB')
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f'    {v:9.3f} ms/step  {k[:100]}')
    bw = {re.search(r'bw_\w+', k).group(0): v for k, v in by_name.items()
          if re.search(r'bw_\w+', k)}
    print(f'  corr_backward\'s kernels: {sum(bw.values())!r} ms/step '
          f'{bw}', flush=True)
    return launches


def train_on_card(dev, smi):
    """Phase 13 (see the module docstring). Returns the corr_backward
    entry of the kernels line."""
    import torch
    t_phase = time.perf_counter()
    from dpvo_torch.train.trainer import edge_schedule
    errs = {dtype: backward_vs_plain(dev, dtype, seed)
            for dtype, seed in ((torch.float32, 30), (torch.bfloat16, 31))}
    print('  K1 at the training shapes (edge_schedule(15, 80, 18)\'s final kk, '
          'every edge live, 15 frames, Ng = 1,200):', flush=True)
    kk = edge_schedule(15, 80, 18)[-1][2]
    for dtype, seed in ((torch.bfloat16, 32), (torch.float32, 33)):
        kernel_vs_plain(dev, E=len(kk), F=15, H1=120, W1=160, Ng=1200,
                        nv=len(kk), seed=seed, kk=kk, dtype=dtype)
    train_cpu_vs_cuda(dev)
    launches = train_reference_size(dev, smi)
    err, k_ms, p_ms, bound, _ = errs[torch.bfloat16]
    print(f'  phase 13: {time.perf_counter() - t_phase:.1f} s', flush=True)
    return dict(name='corr_backward', route='cuda',
                source='dpvo_torch/csrc/corr_backward.cu',
                replaces='dpvo_tpu/train/trainer.py:220',
                launches=launches['corr_backward'], max_abs_err=err,
                ms=k_ms, plain_ms=p_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=None)


def classic_timers():
    """Wrap the classic backend's steps (class and module attributes of
    dpvo_torch.loop_closure.long_term) with timers; returns (calls, undo).
    calls: per close_loop, host ms of ORB + matching, structure-only BA
    device ms (CUDA events) and host ms, RANSAC host ms, its result; per
    applied PGO result, host ms from submission to the result polled; the
    arguments of the first structure-only BA."""
    import torch
    from dpvo_torch.loop_closure import long_term as lt
    L = lt.LongTermLoopClosure
    orig = dict(detect=L._detect, match=L._match, close=L.close_loop,
                callback=L.lc_callback, tri=lt.triangulate,
                ransac=lt.ransac_umeyama)
    calls = dict(close=[], pgo=[], first_triplet=None)
    cur = dict(orb=0.0, ba=0.0, ba_host=0.0, ransac=0.0)

    def host(key, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            cur[key] += 1e3 * (time.perf_counter() - t0)
            return out
        return wrapped

    def tri(*a, **k):
        if calls['first_triplet'] is None:
            calls['first_triplet'] = (a, k)
        cuda = torch.device(k.get('device', 'cpu')).type == 'cuda'
        if cuda:
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        out = orig['tri'](*a, **k)
        cur['ba_host'] += 1e3 * (time.perf_counter() - t0)
        if cuda:
            e1.record()
            e1.synchronize()
            cur['ba'] += e0.elapsed_time(e1)
        return out

    def close(self, i, j, n):
        for key in cur:
            cur[key] = 0.0
        t0 = time.perf_counter()
        ok = orig['close'](self, i, j, n)
        calls['close'].append(dict(cur, i=i, j=j, closed=ok,
                                   ms=1e3 * (time.perf_counter() - t0)))
        if ok:
            self._t_submit = time.perf_counter()
        return ok

    def callback(self, skip_if_empty=True):
        busy = self.lc_in_progress
        orig['callback'](self, skip_if_empty)
        if busy and not self.lc_in_progress:
            calls['pgo'].append(1e3 * (time.perf_counter() - self._t_submit))

    L._detect = host('orb', orig['detect'])
    L._match = host('orb', orig['match'])
    L.close_loop = close
    L.lc_callback = callback
    lt.triangulate = tri
    lt.ransac_umeyama = host('ransac', orig['ransac'])

    def undo():
        L._detect, L._match = orig['detect'], orig['match']
        L.close_loop, L.lc_callback = orig['close'], orig['callback']
        lt.triangulate, lt.ransac_umeyama = orig['tri'], orig['ransac']
    return calls, undo


def print_close_calls(calls):
    for c in calls['close']:
        print(f'    close_loop(i={c["i"]}, j={c["j"]}): closed {c["closed"]}, '
              f'{c["ms"]!r} ms host: ORB + matching {c["orb"]!r} ms, '
              f'structure-only BA {c["ba"]!r} ms device ({c["ba_host"]!r} ms '
              f'host), RANSAC {c["ransac"]!r} ms', flush=True)
    for ms in calls['pgo']:
        print(f'    PGO worker: {ms!r} ms from submission to the result '
              f'polled (host clock; the poll runs once per frame)',
              flush=True)


def structure_only_cpu_vs_cuda(dev, args, label):
    """(d): the triplet's structure-only BA on CUDA and on the CPU; depths
    within 1e-4. Returns the CUDA time per call."""
    from dpvo_torch.loop_closure.long_term import triangulate
    from dpvo_torch.scripts import _common as cm
    d_cuda = triangulate(*args, device=dev)
    d_cpu = triangulate(*args, device='cpu')
    err = float(np.abs(d_cuda - d_cpu).max())
    check(np.isfinite(d_cuda).all() and err <= 1e-4,
          f'structure-only BA on {label}: CUDA vs CPU depths differ by {err}')
    ms = cm.time_ms(lambda: triangulate(*args, device=dev), reps=10)
    print(f'  (d) structure-only BA on {label} ({len(args[1])} keypoints, 6 '
          f'iterations): max |depth CUDA - depth CPU| = {err!r} (bound '
          f'1e-4); {ms!r} ms per call on CUDA (CUDA events, median of 10, '
          f'host work and the depths\' copy back included)', flush=True)


def classic_cpu_vs_cuda(dev):
    """(c): classic_run with the trained weights, no oracle, bf16, sync_pgo,
    the same seed on both devices."""
    from dpvo_torch import accuracy as acc
    out = {}
    for d in (dev, 'cpu'):
        reset_launches()
        out[d] = acc.classic_run(d, network=WEIGHTS, oracle=False,
                                 mixed=True)
        out[d]['launches'] = read_launches()
    g, c = out[dev], out['cpu']
    err = float(np.abs(g['poses'] - c['poses']).max())
    iters = 12 + (acc.CLASSIC_FRAMES - 8) + 12
    k1 = g['launches']['corr_onepass']
    print(f'  (c) trained weights, bf16, CUDA vs CPU: max |pose CUDA - pose '
          f'CPU| = {err!r} (bound 1e-2); lc_count {g["lc_count"]} / '
          f'{c["lc_count"]}, loops {g["loops"]} / {c["loops"]}; ATE '
          f'{g["ate"]!r} / {c["ate"]!r} (path {g["path"]!r}); K1 launches '
          f'{k1} of {iters} update iterations', flush=True)
    check(np.isfinite(g['poses']).all() and err <= 1e-2,
          f'classic CUDA vs CPU poses differ by {err}')
    check(g['lc_count'] == c['lc_count'] and g['loops'] == c['loops'],
          f'classic CUDA vs CPU: lc_count {g["lc_count"]} / {c["lc_count"]},'
          f' loops {g["loops"]} / {c["loops"]}')
    check(k1 >= iters, f'(c): K1 launched {k1} times, expected >= {iters}')


def classic_on_card(dev, smi):
    """Phase 14 (see the module docstring)."""
    import importlib.util
    import torch
    from dpvo_torch import accuracy as acc
    from dpvo_torch.loop_closure.retrieval import retrieval_native
    t_phase = time.perf_counter()
    check(importlib.util.find_spec('cv2') is not None,
          'classic loop closure needs the cv2 module (ORB, matching, the '
          'JPEG cache), which this host lacks')
    import cv2
    t0 = time.perf_counter()
    so = retrieval_native.library_path()
    print(f'  cv2 {cv2.__version__}; retrieval library {so.name} (g++ '
          f'{" ".join(retrieval_native.FLAGS)}, no OpenCV) ready in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)

    # (a) full width
    gt, frames, intr = acc.classic_scene(n=48, H=480, W=640)
    over = dict(CLASSIC_LOOP_CLOSURE=True, KEYFRAME_THRESH=-1.0,
                **acc.CLASSIC_RETRIEVAL)
    calls, undo = classic_timers()
    try:
        torch.cuda.reset_peak_memory_stats()
        launches, iters, st = main_path(
            dev, 'default.yaml + CLASSIC_LOOP_CLOSURE', 'onepass',
            seq=dict(images=frames, intrinsics=intr), **over)
        peak = torch.cuda.max_memory_allocated()
    finally:
        undo()
    lc = st['slam'].long_term_lc
    print(f'  (a) 48 frames of the out-and-back plane at 480x640, overrides '
          f'of default.yaml {over}: {len(calls["close"])} retrieval '
          f'candidates, lc_count {lc.lc_count}, loops '
          f'{list(zip(lc.loop_ii.tolist(), lc.loop_jj.tolist()))}; K1 '
          f'launches {launches["corr_onepass"]} of {iters} update '
          f'iterations', flush=True)
    print_close_calls(calls)
    note(f'(a) {len(calls["close"])} candidates, lc_count {lc.lc_count}')
    closes = [c['ms'] for c in calls['close']]
    print(f'  {smi}: classic LC wall {st["wall"]!r} ms/frame, device busy '
          f'{st["busy"]!r} ms/frame, idle share {st["idle"]!r}; close_loop '
          f'stall (host ms per call) {closes!r}; peak device memory '
          f'(max_memory_allocated) {peak / 2 ** 30!r} GiB', flush=True)
    check(len(calls['close']) >= 1, '(a): retrieval proposed no candidate')
    check(launches['corr_onepass'] >= iters, f'(a): K1 launched '
          f'{launches["corr_onepass"]} times, expected >= {iters}')

    # (b) the oracle gate in f32
    calls, undo = classic_timers()
    try:
        r = acc.classic_run(dev)
    finally:
        undo()
    print(f'  (b) oracle, f32, 36 frames at 128x192: lc_count '
          f'{r["lc_count"]}, loops {r["loops"]}, ATE {r["ate"]!r} (path '
          f'{r["path"]!r}, bar {0.05 * r["path"]!r})', flush=True)
    note(f'(b) oracle lc_count {r["lc_count"]}, ATE {r["ate"]:.3g}')
    print_close_calls(calls)
    check(r['lc_count'] >= 1 and r['ate'] < 0.05 * r['path'],
          f'(b): lc_count {r["lc_count"]}, ATE {r["ate"]}, path {r["path"]}')
    check(calls['first_triplet'] is not None, '(b): no triplet triangulated')

    classic_cpu_vs_cuda(dev)
    a, k = calls['first_triplet']
    structure_only_cpu_vs_cuda(dev, a, '(b)\'s first triplet')
    print(f'  phase 14: {time.perf_counter() - t_phase:.1f} s', flush=True)


# --------------------------------------------------------------------------
# phase 15: the entry points (demo, viewer, MultiStreamVO, evaluate_*)
# --------------------------------------------------------------------------

def stream_frames(n, H, W, B, seed, offset=32):
    """(n, B, H, W, 3): synthetic_frames' moving crop, stream b starting
    offset * b px further right in one texture."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    tex = gaussian_filter(rng.rand(H + 2 * n + 8, W + 3 * n + 8 + offset * B,
                                   3), (2.0, 2.0, 0))
    tex = ((tex - tex.min()) / np.ptp(tex) * 255.0).astype(np.uint8)
    return np.stack([np.stack([tex[2 * t:2 * t + H, 3 * t + offset * b:
                                   3 * t + offset * b + W] for b in range(B)])
                     for t in range(n)])


def left_bootstrap(slam):
    from dpvo_torch.runtime import DeviceVO
    return bool(slam.st.is_init if isinstance(slam, DeviceVO)
                else slam.is_initialized)


def force_probe(slam):
    """Skip the learned motion probe (the micro weights never pass it)."""
    from dpvo_torch.runtime import HybridVO
    if isinstance(slam, HybridVO):
        slam.motion_probe = lambda: 100.0
    else:
        slam.force_accept = True


def timed_pushes(slam):
    """Wrap the runtime's viewer push: host ms of each call, the device
    synchronized around it (DeviceVO's read-back, HybridVO's host
    snapshot)."""
    import torch
    ms, inner = [], slam._push_viewer_state

    def push():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    slam._push_viewer_state = push
    return ms


def demo_main(argv, force, profile=False):
    """dpvo_torch.demo.main(argv) in this process (its reader is a spawn
    process), the runtime captured and, with force, its motion probe
    forced; stdout kept apart. Returns (slam, launches, wall s, per-frame
    Timer ms, viewer push ms, device busy ms or None)."""
    import contextlib
    import io
    import torch
    from dpvo_torch import demo, utils
    real, built, pushes = demo.DPVO, [], []

    def make(*args, **kwargs):
        slam = real(*args, **kwargs)
        if force:
            force_probe(slam)
        if slam.viewer is not None:
            pushes.append(timed_pushes(slam))
        built.append(slam)
        return slam

    demo.DPVO = make
    n_times = len(utils.all_times)
    busy = None
    out = io.StringIO()
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            if profile:
                from torch.profiler import ProfilerActivity
                from torch.profiler import profile as prof_ctx
                with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
                    demo.main(argv)
                    torch.cuda.synchronize()
            else:
                demo.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        demo.DPVO = real
    if profile:
        with tempfile.TemporaryDirectory() as tmp:
            prof.export_chrome_trace(f'{tmp}/trace.json')
            busy = device_time(f'{tmp}/trace.json')[0]
    check(len(built) == 1, f'demo built {len(built)} runtimes')
    return (built[0], launches, wall, utils.all_times[n_times:],
            pushes[0] if pushes else [], busy)


def write_sequence(root, frames, intr):
    """PNG frames (RGB arrays written as the BGR files a camera reader
    would give back) and a calib file; returns (imagedir, calib path)."""
    import cv2
    seq = os.path.join(root, 'seq')
    os.makedirs(seq)
    for t, img in enumerate(frames):
        check(cv2.imwrite(os.path.join(seq, f'{t:06d}.png'), img),
              f'cv2.imwrite frame {t}')
    calib = os.path.join(root, 'calib.txt')
    with open(calib, 'w') as f:
        f.write(' '.join(str(float(x)) for x in intr))
    return seq, calib


def entry_points_on_card(dev, smi, dv_stats, ho_stats, H=480, W=640, T=40,
                         opts=()):
    """Phase 15: the demo (pure VO, then --viz on HybridVO with the
    headless viewer), MultiStreamVO at full width and CUDA against the
    CPU, evaluate_synthetic on the card. H, W, T and opts (config keys
    and values over default.yaml) shrink it for a rehearsal on the CPU."""
    import torch
    from dpvo_torch.runtime import DeviceVO, HybridVO
    t_phase = time.perf_counter()
    print(f'  {smi}', flush=True)
    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    print(f'  import matplotlib on this host: '
          f'{"works" if has_mpl else "fails"} (--plot and the viewer\'s 3D '
          f'render {"run" if has_mpl else "are skipped"})', flush=True)
    expected = 12 + (T - 8) + 12           # bootstrap + 1/frame + refine
    old_cwd = os.getcwd()
    display = os.environ.pop('DISPLAY', None)
    with tempfile.TemporaryDirectory() as tmp:
        seq, calib = write_sequence(tmp, synthetic_frames(T, H, W, seed=0),
                                    (460.0, 460.0, W / 2, H / 2))
        os.chdir(tmp)
        try:
            base = ['--imagedir', seq, '--calib', calib, '--network', WEIGHTS,
                    '--stride', '1', '--config', CONFIG, '--device',
                    str(dev)] + (['--opts', *opts] if opts else [])
            plot = ['--plot'] if has_mpl else []

            # (a) pure VO
            slam, *_ = demo_main(base + ['--name', 'probe'], force=False)
            check(isinstance(slam, DeviceVO), f'(a) ran {type(slam)}')
            probe_ok = left_bootstrap(slam)
            print(f'  (a) demo.main, micro weights, probe not forced: '
                  f'{type(slam).__name__}, keyframes n = {slam.n}, left '
                  f'bootstrap: {probe_ok}', flush=True)
            force = not probe_ok
            if force:
                print('  (a) the motion probe rejected the generated frames: '
                      'the runs below force it (force_accept set on the '
                      'runtime that demo.run builds)', flush=True)
            slam, k, wall, ms, _, _ = demo_main(
                base + ['--name', 'a', '--timeit', '--save_trajectory',
                        '--save_ply', '--save_html', '--save_colmap'] + plot,
                force)
            check(isinstance(slam, DeviceVO) and left_bootstrap(slam),
                  f'(a) {type(slam).__name__} did not leave bootstrap')
            check(k['corr_onepass'] >= expected, f'(a) K1 launched '
                  f'{k["corr_onepass"]} times, expected >= {expected}')
            rows = [r.split() for r in open('saved_trajectories/a.txt')
                    .read().splitlines() if r]
            check(len(rows) == T and all(len(r) == 8 for r in rows),
                  f'(a) TUM file: {len(rows)} rows')
            for rel in ['a.ply', 'a.html', 'a/points3D.txt', 'a/images.txt',
                        'a/cameras.txt'] + (['trajectory_plots/a.pdf']
                                            if has_mpl else []):
                check(os.path.getsize(rel) > 0, f'(a) {rel} is empty')
            a_ms = float(np.median(ms[10:]))
            print(f'  (a) {type(slam).__name__}, {T} frames + terminate(): '
                  f'K1 launches {k["corr_onepass"]} (update iterations '
                  f'{expected}); TUM file {len(rows)} x 8, ply, html, '
                  f'COLMAP{", plot" if has_mpl else ""} written', flush=True)
            print(f'  (a) wall per frame: median {a_ms!r} ms over frames '
                  f'10..{T - 1} (demo --timeit, the device synchronized per '
                  f'frame; phase 4 in this call {dv_stats["wall"]!r}); the '
                  f'whole demo.main (reader spawn, weights, {T} frames, '
                  f'terminate, writers) {1e3 * wall / T!r} ms per frame',
                  flush=True)
            slam, k, wall_p, _, _, busy = demo_main(
                base + ['--name', 'a_prof'], force, profile=True)
            print(f'  (a) device busy per frame over the whole run '
                  f'(torch.profiler, {T} frames, bootstrap and terminate '
                  f'included): '
                  f'{"not measured" if not busy else repr(busy / T)} ms '
                  f'(phase 4 steady state {dv_stats["busy"]!r})', flush=True)

            # (b) --viz: HybridVO with the headless viewer
            slam, k, wall, ms, push_ms, _ = demo_main(
                base + ['--name', 'b', '--viz', '--timeit'] + plot, force)
            check(isinstance(slam, HybridVO) and left_bootstrap(slam),
                  f'(b) {type(slam).__name__}, left bootstrap '
                  f'{left_bootstrap(slam)}')
            check(k['corr_onepass'] >= expected, f'(b) K1 launched '
                  f'{k["corr_onepass"]} times, expected >= {expected}')
            check(not slam.viewer.live and
                  not slam.viewer.thread.is_alive(), '(b) viewer state')
            files = os.listdir('viewer_out')
            jpgs = [f for f in files if f.endswith('.jpg')]
            check(jpgs and os.path.getsize('viewer_out/cloud.ply') > 0,
                  f'(b) viewer wrote {sorted(files)}')
            if has_mpl:
                check(any(f.startswith('traj3d') for f in files) and
                      os.path.getsize('trajectory_plots/b.pdf') > 0,
                      f'(b) 3D render / plot missing: {sorted(files)}')
            b_ms = float(np.median(ms[10:]))
            print(f'  (b) {type(slam).__name__} with viz, {T} frames + '
                  f'terminate(): K1 launches {k["corr_onepass"]} (update '
                  f'iterations {expected}); viewer_out: {len(jpgs)} jpg, '
                  f'cloud.ply, {sum(f.startswith("traj3d") for f in files)} '
                  f'3D renders, viewer.html: {"viewer.html" in files}',
                  flush=True)
            print(f'  (b) wall per frame: median {b_ms!r} ms over frames '
                  f'10..{T - 1} (a: {a_ms!r}; phase 5 HybridVO onepass '
                  f'GRADIENT_BIAS without viewer {ho_stats["wall"]!r}); '
                  f'{len(push_ms)} viewer pushes (every 3rd keyframe count), '
                  f'{float(np.median(push_ms)) if push_ms else 0.0!r} ms '
                  f'each (median), {sum(push_ms)!r} ms in all', flush=True)
            note(f'demo (a) {a_ms:.4g} ms/frame, --viz (b) {b_ms:.4g}')
            # DeviceVO's own viz branch (built directly: the DPVO
            # constructor sends viz to HybridVO), same frames
            from dpvo_torch.config import cfg as base_cfg
            cfg = base_cfg.clone()
            cfg.merge_from_file(CONFIG)
            cfg.merge_from_list(list(opts))
            dvo = DeviceVO(cfg, WEIGHTS, H, W, viz=True, seed=0, device=dev)
            dvo.force_accept = True
            push_ms = timed_pushes(dvo)
            frames = synthetic_frames(T, H, W, seed=0)
            intr = np.array([460.0, 460.0, W / 2, H / 2], np.float32)
            walls = []
            for t, img in enumerate(frames):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dvo(t, img, intr)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
            dvo.terminate()
            check(len(push_ms) == T // 10 + 1, f'DeviceVO viz pushes '
                  f'{len(push_ms)}')
            print(f'  (b) DeviceVO with viz (built directly): wall per frame '
                  f'median {float(np.median(walls[10:]))!r} ms over frames '
                  f'10..{T - 1}; {len(push_ms)} viewer pushes (every 10th '
                  f'frame + terminate, one read-back each) '
                  f'{float(np.median(push_ms))!r} ms each (median)',
                  flush=True)
        finally:
            os.chdir(old_cwd)
            if display is not None:
                os.environ['DISPLAY'] = display

        # (e) evaluate_synthetic, one trial, trained and random weights
        os.chdir(tmp)
        try:
            from dpvo_torch import evaluate_synthetic
            avg = {}
            for net in (WEIGHTS, 'none'):
                reset_launches()
                t0 = time.perf_counter()
                _, avg[net] = evaluate_synthetic.main(
                    ['--network', net, '--trials', '1', '--config', CONFIG,
                     '--device', str(dev)])
                k1 = read_launches()['corr_onepass']
                check(k1 > 0 and np.isfinite(avg[net]),
                      f'(e) {net}: K1 {k1}, AVG {avg[net]}')
                print(f'  (e) evaluate_synthetic --trials 1, '
                      f'{"trained" if net == WEIGHTS else "random"} weights: '
                      f'AVG ATE {avg[net]!r} over scenes 900-904 (K1 '
                      f'launches {k1}; {time.perf_counter() - t0:.1f} s)',
                      flush=True)
            check(avg[WEIGHTS] < avg['none'], f'(e) trained AVG '
                  f'{avg[WEIGHTS]} >= random {avg["none"]}')
            entry_turns(dev, base, force, H, W, T, opts)
        finally:
            os.chdir(old_cwd)

    multistream_cpu_vs_cuda(dev)
    print(f'  phase 15: {time.perf_counter() - t_phase:.1f} s', flush=True)


def entry_turns(dev, base, force, H, W, T, opts, rounds=2):
    """(c) in turns: phase 4's main path, (a)'s demo.main (--timeit) and
    MultiStreamVO with 1 and 2 streams, rounds of ABCD then DCBA, each run
    between two host_pace() probes. Prints each run's wall per frame (per
    stream-frame for MultiStreamVO) beside the probes' mean pace, then
    each one's median over the rounds and its ratio to phase 4's."""
    import contextlib
    import io
    runs = ('phase 4', 'demo (a)', '1 stream', '2 streams')
    walls = {r: [] for r in runs}
    for i in range(rounds):
        for run in (runs if i % 2 == 0 else runs[::-1]):
            before = host_pace(dev)
            if run == 'phase 4':
                with contextlib.redirect_stdout(io.StringIO()):
                    *_, st = main_path(dev, 'default.yaml', 'onepass')
                wall = st['wall']
            elif run == 'demo (a)':
                ms = demo_main(base + ['--name', 'turn', '--timeit'],
                               force)[3]
                wall = float(np.median(ms[10:]))
            else:
                B = 1 if run == '1 stream' else 2
                wall = multistream_on_card(dev, B, H, W, T, opts) / B
            py_ms, launch_us, _ = (float(x) for x in
                                   np.mean([before, host_pace(dev)], 0))
            walls[run].append(wall)
            print(f'  (c) in turns, round {i + 1}, {run}: wall per '
                  f'{"stream-" if "stream" in run else ""}frame {wall!r} ms;'
                  f' host pace (mean of the probes before and after): '
                  f'Python loop {py_ms!r} ms, {launch_us!r} us per launch; '
                  f'{before[2]} objects tracked by gc before', flush=True)
    ref = float(np.median(walls['phase 4']))
    print('  (c) in turns, median over the rounds (ms per frame or stream-'
          'frame; / phase 4): ' + '; '.join(
              f'{r} {float(np.median(w))!r} ({float(np.median(w)) / ref!r})'
              for r, w in walls.items()), flush=True)


def multistream_on_card(dev, B=2, H=480, W=640, T=40, opts=()):
    """(c) MultiStreamVO at full width (default.yaml, 640x480, bf16), B
    streams on one card, T lockstep frames, each stream its own crop; the
    probe forced. Returns the median wall per lockstep step, ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dpvo_torch.config import cfg as base_cfg
    from dpvo_torch.parallel.streams import MultiStreamVO
    trace_from = T - 10
    cfg = base_cfg.clone()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(list(opts))
    frames = stream_frames(T, H, W, B, seed=0)
    intr = np.array([460.0, 460.0, W / 2, H / 2], np.float32)
    devices = ['cuda:0'] * B if torch.device(dev).type == 'cuda' else \
        [dev] * B
    mv = MultiStreamVO(cfg, WEIGHTS, H, W, intr, devices=devices)
    mv.force_accept = True
    check(len({id(n) for n in mv.networks}) == 1, 'one network per device')
    reset_launches()
    walls = []
    with tempfile.TemporaryDirectory() as tmp:
        for t in range(T):
            if t == trace_from:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
                t_trace = time.perf_counter()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mv(np.full(B, float(t)), frames[t])
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        wall_trace = time.perf_counter() - t_trace
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(f'{tmp}/trace.json')
        busy = device_time(f'{tmp}/trace.json')[0]
    k1 = read_launches()['corr_onepass']
    iters = 12 + (T - 8)                # bootstrap + 1/frame, no terminate
    check(k1 == B * iters, f'(c) K1 launched {k1} times, expected '
          f'{B} x {iters}')
    kf = [int(st.n) for st in mv.states]
    for b, st in enumerate(mv.states):
        poses = st.poses[:kf[b]].cpu().numpy()
        check(bool(st.is_init) and kf[b] >= 8, f'(c) stream {b}: n = {kf[b]}')
        check(np.isfinite(poses).all() and
              np.abs(poses[-1, :3]).max() > 1e-3,
              f'(c) stream {b}: poses {poses[-1]}')
    step = float(np.median(walls[10:trace_from]))
    nt = T - trace_from
    busy_ms = busy / nt if busy > 0 else None
    print(f'  (c) MultiStreamVO, {B} streams on {[str(d) for d in mv.devices]}'
          f', {T} lockstep frames at {W}x{H} '
          f'{"bf16" if cfg.MIXED_PRECISION else "f32"}: K1 launches {k1} = {B} x '
          f'{iters} update iterations; keyframes {kf}'
          f'; wall per lockstep step median {step!r} ms over steps '
          f'10..{trace_from - 1} ({step / B!r} ms per stream-frame)',
          flush=True)
    print(f'  (c) device busy per step (profiler, steps {trace_from}..'
          f'{T - 1}): '
          f'{"not measured" if busy_ms is None else repr(busy_ms)} ms; idle '
          f'share of the unprofiled wall '
          f'{"not measured" if busy_ms is None else repr(1 - busy_ms / step)}'
          f'; traced wall per step {1e3 * wall_trace / nt!r} ms', flush=True)
    return step


def multistream_cpu_vs_cuda(dev, B=2, T=16, H=64, W=96):
    """(d) MultiStreamVO on CUDA against the CPU, the same draws: f32
    within 1e-3 and bf16 within 1e-2 per pose component (phase 7's
    bounds); K1 launched in the CUDA run."""
    from dpvo_torch.config import cfg as base_cfg
    from dpvo_torch.parallel.streams import MultiStreamVO
    frames = stream_frames(T, H, W, B, seed=1, offset=8)
    intr = np.array([W * 0.625, W * 0.625, W / 2, H / 2], np.float32)
    for mixed in (False, True):
        cfg = base_cfg.clone()
        cfg.merge_from_file(CONFIG)
        cfg.PATCHES_PER_FRAME = 8
        cfg.BUFFER_SIZE = 64
        cfg.MIXED_PRECISION = mixed
        out = {}
        for d in (dev, 'cpu'):
            mv = MultiStreamVO(cfg, WEIGHTS, H, W, intr, devices=[d] * B)
            mv.force_accept = True
            reset_launches()
            for t in range(T):
                mv(np.full(B, float(t)), frames[t])
            if d == dev:
                k1 = read_launches()['corr_onepass']
            out[d] = [(int(st.n), st.poses[:int(st.n)].cpu().numpy())
                      for st in mv.states]
        tol = 1e-2 if mixed else 1e-3
        prec = 'bf16' if mixed else 'f32'
        check([n for n, _ in out[dev]] == [n for n, _ in out['cpu']],
              f'(d) {prec} keyframes {out}')
        err = max(float(np.abs(a - b).max())
                  for (_, a), (_, b) in zip(out[dev], out['cpu']))
        check(err <= tol and k1 > 0, f'(d) {prec}: CUDA vs CPU poses '
              f'{err}, K1 launches {k1}')
        print(f'  (d) MultiStreamVO {B} streams {H}x{W} {prec}, {T} frames: '
              f'max |pose CUDA - pose CPU| = {err!r} (bound {tol!r}; '
              f'keyframes {[n for n, _ in out[dev]]}; CUDA K1 launches {k1})',
              flush=True)



# --------------------------------------------------------------------------
# phase 16: the training and evaluation entry points (train/cli.py, parallel/
# mesh.py, evaluate_tartan.py, graft_entry.py)
# --------------------------------------------------------------------------

TARTAN_INTR = (320.0, 320.0, 320.0, 240.0)    # TartanAir's fixed camera


def write_tartan(root, scenes, n, H, W, seed):
    """TartanAir's layout under root: per scene image_left/*.png,
    depth_left/*.npy (metres) and a NED pose_left.txt, rendered by the
    port's data_readers/synthetic.py (a textured plane seen by TartanAir's
    camera along a forward trajectory). Returns the scene directories."""
    import cv2
    from dpvo_torch.data_readers import synthetic as syn
    from dpvo_torch.data_readers.tartan import TartanAir
    intr = np.array(TARTAN_INTR, np.float32)
    plane = np.array([0.0, 0.0, 1.0], np.float32)
    dirs = []
    for k, scene in enumerate(scenes):
        d = os.path.join(root, scene)
        for sub in ('image_left', 'depth_left'):
            os.makedirs(os.path.join(d, sub))
        rng = np.random.RandomState(seed + k)
        tex = syn.make_texture(rng)
        wfc = syn.make_trajectory(rng, n, step=0.12)
        for t in range(n):
            img, z = syn.render_plane_view(tex, wfc[t], intr, H, W, plane,
                                           3.5)
            check(cv2.imwrite(os.path.join(d, 'image_left',
                                           f'{t:06d}_left.png'), img),
                  f'cv2.imwrite {scene} frame {t}')
            np.save(os.path.join(d, 'depth_left', f'{t:06d}_left_depth.npy'),
                    (z * TartanAir.DEPTH_SCALE).astype(np.float32))
        # the reader's NED -> xyz permutation [1, 2, 0, 4, 5, 3, 6] and
        # translation / DEPTH_SCALE, inverted
        ned = np.empty((n, 7))
        ned[:, [1, 2, 0, 4, 5, 3, 6]] = wfc
        ned[:, :3] *= TartanAir.DEPTH_SCALE
        np.savetxt(os.path.join(d, 'pose_left.txt'), ned, delimiter=' ')
        dirs.append(d)
    return dirs


class TimedSteps:
    """make_train_step wrapped: each step's wall ms (host clock around a
    step that ends in a synchronize) and, for the step numbered `trace`,
    a profiler trace's device busy ms, ops and kernel times by name."""

    def __init__(self, dev, trace=None):
        self.dev, self.trace, self.walls, self.traced = dev, trace, [], None

    def sync(self):
        import torch
        if self.dev.type == 'cuda':
            torch.cuda.synchronize(self.dev)

    def wrap(self, make):
        def make_timed(*a, **k):
            step = make(*a, **k)

            def timed(batch):
                from torch.profiler import ProfilerActivity, profile
                traced = len(self.walls) == self.trace
                self.sync()
                if traced:
                    prof = profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
                    prof.__enter__()
                t0 = time.perf_counter()
                out = step(batch)
                self.sync()
                self.walls.append(1e3 * (time.perf_counter() - t0))
                if traced:
                    prof.__exit__(None, None, None)
                    with tempfile.TemporaryDirectory() as tmp:
                        prof.export_chrome_trace(f'{tmp}/step.json')
                        self.traced = device_time(f'{tmp}/step.json')
                return out
            return timed
        return make_timed


def train_cli_run(dev, datapath, name, n_steps, ckpt=None, trace=None,
                  n_frames=15, M=80, crop=None):
    """train/cli.main as a user runs it (--dataset tartan, bf16), its first
    n_steps steps of the 240,000-step schedule, the reader's scene info
    pickled beside datapath (not in the package's cache directory); launch
    counts set to 0 just before and read just after. Returns (history,
    launches, TimedSteps, host ms per item of the reader)."""
    from dpvo_torch.data_readers import factory
    from dpvo_torch.data_readers.tartan import TartanAir
    from dpvo_torch.ops import corr_grad, corr_onepass
    from dpvo_torch.train import cli, trainer
    argv = ['--name', name, '--dataset', 'tartan', '--datapath', datapath,
            '--steps', '240000', '--n_frames', str(n_frames),
            '--patches_per_frame', str(M), '--batch', '1', '--device',
            str(dev)] + (['--ckpt', ckpt] if ckpt else [])
    timer = TimedSteps(dev, trace)
    reads = []
    orig = dict(make=trainer.make_train_step, item=TartanAir.__getitem__,
                factory=factory.dataset_factory)

    def item(self, i):
        t0 = time.perf_counter()
        out = orig['item'](self, i)
        reads.append(1e3 * (time.perf_counter() - t0))
        return out

    def placed(names, **kw):
        if crop is not None:              # a CPU rehearsal's crop
            kw['crop_size'] = crop
        return orig['factory'](names, scene_info_path=os.path.join(
            datapath, 'scene_info.pickle'), **kw)
    trainer.make_train_step = timer.wrap(orig['make'])
    TartanAir.__getitem__ = item
    factory.dataset_factory = placed
    corr_onepass.launches = corr_grad.backward_launches = 0
    try:
        hist = cli.main(cli.parser().parse_args(argv), n_steps=n_steps)
    finally:
        trainer.make_train_step = orig['make']
        TartanAir.__getitem__ = orig['item']
        factory.dataset_factory = orig['factory']
    launches = dict(corr_onepass=corr_onepass.launches,
                    corr_backward=corr_grad.backward_launches)
    return hist, launches, timer, reads


def rel_l2(a, b):
    """Relative L2 distance of two gradient dicts as one vector."""
    num = sum(float(((a[k] - b[k]).double() ** 2).sum()) for k in b)
    den = sum(float((b[k].double() ** 2).sum()) for k in b)
    return (num / den) ** 0.5


def dp_one_rank(dev, datapath, n_frames=15, M=80, crop=None):
    """(b): one batch of the cli's pipeline, two plain steps and one step
    through parallel/mesh.py (a world of one: nccl on CUDA, gloo on the
    CPU), each from the seeded weights, first as the trainer runs, then
    under torch.use_deterministic_algorithms (warn_only: index_add_ and
    the other scatter sums of the forward and backward sorted instead of
    atomic; corr_backward's dgmap atomics stay): the DP step's gradients
    against the first plain step's (relative L2 of the whole gradient),
    beside the two plain steps' spread. The deterministic pair is held to
    1e-4. Returns {mode: (DP vs plain, plain vs plain)}."""
    import socket
    import warnings
    import torch
    import torch.distributed as dist
    from argparse import Namespace
    from dpvo_torch.data_readers.factory import dataset_factory
    from dpvo_torch.graft_entry import KeepGrads
    from dpvo_torch.models.vonet import init_vonet
    from dpvo_torch.parallel import mesh
    from dpvo_torch.runtime import numpy_se3 as nse3
    from dpvo_torch.train import cli, trainer
    kw = dict(crop_size=crop) if crop else {}
    db = dataset_factory(['tartan'], datapath=datapath, n_frames=n_frames,
                         scene_info_path=os.path.join(datapath,
                                                      'scene_info.pickle'),
                         **kw)
    batches = cli.prefetch_batches(db, Namespace(batch=1,
                                                 patches_per_frame=M),
                                   np.random.RandomState(1234))
    batch = next(batches)
    batches.close()
    batch['poses_gt'] = nse3.inv(batch.pop('poses_c2w'))
    batch['rng'] = np.random.RandomState(1235).randint(
        0, 2 ** 31 - 1, (1, 2)).astype(np.uint32)
    sched = trainer.edge_schedule(n_frames, M, 18)

    def run(group):
        net = init_vonet(None, dev)
        opt = KeepGrads(trainer.make_optimizer(net.parameters()), net)
        step = trainer.make_train_step(net, opt, sched, group=group)
        loss, _ = step(mesh.shard_batch(batch, 0, 1))
        return float(loss), opt.grads

    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    env = dict(WORLD_SIZE='1', RANK='0', LOCAL_RANK='0',
               MASTER_ADDR='localhost', MASTER_PORT=str(port))
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = {}
    try:
        rank, world, ddev, group = mesh.init_from_env(str(dev))
        backend = dist.get_backend(group)
        for mode in ('as the trainer runs', 'deterministic'):
            det = mode == 'deterministic'
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter('always')
                torch.use_deterministic_algorithms(det, warn_only=True)
                try:
                    (l0, g0), (l1, g1), (l2, g2) = (run(None), run(None),
                                                    run(group))
                finally:
                    torch.use_deterministic_algorithms(False)
            ops = sorted({str(w.message).split(' does not have')[0]
                          for w in caught if 'deterministic' in
                          str(w.message)})
            dp, spread = rel_l2(g2, g0), rel_l2(g1, g0)
            out[mode] = (dp, spread)
            print(f'  (b) {mode}: the step through parallel/mesh.py '
                  f'({backend}, world size {world}, rank {rank}, {ddev}): '
                  f'loss {l2!r} (plain {l0!r}, {l1!r}); gradients vs the '
                  f'plain step {dp!r} relative L2, two plain steps {spread!r}'
                  + (f'; ops without a deterministic version: {ops}'
                     if det else ''), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    check(torch.device(ddev).type == torch.device(dev).type and
          backend == ('nccl' if torch.device(dev).type == 'cuda' else 'gloo'),
          f'(b) ran on {ddev} over {backend}')
    dp, spread = out['deterministic']
    check(np.isfinite(dp) and dp <= 1e-4,
          f'(b) deterministic DP step vs plain: {dp} (bound 1e-4)')
    return out


def evaluate_on_card(dev, scenes):
    """(c): evaluate_tartan.evaluate over the given validation scenes (its
    test_split patched to them), default.yaml, the micro VONet, the motion
    probe forced; launch counts set to 0 just before and read just after.
    Returns (results, wall ms per frame, K1 launches)."""
    from dpvo_torch import evaluate_tartan
    from dpvo_torch.config import cfg as base_cfg
    from dpvo_torch.data_readers import tartan
    cfg = base_cfg.clone()
    cfg.merge_from_file(CONFIG)
    orig = (tartan.test_split, evaluate_tartan.DPVO)

    def forced(*a, **k):
        slam = orig[1](*a, **k)
        slam.force_accept = True
        return slam
    tartan.test_split, evaluate_tartan.DPVO = scenes, forced
    n = sum(len(os.listdir(os.path.join('datasets', 'TartanAir', s,
                                        'image_left'))) for s in scenes)
    reset_launches()
    try:
        t0 = time.perf_counter()
        res = evaluate_tartan.evaluate(cfg, WEIGHTS, device=str(dev))
        wall = 1e3 * (time.perf_counter() - t0) / n
    finally:
        tartan.test_split, evaluate_tartan.DPVO = orig
    return res, wall, read_launches()['corr_onepass']


def train_eval_on_card(dev, smi, H=480, W=640, n_frames=15, M=80, crop=None,
                       n_scene=70, n_val=40):
    """Phase 16 (see the module docstring). H, W, n_frames, M and crop
    shrink it for a rehearsal on the CPU."""
    import torch
    from dpvo_torch import graft_entry
    from dpvo_torch.data_readers import tartan
    from dpvo_torch.models.checkpoint import save_params_npz
    from dpvo_torch.models.vonet import init_vonet
    t_phase = time.perf_counter()
    old_cwd = os.getcwd()
    old_split = tartan.test_split
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            root = os.path.join(tmp, 'datasets', 'TartanAir')
            t0 = time.perf_counter()
            train = write_tartan(root, ['s000/s000/Easy/P000',
                                        's001/s001/Easy/P001'], n_scene, H,
                                 W, seed=40)
            # two validation scenes: the first n_val frames of each
            val = ['v000/v000/Easy/P000', 'v001/v001/Easy/P001']
            for src, scene in zip(train, val):
                d = os.path.join(root, scene, 'image_left')
                os.makedirs(d)
                for f in sorted(os.listdir(os.path.join(src, 'image_left'))
                                )[:n_val]:
                    os.link(os.path.join(src, 'image_left', f),
                            os.path.join(d, f))
                rows = open(os.path.join(src, 'pose_left.txt')).readlines()
                with open(os.path.join(root, scene, 'pose_left.txt'),
                          'w') as f:
                    f.writelines(rows[:n_val])
            tartan.test_split = val     # the reader reserves them too
            print(f'  TartanAir layout: 2 scenes x {n_scene} frames at '
                  f'{H}x{W} (+ 2 validation scenes of {n_val}) written in '
                  f'{time.perf_counter() - t0:.1f} s', flush=True)

            # (a) train/cli.main, structure-only, then from a checkpoint
            runs = {}
            ckpt = os.path.join(tmp, 'seeded.npz')
            save_params_npz(init_vonet(None, 'cpu').state_dict(), ckpt)
            for label, kw in (('structure-only', {}),
                              ('full, --ckpt', dict(ckpt=ckpt, trace=2))):
                t0 = time.perf_counter()
                hist, launches, timer, reads = train_cli_run(
                    dev, root, label[:4], 3, n_frames=n_frames, M=M,
                    crop=crop, **kw)
                runs[label] = (hist, launches, timer, reads)
                whole = time.perf_counter() - t0
                steps = len(hist)
                per = {k: v / steps for k, v in launches.items()}
                print(f'  (a) train/cli.main {label}: {steps} steps in '
                      f'{whole:.1f} s (setup and reader included); losses '
                      f'{[h["loss"] for h in hist]}; aux keys '
                      f'{sorted(hist[-1])}; wall ms per step '
                      f'{timer.walls!r}; launches per step {per}; reader '
                      f'host ms per item {np.round(reads, 1).tolist()} '
                      f'({len(reads)} items for {steps} batches of 1)',
                      flush=True)
                check(steps == 3 and all(np.isfinite(v) for h in hist
                                         for v in h.values()),
                      f'(a) {label}: {hist}')
                check(launches == dict(corr_onepass=18 * steps,
                                       corr_backward=18 * steps),
                      f'(a) {label}: launches {launches}, expected 18 per '
                      f'step')
                check(('tr' in hist[-1]) == ('ckpt' in kw),
                      f'(a) {label}: aux {sorted(hist[-1])}')
            hist, launches, timer, reads = runs['full, --ckpt']
            busy, by_name, n_ops = timer.traced
            wall = float(np.median(timer.walls[:2]))
            print(f'  {smi}: (a) full step wall {wall!r} ms (median of the '
                  f'untraced steps), device busy {busy!r} ms in {n_ops} '
                  f'device ops (profiler, the third step), idle share '
                  f'{1.0 - busy / wall if busy else "not measured"}; traced '
                  f'step {timer.walls[2]!r} ms; reader {np.median(reads)!r} '
                  f'host ms per item (median; the prefetch thread, beside '
                  f'the steps)', flush=True)
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
                print(f'    {v:9.3f} ms/step  {k[:100]}')
            note(f'(a) train CLI step wall {wall:.5g} ms, busy '
                 f'{busy or 0:.5g}')

            # (b) the same step over torch.distributed, one rank
            dp_one_rank(dev, root, n_frames=n_frames, M=M, crop=crop)

            # (c) evaluate_tartan on the two validation scenes
            res, wall, k1 = evaluate_on_card(dev, val)
            print(f'  (c) evaluate_tartan.evaluate over 2 scenes x {n_val} '
                  f'frames at {H}x{W}, default.yaml, micro VONet, probe '
                  f'forced: {res}; wall {wall!r} ms per frame (whole run, '
                  f'runtime builds included); K1 launches {k1}', flush=True)
            note(f'(c) evaluate_tartan {wall:.4g} ms/frame')
            check(all(np.isfinite(v) for v in res.values()) and k1 >= 2 * (
                12 + (n_val - 8) + 12), f'(c) {res}, K1 launches {k1}')

            # (d) graft_entry.entry()
            fn, args = graft_entry.entry(str(dev))
            reset_launches()
            t0 = time.perf_counter()
            fn(*args)
            if torch.device(dev).type == 'cuda':
                torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            k1 = read_launches()['corr_onepass']
            print(f'  (d) graft_entry.entry(): one DeviceVO frame at 640x480 '
                  f'in {ms!r} ms, K1 launches {k1}', flush=True)
            check(k1 >= 1, f'(d) K1 launched {k1} times')
        finally:
            tartan.test_split = old_split
            os.chdir(old_cwd)
    print(f'  phase 16: {time.perf_counter() - t_phase:.1f} s', flush=True)


def geometry_scene(E, N, M, seed):
    """E edges over N frames of M 3x3 patches in a 160x120 map (default.
    yaml's 640x480 at 1/4): poses within 0.05 of the identity, inverse
    depths 0.3-2, so every tap lands at Z in ~[0.4, 3.5], away from the
    0.2 gates; ii != jj, kk a patch of frame ii."""
    from dpvo_torch import lie
    import torch
    rng = np.random.RandomState(seed)
    xi = torch.from_numpy(rng.randn(N, 6).astype(np.float32) * 0.05)
    poses = lie.se3_exp(xi)
    intr = torch.tensor([[120.0, 120.0, 80.0, 60.0]]).repeat(N, 1)
    c = np.stack([rng.uniform(4, 156, N * M), rng.uniform(4, 116, N * M)], 1)
    g = np.arange(-1, 2)
    patches = np.stack([
        np.broadcast_to(c[:, 0, None, None] + g[None, None, :], (N * M, 3, 3)),
        np.broadcast_to(c[:, 1, None, None] + g[None, :, None], (N * M, 3, 3)),
        np.broadcast_to(rng.uniform(0.3, 2.0, (N * M, 1, 1)), (N * M, 3, 3))],
        axis=1).astype(np.float32)
    ii = rng.randint(0, N, E)
    jj = (ii + rng.randint(1, N, E)) % N
    kk = ii * M + rng.randint(0, M, E)
    scales = torch.from_numpy(np.exp(rng.randn(N, 1) * 0.1).astype(np.float32))
    return (poses, torch.from_numpy(patches), intr,
            *(torch.from_numpy(a) for a in (ii, jj, kk))), scales


def geometry_on_card(dev, smi):
    """Phase 17: the geometry library (lie.py, projective.py) on the card
    against the CPU in f32, the same inputs: transform with jacobian=True
    for SE3 and Sim3, flow_mag and point_cloud at E = 49,152 edges of 3x3
    patches (default.yaml's 512 pair slots x M = 96), and the class
    surface's ops on 4,096 elements of each group. Bounds: a difference
    relative to the output's largest entry of 1e-5 (both sides f32; the
    card contracts into FMAs and has its own sin / cos / sqrt, so a few
    ulps per op, and no tap lies near a gate); the group ops' O(1) values
    2e-5 absolute (1e-4 through Sim3's 3x3 inverse). Also .backward()
    through log at the identity must give finite gradients on the card."""
    import torch
    from dpvo_torch import lie, projective
    from dpvo_torch.scripts._common import time_ms
    t_phase = time.perf_counter()
    worst = []

    def held(what, a, b, bound, rel=True):
        a, b = a.detach().double().cpu(), b.detach().double()
        scale = b.abs().max().item() if rel else 1.0
        d = (a - b).abs().max().item() / max(scale, 1e-30)
        worst.append((what, d, bound))
        check(bool(torch.isfinite(a).all()) and d <= bound,
              f'phase 17 {what}: difference {d!r} over {bound}')

    E, N, M = 49152, 36, 96
    scene, scales = geometry_scene(E, N, M, seed=17)
    for group in ('se3', 'sim3'):
        args = list(scene)
        if group == 'sim3':
            args[0] = torch.cat([args[0], scales], dim=1)
        cuda = [a.to(dev) for a in args]
        x, v, (Ji, Jj, Jz) = projective.transform(*cuda, jacobian=True,
                                                  group=group)
        xr, vr, (Jir, Jjr, Jzr) = projective.transform(*args, jacobian=True,
                                                       group=group)
        check(bool(vr.all()) and torch.equal(v.cpu(), vr),
              f'phase 17 {group}: validity differs or not every edge valid')
        for what, a, b in (('coords', x, xr), ('Ji', Ji, Jir),
                           ('Jj', Jj, Jjr), ('Jz', Jz, Jzr)):
            held(f'transform {group} {what}', a, b, 1e-5)
        ms = time_ms(lambda: projective.transform(*cuda, jacobian=True,
                                                  group=group))
        print(f'  transform({group}, jacobian=True) at E = {E:,}: '
              f'{ms!r} ms on the card (one call alone)', flush=True)
    cuda = [a.to(dev) for a in scene]
    mag, val = projective.flow_mag(*cuda, beta=0.5)
    magr, valr = projective.flow_mag(*scene, beta=0.5)
    check(torch.equal(val.cpu(), valr), 'phase 17 flow_mag: validity differs')
    held('flow_mag', mag, magr, 1e-5)
    ix = torch.arange(N).repeat_interleave(M)
    held('point_cloud', projective.point_cloud(cuda[0], cuda[1], cuda[2],
                                               ix.to(dev)),
         projective.point_cloud(scene[0], scene[1], scene[2], ix), 1e-5)

    n = 4096
    rng = np.random.RandomState(18)
    for cls, key in ((lie.SO3, 1), (lie.RxSO3, 2), (lie.SE3, 3),
                     (lie.Sim3, 4)):
        d = cls.manifold_dim
        bound = 1e-4 if cls is lie.Sim3 else 2e-5
        A, B = (cls.Random(n, sigma=0.5, key=k, device=dev)
                for k in (key, key + 10))
        Ar, Br = (cls.Random(n, sigma=0.5, key=k, device='cpu')
                  for k in (key, key + 10))
        xi, X = (torch.from_numpy(rng.randn(n, d).astype(np.float32) * s)
                 for s in (0.3, 1.0))
        p3, p4 = (torch.from_numpy(rng.randn(n, w).astype(np.float32))
                  for w in (3, 4))

        def ops(A, B, xi, X, p3, p4):
            out = dict(Random=A.data, mul=(A * B).data, inv=A.inv().data,
                       log=A.log(), exp=cls.exp(xi).data,
                       retr=A.retr(xi).data, matrix=A.matrix(),
                       adj=A.adj(xi), adjT=A.adjT(X), Jinv=A.Jinv(xi),
                       act=A * p3)
            if cls is not lie.SO3:
                out['act4'] = A * p4
            return out

        on = ops(A, B, *(t.to(dev) for t in (xi, X, p3, p4)))
        ref = ops(Ar, Br, xi, X, p3, p4)
        for k in ref:
            held(f'{cls.__name__}.{k}', on[k], ref[k], bound, rel=False)
        x = torch.zeros(n, d, device=dev, requires_grad=True)
        (cls.exp(x).log().sum() + (cls.exp(x) * A).log().sum()).backward()
        check(bool(torch.isfinite(x.grad).all()),
              f'phase 17 {cls.__name__}: a gradient at the identity is not '
              f'finite')
    what, d, bound = max(worst, key=lambda w: w[1] / w[2])
    print(f'  {len(worst)} outputs held, CUDA against the CPU; the largest '
          f'differences (relative to the output\'s largest entry for '
          f'projective.py, absolute for the group ops):', flush=True)
    for w, dd, b in worst:
        print(f'    {w}: {dd!r} (bound {b})')
    print(f'  closest to its bound: {what} {d!r} of {bound}; {smi}')
    note(f'{len(worst)} outputs held; closest {what} {d:.3g} of {bound}')
    print(f'  phase 17: {time.perf_counter() - t_phase:.1f} s', flush=True)


# --------------------------------------------------------------------------
# phase 18: HybridVO with mirrors in flight (MIRROR_PIPELINE >= 2)
# --------------------------------------------------------------------------

def pipeline_run(dev, k, frames, intr, warm=10, timed=20, traced=10,
                 **overrides):
    """HybridVO at 640x480 (default.yaml + GRADIENT_BIAS, the full-width
    VONet, onepass; + overrides) with MIRROR_PIPELINE = k over `frames` +
    terminate():
    the calls of frames warm .. warm + timed - 1 as one segment on the host
    clock, from a synchronize to a synchronize (no sync per frame, so
    mirrors stay in flight), then `traced` frames under the profiler and
    the sync counter. Returns dict(wall, busy, idle (ms per frame, share),
    syncs, waits (per traced frame), sites, n (keyframes), launches,
    poses)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dpvo_torch.config import cfg as base_cfg
    H, W = frames[0].shape[:2]
    cfg = base_cfg.clone()
    cfg.merge_from_file(CONFIG)
    cfg.CENTROID_SEL_STRAT = 'GRADIENT_BIAS'
    cfg.MIRROR_PIPELINE = k
    for key, v in overrides.items():
        cfg[key] = v
    slam = make_slam(cfg, H, W, dev, 'onepass')
    reset_launches()
    for t in range(warm):
        slam(t, frames[t], intr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(warm, warm + timed):
        slam(t, frames[t], intr)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / timed
    reads = slam._readback.reads
    sc = SyncCounter()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with sc:
                for t in range(warm + timed, warm + timed + traced):
                    slam(t, frames[t], intr)
            torch.cuda.synchronize()
        prof.export_chrome_trace(f'{tmp}/trace.json')
        busy, _, n_ops = device_time(f'{tmp}/trace.json')
    waits = slam._readback.reads - reads
    for t in range(warm + timed + traced, len(frames)):
        slam(t, frames[t], intr)
    poses, _ = slam.terminate()
    torch.cuda.synchronize()
    busy = busy / traced if busy > 0 else None
    return dict(wall=wall, busy=busy,
                idle=None if busy is None else 1.0 - busy / wall,
                syncs=sc.n / traced, waits=waits / traced, sites=sc.sites,
                ops=n_ops / traced, n=slam.n, edges=len(slam.ii),
                launches=read_launches(), poses=poses)


def pipeline_turns(dev, smi, label, n_frames=40, order=(1, 2, 2, 1),
                   H=480, W=640, **overrides):
    """Phase 18 (b): pipeline_run at k = 1 and 2 in turns (ABBA) on phase
    4's frames; K1 on every update iteration, finite unit poses; prints
    each run's wall, busy and idle per frame, its syncs and event waits
    per traced frame, the sync sites, and the medians per k. H, W shrink
    it for a rehearsal on the CPU."""
    frames = synthetic_frames(n_frames, H, W, seed=0)
    intr = np.array([460.0, 460.0, W / 2, H / 2], np.float32)
    iters = 12 + (n_frames - 8) + 12
    res = {1: [], 2: []}
    print(f'  (b) {label}, {smi}: HybridVO {W}x{H}, default.yaml + '
          f'GRADIENT_BIAS{"".join(f" + {k}={v}" for k, v in overrides.items())}'
          f', onepass, {n_frames} frames; wall over frames 10-29 as one '
          f'segment, busy / syncs / waits over frames 30-39; runs in turns '
          f'k = {list(order)}', flush=True)
    for k in order:
        r = pipeline_run(dev, k, frames, intr, **overrides)
        check(r['launches']['corr_onepass'] >= iters,
              f'(b) k={k}: K1 launched {r["launches"]["corr_onepass"]} '
              f'times, expected >= {iters}')
        check(np.isfinite(r['poses']).all() and np.allclose(
            np.linalg.norm(r['poses'][:, 3:], axis=1), 1.0, atol=1e-3),
            f'(b) k={k}: poses not finite or not unit')
        res[k].append(r)
        print(f'  (b) MIRROR_PIPELINE={k}: wall {r["wall"]!r} ms/frame, '
              f'busy {r["busy"]!r} ms/frame, idle {r["idle"]!r}, '
              f'{r["ops"]!r} device ops/frame; syncs (sync debug mode) '
              f'{r["syncs"]!r} and read-back event waits {r["waits"]!r} '
              f'per frame; keyframes {r["n"]}, live edges {r["edges"]} at '
              f'the end; K1 launches {r["launches"]["corr_onepass"]} (>= '
              f'{iters})', flush=True)
    for k in (1, 2):
        sites = sum((r['sites'] for r in res[k]), collections.Counter())
        print(f'  (b) k={k} sync sites over its {len(res[k])} runs x 10 '
              f'frames: {dict(sites.most_common())}', flush=True)
    med = {k: {m: float(np.median([r[m] for r in res[k]]))
               for m in ('wall', 'busy', 'idle', 'syncs', 'waits')}
           for k in (1, 2)}
    print(f'  (b) {label}, {smi}: medians k=1 {med[1]}, k=2 {med[2]}; wall '
          f'k=2 / k=1 {med[2]["wall"] / med[1]["wall"]!r}', flush=True)
    for k in (1, 2):
        note(f'{label} k={k}: n = {res[k][0]["n"]}, wall '
             f'{med[k]["wall"]:.4g} ms/frame, busy {med[k]["busy"]:.4g}, '
             f'idle {med[k]["idle"]:.3g}, syncs {med[k]["syncs"]:.3g} + '
             f'waits {med[k]["waits"]:.3g}/frame')
    return res


def pipeline_on_card(dev, smi):
    """Phase 18 (see the module docstring)."""
    import torch
    t_phase = time.perf_counter()
    sc = SyncCounter()
    with sc:
        torch.zeros(1, device=dev).item()
    check(sc.n == 1, f'the sync counter saw {sc.n} syncs in one .item()')
    pipe = dict(GB, MIRROR_PIPELINE=2)
    parts = []

    def part(name, t0):
        parts.append(f'{name} {time.perf_counter() - t0:.1f} s')

    t0 = time.perf_counter()
    print('  (a) HybridVO at MIRROR_PIPELINE=2, CUDA vs CPU:', flush=True)
    small_cpu_vs_cuda(dev, cover=True, runs=(
        ('HybridVO', (256, 320), 'onepass', pipe, ('corr_onepass',)),
        ('HybridVO', (256, 320), 'fused_k', pipe,
         ('corr_planes', 'corr_select'))))
    part('(a)', t0)
    # as configured (keyframes removed), then with every keyframe kept,
    # where k = 1 and k = 2 do the same work
    for label, kw in (('default', {}),
                      ('keyframes kept', dict(KEYFRAME_THRESH=-1.0))):
        t0 = time.perf_counter()
        pipeline_turns(dev, smi, label, **kw)
        part(f'(b) {label}', t0)
    t0 = time.perf_counter()
    print('  (c) the LC runtime at MIRROR_PIPELINE=2, CUDA vs CPU:',
          flush=True)
    lc_cpu_vs_cuda(dev, pipeline=2)
    part('(c)', t0)
    print(f'  phase 18: {time.perf_counter() - t_phase:.1f} s '
          f'({", ".join(parts)})', flush=True)
    note(', '.join(parts))


def check_items(where, items, E, cap, max_pos):
    """A target-tile chain's work items as it made them (corr_probes.
    pair_work, slab_work): each of 1 .. cap edges, together every edge
    once, in consecutive runs of the sorted edges, by bin; a tile of at
    most max_pos positions, no tile only for the last bin (the edges that
    write zeros)."""
    first, n, b, pos = items.T
    check(len(items) > 0 and int(first[0]) == 0 and
          bool((first[1:] == first[:-1] + n[:-1]).all()) and
          int(n.sum()) == E, f'{where}: do not cover the edges once')
    check(bool(((n >= 1) & (n <= cap)).all()),
          f'{where}: an item holds 0 or more than {cap} edges')
    check(bool((b[1:] >= b[:-1]).all()), f'{where}: not in bin order')
    check(bool(((pos >= 0) & (pos <= max_pos)).all()) and
          bool((b[pos == 0] == b[-1]).all()), f'{where}: a tile off its bounds')


def probes():
    """Phase 8: the four probe entry points at their scripts' sizes, the
    launch counts set to 0 just before each and read just after. Each
    main holds every kernel against its plain version (and raises off the
    bound); here each probe kernel must also have launched. Returns the
    kernels' JSON entries, one per probe instantiation."""
    import torch
    from dpvo_torch.ops import corr_probes
    from dpvo_torch.scripts import (micro_corr_floor, micro_fused_v2,
                                    micro_kernel_variants, micro_onepass_dma)
    entries = []
    for mod in (micro_fused_v2, micro_corr_floor, micro_onepass_dma,
                micro_kernel_variants):
        corr_probes.reset_launches()
        res = mod.main(device='cuda', scale=1.0, seed=0)
        counts = dict(corr_probes.launches)
        if mod is micro_fused_v2:
            k2 = res['reference']['corr_planes']['ms']
            k4 = res['variants']['planes_pair']['ms']
            print(f'  K2 on K4\'s inputs: {k2!r} ms, K4 {k4!r} ms, K2 / K4 '
                  f'{k2 / k4!r}', flush=True)
            st, pr = res['pair_stats'], res['paired'][
                'planes_roll / planes_pair']
            read = st['tile_bytes'] + st['g_bytes']
            print(f'  K4 from L2 per call: {st["items"]} work items, '
                  f'{st["edges_per_item"]!r} edges per item; tiles '
                  f'{st["tile_bytes"] / 1e9!r} GB + g rows '
                  f'{st["g_bytes"] / 1e9!r} GB = {read / 1e9!r} GB, '
                  f'{read / k4 / 1e9!r} TB/s alone, '
                  f'{pr["other_tb_per_s"]!r} TB/s in turns', flush=True)
            check(st['tile_bytes'] <= 1.0e9,
                  f'K4 stages {st["tile_bytes"]} B of tiles per call')
            for level, items in zip((1, 2), res['pair_work']):
                wx = corr_probes.WX if level == 1 else corr_probes.WX2
                check_items(f'K4 level {level} items', items, res['E'],
                            corr_probes.PAIR_CAP,
                            corr_probes.PAIR_TILE[level][0] * wx)
        if mod is micro_corr_floor:
            st, row = res['slab_stats'], res['variants']['slab']
            rows, cap = corr_probes.SLAB_TILE[:2]
            print(f'  K6 slab: device time {res["slab_device_ms"]!r} ms, '
                  f'{row["bound_ms"] / res["slab_device_ms"]!r} of its bound '
                  f'{row["bound_ms"]!r} ms ({row["ms"]!r} ms one launch '
                  f'alone); from L2 per call: {st["items"]} work items, '
                  f'{st["edges_per_item"]!r} edges per item; tiles '
                  f'{st["tile_bytes"] / 1e9!r} GB + g rows '
                  f'{st["g_bytes"] / 1e9!r} GB', flush=True)
            check(st['tile_bytes'] <= 0.25e9,
                  f'K6 slab stages {st["tile_bytes"]} B of tiles per call')
            check_items('K6 slab items', res['slab_work'], res['E'], cap,
                        rows * corr_probes.SLAB)
        if mod is micro_onepass_dma:
            pr = res['paired']['planes_first49_streams / planes_first49']
            print(f'  K7 from L2 per call: {res["copied"] / 1e9!r} GB, '
                  f'{pr["other_tb_per_s"]!r} TB/s (STREAMS=0) and '
                  f'{pr["tb_per_s"]!r} TB/s (STREAMS=1) in turns; STREAMS=1 '
                  f'/ STREAMS=0 {pr["ratio"]!r}', flush=True)
        for row in res['variants'].values():
            k = row['kernel']
            check(counts[k] > 0, f'{row["name"]}: kernel never launched')
            check(row['ms'] is not None, f'{row["name"]}: not timed')
            entries.append(dict(
                name=f'probe_{k}', route='cuda',
                source='dpvo_torch/csrc/corr_probes.cu',
                replaces=row['replaces'], launches=counts[k],
                max_abs_err=row['max_abs_err'], ms=row['ms'],
                plain_ms=row['plain_ms'], bound_ms=row['bound_ms'],
                bound_by=row['bound_by'], library_ms=row['library_ms']))
        del res
        torch.cuda.empty_cache()
    names = {e['name'] for e in entries}
    check(len(names) == len(corr_probes.launches),
          f'probe instantiations run: {sorted(names)}')
    return entries


def main(argv=None):
    import argparse
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument('--phases', default=None,
                    help='for development: run the environment, the build '
                         'and these of phases 14, 16, 17 and 18 (e.g. '
                         '14,16), then stop without the result lines')
    only = ap.parse_args(argv).phases
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    name = torch.cuda.get_device_name(0)

    begin(1, 'environment')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f'  torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.device_count()} device(s): {name}')
    note(f'{smi}; torch {torch.__version__}')

    begin(2, 'build')
    from concurrent.futures import ThreadPoolExecutor
    from dpvo_torch.ops import corr_fused, corr_grad, corr_onepass, \
        corr_probes
    t0 = time.perf_counter()
    builds = (corr_onepass.build, corr_fused.build, corr_probes.build,
              corr_grad.build)
    with ThreadPoolExecutor(len(builds)) as ex:  # one nvcc per source
        sos = [f.result() for f in [ex.submit(b) for b in builds]]
    print(f'  {", ".join(so.name for so in sos)} in '
          f'{time.perf_counter() - t0:.1f} s')
    note(f'{len(sos)} sources built in {time.perf_counter() - t0:.1f} s')
    for so in sos:
        for line in so.with_suffix('.log').read_text().splitlines():
            if 'Compiling entry' in line or 'registers' in line \
                    or 'spill' in line:
                print('  ' + line.strip())
    for maps in (torch.bfloat16, torch.float32):
        thr, smem, blocks = corr_onepass.occupancy(maps, torch.bfloat16)
        print(f'  K1 with {maps} maps: {thr} threads and {smem} B of shared '
              f'memory per block, {blocks} blocks per SM')
    sh = corr_fused.planes_shape(49152)
    check(sh['smem'] == corr_fused.ring_smem() and
          (sh['stages'], sh['rows'], sh['warps']) ==
          (corr_fused.RING_STAGES, corr_fused.RING_ROWS,
           corr_fused.RING_WARPS), f'K2 launch shape {sh}')
    print(f'  K2 with bf16 maps at E = 49,152: grid {sh["grid"]}, '
          f'{sh["threads"]} threads, {sh["smem"]} B of dynamic shared '
          f'memory, {sh["regs"]} registers, {sh["resident"]} blocks per SM; '
          f'ring of {sh["stages"]} stages x {sh["rows"]} window positions '
          f'({sh["stages"] * sh["rows"] * 256} B), {sh["warps"]} consumer '
          f'warps')
    for key, (stages, rows, warps, _) in corr_probes.PLANES_RING.items():
        sh = corr_probes.planes_ring_shape(key, 49152)
        check(sh['smem'] == corr_probes.ring_smem(key) and
              (sh['stages'], sh['rows'], sh['warps']) == (stages, rows, warps),
              f'{key} launch shape {sh}')
        print(f'  {key} (on the planes ring) at E = 49,152: grid '
              f'{sh["grid"]}, {sh["threads"]} threads, {sh["smem"]} B of '
              f'dynamic shared memory, {sh["regs"]} registers, '
              f'{sh["resident"]} blocks per SM; ring of {sh["stages"]} stages '
              f'x {sh["rows"]} window positions, {sh["warps"]} consumer warps')
    for level in (1, 2):
        sh = corr_probes.pair_shape(level, 43008)
        rows, warps, _, unit = corr_probes.PAIR_TILE[level]
        check(sh['smem'] == corr_probes.pair_smem(level) and
              (sh['rows'], sh['warps'], sh['cap'], sh['unit']) ==
              (rows, warps, corr_probes.PAIR_CAP, unit),
              f'K4 level {level} launch shape {sh}')
        print(f'  planes_pair (K4) level {level} tiles at E = 43,008: grid '
              f'{sh["grid"]}, {sh["threads"]} threads, {sh["smem"]} B of '
              f'dynamic shared memory, {sh["regs"]} registers, '
              f'{sh["resident"]} blocks per SM; tiles of up to {sh["rows"]} '
              f'map rows, {sh["warps"]} consumer warps, units of '
              f'{sh["unit"]} tile pairs, up to {sh["cap"]} edges per work '
              f'item')
    sh = corr_probes.slab_shape(49152)
    rows, cap, warps, blocks, *unit = corr_probes.SLAB_TILE
    check(sh['smem'] == corr_probes.slab_smem() and
          [sh[k] for k in ('rows', 'cap', 'warps', 'unit_rows', 'unit',
                           'pass')] == [rows, cap, warps, *unit] and
          1 <= sh['resident'] <= blocks, f'K6 slab launch shape {sh}')
    print(f'  slab (K6) tiles at E = 49,152: grid {sh["grid"]}, '
          f'{sh["threads"]} threads, {sh["smem"]} B of dynamic shared '
          f'memory, {sh["regs"]} registers, {sh["resident"]} blocks per SM; '
          f'tiles of up to {sh["rows"]} map rows, up to {sh["cap"]} edges '
          f'per work item, {sh["warps"]} consumer warps, units of '
          f'{sh["unit_rows"]} tile rows x up to {sh["unit"]} m16 tiles, '
          f'passes of {sh["pass"]}')
    for key in ('dots', 'dots2'):
        sh = corr_probes.dots_shape(key, 49152)
        print(f'  K6 {key} at E = 49,152: grid {sh["grid"]}, '
              f'{sh["threads"]} threads, {sh["smem"]} B of dynamic shared '
              f'memory, {sh["regs"]} registers, {sh["resident"]} blocks per '
              f'SM; ring of {sh["stages"]} stages x {sh["rows"]} rows, '
              f'{sh["warps"]} consumer warps')

    if only is not None:
        dev_phases = {
            14: ('classic loop closure on the card', classic_on_card),
            16: ('training and evaluation entry points on the card',
                 train_eval_on_card),
            17: ('the geometry library on the card', geometry_on_card),
            18: ('HybridVO with mirrors in flight on the card',
                 pipeline_on_card)}
        for n in sorted(int(x) for x in only.split(',')):
            check(n in dev_phases, f'--phases takes 14, 16, 17 and 18, not '
                  f'{n}')
            begin(n, dev_phases[n][0])
            dev_phases[n][1](dev, smi)
        print_summary()
        print(f'{smi}\nchip_smoke: phases {only} only; no result lines')
        return 0

    begin(3, 'kernels vs plain')
    err, k_ms, p_ms, b1, staged = kernel_vs_plain(
        dev, E=49152, F=36, H1=120, W1=160, Ng=36 * 96, nv=40013, seed=0,
        timed=True)
    M, G = 48, 320                  # fast.yaml: M = 48, 320 pair slots
    kk = (np.repeat(np.arange(G) % 36, M) * M + np.tile(np.arange(M), G))
    err48, *_ = kernel_vs_plain(dev, E=M * G, F=36, H1=120, W1=160,
                                  Ng=36 * M, nv=300 * M, seed=1, kk=kk)
    k2, k3, streamed = fused_vs_plain(dev, E=49152, F=36, H1=120, W1=160,
                                      Ng=36 * 96, seed=2)
    print(f'  bytes to the SMs per call: K1 stages {staged / 1e9!r} GB '
          f'({staged / k_ms / 1e9!r} TB/s at its time), K2 copies '
          f'{streamed / 1e9!r} GB ({streamed / k2[1] / 1e9!r} TB/s)',
          flush=True)
    for key, (e, ms, pms, bound) in (('K1', (max(err, err48), k_ms, p_ms,
                                             b1)), ('K2', k2), ('K3', k3)):
        note(f'{key} {ms:.4g} ms (plain {pms:.4g}, bound {bound[0]:.3g}, '
             f'err {e:.2g})')

    begin(4, 'DeviceVO main path')
    py_ms, launch_us, objs = host_pace(dev)
    print(f'  host pace: Python loop {py_ms!r} ms, {launch_us!r} us per '
          f'launch, {objs} objects tracked by gc', flush=True)
    dv, dv_iters, dv_stats = main_path(dev, 'default.yaml', 'onepass')
    check(dv['corr_onepass'] >= dv_iters, f'K1 launched '
          f'{dv["corr_onepass"]} times, expected >= {dv_iters}')

    begin(5, 'hybrid main path')
    hy, hy_iters, hy_stats = main_path(dev, 'default.yaml + GRADIENT_BIAS',
                                       'fused_k',
                                       CENTROID_SEL_STRAT='GRADIENT_BIAS')
    # one K2 launch per update iteration, one K3 launch per level
    check(hy['corr_planes'] >= hy_iters, f'K2 launched '
          f'{hy["corr_planes"]} times, expected >= {hy_iters}')
    check(hy['corr_select'] >= 2 * hy_iters, f'K3 launched '
          f'{hy["corr_select"]} times, expected >= {2 * hy_iters}')
    # the hybrid's default correlation (K1) on the same frames
    ho, ho_iters, ho_stats = main_path(dev, 'default.yaml + GRADIENT_BIAS',
                                       'onepass',
                                       CENTROID_SEL_STRAT='GRADIENT_BIAS')
    check(ho['corr_onepass'] >= ho_iters and ho['corr_planes'] == 0,
          f'HybridVO onepass launches {ho}, expected K1 >= {ho_iters}')
    for impl, st in (('fused_k', hy_stats), ('onepass', ho_stats)):
        corr = ('not measured' if st['busy'] is None else
                f'K1 {st["K1"]!r}, K2 {st["K2"]!r}, K3 {st["K3"]!r}, '
                f'K2 + K3 {st["K2"] + st["K3"]!r}')
        print(f'  HybridVO {impl}: wall {st["wall"]!r} ms/frame, busy '
              f'{st["busy"]!r}, idle {st["idle"]!r}; correlation ms/frame: '
              f'{corr}', flush=True)

    begin(6, 'DeviceVO with fused_k')
    dk, dk_iters, _ = main_path(dev, 'default.yaml', 'fused_k', n_frames=12,
                                measure=False)
    check(dk['corr_planes'] >= dk_iters and
          dk['corr_select'] >= 2 * dk_iters,
          f'K2 / K3 launched {dk}, expected >= {dk_iters} / '
          f'{2 * dk_iters}')

    begin(7, 'CUDA vs CPU')
    small_cpu_vs_cuda(dev)

    begin(8, 'correlation probes')
    probe_entries = probes()
    for e in probe_entries:
        note(f'{e["name"]} {e["ms"]:.4g} ms (bound {e["bound_ms"]:.3g})')

    begin(9, 'DeviceVO on yuv420, per frame and chunked')
    ingest_and_chunks(dev, smi, dv_stats)

    begin(10, 'HybridVO on yuv420, CUDA vs CPU')
    small_cpu_vs_cuda(dev, runs=(
        ('HybridVO', (256, 320), 'onepass', dict(GB, UPLOAD_FORMAT='yuv420'),
         ('corr_onepass',)),), precisions=(True,))

    begin(11, 'accuracy on the card')
    accuracy_on_card(dev)

    begin(12, 'DPV-SLAM (learned loop closure) on the card')
    dpv_slam_on_card(dev, smi)

    begin(13, 'training on the card')
    backward_entry = train_on_card(dev, smi)
    note(f'corr_backward {backward_entry["ms"]:.4g} ms (plain '
         f'{backward_entry["plain_ms"]:.4g}, bound '
         f'{backward_entry["bound_ms"]:.3g})')

    begin(14, 'classic loop closure on the card')
    classic_on_card(dev, smi)

    begin(15, 'entry points on the card')
    entry_points_on_card(dev, smi, dv_stats, ho_stats)

    begin(16, 'training and evaluation entry points on the card')
    train_eval_on_card(dev, smi)

    begin(17, 'the geometry library on the card')
    geometry_on_card(dev, smi)

    begin(18, 'HybridVO with mirrors in flight on the card')
    pipeline_on_card(dev, smi)

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound):
        return dict(name=name, route='cuda', source=source,
                    replaces=replaces, launches=launches, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                    bound_by=bound[1], library_ms=None)

    print(smi)
    print_summary()
    print(json.dumps({'kernels': [
        entry('corr_onepass', 'dpvo_torch/csrc/corr_onepass.cu',
              'dpvo_tpu/ops/corr_onepass.py:196', dv['corr_onepass'],
              max(err, err48), k_ms, p_ms, b1),
        entry('corr_planes', 'dpvo_torch/csrc/corr_fused.cu',
              'dpvo_tpu/ops/corr_fused.py:94', hy['corr_planes'], *k2),
        entry('corr_select', 'dpvo_torch/csrc/corr_fused.cu',
              'dpvo_tpu/ops/corr_select.py:63', hy['corr_select'], *k3),
        *probe_entries, backward_entry]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
