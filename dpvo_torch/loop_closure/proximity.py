"""Learned proximity loop-closure edge proposal (DPV-SLAM backend #1).

Copy of dpvo_tpu/loop_closure/proximity.py (numpy only; copied so this
package never imports the JAX package). Mirrors PatchGraph.edges_loop
(reference dpvo/patchgraph.py:56-82): propose edges from old patches to
recent frames, filter by blended flow magnitude, then greedy NMS edge
selection (reference reduce_edges, dpvo/loop_closure/optim_utils.py:24-60).
"""
from __future__ import annotations

import numpy as np

from ..runtime import numpy_se3 as nse3


def reduce_edges(flow_mag, ii, jj, max_num_edges, nms=1):
    """Greedy lowest-flow-first selection with (i, j) NMS suppression."""
    if len(flow_mag) == 0:
        return np.zeros((0, 2), dtype=np.int64)
    es = []
    taken_i = set()
    taken_j = set()
    order = np.argsort(flow_mag, kind='stable')
    for idx in order:
        if len(es) >= max_num_edges:
            break
        i, j = int(ii[idx]), int(jj[idx])
        if any((i + di) in taken_i for di in range(-nms, nms + 1)):
            continue
        if any((j + dj) in taken_j for dj in range(-nms, nms + 1)):
            continue
        es.append((i, j))
        taken_i.add(i)
        taken_j.add(j)
    return np.asarray(es, dtype=np.int64).reshape(-1, 2)


def proximity_edges(slam):
    """Candidate loop edges (kk, jj) for the current graph state: slam's
    cfg, M, n and host mirrors poses_np, centers_np, depth_np, intr_np."""
    cfg = slam.cfg
    M = slam.M
    n = slam.n
    lc_range = cfg.MAX_EDGE_AGE
    l = n - cfg.REMOVAL_WINDOW  # upper bound for "old" patches

    if l <= 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)

    jj_f = np.arange(n - cfg.GLOBAL_OPT_FREQ, n - cfg.KEYFRAME_INDEX)
    jj_f = jj_f[jj_f >= 0]
    kk_c = np.arange(max(l - lc_range, 0) * M, l * M)
    if len(jj_f) == 0 or len(kk_c) == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)

    jj, kk = np.meshgrid(jj_f, kk_c, indexing='ij')
    jj, kk = jj.ravel(), kk.ravel()
    ii = kk // M

    flow, val = nse3.flow_mag(slam.poses_np, slam.centers_np, slam.depth_np,
                              slam.intr_np, ii, jj, kk, beta=0.5)

    # per-(frame-pair) mean over valid patches; require 75% valid
    fl = flow.reshape(-1, M)
    vl = val.reshape(-1, M)
    num_val = np.maximum(vl.sum(axis=1), 1)
    mean_flow = np.where(vl.sum(axis=1) > M * 0.75,
                         (fl * vl).sum(axis=1) / num_val, np.inf)

    mask = mean_flow < cfg.BACKEND_THRESH
    if mask.sum() == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)

    ii_g = ii.reshape(-1, M)[:, 0][mask]
    jj_g = jj.reshape(-1, M)[:, 0][mask]
    es = reduce_edges(mean_flow[mask], ii_g, jj_g, max_num_edges=1000, nms=1)
    if len(es) == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)

    kk_out = (es[:, 0:1] * M + np.arange(M)[None, :]).ravel()
    jj_out = np.repeat(es[:, 1], M)
    return kk_out.astype(np.int32), jj_out.astype(np.int32)
