"""Training dataset base: co-visibility sampled RGB-D video clips.

Copy of dpvo_tpu/data_readers/base.py (reference dpvo/data_readers/
base.py:18-176; a plain indexable over host numpy, no torch Dataset).
Scene indices are built once and cached in a pickle; clips are sampled by
walking the precomputed co-visibility frame graph with flow-magnitude
bounds [fmin, fmax]. Where it differs from dpvo_tpu:
  * the clip sampling and the augmentor draw from generators made from
    `seed` (seed and seed + 1), where dpvo_tpu's draw from unseeded
    RandomStates;
  * given scene_info_path it makes no directory; without it the pickle
    goes to CACHE_DIR, made then (dpvo_tpu makes its package's cache/ in
    every case).
"""
from __future__ import annotations

import os
import os.path as osp
import pickle

import cv2
import numpy as np

from .augmentation import RGBDAugmentor
from .rgbd_utils import compute_distance_matrix_flow

CACHE_DIR = osp.join(osp.dirname(osp.abspath(__file__)), 'cache')


class RGBDDataset:
    def __init__(self, name, datapath, n_frames=4, crop_size=(480, 640),
                 fmin=10.0, fmax=75.0, aug=True, sample=True,
                 scene_info_path=None, seed=0):
        self.root = datapath
        self.name = name
        self.n_frames = n_frames
        self.fmin = fmin
        self.fmax = fmax
        self.sample = sample
        self.aug = (RGBDAugmentor(crop_size=crop_size, rng=seed + 1)
                    if aug else None)
        self.rng = np.random.RandomState(seed)

        if scene_info_path is None:
            os.makedirs(CACHE_DIR, exist_ok=True)
            scene_info_path = osp.join(CACHE_DIR, f'{name}.pickle')
        if osp.isfile(scene_info_path):
            with open(scene_info_path, 'rb') as f:
                obj = pickle.load(f)
            # reference shipped pickles are wrapped in a 1-tuple
            self.scene_info = obj[0] if isinstance(obj, tuple) else obj
        else:
            self.scene_info = self._build_dataset()
            with open(scene_info_path, 'wb') as f:
                pickle.dump(self.scene_info, f)

        self._build_dataset_index()

    # -------------------------------------------------------------- #
    def _build_dataset(self):
        raise NotImplementedError

    @staticmethod
    def is_test_scene(scene):
        return False

    def _build_dataset_index(self):
        self.dataset_index = []
        for scene in self.scene_info:
            if not self.__class__.is_test_scene(scene):
                graph = self.scene_info[scene]['graph']
                for i in graph:
                    if i < len(graph) - 65:
                        self.dataset_index.append((scene, i))
            else:
                print(f'Reserving {scene} for validation')

    @staticmethod
    def image_read(image_file):
        return cv2.imread(image_file)

    @staticmethod
    def depth_read(depth_file):
        return np.load(depth_file)

    def build_frame_graph(self, poses, depths, intrinsics, f=16,
                          max_flow=256):
        """All-pairs flow distance graph (reference base.py:64-83)."""
        def read_disp(fn):
            depth = self.__class__.depth_read(fn)[f // 2::f, f // 2::f]
            depth[depth < 0.01] = np.mean(depth)
            return 1.0 / depth

        poses = np.array(poses)
        intrinsics = np.array(intrinsics) / f
        disps = np.stack(list(map(read_disp, depths)), 0)
        d = f * compute_distance_matrix_flow(poses, disps, intrinsics)

        graph = {}
        for i in range(d.shape[0]):
            j, = np.where(d[i] < max_flow)
            graph[i] = (j, d[i, j])
        return graph

    # -------------------------------------------------------------- #
    def __len__(self):
        return len(self.dataset_index)

    def __getitem__(self, index):
        """Returns (images (T,H,W,3) f32, poses (T,7) c2w, disps (T,H,W),
        intrinsics (T,4)) — sampling logic of reference base.py:84-169."""
        index = index % len(self.dataset_index)
        scene_id, ix = self.dataset_index[index]

        graph = self.scene_info[scene_id]['graph']
        images_list = self.scene_info[scene_id]['images']
        depths_list = self.scene_info[scene_id]['depths']
        poses_list = self.scene_info[scene_id]['poses']
        intrinsics_list = self.scene_info[scene_id]['intrinsics']

        inds = [ix]
        while len(inds) < self.n_frames:
            if self.sample:
                k = (graph[ix][1] > self.fmin) & (graph[ix][1] < self.fmax)
                frames = graph[ix][0][k]
                if np.count_nonzero(frames[frames > ix]):
                    ix = self.rng.choice(frames[frames > ix])
                elif ix + 1 < len(images_list):
                    ix = ix + 1
                elif np.count_nonzero(frames):
                    ix = self.rng.choice(frames)
            else:
                ix = min(ix + 1, len(images_list) - 1)
            inds.append(ix)

        images = np.stack([self.__class__.image_read(images_list[i])
                           for i in inds]).astype(np.float32)
        depths = np.stack([self.__class__.depth_read(depths_list[i])
                           for i in inds]).astype(np.float32)
        poses = np.stack([poses_list[i] for i in inds]).astype(np.float32)
        intrinsics = np.stack([intrinsics_list[i]
                               for i in inds]).astype(np.float32)

        disps = 1.0 / depths

        if self.aug is not None:
            images, poses, disps, intrinsics = self.aug(
                images, poses, disps, intrinsics)

        # normalize depth scale (reference base.py:165-167)
        s = 0.7 * np.quantile(disps, 0.98)
        disps = disps / s
        poses = poses.copy()
        poses[..., :3] *= s

        return images, poses, disps, intrinsics
