"""TartanAir training dataset (reference dpvo/data_readers/tartan.py:53-108).

Copy of dpvo_tpu/data_readers/tartan.py over this package's RGBDDataset.
NED -> xyz pose permutation [1,2,0,4,5,3,6], DEPTH_SCALE 5.0, fixed
intrinsics [320, 320, 320, 240], 32-scene validation split.
"""
from __future__ import annotations

import glob
import os.path as osp

import cv2
import numpy as np

from .base import RGBDDataset

test_split = [
    "abandonedfactory/abandonedfactory/Easy/P011",
    "abandonedfactory/abandonedfactory/Hard/P011",
    "abandonedfactory_night/abandonedfactory_night/Easy/P013",
    "abandonedfactory_night/abandonedfactory_night/Hard/P014",
    "amusement/amusement/Easy/P008",
    "amusement/amusement/Hard/P007",
    "carwelding/carwelding/Easy/P007",
    "endofworld/endofworld/Easy/P009",
    "gascola/gascola/Easy/P008",
    "gascola/gascola/Hard/P009",
    "hospital/hospital/Easy/P036",
    "hospital/hospital/Hard/P049",
    "japanesealley/japanesealley/Easy/P007",
    "japanesealley/japanesealley/Hard/P005",
    "neighborhood/neighborhood/Easy/P021",
    "neighborhood/neighborhood/Hard/P017",
    "ocean/ocean/Easy/P013",
    "ocean/ocean/Hard/P009",
    "office2/office2/Easy/P011",
    "office2/office2/Hard/P010",
    "office/office/Hard/P007",
    "oldtown/oldtown/Easy/P007",
    "oldtown/oldtown/Hard/P008",
    "seasidetown/seasidetown/Easy/P009",
    "seasonsforest/seasonsforest/Easy/P011",
    "seasonsforest/seasonsforest/Hard/P006",
    "seasonsforest_winter/seasonsforest_winter/Easy/P009",
    "seasonsforest_winter/seasonsforest_winter/Hard/P018",
    "soulcity/soulcity/Easy/P012",
    "soulcity/soulcity/Hard/P009",
    "westerndesert/westerndesert/Easy/P013",
    "westerndesert/westerndesert/Hard/P007",
]


class TartanAir(RGBDDataset):

    DEPTH_SCALE = 5.0  # scale depths to balance rot & trans

    def __init__(self, mode='training', **kwargs):
        self.mode = mode
        super().__init__(name='TartanAir', **kwargs)

    @staticmethod
    def is_test_scene(scene):
        return any(x in scene for x in test_split)

    def _build_dataset(self):
        print('Building TartanAir dataset')
        scene_info = {}
        scenes = glob.glob(osp.join(self.root, '*/*/*/*'))
        for scene in sorted(scenes):
            images = sorted(glob.glob(osp.join(scene, 'image_left/*.png')))
            depths = sorted(glob.glob(osp.join(scene, 'depth_left/*.npy')))
            if len(images) != len(depths) or len(images) == 0:
                continue

            poses = np.loadtxt(osp.join(scene, 'pose_left.txt'), delimiter=' ')
            poses = poses[:, [1, 2, 0, 4, 5, 3, 6]]       # NED -> xyz
            poses[:, :3] /= TartanAir.DEPTH_SCALE
            intrinsics = [TartanAir.calib_read()] * len(images)

            graph = self.build_frame_graph(poses, depths, intrinsics)
            scene_info[scene] = {
                'images': images, 'depths': depths, 'poses': poses,
                'intrinsics': intrinsics, 'graph': graph}
        return scene_info

    @staticmethod
    def calib_read():
        return np.array([320.0, 320.0, 320.0, 240.0])

    @staticmethod
    def image_read(image_file):
        return cv2.imread(image_file)

    @staticmethod
    def depth_read(depth_file):
        depth = np.load(depth_file) / TartanAir.DEPTH_SCALE
        depth[np.isnan(depth)] = 1.0
        depth[np.isinf(depth)] = 1.0
        return depth


class TartanAirTest:
    """Iterator over the official TartanAir mono test sequences
    (reference tartan.py test loader + evaluate_tartan.py:95-110)."""

    def __init__(self, datapath):
        self.datapath = datapath

    def sequences(self):
        return sorted(glob.glob(osp.join(self.datapath, '*')))

    @staticmethod
    def intrinsics():
        return np.array([320.0, 320.0, 320.0, 240.0])
