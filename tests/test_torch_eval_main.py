"""The evaluation CLIs' main (dpvo_torch.demo.evaluate under
evaluate_euroc, _tum, _kitti and _icl_nuim) on test_torch_eval_cli.py's
fake dataset layouts, on the CPU, the motion probe forced as there. The
root scripts run their protocol at import level (under __main__), so
there is no root function to hold main to: the test checks the root's
output names, the per-scene median and the AVG. The readers, run and ate
are held to the root's in test_torch_eval_cli.py."""
import os
import shutil

import numpy as np
import pytest

from dpvo_torch import demo as tdemo
from dpvo_torch import evaluate_euroc as teuroc
from dpvo_torch import evaluate_icl_nuim as ticl
from dpvo_torch import evaluate_kitti as tkitti
from dpvo_torch import evaluate_tum as ttum
from dpvo_torch.config import cfg as torch_cfg
from test_torch_cli import _forced, _small_cfg
from test_torch_eval_cli import N_EVAL, _euroc, _icl_nuim, _kitti, _tum
from test_torch_runtime import NPZ, REPO, torch_threads

LAYOUTS = dict(euroc=_euroc, tum=_tum, kitti=_kitti, icl_nuim=_icl_nuim)


# each CLI's main over its layout's one scene: (module, scene-list
# attribute, scene, dataset flag and directory under tmp_path, the names
# of its plot and saved trajectory)
MAINS = {
    'euroc': (teuroc, 'SCENES', 'MH_01_easy', '--eurocdir', 'EUROC',
              'euroc_MH_01_easy_trial01', 'euroc_MH_01_easy'),
    'tum': (ttum, 'SCENES', 'rgbd_dataset_freiburg1_xyz', '--tumdir', '.',
            'TUM_rgbd_dataset_freiburg1_xyz_Trial01',
            'TUM_rgbd_dataset_freiburg1_xyz'),
    'kitti': (tkitti, 'SEQUENCES', '00', '--kittidir', 'KITTI',
              'KITTI_00_Trial01', 'KITTI_00'),
    'icl_nuim': (ticl, 'SCENES', 'living_room_traj0_loop', '--iclnuim_dir',
                 'ICL_NUIM', 'ICL_NUIM_Living_Room_Traj0_Trial01',
                 'ICL_NUIM_living_room_traj0_loop'),
}


@pytest.mark.parametrize('name', sorted(MAINS))
def test_eval_main_writes_and_averages(name, tmp_path, monkeypatch):
    """Each CLI's main (demo.evaluate) on its fake layout, one trial, with
    --plot and --save_trajectory, cwd=tmp_path (the root scripts' relative
    calib/ and ground-truth paths): the per-trial plots and the saved
    trajectory under the root's names, and a finite AVG equal to the
    scene's median."""
    module, attr, scene, flag, sub, plot, saved = MAINS[name]
    LAYOUTS[name](tmp_path)
    shutil.copytree(os.path.join(REPO, 'calib'), tmp_path / 'calib')
    if name == 'euroc':
        (tmp_path / 'datasets' / 'euroc_groundtruth').mkdir(parents=True)
        shutil.copy(tmp_path / 'gt.txt', tmp_path / 'datasets' /
                    'euroc_groundtruth' / f'{scene}.txt')
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(module, attr, [scene])
    monkeypatch.setattr(tdemo, 'DPVO', _forced(tdemo.DPVO))
    monkeypatch.setattr(tdemo, 'cfg', _small_cfg(torch_cfg))
    with torch_threads(2):
        results, avg = module.main(
            [flag, str(tmp_path / sub), '--network', NPZ, '--stride', '1',
             '--trials', '1', '--plot', '--save_trajectory', '--device',
             'cpu', '--config', os.path.join(REPO, 'config', 'default.yaml'),
             '--opts', 'BUFFER_SIZE', '64', 'PATCHES_PER_FRAME', '8',
             'MIXED_PRECISION', 'False'])
    assert list(results) == [scene] and np.isfinite(avg)
    assert avg == results[scene]
    assert (tmp_path / 'trajectory_plots' / f'{plot}.pdf').stat().st_size
    rows = (tmp_path / 'saved_trajectories' / f'{saved}.txt').read_text()
    assert len([r for r in rows.splitlines() if r]) == N_EVAL
