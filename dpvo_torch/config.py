"""Configuration system — yacs-compatible CfgNode without the dependency.

Same keys and defaults as dpvo_tpu/config.py (reference dpvo/config.py:3-38).
`yaml` is imported only inside merge_from_file, so building a config from
the defaults or from `--opts` lists needs no third-party package.
"""
from __future__ import annotations

import copy


class CfgNode(dict):
    """Minimal yacs-style config: attribute access + yaml/list merging."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def clone(self):
        return CfgNode(copy.deepcopy(dict(self)))

    def merge_from_file(self, path):
        import yaml
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        for k, v in data.items():
            self[k] = _coerce(self.get(k), v)

    def merge_from_list(self, opts):
        """KEY VALUE pairs (yacs style); KEY=VALUE tokens also accepted."""
        flat = []
        for tok in opts:
            if isinstance(tok, str) and '=' in tok:
                flat.extend(tok.split('=', 1))
            else:
                flat.append(tok)
        if len(flat) % 2:
            raise ValueError('opts must be KEY VALUE pairs')
        for k, v in zip(flat[::2], flat[1::2]):
            self[k] = _coerce(self.get(k), v)

    def __str__(self):
        return '\n'.join(f'{k}: {self[k]}' for k in sorted(self))


def _coerce(old, new):
    """Coerce a yaml/string value to the type of the existing default."""
    if old is None:
        return new
    t = type(old)
    if t is bool and isinstance(new, str):
        return new.lower() in ('1', 'true', 'yes')
    if isinstance(new, str) and t is not str:
        return t(new)
    if t in (int, float):
        return t(new)
    return new


# defaults — reference dpvo/config.py:3-38 (equal to dpvo_tpu.config.cfg)
cfg = CfgNode(
    BUFFER_SIZE=4096,
    CENTROID_SEL_STRAT='RANDOM',
    PATCHES_PER_FRAME=80,
    REMOVAL_WINDOW=20,
    OPTIMIZATION_WINDOW=12,
    PATCH_LIFETIME=12,
    KEYFRAME_INDEX=4,
    KEYFRAME_THRESH=12.5,
    MOTION_MODEL='DAMPED_LINEAR',
    MOTION_DAMPING=0.5,
    MIXED_PRECISION=True,
    # frame ingest: 'rgb' or 'yuv420' (I420 planes, half the bytes)
    UPLOAD_FORMAT='rgb',
    # hybrid runtime: frames whose host mirrors may be in flight at once
    # (runtime/dpvo.py); 1 reads each frame's back before the next
    MIRROR_PIPELINE=1,
    LOOP_CLOSURE=False,
    BACKEND_THRESH=64.0,
    MAX_EDGE_AGE=1000,
    GLOBAL_OPT_FREQ=15,
    CLASSIC_LOOP_CLOSURE=False,
    LOOP_CLOSE_WINDOW_SIZE=3,
    LOOP_RETR_THRESH=0.04,
    LOOP_RETR_RAD=50,
)
