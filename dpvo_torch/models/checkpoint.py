"""Weights: dpvo_tpu flat dicts <-> torch state_dicts, loading, seeded init.

dpvo_tpu keeps weights as a flat name -> array dict in its own layout
(models/checkpoint.py:convert_torch_state_dict): conv HWIO, linear
(in, out). VONet here uses the reference's torch layout (OIHW, (out, in)),
so `state_dict_from_jax` inverts those transposes and a dpvo_tpu .npz
(e.g. artifacts/micro_vonet.npz) loads with load_state_dict. A reference
dpvo.pth loads directly after stripping 'module.' and dropping
'update.lmbda' (reference dpvo.py:90-111).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def state_dict_from_jax(params):
    """dpvo_tpu flat dict (name -> array) -> torch state_dict (f32)."""
    out = {}
    for k, v in params.items():
        a = np.asarray(v, dtype=np.float32)
        if a.ndim == 4:                    # conv HWIO -> OIHW
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2 and k.endswith('.weight'):
            a = a.T                        # linear (in, out) -> (out, in)
        out[k] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def load_network(path):
    """state_dict from a reference .pth or a dpvo_tpu .npz, by extension."""
    path = str(path)
    if path.endswith('.npz'):
        with np.load(path) as z:
            return state_dict_from_jax({k: z[k] for k in z.files})
    sd = torch.load(path, map_location='cpu', weights_only=True)
    return {k.replace('module.', ''): v.float() for k, v in sd.items()
            if 'update.lmbda' not in k}


# ---------------------------------------------------------------------------
# seeded init — the same numpy draws, in the same order and layout, as
# dpvo_tpu/models/vonet.py:259-288 and extractor.py:181-208, so a network of
# None gives bit-identical weights in both packages
# ---------------------------------------------------------------------------

_ENC_DIM = 32
_DIM = 384
_CORR_IN = 2 * 49 * 3 * 3


def _init_encoder(rng, prefix, output_dim):
    p = {}

    def add_conv(name, o, i, k):
        std = math.sqrt(2.0 / (o * k * k))        # kaiming normal, fan_out
        p[name + '.weight'] = rng.randn(k, k, i, o).astype(np.float32) * std
        p[name + '.bias'] = np.zeros(o, np.float32)

    add_conv(prefix + '.conv1', _ENC_DIM, 3, 7)
    for li, (cin, cout, stride) in enumerate(
            [(_ENC_DIM, _ENC_DIM, 1), (_ENC_DIM, 2 * _ENC_DIM, 2)]):
        name = f'{prefix}.layer{li + 1}'
        add_conv(name + '.0.conv1', cout, cin, 3)
        add_conv(name + '.0.conv2', cout, cout, 3)
        if stride != 1:
            add_conv(name + '.0.downsample.0', cout, cin, 1)
        add_conv(name + '.1.conv1', cout, cout, 3)
        add_conv(name + '.1.conv2', cout, cout, 3)
    add_conv(prefix + '.conv2', output_dim, 2 * _ENC_DIM, 1)
    return p


def _init_linear(rng, p, name, fan_in, fan_out):
    bound = 1.0 / np.sqrt(fan_in)
    p[name + '.weight'] = rng.uniform(
        -bound, bound, (fan_in, fan_out)).astype(np.float32)
    p[name + '.bias'] = rng.uniform(-bound, bound, fan_out).astype(np.float32)


def _init_layer_norm(p, name, dim):
    p[name + '.weight'] = np.ones(dim, np.float32)
    p[name + '.bias'] = np.zeros(dim, np.float32)


def init_vonet_params(seed=0):
    """Seeded random VONet weights as a dpvo_tpu-layout flat numpy dict."""
    rng = np.random.RandomState(seed)
    p = {}
    p.update(_init_encoder(rng, 'patchify.fnet', 128))
    p.update(_init_encoder(rng, 'patchify.inet', _DIM))
    for name in ('update.c1.0', 'update.c1.2', 'update.c2.0', 'update.c2.2'):
        _init_linear(rng, p, name, _DIM, _DIM)
    _init_layer_norm(p, 'update.norm', _DIM)
    for agg in ('update.agg_kk', 'update.agg_ij'):
        for f in ('.f', '.g', '.h'):
            _init_linear(rng, p, agg + f, _DIM, _DIM)
    for ln, gr in (('update.gru.0', 'update.gru.1'),
                   ('update.gru.2', 'update.gru.3')):
        _init_layer_norm(p, ln, _DIM)
        for name in ('.gate.0', '.res.0', '.res.2'):
            _init_linear(rng, p, gr + name, _DIM, _DIM)
    _init_linear(rng, p, 'update.corr.0', _CORR_IN, _DIM)
    _init_linear(rng, p, 'update.corr.2', _DIM, _DIM)
    _init_layer_norm(p, 'update.corr.3', _DIM)
    _init_linear(rng, p, 'update.corr.5', _DIM, _DIM)
    _init_linear(rng, p, 'update.d.1', _DIM, 2)
    _init_linear(rng, p, 'update.w.1', _DIM, 2)
    return p
