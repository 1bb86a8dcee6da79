"""Seeded random VONet weights, made on the device in a few large calls.

The layout is VONet's state_dict (reference dpvo/net.py names, torch
layouts: conv OIHW, linear (out, in)), stated here from the
configuration's widths so that the reference and the program get the same
values without either reading the other. One normal draw of every value
from a torch.Generator on the device, scaled and shifted per tensor by
two vectors (repeat_interleave), then cast to the served precision.
"""
from __future__ import annotations

import math

import torch


def layout(net):
    """[(name, shape, std, mean)] of every VONet parameter for the
    configuration's `network` widths: conv weights normal with std
    sqrt(2 / fan_out) (kaiming, as the repository's seeded init), conv
    biases 0, linear weights and biases normal with the variance of
    uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)), LayerNorm weight 1, bias
    0."""
    e, dim, fdim = net['enc_dim'], net['dim'], net['fdim']
    P, R = net['patch'], net['corr_radius']
    corr_in = net['corr_levels'] * (2 * R + 1) ** 2 * P * P
    out = []

    def conv(name, o, i, k):
        out.append((name + '.weight', (o, i, k, k),
                    math.sqrt(2.0 / (o * k * k)), 0.0))
        out.append((name + '.bias', (o,), 0.0, 0.0))

    def lin(name, i, o):
        s = 1.0 / math.sqrt(3.0 * i)
        out.append((name + '.weight', (o, i), s, 0.0))
        out.append((name + '.bias', (o,), s, 0.0))

    def norm(name, d):
        out.append((name + '.weight', (d,), 0.0, 1.0))
        out.append((name + '.bias', (d,), 0.0, 0.0))

    for enc, od in (('patchify.fnet', fdim), ('patchify.inet', dim)):
        conv(enc + '.conv1', e, 3, 7)
        for li, (ci, co, stride) in enumerate([(e, e, 1), (e, 2 * e, 2)]):
            name = f'{enc}.layer{li + 1}'
            conv(name + '.0.conv1', co, ci, 3)
            conv(name + '.0.conv2', co, co, 3)
            if stride != 1:
                conv(name + '.0.downsample.0', co, ci, 1)
            conv(name + '.1.conv1', co, co, 3)
            conv(name + '.1.conv2', co, co, 3)
        conv(enc + '.conv2', od, 2 * e, 1)
    u = 'update'
    for name in ('c1.0', 'c1.2', 'c2.0', 'c2.2'):
        lin(f'{u}.{name}', dim, dim)
    norm(f'{u}.norm', dim)
    for agg in ('agg_kk', 'agg_ij'):
        for f in ('f', 'g', 'h'):
            lin(f'{u}.{agg}.{f}', dim, dim)
    for ln, gr in (('gru.0', 'gru.1'), ('gru.2', 'gru.3')):
        norm(f'{u}.{ln}', dim)
        for name in ('gate.0', 'res.0', 'res.2'):
            lin(f'{u}.{gr}.{name}', dim, dim)
    lin(f'{u}.corr.0', corr_in, dim)
    lin(f'{u}.corr.2', dim, dim)
    norm(f'{u}.corr.3', dim)
    lin(f'{u}.corr.5', dim, dim)
    lin(f'{u}.d.1', dim, 2)
    lin(f'{u}.w.1', dim, 2)
    return out


def make(net, seed, device, dtype):
    """{name: tensor} of the seeded weights on `device` in `dtype`, views
    of one flat buffer. The values are those of `dtype`: the reference
    asks for torch.bfloat16 and widens them, so both sides hold the same
    numbers."""
    spec = layout(net)
    sizes = [math.prod(s) for _, s, _, _ in spec]
    total = sum(sizes)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    n = torch.tensor(sizes, device=device)
    std = torch.tensor([s for _, _, s, _ in spec], device=device)
    mean = torch.tensor([m for _, _, _, m in spec], device=device)
    flat = (flat * std.repeat_interleave(n, output_size=total)
            + mean.repeat_interleave(n, output_size=total)).to(dtype)
    out, at = {}, 0
    for (name, shape, _, _), k in zip(spec, sizes):
        out[name] = flat[at:at + k].view(shape)
        at += k
    return out
