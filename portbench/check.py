"""What decides `correct`: the program's own state, judged by the plain
reference (portbench/reference), which imports nothing of the program.

Two checks per client:

* boot: the state after the bootstrap frame (frame 7: seven frames that
  only store patches and pairs, then 12 update iterations with bundle
  adjustment), against the reference run from the empty state on the same
  frames, patch draws and weights. Nothing of the program enters it.
* step: one frame of the measured window, drawn from the seed. The
  reference follows the program from its state before that frame: it takes
  the poses, depths and the pair table's hidden state (a recurrence over
  every earlier frame), replays the integer bookkeeping from the program's
  keyframe decisions (books.py) and holds the program's to it, recomputes
  every feature the ring holds from the frames themselves, runs the frame,
  and compares the state after it.

Numbers compared, each a gap measured against the reference:
  patchify: worst relative L2 gap of the new frames' feature maps, patch
            features and context features (extractor and patch gather);
  net:      relative L2 gap of the pair table's hidden state over the
            live pairs (correlation and update operator);
  delta:    relative L2 gap of the flow the update's head added to the
            targets, against the reference's head on the program's own
            hidden state (the head by itself);
  weight:   relative L2 gap of the confidence weights;
  net1, weight1: (boot only) the same two after the bootstrap's first
            update iteration, before any bundle adjustment: the twelve
            iterations after it carry BA's rounding, which each window's
            conditioning amplifies, back into the hidden state;
  ba.system: bundle adjustment by itself, on the inputs of the
            program's last BA call: the largest relative gap of the normal
            equations of its first Gauss-Newton step (ba_stage);
  ba.solve: that step's solve by itself, on the program's own normal
            equations, in units of the gap float32 leaves (solve_stage);
  state:    integer entries that differ: keyframe count, input counter,
            init flag, keyframe timestamps, ring slots, the live pair
            table, removed frames' links (the state machine);
  replay:   the same, of the program's state before the checked frame
            against the bookkeeping replayed from its decisions;
  keyframe: whether the program's keyframe decision disagrees with its
            own mean flow (recomputed from its BA outputs).
The keyframe test is a threshold on a mean flow: where the reference's
flow lies within `keyframe_band` px of it, rounding alone can decide it
either way, and the reference takes the program's decision.
"""
from __future__ import annotations

import math

import torch

from . import traffic as traffic_mod
from . import weights as weights_mod
from .reference import bf16, fp8, plain_numerics
from .reference.books import Books
from .reference.model import Net
from .reference.vo import frame_step, init_state, statics

FLOATS = ('poses', 'depth', 'net', 'target', 'weight')
INTS = ('tstamps', 'fslot', 'pi', 'pj', 'pvalid', 'n', 'counter', 'is_init',
        'delta_src')
FEATS = ('fmap1', 'fmap2', 'gmap', 'imap')
BOOT_FRAME = 7          # the bootstrap frame: the 8th accepted frame
NUMBERS = ('patchify', 'net', 'delta', 'weight', 'pose', 'depth', 'state')


def _snap(st, names):
    return {k: getattr(st, k).clone() for k in names}


def _feats(st, keyframes, M):
    """Feature rows of the ring slots of `keyframes` (device indices)."""
    slot = st.fslot.index_select(0, keyframes)
    pmem = st.fmap1.shape[0]
    return dict(
        fmap1=st.fmap1.index_select(0, slot),
        fmap2=st.fmap2.index_select(0, slot),
        gmap=st.gmap.view((pmem, M) + st.gmap.shape[1:]).index_select(0, slot),
        imap=st.imap.view(pmem, M, -1).index_select(0, slot))


# the program's bundle adjustment as its state machine calls it: the check
# keeps the inputs and outputs of its last call in the checked frame
BA_TARGET = ('dpvo_torch.runtime.device_vo', 'bundle_adjust_pairs')
# the Gauss-Newton solve BA calls per step with its normal equations: the
# check keeps the system of the checked frame's first step
SOLVE_TARGET = ('dpvo_torch.ba_pairs', 'solve_step')
# the update operator: the check keeps the bootstrap's first iteration
UPDATE_TARGET = ('dpvo_torch.models.vonet', 'VONet.update_op')
RESET = 1.0             # the depth BA resets a depth past 20 to


class Recorder:
    """Keeps, without reading anything back, what the check needs of a
    DeviceVO run: the keyframe count after every frame (its 0-d device
    tensors, which the runtime replaces every frame), the state after the
    bootstrap frame, the state before and after frame `step_frame`, and
    the last bundle adjustment of that frame (through `hook`, which the
    client puts around BA_TARGET). Call before(t) and after(t) around the
    runtime's call for frame t."""

    def __init__(self, vo, step_frame):
        self.vo = vo
        self.step_frame = step_frame
        self.ns = []
        self.boot = self.pre = self.post = self.ba = self.system = None
        self.first = None
        self.armed = self.booting = False

    def hook_update(self, fn):
        """fn (UPDATE_TARGET) keeping the hidden state and weights its
        first call in the bootstrap frame returns."""
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.booting and self.first is None:
                self.first = (out[0].clone(), out[2].clone())
            return out
        return wrapped

    def hook(self, fn):
        """fn (BA_TARGET) keeping its last call's inputs and outputs
        while the checked frame runs."""
        def wrapped(*args, **kwargs):
            if self.armed:
                self.system = None
            out = fn(*args, **kwargs)
            if self.armed:
                self.ba = (tuple(a.clone() if isinstance(a, torch.Tensor)
                                 else a for a in args), dict(kwargs),
                           tuple(o.clone() for o in out))
            return out
        return wrapped

    def hook_solve(self, fn):
        """fn (SOLVE_TARGET) keeping the inputs (the normal equations
        among them) and outputs of its first call in each BA call of the
        checked frame."""
        def wrapped(*args, **kwargs):
            keep = self.armed and self.system is None
            if keep:
                self.system = (tuple(a.clone() if isinstance(a, torch.Tensor)
                                     else a for a in args),)
            out = fn(*args, **kwargs)
            if keep:
                self.system += (tuple(o.clone() for o in out),)
            return out
        return wrapped

    def before(self, t):
        self.booting = t == BOOT_FRAME
        if t == self.step_frame:
            self.pre = _snap(self.vo.st, FLOATS[:3] + INTS)
            self.armed = True

    def after(self, t):
        st = self.vo.st
        self.armed = self.booting = False
        self.ns.append(st.n)
        if t in (BOOT_FRAME, self.step_frame):
            snap = _snap(st, FLOATS + INTS)
            kf = torch.arange(BOOT_FRAME + 1, device=st.n.device) \
                if t == BOOT_FRAME else (st.n - 1).reshape(1)
            snap.update(_feats(st, kf, self.vo.M))
            if t == BOOT_FRAME:
                if self.first is not None:
                    GP, M = st.net.shape[:2]
                    snap['net1'] = self.first[0].reshape(GP, M, -1)
                    snap['weight1'] = self.first[1].reshape(GP, M, 2)
                self.boot = snap
            else:
                self.post = snap


def _rel(a, b, scale=None):
    d = torch.linalg.vector_norm((a.double() - b.double()).reshape(-1))
    s = torch.linalg.vector_norm(b.double().reshape(-1)) if scale is None \
        else torch.as_tensor(scale, dtype=torch.float64)
    return float(d / s.clamp(min=1e-30))


def _ints_of(st):
    """The compared integers of a state: {name: 1-d int64 tensor}, on the
    live prefix of each buffer."""
    n, c = int(st['n']), int(st['counter'])
    nv = int(st['pvalid'].sum())
    return dict(n=st['n'].reshape(1).long(),
                counter=st['counter'].reshape(1).long(),
                is_init=st['is_init'].reshape(1).long(),
                tstamps=st['tstamps'][:n], fslot=st['fslot'][:n],
                nvalid=torch.tensor([nv]), pi=st['pi'][:nv],
                pj=st['pj'][:nv], delta_src=st['delta_src'][:c])


def mismatches(a, b):
    """Integer entries of state a that differ from b (a length that
    differs counts as its longer side)."""
    bad = 0
    ia, ib = _ints_of(a), _ints_of(b)
    for k in ia:
        x, y = ia[k].cpu().long(), ib[k].cpu().long()
        m = min(len(x), len(y))
        bad += int((x[:m] != y[:m]).sum()) + abs(len(x) - len(y))
    return bad


def compare(prog, ref, ref_feats, ba_steps):
    """The numbers of one check: prog, a dict of the program's state after
    the frame (FLOATS, INTS, FEATS rows of the frames compared); ref, the
    reference's state (a namespace); ref_feats {name: tensor} stacked like
    prog's feature rows; ba_steps (pose, depth) norms of the reference's
    BA moves."""
    r = {k: getattr(ref, k) for k in FLOATS + INTS}
    out = dict(state=float(mismatches(prog, r)))
    out['patchify'] = max(_rel(prog[k].float(), ref_feats[k]) for k in FEATS)
    n, nv = int(ref.n), int(ref.pvalid.sum())
    first = ('net1', 'weight1') if 'net1' in prog else ()
    if out['state'] or int(prog['n']) != n:
        for k in ('net', 'delta', 'weight', 'pose', 'depth') + first:
            out[k] = 1e30        # cannot be compared: the state differs
        return out
    M = ref.net.shape[1]
    for k in first:
        out[k] = _rel(prog[k][:nv].float(), getattr(ref, k)[:nv])
    out['net'] = _rel(prog['net'][:nv].float(), ref.net[:nv])
    out['delta'] = _rel(prog['target'][:nv], ref.target[:nv],
                        scale=torch.linalg.vector_norm(
                            (ref.target[:nv] - ref.center[:nv]).double()))
    out['weight'] = _rel(prog['weight'][:nv], ref.weight[:nv])
    out['pose'] = _rel(prog['poses'][:n], ref.poses[:n], scale=ba_steps[0])
    out['depth'] = _rel(prog['depth'][:n * M], ref.depth[:n * M],
                        scale=ba_steps[1])
    return out


class Judge:
    """The reference side of one client's checks: its weights (from the
    run's seed), its frames and patch draws (from the client's seeds), at
    the configuration's sizes. `control` computes the reference in the
    control's precision instead (float8 e4m3 with one scale per tensor)
    and stands in for the program."""

    def __init__(self, config, seq, weight_seed, vo_seed, device):
        self.cfg = config
        self.seq = seq
        self.dev = torch.device(device)
        self.s = statics(config['dpvo'])
        net = config['network']
        self.D, self.C, self.P = net['dim'], net['fdim'], net['patch']
        self.H, self.W = config['height'], config['width']
        # the served values (bfloat16 under MIXED_PRECISION), widened
        served = torch.bfloat16 if config['dpvo']['MIXED_PRECISION'] else \
            torch.float32
        w = weights_mod.make(net, weight_seed, self.dev, served)
        self.w = {k: v.float() for k, v in w.items()}
        self.vo_seed = vo_seed
        self.draws = None

    def net(self, control=False):
        return Net(self.w, self.P, q=fp8, store=fp8) if control else \
            Net(self.w, self.P)

    def _draws(self, count):
        if self.draws is None or len(self.draws[0]) < count:
            c, d = traffic_mod.patch_draws(self.vo_seed, self.s['M'],
                                           self.H // 4, self.W // 4, count)
            self.draws = (torch.as_tensor(c, device=self.dev),
                          torch.as_tensor(d, dtype=torch.float32,
                                          device=self.dev))
        return self.draws

    def _aux(self, t):
        c, d = self._draws(t + 1)
        M = self.s['M']
        return torch.cat([c[t], d[t][:, None],
                          torch.full((M, 1), float(t), device=self.dev)], 1)

    def _image(self, t):
        return torch.as_tensor(self.seq.frame(t), device=self.dev)

    def _empty(self):
        return init_state(self.s, self.H, self.W, self.seq.intrinsics, self.D,
                          self.C, self.P, self.dev)

    def boot(self, control=False):
        """(state, features of frames 0..7 stacked, BA step norms) of the
        reference run from the empty state through the bootstrap frame."""
        with plain_numerics():
            net = self.net(control)
            st = self._empty()
            feats = []
            for t in range(BOOT_FRAME + 1):
                feats.append(frame_step(net, st, self._image(t), self._aux(t),
                                        self.s))
            return st, {k: torch.stack([f[k] for f in feats])
                        for k in FEATS}, (st.ba_pose_step, st.ba_depth_step)

    def step(self, pre, ns, t, control=False, follow=None):
        """(state, new features stacked, BA step norms, integer mismatches
        of the program's state before the frame against the replay) of
        frame t run by the reference from the program's state `pre`
        before it, with the keyframe counts `ns` after frames 0..t-1.
        follow = (decision, band): where the reference's keyframe flow
        lies within `band` px of the threshold, it takes the program's
        decision (state.followed says whether it did)."""
        s = self.s
        decide = None
        if follow is not None:
            def decide(m):
                st.followed = abs(m - s['kf_thresh']) < follow[1]
                return follow[0] if st.followed else m < s['kf_thresh']
        books = Books(s)
        for i in range(t):
            removed = books.is_init and ns[i] == books.n
            books.step(removed)
        with plain_numerics():
            net = self.net(control)
            st = self._empty()
            n, M = books.n, s['M']
            dev = self.dev
            st.n = torch.tensor(n, device=dev)
            st.counter = torch.tensor(books.counter, device=dev)
            st.is_init = torch.tensor(books.is_init, device=dev)
            st.tstamps[:n] = torch.tensor(books.tstamps, device=dev)
            st.fslot[:n] = torch.tensor(books.fslot, device=dev)
            nv = len(books.pairs)
            if nv:
                pij = torch.tensor(books.pairs, device=dev)
                st.pi[:nv], st.pj[:nv] = pij[:, 0], pij[:, 1]
            st.pvalid[:nv] = True
            for a, b in books.delta_src.items():
                st.delta_src[a] = b
            st.in_times[:books.counter] = torch.arange(
                books.counter, dtype=torch.float32, device=dev)
            coords, _ = self._draws(t + 1)
            st.centers[:n] = coords[st.tstamps[:n]].reshape(n, 2 * M)
            replay = {k: getattr(st, k) for k in INTS}
            bad = mismatches(pre, replay)
            st.poses = pre['poses'].float().clone()
            st.depth = pre['depth'].float().clone()
            st.net[:nv] = pre['net'][:nv].float()
            pmem = s['pmem']
            for slot, frame in books.slot_frame.items():
                f = net.patchify(self._image(frame).float() * (2.0 / 255.0)
                                 - 0.5, coords[frame])
                st.fmap1[slot], st.fmap2[slot] = f['fmap1'], f['fmap2']
                st.gmap.view((pmem, M) + st.gmap.shape[1:])[slot] = f['gmap']
                st.imap.view(pmem, M, -1)[slot] = f['imap']
            st.followed = False
            f = frame_step(net, st, self._image(t), self._aux(t), s, decide)
            feats = {k: f[k][None] for k in FEATS}
            return st, feats, (st.ba_pose_step, st.ba_depth_step), bad

    @staticmethod
    def as_prog(st, feats, first=False):
        """A reference state in the form of the program's snapshot (the
        control standing in for the program); first: with the bootstrap's
        first iteration."""
        out = {k: getattr(st, k) for k in FLOATS + INTS}
        out.update(feats)
        if first:
            out.update(net1=st.net1, weight1=st.weight1)
        return out


def solve_stage(sargs, sout, control=False):
    """The program's Gauss-Newton solve by itself: the reference's solve
    (Schur complement, Cholesky, retraction, depth clamps) of the program's
    own normal equations against the program's poses and depths, in units
    of the gap float32 itself leaves there (the reference's float32 solve
    against its float64 one, floored at 1e-6 of the move): how far any
    solve moves from another under rounding depends on the window's
    conditioning, which this measures. With control, the reference's solve
    of the system rounded to bfloat16 stands in for the program's."""
    from .reference.ba import solve_step
    with plain_numerics():
        ref = solve_step(*sargs)
        wide = solve_step(*(a.double() if isinstance(a, torch.Tensor) and
                            a.is_floating_point() else a for a in sargs))
        if control:
            sout = solve_step(*sargs[:2], *(bf16(a) for a in sargs[2:7]),
                              *sargs[7:])
    worst = 0.0
    for got, r, w, a in zip(sout, ref, wide, sargs[:2]):
        move = torch.linalg.vector_norm((r - a).double().reshape(-1))
        f32 = torch.linalg.vector_norm((r.double() - w).reshape(-1))
        gap = torch.linalg.vector_norm((got - r).double().reshape(-1))
        worst = max(worst, float(gap / (f32 + 1e-6 * move).clamp(min=1e-30)))
    return worst


def ba_stage(ba_call, system, control=False):
    """The program's bundle adjustment by itself, on the inputs of its last
    call in the checked frame. Compared: the largest relative gap of the
    normal equations of that call's first Gauss-Newton step (B, Em, C, v,
    u: the linearization and its sums, most of BA's arithmetic), against
    the reference's on the same inputs. Readings beside it, not compared:
    where the live edges' patch centers reproject under the call's outputs
    against the reference BA's (over how far the reference moved them),
    the pose and depth gaps (over how far it moved those), the patches
    whose depth BA reset in one output only (left out of those gaps), and
    the same four of the reference against its own float64 run. The solve
    amplifies rounding by the window's conditioning, which varies from
    window to window many times over, so its outputs do not separate
    float32 from the control; the system does. With control, the
    reference's BA with its linearization (residuals, weights, Jacobians)
    rounded to bfloat16 stands in for the program's: the step below the
    float32 the configuration computes BA in (its matmuls, where TF32
    would enter, are a small part of it)."""
    from .reference.ba import bundle_adjust_pairs, normal_equations, \
        solve_step
    from .reference.vo import _reproject
    args, kwargs, out = ba_call
    (sargs, sout) = system if system is not None else (None, None)
    poses, centers, depth, intr, target, weight = args[:6]
    pi, pj, pvalid, t0, _, fbase = args[7:13]
    M, W, PCF = kwargs['M'], kwargs['W'], kwargs['PCF']
    with plain_numerics():
        first = (poses, centers, depth, intr, target, weight, pi, pj, pvalid,
                 t0, fbase)
        ref_sys = normal_equations(*first, M=M, W=W, PCF=PCF)[:5]
        ref = bundle_adjust_pairs(*args, **kwargs)
        if control:
            got_sys = normal_equations(*first, M=M, W=W, PCF=PCF, q=bf16)[:5]
            out = bundle_adjust_pairs(*args, q=bf16, **kwargs)
        else:
            got_sys = sargs[2:7] if sargs is not None else None
        sys_gap = max(_rel(a, b) for a, b in zip(got_sys, ref_sys)) \
            if got_sys is not None else 1e30
        solve_gap = solve_stage(sargs, sout, control) if sargs is not None \
            else 1e30
        # what float32 itself leaves: the reference's gap to its float64 run
        wide = tuple(a.double() if isinstance(a, torch.Tensor) and
                     a.is_floating_point() else a for a in args)
        f64 = tuple(t.float() for t in bundle_adjust_pairs(*wide, **kwargs))

        def centers_of(p, d):
            """Where the live edges' patch centers land in their target
            frames under poses p and depths d."""
            return _reproject(p, centers, d, intr, pi, pj, M, 3)[
                :, :, 1, 1][pvalid]

        c_in, c_ref = centers_of(poses, depth), centers_of(*ref)

    def gaps(got):
        # BA resets a depth that its step takes past 20 to 1 (ba_cuda.cu:
        # 209-229): a jump, which a rounding difference at the threshold
        # takes in one run and not the other. Patches reset in one output
        # only are left out of the gaps and counted.
        flip = (got[1] == RESET) != (ref[1] == RESET)
        keep = ~flip.view(-1, M)[pi.clamp(min=0)][pvalid]
        moved = torch.linalg.vector_norm((c_ref - c_in)[keep].double())
        return (_rel(centers_of(*got)[keep], c_ref[keep], scale=moved),
                _rel(got[0], ref[0], scale=torch.linalg.vector_norm(
                    (ref[0] - poses).double().reshape(-1))),
                _rel(got[1][~flip], ref[1][~flip], scale=torch.linalg.
                     vector_norm((ref[1] - depth)[~flip].double())),
                float(flip.sum()))
    return (sys_gap, solve_gap) + gaps(out) + gaps(f64)


def keyframe_flow(ba_call, n_before, s):
    """The keyframe test's mean flow as the program saw it: the
    reference's formula on the poses and depths its last BA of the frame
    returned (what its test reads)."""
    from .reference.vo import center_flow
    args, _, (poses, depth) = ba_call
    centers, intr = args[1], args[3]
    n1 = torch.tensor(n_before + 1, device=poses.device)
    i, j, M = n1 - s['kf_index'] - 1, n1 - s['kf_index'] + 1, s['M']
    with plain_numerics():
        return float(0.5 * (center_flow(poses, centers, depth, intr, i, j, M)
                            + center_flow(poses, centers, depth, intr, j, i,
                                          M)))


def head_gap(j, prog, st):
    """The update operator's flow head by itself: the program's targets
    less the reference's reprojected centers (the flow it added), against
    the reference's head (ReLU, then update.d.1) on the program's own
    hidden state of the live pairs. The flow's gap over the whole step
    scales with each seed's weights; one layer's does not."""
    nv = int(st.pvalid.sum())
    with plain_numerics():
        want = torch.nn.functional.linear(
            torch.relu(prog['net'][:nv].float()), j.w['update.d.1.weight'],
            j.w['update.d.1.bias'])
    return _rel(prog['target'][:nv] - st.center[:nv], want)


def judge(j, rec, control=False, band=0.0):
    """{'boot.<number>', 'step.<number>', 'ba.<number>': value} of one
    client (the module docstring lists the numbers; the rest are
    readings): the program's snapshots in `rec` against the reference `j`;
    with control, the control's state stands in for the program's. band:
    the limits' keyframe_band."""
    out = {}
    ns = [int(v) for v in torch.stack(rec.ns).cpu()]
    st, feats, steps = j.boot()
    prog = Judge.as_prog(*j.boot(control=True)[:2], first=True) if control \
        else rec.boot
    out.update({f'boot.{k}': v for k, v in compare(prog, st, feats,
                                                   steps).items()})
    t = rec.step_frame
    if rec.post is None:            # the window ended before that frame
        out.update({f'step.{k}': 1e30 for k in NUMBERS + ('replay',)})
        out.update({'ba.system': 1e30, 'ba.solve': 1e30, 'ba.reproj': 1e30})
        return out
    n_before = int(rec.pre['n'])
    if control:
        cst, cfeats, _, _ = j.step(rec.pre, ns, t, control=True)
        prog = Judge.as_prog(cst, cfeats)
        flow, removed = cst.mflow, int(cst.n) == n_before
    else:
        prog = rec.post
        flow = keyframe_flow(rec.ba, n_before, j.s) if rec.ba else math.nan
        removed = ns[t] == n_before
    st, feats, steps, bad = j.step(rec.pre, ns, t, follow=(removed, band))
    out.update({f'step.{k}': v for k, v in compare(prog, st, feats,
                                                   steps).items()})
    out['step.delta_full'] = out['step.delta']
    out['step.delta'] = head_gap(j, prog, st) if out['step.state'] == 0 \
        else 1e30
    out['step.replay'] = float(bad)
    # the program's decision against its own flow (exact), and how far its
    # flow lies from the reference's (a reading)
    out['step.keyframe'] = float(removed != (flow < j.s['kf_thresh']))
    out['step.mflow_gap'] = abs(flow - st.mflow)
    out['step.followed'] = float(st.followed)
    (out['ba.system'], out['ba.solve'], out['ba.reproj'], out['ba.pose'],
     out['ba.depth'], out['ba.resets'], out['ba.f32_reproj'],
     out['ba.f32_pose'], out['ba.f32_depth'], out['ba.f32_resets']) = \
        ba_stage(rec.ba, rec.system, control) if rec.ba else (1e30,) * 10
    out['step.mflow'] = getattr(st, 'mflow', float('nan'))
    return out


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): every number at or under its
    limit (a NaN fails); names without a limit are shown with None."""
    rows, ok = [], True
    for k in sorted(numbers):
        lim = limits.get(k)
        v = numbers[k]
        if lim is not None and not v <= lim:
            ok = False
        rows.append((k, v, lim))
    missing = [k for k in limits if k not in numbers]
    return ok and not missing, rows


def limits_of(config_name, here=None):
    """A configuration's limits/<name>.json: {'numbers': {name: limit},
    'keyframe_band': px}."""
    from .spec import HERE, load_json
    return load_json((here or HERE) / 'limits' / f'{config_name}.json')


__all__ = ['Recorder', 'Judge', 'judge', 'verdict', 'limits_of']
