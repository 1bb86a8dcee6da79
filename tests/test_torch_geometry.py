"""dpvo_torch's Lie-group library (lie.py: the functional ops and the
lietorch-style classes) against dpvo_tpu.lie on the same seeded numpy
inputs.

Tolerances, each with its reason:
- values: both sides run the same f32 formulas with the same branches and
  differ only in the order of a few f32 operations, so O(1) outputs agree
  to a few ulps: atol 2e-6 (1e-5 where randn points or covectors up to ~4
  in size enter, 5e-5 through Sim3's 3x3 inverse);
- reverse-mode Jacobians of exp and log (torch.func.jacrev): against
  jax.jacrev at 1e-4, and against central differences at eps 1e-3 at
  tests/test_lie.py's bounds (2e-3 exp, 5e-3 log: the O(eps^2) truncation
  and f32 rounding of the differences), at scales down to 1e-6. Against
  jax.jacrev the bound is set by Sim3: d/dsigma of expm1(s)/s is f32
  rounding noise for 1e-8 < |s| < 1e-2 in both packages (ROADMAP.md §3,
  "Precision"), and it enters the Jacobian multiplied by tau;
- every reverse-mode gradient must be finite, also at the identity and at
  a rotation by pi, where a torch.where branch that is not selected divides
  by a safe denominator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_torch import lie as tl
from dpvo_tpu import lie as jl

CPU = 'cpu'
SCALES = [1e-6, 1e-3, 0.5]

# name: (tangent dim, embedded dim, exp, log), as (torch, jax) pairs
GROUPS = {
    'so3': (3, 4, (tl.so3_exp, jl.so3_exp), (tl.so3_log, jl.so3_log)),
    'rxso3': (4, 5, (tl.rxso3_exp, jl.rxso3_exp),
              (tl.rxso3_log, jl.rxso3_log)),
    'se3': (6, 7, (tl.se3_exp, jl.se3_exp), (tl.se3_log, jl.se3_log)),
    'sim3': (7, 8, (tl.sim3_exp, jl.sim3_exp), (tl.sim3_log, jl.sim3_log)),
}
CLASSES = {'so3': (tl.SO3, jl.SO3), 'rxso3': (tl.RxSO3, jl.RxSO3),
           'se3': (tl.SE3, jl.SE3), 'sim3': (tl.Sim3, jl.Sim3)}


def _rand(shape, scale, seed):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _elements(name, n, scale, seed):
    """n group elements exp(xi), xi ~ scale * N(0, 1), from dpvo_tpu."""
    dim, _, (_, jexp), _ = GROUPS[name]
    return _jax(jexp, _rand((n, dim), scale, seed))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


_JITTED = {}


def _jax(fn, *args):
    """fn on numpy args (pytrees of arrays) under jax.jit, compiled once per
    fn and shape (eager jnp would compile every primitive). Returns numpy."""
    jitted = _JITTED.setdefault(fn, jax.jit(fn))
    return jax.tree_util.tree_map(np.array, jitted(*args))


def _check(calls, atol):
    """calls: (torch fn, jax fn, numpy args)."""
    for tf, jf, args in calls:
        _close(tf(*map(_t, args)), _jax(jf, *args), atol)


def _close(out, ref, atol=2e-6):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# functional ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('scale', SCALES)
def test_so3_ops(scale):
    q = _elements('so3', 32, scale, 0)
    q2 = _elements('so3', 32, scale, 1)
    v = _rand((32, 3), 1.0, 2)
    _check([(tl.quat_to_matrix, jl.quat_to_matrix, (q,)),
            (tl.so3_inv, jl.so3_inv, (q,)),
            (tl.so3_mul, jl.so3_mul, (q, q2)),
            (tl.so3_act, jl.so3_act, (q, v)),
            (tl.so3_adj, jl.so3_adj, (q, v)),
            (tl.so3_adjT, jl.so3_adjT, (q, v))], atol=1e-5)


@pytest.mark.parametrize('scale', SCALES)
def test_se3_ops(scale):
    G = _elements('se3', 32, scale, 3)
    p = _rand((32, 3), 1.0, 4)
    xi = _rand((32, 6), 1.0, 5)
    _check([(tl.se3_act, jl.se3_act, (G, p)),
            (tl.se3_adj, jl.se3_adj, (G, xi)),
            (tl.se3_matrix, jl.se3_matrix, (G,))], atol=1e-5)


@pytest.mark.parametrize('scale', SCALES)
def test_rxso3_ops(scale):
    R = _elements('rxso3', 32, scale, 6)
    p4 = _rand((32, 4), 1.0, 7)
    xi = _rand((32, 4), 1.0, 8)
    _check([(tl.rxso3_act4, jl.rxso3_act4, (R, p4)),
            (tl.rxso3_adj, jl.rxso3_adj, (R, xi)),
            (tl.rxso3_adjT, jl.rxso3_adjT, (R, xi)),
            (tl.rxso3_matrix, jl.rxso3_matrix, (R,))], atol=1e-5)


@pytest.mark.parametrize('scale', SCALES)
def test_sim3_ops(scale):
    S = _elements('sim3', 32, scale, 9)
    p4 = _rand((32, 4), 1.0, 10)
    xi = _rand((32, 7), scale, 11)
    X = _rand((32, 7), 1.0, 12)
    _check([(tl.sim3_act4, jl.sim3_act4, (S, p4)),
            (tl.sim3_matrix, jl.sim3_matrix, (S,)),
            (tl.sim3_adjT, jl.sim3_adjT, (S, X))], atol=1e-5)
    _check([(tl.sim3_retr, jl.sim3_retr, (S, xi))], atol=5e-5)


def test_identities():
    shapes = [(), (3,), (2, 5)]
    pairs = [(tl.se3_identity, jl.se3_identity),
             (tl.sim3_identity, jl.sim3_identity)]
    refs = _jax(lambda: [jf(shape) for shape in shapes for _, jf in pairs])
    outs = [tf(shape, device=CPU) for shape in shapes for tf, _ in pairs]
    for out, ref in zip(outs, refs):
        assert out.dtype == torch.float32 and out.device.type == 'cpu'
        np.testing.assert_array_equal(out.numpy(), ref)
    assert tl.se3_identity((2,), dtype=torch.float64, device=CPU).dtype == \
        torch.float64


@pytest.mark.parametrize('name', list(GROUPS))
def test_exp_log_match(name):
    """exp and log over the small-angle branches and the general one."""
    dim, _, (texp, jexp), (tlog, jlog) = GROUPS[name]
    for k, scale in enumerate(SCALES):
        xi = _rand((32, dim), scale, 20 + k)
        X = _jax(jexp, xi)
        _close(texp(_t(xi)), X)
        _close(tlog(_t(X)), _jax(jlog, X),
               atol=5e-5 if name == 'sim3' else 1e-5)


# ---------------------------------------------------------------------------
# reverse-mode Jacobians and finite gradients
# ---------------------------------------------------------------------------

def _central(f, x, eps=1e-3):
    """Central-difference Jacobian of f at x (numpy in, numpy out)."""
    cols = []
    for k in range(x.shape[0]):
        d = np.zeros_like(x)
        d[k] = eps
        cols.append((f(x + d) - f(x - d)) / (2 * eps))
    return np.stack(cols, axis=-1)


@pytest.fixture(scope='module')
def jax_jacobians():
    """jax.jacrev of exp and log for every group at each of SCALES, one
    compile per function (vmapped over the scales): name -> (xi, X, J_exp,
    J_log), each stacked over SCALES."""
    out = {}
    for name, (dim, _, (_, jexp), (_, jlog)) in GROUPS.items():
        xi = np.stack([_rand((dim,), scale, 30) for scale in SCALES])
        X = _jax(jexp, xi)
        out[name] = (xi, X, _jax(jax.vmap(jax.jacrev(jexp)), xi),
                     _jax(jax.vmap(jax.jacrev(jlog)), X))
    return out


@pytest.mark.parametrize('scale', SCALES)
@pytest.mark.parametrize('name', list(GROUPS))
def test_reverse_mode_jacobians(jax_jacobians, name, scale):
    _, _, (texp, _), (tlog, _) = GROUPS[name]
    k = SCALES.index(scale)
    xi, X, Jexp, Jlog = (a[k] for a in jax_jacobians[name])
    for tf, x, ref, atol in [(texp, xi, Jexp, 2e-3), (tlog, X, Jlog, 5e-3)]:
        J = torch.func.jacrev(tf)(_t(x)).numpy()
        assert np.isfinite(J).all()
        np.testing.assert_allclose(J, ref, atol=1e-4, rtol=0)
        num = _central(lambda v: tf(_t(v.astype(np.float32))).numpy(), x)
        np.testing.assert_allclose(J, num, atol=atol, rtol=0)


@pytest.mark.parametrize('name', list(GROUPS))
def test_backward_finite_at_identity_and_pi(name):
    """.backward() through exp, log, inv, mul and act at xi = 0, 1e-6 and at
    a rotation by pi (qw = 0, and just below 0)."""
    cls = CLASSES[name][0]
    dim = GROUPS[name][0]
    for xi in [np.zeros((4, dim), np.float32), _rand((4, dim), 1e-6, 31)]:
        x = _t(xi).requires_grad_()
        G = cls.exp(x)
        p = torch.ones(4, 3)
        loss = (G.inv() * G).log().sum() + G.log().sum() + (G * p).sum() + \
            G.matrix().sum()
        loss.backward()
        assert torch.isfinite(x.grad).all(), (name, xi)
    for w in [0.0, -1e-7]:
        v = np.array([0.3, -0.5, 0.2])
        q = np.append(v / np.linalg.norm(v) * np.sqrt(1 - w * w), w)
        data = cls.Identity(device=CPU).data.clone()
        off = 3 if dim >= 6 else 0
        data[off:off + 4] = _t(q.astype(np.float32))
        data[:off] = 0.1
        x = data.requires_grad_()
        cls(x).log().sum().backward()
        assert torch.isfinite(x.grad).all(), (name, w)


# ---------------------------------------------------------------------------
# the class surface
# ---------------------------------------------------------------------------

def _methods(cls, a, b, xi, X, p3, p4, cpu=None):
    """Every method of the class surface on elements a, b (data), by name;
    the same code runs on both packages."""
    dev = {} if cpu is None else dict(device=cpu)
    A, B = cls(a), cls(b)
    out = dict(mul=(A * B).data, inv=A.inv().data, log=A.log(),
               exp=cls.exp(xi).data, retr=A.retr(xi).data, matrix=A.matrix(),
               adj=A.adj(xi), adjT=A.adjT(X), Jinv=A.Jinv(xi), act=A * p3,
               vec=A.vec(), translation=A.translation(), item=A[1:3].data,
               identity=cls.Identity(2, 3, **dev).data,
               like=(A * cls.IdentityLike(A)).data)
    if cls.embedded_dim != 4:
        out['act4'] = A * p4
    return out


@pytest.mark.parametrize('name', list(CLASSES))
def test_random_gives_dpvo_tpus_elements(name):
    tc, jc = CLASSES[name]
    cases = [(0, (4,)), (3, (2, 3))]
    refs = _jax(lambda: [jc.Random(*shape, sigma=0.3, key=key).data
                         for key, shape in cases])
    for (key, shape), ref in zip(cases, refs):
        a = tc.Random(*shape, sigma=0.3, key=key, device=CPU)
        assert type(a) is tc and a.shape == torch.Size(shape)
        _close(a.data, ref)


@pytest.mark.parametrize('name', list(CLASSES))
def test_class_ops_match(name):
    """Every method against dpvo_tpu's on the same elements."""
    tc, jc = CLASSES[name]
    dim, edim = GROUPS[name][:2]
    a, b = _jax(lambda: [jc.Random(5, sigma=0.4, key=k).data for k in (1, 2)])
    args = (a, b, _rand((5, dim), 0.3, 40), _rand((5, dim), 1.0, 41),
            _rand((5, 3), 1.0, 42), _rand((5, 4), 1.0, 43))
    refs = _jax(lambda *x: _methods(jc, *x), *args)
    out = _methods(tc, *map(_t, args), cpu=CPU)
    assert out.keys() == refs.keys()
    for k in out:
        _close(out[k], refs[k], 5e-5 if name == 'sim3' else 1e-5)
    A = tc(_t(a))
    assert A.shape == (5,) and A.detach().data.requires_grad is False
    assert tc.Identity(2, 3, device=CPU).data.shape == (2, 3, edim)
    E = tc.IdentityLike(tc(_t(a).double()))
    assert E.data.dtype == torch.float64 and E.shape == (5,)
    if name == 'so3':
        with pytest.raises(ValueError, match='3-wide'):
            A * _t(args[5])


def test_broadcast_mul_and_stack():
    """(4, 1) x (1, 3) elements broadcast to (4, 3) as jnp.broadcast_arrays
    does; stack and SE3.scale."""
    def run(mod, **dev):
        A = mod.SE3.Random(4, 1, sigma=0.3, key=5, **dev)
        B = mod.SE3.Random(1, 3, sigma=0.3, key=6, **dev)
        return dict(mul=(A * B).data, scale=A.scale(2.5).data,
                    stack=mod.stack([A, A.inv()], dim=1).data)

    out, refs = run(tl, device=CPU), _jax(lambda: run(jl))
    assert out['mul'].shape == (4, 3, 7)
    assert out['stack'].shape == (4, 2, 1, 7)
    for k in out:
        _close(out[k], refs[k], 1e-5)
    assert type(tl.stack([tl.SE3.Identity(2, device=CPU)] * 3)) is tl.SE3


def test_api_parity_identities():
    """tests/test_api_parity.py's class identities on the port."""
    G = tl.SE3.Random(4, sigma=0.3, key=0, device=CPU)
    assert G.vec().shape == (4, 7) and G.translation().shape == (4, 4)
    assert G.matrix().shape == (4, 4, 4)
    xi = _t(np.random.RandomState(0).randn(4, 6).astype(np.float32))
    lhs = tl.SE3.exp(G.adj(xi))
    rhs = G * tl.SE3.exp(xi) * G.inv()
    _close(tl.se3_log(lhs.data), tl.se3_log(rhs.data).numpy(), 1e-4)
    tau = xi * 0.001
    X2 = tl.SE3.exp(G.log() + tau)
    X2b = tl.SE3.exp(G.Jinv(tau)) * G
    _close(X2.data, X2b.data.numpy(), 1e-5)
    S = tl.stack([G, G.inv()], dim=0)
    assert S.data.shape == (2, 4, 7)
    _close((G * tl.SE3.IdentityLike(G)).data, G.data.numpy(), 1e-6)
    R = tl.RxSO3.Random(3, sigma=0.2, key=1, device=CPU)
    _close(tl.rxso3_log((R * R.inv()).data), np.zeros((3, 4)), 1e-5)
    # Sim3's adj has no closed form: torch.func.jvp of the conjugation
    T = tl.Sim3.Random(3, sigma=0.3, key=2, device=CPU)
    v = _t(_rand((3, 7), 0.3, 3))
    _close(tl.sim3_log((tl.Sim3.exp(T.adj(v))).data),
           tl.sim3_log((T * tl.Sim3.exp(v) * T.inv()).data).numpy(), 1e-4)
