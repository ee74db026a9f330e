"""The port's ``solve_qp_implicit`` (a ``torch.autograd.Function``) against
the JAX package's ``custom_vjp``, on the CPU.

Problems are ``tests/test_diff.py``'s (M=4, N=10 random QPs from a NumPy
seed) under its config.  Bars: the forward U within 1e-4 * max(1, |U|max)
of JAX's and feasible to 1e-4; each gradient (Qp, Fp, Gp, Kp) within
1e-4 * max(1, |g|max) of ``jax.grad``'s, and within
1e-3 * max(1, |fd|) of central finite differences in float64 of the exact
solution map on the solve's active set (the float32 forward is certified to
the config's 1e-5 gap, the backward is one float32 KKT solve);
``torch.func.vmap`` equal to one instance at a time to 1e-5 in U and 1e-4
in gradients, with ONE batched solve; the degenerate vertex (box and slew
bounds active at once, a singular KKT matrix) gives finite gradients,
JAX's on everything the vertex determines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pqp_for_mpc_tpu as jpqp
from pqp_for_mpc_tpu.diff import solve_qp_implicit as j_solve_qp_implicit
import pqp_for_mpc_tpu_torch as tpqp
from pqp_for_mpc_tpu_torch import diff
from pqp_for_mpc_tpu_torch.diff import solve_qp_implicit

KW = dict(max_iters=100_000, check_every=4, accel_every=4, y0=0.1,
          strict_weak_duality=False, eaj=1e-5, erj=1e-6)
JCFG, CFG = jpqp.SolverConfig(**KW), tpqp.SolverConfig(**KW)
NAMES = ("Qp", "Fp", "Gp", "Kp")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _problem(seed=0, M=4, N=10):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((M, M)).astype(np.float32)
    Qp = L @ L.T + M * np.eye(M, dtype=np.float32)
    Gp = rng.integers(-1, 2, (N, M)).astype(np.float32)
    Kp = rng.uniform(0.5, 2.0, N).astype(np.float32)
    Fp = (rng.standard_normal(M) * 5).astype(np.float32)
    return Qp, Fp, Gp, Kp


def _vertex_problem():
    """The condensed double integrator at H=6 with R = 0.05, |u| <= 1 and
    |du| <= 1 from x0 = [1.5, 0]: u_0 = -1 makes the box row and the slew
    row of stage 0 active together (linearly dependent active rows)."""
    from pqp_for_mpc_tpu_torch.models import MPCSpec, condense, plants
    spec = MPCSpec(plants.double_integrator(), horizon=6, Qy=np.eye(1),
                   R=0.05 * np.eye(1), r=np.zeros(1), u_min=-np.ones(1),
                   u_max=np.ones(1), du_max=np.ones(1))
    data = condense(spec, device="cpu")
    primal = data.assemble(x=torch.tensor([1.5, 0.0]), Qp=data.qp())
    return tuple(t.numpy().copy() for t in (primal.Qp, primal.Fp, primal.Gp,
                                            primal.Kp))


def _grads(args, w):
    """(port gradients, JAX gradients) of w'U* w.r.t. the four inputs."""
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    (torch.from_numpy(w) @ solve_qp_implicit(*ts, CFG)).backward()
    jg = jax.grad(lambda *a: jnp.dot(jnp.asarray(w),
                                     j_solve_qp_implicit(*a, JCFG)),
                  argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    return [t.grad.numpy() for t in ts], [np.asarray(g) for g in jg]


@pytest.mark.parametrize("seed", [0, 2, 4])
def test_forward_matches_jax(seed):
    Qp, Fp, Gp, Kp = _problem(seed)
    U = solve_qp_implicit(*map(torch.from_numpy, (Qp, Fp, Gp, Kp)), CFG)
    want = np.asarray(j_solve_qp_implicit(*map(jnp.asarray,
                                               (Qp, Fp, Gp, Kp)), JCFG))
    assert U.shape == (4,) and U.dtype == torch.float32
    np.testing.assert_allclose(U.numpy(), want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))
    assert (Gp @ U.numpy() <= Kp + 1e-4).all()


@pytest.mark.parametrize("seed", [0, 2, 4])
def test_gradients_match_jax(seed):
    args = _problem(seed)
    w = np.random.default_rng(1).standard_normal(4).astype(np.float32)
    got, want = _grads(args, w)
    for name, g, gw in zip(NAMES, got, want):
        assert g.shape == gw.shape, name
        np.testing.assert_allclose(g, gw, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(gw).max()),
                                   err_msg=name)


def _exact_u(Qp, Fp, Gp, Kp, active):
    """U* of the equality-constrained QP on the active rows, float64."""
    GA = Gp[active]
    M, nA = Qp.shape[0], GA.shape[0]
    K = np.block([[Qp, GA.T], [GA, np.zeros((nA, nA))]])
    return np.linalg.solve(K, np.concatenate([-Fp, Kp[active]]))[:M]


@pytest.mark.parametrize("wrt", NAMES)
def test_gradients_match_float64_finite_differences(wrt):
    """Central differences (eps 1e-6) of w'U* in float64 on the solve's
    active set, at four random coordinates; Qp moves symmetrically."""
    args = [a.astype(np.float64) for a in _problem(seed=2)]
    w = np.random.default_rng(1).standard_normal(4)
    ts = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
          for a in args]
    U, Y = diff._ImplicitQP.apply(*ts, CFG, 1e-6)
    (torch.from_numpy(w).float() @ U).backward()
    active = Y.detach().numpy() > 1e-6
    assert active.any()
    i = NAMES.index(wrt)
    g = ts[i].grad.numpy()
    rng = np.random.default_rng(3)
    eps = 1e-6
    for _ in range(4):
        idx = tuple(int(rng.integers(0, s)) for s in args[i].shape)
        hi = [a.copy() for a in args]
        lo = [a.copy() for a in args]
        hi[i][idx] += eps
        lo[i][idx] -= eps
        an = float(g[idx])
        if wrt == "Qp" and idx[0] != idx[1]:
            hi[i][idx[::-1]] += eps
            lo[i][idx[::-1]] -= eps
            an += float(g[idx[::-1]])
        fd = (w @ _exact_u(*hi, active) - w @ _exact_u(*lo, active)) / (
            2 * eps)
        assert abs(fd - an) <= 1e-3 * max(1.0, abs(fd)), (wrt, idx, fd, an)


def test_vmap_matches_one_at_a_time_with_one_solve(monkeypatch):
    """torch.func.vmap over Fp: one batched solve (not a loop over
    instances), the per-instance U and gradients of one-at-a-time calls;
    the batched gradient also through plain autograd."""
    Qp, Fp, Gp, Kp = map(torch.from_numpy, _problem(seed=4))
    Fps = torch.from_numpy((np.random.default_rng(5).standard_normal(
        (3, 4)) * 5).astype(np.float32))
    f = lambda fp: solve_qp_implicit(Qp, fp, Gp, Kp, CFG)
    calls = []
    solve = diff.solve_batched
    monkeypatch.setattr(diff, "solve_batched",
                        lambda *a, **k: calls.append(1) or solve(*a, **k))
    U = torch.func.vmap(f)(Fps)
    assert U.shape == (3, 4) and len(calls) == 1
    for b in range(3):
        np.testing.assert_allclose(U[b].numpy(), f(Fps[b]).numpy(),
                                   rtol=1e-5, atol=1e-5)
    g = torch.func.grad(lambda fps: (torch.func.vmap(f)(fps) ** 2).sum())(
        Fps)
    assert g.shape == Fps.shape and torch.isfinite(g).all()
    for b in range(3):
        gb = torch.func.grad(lambda fp: (f(fp) ** 2).sum())(Fps[b])
        np.testing.assert_allclose(g[b].numpy(), gb.numpy(), rtol=1e-4,
                                   atol=1e-4)
    Fv = Fps.clone().requires_grad_()
    (torch.func.vmap(f)(Fv) ** 2).sum().backward()
    np.testing.assert_allclose(Fv.grad.numpy(), g.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_vmap_over_every_input_matches_jax():
    """vmap over all four inputs (one geometry per lane: the distinct
    solve) against jax.vmap of the JAX function, forward and gradient of
    the summed squares w.r.t. each batched input."""
    probs = [_problem(seed) for seed in (0, 2, 4)]
    batched = [np.stack([p[i] for p in probs]) for i in range(4)]
    loss_t = lambda *a: (torch.func.vmap(
        lambda q, f, g, k: solve_qp_implicit(q, f, g, k, CFG))(*a)
        ** 2).sum()
    loss_j = lambda *a: (jax.vmap(
        lambda q, f, g, k: j_solve_qp_implicit(q, f, g, k, JCFG))(*a)
        ** 2).sum()
    got = torch.func.grad(loss_t, argnums=(0, 1, 2, 3))(
        *map(torch.from_numpy, batched))
    want = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*map(jnp.asarray,
                                                       batched))
    for name, g, gw in zip(NAMES, got, want):
        gw = np.asarray(gw)
        np.testing.assert_allclose(g.numpy(), gw, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(gw).max()),
                                   err_msg=name)


def test_degenerate_vertex_gives_finite_gradients_like_jax():
    """At the vertex the box row -u_0 <= 1 (row H) and the slew row
    -(u_0 - u_prev) <= 1 (row 3H) are the same row: the 1e-6 ridge keeps
    the KKT solve finite, and the split of the two rows' multiplier
    gradients along the null direction is float32 noise amplified by
    1/ridge (the packages differ there by ~0.03, and each rounds it its own
    way).  Held to JAX: Qp and Fp, every other row of Gp and Kp, and the
    pair's sums."""
    args = _vertex_problem()
    Qp, Fp, Gp, Kp = map(torch.from_numpy, args)
    U, Y = diff._ImplicitQP.apply(Qp, Fp, Gp, Kp, CFG, 1e-6)
    H = 6
    assert abs(float(U[0]) + 1.0) <= 1e-3
    assert Y[H] > 1e-6 and Y[3 * H] > 1e-6
    np.testing.assert_array_equal(args[2][H], args[2][3 * H])
    got, want = _grads(args, np.ones(H, np.float32))
    others = np.ones(args[3].shape[0], bool)
    others[[H, 3 * H]] = False
    for name, g, gw in zip(NAMES, got, want):
        assert np.isfinite(g).all(), name
        tol = 1e-4 * max(1.0, np.abs(gw).max())
        if name in ("Gp", "Kp"):
            np.testing.assert_allclose(g[H] + g[3 * H], gw[H] + gw[3 * H],
                                       rtol=0, atol=tol, err_msg=name)
            g, gw = g[others], gw[others]
        np.testing.assert_allclose(g, gw, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("log_r", [0.0, -1.0])
def test_tuning_gradient_matches_jax(log_r):
    """examples/differentiable_mpc.py's first-input gradient w.r.t. the
    log input weight (Qp = Qp0 + 2 (e^log_r - 1) I) through assemble."""
    from pqp_for_mpc_tpu.models import MPCSpec as JSpec
    from pqp_for_mpc_tpu.models import condense as jcondense
    from pqp_for_mpc_tpu.models import plants as jplants
    from pqp_for_mpc_tpu_torch.models import MPCSpec, condense, plants
    H = 8
    kw = dict(horizon=H, Qy=np.eye(1), R=np.eye(1), r=np.zeros(1),
              u_min=-np.ones(1), u_max=np.ones(1), du_max=np.ones(1))
    data = condense(MPCSpec(plants.double_integrator(), **kw), device="cpu")
    jdata = jcondense(JSpec(jplants.double_integrator(), **kw))

    def first_input_t(lr):
        Qp = data.qp() + 2.0 * (torch.exp(lr) - 1.0) * torch.eye(H)
        p = data.assemble(x=torch.tensor([1.5, 0.0]), D=torch.zeros(H),
                          Qp=Qp)
        return solve_qp_implicit(Qp, p.Fp, p.Gp, p.Kp, CFG)[0]

    def first_input_j(lr):
        Qp = jnp.linalg.inv(jdata.Qp_inv) + 2.0 * (jnp.exp(lr) - 1.0) \
            * jnp.eye(H, dtype=jnp.float32)
        p = jdata.assemble(x=jnp.asarray([1.5, 0.0], jnp.float32),
                           D=jnp.zeros(H, jnp.float32), Qp=Qp)
        return j_solve_qp_implicit(Qp, p.Fp, p.Gp, p.Kp, JCFG)[0]

    lr = torch.tensor(log_r, requires_grad=True)
    first_input_t(lr).backward()
    want = float(jax.grad(first_input_j)(jnp.asarray(log_r, jnp.float32)))
    assert abs(float(lr.grad) - want) <= 1e-3 * max(1.0, abs(want))
