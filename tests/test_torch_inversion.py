"""The port's inversion (``das_diff_veh_tpu_torch/inversion``: the forward
model, the misfit, the swarm and Adam steps, the search, the sensitivity
kernels) against the JAX package on the CPU at float64.

Bars:
- ``phase_velocity`` for modes 0-4 at 1e-10 with the NaN pattern equal;
  the gradient of its sum in the model fields (autograd against
  ``jax.grad``) at 1e-8; ``phase_sensitivity`` and ``scan_mode_diagnostics``
  at 1e-9 (counts and flags equal); the misfits at 1e-10; three PSO steps
  fed JAX's own draws at 1e-12 with the same best members.
- The secular function is a determinant that cancels: the JAX package's own
  value moves by up to ~1e-5 of its peak when ``c`` moves by one or two
  ulps (6-layer models; 1e-14 on benign ones).  It is held at 1e-12
  peak-relative or at twice that spread of the JAX value, whichever is
  larger.  Five Adam steps inherit the same noise through the gradient
  (Adam divides it by its own square root); they are held at 1e-9 or at
  twice the spread of JAX's refinement from starts moved by one ulp.
- The search itself draws from another random stream than JAX, so whole
  runs are held to the JAX tests' quality bars instead of to JAX's
  trajectory.
"""

import importlib
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das_diff_veh_tpu.inversion import Curve as JCurve
from das_diff_veh_tpu.inversion import forward as JF
from das_diff_veh_tpu.inversion import sensitivity as JS
from das_diff_veh_tpu_torch.convert import layered_model_from_numpy, model_spec_from_bounds
from das_diff_veh_tpu_torch.inversion import Curve as PCurve
from das_diff_veh_tpu_torch.inversion import fleet as PFL
from das_diff_veh_tpu_torch.inversion import forward as PF
from das_diff_veh_tpu_torch.inversion import sensitivity as PS

JI = importlib.import_module("das_diff_veh_tpu.inversion.invert")
PI = importlib.import_module("das_diff_veh_tpu_torch.inversion.invert")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
ULP = float(np.finfo(np.float64).eps)


@pytest.fixture(autouse=True)
def one_thread():
    """The suite runs in several worker processes on a few cores: PyTorch's
    CPU pool of one thread a core in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _models(d, vs, nu=0.4375):
    """(jax, port) models with the reference's Poisson and density laws."""
    vs = jnp.asarray(vs, dtype=jnp.float64)
    vp = JF.vp_from_poisson(vs, nu)
    jm = JF.LayeredModel(jnp.asarray(d, dtype=jnp.float64), vp, vs,
                         JF.density_gardner_linear(vp))
    return jm, layered_model_from_numpy(*(np.asarray(a) for a in jm), device=CPU)


def _three_layer_problem():
    """The JAX tests' recovery problem: truth, curves (both packages) and
    the search space (both packages)."""
    jm, _ = _models([0.006, 0.02, 0.0], [0.20, 0.40, 0.70])
    T0, T1 = np.linspace(0.05, 0.4, 12), np.linspace(0.04, 0.1, 6)
    c0 = np.asarray(JF.phase_velocity(jnp.asarray(T0), jm, mode=0))
    c1 = np.asarray(JF.phase_velocity(jnp.asarray(T1), jm, mode=1))
    rows = [(T0, c0, 0, 1.0, 0.01 * np.ones(12)), (T1, c1, 1, 1.0, 0.01 * np.ones(6))]
    bounds = ([(0.002, 0.012), (0.01, 0.04), (0.02, 0.08)],
              [(0.1, 0.3), (0.25, 0.55), (0.5, 1.0)])
    jspec = JI.ModelSpec(layers=tuple(JI.LayerBounds(d, v) for d, v in zip(*bounds)))
    return ([0.20, 0.40, 0.70], [JCurve(*r) for r in rows], [PCurve(*r) for r in rows],
            jspec, model_spec_from_bounds(*bounds))


# -- the layer system ----------------------------------------------------------

def test_coefficient_matrix_eigenvalues():
    vp_, vs_, rho_, c, k = 1.5, 0.5, 1.8, 0.4, 5.0
    A = PF._layer_A(torch.tensor(k, dtype=torch.float64), k * c, vp_, vs_, rho_).numpy()
    got = np.sort(np.linalg.eigvals(A).real)
    nup, nus = k * np.sqrt(1 - (c / vp_) ** 2), k * np.sqrt(1 - (c / vs_) ** 2)
    np.testing.assert_allclose(got, np.sort([-nus, -nup, nup, nus]), rtol=1e-12)


def test_propagator_matches_jax_and_is_expm():
    from scipy.linalg import expm
    rng = np.random.default_rng(1)
    for _ in range(20):
        vs_ = rng.uniform(0.2, 1.0)
        vp_, rho_ = 3.0 * vs_, rng.uniform(1.6, 2.1)
        c, k, d = rng.uniform(0.1, 1.2), rng.uniform(1.0, 800.0), rng.uniform(0.001, 0.08)
        kt = torch.tensor(k, dtype=torch.float64)
        M = PF._layer_propagator(kt, k * c, d, vp_, vs_, rho_).numpy()
        Mj = np.asarray(JF._layer_propagator(jnp.float64(k), jnp.float64(k * c), d, vp_, vs_,
                                             rho_))
        np.testing.assert_allclose(M, Mj, rtol=0, atol=1e-12 * np.abs(Mj).max())
        M_ref = expm(PF._layer_A(kt, k * c, vp_, vs_, rho_).numpy() * d)
        M_ref, Mn = M_ref / np.abs(M_ref).max(), M / np.abs(M).max()
        i = np.unravel_index(np.abs(M_ref).argmax(), M_ref.shape)
        Mn = Mn if np.sign(M_ref[i]) == np.sign(Mn[i]) else -Mn
        np.testing.assert_allclose(Mn, M_ref, atol=1e-10)


@pytest.mark.parametrize("n_layers", [2, 3, 6])
def test_secular_matches_jax(n_layers):
    rng = np.random.default_rng(10 + n_layers)
    sec = jax.jit(JF.secular)
    for _ in range(4):
        d = rng.uniform(0.005, 0.03, n_layers)
        vs = np.sort(rng.uniform(0.2, 0.8, n_layers))
        jm, pm = _models(d, vs)
        c = rng.uniform(0.7 * vs.min(), vs[-1], 64)
        om = 2 * np.pi / rng.uniform(0.04, 0.5, 64)
        want = np.asarray(sec(jnp.asarray(c), jnp.asarray(om), jm))
        got = PF.secular(torch.as_tensor(c), torch.as_tensor(om), pm).numpy()
        peak = np.abs(want).max()
        spread = max(np.abs(np.asarray(sec(jnp.asarray(c * (1 + s * ULP)), jnp.asarray(om),
                                           jm)) - want).max() for s in (-2, -1, 1, 2)) / peak
        assert np.abs(got - want).max() / peak <= max(1e-12, 2 * spread)


def test_secular_batched_model_pairs_leading_dims():
    """A (B, n_layers) model pairs with the leading dim of c: member b of
    the batch equals the unbatched model b."""
    spec = PI.speed_model_spec()
    x = torch.as_tensor(np.random.default_rng(2).uniform(0, 1, (3, 12)))
    c = torch.linspace(0.1, 0.4, 7, dtype=torch.float64)
    om = torch.full((7,), 60.0, dtype=torch.float64)
    Db = PF.secular(c.expand(3, 7), om, spec.to_model(x))
    for b in range(3):
        np.testing.assert_allclose(Db[b].numpy(), PF.secular(c, om, spec.to_model(x[b])).numpy(),
                                   rtol=1e-13, atol=1e-15)


def _reference_models():
    """A 3-layer normal model, a 6-layer model from the speed search space,
    and a low-velocity-zone model (modes 0-4 exist in parts of the band)."""
    out = [_models([0.008, 0.02, 0.0], [0.2, 0.4, 0.7])]
    x = jnp.asarray(np.random.default_rng(4).uniform(0.2, 0.8, 12))
    jm6 = JI.speed_model_spec().to_model(x)
    out.append((jm6, layered_model_from_numpy(*(np.asarray(a) for a in jm6), device=CPU)))
    out.append(_models([0.012, 0.010, 0.030, 0.05], [0.45, 0.20, 0.55, 0.75], 0.35))
    return out


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_phase_velocity_matches_jax(mode):
    T = np.linspace(0.03, 0.5, 24)
    for jm, pm in _reference_models():
        want = np.asarray(JF.phase_velocity(jnp.asarray(T), jm, mode=mode, n_grid=300))
        got = PF.phase_velocity(T, pm, mode=mode, n_grid=300).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-10, atol=0)


def test_phase_velocity_per_period_modes_and_halfspace():
    jm, pm = _reference_models()[1]
    T = np.asarray(1.0 / np.arange(2.0, 24.0, 1.5))
    mode = np.resize([0, 3, 4], T.size)
    want = np.asarray(JF.phase_velocity(jnp.asarray(T), jm, mode=jnp.asarray(mode), n_grid=300))
    got = PF.phase_velocity(T, pm, mode=torch.as_tensor(mode), n_grid=300).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-10, atol=0)
    _, hm = _models([0.01, 0.02, 0.0], [0.5, 0.5, 0.5])
    c = PF.phase_velocity(np.array([0.05, 0.1, 0.3, 1.0]), hm, mode=0).numpy()
    np.testing.assert_allclose(c, PF.rayleigh_halfspace_velocity(float(hm.vp[0]), 0.5),
                               rtol=1e-8)
    _, tm = _models([0.01, 0.0], [0.2, 0.6])
    assert np.isnan(PF.phase_velocity(np.array([1.0]), tm, mode=4).numpy()).all()


def test_phase_velocity_gradient_matches_jax():
    T = np.linspace(0.05, 0.3, 6)
    d0, vs0 = np.array([0.008, 0.015, 0.0]), np.array([0.25, 0.45, 0.75])
    rho0 = np.full(3, 1.9)

    def fj(d, vs, rho):
        m = JF.LayeredModel(d, 3.0 * vs, vs, rho)
        return jnp.sum(JF.phase_velocity(jnp.asarray(T), m, mode=0, n_grid=300))

    gd, gv, gr = jax.grad(fj, argnums=(0, 1, 2))(jnp.asarray(d0), jnp.asarray(vs0),
                                                 jnp.asarray(rho0))
    d = torch.tensor(d0, requires_grad=True)
    vs = torch.tensor(vs0, requires_grad=True)
    rho = torch.tensor(rho0, requires_grad=True)
    PF.phase_velocity(T, PF.LayeredModel(d, 3.0 * vs, vs, rho), mode=0,
                      n_grid=300).sum().backward()
    np.testing.assert_allclose(vs.grad.numpy(), np.asarray(gv), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gd), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(rho.grad.numpy(), np.asarray(gr), rtol=1e-8, atol=1e-8)


def test_float32_agrees_with_float64():
    _, pm = _models([0.008, 0.02, 0.0], [0.2, 0.4, 0.7])
    m32 = PF.LayeredModel(*(a.float() for a in pm))
    c64 = PF.phase_velocity(np.linspace(0.05, 0.4, 8), pm).numpy()
    c32 = PF.phase_velocity(torch.linspace(0.05, 0.4, 8, dtype=torch.float32), m32)
    assert c32.dtype == torch.float32
    np.testing.assert_allclose(c32.numpy(), c64, rtol=2e-4)


def test_phase_sensitivity_matches_jax():
    jm, pm = _models([0.01, 0.03, 0.0], [0.25, 0.45, 0.8])
    for period in (1 / 15.0, 1 / 4.0):
        kj = JS.phase_sensitivity(jm, period=period, dz=0.01, zmax=0.1, n_grid=600)
        kp = PS.phase_sensitivity(pm, period=period, dz=0.01, zmax=0.1, n_grid=600)
        np.testing.assert_array_equal(kp.depth, kj.depth)
        assert np.isfinite(kp.kernel).all() and kp.kernel.sum() > 0
        np.testing.assert_allclose(kp.kernel, kj.kernel, rtol=0, atol=1e-9)
    fine_j = JS.resample_fine(jm, dz=0.002, zmax=0.1)
    fine_p = PS.resample_fine(pm, dz=0.002, zmax=0.1)
    for a, b in zip(fine_p, fine_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_scan_mode_diagnostics_matches_jax():
    vs = jnp.asarray([0.45, 0.20, 0.55, 0.75])
    vp = JF.vp_from_poisson(vs, 0.35)
    jm = JF.LayeredModel(jnp.asarray([0.012, 0.010, 0.030, 0.05]), vp, vs,
                         JF.density_gardner_linear(vp))
    pm = layered_model_from_numpy(*(np.asarray(a) for a in jm), device=CPU)
    per = np.asarray([1.0 / 14.4, 1 / 8.0, 1 / 20.0])
    for n_grid in (100, 300):
        dj = JF.scan_mode_diagnostics(jnp.asarray(per), jm, n_grid=n_grid)
        dp = PF.scan_mode_diagnostics(per, pm, n_grid=n_grid)
        for key in ("count", "count_refined", "missed", "dip"):
            np.testing.assert_array_equal(dp[key].numpy(), np.asarray(dj[key]))
    assert bool(dp["missed"].any()) is False
    d100 = PF.scan_mode_diagnostics(per[:1], pm, n_grid=100)
    assert bool(d100["missed"][0]) and bool(d100["dip"][0])


# -- curves ---------------------------------------------------------------------

def test_ridge_stats_and_curves_from_ridges_equal_jax():
    """The numpy copies give the JAX package's curves: band selection,
    ascending periods, km/s, the range as uncertainty floored at 1e-4, a
    skipped band, and a single repetition."""
    from das_diff_veh_tpu.inversion import curves as JC
    from das_diff_veh_tpu_torch.inversion import curves as PC
    rng = np.random.default_rng(12)
    freqs = np.arange(0.8, 25.0, 0.1)
    lb, ub = (2.5, 10.0, 14.0, 16.0), (14.0, 15.0, 19.0, 20.0)
    ridges = [300.0 + rng.normal(0, 5.0, (6, int(((freqs >= a) & (freqs < b)).sum())))
              for a, b in zip(lb, ub)]
    ridges[2][:, :3] = 420.0                       # zero spread: the floor
    for args in ((ridges, [0, 1, 3, 4], [2.0, 1.0, 1.0, 1.0], (1,)),
                 ([r[:1] for r in ridges], [0, 0, 3, 4], None, ())):
        want = JC.curves_from_ridges(freqs, lb, ub, args[0], args[1], args[2], args[3])
        got = PC.curves_from_ridges(freqs, lb, ub, args[0], args[1], args[2], args[3])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.mode, g.weight) == (w.mode, w.weight)
            for a, b in ((g.period, w.period), (g.velocity, w.velocity),
                         (g.uncertainty, w.uncertainty)):
                np.testing.assert_array_equal(a, b)
    for a, b in zip(PC.ridge_stats(ridges[0]), JC.ridge_stats(ridges[0])):
        np.testing.assert_array_equal(a, b)


# -- the misfit, the swarm and Adam --------------------------------------------

@pytest.mark.parametrize("invalid", ["penalty", "truncate"])
def test_misfit_matches_jax(invalid):
    _, jc, pc, jspec, pspec = _three_layer_problem()
    # a curve that asks for mode 4 below its cutoff: penalty vs truncation
    jc = jc + [JCurve(np.array([2.0, 0.05]), np.array([0.6, 0.9]), 4, 0.5,
                      np.array([0.01, 0.02]))]
    pc = pc + [PCurve(*jc[-1])]
    jf = JI.make_misfit_fn(jspec, jc, n_grid=150, invalid=invalid)
    pf = PI.make_misfit_fn(pspec, pc, n_grid=150, invalid=invalid)
    xs = np.random.default_rng(3).uniform(0.0, 1.0, (6, 6))
    want = np.array([float(jf(jnp.asarray(x))) for x in xs])
    got = pf(torch.as_tensor(xs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


def test_misfit_matches_jax_at_the_committed_best_models():
    """The closure and the packed misfit at the committed
    ``INVERSION_PARITY.json`` ``x_best`` vectors, against JAX's closure, on
    reference-band curves predicted from the search space's centre
    (tests/test_fleet_inversion.py:134-160)."""
    with open(os.path.join(REPO, "INVERSION_PARITY.json")) as f:
        parity = json.load(f)
    periods = np.asarray(1.0 / np.arange(2.0, 24.0, 1.5))[::-1]
    for name in ("speed", "weight"):
        jspec = getattr(JI, f"{name}_model_spec")()
        pspec = getattr(PI, f"{name}_model_spec")()
        xs = [e["x_best"] for k, e in parity.items() if k.endswith(name) and "x_best" in e][:2]
        assert xs
        vel = np.asarray(JF.phase_velocity(jnp.asarray(periods),
                                           jspec.to_model(jnp.full(jspec.n_params, 0.5)),
                                           mode=0, n_grid=300))
        keep = np.isfinite(vel)
        row = (periods[keep], vel[keep], 0, 1.0, 0.02 * np.ones(keep.sum()))
        packed_data = PFL.pack_curve_sets([[PCurve(*row)]], device=CPU)
        for inv in ("penalty", "truncate"):
            jf = JI.make_misfit_fn(jspec, [JCurve(*row)], n_grid=300, invalid=inv)
            pf = PI.make_misfit_fn(pspec, [PCurve(*row)], n_grid=300, invalid=inv)
            packed = PFL.make_packed_misfit_fn(pspec, n_grid=300, invalid=inv)
            for x in xs:
                x = np.asarray(x, np.float64)
                want = float(jf(jnp.asarray(x)))
                np.testing.assert_allclose(float(pf(torch.as_tensor(x))), want, rtol=1e-10,
                                           atol=1e-12)
                np.testing.assert_allclose(float(packed(torch.as_tensor(x)[None], packed_data)[0]),
                                           want, rtol=1e-10, atol=1e-12)


def test_three_pso_steps_fed_jax_draws_match_jax():
    _, jc, pc, jspec, pspec = _three_layer_problem()
    jfd = JI._as_data_misfit(JI.make_misfit_fn(jspec, jc, n_grid=150))
    pfd = PI._as_data_misfit(PI.make_misfit_fn(pspec, pc, n_grid=150))
    pop, npar = 6, 6
    state = JI._pso_init(jfd, jax.random.PRNGKey(0), n_params=npar, popsize=pop,
                         dtype=jnp.float64)
    key = jax.random.PRNGKey(5)
    jstate, jtrace = JI._pso_run(jfd, state, key, 3)
    pstate = tuple(torch.as_tensor(np.array(a)) for a in state)
    ptrace = []
    for k in jax.random.split(key, 3):
        r = jax.random.uniform(k, (2, pop, npar), dtype=jnp.float64)
        pstate, gf = PI.pso_step(pfd, pstate, torch.as_tensor(np.asarray(r)))
        ptrace.append(float(gf))
    for a, b in zip(pstate, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ptrace, np.asarray(jtrace), rtol=1e-12)
    # the same best members
    assert int(torch.argmin(pstate[3])) == int(jnp.argmin(jstate[3]))
    np.testing.assert_array_equal(pstate[3].argsort().numpy(), np.argsort(np.asarray(jstate[3])))


def test_pso_init_with_warm_start_matches_jax_layout():
    _, _, pc, _, pspec = _three_layer_problem()
    pfd = PI._as_data_misfit(PI.make_misfit_fn(pspec, pc, n_grid=120))
    u = torch.rand((2, 5, 6), dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    x0 = torch.tensor([[1.5, 0.5, -0.2, 0.3, 0.3, 0.3]], dtype=torch.float64)
    x, v, px, pf, gx, gf = PI.pso_init(pfd, u, u, x0=x0)
    np.testing.assert_array_equal(x[:, 0].numpy(), np.clip(x0.numpy(), 0, 1).repeat(2, 0))
    np.testing.assert_array_equal(v.numpy(), 0.1 * (u.numpy() - 0.5))
    assert torch.equal(gf, pf.amin(-1))


def test_five_refine_steps_match_jax():
    _, jc, pc, jspec, pspec = _three_layer_problem()
    jfd = JI._as_data_misfit(JI.make_misfit_fn(jspec, jc, n_grid=150))
    pfd = PI._as_data_misfit(PI.make_misfit_fn(pspec, pc, n_grid=150))
    starts = np.random.default_rng(6).uniform(0.1, 0.9, (4, 6))
    jx, jf = JI._refine(jfd, jnp.asarray(starts), 5)
    jx2, _ = JI._refine(jfd, jnp.asarray(starts * (1 + ULP)), 5)
    px, pf = PI._refine(pfd, torch.as_tensor(starts), 5)
    spread = np.abs(np.asarray(jx2) - np.asarray(jx)).max()
    assert np.abs(px.detach().numpy() - np.asarray(jx)).max() <= max(1e-9, 2 * spread)
    # the misfits of the refined points agree as the points do
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=1e-5)
    np.testing.assert_allclose(pfd(px, None).detach().numpy(), pf.numpy(), rtol=1e-12)


def test_adam_matches_optax_on_a_quadratic():
    """The batched Adam's update rule is optax.adam's (defaults, order)."""
    import optax
    target = np.array([[0.3, -1.0], [2.0, 0.5]])
    f = lambda z, data: ((z - torch.as_tensor(target)) ** 2).sum(-1)
    z = torch.zeros((2, 2), dtype=torch.float64)
    state = PI.adam_init(z)
    zj = jnp.zeros((2, 2))
    opt = optax.adam(0.1)
    sj = opt.init(zj)
    for _ in range(7):
        z, state, _ = PI.refine_step(lambda x, d: f(torch.logit(x), d), z, state, lr=0.1)
        g = 2 * (zj - target)
        u, sj = opt.update(g, sj)
        zj = optax.apply_updates(zj, u)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), rtol=1e-12, atol=1e-14)


# -- whole searches: the JAX tests' quality bars --------------------------------

def test_multirun_batching_mechanics():
    """tests/test_inversion.py:191: every run advances, the history is the
    best over the runs and never rises, refinement never hurts."""
    _, _, pc, _, pspec = _three_layer_problem()
    res = PI.invert_multirun(pspec, pc, n_runs=2, popsize=8, maxiter=24, n_refine_starts=3,
                             n_refine_steps=20, n_grid=150, seed=0, device=CPU)
    assert res.models_x.shape[0] == 2 * 8 + 2 * 4
    assert torch.isfinite(res.misfits).all()
    hist = res.history.numpy()
    assert hist.shape == (24,)
    assert (np.diff(hist) <= 1e-12).all()
    assert float(res.misfit) <= hist[-1] + 1e-6
    # a warm start from the best never ends above it
    warm = PI.invert_multirun(pspec, pc, n_runs=2, popsize=8, maxiter=4, n_refine_starts=3,
                              n_refine_steps=5, n_grid=150, seed=3, x0=res.x_best[None],
                              device=CPU)
    assert float(warm.misfit) <= float(res.misfit) + 1e-12


def test_invert_recovers_the_three_layer_profile():
    """tests/test_inversion.py's recovery bar (misfit < 0.5, Vs within 5 %)
    at a smaller swarm."""
    vs_true, _, pc, _, pspec = _three_layer_problem()
    res = PI.invert(pspec, pc, popsize=16, maxiter=40, n_refine_starts=4, n_refine_steps=40,
                    n_grid=150, seed=0, device=CPU)
    assert float(res.misfit) < 0.5
    np.testing.assert_allclose(res.model.vs.numpy(), vs_true, rtol=0.05)


def test_multirun_on_a_cpu_mesh_matches_the_single_slot():
    """Run r draws from the generator seeded seed + r on whichever slot it
    lands: four CPU slots give the single slot's result (the JAX test's
    tolerances, tests/test_inversion.py:286-316)."""
    from das_diff_veh_tpu_torch.parallel import make_mesh
    _, _, pc, _, pspec = _three_layer_problem()
    kw = dict(n_runs=4, popsize=6, maxiter=8, n_refine_starts=2, n_refine_steps=6,
              n_grid=120, seed=0, device=CPU)
    base = PI.invert_multirun(pspec, pc, **kw)
    sharded = PI.invert_multirun(pspec, pc, mesh=make_mesh(4, device=CPU), **kw)
    np.testing.assert_allclose(sharded.misfits.numpy(), base.misfits.numpy(), rtol=5e-3)
    np.testing.assert_allclose(sharded.x_best.numpy(), base.x_best.numpy(), atol=1e-7)
    assert int(torch.argmin(sharded.misfits)) == int(torch.argmin(base.misfits))


def test_inversion_entry_points_need_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, _, pc, _, pspec = _three_layer_problem()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PI.invert(pspec, pc, popsize=2, maxiter=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        layered_model_from_numpy([0.01, 0.0], [0.6, 1.2], [0.2, 0.4], [1.8, 1.9])


def test_science_path_loads_no_jax():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import numpy as np, torch
        torch.set_num_threads(1)
        import das_diff_veh_tpu_torch.analysis as A
        import das_diff_veh_tpu_torch.inversion as I
        import das_diff_veh_tpu_torch.ops as O
        from das_diff_veh_tpu_torch.ops import cwt, enhance, psd
        from das_diff_veh_tpu_torch.pipeline.timelapse import FleetVsMonitor
        spec = I.speed_model_spec()
        T = np.linspace(0.05, 0.3, 5)
        c = I.phase_velocity(T, spec.to_model(torch.full((12,), 0.5, dtype=torch.float64)))
        curves = [I.Curve(T, c.numpy(), 0, 1.0, 0.01 * np.ones(5))]
        r = I.invert(spec, curves, popsize=3, maxiter=2, n_refine_starts=1,
                     n_refine_steps=1, n_grid=60, device="cpu")
        fr = I.invert_fleet(spec, [curves], n_runs=1, popsize=3, maxiter=1,
                            n_refine_starts=1, n_refine_steps=1, n_grid=60, device="cpu")
        FleetVsMonitor(fr).observe(fr)
        O.fv_map_enhance(torch.rand(40, 30, dtype=torch.float64), tiles=(5, 4))
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "das_diff_veh_tpu")]
        assert not loaded, loaded
        print("ok", float(r.misfit))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.join(REPO, "tests"), env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")
