"""The port's fleet engine (``inversion/fleet.py``) and ``FleetVsMonitor``
against the JAX package on the CPU at float64.

- packing equals the JAX packing array for array; the packed misfit equals
  the port's closure misfit and the JAX packed misfit at 1e-10 on ragged
  sets, in both ``invalid`` modes;
- the search draws from another stream than JAX, so whole fleets are held
  to tests/test_fleet_inversion.py's bars: intervals contain the estimates,
  the history never rises, the reported misfit is the closure oracle's
  score of the reported best, a target's result does not depend on the
  chunking, the mesh or the fleet around it;
- ``detect_vs_shifts`` and ``FleetVsMonitor`` give the JAX package's events,
  counters and flight records on the same results.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das_diff_veh_tpu.inversion import fleet as JFL
from das_diff_veh_tpu.inversion import forward as JF
from das_diff_veh_tpu.inversion.curves import Curve as JCurve
from das_diff_veh_tpu_torch.convert import fleet_result_from_numpy, model_spec_from_bounds
from das_diff_veh_tpu_torch.inversion import fleet as PFL
from das_diff_veh_tpu_torch.inversion.curves import Curve as PCurve

JI = importlib.import_module("das_diff_veh_tpu.inversion.invert")
PI = importlib.import_module("das_diff_veh_tpu_torch.inversion.invert")
CPU = "cpu"
BUDGET = dict(n_runs=2, popsize=5, maxiter=6, n_refine_starts=2, n_refine_steps=5, n_grid=120)
BOUNDS = ([(0.002, 0.012), (0.01, 0.04), (0.02, 0.08)], [(0.1, 0.3), (0.25, 0.55), (0.5, 1.0)])


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


def _specs():
    jspec = JI.ModelSpec(layers=tuple(JI.LayerBounds(d, v) for d, v in zip(*BOUNDS)))
    return jspec, model_spec_from_bounds(*BOUNDS)


def _truth():
    vs = jnp.asarray([0.20, 0.40, 0.70])
    vp = JF.vp_from_poisson(vs, 0.4375)
    return JF.LayeredModel(jnp.asarray([0.006, 0.02, 0.0]), vp, vs,
                           JF.density_gardner_linear(vp))


def _curve_rows(n_targets, n_pts=12, seed=1, ragged=False):
    """The JAX tests' noisy replicates of the truth's mode-0 curve (every
    second target shorter, a mode-1 curve on the first when ``ragged``)."""
    periods = np.linspace(0.05, 0.4, n_pts)
    c0 = np.asarray(JF.phase_velocity(jnp.asarray(periods), _truth(), mode=0, n_grid=400))
    rng = np.random.default_rng(seed)
    sets = []
    for t in range(n_targets):
        n = n_pts - 3 if (ragged and t % 2) else n_pts
        sets.append([(periods[:n], c0[:n] + rng.normal(0, 0.005, n), 0, 1.0,
                      0.01 * np.ones(n))])
    if ragged:
        p1 = np.linspace(0.05, 0.12, 4)
        c1 = np.asarray(JF.phase_velocity(jnp.asarray(p1), _truth(), mode=1, n_grid=400))
        sets[0].append((p1, c1, 1, 0.5, 0.02 * np.ones(4)))
    return sets


def _sets(rows, cls):
    return [[cls(*r) for r in s] for s in rows]


@pytest.fixture(scope="module")
def small_fleet():
    """(spec, port curve sets, FleetResult): one small ragged fleet, on one
    PyTorch thread (a module fixture runs before ``one_thread``)."""
    _, pspec = _specs()
    sets = _sets(_curve_rows(3, ragged=True), PCurve)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return pspec, sets, PFL.invert_fleet(pspec, sets, seed=0, device=CPU, **BUDGET)
    finally:
        torch.set_num_threads(n)


def test_pack_curve_sets_equals_jax():
    rows = _curve_rows(3, ragged=True)
    jb = JFL.pack_curve_sets(_sets(rows, JCurve))
    pb = PFL.pack_curve_sets(_sets(rows, PCurve), device=CPU)
    for a, b in zip(pb, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert pb.n_targets == 3 and pb.n_curves == 2
    pinned = PFL.pack_curve_sets(_sets(rows, PCurve), max_points=40, max_curves=3, device=CPU)
    assert pinned.period.shape == (3, 40) and pinned.weight.shape == (3, 3)
    with pytest.raises(ValueError, match="capacity"):
        PFL.pack_curve_sets(_sets(rows, PCurve), max_points=4, device=CPU)
    with pytest.raises(ValueError):
        PFL.pack_curve_sets([], device=CPU)


@pytest.mark.parametrize("invalid", ["penalty", "truncate"])
def test_packed_misfit_matches_closure_and_jax(invalid):
    jspec, pspec = _specs()
    rows = _curve_rows(3, ragged=True)
    # a mode-4 curve below its cutoff on the last target
    rows[2].append((np.array([1.0, 0.06]), np.array([0.6, 0.9]), 4, 0.7, np.array([0.01, 0.02])))
    jb = JFL.pack_curve_sets(_sets(rows, JCurve))
    pb = PFL.pack_curve_sets(_sets(rows, PCurve), device=CPU)
    jpacked = JFL.make_packed_misfit_fn(jspec, n_grid=120, invalid=invalid)
    ppacked = PFL.make_packed_misfit_fn(pspec, n_grid=120, invalid=invalid)
    xs = np.random.default_rng(3).uniform(0.05, 0.95, (4, 6))
    batched = ppacked(torch.as_tensor(np.broadcast_to(xs, (3, 4, 6)).copy()), pb).numpy()
    for t, row in enumerate(rows):
        closure = PI.make_misfit_fn(pspec, _sets([row], PCurve)[0], n_grid=120, invalid=invalid)
        data_t = jax.tree.map(lambda a: a[t], jb)
        want = np.array([float(jpacked(jnp.asarray(x), data_t)) for x in xs])
        got = ppacked(torch.as_tensor(xs), pb.map(lambda a: a[t])).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(closure(torch.as_tensor(xs)).numpy(), got, rtol=1e-12)
        np.testing.assert_allclose(batched[t], got, rtol=1e-12)


def test_fleet_result_carries_intervals_and_the_oracle_misfit(small_fleet):
    spec, sets, res = small_fleet
    T = len(sets)
    assert res.vs.shape == res.vs_lo.shape == res.vs_hi.shape == (T, 3)
    assert np.all(res.vs_lo <= res.vs) and np.all(res.vs <= res.vs_hi)
    assert np.all(res.n_ensemble >= 1) and np.all(np.isfinite(res.misfit))
    assert res.history.shape == (T, BUDGET["maxiter"])
    assert np.all(np.diff(res.history, axis=1) <= 1e-12)
    for t, cs in enumerate(sets):
        oracle = float(PI.make_misfit_fn(spec, cs, n_grid=120)(torch.as_tensor(res.x_best[t])))
        np.testing.assert_allclose(res.misfit[t], oracle, rtol=1e-9, atol=1e-12)
        assert res.misfit[t] <= np.nanmin(res.misfits[t]) + 1e-12


def test_fleet_target_is_its_own_multirun(small_fleet):
    """Target t draws from the generators seeded seed + t * n_runs + r: it
    reproduces ``invert_multirun`` with seed + t * n_runs."""
    spec, sets, res = small_fleet
    for t in (0, 2):
        single = PI.invert_multirun(spec, sets[t], seed=t * BUDGET["n_runs"], device=CPU,
                                    **BUDGET)
        np.testing.assert_allclose(res.misfit[t], float(single.misfit), rtol=1e-9)
        np.testing.assert_allclose(res.x_best[t], single.x_best.numpy(), atol=1e-7)


def test_target_chunk_and_cpu_mesh_invariance(small_fleet):
    from das_diff_veh_tpu_torch.parallel import make_mesh
    spec, sets, base = small_fleet
    chunked = PFL.invert_fleet(spec, sets, seed=0, target_chunk=2, device=CPU, **BUDGET)
    meshed = PFL.invert_fleet(spec, sets, seed=0, mesh=make_mesh(2, device=CPU), **BUDGET)
    for other in (chunked, meshed):
        np.testing.assert_allclose(other.misfit, base.misfit, rtol=5e-3)
        np.testing.assert_allclose(other.x_best, base.x_best, atol=1e-6)
        np.testing.assert_allclose(other.vs, base.vs, atol=1e-6)


def _shift(res, t, layer, delta):
    vs = res.vs.copy()
    vs[t, layer] += delta
    return res._replace(vs=vs, vs_lo=vs - (res.vs - res.vs_lo), vs_hi=vs + (res.vs_hi - res.vs))


def test_detect_vs_shifts_matches_jax(small_fleet):
    _, _, res = small_fleet
    jres = JFL.FleetResult(**res._asdict())
    assert PFL.detect_vs_shifts(res, res) == [] == JFL.detect_vs_shifts(jres, jres)
    big = float(res.vs_hi[1, 0] - res.vs[1, 0]) + 0.05
    cur = _shift(res, 1, 0, big)
    cur = cur._replace(vs=cur.vs + np.array([[0, 0, 0], [0, 0, 0], [0, -0.3, 0]]))
    want = JFL.detect_vs_shifts(jres, JFL.FleetResult(**cur._asdict()))
    got = PFL.detect_vs_shifts(res, cur)
    assert [tuple(e) for e in got] == [tuple(e) for e in want]
    assert [(e.target, e.layer) for e in got] == [(1, 0), (2, 1)]
    with pytest.raises(ValueError):
        PFL.detect_vs_shifts(res, res._replace(vs=res.vs[:2]))


def test_fleet_result_round_trips_through_numpy(small_fleet):
    _, _, res = small_fleet
    jres = JFL.FleetResult(**res._asdict())
    back = fleet_result_from_numpy({k: np.asarray(v) for k, v in jres._asdict().items()})
    for a, b in zip(back, res):
        np.testing.assert_array_equal(a, b)


def test_monitor_counters_and_flight_records_match_jax(small_fleet):
    from das_diff_veh_tpu.obs.flight import FlightRecorder as JFlight
    from das_diff_veh_tpu.obs.registry import MetricsRegistry as JRegistry
    from das_diff_veh_tpu.pipeline.timelapse import FleetVsMonitor as JMonitor
    from das_diff_veh_tpu_torch.obs.flight import FlightRecorder as PFlight
    from das_diff_veh_tpu_torch.obs.registry import MetricsRegistry as PRegistry
    from das_diff_veh_tpu_torch.pipeline.timelapse import FleetVsMonitor as PMonitor
    _, _, res = small_fleet
    names = ["t0", "t1", "t2"]
    big = float(res.vs_hi[1, 0] - res.vs[1, 0]) + 0.05
    epochs = [res, _shift(res, 1, 0, big), res, _shift(res, 2, 2, -1.0)]
    sides = []
    for Reg, Fl, Mon, FR in ((JRegistry, JFlight, JMonitor, JFL.FleetResult),
                             (PRegistry, PFlight, PMonitor, PFL.FleetResult)):
        reg, fl = Reg(), Fl(capacity=16)
        mon = Mon(FR(**res._asdict()), registry=reg, flight=fl, target_names=names)
        seen = []
        for ep in epochs:
            events = mon.observe(FR(**ep._asdict()))
            seen.append(([tuple(e) for e in events],
                         {n: reg.get("das_fleet_vs_alarm_active").labels(target=n).value
                          for n in names},
                         {n: reg.get("das_fleet_vs_shift_total").labels(target=n).value
                          for n in names},
                         reg.get("das_fleet_vs_epochs_total").value))
        recs = [{k: v for k, v in r.items() if k not in ("t", "ts", "time", "wall")}
                for r in fl.records() if r["kind"] == "vs_shift"]
        mon.rebase(FR(**epochs[1]._asdict()))
        rebased = [reg.get("das_fleet_vs_alarm_active").labels(target=n).value for n in names]
        sides.append((seen, recs, rebased))
    (js, jr, jb), (ps, pr, pb) = sides
    assert ps == js and pr == jr and pb == jb
    assert [len(s[0]) for s in ps] == [0, 1, 0, 1] and ps[1][1]["t1"] == 1.0
    assert len(pr) == 2 and pr[0]["target"] == "t1" and pr[1]["target"] == "t2"
    with pytest.raises(ValueError):
        PMonitor(res, registry=PRegistry(), target_names=["a"])
