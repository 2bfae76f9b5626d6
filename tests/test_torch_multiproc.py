"""The mesh across processes on the CPU: ``torch.distributed`` groups of gloo
ranks on localhost, each rank driving its own CPU slots of a global
``make_mesh``, against the single-process calls and the JAX package.

Each case spawns its ranks (``multiprocessing`` "spawn"), which rendezvous
through a ``file://`` store under the test's ``tmp_path`` (so no two test
workers share a port), with a group timeout of 60 s; the parent joins them
by a 120 s deadline and kills any straggler.  A rank imports this module to
find its task: the module imports neither JAX nor the JAX package at its top,
and each rank asserts that neither is loaded when it is done.  The JAX
package runs only in the parent, inside the tests that compare with it.

Bars: every sharded entry on rank 0 equals the single-process call over as
many slots bit for bit (the same per-slot arithmetic; partial results reach
rank 0 and are added in slot order).  The ring also equals the unsharded
call bit for bit on the kernels' plain versions (as in
``test_torch_parallel.py``), and JAX's interpret-mode ring at the
all-pairs bar, 1e-6 peak-relative; the stack JAX's at 1e-9 in float64.
The searches on 2 ranks x 2 slots equal the single-process 4-slot search
bit for bit, and one slot bit for bit but for the fleet's refined members
(1e-12, as phase 17 of ``chip_smoke.py`` holds the fleet on the card).
"""

import multiprocessing
import os
import sys
import time

import numpy as np
import pytest
import torch

from das_diff_veh_tpu_torch import config as PC
from das_diff_veh_tpu_torch import parallel as PP
from das_diff_veh_tpu_torch import workloads as PWL
from das_diff_veh_tpu_torch.models import vsg as PV
from das_diff_veh_tpu_torch.ops.all_pairs import xcorr_all_pairs_peak

GROUP_TIMEOUT_S = 60
JOIN_DEADLINE_S = 120
ALL_PAIRS_BAR = 1e-6
# make_ambient_record(99, 2048) at wlen 256: 15 windows of 129 frequencies;
# 99 rows over 4 slots pad to shards of 25, a ragged last shard
RECORD = dict(nch=99, nt=2048, seed=0)
WLEN, SRC_CHUNK = 256, 8
RING_CONFIGS = {"ring": PC.RingConfig(),
                "serialized": PC.RingConfig(double_buffer=False),
                "replicated": PC.RingConfig(mode="replicated"),
                "bf16": PC.RingConfig(precision="bf16")}
# the stack's window batch (test_torch_parallel.py's), 7 windows over 4
# slots: padded to 8
STACK = dict(wkw=dict(wlen_sw=2.0, length_sw=120.0), gkw=dict(wlen=0.5, time_window=1.0),
             dkw=dict(freq_step=0.5, vel_step=20.0), n_windows=7)
# tiny searches (test_torch_inversion.py's multirun, test_torch_fleet.py's budget)
BOUNDS = ([(0.002, 0.01), (0.01, 0.03), (0.0, 0.0)], [(0.1, 0.3), (0.25, 0.6), (0.5, 0.9)])
SEARCH = dict(popsize=6, maxiter=8, n_refine_starts=2, n_refine_steps=6, n_grid=120, seed=0)


@pytest.fixture(autouse=True)
def one_thread():
    """Several test workers share a few cores: one PyTorch thread a test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the ranks

def _record():
    return PWL.make_ambient_record(**RECORD, device="cpu")


def _stack_inputs():
    batch, x = PWL.make_window_batch(n_windows=STACK["n_windows"], fs=50.0,
                                     wcfg=PC.WindowConfig(**STACK["wkw"]), dtype=np.float64,
                                     device="cpu")
    gcfg = PC.GatherConfig(**STACK["gkw"])
    g = PV.VsgGeometry.build(x, 1.0 / 50.0, 700.0, 640.0, 730.0, gcfg)
    return batch, g, g.offsets(x), gcfg, PC.DispersionConfig(**STACK["dkw"])


def _stack(batch, g, offs, gcfg, dcfg, mesh):
    return PP.sharded_stack_pipeline(batch, g, offs, mesh, gcfg, dcfg, disp_start_x=-60.0,
                                     disp_end_x=0.0)


def _curves():
    """Noisy replicates of a 3-layer model's mode-0 curve (3 targets)."""
    from das_diff_veh_tpu_torch.inversion import Curve
    from das_diff_veh_tpu_torch.inversion.forward import (LayeredModel,
                                                          density_gardner_linear,
                                                          phase_velocity, vp_from_poisson)

    vs = torch.tensor([0.20, 0.40, 0.70], dtype=torch.float64)
    vp = vp_from_poisson(vs, 0.4375)
    truth = LayeredModel(torch.tensor([0.006, 0.02, 0.0], dtype=torch.float64), vp, vs,
                         density_gardner_linear(vp))
    periods = np.linspace(0.05, 0.4, 10)
    c0 = phase_velocity(torch.from_numpy(periods), truth, mode=0, n_grid=200).numpy()
    rng = np.random.default_rng(1)
    return [[Curve(periods, c0 + rng.normal(0, 0.005, c0.size), 0, 1.0,
                   0.01 * np.ones(c0.size))] for _ in range(3)]


def _search(mesh, device=None):
    from das_diff_veh_tpu_torch.convert import model_spec_from_bounds
    from das_diff_veh_tpu_torch.inversion import invert_fleet, invert_multirun

    spec, sets = model_spec_from_bounds(*BOUNDS), _curves()
    multi = invert_multirun(spec, sets[0], n_runs=4, mesh=mesh, device=device, **SEARCH)
    fleet = invert_fleet(spec, sets, n_runs=2, mesh=mesh, device=device, **SEARCH)
    return multi, fleet


def _task_ring(slots):
    mesh = PP.make_mesh(slots, device="cpu")
    data = _record()
    return {name: PP.sharded_all_pairs_peak(data, WLEN, mesh, use_kernel=True,
                                            src_chunk=SRC_CHUNK, ring=cfg)
            for name, cfg in RING_CONFIGS.items()}


def _task_stack(slots):
    return _stack(*_stack_inputs(), PP.make_mesh(slots, device="cpu"))


def _task_search(slots):
    return _search(PP.make_mesh(slots, device="cpu"))


def _task_ladder(planted_on):
    """Two calls of ``resilient_all_pairs_peak`` on a fresh ladder, with one
    ``parallel.ring`` fault planted on the ranks listed."""
    from das_diff_veh_tpu_torch.obs.registry import MetricsRegistry
    from das_diff_veh_tpu_torch.resilience import degrade, faults
    from das_diff_veh_tpu_torch.resilience.faults import FaultPlan, FaultSpec

    lad = degrade.DegradationLadder(registry=MetricsRegistry())
    mesh = PP.make_mesh(PP.world_size(), device="cpu")
    data = _record()
    plan = FaultPlan(specs=(FaultSpec("parallel.ring", "error"),)
                     if PP.rank() in planted_on else ())
    with faults.injected(plan) as inj:
        first = degrade.resilient_all_pairs_peak(data, WLEN, mesh, lad=lad, use_kernel=True,
                                                 src_chunk=SRC_CHUNK)
        second = degrade.resilient_all_pairs_peak(data, WLEN, mesh, lad=lad, use_kernel=True,
                                                  src_chunk=SRC_CHUNK)
        fired = inj.n_injected
    return {"first": first, "second": second, "fired": fired,
            "demoted": lad.demoted(degrade.PARALLEL_RING),
            "failures": lad.failures(degrade.PARALLEL_RING)}


def _task_refused_input(refused_on):
    """``resilient_all_pairs_peak`` with a negative ``win_block`` (a refused
    input) on the ranks listed, then a valid call on every rank."""
    from das_diff_veh_tpu_torch.obs.registry import MetricsRegistry
    from das_diff_veh_tpu_torch.resilience import degrade

    lad = degrade.DegradationLadder(registry=MetricsRegistry())
    mesh = PP.make_mesh(PP.world_size(), device="cpu")
    data = _record()
    try:
        degrade.resilient_all_pairs_peak(data, WLEN, mesh, lad=lad, use_kernel=True,
                                         src_chunk=SRC_CHUNK,
                                         win_block=-1 if PP.rank() in refused_on else None)
        raised = None
    except ValueError as e:
        raised = type(e).__name__
    after = degrade.resilient_all_pairs_peak(data, WLEN, mesh, lad=lad, use_kernel=True,
                                             src_chunk=SRC_CHUNK)
    return {"raised": raised, "after": after, "demoted": lad.demoted(degrade.PARALLEL_RING),
            "failures": lad.failures(degrade.PARALLEL_RING)}


TASKS = {"ring": _task_ring, "stack": _task_stack, "search": _task_search,
         "ladder": _task_ladder, "refused_input": _task_refused_input}


def _rank_main(rank: int, world: int, store: str, task: str, arg, out_dir: str) -> None:
    torch.set_num_threads(1)
    PP.initialize_cluster(f"file://{store}", world, rank, backend="gloo",
                          timeout_s=GROUP_TIMEOUT_S)
    try:
        result = TASKS[task](arg)
        loaded = sorted(m for m in ("jax", "das_diff_veh_tpu") if m in sys.modules)
        assert not loaded, f"rank {rank} loaded {loaded}"
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _spawn(tmp_path, world: int, task: str, arg) -> list:
    """Run ``task(arg)`` on ``world`` gloo ranks; every rank's result, in
    rank order.  A rank that fails or misses the deadline fails the test
    (stragglers are killed)."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, str(tmp_path / "store"), task, arg, str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_DEADLINE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not late, f"ranks {late} missed the {JOIN_DEADLINE_S} s deadline"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# the tests

def _peak_rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("world", [4, 2])           # 4 ranks x 1 slot, 2 ranks x 2 slots
def test_ring_across_ranks(tmp_path, world):
    """Every mode and buffering and the bf16 tier on 4 slots dealt to the
    ranks: rank 0's matrix equals the single-process 4-slot ring and the
    unsharded call bit for bit; the other ranks return None."""
    got = _spawn(tmp_path, world, "ring", 4)
    assert all(v is None for r in got[1:] for v in r.values())
    data, mesh = _record(), PP.make_mesh(4, device="cpu")
    want = {p: xcorr_all_pairs_peak(data, WLEN, use_kernel=True, src_chunk=SRC_CHUNK,
                                    precision=p, device="cpu") for p in ("f32", "bf16")}
    for name, cfg in RING_CONFIGS.items():
        single = PP.sharded_all_pairs_peak(data, WLEN, mesh, use_kernel=True,
                                           src_chunk=SRC_CHUNK, ring=cfg)
        assert got[0][name].shape == (RECORD["nch"],) * 2, name
        assert torch.equal(got[0][name], single), name
        assert torch.equal(got[0][name], want[cfg.precision]), name


def test_ring_across_ranks_matches_jax(tmp_path):
    """4 ranks x 1 slot against JAX's interpret-mode ring on a 4-device CPU
    mesh, at the all-pairs bar."""
    import jax.numpy as jnp

    from das_diff_veh_tpu import parallel as JP

    got = _spawn(tmp_path, 4, "ring", 4)[0]["ring"]
    jring = JP.sharded_all_pairs_peak(jnp.asarray(_record().numpy()), WLEN, JP.make_mesh(4),
                                      use_pallas=True, interpret=True, src_chunk=SRC_CHUNK)
    assert _peak_rel(got.numpy(), jring) <= ALL_PAIRS_BAR


@pytest.mark.parametrize("world", [4, 2])
def test_stack_across_ranks(tmp_path, world):
    """The window-sharded stack on 4 slots dealt to the ranks (7 windows,
    padded to 8): rank 0's stack and image equal the single-process 4-slot
    stack bit for bit, and JAX's sharded stack at 1e-9 in float64."""
    from das_diff_veh_tpu import config as JC
    from das_diff_veh_tpu import parallel as JP
    from das_diff_veh_tpu import workloads as JWL
    from das_diff_veh_tpu.models import vsg as JV
    from das_diff_veh_tpu.parallel.stack import shard_windows as j_shard_windows
    from das_diff_veh_tpu.parallel.stack import sharded_stack_pipeline as j_sharded_stack

    got = _spawn(tmp_path, world, "stack", 4)
    assert all(r is None for r in got[1:])
    stack, img = got[0]
    inputs = _stack_inputs()
    want_stack, want_img = _stack(*inputs, PP.make_mesh(4, device="cpu"))
    assert torch.equal(stack, want_stack) and torch.equal(img, want_img)

    jb, x = JWL.make_window_batch(n_windows=STACK["n_windows"], fs=50.0,
                                  wcfg=JC.WindowConfig(**STACK["wkw"]), dtype=np.float64)
    jg = JV.VsgGeometry.build(x, 1.0 / 50.0, 700.0, 640.0, 730.0,
                              JC.GatherConfig(**STACK["gkw"]))
    jmesh = JP.make_mesh(4)
    jstack, jimg = j_sharded_stack(j_shard_windows(jb, jmesh), jg, jg.offsets(x), jmesh,
                                   JC.GatherConfig(**STACK["gkw"]),
                                   JC.DispersionConfig(**STACK["dkw"]), disp_start_x=-60.0,
                                   disp_end_x=0.0)
    np.testing.assert_allclose(stack.numpy(), np.asarray(jstack), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=1e-9, atol=1e-12)


def test_searches_across_ranks(tmp_path):
    """``invert_multirun`` (4 runs) and a 3-target fleet on 2 ranks x 2
    slots: rank 0's results equal the single-process 4-slot searches bit for
    bit, and the single slot's: the multirun bit for bit, the fleet in every
    field but its refined members, whose batched refinement sums in another
    order at another batch size (held at phase 17's 1e-12); the other ranks
    return None."""
    got = _spawn(tmp_path, 2, "search", 4)
    assert got[1] == (None, None)
    multi, fleet = got[0]
    multi4, fleet4 = _search(PP.make_mesh(4, device="cpu"))
    multi1, fleet1 = _search(None, device="cpu")
    for f in ("misfit", "x_best", "models_x", "misfits", "history"):
        assert torch.equal(getattr(multi, f), getattr(multi4, f)), f
        assert torch.equal(getattr(multi, f), getattr(multi1, f)), f
    for f, a, b, c in zip(fleet._fields, fleet, fleet4, fleet1):
        assert np.array_equal(a, b, equal_nan=True), f
        if f in ("models_x", "misfits"):
            np.testing.assert_allclose(a, c, rtol=0, atol=1e-12, err_msg=f)
        else:
            assert np.array_equal(a, c, equal_nan=True), f


@pytest.mark.parametrize("planted_on", [(0, 1, 2, 3), (1,)], ids=["every_rank", "rank1_only"])
def test_ladder_demotes_every_rank_together(tmp_path, planted_on):
    """A ``parallel.ring`` fault planted on every rank, or on rank 1 only:
    every rank's ladder demotes once, together, nothing hangs, and rank 0's
    result is the replicated layout's, equal to the unsharded call; the
    second call starts replicated on every rank (no fault site)."""
    got = _spawn(tmp_path, 4, "ladder", planted_on)
    want = xcorr_all_pairs_peak(_record(), WLEN, use_kernel=True, src_chunk=SRC_CHUNK,
                                device="cpu")
    for r, res in enumerate(got):
        assert res["demoted"] and res["failures"] == 1, (r, res)
        assert res["fired"] == (1 if r in planted_on else 0), (r, res)
        if r:
            assert res["first"] is None and res["second"] is None
    assert torch.equal(got[0]["first"], want) and torch.equal(got[0]["second"], want)


def test_ladder_refused_input_on_one_rank_demotes_no_rank(tmp_path):
    """A ``ValueError`` (a negative ``win_block``) on rank 1 only: every rank
    raises a ``ValueError`` together (rank 1 its own, the others
    ``PeerInvalid``), no ladder demotes, nothing hangs, and the next call
    runs the ring on every rank, equal to the unsharded call."""
    got = _spawn(tmp_path, 4, "refused_input", (1,))
    assert [r["raised"] for r in got] == ["PeerInvalid", "ValueError", "PeerInvalid",
                                          "PeerInvalid"]
    for r, res in enumerate(got):
        assert not res["demoted"] and res["failures"] == 0, (r, res)
        if r:
            assert res["after"] is None
    want = xcorr_all_pairs_peak(_record(), WLEN, use_kernel=True, src_chunk=SRC_CHUNK,
                                device="cpu")
    assert torch.equal(got[0]["after"], want)
