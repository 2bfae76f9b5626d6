"""Fleet inversion: T curve sets inverted in one batched search (mirrors
``das_diff_veh_tpu/inversion/fleet.py``).

- :func:`pack_curve_sets` pads T ragged curve sets into ``(T, P)``
  period/velocity/uncertainty/mode tensors with a validity mask and
  per-point curve ids (:class:`CurveBatch`);
- :func:`make_packed_misfit_fn` builds ``misfit(x01, curve_batch)`` whose
  per-curve RMSE is a masked sum per curve id: numerically the closure
  objective of ``invert.make_misfit_fn``, with the observations as
  arguments;
- :func:`invert_fleet` batches the search over ``(targets, runs, pop)``,
  cuts the target axis into padded chunks (``target_chunk``) and deals a
  chunk's targets over a mesh's slots.  Target ``t`` run ``r`` draws from
  the generator seeded ``seed + t * n_runs + r``, so a target's result does
  not depend on the chunking or the mesh.

:class:`FleetResult` carries per-target credible intervals from the pooled
ensemble (population + refined members within ``credible_factor`` of the
best), widened to contain the best profile; :func:`detect_vs_shifts` turns a
(baseline, current) pair into change events for
``pipeline.timelapse.FleetVsMonitor``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from das_diff_veh_tpu_torch.inversion.curves import Curve
from das_diff_veh_tpu_torch.inversion.forward import _pairwise_sum, phase_velocity
from das_diff_veh_tpu_torch.inversion.invert import (INVALID_RESIDUAL, ModelSpec, _on_root,
                                                     _pool_starts, _refine, _run_generators,
                                                     _slots_of, _swarm, _warm_starts)


class CurveBatch(NamedTuple):
    """T ragged curve sets as padded, masked tensors: ``(..., P)`` points and
    ``(..., S)`` curve slots.  Padding points carry ``valid=False``, period
    1.0, uncertainty 1.0 and curve 0; padding curve slots weight 0.
    ``wsum`` is each target's sum of real curve weights."""

    period: torch.Tensor
    velocity: torch.Tensor
    uncertainty: torch.Tensor
    mode: torch.Tensor
    valid: torch.Tensor
    segment: torch.Tensor
    weight: torch.Tensor
    wsum: torch.Tensor

    @property
    def n_targets(self) -> int:
        return self.period.shape[0]

    @property
    def n_curves(self) -> int:
        return self.weight.shape[-1]

    def map(self, fn) -> "CurveBatch":
        return CurveBatch(*(fn(a) for a in self))


def pack_curve_sets(curve_sets: Sequence[Sequence[Curve]], dtype=None,
                    max_points: Optional[int] = None, max_curves: Optional[int] = None,
                    device=None) -> CurveBatch:
    """T ragged curve sets in one padded :class:`CurveBatch` on ``device``
    (``None`` = the card).  ``max_points`` / ``max_curves`` pin the padded
    capacity; ``dtype`` the observations' float dtype (None: float64)."""
    from das_diff_veh_tpu_torch.device import resolve_device

    if not curve_sets:
        raise ValueError("pack_curve_sets needs at least one curve set")
    counts = [[int(np.asarray(c.period).shape[0]) for c in cs] for cs in curve_sets]
    if any(len(c) == 0 for c in counts):
        raise ValueError("every curve set needs at least one curve")
    p_need = max(sum(cnt) for cnt in counts)
    s_need = max(len(cnt) for cnt in counts)
    P = p_need if max_points is None else int(max_points)
    S = s_need if max_curves is None else int(max_curves)
    if P < p_need or S < s_need:
        raise ValueError(f"capacity ({P} pts, {S} curves) below largest "
                         f"set ({p_need} pts, {s_need} curves)")
    T = len(curve_sets)
    per, vel, unc = np.ones((T, P)), np.zeros((T, P)), np.ones((T, P))
    mode = np.zeros((T, P), dtype=np.int64)
    valid = np.zeros((T, P), dtype=bool)
    seg = np.zeros((T, P), dtype=np.int64)
    w = np.zeros((T, S))
    for t, cs in enumerate(curve_sets):
        o = 0
        for i, c in enumerate(cs):
            p = np.asarray(c.period, dtype=np.float64)
            n = p.shape[0]
            per[t, o:o + n] = p
            vel[t, o:o + n] = np.asarray(c.velocity, dtype=np.float64)
            unc[t, o:o + n] = (np.asarray(c.uncertainty, dtype=np.float64)
                               if c.uncertainty is not None else 1.0)
            mode[t, o:o + n] = int(c.mode)
            valid[t, o:o + n] = True
            seg[t, o:o + n] = i
            w[t, i] = float(c.weight)
            o += n
    dev = resolve_device(device)
    dtype = dtype or torch.float64
    f = lambda a: torch.as_tensor(a, device=dev).to(dtype)
    i = lambda a: torch.as_tensor(a, device=dev)
    return CurveBatch(period=f(per), velocity=f(vel), uncertainty=f(unc), mode=i(mode),
                      valid=i(valid), segment=i(seg), weight=f(w), wsum=f(w.sum(axis=1)))


def _align(cb: CurveBatch, n_batch: int) -> CurveBatch:
    """Insert singleton dims after the curve batch's leading dims so it
    broadcasts against ``n_batch`` model batch dims."""
    extra = n_batch - (cb.period.ndim - 1)
    if extra < 0:
        raise ValueError(f"a curve batch of {cb.period.shape[:-1]} targets cannot pair with "
                         f"{n_batch} model batch dims")
    lead = cb.period.shape[:-1]
    return cb.map(lambda a: a.reshape(lead + (1,) * extra + a.shape[len(lead):]))


@functools.lru_cache(maxsize=64)
def make_packed_misfit_fn(spec: ModelSpec, n_grid: int = 400, n_subdiv: int = 1,
                          invalid: str = "penalty"):
    """``misfit(x01, curve_batch)``: unit-cube vectors ``(*Bc, *E,
    n_params)`` against a curve batch with leading ``Bc`` (one target when
    ``Bc`` is empty) -> ``(*Bc, *E)``.  The closure objective of
    ``make_misfit_fn``, with each curve's sums taken over its masked points;
    cached on ``(spec, n_grid, n_subdiv, invalid)``."""
    if invalid not in ("penalty", "truncate"):
        raise ValueError(f"invalid must be 'penalty' or 'truncate', got {invalid!r}")

    def misfit(x01: torch.Tensor, cb: CurveBatch) -> torch.Tensor:
        cb = _align(cb, x01.ndim - 1)
        pred = phase_velocity(cb.period, spec.to_model(x01), mode=cb.mode, n_grid=n_grid,
                              n_subdiv=n_subdiv)
        fin = torch.isfinite(pred) & cb.valid
        r = torch.where(fin, (cb.velocity - pred) / cb.uncertainty, INVALID_RESIDUAL)
        r = torch.where(cb.valid, r, 0.0)
        rmse = []
        for s in range(cb.weight.shape[-1]):
            in_s = cb.segment == s
            npts = (cb.valid & in_s).sum(-1)
            if invalid == "truncate":
                kept = fin & in_s
                n_fin = kept.sum(-1)
                ss = _pairwise_sum(torch.where(kept, r * r, 0.0))
                e = torch.sqrt(ss / torch.clamp(n_fin, min=1))
                e = torch.where(n_fin > 0, e, INVALID_RESIDUAL)
                e = torch.where(npts > 0, e, 0.0)
            else:
                ss = _pairwise_sum(torch.where(in_s, r * r, 0.0))
                e = torch.sqrt(ss / torch.clamp(npts, min=1))
            rmse.append(e)
        rmse = torch.stack(rmse, dim=-1)
        return _pairwise_sum(cb.weight * rmse) / cb.wsum

    return misfit


class FleetResult(NamedTuple):
    """Per-target best models + pooled-ensemble credible intervals, host
    numpy arrays with a leading target axis ``T``."""

    x_best: np.ndarray       # (T, n_params) unit-cube best model
    misfit: np.ndarray       # (T,)
    thickness: np.ndarray    # (T, n_layers) km
    vs: np.ndarray           # (T, n_layers) km/s best-model profile
    vs_lo: np.ndarray        # (T, n_layers) lower credible bound
    vs_med: np.ndarray       # (T, n_layers) ensemble median
    vs_hi: np.ndarray        # (T, n_layers) upper credible bound
    n_ensemble: np.ndarray   # (T,) members inside the credible cut
    models_x: np.ndarray     # (T, M, n_params) pooled pop + refined
    misfits: np.ndarray      # (T, M)
    history: np.ndarray      # (T, maxiter) best-so-far misfit trace


class VsShiftEvent(NamedTuple):
    """One layer of one target outside the baseline interval."""

    target: int
    layer: int
    vs: float
    lo: float
    hi: float


def detect_vs_shifts(baseline: FleetResult, current: FleetResult) -> list[VsShiftEvent]:
    """Layers whose current best Vs falls outside the baseline's credible
    interval."""
    if baseline.vs.shape != current.vs.shape:
        raise ValueError(f"baseline/current fleet shapes differ: "
                         f"{baseline.vs.shape} vs {current.vs.shape}")
    out = (current.vs < baseline.vs_lo) | (current.vs > baseline.vs_hi)
    return [VsShiftEvent(target=int(t), layer=int(layer), vs=float(current.vs[t, layer]),
                         lo=float(baseline.vs_lo[t, layer]), hi=float(baseline.vs_hi[t, layer]))
            for t, layer in zip(*np.nonzero(out))]


def _ensemble_intervals(spec: ModelSpec, models_x: np.ndarray, misfits: np.ndarray,
                        factor: float, q: tuple[float, float]):
    """Per-layer Vs quantiles over each target's credible members (finite
    misfit within ``factor`` x the best)."""
    lo_b, hi_b = spec.bounds_arrays()
    n = spec.n_layers
    x = lo_b + (hi_b - lo_b) * np.clip(models_x, 0.0, 1.0)
    vs_all = x[..., n:2 * n]
    best = np.nanmin(np.where(np.isfinite(misfits), misfits, np.inf), axis=1, keepdims=True)
    sel = np.isfinite(misfits) & (misfits <= factor * best)
    v = np.where(sel[..., None], vs_all, np.nan)
    return (np.nanquantile(v, q[0], axis=1), np.nanquantile(v, 0.5, axis=1),
            np.nanquantile(v, q[1], axis=1), sel.sum(axis=1))


def invert_fleet(spec: ModelSpec, curve_sets: Optional[Sequence[Sequence[Curve]]] = None, *,
                 batch: Optional[CurveBatch] = None, n_runs: int = 2, popsize: int = 50,
                 maxiter: int = 200, n_refine_starts: int = 8, n_refine_steps: int = 80,
                 n_grid: int = 400, n_subdiv: int = 1, dtype=None, invalid: str = "penalty",
                 seed: int = 0, chunk: int = 50, eval_chunk: int = 0, refine_chunk: int = 0,
                 target_chunk: int = 0, credible_factor: float = 2.0,
                 credible_q: tuple[float, float] = (0.05, 0.95), x0=None, mesh=None,
                 mesh_axis: str = "win", device=None) -> FleetResult | None:
    """Invert T curve sets in one batched search over (targets, runs, pop),
    on ``device`` (``None`` = the card) or the slots of ``mesh``.

    Parameters mirror ``invert_multirun`` per target, plus ``batch`` (a
    prebuilt :class:`CurveBatch`), ``target_chunk`` (targets per pass, each
    pass padded to that size by repeating its first target), the credible
    cut and quantiles.  ``mesh`` deals each pass's targets over its slots in
    contiguous blocks (the pass rounded up to a multiple of its size); on a
    mesh across processes each rank runs its own slots' targets, their
    members and histories go to rank 0 in slot order, and rank 0 returns
    the result, the other ranks ``None``."""
    del chunk, mesh_axis
    dtype = dtype or torch.float64
    devs, local = _slots_of(mesh, device)
    home = devs[local[0]]
    if batch is None:
        if curve_sets is None:
            raise ValueError("pass curve_sets or a packed batch")
        batch = pack_curve_sets(curve_sets, dtype=dtype, device=home)
    misfit_fn = make_packed_misfit_fn(spec, n_grid=n_grid, n_subdiv=n_subdiv, invalid=invalid)
    T = batch.n_targets
    tc = target_chunk if (target_chunk and target_chunk < T) else T
    tc = -(-tc // len(devs)) * len(devs)
    x0 = _warm_starts(x0, dtype)
    k = min(n_refine_starts, popsize)
    chunks = []
    for start in range(0, T, tc):
        sel = np.arange(start, start + tc)
        sel = np.where(sel < T, sel, start)
        keep = min(tc, T - start)
        parts = np.array_split(sel, len(devs))
        slots = []
        for j in local:
            d, part = devs[j], parts[j]
            idx = torch.as_tensor(part, device=batch.period.device)
            seeds = seed + part[:, None] * n_runs + np.arange(n_runs)[None, :]
            slots.append({"misfit": misfit_fn, "device": d, "lead": (len(part), n_runs),
                          "data": batch.map(lambda a: a[idx].to(d)),
                          "gens": _run_generators(seeds, d)})

        def run_slots(slots=slots):
            out = _swarm(slots, popsize, spec.n_params, maxiter, dtype, eval_chunk, x0)
            done = []
            for s, (state, hist) in zip(slots, out):
                starts = _pool_starts(state, k)               # (tc_s, runs*(k+1), n_params)
                ref_x, ref_f = _refine(misfit_fn, starts, n_refine_steps, data=s["data"],
                                       refine_chunk=refine_chunk)
                n = starts.shape[0]
                done.append(tuple(a.detach().cpu().numpy() for a in (
                    torch.cat([state[2].reshape(n, -1, spec.n_params), ref_x], dim=1),
                    torch.cat([state[3].reshape(n, -1), ref_f], dim=1),
                    torch.amin(hist, dim=1))))
            return done

        done = _on_root(mesh, home, "invert_fleet", run_slots, lambda e: e)
        if done is None:
            continue
        ax, af, ah = (np.concatenate([d[i] for d in done], axis=0) for i in range(3))
        chunks.append((ax[:keep], af[:keep], ah[:keep]))
    if not chunks:                  # a rank other than 0 of a mesh across processes
        return None
    models_x = np.concatenate([c[0] for c in chunks], axis=0)
    misfits = np.concatenate([c[1] for c in chunks], axis=0)
    history = np.concatenate([c[2] for c in chunks], axis=0)

    best = np.argmin(misfits, axis=1)
    x_best = np.take_along_axis(models_x, best[:, None, None], axis=1)[:, 0]
    misfit_best = np.take_along_axis(misfits, best[:, None], axis=1)[:, 0]
    lo_b, hi_b = spec.bounds_arrays()
    xb = lo_b + (hi_b - lo_b) * np.clip(x_best, 0.0, 1.0)
    nl = spec.n_layers
    thickness, vs = xb[:, :nl], xb[:, nl:2 * nl]
    vs_lo, vs_med, vs_hi, n_ens = _ensemble_intervals(spec, models_x, misfits,
                                                      credible_factor, credible_q)
    # the interval always contains the shipped best profile
    vs_lo = np.minimum(vs_lo, vs)
    vs_hi = np.maximum(vs_hi, vs)
    return FleetResult(x_best=x_best, misfit=misfit_best, thickness=thickness, vs=vs,
                       vs_lo=vs_lo, vs_med=vs_med, vs_hi=vs_hi, n_ensemble=n_ens,
                       models_x=models_x, misfits=misfits, history=history)
