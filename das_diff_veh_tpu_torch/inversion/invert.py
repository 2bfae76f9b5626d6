"""Vs-profile inversion: misfit, particle swarm and Adam refinement (mirrors
``das_diff_veh_tpu/inversion/invert.py``; the role of the reference's
``evodcinv.EarthModel`` CPSO inversion, inversion_diff_speed.ipynb cells
7-9).

- The misfit is evodcinv's "rmse": per curve ``sqrt(mean(((obs - pred) /
  unc)^2))``, a weight-normalised sum over curves; a missing overtone counts
  a fixed penalty residual (``invalid="penalty"``) or drops out of its
  curve's mean (``"truncate"``, evodcinv's own rule).  It takes a batch of
  unit-cube vectors ``(*B, n_params)`` and evaluates them in one root solve.
- The swarm is inertial global-best PSO (w=0.7298, c1=c2=1.49618, velocity
  clamp ±0.25, positions clipped to the unit cube).  Its random draws come
  from one ``torch.Generator`` per run on the run's device, seeded
  ``seed + run``; a step takes its draws as an argument
  (:func:`pso_step`), so a test can feed it the JAX package's own draws.
- Refinement is batched Adam in logit space with optax's defaults and
  update order (b1 0.9, b2 0.999, eps 1e-8 after the square root, bias
  corrected); each start keeps its own moments in one batched tensor, and
  non-finite gradients are set to 0.

Every run's swarm advances in one batched evaluation; the best basins of all
runs are pooled into one refinement batch.  With a ``mesh``
(``parallel.Mesh``) the run axis is dealt over its slots in contiguous
blocks, each slot advances its own runs, and the runs are pooled at the end.
On a mesh across processes each rank advances its own slots' runs, and
their swarm states and histories go to rank 0 in slot order, which refines
and returns the result; the other ranks return ``None``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from das_diff_veh_tpu_torch.device import resolve_device
from das_diff_veh_tpu_torch.inversion.curves import Curve
from das_diff_veh_tpu_torch.inversion.forward import (LayeredModel, density_gardner_linear,
                                                      vp_from_poisson)
from das_diff_veh_tpu_torch.parallel import distributed

INVALID_RESIDUAL = 5.0  # penalty residual of a below-cutoff overtone sample
PSO_W, PSO_C1, PSO_C2 = 0.7298, 1.49618, 1.49618
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class LayerBounds(NamedTuple):
    """Search bounds of one layer: thickness (km), vs (km/s), Poisson; a
    degenerate Poisson interval pins nu."""

    thickness: tuple[float, float]
    vs: tuple[float, float]
    poisson: tuple[float, float] = (0.4375, 0.4375)


class ModelSpec(NamedTuple):
    layers: tuple[LayerBounds, ...]
    density: Callable[[torch.Tensor], torch.Tensor] = density_gardner_linear

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def free_poisson(self) -> bool:
        return any(b.poisson[0] != b.poisson[1] for b in self.layers)

    @property
    def n_params(self) -> int:
        return self.n_layers * (3 if self.free_poisson else 2)

    def bounds_arrays(self):
        """Host float64 ``(lo, hi)`` of the parameter vector."""
        lo = [b.thickness[0] for b in self.layers] + [b.vs[0] for b in self.layers]
        hi = [b.thickness[1] for b in self.layers] + [b.vs[1] for b in self.layers]
        if self.free_poisson:
            lo += [b.poisson[0] for b in self.layers]
            hi += [b.poisson[1] for b in self.layers]
        return np.asarray(lo, dtype=np.float64), np.asarray(hi, dtype=np.float64)

    def to_model(self, x01: torch.Tensor) -> LayeredModel:
        """Unit-cube vectors ``(*B, n_params)`` -> a LayeredModel with batch
        ``B``, in x01's dtype and on its device."""
        lo, hi = (torch.as_tensor(a, device=x01.device).to(x01.dtype)
                  for a in self.bounds_arrays())
        x = lo + (hi - lo) * torch.clamp(x01, 0.0, 1.0)
        n = self.n_layers
        d, vs = x[..., :n], x[..., n:2 * n]
        if self.free_poisson:
            nu = x[..., 2 * n:3 * n]
        else:
            nu = torch.tensor([b.poisson[0] for b in self.layers], dtype=x01.dtype,
                              device=x01.device)
        vp = vp_from_poisson(vs, nu)
        return LayeredModel(thickness=d, vp=vp, vs=vs, rho=self.density(vp))


def speed_model_spec() -> ModelSpec:
    """The 6-layer search space of inversion_diff_speed.ipynb cell 7
    (Poisson fixed at 0.4375)."""
    return ModelSpec(layers=(
        LayerBounds((0.001, 0.015), (0.1, 0.5)),
        LayerBounds((0.001, 0.015), (0.1, 0.5)),
        LayerBounds((0.005, 0.025), (0.2, 0.6)),
        LayerBounds((0.005, 0.025), (0.2, 0.6)),
        LayerBounds((0.02, 0.08), (0.4, 1.0)),
        LayerBounds((0.02, 0.08), (0.4, 1.0)),
    ))


def weight_model_spec() -> ModelSpec:
    """inversion_diff_weight.ipynb cell 7: thinner upper layers, free
    Poisson in [0.33, 0.49]."""
    nu = (0.33, 0.49)
    return ModelSpec(layers=(
        LayerBounds((0.001, 0.01), (0.1, 0.5), nu),
        LayerBounds((0.001, 0.01), (0.1, 0.5), nu),
        LayerBounds((0.001, 0.01), (0.2, 0.6), nu),
        LayerBounds((0.005, 0.025), (0.2, 0.6), nu),
        LayerBounds((0.02, 0.08), (0.4, 1.0), nu),
        LayerBounds((0.02, 0.08), (0.4, 1.0), nu),
    ))


def make_misfit_fn(spec: ModelSpec, curves: Sequence[Curve], n_grid: int = 400,
                   n_subdiv: int = 1, dtype=None, invalid: str = "penalty"):
    """``misfit(x01) -> (*B,)`` for unit-cube vectors ``(*B, n_params)``, on
    their device; autograd flows through it.

    The curves are packed once as one target of ``fleet.pack_curve_sets``
    and scored by ``fleet.make_packed_misfit_fn``: all (period, mode)
    samples in one root solve, each curve's RMSE a masked sum over its
    points.  ``dtype`` pins the observations' precision (None: float64).
    ``invalid``: ``"penalty"`` (a missing overtone point counts
    ``INVALID_RESIDUAL``) or ``"truncate"`` (it drops out of its curve's
    mean)."""
    # fleet builds on this module, so it is imported when the objective is made
    from das_diff_veh_tpu_torch.inversion.fleet import make_packed_misfit_fn, pack_curve_sets

    packed = make_packed_misfit_fn(spec, n_grid=n_grid, n_subdiv=n_subdiv, invalid=invalid)
    host = pack_curve_sets([curves], dtype=dtype, device="cpu").map(lambda a: a[0])
    on_device = {}

    def misfit(x01: torch.Tensor) -> torch.Tensor:
        dev = x01.device
        if dev not in on_device:
            on_device[dev] = host.map(lambda a: a.to(dev))
        return packed(x01, on_device[dev])

    return misfit


class InversionResult(NamedTuple):
    """Best model + the final ensemble (cf. evodcinv's ``res.model`` /
    ``res.models`` / ``res.misfits``), tensors on the search's device."""

    model: LayeredModel
    misfit: torch.Tensor
    x_best: torch.Tensor
    models_x: torch.Tensor     # (M, n_params) pooled pbest populations + refined
    misfits: torch.Tensor      # (M,)
    history: torch.Tensor      # (maxiter,) best-so-far misfit over the runs


def _as_data_misfit(fn):
    """``misfit(x01)`` closures take no observations: ``misfit(x01, data)``
    ignores ``data`` (the fleet's packed misfit uses it)."""
    return lambda x01, data: fn(x01)


def _eval_pop(misfit_fn, x: torch.Tensor, data, eval_chunk: int) -> torch.Tensor:
    """Misfits of ``x`` (*lead, pop, n_params); ``eval_chunk > 0`` evaluates
    that many members of the population axis at a time."""
    pop = x.shape[-2]
    with torch.no_grad():
        if eval_chunk <= 0 or eval_chunk >= pop:
            return misfit_fn(x, data)
        return torch.cat([misfit_fn(x[..., i:i + eval_chunk, :], data)
                          for i in range(0, pop, eval_chunk)], dim=-1)


def _take(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``a[..., g, :]`` (or ``a[..., g]``) per leading index."""
    if a.ndim == g.ndim + 2:
        return torch.gather(a, -2, g[..., None, None].expand(g.shape + (1, a.shape[-1])))[..., 0, :]
    return torch.gather(a, -1, g[..., None])[..., 0]


def pso_init(misfit_fn, u1: torch.Tensor, u2: torch.Tensor, data=None, x0=None,
             eval_chunk: int = 0):
    """Swarm state ``(x, v, pbest_x, pbest_f, gbest_x, gbest_f)`` from two
    uniform draws ``(*lead, pop, n_params)``; ``x0`` rows (clipped to the
    cube) replace the first members of every run."""
    x = u1.clone()
    if x0 is not None:
        m = min(x0.shape[0], x.shape[-2])
        x[..., :m, :] = torch.clamp(x0[:m].to(x.dtype), 0.0, 1.0)
    v = 0.1 * (u2 - 0.5)
    f = _eval_pop(misfit_fn, x, data, eval_chunk)
    g = torch.argmin(f, dim=-1)
    return (x, v, x, f, _take(x, g), _take(f, g))


def pso_step(misfit_fn, state, r: torch.Tensor, data=None, eval_chunk: int = 0):
    """One PSO step with the draws ``r`` (*lead, 2, pop, n_params) (the JAX
    package's ``uniform(key, (2, pop, n_params))`` per run).  Returns
    ``(state, gbest_f)``."""
    x, v, pbest_x, pbest_f, gbest_x, gbest_f = state
    v = (PSO_W * v + PSO_C1 * r[..., 0, :, :] * (pbest_x - x)
         + PSO_C2 * r[..., 1, :, :] * (gbest_x[..., None, :] - x))
    v = torch.clamp(v, -0.25, 0.25)
    x = torch.clamp(x + v, 0.0, 1.0)
    f = _eval_pop(misfit_fn, x, data, eval_chunk)
    better = f < pbest_f
    pbest_x = torch.where(better[..., None], x, pbest_x)
    pbest_f = torch.where(better, f, pbest_f)
    g = torch.argmin(pbest_f, dim=-1)
    cand_x, cand_f = _take(pbest_x, g), _take(pbest_f, g)
    improved = cand_f < gbest_f
    gbest_x = torch.where(improved[..., None], cand_x, gbest_x)
    gbest_f = torch.where(improved, cand_f, gbest_f)
    return (x, v, pbest_x, pbest_f, gbest_x, gbest_f), gbest_f


def adam_init(z: torch.Tensor):
    """Adam state ``(mu, nu, count)`` of a batch of starts."""
    return torch.zeros_like(z), torch.zeros_like(z), 0


def refine_step(misfit_fn, z: torch.Tensor, state, lr: float = 0.02, data=None):
    """One Adam step in logit space on every start of ``z`` (*lead, S,
    n_params).  Returns ``(z, state, loss)``."""
    zz = z.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = misfit_fn(torch.sigmoid(zz), data)
        (grad,) = torch.autograd.grad(loss.sum(), zz)
    grad = torch.where(torch.isfinite(grad), grad, 0.0)
    mu, nu, count = state
    mu = (1 - ADAM_B1) * grad + ADAM_B1 * mu
    nu = (1 - ADAM_B2) * (grad * grad) + ADAM_B2 * nu
    count += 1
    mu_hat = mu / (1 - ADAM_B1 ** count)
    nu_hat = nu / (1 - ADAM_B2 ** count)
    z = z + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
    return z, (mu, nu, count), loss.detach()


def _refine(misfit_fn, x0_batch: torch.Tensor, n_steps: int, lr: float = 0.02, data=None,
            refine_chunk: int = 0):
    """Multi-start Adam from ``x0_batch`` (*lead, S, n_params); ``refine_chunk``
    refines that many starts at a time.  Returns ``(x, misfits)``."""
    eps = 1e-4
    S = x0_batch.shape[-2]
    rc = refine_chunk if (refine_chunk and refine_chunk < S) else S
    xs, fs = [], []
    for i in range(0, S, rc):
        z = torch.logit(torch.clamp(x0_batch[..., i:i + rc, :], eps, 1.0 - eps))
        state = adam_init(z)
        for _ in range(n_steps):
            z, state, _ = refine_step(misfit_fn, z, state, lr, data)
        x = torch.sigmoid(z)
        xs.append(x)
        with torch.no_grad():
            fs.append(misfit_fn(x, data))
    return torch.cat(xs, dim=-2), torch.cat(fs, dim=-1)


def _run_generators(seeds: np.ndarray, device) -> list:
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds.reshape(-1)]


def _draw(gens: list, lead: tuple, shape: tuple, dtype, device) -> torch.Tensor:
    """One uniform draw of ``shape`` per run generator, stacked to ``lead``."""
    return torch.stack([torch.rand(shape, generator=g, dtype=dtype, device=device)
                        for g in gens]).reshape(lead + shape)


def _swarm(slots: list, popsize: int, n_params: int, maxiter: int, dtype,
           eval_chunk: int, x0):
    """Advance every slot's runs ``maxiter`` PSO steps, the slots in turns at
    each step (their devices' queues overlap).  A slot is a dict with
    ``misfit``, ``data``, ``gens``, ``lead`` and ``device``; returns its
    ``(state, history (*lead, maxiter))``."""
    states, hists = [], []
    for s in slots:
        dev = s["device"]
        u1 = _draw(s["gens"], s["lead"], (popsize, n_params), dtype, dev)
        u2 = _draw(s["gens"], s["lead"], (popsize, n_params), dtype, dev)
        xs = None if x0 is None else x0.to(dev)
        states.append(pso_init(s["misfit"], u1, u2, s["data"], xs, eval_chunk))
        hists.append([])
    for _ in range(maxiter):
        for i, s in enumerate(slots):
            r = _draw(s["gens"], s["lead"], (2, popsize, n_params), dtype, s["device"])
            states[i], gf = pso_step(s["misfit"], states[i], r, s["data"], eval_chunk)
            hists[i].append(gf)
    return [(st, torch.stack(h, dim=-1) if h else st[5].new_zeros(st[5].shape + (0,)))
            for st, h in zip(states, hists)]


def _pool_starts(state, k: int) -> torch.Tensor:
    """Each run's gbest then its ``k`` best pbest members, pooled over the
    runs: (*lead[:-1], runs * (k + 1), n_params)."""
    _, _, pop_x, pop_f, gbest_x, _ = state
    top = torch.argsort(pop_f, dim=-1, stable=True)[..., :k]
    picked = torch.gather(pop_x, -2, top[..., None].expand(top.shape + (pop_x.shape[-1],)))
    starts = torch.cat([gbest_x[..., None, :], picked], dim=-2)
    return starts.reshape(starts.shape[:-3] + (-1, starts.shape[-1]))


def _warm_starts(x0, dtype):
    """Warm-start rows as a host tensor of ``dtype``, cast through float64 as
    the JAX package does (a tensor on any device, or array-like)."""
    if x0 is None:
        return None
    if isinstance(x0, torch.Tensor):
        return x0.detach().cpu().to(torch.float64).to(dtype)
    return torch.as_tensor(np.array(x0, dtype=np.float64)).to(dtype)


def _slots_of(mesh, device) -> tuple:
    """``(every slot's device, this process's slots)``."""
    if mesh is None:
        return [resolve_device(device)], (0,)
    return list(mesh.devices), mesh.local_slots


def _on_root(mesh, home, what: str, fn, pack) -> list | None:
    """``fn()`` (a list, one entry per local slot); on a mesh across
    processes every rank's entries go to rank 0 through ``pack`` (to the
    host), in slot order, and the other ranks get None."""
    if mesh is None or not mesh.multiprocess:
        return fn()
    got = distributed.gather_objects([pack(e) for e in distributed.agreed(fn, what, home)])
    return None if got is None else [e for per_rank in got for e in per_rank]


def invert(spec: ModelSpec, curves: Sequence[Curve], *, popsize: int = 50, maxiter: int = 200,
           n_refine_starts: int = 8, n_refine_steps: int = 80, n_grid: int = 400,
           n_subdiv: int = 1, dtype=None, invalid: str = "penalty", seed: int = 0,
           misfit_fn=None, x0=None, device=None) -> InversionResult:
    """Swarm search + gradient refinement for a 1-D Vs profile:
    :func:`invert_multirun` with one run (the reference's EarthModel.invert
    role)."""
    return invert_multirun(spec, curves, n_runs=1, popsize=popsize, maxiter=maxiter,
                           n_refine_starts=n_refine_starts, n_refine_steps=n_refine_steps,
                           n_grid=n_grid, n_subdiv=n_subdiv, dtype=dtype, invalid=invalid,
                           seed=seed, misfit_fn=misfit_fn, x0=x0, device=device)


def invert_multirun(spec: ModelSpec, curves: Sequence[Curve], *, n_runs: int = 3,
                    popsize: int = 50, maxiter: int = 200, n_refine_starts: int = 8,
                    n_refine_steps: int = 80, n_grid: int = 400, n_subdiv: int = 1,
                    dtype=None, invalid: str = "penalty", seed: int = 0, chunk: int = 50,
                    eval_chunk: int = 0, refine_chunk: int = 0, misfit_fn=None, x0=None,
                    mesh=None, mesh_axis: str = "win",
                    device=None) -> InversionResult | None:
    """Best of ``n_runs`` swarms, every run advanced in one batched
    evaluation, on ``device`` (``None`` = the card; raises without one).

    ``eval_chunk`` / ``refine_chunk`` bound how many misfits / refinement
    starts evaluate together (0 = all).  ``chunk`` is the JAX package's host
    chunking of its compiled swarm loop; the port's loop is on the host
    already, so it is accepted and has no effect.  ``misfit_fn``: a prebuilt
    :func:`make_misfit_fn` objective.  ``x0``: ``(m, n_params)`` warm-start
    points placed first in every run's population.  ``mesh``: a
    ``parallel.Mesh`` whose slots take contiguous blocks of the runs
    (``mesh_axis`` is its only axis); run ``r`` draws from the generator
    seeded ``seed + r`` wherever it runs, so the result does not depend on
    the mesh.  On a mesh across processes every rank passes the same
    arguments; rank 0 returns the result, the other ranks ``None``."""
    del chunk, mesh_axis
    dtype = dtype or torch.float64
    if misfit_fn is None:
        misfit_fn = make_misfit_fn(spec, curves, n_grid=n_grid, n_subdiv=n_subdiv,
                                   dtype=dtype, invalid=invalid)
    fn = _as_data_misfit(misfit_fn)
    devs, local = _slots_of(mesh, device)
    home = devs[local[0]]
    blocks = np.array_split(np.arange(n_runs), len(devs))
    slots = [{"misfit": fn, "data": None, "device": devs[j], "lead": (len(blocks[j]),),
              "gens": _run_generators(seed + blocks[j], devs[j])}
             for j in local if len(blocks[j])]
    x0 = _warm_starts(x0, dtype)
    out = _on_root(mesh, home, "invert_multirun",
                   lambda: _swarm(slots, popsize, spec.n_params, maxiter, dtype, eval_chunk, x0),
                   lambda e: (tuple(a.cpu() for a in e[0]), e[1].cpu()))
    if out is None:
        return None
    states = [tuple(a.to(home) for a in st) for st, _ in out]
    state = tuple(torch.cat([st[i] for st in states], dim=0) for i in range(6))
    hist = torch.cat([h.to(home) for _, h in out], dim=0)
    starts = _pool_starts(state, min(n_refine_starts, popsize))
    ref_x, ref_f = _refine(fn, starts, n_refine_steps, refine_chunk=refine_chunk)
    all_x = torch.cat([state[2].reshape(-1, spec.n_params), ref_x], dim=0)
    all_f = torch.cat([state[3].reshape(-1), ref_f], dim=0)
    best = torch.argmin(all_f)
    x_best = all_x[best]
    return InversionResult(model=spec.to_model(x_best), misfit=all_f[best], x_best=x_best,
                           models_x=all_x, misfits=all_f, history=torch.amin(hist, dim=0))
