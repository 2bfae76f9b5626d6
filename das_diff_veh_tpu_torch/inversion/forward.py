"""Differentiable Rayleigh-wave phase-velocity forward model (mirrors
``das_diff_veh_tpu/inversion/forward.py``; the role of the reference's
``disba`` surf96 secular function).

The P-SV field ``y = (V, W, S, T)`` obeys ``y' = A y`` with a real 4x4
matrix per layer.  Each layer's propagator ``expm(A d)`` is a cubic in ``A``
whose coefficients are entire functions of the squared vertical wavenumbers
(``_scaled_trig``), pre-scaled by ``e^-s`` so nothing overflows.  The two
free-surface solutions are propagated as the antisymmetric bivector
``Wg <- M Wg M^T`` (the 2x2 minors Dunkin's delta matrix tracks), projected
back onto the symplectic constraint and Frobenius-normalised after every
layer.  The secular function is the determinant ``det[vp, vs, y1, y2]``
against the halfspace's two decaying eigenvectors; modes are its roots.

Batching is explicit.  A model's fields may carry leading batch dimensions
``B`` (a population is ``(B, n_layers)``); ``c`` and ``omega`` then carry
``B`` as their leading dimensions, and the recursion is a Python loop over
the layers on ``(*B, ..., 4, 4)`` tensors.  Every operation is elementwise
or a gather: the 4x4 products are four products and three sums of
broadcast slices, and the Frobenius norm adds its 16 squares pairwise.  So a
member's value does not depend on the batch it is evaluated in, which keeps
a chaotic swarm on the same trajectory whatever the batch composition (the
fleet on one slot and on a mesh).

The root solve (:func:`phase_velocity`) scans each member's own grid
``lo + (hi - lo) * grid`` for sign changes, narrows the bracket by
subdivision and ends with one regula-falsi step.  The scan and the
subdivision run without autograd: their outputs are integer picks of
constants (``lax.stop_gradient`` in the JAX package), so the root's gradient
flows only through the final step's two secular values (the implicit
function theorem).

Units follow disba: km, km/s, g/cm^3, periods in seconds.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from das_diff_veh_tpu_torch.core.constants import device_constant
from das_diff_veh_tpu_torch.ops.filters import median


class LayeredModel(NamedTuple):
    """1-D layered elastic model; the last entry is the halfspace.

    Fields are ``(*B, n_layers)`` tensors: ``thickness`` (km; the last value
    is ignored), ``vp``/``vs`` (km/s), ``rho`` (g/cm^3)."""

    thickness: torch.Tensor
    vp: torch.Tensor
    vs: torch.Tensor
    rho: torch.Tensor


def vp_from_poisson(vs: torch.Tensor, nu) -> torch.Tensor:
    """P velocity from S velocity and Poisson's ratio:
    ``vp/vs = sqrt((2-2nu)/(1-2nu))`` (nu = 0.4375 gives vp = 3 vs)."""
    if isinstance(nu, torch.Tensor):
        return vs * torch.sqrt((2.0 - 2.0 * nu) / (1.0 - 2.0 * nu))
    return vs * math.sqrt((2.0 - 2.0 * nu) / (1.0 - 2.0 * nu))


def density_gardner_linear(vp: torch.Tensor) -> torch.Tensor:
    """The reference's density law ``rho = 1.56 + 0.186 vp`` (g/cm^3)."""
    return 1.56 + 0.186 * vp


# -- entire-function building blocks ----------------------------------------


def _sqrt_relu(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) with a zero (not NaN) gradient on x <= 0: the inner
    ``where`` keeps the inactive branch's sqrt away from 0 and below."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _scaled_trig(x: torch.Tensor, s: torch.Tensor):
    """(cosh(sqrt(x)) e^-s, sinh(sqrt(x))/sqrt(x) e^-s), continued to x < 0
    as cos/sinc; every branch is grad-safe as in the JAX package."""
    pos = x >= 0
    big = x >= 1e-8
    neg = x <= -1e-8
    xr = _sqrt_relu(x)
    xn = torch.sqrt(torch.where(neg, -x, 1.0))
    ep = torch.exp(xr - s)
    en = torch.exp(-xr - s)
    es = torch.exp(-s)
    series = (1.0 + x / 6.0) * es
    c_pos = 0.5 * (ep + en)
    s_pos = torch.where(big, 0.5 * (ep - en) / torch.where(big, xr, 1.0), series)
    c_neg = torch.cos(xn) * es
    s_neg = torch.where(neg, torch.sin(xn) / xn * es, series)
    cv = torch.where(pos, c_pos, c_neg)
    sv = torch.where(pos, s_pos, torch.where(neg, s_neg, series))
    return cv, sv


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by halving (zero-padded to a power of two):
    elementwise adds only, so the order does not depend on the batch."""
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (p - n,))], dim=-1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


# -- layer system, entry by entry ---------------------------------------------
#
# A 4x4 matrix is a dict {(i, j): field} of its nonzero entries and an
# antisymmetric bivector a dict {(i, j): field} over i < j (BIV), every field
# a tensor of the batch shape.  A has the checkerboard pattern of its odd
# entries (i + j odd), so A^2 is even and A^3 odd.

BIV = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_ODD = ((0, 1), (0, 3), (1, 0), (1, 2), (2, 1), (2, 3), (3, 0), (3, 2))
_EVEN = ((0, 0), (0, 2), (1, 1), (1, 3), (2, 0), (2, 2), (3, 1), (3, 3))


def _layer_A_entries(k, omega, vp, vs, rho, stress_scale=1.0) -> dict:
    """The eight nonzero entries of the real coefficient matrix of y' = A y
    for y = (V, W, S, T) (the JAX package's ``_layer_A``): eigenvalues
    +-k nu_p, +-k nu_s.  ``stress_scale`` nondimensionalises (S, T)."""
    mu = rho * vs * vs
    lam = rho * (vp * vp - 2.0 * vs * vs)
    lam2mu = lam + 2.0 * mu
    zeta = 4.0 * mu * (lam + mu) / lam2mu
    rw2 = rho * omega * omega * torch.ones_like(k)
    s0 = stress_scale * torch.ones_like(k)
    return {(0, 1): k, (0, 3): s0 / mu, (1, 0): -lam * k / lam2mu, (1, 2): s0 / lam2mu,
            (2, 1): -rw2 / s0, (2, 3): -k, (3, 0): (k * k * zeta - rw2) / s0,
            (3, 2): lam * k / lam2mu}


def _sparse_mm(a: dict, b: dict, out_keys) -> dict:
    """Entries ``out_keys`` of the product of two sparse 4x4 matrices, the
    terms summed in k order."""
    out = {}
    for i, j in out_keys:
        acc = None
        for m in range(4):
            if (i, m) in a and (m, j) in b:
                t = a[(i, m)] * b[(m, j)]
                acc = t if acc is None else acc + t
        out[(i, j)] = acc
    return out


def _layer_propagator_entries(k, omega, d, vp, vs, rho, stress_scale=1.0) -> dict:
    """``e^-s expm(A d)`` entry by entry: c0 I + c1 A + c2 A^2 + c3 A^3 with
    coefficients from cosh/sinh on A's eigenvalue pairs (+-a, +-b),
    a^2 = k^2 - omega^2/vp^2, b^2 = k^2 - omega^2/vs^2 (times d^2)."""
    a2 = (k * k - (omega / vp) ** 2) * d * d
    b2 = (k * k - (omega / vs) ** 2) * d * d
    # common scale e^-s, s a smooth upper bound on max(|a|, |b|): a positive
    # factor (roots and signs unchanged) with no kink where the root polish
    # needs a slope
    s = torch.logaddexp(_sqrt_relu(a2), _sqrt_relu(b2))
    ca, sa = _scaled_trig(a2, s)
    cb, sb = _scaled_trig(b2, s)
    denom = a2 - b2           # = omega^2 d^2 (1/vs^2 - 1/vp^2) > 0 (vp > vs)
    c2 = (ca - cb) / denom
    c0 = ca - c2 * a2
    c3 = (sa - sb) / denom
    c1 = sa - c3 * a2
    Ad = {ij: v * d for ij, v in _layer_A_entries(k, omega, vp, vs, rho, stress_scale).items()}
    Ad2 = _sparse_mm(Ad, Ad, _EVEN)
    Ad3 = _sparse_mm(Ad, Ad2, _ODD)
    M = {ij: c1 * Ad[ij] + c3 * Ad3[ij] for ij in _ODD}
    for i, j in _EVEN:
        M[(i, j)] = c0 + c2 * Ad2[(i, j)] if i == j else c2 * Ad2[(i, j)]
    return M


def _dense(entries: dict, shape, dtype, device) -> torch.Tensor:
    out = torch.zeros(tuple(shape) + (4, 4), dtype=dtype, device=device)
    for (i, j), v in entries.items():
        out[..., i, j] = v
    return out


def _bcast(k, *xs):
    k = torch.as_tensor(k)
    shape = torch.broadcast_shapes(k.shape, *(torch.as_tensor(x).shape for x in xs))
    return k.expand(shape)


def _layer_A(k, omega, vp, vs, rho, stress_scale=1.0) -> torch.Tensor:
    """A as a dense ``(..., 4, 4)`` tensor (for tests)."""
    k = _bcast(k, omega, vp, vs, rho, stress_scale)
    e = _layer_A_entries(k, omega, vp, vs, rho, stress_scale)
    return _dense({ij: v.expand(k.shape) for ij, v in e.items()}, k.shape, k.dtype, k.device)


def _layer_propagator(k, omega, d, vp, vs, rho, stress_scale=1.0) -> torch.Tensor:
    """``e^-s expm(A d)`` as a dense ``(..., 4, 4)`` tensor (for tests)."""
    k = _bcast(k, omega, d, vp, vs, rho, stress_scale)
    M = _layer_propagator_entries(k, omega, d, vp, vs, rho, stress_scale)
    return _dense({ij: v.expand(k.shape) for ij, v in M.items()}, k.shape, k.dtype, k.device)


def _propagate(M: dict, W: dict) -> dict:
    """The bivector ``M W M^T`` (W antisymmetric, so only i < j are kept)."""
    def w(i, j):
        return W[(i, j)] if i < j else -W[(j, i)]
    T = {}
    for i in range(4):
        for j in range(4):
            acc = None
            for m in range(4):
                if m != j:
                    t = M[(i, m)] * w(m, j)
                    acc = t if acc is None else acc + t
            T[(i, j)] = acc
    out = {}
    for i, j in BIV:
        acc = T[(i, 0)] * M[(j, 0)]
        for m in range(1, 4):
            acc = acc + T[(i, m)] * M[(j, m)]
        out[(i, j)] = acc
    return out


def _project_symplectic(W: dict) -> dict:
    """Project onto the symplectic constraint W[0,3] + W[1,2] = 0."""
    delta = 0.5 * (W[(0, 3)] + W[(1, 2)])
    out = dict(W)
    out[(0, 3)] = W[(0, 3)] - delta
    out[(1, 2)] = W[(1, 2)] - delta
    return out


def _fro_normalise(W: dict) -> dict:
    """Divide by the Frobenius norm of the full antisymmetric matrix (twice
    the upper squares, added in a fixed order): smooth in c, no max kink."""
    sq = [W[ij] * W[ij] for ij in BIV]
    n = torch.sqrt(2.0 * (((sq[0] + sq[1]) + (sq[2] + sq[3])) + (sq[4] + sq[5])))
    n = n + torch.finfo(n.dtype).tiny
    return {ij: v / n for ij, v in W.items()}


def _halfspace_bivector(k, omega, vp, vs, rho, stress_scale=1.0) -> dict:
    """v_p ^ v_s of the halfspace's two downward-decaying eigenvectors
    (c < vs), projected onto the symplectic constraint."""
    c = omega / k
    mu = rho * vs * vs
    nup = torch.sqrt(torch.clamp(1.0 - (c / vp) ** 2, min=1e-12))
    nus = torch.sqrt(torch.clamp(1.0 - (c / vs) ** 2, min=1e-12))
    s0 = stress_scale * torch.ones_like(k)
    one = torch.ones_like(k)
    v1 = (one, nup, -rho * k * (2.0 * vs * vs - c * c) / s0, -2.0 * mu * k * nup / s0)
    v2 = (nus, one, -2.0 * mu * k * nus / s0, -mu * k * (2.0 - (c / vs) ** 2) / s0)
    return _project_symplectic({(i, j): v1[i] * v2[j] - v2[i] * v1[j] for i, j in BIV})


def _result_dtype(*xs) -> torch.dtype:
    """``jnp.result_type`` of the arguments, Python scalars weak."""
    dt = None
    for x in xs:
        if isinstance(x, torch.Tensor):
            d = x.dtype
        elif isinstance(x, np.ndarray):
            d = torch.from_numpy(np.zeros(0, dtype=x.dtype)).dtype
        else:
            continue
        dt = d if dt is None else torch.promote_types(dt, d)
    return dt if dt is not None else torch.get_default_dtype()


def secular(c, omega, model: LayeredModel) -> torch.Tensor:
    """Rayleigh secular function D(c, omega), zero at the modal phase
    velocities; sign-normalised per layer so values stay O(1).

    ``c`` and ``omega`` broadcast together; a model with batch dimensions
    ``B`` pairs them with the leading ``len(B)`` dimensions of ``c``."""
    dev = model.vs.device
    dt = _result_dtype(c, omega, model.vs)
    c = torch.as_tensor(c, device=dev).to(dt)
    omega = torch.as_tensor(omega, device=dev).to(dt)
    B = tuple(model.vs.shape[:-1])
    extra = max(c.ndim, omega.ndim) - len(B)
    if extra < 0:
        raise ValueError(f"c/omega of {max(c.ndim, omega.ndim)} dims cannot carry the "
                         f"model's batch {B}")
    shape = torch.broadcast_shapes(c.shape, omega.shape, B + (1,) * extra)
    c, omega = c.expand(shape), omega.expand(shape)
    p = lambda a, i: a[..., i].to(dt).reshape(B + (1,) * extra)
    k = omega / c
    # global stress nondimensionalisation (see _layer_A_entries): mu_1 * k
    s0 = p(model.rho, 0) * p(model.vs, 0) * p(model.vs, 0) * k
    zero = torch.zeros_like(k)
    W = {ij: zero for ij in BIV}
    W[(0, 1)] = torch.ones_like(k)
    for i in range(model.vs.shape[-1] - 1):
        M = _layer_propagator_entries(k, omega, p(model.thickness, i), p(model.vp, i),
                                      p(model.vs, i), p(model.rho, i), s0)
        # the elastic ODE conserves W[0,3] + W[1,2] (0 for the free-surface
        # pair): project its round-off drift back out after every layer
        W = _fro_normalise(_project_symplectic(_propagate(M, W)))
    V = _fro_normalise(_halfspace_bivector(k, omega, p(model.vp, -1), p(model.vs, -1),
                                           p(model.rho, -1), s0))
    # det[v_p, v_s, y1, y2] = sum over i<j of sign * V_ij W_complement
    return (V[(0, 1)] * W[(2, 3)] - V[(0, 2)] * W[(1, 3)] + V[(0, 3)] * W[(1, 2)]
            + V[(1, 2)] * W[(0, 3)] - V[(1, 3)] * W[(0, 2)] + V[(2, 3)] * W[(0, 1)])


# -- root finding ------------------------------------------------------------


def _unit_grid(n: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` (numpy's formula, built in float64)."""
    return device_constant(("unit_grid", n), lambda: np.linspace(0.0, 1.0, n), dtype, device)


def _first_flip(Df: torch.Tensor) -> torch.Tensor:
    s = torch.sign(Df)
    return torch.argmax(((s[..., :-1] * s[..., 1:]) < 0).to(torch.int8), dim=-1)


def _scan_setup(periods, model: LayeredModel, cmin, cmax):
    """(omega, lo, hi, periods shape) with the model's batch leading."""
    dev = model.vs.device
    if not isinstance(periods, torch.Tensor):
        periods = torch.as_tensor(np.array(periods, dtype=np.float64))
    periods = torch.atleast_1d(periods.to(dev))
    wdt = torch.promote_types(periods.dtype, model.vs.dtype)
    B = tuple(model.vs.shape[:-1])
    shape_t = torch.broadcast_shapes(periods.shape, B + (1,))
    omega = (2.0 * math.pi / periods).to(wdt).expand(shape_t)
    with torch.no_grad():
        lo = 0.7 * torch.amin(model.vs, dim=-1) if cmin is None else cmin
        hi = 0.999 * model.vs[..., -1] if cmax is None else cmax
        lo = torch.as_tensor(lo, device=dev).to(wdt).detach().expand(B)
        hi = torch.as_tensor(hi, device=dev).to(wdt).detach().expand(B)
    return omega, lo, hi, shape_t, wdt


def phase_velocity(periods, model: LayeredModel, mode=0, cmin=None, cmax=None,
                   n_grid: int = 1200, n_subdiv: int = 3, subdiv_pts: int = 16) -> torch.Tensor:
    """Modal Rayleigh phase velocities c(T), on the model's device.

    ``periods`` (nT,) or broadcastable to ``(*B, nT)``; ``mode`` 0 is
    fundamental, a scalar or per period (modes 0, 3 and 4 in one solve).
    NaN where the overtone does not exist at that period.  The scan grid of
    ``n_grid`` points spans each member's own ``[0.7 min vs, 0.999 vs_half]``;
    ``n_subdiv`` rounds of ``subdiv_pts``-ary subdivision narrow the bracket;
    a final regula-falsi step carries the gradient."""
    omega, lo, hi, shape_t, wdt = _scan_setup(periods, model, cmin, cmax)
    dev = model.vs.device
    B = tuple(model.vs.shape[:-1])
    mode_arr = torch.as_tensor(mode, device=dev).expand(shape_t)
    with torch.no_grad():
        grid = _unit_grid(n_grid, wdt, dev)
        subgrid = _unit_grid(subdiv_pts, wdt, dev)
        cs = lo[..., None] + (hi - lo)[..., None] * grid                 # (*B, n_grid)
        Ds = secular(cs[..., None, :], omega[..., :, None], model)      # (*B, nT, n_grid)
        sign = torch.sign(Ds)
        flips = (sign[..., :-1] * sign[..., 1:]) < 0
        order = torch.cumsum(flips.to(torch.int32), dim=-1)
        hit = flips & (order == (mode_arr[..., None] + 1))
        valid = torch.any(hit, dim=-1)
        idx = torch.argmax(hit.to(torch.int8), dim=-1)                  # (*B, nT)
        csb = cs.expand(shape_t[:-1] + (n_grid,)) if len(shape_t) > len(B) + 1 else cs
        c_lo = torch.gather(csb, -1, idx)
        c_hi = torch.gather(csb, -1, idx + 1)
        for _ in range(n_subdiv):
            cf = c_lo[..., None] + (c_hi - c_lo)[..., None] * subgrid
            j = _first_flip(secular(cf, omega[..., None], model))[..., None]
            c_lo = torch.gather(cf, -1, j)[..., 0]
            c_hi = torch.gather(cf, -1, j + 1)[..., 0]
        w = c_hi - c_lo
    # one differentiable secular evaluation at both ends (implicit function theorem)
    D2 = secular(torch.stack([c_lo, c_hi], dim=-1), omega[..., None], model)
    D_lo, D_hi = D2[..., 0], D2[..., 1]
    denom = (D_hi - D_lo).detach()
    denom = torch.where(torch.abs(denom) > 0, denom, 1.0)
    step = torch.minimum(torch.clamp(-D_lo * w / denom, min=0.0), w)
    return torch.where(valid, c_lo + step, torch.nan)


def scan_mode_diagnostics(periods, model: LayeredModel, cmin=None, cmax=None,
                          n_grid: int = 1200, refine_factor: int = 4,
                          rel_floor: float = 0.05) -> dict:
    """Mode-miss guard for the sign-change scan: per period ``count`` (sign
    changes at ``n_grid``), ``count_refined`` (at ``refine_factor *
    n_grid``), ``missed`` (the latter larger) and ``dip`` (an interior |D|
    minimum below ``rel_floor x median |D|`` with no adjacent sign change)."""
    omega, lo, hi, _, wdt = _scan_setup(periods, model, cmin, cmax)
    dev = model.vs.device

    def scan_counts(n):
        cs = lo[..., None] + (hi - lo)[..., None] * _unit_grid(n, wdt, dev)
        Ds = secular(cs[..., None, :], omega[..., :, None], model)
        s = torch.sign(Ds)
        flips = (s[..., :-1] * s[..., 1:]) < 0
        return Ds, flips, flips.sum(-1)

    with torch.no_grad():
        Ds, flips, count = scan_counts(n_grid)
        _, _, count_refined = scan_counts(refine_factor * n_grid)
        absD = torch.abs(Ds)
        interior_min = (absD[..., 1:-1] <= absD[..., :-2]) & (absD[..., 1:-1] <= absD[..., 2:])
        no_flip = ~(flips[..., :-1] | flips[..., 1:])
        floor = rel_floor * median(absD, dim=-1, keepdim=True)
        dip = torch.any(interior_min & no_flip & (absD[..., 1:-1] < floor), dim=-1)
    return {"count": count, "count_refined": count_refined,
            "missed": count_refined > count, "dip": dip}


def rayleigh_halfspace_velocity(vp, vs) -> float:
    """Analytic homogeneous-halfspace Rayleigh speed (test oracle): the root
    of the Rayleigh polynomial in x = (c/vs)^2."""
    vp, vs = float(vp), float(vs)
    g = (vs / vp) ** 2
    roots = np.roots([1.0, -8.0, 24.0 - 16.0 * g, -16.0 * (1.0 - g)])
    real = roots[np.abs(roots.imag) < 1e-9].real
    x = real[(real > 0) & (real < 1)]
    return float(vs * np.sqrt(x.min()))
