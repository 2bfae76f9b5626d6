"""The port's remaining ops (``ops/psd``, ``ops/cwt``, ``ops/enhance``), the
``enhance`` option of ``gather_disp_image``, and the configuration and
conversion helpers of the science path, against the JAX package on the CPU.

Inputs are seeded numpy handed to both packages at float64 (conftest runs
JAX with x64).  The Welch PSD is held at 1e-12 relative, the CWT and the
picker at 1e-10.

CLAHE and the box blur are integer results of a rounding.  CLAHE rounds
the float64 values of the JAX package's compiled CPU program (a reciprocal
product and fused multiply-adds, which the port evaluates exactly), so it is
held equal to JAX everywhere, and to an exact numpy oracle everywhere but at
exact ties (a value of k + 0.5), where float64 may round either way.  The
port's blur rounds the exact patch mean, the JAX package's a float32
convolution's, so the blur (and the enhancements that end in it) is held
equal to the exact oracle everywhere and to JAX everywhere but at exact
ties, where the two differ by at most one gray level.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das_diff_veh_tpu import config as J
from das_diff_veh_tpu.inversion import forward as JF
from das_diff_veh_tpu.models import vsg as JV
from das_diff_veh_tpu.ops import cwt as JCWT
from das_diff_veh_tpu.ops import enhance as JE
from das_diff_veh_tpu.ops import psd as JPSD
from das_diff_veh_tpu_torch import config as P
from das_diff_veh_tpu_torch import convert
from das_diff_veh_tpu_torch.inversion import forward as PF
from das_diff_veh_tpu_torch.models import vsg as PV
from das_diff_veh_tpu_torch.ops import cwt as PCWT
from das_diff_veh_tpu_torch.ops import enhance as PE
from das_diff_veh_tpu_torch.ops import psd as PPSD

RNG = np.random.default_rng(91)
CPU = "cpu"


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


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _clahe_oracle(img: np.ndarray, clip_limit: float, tiles):
    """(out, ties) of CLAHE in exact integer arithmetic: numpy's reflect
    pad, the LUTs as in the JAX package, and the bilinear interpolation
    numerator over its common denominator 4 * th * tw."""
    tx, ty = tiles
    H, W = img.shape
    th, tw = -(-H // ty), -(-W // tx)
    imgp = np.pad(img, ((0, ty * th - H), (0, tx * tw - W)), mode="reflect")
    tid = (np.arange(ty * th) // th)[:, None] * tx + (np.arange(tx * tw) // tw)[None, :]
    hist = np.bincount((tid * 256 + imgp).ravel(), minlength=ty * tx * 256).reshape(-1, 256)
    area = th * tw
    clip = max(int(clip_limit * area / 256.0), 1)
    cl = np.minimum(hist, clip)
    excess = (hist - cl).sum(1, keepdims=True)
    res = excess - (excess // 256) * 256
    step = np.maximum(256 // np.maximum(res, 1), 1)
    i = np.arange(256)[None]
    h2 = cl + excess // 256 + ((i % step == 0) & (i // step < res))
    luts = np.clip(np.round(np.cumsum(h2, 1) * (255.0 / area)), 0, 255).astype(np.int64)

    def axis(n, t):
        num = 2 * np.arange(n) + 1 - t
        lo = num // (2 * t)
        return lo, num - 2 * t * lo
    y1, wy = axis(H, th)
    x1, wx = axis(W, tw)
    yc = lambda a: np.clip(a, 0, ty - 1)[:, None]
    xc = lambda a: np.clip(a, 0, tx - 1)[None, :]
    at = lambda a, b: luts[a * tx + b, img]
    wy, wx = wy[:, None], wx[None, :]
    top = at(yc(y1), xc(x1)) * (2 * tw - wx) + at(yc(y1), xc(x1 + 1)) * wx
    bot = at(yc(y1 + 1), xc(x1)) * (2 * tw - wx) + at(yc(y1 + 1), xc(x1 + 1)) * wx
    num = top * (2 * th - wy) + bot * wy
    den = 4 * th * tw
    q, r = num // den, num % den
    q = q + ((2 * r > den) | ((2 * r == den) & (q % 2 == 1)))
    return np.clip(q, 0, 255).astype(np.int32), 2 * r == den


def _blur_oracle(eq: np.ndarray, ksize: int = 10):
    """(out, ties) of the box blur from exact integer patch sums
    (reflect-101, anchor ``ksize//2``), rounded half to even."""
    a, b = ksize // 2, ksize - 1 - ksize // 2
    p = np.concatenate([eq[1:1 + a][::-1], eq, eq[-1 - b:-1][::-1]], axis=0)
    p = np.concatenate([p[:, 1:1 + a][:, ::-1], p, p[:, -1 - b:-1][:, ::-1]], axis=1)
    win = np.lib.stride_tricks.sliding_window_view(p.astype(np.int64), (ksize, ksize))
    s, den = win.sum(axis=(-2, -1)), ksize * ksize
    q, r = s // den, s % den
    q = q + ((2 * r > den) | ((2 * r == den) & (q % 2 == 1)))
    return np.clip(q, 0, 255).astype(np.int32), 2 * r == den


def _equal_but_ties(port, jax_out, oracle, ties):
    """``port`` equals ``oracle``, and ``jax_out`` everywhere but at
    ``ties``, where the two differ by at most 1."""
    port, jax_out = np.asarray(port), np.asarray(jax_out)
    assert port.dtype == np.int32 and jax_out.dtype == np.int32
    np.testing.assert_array_equal(port, oracle)
    d = np.abs(port.astype(np.int64) - jax_out)
    assert (d[~ties] == 0).all(), int((d[~ties] != 0).sum())
    assert d.max() <= 1


# -- Welch PSD ---------------------------------------------------------------

@pytest.mark.parametrize("shape,nperseg,noverlap,nfft", [
    ((3, 4, 1000), 256, None, None),
    ((2, 5, 777), 200, 50, 256),
    ((6, 301), 2048, None, None),          # nperseg shrinks to the signal
])
def test_welch_psd_matches_jax(shape, nperseg, noverlap, nfft):
    x = RNG.standard_normal(shape)
    fj, pj = JPSD.welch_psd(jnp.asarray(x), 250.0, nperseg, noverlap, nfft)
    fp, pp = PPSD.welch_psd(torch.as_tensor(x), 250.0, nperseg, noverlap, nfft)
    np.testing.assert_allclose(fp, np.asarray(fj), rtol=1e-12, atol=0)
    np.testing.assert_allclose(pp.numpy(), np.asarray(pj), rtol=1e-12, atol=0)


def test_stack_avg_psd_matches_jax():
    x = RNG.standard_normal((4, 6, 900))
    fj, aj, wj = JPSD.stack_avg_psd(jnp.asarray(x), 250.0, nperseg=300)
    fp, ap, wp = PPSD.stack_avg_psd(torch.as_tensor(x), 250.0, nperseg=300)
    np.testing.assert_allclose(fp, np.asarray(fj), rtol=1e-12, atol=0)
    np.testing.assert_allclose(ap.numpy(), np.asarray(aj), rtol=1e-12, atol=0)
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=1e-12, atol=0)


def test_welch_psd_refuses_what_jax_refuses():
    x = torch.zeros(10, dtype=torch.float64)
    with pytest.raises(ValueError, match="nfft"):
        PPSD.welch_psd(x, 1.0, nperseg=8, nfft=4)
    with pytest.raises(ValueError, match="noverlap"):
        PPSD.welch_psd(x, 1.0, nperseg=8, noverlap=8)


# -- CWT ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(512,), (3, 700)])
def test_cwt_morlet_matches_jax(shape):
    x = RNG.standard_normal(shape)
    freqs = JCWT.log_freqs(2.0, 20.0, 24)
    np.testing.assert_array_equal(PCWT.log_freqs(2.0, 20.0, 24), freqs)
    cj = np.asarray(JCWT.cwt_morlet(jnp.asarray(x), 250.0, freqs))
    cp = PCWT.cwt_morlet(torch.as_tensor(x), 250.0, freqs).numpy()
    assert cp.shape == cj.shape and cp.dtype == np.complex128
    assert _rel(cp, cj) < 1e-10


def test_pick_travel_times_matches_jax():
    dt, nt = 1 / 250.0, 2000
    t = np.arange(nt) * dt
    taus = np.array([0.4, 0.8, 1.6, 2.2])
    g = np.stack([np.cos(2 * np.pi * 12.0 * (t - nt // 2 * dt - tau))
                  * np.exp(-0.5 * ((t - nt // 2 * dt - tau) / 0.15) ** 2) for tau in taus])
    g = g + 0.05 * RNG.standard_normal(g.shape)
    tj, fj = JCWT.pick_travel_times(jnp.asarray(g), dt, pick_freq=12.0)
    tp, fp = PCWT.pick_travel_times(torch.as_tensor(g), dt, pick_freq=12.0)
    assert fp == fj
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), rtol=1e-10, atol=0)
    np.testing.assert_allclose(tp.numpy(), taus, atol=0.05)


# -- CLAHE, blur, enhance ----------------------------------------------------

@pytest.mark.parametrize("shape,tiles,clip", [
    ((200, 121), (20, 5), 100.0),
    ((1000, 242), (100, 10), 100.0),     # the reference's grid on a full f-v map
    ((37, 23), (100, 10), 40.0),         # more tiles than pixels: repeated reflection
    ((64, 64), (8, 8), 2.0),             # a low clip limit: the residual walk
])
def test_clahe_u8_equals_jax_but_exact_ties(shape, tiles, clip):
    """Equal to JAX everywhere; equal to the exact oracle but at its ties."""
    img = (np.abs(RNG.standard_normal(shape)) * 60).clip(0, 255).astype(np.int32)
    oracle, ties = _clahe_oracle(img, clip, tiles)
    got = PE.clahe_u8(torch.as_tensor(img), clip, tiles)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(JE.clahe_u8(jnp.asarray(img), clip,
                                                                      tiles)))
    _equal_but_ties(oracle, got.numpy(), oracle, ties)


def test_fma_rounds_once():
    """The emulated fused multiply-add against exact rational arithmetic,
    on random magnitudes, near-cancelling sums and the dyadic values of
    CLAHE's blends."""
    from fractions import Fraction
    rng = np.random.default_rng(5)
    n = 3000
    a = rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
    b = rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
    c = -a * b * (1 + rng.standard_normal(n) * np.exp(rng.uniform(-60, 0, n)))
    c[::3] = rng.standard_normal(len(c[::3]))
    a[:500] = rng.integers(0, 256, 500)
    b[:500] = rng.integers(0, 2 ** 20, 500) / 2 ** 20
    c[:500] = rng.integers(0, 2 ** 30, 500) / 2 ** 31
    got = PE._fma(*(torch.as_tensor(v) for v in (a, b, c))).numpy()
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got, want)
    assert (a * b + c != want).any()          # the inputs reach double rounding


@pytest.mark.parametrize("shape,ksize", [((120, 90), 10), ((1000, 242), 10), ((50, 40), 7)])
def test_box_blur_u8_equals_jax_but_exact_ties(shape, ksize):
    img = RNG.integers(0, 256, size=shape).astype(np.int32)
    oracle, ties = _blur_oracle(img, ksize)
    _equal_but_ties(PE.box_blur_u8(torch.as_tensor(img), ksize),
                    JE.box_blur_u8(jnp.asarray(img), ksize), oracle, ties)


def _enhance_oracle(fv: np.ndarray, tiles=(100, 10)):
    """(out, ties) of fv_map_enhance: the uint8 quantisation and CLAHE as
    the JAX package computes them (the port equals both), then the exact
    blur and its ties."""
    u8 = np.clip((fv - fv.min()) / fv.max() * 255.0, 0, 255).astype(np.int32)
    return _blur_oracle(np.asarray(JE.clahe_u8(jnp.asarray(u8), 100.0, tiles)))


def test_fv_map_enhance_equals_jax_but_exact_ties():
    fv = np.abs(RNG.standard_normal((1000, 242))) + 0.05
    oracle, ties = _enhance_oracle(fv)
    _equal_but_ties(PE.fv_map_enhance(torch.as_tensor(fv)), JE.fv_map_enhance(jnp.asarray(fv)),
                    oracle, ties)


def test_fv_map_enhance_constant_map_is_finite():
    out = PE.fv_map_enhance(torch.zeros((30, 20), dtype=torch.float64), tiles=(5, 3))
    assert out.dtype == torch.int32 and int(out.min()) >= 0 and int(out.max()) <= 255


def test_gather_disp_image_enhance_equals_jax_but_exact_ties():
    xcf = RNG.standard_normal((30, 64))
    offs = np.linspace(-150.0, 70.0, 30)
    jcfg = J.DispersionConfig(freq_step=0.5, vel_step=10.0)
    pcfg = P.DispersionConfig(freq_step=0.5, vel_step=10.0)
    want = JV.gather_disp_image(jnp.asarray(xcf), offs, 0.004, 8.16, jcfg, -150.0, 0.0,
                                enhance=True)
    got = PV.gather_disp_image(torch.as_tensor(xcf), offs, 0.004, 8.16, pcfg, -150.0, 0.0,
                               enhance=True)
    img = PV.gather_disp_image(torch.as_tensor(xcf), offs, 0.004, 8.16, pcfg, -150.0, 0.0)
    oracle, ties = _enhance_oracle(img.numpy())
    _equal_but_ties(got, want, oracle, ties)


# -- configuration and conversion --------------------------------------------

def test_science_configs_round_trip():
    jcfg = J.PipelineConfig().replace(
        bootstrap=J.BootstrapConfig(bt_times=8, sigma=(35.0,), ref_freq_idx=(87,),
                                    freq_lb=(3.5,), freq_ub=(10.0,)),
        fleet=J.FleetInversionConfig(target_chunk=4, eval_chunk=10))
    d = dataclasses.asdict(jcfg)
    pcfg = convert.config_from_dict(d)
    assert dataclasses.asdict(pcfg) == d
    assert pcfg.bootstrap.freq_lb == (3.5,) and pcfg.fleet.target_chunk == 4
    # a JSON round trip turns the tuples into lists; the port keeps tuples
    d["bootstrap"] = {k: list(v) if isinstance(v, tuple) else v
                      for k, v in d["bootstrap"].items()}
    assert convert.config_from_dict(d).bootstrap == pcfg.bootstrap


def test_layered_model_and_spec_from_numpy_give_jax_phase_velocity():
    vs = jnp.asarray([0.22, 0.38, 0.52, 0.8])
    vp = JF.vp_from_poisson(vs, 0.4375)
    jm = JF.LayeredModel(jnp.asarray([0.006, 0.012, 0.03, 0.0]), vp, vs,
                         JF.density_gardner_linear(vp))
    pm = convert.layered_model_from_numpy(*(np.asarray(a) for a in jm), device=CPU)
    assert pm.vs.dtype == torch.float64 and pm.vs.device.type == "cpu"
    T = np.linspace(0.04, 0.4, 15)
    for mode in (0, 1, 2):
        cj = np.asarray(JF.phase_velocity(jnp.asarray(T), jm, mode=mode, n_grid=300))
        cp = PF.phase_velocity(T, pm, mode=mode, n_grid=300).numpy()
        np.testing.assert_array_equal(np.isnan(cp), np.isnan(cj))
        ok = ~np.isnan(cj)
        np.testing.assert_allclose(cp[ok], cj[ok], rtol=1e-12, atol=0)
    from das_diff_veh_tpu.inversion import speed_model_spec
    jspec = speed_model_spec()
    pspec = convert.model_spec_from_bounds([b.thickness for b in jspec.layers],
                                           [b.vs for b in jspec.layers])
    x = RNG.uniform(0, 1, 12)
    jmodel = jspec.to_model(jnp.asarray(x))
    pmodel = pspec.to_model(torch.as_tensor(x))
    for a, b in zip(jmodel, pmodel):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
