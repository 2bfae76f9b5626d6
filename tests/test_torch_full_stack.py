"""The port's copy of tests/test_full_stack.py: a known Vs model -> its
recovered Vs profile, through the port alone on the CPU at float64.

    synthesize -> process_chunk -> per-window virtual shot gathers ->
    bootstrap ridges -> curves -> swarm + Adam inversion

The scene, the budget and the assertions are the JAX test's: Vs within 10 %
and 20 %, the first layer's thickness within 40 %, misfit < 1.5, the
median ridge error < 8 % and the closure error < 5 %.  The search draws from
the port's own random stream, so the recovered numbers are not JAX's.
"""

import numpy as np
import torch

from das_diff_veh_tpu_torch.analysis.bootstrap import bootstrap_disp, sample_indices
from das_diff_veh_tpu_torch.config import BootstrapConfig, ImagingConfig, PipelineConfig
from das_diff_veh_tpu_torch.inversion.curves import curves_from_ridges
from das_diff_veh_tpu_torch.inversion.forward import (LayeredModel, density_gardner_linear,
                                                      phase_velocity, vp_from_poisson)
from das_diff_veh_tpu_torch.inversion.invert import LayerBounds, ModelSpec, invert
from das_diff_veh_tpu_torch.io.synthetic import SceneConfig, synthesize_section
from das_diff_veh_tpu_torch.models import vsg as V
from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

CPU = "cpu"


def _truth_model():
    """Soft layer over a stiffer halfspace, Poisson 0.4375 (the JAX test's)."""
    vs = torch.tensor([0.24, 0.55], dtype=torch.float64)
    vp = vp_from_poisson(vs, 0.4375)
    return LayeredModel(torch.tensor([0.018, 0.05], dtype=torch.float64), vp, vs,
                        density_gardner_linear(vp))


def test_full_stack_truth_to_vs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _truth_to_vs()
    finally:
        torch.set_num_threads(n)


def _truth_to_vs():
    truth = _truth_model()
    f_grid = np.linspace(0.5, 30.0, 400)
    c_grid = phase_velocity(1.0 / f_grid, truth, mode=0, n_grid=800).numpy() * 1000.0
    assert np.isfinite(c_grid).all()

    def c_of_f(freqs):
        f = np.clip(np.asarray(freqs, float), f_grid[0], f_grid[-1])
        return np.interp(f, f_grid, c_grid)

    section, _ = synthesize_section(SceneConfig(nch=100, duration=300.0, n_vehicles=8, seed=3,
                                                speed_range=(10.0, 20.0), noise_std=0.005,
                                                phase_velocity=c_of_f))
    cfg = PipelineConfig().replace(imaging=ImagingConfig(x0=400.0))
    res = process_chunk(section, cfg, method="xcorr", device=CPU)
    assert res.n_windows >= 5

    dt = float(section.t[1] - section.t[0])
    x = res.batch.x.numpy()
    g = V.VsgGeometry.build(x, dt, cfg.imaging.x0, cfg.imaging.x0 + cfg.imaging.disp_start_x,
                            cfg.imaging.x0 + cfg.gather.far_offset, cfg.gather)
    gathers = V.build_gather_batch(res.batch, g, cfg.gather)[res.batch.valid]
    n = int(gathers.shape[0])
    bcfg = BootstrapConfig(bt_times=8, bt_size=n - 3, sigma=(35.0,), ref_freq_idx=(87,),
                           freq_lb=(3.5,), freq_ub=(10.0,))
    idx = sample_indices(n, n - 3, 8, np.random.default_rng(0))
    ridges, freqs = bootstrap_disp(gathers, g.offsets(x), dt, cfg.interrogator.dx, idx, bcfg,
                                   cfg.dispersion, disp_start_x=cfg.imaging.disp_start_x,
                                   disp_end_x=cfg.imaging.disp_end_x)
    band = (freqs >= 3.5) & (freqs < 10.0)
    assert ridges[0].std(axis=0).max() > 0.0
    obs_mean = ridges[0].mean(axis=0)
    med_err = np.median(np.abs(obs_mean - c_of_f(freqs[band])) / c_of_f(freqs[band]))
    assert med_err < 0.08, med_err

    c = curves_from_ridges(freqs, [3.5], [10.0], [ridges[0]], band_modes=[0])[0]
    cur = c._replace(period=c.period[::3], velocity=c.velocity[::3],
                     uncertainty=np.maximum(c.uncertainty[::3], 1.5e-2))
    spec = ModelSpec(layers=(LayerBounds((0.006, 0.035), (0.15, 0.45)),
                             LayerBounds((0.02, 0.08), (0.35, 0.9))))
    r = invert(spec, [cur], popsize=20, maxiter=60, n_refine_starts=6, n_refine_steps=50,
               n_grid=200, seed=0, device=CPU)

    vs_rec, vs_tru = r.model.vs.numpy(), truth.vs.numpy()
    th_rec = float(r.model.thickness[0])
    assert abs(vs_rec[0] - vs_tru[0]) / vs_tru[0] < 0.10, vs_rec
    assert abs(vs_rec[1] - vs_tru[1]) / vs_tru[1] < 0.20, vs_rec
    assert abs(th_rec - 0.018) / 0.018 < 0.40, th_rec
    assert float(r.misfit) < 1.5

    pred = phase_velocity(cur.period, r.model, mode=0, n_grid=200).numpy()
    assert np.isfinite(pred).all()
    rel = np.abs(pred - cur.velocity) / cur.velocity
    assert np.median(rel) < 0.05, np.median(rel)
