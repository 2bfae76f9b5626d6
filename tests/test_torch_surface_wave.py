"""The rest of the chunk API beside the dot finish, against the JAX package
on the CPU: the dispersion transforms' precision tiers, the phase-shift
transform and ``stack_fv_maps``, the trajectory and time mutes, the
per-window images of ``method="surface_wave"``, and two whole chunks: the
surface_wave chunk and the xcorr chunk with a 1 s window through the dot
finish.

Tolerances: the repository's oracle bar (1e-7 peak-relative) in float64;
1e-6 in the bf16 tiers, where both packages contract bfloat16-rounded
operands in float32 and sum in their own orders.  The mutes multiply by a
Tukey taper whose cosines XLA and PyTorch round in their own ways (1e-15, as
``test_torch_stages.py`` holds the taper)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_windows import _make_tracks_and_data

from das_diff_veh_tpu import config as JC
from das_diff_veh_tpu.core.section import VehicleTracks as JTracks
from das_diff_veh_tpu.models import vsg as JV
from das_diff_veh_tpu.models import windows as JW
from das_diff_veh_tpu.ops import dispersion as JD
from das_diff_veh_tpu.pipeline import timelapse as JTL
from das_diff_veh_tpu_torch import config as PC
from das_diff_veh_tpu_torch.convert import config_from_dict, section_from_numpy
from das_diff_veh_tpu_torch.core.section import VehicleTracks as PTracks
from das_diff_veh_tpu_torch.models import vsg as PV
from das_diff_veh_tpu_torch.models import windows as PW
from das_diff_veh_tpu_torch.ops import dispersion as PD
from das_diff_veh_tpu_torch.ops import traj_gather as tg
from das_diff_veh_tpu_torch.pipeline import timelapse as PTL

RNG = np.random.default_rng(59)
FREQS = np.arange(0.8, 25.0, 0.1)
VELS = np.arange(200.0, 1200.0, 1.0)          # 1000 velocities: a padded last chunk
ORACLE = 1e-7
BF16_TOL = 1e-6
DISP_FK_BF16_BUDGET = 3e-2                    # tests/test_precision.py
DISP_PS_BF16_BUDGET = 2e-2


def _peak_rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _data(nch=18, nt=500):
    return RNG.standard_normal((nch, nt))


# ---- the dispersion transforms ----

@pytest.mark.parametrize("norm", [False, True])
def test_fv_map_fk_bf16_matches_jax(norm):
    data = _data()
    kw = dict(norm=norm, precision="bf16")
    want = np.asarray(JD.fv_map_fk(jnp.asarray(data), 8.16, 0.004, jnp.asarray(FREQS),
                                   jnp.asarray(VELS), **kw))
    got = PD.fv_map_fk(torch.from_numpy(data), 8.16, 0.004, FREQS, VELS, **kw).numpy()
    f32 = PD.fv_map_fk(torch.from_numpy(data), 8.16, 0.004, FREQS, VELS, norm=norm).numpy()
    assert got.dtype == want.dtype == np.float32          # float32 after the bf16 cast
    assert _peak_rel(got, want) <= BF16_TOL
    assert not np.array_equal(got, f32), "the bf16 tier must change bits"
    assert _peak_rel(got, f32) < DISP_FK_BF16_BUDGET
    assert np.array_equal(f32, PD.fv_map_fk(torch.from_numpy(data), 8.16, 0.004, FREQS, VELS,
                                            norm=norm, precision="f32").numpy())


@pytest.mark.parametrize("whiten", [False, True])
@pytest.mark.parametrize("direction", [1.0, -1.0])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_fv_map_phase_shift_matches_jax(precision, direction, whiten):
    data = _data()
    kw = dict(whiten=whiten, direction=direction, x0=12.0, precision=precision)
    want = np.asarray(JD.fv_map_phase_shift(jnp.asarray(data), 8.16, 0.004,
                                            jnp.asarray(FREQS), jnp.asarray(VELS), **kw))
    got = PD.fv_map_phase_shift(torch.from_numpy(data), 8.16, 0.004, FREQS, VELS, **kw).numpy()
    assert got.shape == (VELS.size, FREQS.size) and got.dtype == want.dtype
    assert _peak_rel(got, want) <= (ORACLE if precision == "f32" else BF16_TOL)
    if precision == "bf16":
        f32 = PD.fv_map_phase_shift(torch.from_numpy(data), 8.16, 0.004, FREQS, VELS,
                                    whiten=whiten, direction=direction, x0=12.0).numpy()
        assert not np.array_equal(got, f32), "the bf16 tier must change bits"
        assert _peak_rel(got, f32) < DISP_PS_BF16_BUDGET


@pytest.mark.parametrize("fn", ["fv_map_fk", "fv_map_phase_shift"])
def test_dispersion_batch_axis_and_precision_check(fn):
    """A leading window axis equals per-window calls; an unknown tier is a
    ValueError naming ``precision``, as in the JAX package."""
    data = RNG.standard_normal((3, 18, 500))
    port = getattr(PD, fn)
    both = port(torch.from_numpy(data), 8.16, 0.004, FREQS, VELS).numpy()
    for b in range(3):
        one = port(torch.from_numpy(data[b]), 8.16, 0.004, FREQS, VELS).numpy()
        assert _peak_rel(both[b], one) <= 1e-12
    with pytest.raises(ValueError, match="precision"):
        port(torch.from_numpy(data), 8.16, 0.004, FREQS, VELS, precision="f64")
    with pytest.raises(ValueError, match="precision"):
        getattr(JD, fn)(jnp.asarray(data[0]), 8.16, 0.004, jnp.asarray(FREQS),
                        jnp.asarray(VELS), precision="f64")


def test_stack_fv_maps_matches_jax():
    """A mean over the window axis; XLA and PyTorch sum five values in their
    own orders (tests/test_dispersion.py holds JAX's against numpy at 1e-12)."""
    maps = RNG.standard_normal((5, 10, 12))
    np.testing.assert_allclose(PD.stack_fv_maps(torch.from_numpy(maps)).numpy(),
                               np.asarray(JD.stack_fv_maps(jnp.asarray(maps))),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_gather_disp_image_phase_shift_matches_jax(chunk_result_xcorr, precision):
    """``DispersionConfig(method="phase_shift")`` on the stacked gather of
    the JAX chunk fixture, through both packages' ``gather_disp_image``."""
    stack = np.array(chunk_result_xcorr.vsg_stack)
    offsets = np.arange(stack.shape[0]) * 8.16 - 150.0
    jcfg = JC.DispersionConfig(method="phase_shift", precision=precision)
    want = np.asarray(JV.gather_disp_image(jnp.asarray(stack), offsets, 0.004, 8.16, jcfg,
                                           -150.0, 0.0))
    got = PV.gather_disp_image(torch.from_numpy(stack), offsets, 0.004, 8.16,
                               PC.DispersionConfig(**dataclasses.asdict(jcfg)),
                               -150.0, 0.0).numpy()
    assert got.shape == want.shape
    assert _peak_rel(got, want) <= (ORACLE if precision == "f32" else BF16_TOL)


# ---- mutes and the per-window images ----

def _batches():
    data, x, t, states, x_track, t_track, x0 = _make_tracks_and_data()
    jtr = JTracks(t_idx=jnp.asarray(states), valid=jnp.ones(states.shape[0], bool),
                  x=jnp.asarray(x_track), t=jnp.asarray(t_track))
    ptr = PTracks(t_idx=torch.from_numpy(states),
                  valid=torch.ones(states.shape[0], dtype=torch.bool),
                  x=torch.from_numpy(x_track), t=torch.from_numpy(t_track))
    want = JW.select_windows(jnp.asarray(data), x, t, jtr, x0, JC.WindowConfig())
    got = PW.select_windows(torch.from_numpy(data), x, t, ptr, x0, PC.WindowConfig())
    return want, got, x0


@pytest.mark.parametrize("double_sided", [False, True])
def test_mute_along_traj_and_time_match_jax(double_sided):
    want, got, _ = _batches()
    k = int(np.flatnonzero(np.asarray(want.valid))[0])
    tt = np.asarray(want.traj_t[k])
    jm = JW.mute_along_traj(want.data[k], want.x, want.t[k], want.traj_x[k], jnp.asarray(tt),
                            jnp.isfinite(jnp.asarray(tt)), 8.16, double_sided=double_sided)
    pm = PW.mute_along_traj(got.data[k], got.x, got.t[k], got.traj_x[k], got.traj_t[k],
                            torch.isfinite(got.traj_t[k]), 8.16, double_sided=double_sided)
    assert pm.dtype == torch.float64
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0, atol=1e-15)
    assert np.array_equal(pm.numpy() == 0, np.asarray(jm) == 0)
    for alpha in (0.3, 0.05):
        np.testing.assert_allclose(PW.mute_along_time(got.data[k], alpha).numpy(),
                                   np.asarray(JW.mute_along_time(want.data[k], alpha)),
                                   rtol=0, atol=1e-15)


@pytest.mark.parametrize("method", ["fk", "phase_shift"])
def test_disp_image_batch_matches_jax(method):
    want_b, got_b, x0 = _batches()
    jcfg = JC.PipelineConfig().replace(imaging=JC.ImagingConfig(x0=x0),
                                       dispersion=JC.DispersionConfig(method=method))
    pcfg = config_from_dict(dataclasses.asdict(jcfg))
    valid = np.asarray(want_b.valid)
    want = np.asarray(JTL.disp_image_batch(want_b, jcfg))[valid]
    got = PTL.disp_image_batch(got_b, pcfg).numpy()[valid]
    assert got.shape == want.shape and valid.sum() >= 2
    for g, w in zip(got, want):
        assert _peak_rel(g, w) <= ORACLE


# ---- whole chunks ----

def _same_chunk(got, want):
    assert got.n_windows == int(want.n_windows) > 0
    np.testing.assert_array_equal(got.batch.valid.numpy(), np.asarray(want.batch.valid))
    np.testing.assert_array_equal(got.tracks.valid.numpy(), np.asarray(want.tracks.valid))
    assert got.disp_image.shape == want.disp_image.shape
    assert _peak_rel(got.disp_image.numpy(), want.disp_image) <= ORACLE


def test_surface_wave_chunk_matches_jax(small_scene_sw, pipeline_cfg, small_chunk_sw):
    section, _ = small_scene_sw
    sec = section_from_numpy(np.asarray(section.data), np.asarray(section.x),
                             np.asarray(section.t), device="cpu")
    got = PTL.process_chunk(sec, config_from_dict(dataclasses.asdict(pipeline_cfg)),
                            method="surface_wave", device="cpu")
    assert got.vsg_stack is None
    _same_chunk(got, small_chunk_sw)


# WindowConfig overrides of the dot chunks.  With the default 8 s window the
# vehicle sits at its centre, so a time-reversed row, which ends delta_t
# before the vehicle reaches its channel, has less than time_window (4 s) of
# record before it: every one is a backward empty slice and the image sees
# only the main side.  16 s windows at the default 8 s isolation spacing
# leave the time-reversed rows near the pivot live.
DOT_WINDOWS = {"default_window": {},
               "live_time_reversed": dict(wlen_sw=16.0, temporal_spacing=8.0)}


@pytest.fixture(scope="module", params=list(DOT_WINDOWS))
def dot_chunks(request, pipeline_scene, pipeline_cfg):
    """The JAX staged chunk with a 1 s window through the Pallas dot finish
    (interpret mode), the port's CPU chunk with the same configuration, and
    the calls that chunk made of the dot finish's plain version, each with
    its output last."""
    section, _ = pipeline_scene
    jcfg = pipeline_cfg.replace(
        gather=dataclasses.replace(pipeline_cfg.gather, wlen=1.0, traj_gather="fused",
                                   traj_gather_finish="dot"),
        window=dataclasses.replace(pipeline_cfg.window, **DOT_WINDOWS[request.param]))
    want = JTL.process_chunk(section, jcfg, method="xcorr")
    sec = section_from_numpy(np.asarray(section.data), np.asarray(section.x),
                             np.asarray(section.t), device="cpu")
    pcfg = config_from_dict(dataclasses.asdict(jcfg))
    calls = []
    plain = tg.correlate_dot_plain

    def recording(data, scal, *args):
        out = plain(data, scal, *args)
        calls.append((tuple(scal.shape), *args, out))
        return out

    tg.correlate_dot_plain = recording
    try:
        got = PTL.process_chunk(sec, pcfg, device="cpu")
    finally:
        tg.correlate_dot_plain = plain
    return request.param, sec, pcfg, got, want, calls


def test_dot_chunk_matches_jax(dot_chunks):
    _, _, _, got, want, _ = dot_chunks
    _same_chunk(got, want)
    assert got.vsg_stack.shape == want.vsg_stack.shape and want.vsg_stack.shape[-1] == 250
    assert _peak_rel(got.vsg_stack.numpy(), want.vsg_stack) <= ORACLE


def test_dot_chunk_ran_the_dot_finish(dot_chunks):
    """Both trajectory sides went through the dot finish (its plain version
    on the CPU, so no kernel launch), all 64 window slots in one call each:
    nwin 6 at wlen 250 (nsamp 999, offset 125), the time-reversed side
    swapped."""
    *_, calls = dot_chunks
    assert [c[0][0] for c in calls] == [64, 64]
    assert [c[2:6] for c in calls] == [(6, 250, 125, False), (6, 250, 125, True)]
    assert tg.dot_launches == 0


def test_dot_chunk_time_reversed_side_reaches_the_image(dot_chunks, monkeypatch):
    """Which of the dot finish's rows the image sees (``DOT_WINDOWS``): the
    main side has live rows in the isolated windows in both cases; the
    time-reversed side has none with the default window (so zeroing its
    output could not move the stack of the isolated windows), and has live
    rows with 16 s windows, where zeroing them moves the image by far more
    than the card's 1e-3 check of the chunk."""
    name, sec, pcfg, got, _, calls = dot_chunks
    valid = got.batch.valid
    live = [int(c[-1][valid].abs().amax(-1).gt(0).sum()) for c in calls]
    assert live[0] > 0
    if name == "default_window":
        assert live[1] == 0
        return
    plain = tg.correlate_dot_plain

    def zero_time_reversed(data, scal, pivot, nwin, wlen, offset, swap, precision):
        out = plain(data, scal, pivot, nwin, wlen, offset, swap, precision)
        return torch.zeros_like(out) if swap else out

    monkeypatch.setattr(tg, "correlate_dot_plain", zero_time_reversed)
    moved = _peak_rel(PTL.process_chunk(sec, pcfg, device="cpu").disp_image.numpy(),
                      got.disp_image.numpy())
    assert live[1] > 0 and moved > 1e-2
