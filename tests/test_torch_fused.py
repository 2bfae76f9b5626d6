"""The port's fused chunk (``das_diff_veh_tpu_torch.pipeline.fused``) on the
CPU, where a program runs ``chunk_body`` without a graph.

- fused equals the port's staged chunk bit for bit (xcorr on the conftest
  scene, surface_wave on a small scene), and the xcorr chunk is within 1e-7
  peak-relative of the JAX staged chunk (the JAX fused tests fail at seed,
  so the JAX fused path is no oracle here);
- the program cache and its counters: another chunk of the same geometry is
  a hit, a shifted time origin a new program; the CPU captures nothing;
- a zero-signal chunk and an echo chunk (vehicles tracked, none isolated)
  give ``n_windows == 0`` and a finite image;
- the program body is free of host syncs (mirroring JAX
  ``tests/test_fused_pipeline.py:156-194``): with the host pulls and host
  copies patched to raise, a second call of the body trips nothing, and the
  staged ``process_chunk`` does trip the detector;
- an unknown ``chunk_pipeline`` raises before the data is touched, and the
  run config hash tells staged and fused apart;
- ``run_directory`` over 2 files with fused equals staged bit for bit.

Both sides run at float64 (conftest runs JAX with x64).  Apart from the
JAX comparison the tests run on ``tiny``, a scene of the port's own
generator (no JAX compile).  The card's side (capture, replay, aliasing,
recapture) is in tests/test_torch_cuda.py.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import das_diff_veh_tpu_torch.io.readers as PR
import das_diff_veh_tpu_torch.pipeline.workflow as PW
from das_diff_veh_tpu_torch.config import ImagingConfig, PipelineConfig
from das_diff_veh_tpu_torch.convert import config_from_dict, section_from_numpy
from das_diff_veh_tpu_torch.core.section import DasSection
from das_diff_veh_tpu_torch.pipeline import fused as F
from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk, resolve_chunk_metadata
from das_diff_veh_tpu_torch.runtime import RuntimeConfig, config_hash

ORACLE_BAR = 1e-7    # peak-relative, the JAX package's staged-vs-oracle bar
DATE = "20230301"
TINY_CFG = PipelineConfig().replace(imaging=ImagingConfig(x0=250.0))


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


@pytest.fixture(scope="module")
def tiny():
    """60 channels x 40 s: 2 isolated windows for either method; glued to a
    copy of itself 3 s later it still tracks 2 vehicles and isolates none."""
    from das_diff_veh_tpu_torch.io.synthetic import SceneConfig, synthesize_section

    return synthesize_section(SceneConfig(nch=60, duration=40.0, n_vehicles=2, seed=3,
                                          speed_range=(12.0, 18.0)))[0]


def _peak_rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _cfgs(cfg=TINY_CFG, **gather):
    """The staged and fused configurations of the port's ``cfg``."""
    if gather:
        cfg = cfg.replace(gather=dataclasses.replace(cfg.gather, **gather))
    return cfg, cfg.replace(chunk_pipeline="fused")


def _port(section, data=None, t_shift=0.0) -> DasSection:
    d = np.asarray(section.data) if data is None else data
    return section_from_numpy(d, np.asarray(section.x), np.asarray(section.t) + t_shift,
                              device="cpu")


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaN where NaN."""
    return a.dtype == b.dtype and bool(torch.equal(torch.isnan(a), torch.isnan(b))
                                       and torch.equal(a.nan_to_num(), b.nan_to_num()))


def _assert_same_chunk(fused, staged):
    assert torch.is_tensor(fused.n_windows) and fused.n_windows.dim() == 0
    assert int(fused.n_windows) == staged.n_windows
    assert _same(fused.disp_image, staged.disp_image)
    assert (fused.vsg_stack is None) == (staged.vsg_stack is None)
    if staged.vsg_stack is not None:
        assert _same(fused.vsg_stack, staged.vsg_stack)
    for f in dataclasses.fields(staged.tracks):
        assert _same(getattr(fused.tracks, f.name), getattr(staged.tracks, f.name)), f.name
    for f in dataclasses.fields(staged.batch):
        assert _same(getattr(fused.batch, f.name), getattr(staged.batch, f.name)), f.name


def _assert_near_jax(got, want):
    assert int(got.n_windows) == want.n_windows >= 1
    np.testing.assert_array_equal(got.batch.valid.numpy(), np.asarray(want.batch.valid))
    np.testing.assert_array_equal(got.tracks.valid.numpy(), np.asarray(want.tracks.valid))
    assert _peak_rel(got.batch.data.numpy(), want.batch.data) <= ORACLE_BAR
    assert _peak_rel(got.disp_image.numpy(), want.disp_image) <= ORACLE_BAR
    if want.vsg_stack is not None:
        assert _peak_rel(got.vsg_stack.numpy(), want.vsg_stack) <= ORACLE_BAR


def test_fused_xcorr_equals_staged_and_jax(pipeline_scene, pipeline_cfg, chunk_result_xcorr):
    section, _ = pipeline_scene
    staged_cfg, fused_cfg = _cfgs(config_from_dict(dataclasses.asdict(pipeline_cfg)))
    staged = process_chunk(_port(section), staged_cfg, method="xcorr", device="cpu")
    fused = process_chunk(_port(section), fused_cfg, method="xcorr", device="cpu")
    _assert_same_chunk(fused, staged)
    assert fused.qs_batch is None and fused.health is None
    _assert_near_jax(fused, chunk_result_xcorr)


def test_fused_surface_wave_equals_staged(tiny):
    """(The staged surface_wave chunk is held to JAX's in
    tests/test_torch_surface_wave.py.)"""
    section = tiny
    staged_cfg, fused_cfg = _cfgs()
    staged = process_chunk(_port(section), staged_cfg, method="surface_wave", device="cpu")
    fused = process_chunk(_port(section), fused_cfg, method="surface_wave", device="cpu")
    _assert_same_chunk(fused, staged)
    assert fused.vsg_stack is None and int(fused.n_windows) >= 1


def test_program_cache_and_counters(tiny):
    """Same geometry with other data is a hit; a shifted time origin is a
    new program (every slice bound comes from the axis values); each call
    counts one dispatch under its tag; the CPU captures and replays
    nothing."""
    section = tiny
    _, cfg = _cfgs()
    tag = "test_program_cache"
    # a time origin no other test uses: this geometry's program is new here
    base = _port(section, t_shift=7200.0)
    progs0, caps0, reps0 = F.n_programs(), F.n_captures(), F.n_replays()
    first = F.fused_process_chunk(base, cfg, tag=tag, device="cpu")
    assert F.n_programs() == progs0 + 1 and F.n_dispatches(tag) == 1
    other = F.fused_process_chunk(_port(section, 1.5 * np.asarray(section.data), 7200.0),
                                  cfg, tag=tag, device="cpu")
    assert F.n_programs() == progs0 + 1 and F.n_dispatches(tag) == 2
    assert torch.isfinite(other.disp_image).all()
    shifted = F.fused_process_chunk(_port(section, t_shift=7200.004), cfg, tag=tag,
                                    device="cpu")
    assert F.n_programs() == progs0 + 2 and F.n_dispatches(tag) == 3
    assert (F.n_captures(), F.n_replays()) == (caps0, reps0)
    assert int(shifted.n_windows) == int(first.n_windows)
    prog = F.programs()[-1]
    assert prog.graph is None and prog.launches_per_replay == {} and prog.pool_bytes() == 0


def test_zero_signal_and_echo_chunks_isolate_nothing(tiny):
    """A zero-signal chunk (nothing tracked) and the echo chunk (every
    vehicle glued to a twin 3 s behind it: vehicles tracked, none isolated)
    through one program: ``n_windows == 0``, no valid slot, a finite
    image."""
    section = tiny
    _, cfg = _cfgs()
    d = np.asarray(section.data)
    echo = d + np.roll(d, int(3.0 * 250.0), axis=1)         # 3 s at 250 Hz
    progs0 = None
    for data in (echo, np.zeros_like(d)):
        res = process_chunk(_port(section, data), cfg, method="xcorr", device="cpu")
        if progs0 is None:
            progs0 = F.n_programs()
            assert int(res.tracks.valid.sum()) > 0               # tracked, not isolated
        assert int(res.n_windows) == 0 and not res.batch.valid.any()
        assert torch.isfinite(res.disp_image).all()
    assert F.n_programs() == progs0


def test_constants_cache_keeps_the_staged_bits(tiny):
    """The staged chunk with an empty constants cache and with the cache
    its first call filled: the same bits, and the second call builds no
    constant (every host-built tensor of the path is a cache hit)."""
    from das_diff_veh_tpu_torch.core import constants

    section = tiny
    cfg, _ = _cfgs()
    constants.clear()
    cold = process_chunk(_port(section), cfg, method="xcorr", device="cpu")
    n = constants.n_constants()
    assert n > 0 and constants.nbytes() > 0
    warm = process_chunk(_port(section), cfg, method="xcorr", device="cpu")
    assert constants.n_constants() == n
    assert _same(warm.disp_image, cold.disp_image) and _same(warm.vsg_stack, cold.vsg_stack)
    assert _same(warm.tracks.t_idx, cold.tracks.t_idx)
    a = np.arange(5.0)
    assert constants.host_constant(a, torch.float32, "cpu") is \
        constants.host_constant(a.copy(), torch.float32, "cpu")


class HostSync(RuntimeError):
    """A host pull or a host-to-device copy inside the region under test."""


@contextlib.contextmanager
def no_host_sync():
    """Inside: every tensor-to-host pull (``item``, ``bool``, ``int``,
    ``float``, ``index``, ``cpu``, ``numpy``, ``tolist``) and every
    ``torch.as_tensor`` / ``torch.tensor`` of host data raises
    :class:`HostSync`.  On the card each is a sync, or a host-to-device copy
    that a CUDA graph cannot capture."""
    names = ("item", "__bool__", "__int__", "__float__", "__index__", "cpu", "numpy",
             "tolist")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    as_tensor, tensor = torch.as_tensor, torch.tensor

    def trip(name):
        def call(*args, **kwargs):
            raise HostSync(f"Tensor.{name}")
        return call

    def tensors_only(fn, name):
        def call(data, *args, **kwargs):
            if not torch.is_tensor(data):
                raise HostSync(f"torch.{name} of host data")
            return fn(data, *args, **kwargs)
        return call

    try:
        for n in names:
            setattr(torch.Tensor, n, trip(n))
        torch.as_tensor = tensors_only(as_tensor, "as_tensor")
        torch.tensor = tensors_only(tensor, "tensor")
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)
        torch.as_tensor, torch.tensor = as_tensor, tensor


def test_host_sync_detector_trips():
    with pytest.raises(HostSync, match="item"), no_host_sync():
        torch.zeros(()).item()
    with pytest.raises(HostSync, match="as_tensor"), no_host_sync():
        torch.as_tensor(np.zeros(3))
    with no_host_sync():
        torch.as_tensor(torch.zeros(3))
    assert torch.ones(()).item() == 1.0                      # restored


@pytest.mark.parametrize("case", ["xcorr", "dot", "surface_wave"])
def test_program_body_is_host_sync_free(case, tiny):
    """A second call of the program body (the constants cached by the
    first) pulls nothing to the host and copies nothing from it, for the
    rfft and the dot finish and for surface_wave; the staged
    ``process_chunk`` trips the detector (its metadata pull and its
    ``int(n_windows)``)."""
    method = "surface_wave" if case == "surface_wave" else "xcorr"
    gather = dict(wlen=1.0, traj_gather_finish="dot") if case == "dot" else {}
    staged_cfg, cfg = _cfgs(**gather)
    sec = _port(tiny)
    x_dist, t, _ = resolve_chunk_metadata(sec, cfg)
    prog = F._program(sec.data.shape, sec.data.dtype, sec.data.device, x_dist, t, cfg,
                      method, False)
    first = prog.body(sec.data)
    with no_host_sync():
        second = prog.body(sec.data)
    assert _same(second[0], first[0])
    with pytest.raises(HostSync), no_host_sync():
        process_chunk(sec, staged_cfg, method=method, device="cpu")


class _Untouchable:
    def __getattr__(self, name):
        raise AssertionError(f"the data was touched ({name})")


def test_unknown_chunk_pipeline_raises_before_the_data():
    sec = DasSection(_Untouchable(), torch.arange(4.0), torch.arange(8.0) / 250.0)
    bogus = PipelineConfig(chunk_pipeline="bogus")
    for device in (None, "cpu"):
        with pytest.raises(ValueError, match="chunk_pipeline"):
            process_chunk(sec, bogus, device=device)
    staged, fused = _cfgs()
    assert config_hash(staged, "xcorr", False) != config_hash(fused, "xcorr", False)
    assert PW._run_config_hash(staged, "xcorr", False, None) != \
        PW._run_config_hash(fused, "xcorr", False, None)


def test_run_directory_fused_equals_staged(tmp_path, tiny):
    """Two files through ``run_directory``: the fused chunk at prefetch depth
    2 and the staged one inline give the same image bits and counts."""
    section = tiny
    day = tmp_path / DATE
    day.mkdir()
    for i, s in enumerate((1.0, 1.01)):
        np.savez(day / f"{DATE}_{i:02d}0000.npz", data=np.asarray(section.data) * s,
                 x_axis=np.asarray(section.x), t_axis=np.asarray(section.t))
    staged_cfg, fused_cfg = _cfgs()
    res = {}
    for name, cfg, depth in (("staged", staged_cfg, 0), ("fused", fused_cfg, 2)):
        ds = PR.DirectoryDataset(DATE, root=str(tmp_path), ch1=None, ch2=None,
                                 smoothing=False, rescale_after=None)
        res[name] = PW.run_directory(ds, cfg, x_is_channels=False,
                                     runtime=RuntimeConfig(prefetch_depth=depth),
                                     out_dir=str(tmp_path / name), device="cpu")
    s, f = res["staged"], res["fused"]
    assert f.avg_image is not None and f.n_chunks == 2 and not f.quarantined
    assert np.array_equal(f.avg_image, s.avg_image)
    assert (f.n_vehicles, f.n_chunks, f.complete) == (s.n_vehicles, s.n_chunks, s.complete)


def test_pull_count_and_image():
    img = torch.arange(6.0, dtype=torch.float32).reshape(2, 3)
    for n in (3, torch.tensor(3)):
        got_n, got = PW.pull_count_and_image(n, img)
        assert got_n == 3 and isinstance(got_n, int)
        assert np.array_equal(got, img.numpy()) and got.dtype == np.float32
