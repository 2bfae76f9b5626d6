"""The port's slice as a whole: ``process_chunk(method="xcorr")`` on the CPU
against the JAX session result ``chunk_result_xcorr``; the port imports no
JAX; its entry points need a card unless the CPU is asked for."""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from das_diff_veh_tpu_torch.config import PipelineConfig
from das_diff_veh_tpu_torch.convert import config_from_dict, section_from_numpy
from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "das_diff_veh_tpu_torch"


def _peak_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_process_chunk_matches_jax_chunk(pipeline_scene, pipeline_cfg, chunk_result_xcorr):
    section, _ = pipeline_scene
    want = chunk_result_xcorr
    sec = section_from_numpy(np.asarray(section.data), np.asarray(section.x),
                             np.asarray(section.t), device="cpu")
    got = process_chunk(sec, config_from_dict(dataclasses.asdict(pipeline_cfg)),
                        method="xcorr", device="cpu")
    assert got.n_windows == want.n_windows
    np.testing.assert_array_equal(got.batch.valid.numpy(), np.asarray(want.batch.valid))
    np.testing.assert_array_equal(got.tracks.valid.numpy(), np.asarray(want.tracks.valid))
    np.testing.assert_array_equal(np.isnan(got.tracks.t_idx.numpy()),
                                  np.isnan(np.asarray(want.tracks.t_idx)))
    assert got.disp_image.shape == want.disp_image.shape
    assert _peak_rel(got.vsg_stack.numpy(), want.vsg_stack) <= 1e-7
    assert _peak_rel(got.disp_image.numpy(), want.disp_image) <= 1e-7


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_smoke_script_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = [(f.relative_to(REPO).as_posix(), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "das_diff_veh_tpu")]
    assert not bad, bad


def test_port_runs_a_chunk_without_loading_jax():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        import torch
        from das_diff_veh_tpu_torch.config import ImagingConfig, PipelineConfig
        from das_diff_veh_tpu_torch.io.synthetic import SceneConfig, synthesize_section
        from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk
        sec, _ = synthesize_section(SceneConfig(nch=60, duration=40.0, n_vehicles=2,
                                                seed=5, speed_range=(12.0, 18.0)))
        cfg = PipelineConfig().replace(imaging=ImagingConfig(x0=250.0))
        r = process_chunk(sec, cfg, device="cpu")
        assert bool(torch.isfinite(r.disp_image).all()), "non-finite image"
        from das_diff_veh_tpu_torch.ops import traj_gather as tg
        from das_diff_veh_tpu_torch.ops.xcorr import xcorr_traj_follow
        dot = xcorr_traj_follow(sec.data[:, :2000], sec.t[:2000], 6, torch.tensor([2, 3]),
                                torch.tensor([1.0, 2.0], dtype=torch.float64), 800, 250,
                                mode="fused", finish="dot", precision="bf16")
        assert dot.shape == (2, 250) and bool(dot.abs().sum() > 0), "empty dot finish"
        assert tg.dot_launches == 0
        from das_diff_veh_tpu_torch.ops.all_pairs import xcorr_all_pairs_peak
        from das_diff_veh_tpu_torch.workloads import make_ambient_record
        peak = xcorr_all_pairs_peak(make_ambient_record(12, 300, device="cpu"), 64,
                                    src_chunk=4, use_kernel=True, device="cpu")
        assert peak.shape == (12, 12) and bool(torch.isfinite(peak).all())
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "das_diff_veh_tpu")]
        assert not loaded, loaded
        print("ok", r.n_windows)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(REPO / "tests"), env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_entry_points_need_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    x, t = np.arange(4) * 8.16, np.arange(8) * 0.004
    with pytest.raises(RuntimeError, match="device='cpu'"):
        section_from_numpy(np.zeros((4, 8)), x, t)
    sec = section_from_numpy(np.zeros((4, 8)), x, t, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        process_chunk(sec)


def test_unported_options_raise():
    """An unknown chunk pipeline and an unknown method are refused (the fused
    chunk is ported: tests/test_torch_fused.py).  The health sentinel is
    ported: with it on, an all-flat chunk is refused as poisoned instead of
    raising NotImplementedError."""
    from das_diff_veh_tpu_torch.resilience.health import PoisonedChunkError

    x, t = np.arange(4) * 8.16, np.arange(8) * 0.004
    sec = section_from_numpy(np.zeros((4, 8)), x, t, device="cpu")
    with pytest.raises(ValueError, match="surface_wave"):
        process_chunk(sec, method="rayleigh", device="cpu")
    with pytest.raises(ValueError, match="chunk_pipeline"):
        process_chunk(sec, PipelineConfig(chunk_pipeline="bogus"), device="cpu")
    cfg = PipelineConfig()
    cfg = cfg.replace(health=dataclasses.replace(cfg.health, enabled=True))
    with pytest.raises(PoisonedChunkError, match="4/4 channels masked"):
        process_chunk(sec, cfg, device="cpu")


def test_chip_smoke_fails_without_a_card(tmp_path):
    """The smoke script exits non-zero and prints no result without a CUDA
    device, and alone in a directory without the rest of the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (REPO / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             cwd=str(script.parent), timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
