"""The port's batch workflow with real compute against the JAX workflow, and
its command line.

The real-compute case runs ``process_chunk`` on every file of a 2-file
folder through both packages' ``run_directory`` on the CPU at float64.  It
reuses the session scene and configuration of tests/conftest.py, so the JAX
side compiles nothing new for this geometry.

The folder is read with ``smoothing=False``.  The reference's savgol
pre-smooth (window 21, order 15) is numerically degenerate in the installed
scipy: ``savgol_coeffs(21, 15)`` sums to 5.85e-4 instead of 1, so the
smoothed scene keeps ~1/1700 of its amplitude, no vehicle is tracked in
either package, and the two images would both be None.  The smoothing
itself is held bit for bit against the JAX reader in
tests/test_torch_runtime.py::test_directory_dataset_matches_jax.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import das_diff_veh_tpu.io.readers as JR
import das_diff_veh_tpu.pipeline.cli as JCLI
import das_diff_veh_tpu.pipeline.workflow as JW
import das_diff_veh_tpu.runtime as JRT
import das_diff_veh_tpu_torch.io.readers as PR
import das_diff_veh_tpu_torch.pipeline.cli as PCLI
import das_diff_veh_tpu_torch.pipeline.workflow as PW
import das_diff_veh_tpu_torch.runtime as PRT
from das_diff_veh_tpu_torch.convert import config_from_dict

DATE = "20230301"


def _peak_rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _write_scene_folder(root, section, scales, x=None):
    day = os.path.join(str(root), DATE)
    os.makedirs(day, exist_ok=True)
    x = np.asarray(section.x) if x is None else x
    for i, s in enumerate(scales):
        np.savez(os.path.join(day, f"{DATE}_{i:02d}0000.npz"),
                 data=np.asarray(section.data) * s, x_axis=x, t_axis=np.asarray(section.t))
    return str(root)


def test_run_directory_real_compute_matches_jax(tmp_path, pipeline_scene, pipeline_cfg):
    section, _ = pipeline_scene
    root = _write_scene_folder(tmp_path, section, [1.0, 1.01])
    kw = dict(root=root, ch1=None, ch2=None, smoothing=False, rescale_after=None)
    want = JW.run_directory(JR.DirectoryDataset(DATE, **kw), pipeline_cfg, x_is_channels=False,
                            runtime=JRT.RuntimeConfig(prefetch_depth=2))
    got = PW.run_directory(PR.DirectoryDataset(DATE, **kw),
                           config_from_dict(dataclasses.asdict(pipeline_cfg)),
                           x_is_channels=False, runtime=PRT.RuntimeConfig(prefetch_depth=2),
                           device="cpu")
    assert (got.n_vehicles, got.n_chunks, got.complete) == \
        (want.n_vehicles, want.n_chunks, want.complete)
    assert got.n_chunks == 2 and not got.quarantined
    assert got.avg_image.dtype == np.float64
    assert _peak_rel(got.avg_image, np.asarray(want.avg_image)) <= 1e-7


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

FLAGS = ["--data_root", "/d", "--start_date", DATE, "--end_date", DATE,
         "--out_dir", "/o", "--method", "surface_wave", "--x0", "450",
         "--n_min_save", "30", "--max_chunks", "5", "--verbal",
         "--prefetch_depth", "4", "--retries", "2", "--retry_backoff", "0.5",
         "--trace", "/tmp/t.jsonl", "--metrics_jsonl", "/tmp/m.jsonl",
         "--metrics_interval", "3", "--flight_dir", "/tmp/f",
         "--profile_chunks", "4", "--trace_flush_interval", "0.5"]


def test_cli_parser_accepts_the_jax_flags():
    got = vars(PCLI.build_parser().parse_args(FLAGS))
    want = vars(JCLI.build_parser().parse_args(FLAGS))
    assert got.pop("device") is None
    assert got == want


@pytest.mark.parametrize("argv, item", [
    (["serve", "--port", "8080"], "item 12"),
    (["--figures"], "item 9"),
    (["--compilation_cache_dir", "/c"], "no meaning for PyTorch"),
    (["--data_root", "/d", "--start_date", DATE, "--end_date", DATE, "--device", "cpu",
      "--profile_dir", "/p"], "item 13"),
])
def test_cli_options_not_ported_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        PCLI.main(argv)


def test_cli_missing_args_errors_cleanly(capsys):
    with pytest.raises(SystemExit) as exc:
        PCLI.main(["--start_date", DATE])
    assert exc.value.code == 2
    assert "required unless --figures" in capsys.readouterr().err


def test_cli_runs_a_date_on_the_cpu(tmp_path, pipeline_scene, capsys):
    """The command line over a date folder with channel-numbered files (the
    reader's default ch1/ch2 cut and the reference smoothing and rescale),
    on the CPU; a second call resumes the completed date."""
    section, _ = pipeline_scene
    root = _write_scene_folder(tmp_path / "data", section, [1.0],
                               x=np.arange(400.0, 400.0 + section.data.shape[0]))
    out = str(tmp_path / "res")
    argv = ["--data_root", root, "--start_date", DATE, "--end_date", DATE, "--x0", "400",
            "--out_dir", out, "--device", "cpu", "--prefetch_depth", "1"]
    assert PCLI.main(argv) == 0
    summary = json.loads(capsys.readouterr().out)[DATE]
    assert summary["n_chunks"] == summary["n_vehicles"] == 0 and summary["complete"]
    assert summary["n_quarantined"] == 0 and summary["n_resumed"] == 0
    man = PRT.RunManifest.load(os.path.join(out, f"{DATE}_manifest.json"))
    assert man.complete and list(man.files) == [f"{DATE}_000000.npz"]
    assert PCLI.main(argv) == 0
    assert json.loads(capsys.readouterr().out)[DATE]["n_resumed"] == 1
