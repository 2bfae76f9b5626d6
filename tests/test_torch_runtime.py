"""The port's batch runtime against the JAX package's: prefetch, retry and
quarantine, traces, the resume manifest, fault injection, the obs artifacts,
and the readers' file formats.

The contracts are those of tests/test_runtime.py, test_io.py,
test_artifacts.py and the registry/sink/flight cases of test_obs.py.  Where
both packages can run a case, it runs through both and the results are
compared.  Every ``run_directory`` here takes a cheap deterministic numpy
``compute_fn`` and ``device="cpu"``: no imaging pipeline runs
(tests/test_torch_workflow.py covers the real compute).
"""

import json
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

import das_diff_veh_tpu.io.artifacts as JA
import das_diff_veh_tpu.io.readers as JR
import das_diff_veh_tpu.io.segy as JS
import das_diff_veh_tpu.obs as JO
import das_diff_veh_tpu.pipeline.workflow as JW
import das_diff_veh_tpu.resilience.faults as JF
import das_diff_veh_tpu.runtime as JRT
import das_diff_veh_tpu_torch.io.artifacts as PA
import das_diff_veh_tpu_torch.io.readers as PR
import das_diff_veh_tpu_torch.io.segy as PS
import das_diff_veh_tpu_torch.obs as PO
import das_diff_veh_tpu_torch.pipeline.workflow as PW
import das_diff_veh_tpu_torch.resilience.faults as PF
import das_diff_veh_tpu_torch.runtime as PRT
from das_diff_veh_tpu.config import ImagingConfig as JImaging
from das_diff_veh_tpu.config import ObsConfig as JObs
from das_diff_veh_tpu.config import PipelineConfig as JPipeline
from das_diff_veh_tpu.core.section import DasSection as JSection
from das_diff_veh_tpu_torch.config import ImagingConfig, ObsConfig, PipelineConfig
from das_diff_veh_tpu_torch.core.section import DasSection

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

DATE = "20230301"
# (readers, workflow, runtime, faults, obs, ObsConfig) of each package
PKG = {"port": (PR, PW, PRT, PF, PO, ObsConfig),
       "jax": (JR, JW, JRT, JF, JO, JObs)}


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _arrays(scale: float, nch: int = 8, nt: int = 256, seed: int = 7):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((nch, nt)) * scale, np.arange(float(nch)), np.arange(nt) / 250.0


def _write_dir(root, scales, corrupt=()):
    """One date folder of tiny npz chunks (the reference layout, written
    with numpy alone); ``corrupt`` indices get garbage bytes."""
    day = os.path.join(str(root), DATE)
    os.makedirs(day, exist_ok=True)
    for i, s in enumerate(scales):
        path = os.path.join(day, f"{DATE}_{i:02d}0000.npz")
        if i in corrupt:
            with open(path, "wb") as f:
                f.write(b"this is not an npz file")
        else:
            data, x, t = _arrays(s)
            np.savez(path, data=data, x_axis=x, t_axis=t)
    return str(root)


def _fake_compute(section):
    """Deterministic numpy stand-in for process_chunk: (1 vehicle, 4x4)."""
    d = np.asarray(section.data)
    return 1, np.outer(d.mean(axis=1)[:4], d.std(axis=1)[:4] + 1.0)


def _run(pkg, root, out=None, compute=_fake_compute, runtime=None, **kw):
    readers, workflow, rt = PKG[pkg][:3]
    ds = readers.DirectoryDataset(DATE, root=root, ch1=None, ch2=None,
                                  smoothing=False, rescale_after=None)
    if pkg == "port":
        kw.setdefault("device", "cpu")
    return workflow.run_directory(ds, out_dir=out, compute_fn=compute,
                                  runtime=runtime or rt.RuntimeConfig(), **kw)


def _counting(calls):
    def compute(section):
        calls.append(1)
        return _fake_compute(section)
    return compute


# --------------------------------------------------------------------------
# prefetch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 1, 4])
def test_prefetch_loader_preserves_order(depth):
    got = {}
    for pkg in PKG:
        loader = PKG[pkg][2].PrefetchLoader([lambda i=i: i * i for i in range(12)],
                                            depth=depth)
        got[pkg] = list(loader)
        loader.close()
    assert [v for _, v, _ in got["port"]] == [i * i for i in range(12)]
    assert got["port"] == got["jax"]


def test_prefetch_loader_runs_in_background_and_errors_in_band():
    names = []

    def load():
        names.append(threading.current_thread().name)
        return 1

    def bad():
        raise OSError("boom")

    loader = PRT.PrefetchLoader([load, bad, load], depth=2)
    out = list(loader)
    loader.close()
    assert out[0][1] == 1 and out[2][1] == 1
    assert isinstance(out[1][2], OSError)
    assert names and all(n != "MainThread" for n in names)


# --------------------------------------------------------------------------
# executor: retry / quarantine, through both packages
# --------------------------------------------------------------------------

def _executor_case(rt, fault_kind):
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "v"

    def compute(v):
        if v == "bad":
            raise ValueError("shape mismatch")
        return v + "!"

    if fault_kind == "transient":
        tasks = [rt.ChunkTask(0, "a", flaky)]
        cfg = rt.RuntimeConfig(max_retries=2, retry_backoff_s=0.0)
    else:
        tasks = [rt.ChunkTask(i, k, lambda k=k: k) for i, k in enumerate(["a", "bad", "c"])]
        cfg = rt.RuntimeConfig(max_retries=1, retry_backoff_s=0.0)
    acc, quar = [], []
    stats = rt.run_pipelined(tasks, compute, lambda t, r: acc.append(r), cfg=cfg,
                             on_quarantine=quar.append)
    assert quar == stats.quarantined
    return (acc, stats.n_done, stats.n_retries,
            [(q.key, q.stage, q.error, q.retries) for q in stats.quarantined])


@pytest.mark.parametrize("fault_kind", ["transient", "bad_chunk"])
def test_executor_retries_and_quarantine_match_jax(fault_kind):
    port = _executor_case(PRT, fault_kind)
    assert port == _executor_case(JRT, fault_kind)
    if fault_kind == "transient":
        assert port == (["v!"], 1, 2, [])
    else:
        assert port[0] == ["a!", "c!"]
        assert port[3] == [("bad", "compute", "ValueError: shape mismatch", 1)]


def test_executor_zero_retries_means_single_attempt():
    calls = {"n": 0}

    def bad():
        calls["n"] += 1
        raise OSError("nope")

    stats = PRT.run_pipelined([PRT.ChunkTask(0, "a", bad)], compute=lambda v: v,
                              accumulate=lambda t, r: None,
                              cfg=PRT.RuntimeConfig(prefetch_depth=2, max_retries=0,
                                                    retry_backoff_s=0.0))
    assert calls["n"] == 1 and stats.n_retries == 0
    assert [q.stage for q in stats.quarantined] == ["load"]


def test_consult_tuner_raises_for_a_store():
    cfg = PipelineConfig()
    assert PRT.consult_tuner(cfg, PRT.RuntimeConfig()) == (cfg, None)
    with pytest.raises(NotImplementedError, match="item 13"):
        PRT.consult_tuner(cfg, PRT.RuntimeConfig(tuner_store="tuner.json"))


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------

def _trace_events(rt, path):
    tw = rt.TraceWriter(path)
    with tw.span("read", file="f0.npz"):
        with tw.span("inner"):
            pass

    def worker():
        with tw.span("preprocess"):
            pass

    th = threading.Thread(target=worker)
    th.start()
    th.join()
    tw.counter("chunks", done=1, quarantined=0)
    tw.instant("retry", stage="load")
    tw.close()
    return rt.load_trace(path)


def test_trace_writer_chrome_format_matches_jax(tmp_path):
    port = _trace_events(PRT, str(tmp_path / "p.jsonl"))
    jax_ = _trace_events(JRT, str(tmp_path / "j.jsonl"))
    JRT.load_trace(str(tmp_path / "p.jsonl"))       # the JAX loader reads it
    shape = lambda evs: [(e["name"], e["ph"], sorted(e)) for e in evs
                         if e["ph"] != "M"]
    assert shape(port) == shape(jax_)
    x = [e for e in port if e["ph"] == "X"]
    assert {e["name"] for e in x} == {"read", "inner", "preprocess"}
    assert all(e["dur"] >= 0 for e in x) and len({e["tid"] for e in x}) == 2
    with open(tmp_path / "p.jsonl") as f:
        for line in f:
            json.loads(line)


# --------------------------------------------------------------------------
# manifest
# --------------------------------------------------------------------------

def test_manifest_roundtrip_reads_across_packages(tmp_path):
    path = str(tmp_path / "m.json")
    m = PRT.RunManifest(path=path, config_hash=PRT.config_hash(PipelineConfig()), date=DATE)
    m.mark_done("a.npz", 3)
    m.mark_done("b.npz", 0, health={"n_masked": 1})
    m.mark_quarantined("c.npz", "load", "BadZipFile: bad magic", retries=2)
    m.save()
    for rt in (PRT, JRT):
        m2 = rt.RunManifest.load(path)
        assert m2.config_hash == m.config_hash and m2.files == m.files
        assert m2.n_vehicles == 3 and m2.n_chunks == 1
        assert m2.is_settled("a.npz") and m2.is_settled("c.npz")
        assert not m2.is_settled("d.npz")
        assert list(m2.quarantined) == ["c.npz"] and list(m2.degraded) == ["b.npz"]


def test_config_hash_sensitivity_and_port_part():
    a = PRT.config_hash(PipelineConfig(), "xcorr", True)
    b = PRT.config_hash(PipelineConfig().replace(imaging=ImagingConfig(x0=500.0)),
                        "xcorr", True)
    c = PRT.config_hash(PipelineConfig(), "surface_wave", True)
    assert len({a, b, c}) == 3
    assert a == PRT.config_hash(PipelineConfig(), "xcorr", True)
    # the same parts hash apart in the two packages: neither resumes the other
    assert PRT.config_hash("xcorr", True) != JRT.config_hash("xcorr", True)
    assert JRT.config_hash(JPipeline(), "xcorr", True) != JRT.config_hash(
        JPipeline().replace(imaging=JImaging(x0=500.0)), "xcorr", True)


# --------------------------------------------------------------------------
# run_directory: the port against the JAX workflow, same folder, same compute
# --------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 2])
def test_run_directory_bit_identical_to_jax(tmp_path, depth):
    root = _write_dir(tmp_path, [1.0, 1.1, 1.2, 1.3, 1.4], corrupt=(2,))
    res = {pkg: _run(pkg, root, runtime=PKG[pkg][2].RuntimeConfig(
        prefetch_depth=depth, max_retries=1, retry_backoff_s=0.0)) for pkg in PKG}
    p, j = res["port"], res["jax"]
    assert p.avg_image.dtype == np.float64
    assert np.array_equal(p.avg_image, j.avg_image)
    assert (p.n_vehicles, p.n_chunks, p.complete) == (j.n_vehicles, j.n_chunks, j.complete)
    assert [(q.key, q.stage) for q in p.quarantined] == \
        [(q.key, q.stage) for q in j.quarantined] == [(f"{DATE}_020000.npz", "load")]


def test_fault_injection_bit_identical_average(tmp_path):
    """A corrupt npz mid-directory costs exactly that chunk; the average is
    bit-identical to a run over the folder without the file; a second run
    over the same out_dir recomputes nothing."""
    root_a = _write_dir(tmp_path / "a", [1.0, 1.1, 1.2, 1.3], corrupt=(1,))
    root_b = _write_dir(tmp_path / "b", [1.0, 1.2, 1.3])
    out = str(tmp_path / "res_a")
    res_a = _run("port", root_a, out=out,
                 runtime=PRT.RuntimeConfig(max_retries=1, retry_backoff_s=0.0))
    res_b = _run("port", root_b)
    assert [q.key for q in res_a.quarantined] == [f"{DATE}_010000.npz"]
    assert res_a.quarantined[0].stage == "load"
    assert res_a.n_chunks == 3 and res_a.complete
    assert np.array_equal(res_a.avg_image, res_b.avg_image)
    man = PRT.RunManifest.load(os.path.join(out, f"{DATE}_manifest.json"))
    assert man.complete and list(man.quarantined) == [f"{DATE}_010000.npz"]
    calls = []
    res_c = _run("port", root_a, out=out, compute=_counting(calls))
    assert calls == [] and res_c.n_resumed == 4
    assert np.array_equal(res_c.avg_image, res_a.avg_image)


def test_planted_faults_quarantine_and_degrade_as_in_jax(tmp_path):
    """The same seeded fault plan (a loader fault, a dead-channel chunk)
    through both packages' readers, executors and health screens."""
    root = _write_dir(tmp_path, [1.0, 1.1, 1.2, 1.3])
    keys = [f"{DATE}_{i:02d}0000.npz" for i in range(4)]
    out = {}
    for pkg in PKG:
        readers, workflow, rt, faults = PKG[pkg][:4]
        cfg = (PipelineConfig() if pkg == "port" else JPipeline())
        cfg = cfg.replace(health=type(cfg.health)(enabled=True))
        plan = faults.FaultPlan(specs=(
            faults.FaultSpec("io.read", "error", keys=(keys[1],)),
            faults.FaultSpec("io.corrupt", "dead", keys=(keys[2],), channels=(3,))), seed=4)
        with faults.injected(plan, registry=PKG[pkg][4].MetricsRegistry()) as inj:
            out[pkg] = (_run(pkg, root, cfg=cfg, runtime=rt.RuntimeConfig(
                max_retries=1, retry_backoff_s=0.0)), inj.n_injected)
    (p, pn), (j, jn) = out["port"], out["jax"]
    assert pn == jn == 3
    assert np.array_equal(p.avg_image, j.avg_image)
    assert [(q.key, q.stage) for q in p.quarantined] == [(keys[1], "load")]
    assert [(q.key, q.stage) for q in j.quarantined] == [(keys[1], "load")]
    assert p.n_degraded == j.n_degraded == 1 and p.n_chunks == j.n_chunks == 3


# --------------------------------------------------------------------------
# run_directory: kill / restart, max_chunks, invalidation
# --------------------------------------------------------------------------

def test_kill_restart_resume_bit_identical(tmp_path):
    root = _write_dir(tmp_path / "d", [1.0, 1.5, 2.0, 2.5])
    out_int = str(tmp_path / "res_int")
    ref = _run("port", root, out=str(tmp_path / "res_ref"))
    assert ref.n_chunks == 4 and ref.complete
    calls = []

    def killed(section):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt
        return _fake_compute(section)

    with pytest.raises(KeyboardInterrupt):
        _run("port", root, out=out_int, compute=killed)
    man = PRT.RunManifest.load(os.path.join(out_int, f"{DATE}_manifest.json"))
    assert not man.complete and man.n_chunks == 2
    calls2 = []
    res = _run("port", root, out=out_int, compute=_counting(calls2))
    assert len(calls2) == 2 and res.n_resumed == 2
    assert res.complete and res.n_chunks == 4
    assert np.array_equal(res.avg_image, ref.avg_image)
    assert np.array_equal(res.avg_image, _run("jax", root).avg_image)


def test_max_chunks_truncates_then_resumes(tmp_path):
    root = _write_dir(tmp_path / "d", [1.0, 1.5, 2.0])
    out = str(tmp_path / "res")
    res1 = _run("port", root, out=out, max_chunks=2)
    assert res1.n_chunks == 2 and not res1.complete
    res2 = _run("port", root, out=out)
    assert res2.n_resumed == 2 and res2.complete and res2.n_chunks == 3
    assert np.array_equal(res2.avg_image, _run("port", root).avg_image)


def test_config_change_invalidates_resume(tmp_path):
    root = _write_dir(tmp_path / "d", [1.0, 1.5])
    out = str(tmp_path / "res")
    assert _run("port", root, out=out).complete
    calls = []
    _run("port", root, out=out, compute=_counting(calls))
    assert calls == []
    res3 = _run("port", root, out=out, compute=_counting(calls),
                cfg=PipelineConfig().replace(imaging=ImagingConfig(x0=500.0)))
    assert len(calls) == 2 and res3.n_resumed == 0 and res3.complete


def test_stale_manifest_done_entry_is_recomputed(tmp_path):
    root = _write_dir(tmp_path / "d", [1.0, 1.5])
    out = str(tmp_path / "res")
    assert _run("port", root, out=out, max_chunks=1).n_chunks == 1
    mpath = os.path.join(out, f"{DATE}_manifest.json")
    man = PRT.RunManifest.load(mpath)
    man.mark_done(f"{DATE}_010000.npz", 1)
    man.save()
    res2 = _run("port", root, out=out)
    assert res2.n_chunks == 2
    assert np.array_equal(res2.avg_image, _run("port", root).avg_image)


def test_jax_written_out_dir_is_recomputed_not_resumed(tmp_path):
    root = _write_dir(tmp_path / "d", [1.0, 1.5, 2.0])
    out = str(tmp_path / "res")
    jres = _run("jax", root, out=out)
    assert jres.complete and os.path.exists(os.path.join(out, f"{DATE}_manifest.json"))
    calls = []
    pres = _run("port", root, out=out, compute=_counting(calls))
    assert len(calls) == 3 and pres.n_resumed == 0 and pres.complete
    assert np.array_equal(pres.avg_image, jres.avg_image)


def test_run_directory_needs_a_card_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    root = _write_dir(tmp_path / "d", [1.0, 1.5])
    out = str(tmp_path / "res")
    ds = PR.DirectoryDataset(DATE, root=root, ch1=None, ch2=None,
                             smoothing=False, rescale_after=None)
    calls = []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PW.run_directory(ds, out_dir=out, compute_fn=_counting(calls))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PW.run_date_range(root, DATE, DATE, out_dir=out, ch1=None, ch2=None)
    assert calls == [] and not os.path.exists(out)


def test_unported_obs_options_raise(tmp_path):
    root = _write_dir(tmp_path / "d", [1.0])
    for obs in (ObsConfig(profile_dir=str(tmp_path / "prof")),
                ObsConfig(hbm_sample_interval_s=0.5)):
        with pytest.raises(NotImplementedError, match="item 13"):
            _run("port", root, runtime=PRT.RuntimeConfig(obs=obs))


def test_run_directory_emits_valid_chrome_trace(tmp_path):
    root = _write_dir(tmp_path / "d", [1.0, 1.5])
    trace = str(tmp_path / "trace.jsonl")
    res = _run("port", root, runtime=PRT.RuntimeConfig(prefetch_depth=2, trace_path=trace))
    assert res.n_chunks == 2 and res.chunks_per_s > 0
    events = PRT.load_trace(trace)
    spans = {e["name"] for e in events if e["ph"] == "X"}
    assert {"read", "preprocess", "device_put", "compute", "accumulate"} <= spans
    assert {"chunks", "vehicles"} <= {e["name"] for e in events if e["ph"] == "C"}
    tids = {e["tid"] for e in events if e["ph"] == "X" and e["name"] in ("read", "compute")}
    assert len(tids) == 2


# --------------------------------------------------------------------------
# observability: registry, sink and flight schemas; the report script
# --------------------------------------------------------------------------

def _fill(obs):
    reg = obs.MetricsRegistry()
    c = reg.counter("das_e_total", "events", labels=("name",))
    c.labels(name='we"ird\\path\nx').inc()
    c.labels(name="b").inc(5)
    reg.gauge("das_g", "a gauge").set(-2.5)
    h = reg.histogram("das_h_ms", "ring", window=4)
    for v in (1.0, 2.0, 3.0, 4.0, 5.0):
        h.observe(v)
    return reg


def test_registry_renders_as_in_jax():
    port, jax_ = _fill(PO), _fill(JO)
    assert port.prometheus_text() == jax_.prometheus_text()
    assert port.to_json() == jax_.to_json()
    with pytest.raises(ValueError, match="already registered"):
        port.gauge("das_e_total", labels=("name",))
    g = port.gauge("das_depth")
    g.set_fn(lambda: 1 / 0)            # a dead provider must not kill reads
    assert g.value == 0.0


def test_sink_and_flight_files_load_in_both_packages(tmp_path):
    reg = _fill(PO)
    path = str(tmp_path / "deep" / "metrics.jsonl")
    sink = PO.MetricsSink(reg, path, interval_s=60.0)
    sink.flush()
    sink.close()
    snaps = JO.load_metrics_jsonl(path)
    assert len(snaps) == 2 and snaps[-1]["metrics"] == reg.to_json()
    fr = PO.FlightRecorder(capacity=4, out_dir=str(tmp_path), name="f")
    for i in range(10):
        fr.record("chunk", key=f"k{i}")
    dump = fr.dump("quarantine", key="k9")
    payload = JO.load_flight_dump(dump)
    assert payload["context"] == {"key": "k9"} and payload["n_recorded"] == 10
    assert [r["key"] for r in payload["records"]] == ["k6", "k7", "k8", "k9"]
    assert fr.dump("quarantine") is None and fr.dump("quarantine", force=True)


def test_memory_gauges_register_without_a_card():
    reg = PO.MetricsRegistry()
    wired = PO.register_memory_gauges(reg)
    assert wired == torch.cuda.device_count()
    assert reg.get("das_device_bytes_in_use") is not None
    assert reg.get("das_device_peak_bytes") is not None
    reg.prometheus_text()


def test_run_directory_obs_artifacts_render_with_obs_report(tmp_path):
    """A port run (stub compute, one corrupt file) leaves a trace, a metrics
    JSONL and a quarantine flight dump that the repository's report script
    (which reads them through the JAX package's loaders) renders."""
    root = _write_dir(tmp_path / "data", [1.0, 1.1, 1.2, 1.3], corrupt=(2,))
    obs_dir = tmp_path / "obs"
    obs_dir.mkdir()
    trace = str(obs_dir / "trace.jsonl")
    metrics = str(obs_dir / "metrics.jsonl")
    runtime = PRT.RuntimeConfig(
        prefetch_depth=2, max_retries=0, trace_path=trace,
        obs=ObsConfig(metrics_jsonl=metrics, metrics_interval_s=30.0,
                      flight_dir=str(obs_dir), trace_flush_interval_s=0.05))
    res = _run("port", root, runtime=runtime)
    assert res.n_chunks == 3 and len(res.quarantined) == 1
    dumps = [str(obs_dir / f) for f in os.listdir(obs_dir)
             if f.startswith(f"flight_{DATE}_quarantine")]
    assert len(dumps) == 1
    kinds = {r["kind"] for r in JO.load_flight_dump(dumps[0])["records"]}
    assert {"run", "chunk"} <= kinds

    import obs_report
    out = str(obs_dir / "report.txt")
    assert obs_report.main(["--flight", dumps[0], "--trace", trace,
                            "--metrics", metrics, "--out", out]) == 0
    report = open(out).read()
    assert "## flight dump" in report and "## trace" in report and "## metrics" in report
    assert "das_runtime_chunks_total" in report
    assert re.search(r"failed-record join .*\.npz", report)


def test_obs_disabled_is_genuinely_off(tmp_path):
    reg = PO.default_registry()
    fam = reg.get("das_runtime_chunks_total")
    before = fam.labels(status="done").value if fam is not None else 0.0
    tasks = [PRT.ChunkTask(i, f"t{i}", (lambda i=i: i)) for i in range(3)]
    off = ObsConfig(enabled=False, flight_dir=str(tmp_path))
    stats = PRT.run_pipelined(tasks, lambda v: v, lambda t, r: None,
                              cfg=PRT.RuntimeConfig(max_retries=0, obs=off))
    assert stats.n_done == 3
    fam = reg.get("das_runtime_chunks_total")
    assert (fam.labels(status="done").value if fam is not None else 0.0) == before
    assert os.listdir(tmp_path) == []


# --------------------------------------------------------------------------
# fault injection: the same draws in both packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["nan", "inf", "dead", "clip"])
def test_fault_corruption_matches_jax(kind):
    data = np.random.default_rng(3).standard_normal((8, 64))
    got = []
    for faults, obs in ((PF, PO), (JF, JO)):
        plan = faults.FaultPlan(specs=(faults.FaultSpec("io.corrupt", kind, keys=("k",),
                                                        param=0.25),), seed=11)
        with faults.injected(plan, registry=obs.MetricsRegistry()) as inj:
            got.append(inj.corrupt("io.corrupt", "k", data))
            assert inj.corrupt("io.corrupt", "other", data) is data
    np.testing.assert_array_equal(got[0], got[1])
    assert not np.array_equal(got[0], data)


def test_fault_plan_sample_and_sites_match_jax():
    keys = [f"{i:02d}.npz" for i in range(10)]
    a = PF.FaultPlan.sample(7, keys, n_loader_faults=3, n_corrupt=2)
    b = JF.FaultPlan.sample(7, keys, n_loader_faults=3, n_corrupt=2)
    assert [(s.site, s.kind, s.keys) for s in a.specs] == \
        [(s.site, s.kind, s.keys) for s in b.specs]
    plan = PF.FaultPlan(specs=(PF.FaultSpec("io.read", "error", keys=("b.npz",)),))
    with PF.injected(plan, registry=PO.MetricsRegistry()) as inj:
        PF.fire("io.read", "a.npz")
        with pytest.raises(PF.InjectedFault):
            PF.fire("io.read", "b.npz")
        assert inj.n_injected == 1
    PF.fire("io.read", "b.npz")


# --------------------------------------------------------------------------
# readers and artifacts: files round-trip between the two packages
# --------------------------------------------------------------------------

def test_npz_roundtrip_between_packages(tmp_path):
    data, x, t = _arrays(1.0, nch=16, nt=120)
    t = (np.arange(120) - 10) * 0.004     # a 10-sample taper pad each side
    x = np.arange(400.0, 416.0)
    p_path, j_path = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    PR.save_section_npz(p_path, DasSection(torch.from_numpy(data), torch.from_numpy(x),
                                           torch.from_numpy(t)))
    JR.save_section_npz(j_path, JSection(data, x, t))
    for path in (p_path, j_path):
        got = PR.read_npz_section(path, ch1=404, ch2=410)
        want = JR.read_npz_section(path, ch1=404, ch2=410)
        assert got.data.dtype == torch.float64 and got.data.shape == (6, 100)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
        np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))


def test_npz_reader_keeps_the_file_dtype(tmp_path):
    data, x, t = _arrays(1.0)
    path = str(tmp_path / "f32.npz")
    np.savez(path, data=data.astype(np.float32), x_axis=x, t_axis=t)
    got = PR.read_npz_section(path, cut_taper=False)
    assert got.data.dtype == torch.float32 and got.x.dtype == torch.float64
    np.testing.assert_array_equal(got.data.numpy(), data.astype(np.float32))


def test_segy_roundtrip_between_packages(tmp_path):
    data = np.random.default_rng(5).standard_normal((12, 250)).astype(np.float32)
    p_path, j_path = str(tmp_path / "p.segy"), str(tmp_path / "j.segy")
    PS.write_segy(p_path, data, dt=0.004)
    JS.write_segy(j_path, data, dt=0.004)
    assert open(p_path, "rb").read() == open(j_path, "rb").read()
    for ch1, ch2 in ((0, None), (2, 5)):
        got = PR.read_segy_section(p_path, ch1=ch1, ch2=ch2)
        want = JR.read_segy_section(j_path, ch1=ch1, ch2=ch2)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))
    raw = np.array([0x42640000, 0xC2640000, 0x41100000], dtype=np.uint32)
    np.testing.assert_array_equal(PS._ibm_to_float(raw), [100.0, -100.0, 1.0])


def test_multi_file_concat_matches_jax(tmp_path):
    dt = 0.004
    paths = []
    for i, (val, nt) in enumerate(((1.0, 50), (2.0, 60))):
        p = str(tmp_path / f"x{i}.npz")
        np.savez(p, data=val * np.ones((4, nt)), x_axis=np.arange(4.0),
                 t_axis=np.arange(nt) * dt)
        paths.append(p)
    got = PR.read_sections(paths, cut_taper=False)
    want = JR.read_sections(paths, cut_taper=False)
    assert got.data.shape == (4, 110)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))


@pytest.mark.parametrize("smoothing", [False, True])
def test_directory_dataset_matches_jax(tmp_path, smoothing):
    day = tmp_path / "20230301"
    day.mkdir()
    for h in (0, 1):
        data, _, _ = _arrays(1.0 + h, nch=8, nt=100, seed=h)
        np.savez(str(day / f"20230301_0{h}0000.npz"), data=data,
                 x_axis=np.arange(400.0, 408.0), t_axis=np.arange(100) * 0.004)
    kw = dict(root=str(tmp_path), ch1=401, ch2=407, smoothing=smoothing)
    ds, jds = PR.DirectoryDataset("20230301", **kw), JR.DirectoryDataset("20230301", **kw)
    assert len(ds) == 2 and ds.time_interval() == jds.time_interval() == 3600.0
    for i in range(2):
        got, want = ds[i], jds[i]
        assert got.data.shape == (6, 100)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


def test_artifacts_roundtrip_between_packages(tmp_path):
    rng = np.random.default_rng(9)
    xcf = rng.standard_normal((28, 100)).astype(np.float32)
    offs, lags = np.linspace(-150.0, 70.0, 28), (np.arange(100) - 50) * 0.004
    PA.save_gather_npz(str(tmp_path / "g.npz"), xcf, offs, lags)
    g = JA.load_gather_npz(str(tmp_path / "g.npz"))
    np.testing.assert_array_equal(g.xcf, xcf)
    np.testing.assert_array_equal(g.offsets, offs)
    fv, freqs, vels = rng.standard_normal((50, 40)), np.arange(0.8, 4.8, 0.1), np.arange(200.0, 250.0)
    JA.save_dispersion_npz(str(tmp_path / "d.npz"), fv, freqs, vels)
    d = PA.load_dispersion_npz(str(tmp_path / "d.npz"))
    assert set(np.load(str(tmp_path / "d.npz")).files) == {"freqs", "vels", "fv_map"}
    np.testing.assert_array_equal(d.fv_map, fv)
    np.testing.assert_array_equal(d.vels, vels)
    gathers = rng.standard_normal((10, 19, 64)).astype(np.float32)
    PA.save_window_gathers(str(tmp_path / "w.npz"), gathers, np.ones(10, bool),
                           np.linspace(-150.0, 0.0, 19), (np.arange(64) - 32) * 0.004)
    w = JA.load_window_gathers(str(tmp_path / "w.npz"))
    np.testing.assert_array_equal(w.gathers, gathers)
    assert w.valid.all()
