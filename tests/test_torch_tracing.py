"""The port's device timeline and request ids (``runtime/tracing.py``) on the
CPU: ``TraceWriter.device`` on its own track, ``DeviceTimeline`` creating no
event without a card or with a tracer that keeps no device timeline, and the
spans that ``run_directory`` and the serving engine emit.

Without a card, the cases that follow the spans through the program stand
in a host clock for CUDA events (``fake_card``): the gating by
``device_timeline`` is the program's own, only the events and streams are
fakes.  ``tests/test_torch_cuda.py`` holds the timeline against
``torch.profiler`` on the card.
"""

import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import das_diff_veh_tpu_torch.runtime.tracing as T
from das_diff_veh_tpu_torch.config import ImagingConfig, PipelineConfig, ServeConfig
from das_diff_veh_tpu_torch.core.section import DasSection
from das_diff_veh_tpu_torch.io.readers import DirectoryDataset
from das_diff_veh_tpu_torch.pipeline.workflow import run_directory
from das_diff_veh_tpu_torch.runtime import RuntimeConfig
from das_diff_veh_tpu_torch.serve import (FnComputeFactory, ImagingComputeFactory,
                                          ServingEngine)

DATE = "20230110"
SERVE_SPANS = {"admit", "queue", "pad", "compute", "unpad"}
FACTORY_SPANS = {"stage_in", "device_stage", "device_compute"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


class _FakeEvent:
    """A CUDA event on the host clock; counts how many were made."""

    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def fake_card(monkeypatch):
    """Every device counts as a card, and its events are :class:`_FakeEvent`."""
    _FakeEvent.made = 0
    monkeypatch.setattr(T, "_on_card", lambda device: device is not None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    return _FakeEvent


class _Recorder(T.TraceWriter):
    """A trace writer that also keeps every ``device`` call."""

    def __init__(self, path, device_timeline=True):
        super().__init__(path)
        self.device_timeline = device_timeline
        self.device_calls = []

    def device(self, name, start_us, end_us, **args):
        self.device_calls.append((name, start_us, end_us, args))
        super().device(name, start_us, end_us, **args)


def _write_dir(root, n=3):
    day = root / DATE
    day.mkdir(parents=True)
    x = np.arange(8, dtype=np.float64)
    t = np.arange(64, dtype=np.float64) / 250.0
    for i in range(n):
        np.savez(day / f"{DATE}_{i:02d}0000.npz", data=np.full((8, 64), float(i + 1)),
                 x_axis=x, t_axis=t)
    return str(root)


def _fake_compute(section):
    """A stand-in chunk that marks its device work as the program's do."""
    with T.device_work():
        img = torch.as_tensor(section.data)[:2, :4] * 1.0
    return 1, img.numpy()


def _run_dir(root, tracer):
    ds = DirectoryDataset(DATE, root=root, ch1=None, ch2=None, smoothing=False,
                          rescale_after=None)
    return run_directory(ds, compute_fn=_fake_compute, tracer=tracer, device="cpu",
                         runtime=RuntimeConfig(prefetch_depth=2))


def _sum_build(bucket):
    def compute(section, valid, state):
        return float(np.asarray(section.data).sum()), state
    return compute


def test_trace_writer_device_events_on_their_own_track(tmp_path):
    path = str(tmp_path / "t.jsonl")
    tw = T.TraceWriter(path)
    assert tw.device_timeline and not T.NullTracer.device_timeline
    with tw.span("compute", key="a"):
        t0 = tw.now_us()
    tw.device("device_compute", t0, t0 + 1500.0, key="a")
    tw.device("device_stage", t0 + 2000.0, t0 + 2100.0, key="b")
    tw.close()
    events = T.load_trace(path)
    dev = [e for e in events if e.get("cat") == "device"]
    assert [(e["name"], e["ph"], e["tid"], e["dur"], e["args"]) for e in dev] == [
        ("device_compute", "X", T.DEVICE_TID, 1500.0, {"key": "a"}),
        ("device_stage", "X", T.DEVICE_TID, 100.0, {"key": "b"})]
    names = [e for e in events if e["ph"] == "M" and e["tid"] == T.DEVICE_TID]
    assert [e["args"]["name"] for e in names] == ["device"]
    host = [e for e in events if e["name"] == "compute"]
    assert host[0]["tid"] != T.DEVICE_TID and host[0]["ts"] <= dev[0]["ts"]


class _NoTimeline:
    """A tracer without the attribute, as an outside tracer may be."""

    def now_us(self):
        return 0.0

    def close(self):
        pass


@pytest.mark.parametrize("tracer", ["null", "flag_false", "no_attribute"])
def test_device_timeline_makes_no_event_unless_asked(monkeypatch, tmp_path, tracer):
    """No CUDA event is made on the CPU, nor on a card for a tracer that
    keeps no device timeline; a TraceWriter on a card is active."""
    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    tr = {"null": T.NullTracer(), "flag_false": _Recorder(str(tmp_path / "f"), False),
          "no_attribute": _NoTimeline()}[tracer]
    writer = T.TraceWriter(str(tmp_path / "w"))
    try:
        for dev in ("cpu", torch.device("cuda", 0)):
            tl = T.DeviceTimeline(tr, dev)
            assert not tl.active and tl.mark() is None and tl.offset_us() is None
            tl.emit("device_compute", None, None)
        assert not T.DeviceTimeline(writer, "cpu").active
        assert T.DeviceTimeline(writer, "cuda").active
    finally:
        writer.close()
        tr.close()


@pytest.mark.parametrize("tracer", ["null", "flag_false"])
def test_no_device_call_from_the_program_without_a_timeline(fake_card, tmp_path, tracer):
    """On a (fake) card, ``run_directory`` and the serving engine make no
    event and call no ``device()`` for NullTracer or a tracer whose
    ``device_timeline`` is false."""
    tr = T.NullTracer() if tracer == "null" else _Recorder(str(tmp_path / "t"), False)
    res = _run_dir(_write_dir(tmp_path / "d"), tr)
    assert res.n_chunks == 3
    eng = ServingEngine(FnComputeFactory(_sum_build, "t"),
                        ServeConfig(buckets=((8, 32),)), tracer=tr).start()
    try:
        eng.process(DasSection(np.ones((8, 20), np.float32), np.arange(8.0),
                               np.arange(20.0)), timeout=30)
    finally:
        eng.close()
    tr.close()
    assert fake_card.made == 0
    assert getattr(tr, "device_calls", []) == []


def test_device_spans_cover_the_marked_blocks_of_a_unit(fake_card, tmp_path):
    """A unit emits one span for each ``device_work`` block inside it, and
    none for the host work between them; a block outside a unit makes no
    event; a unit that raises emits nothing."""
    tr = _Recorder(str(tmp_path / "t.jsonl"))
    tl = T.DeviceTimeline(tr, "cuda")
    with T.device_work():
        pass
    assert fake_card.made == 0
    with tl.unit("device_compute", key="k"):
        with T.device_work():
            time.sleep(0.002)
        t_host = tr.now_us()
        time.sleep(0.01)                     # host work: the device waits
        with T.device_work():
            time.sleep(0.003)
    with pytest.raises(RuntimeError):
        with tl.unit("device_compute", key="lost"):
            with T.device_work():
                raise RuntimeError("fails")
    tr.close()
    assert [(n, a) for n, _, _, a in tr.device_calls] == [("device_compute", {"key": "k"})] * 2
    (_, s0, e0, _), (_, s1, e1, _) = tr.device_calls
    assert 2e3 <= e0 - s0 < 9e3 and 3e3 <= e1 - s1 < 9e3
    assert e0 <= t_host < t_host + 1e4 <= s1


def test_run_directory_device_spans_carry_the_chunk_key(fake_card, tmp_path):
    """Each computed chunk gives one ``device_compute`` span with its key,
    inside that chunk's host ``compute`` span, on the tracer's clock."""
    path = str(tmp_path / "t.jsonl")
    tr = _Recorder(path)
    res = _run_dir(_write_dir(tmp_path / "d"), tr)
    tr.close()
    assert res.n_chunks == 3
    events = T.load_trace(path)
    dev = [e for e in events if e.get("cat") == "device"]
    host = {e["args"]["key"]: e for e in events if e["name"] == "compute"}
    assert sorted(e["args"]["key"] for e in dev) == sorted(host)
    assert {e["name"] for e in dev} == {"device_compute"}   # the CPU stages nothing
    for e in dev:
        h = host[e["args"]["key"]]
        assert h["ts"] - 1.0 <= e["ts"] and e["ts"] + e["dur"] <= h["ts"] + h["dur"] + 1.0
    # the report script aggregates the device spans by name, as any span
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    import obs_report

    lines = []
    obs_report.render_trace(events, lines)
    row = next(line.split() for line in lines if line.split()[:1] == ["device_compute"])
    assert int(row[1]) == 3


def test_engine_spans_of_a_request_share_its_rid(fake_card, tmp_path):
    """An imaging engine on the CPU: every request's ``admit``, ``queue``,
    ``pad``, ``compute``, ``unpad``, ``stage_in`` and device spans carry one
    ``rid``, a different one for each request; ``admit`` runs on the
    sender's thread; only the warm-up's program spans have no ``rid``."""
    from das_diff_veh_tpu_torch.io.synthetic import SceneConfig, synthesize_section

    sec = synthesize_section(SceneConfig(nch=60, duration=40.0, n_vehicles=2, seed=3,
                                         speed_range=(12.0, 18.0)))[0]
    data = np.asarray(sec.data).astype(np.float32)
    x, t = np.asarray(sec.x), np.asarray(sec.t)
    cfg = PipelineConfig().replace(imaging=ImagingConfig(x0=250.0))
    path = str(tmp_path / "t.jsonl")
    tr = _Recorder(path)
    eng = ServingEngine(ImagingComputeFactory(cfg, x_is_channels=False, x_axis=x,
                                              device="cpu"),
                        ServeConfig(buckets=(data.shape,)), tracer=tr).start()
    senders = []
    try:
        futures = []

        def send():
            futures.append(eng.submit(DasSection(data, x, t)))
            senders.append(threading.get_ident())

        for _ in range(2):
            th = threading.Thread(target=send)
            th.start()
            th.join(timeout=60)
            assert not th.is_alive()
        for f in futures:
            assert f.result(timeout=300).n_windows >= 1
    finally:
        eng.close()
        tr.close()
    events = [e for e in T.load_trace(path) if e["ph"] == "X"]
    by_rid = {}
    for e in events:
        by_rid.setdefault(e["args"].get("rid"), []).append(e)
    untagged = by_rid.pop(None)
    assert {e["name"] for e in untagged} == {"warmup"} | FACTORY_SPANS
    assert len(by_rid) == 2
    for spans in by_rid.values():
        names = [e["name"] for e in spans]
        assert set(names) == SERVE_SPANS | FACTORY_SPANS
        assert all(names.count(n) == 1 for n in SERVE_SPANS | {"stage_in", "device_stage"})
        admit = next(e for e in spans if e["name"] == "admit")
        assert admit["tid"] in senders
        assert {e["tid"] for e in spans if e.get("cat") == "device"} == {T.DEVICE_TID}


def test_stages_keep_each_block_under_its_stage_until_the_unit_ends(fake_card, tmp_path):
    """Named ``device_work`` blocks in a unit come out as spans of their own
    names (an unnamed one of the unit's) with the unit's arguments, all at
    once when the unit ends; outside a unit a named block is nothing, an
    inactive timeline makes no event, and a tracer that turns its device
    timeline off part way stops the events from its next mark on."""
    tracer = _Recorder(str(tmp_path / "t.jsonl"))
    tl = T.DeviceTimeline(tracer, torch.device("cpu"))
    with tl.unit("record", record=3):
        for name in ("cross", "finish", "cross", None):
            with T.device_work(name):
                pass
        assert tracer.device_calls == []
    assert [(n, a) for n, _, _, a in tracer.device_calls] == \
        [(n, {"record": 3}) for n in ("cross", "finish", "cross", "record")]
    assert all(e >= s for _, s, e, _ in tracer.device_calls)
    with T.device_work("cross"):
        pass
    assert len(tracer.device_calls) == 4
    made = fake_card.made
    off = T.DeviceTimeline(_Recorder(str(tmp_path / "u.jsonl"), device_timeline=False),
                           torch.device("cpu"))
    with off.unit("record", record=4), T.device_work("cross"):
        pass
    assert fake_card.made == made
    with tl.unit("record", record=5):
        with T.device_work("cross"):
            pass
        tracer.device_timeline = False
        with T.device_work("finish"):
            pass
    assert not tl.active and fake_card.made == made + 2
    assert [(n, a) for n, _, _, a in tracer.device_calls[4:]] == [("cross", {"record": 5})]
    tracer.close()


def test_day_stack_device_spans_by_stage(fake_card, tmp_path):
    """The day stack's device blocks through the program: a record gives one
    ``ambient_spectra`` span and an ``ambient_cross`` and an
    ``ambient_finish`` span a source chunk, each with its ``record``."""
    from das_diff_veh_tpu_torch.config import AmbientConfig
    from das_diff_veh_tpu_torch.pipeline.ambient import stack_records

    recs = [np.random.default_rng(k).standard_normal((40, 1200)).astype(np.float32)
            for k in range(2)]
    tracer = _Recorder(str(tmp_path / "t.jsonl"))
    cfg = AmbientConfig(fs=1000.0, wlen=256, band_hz=(20.0, 300.0), max_offset=8,
                        max_lag=20, src_chunk=16)
    run = stack_records(recs, cfg, tracer=tracer, device="cpu")
    tracer.close()
    assert run.records == 2 and len(run.stack.schedule) == 3
    for name, per in [("ambient_spectra", 1), ("ambient_cross", 3), ("ambient_finish", 3)]:
        seen = [a["record"] for n, _, _, a in tracer.device_calls if n == name]
        assert sorted(seen) == [0] * per + [1] * per, name
    assert {n for n, *_ in tracer.device_calls} == {"ambient_spectra", "ambient_cross",
                                                     "ambient_finish"}
