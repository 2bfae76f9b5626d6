"""The port's device timeline and request ids (``runtime/tracing.py``) on the
CPU: ``TraceWriter.device`` on its own track, ``DeviceTimeline`` creating no
event without a card or with a tracer that keeps no device timeline, the
spans that ``run_directory`` and the serving engine emit, and the loader's
staging unit (``runtime/staging.py``).

Without a card, the cases that follow the spans through the program stand
in a clock the test steps itself for CUDA events (``fake_card``): the gating
by ``device_timeline`` is the program's own, only the events and streams are
fakes.  A tracer that takes the same clock puts host and device spans on one
time line whose lengths and order do not depend on the host's load.  ``tests/test_torch_cuda.py`` holds the timeline against
``torch.profiler`` on the card.
"""

import contextlib
import sys
import threading
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
from das_diff_veh_tpu_torch.runtime import staging
from das_diff_veh_tpu_torch.runtime.staging import Stager, copy_threads, slab_plan
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


class _Clock:
    """Microseconds that move only as the test says: ``tick`` on every read
    (so that reads in turn are ordered) and ``advance(us)`` in between."""

    def __init__(self, tick=1):
        self.us, self.tick = 0, tick
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            self.us += self.tick
            return float(self.us)

    def advance(self, us):
        with self._lock:
            self.us += us


class _FakeEvent:
    """A CUDA event on :attr:`clock`; counts how many were made."""

    made = 0
    clock = _Clock()

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = type(self).clock()

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e3


@pytest.fixture
def fake_card(monkeypatch):
    """Every device counts as a card, and its events are :class:`_FakeEvent`
    on a fresh :class:`_Clock` (``fake_card.clock``)."""
    _FakeEvent.made = 0
    monkeypatch.setattr(_FakeEvent, "clock", _Clock())
    monkeypatch.setattr(T, "_on_card", lambda device: device is not None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    return _FakeEvent


class _Recorder(T.TraceWriter):
    """A trace writer that also keeps every ``device`` and ``counter`` call;
    with ``clock``, its spans and ``now_us`` read that clock."""

    def __init__(self, path, device_timeline=True, clock=None):
        super().__init__(path)
        self.device_timeline = device_timeline
        self.device_calls = []
        self.counters = []
        if clock is not None:
            self._now_us = clock

    def device(self, name, start_us, end_us, **args):
        self.device_calls.append((name, start_us, end_us, args))
        super().device(name, start_us, end_us, **args)

    def counter(self, name, **values):
        self.counters.append((name, values))
        super().counter(name, **values)


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


def test_device_spans_cover_the_marked_blocks_of_a_unit(fake_card, tmp_path, monkeypatch):
    """A unit emits one span for each ``device_work`` block inside it, and
    none for the host work between them; a block outside a unit makes no
    event; a unit that raises emits nothing.  The blocks step a clock that
    the tracer shares and that moves only when stepped, so each span's
    length and place are exact."""
    clock = _Clock(tick=0)
    monkeypatch.setattr(fake_card, "clock", clock)
    tr = _Recorder(str(tmp_path / "t.jsonl"), clock=clock)
    tl = T.DeviceTimeline(tr, "cuda")
    with T.device_work():
        pass
    assert fake_card.made == 0
    with tl.unit("device_compute", key="k"):
        with T.device_work():
            clock.advance(2000)
        t_host = tr.now_us()
        clock.advance(10000)                 # host work: the device waits
        with T.device_work():
            clock.advance(3000)
    with pytest.raises(RuntimeError):
        with tl.unit("device_compute", key="lost"):
            with T.device_work():
                raise RuntimeError("fails")
    tr.close()
    assert [(n, a) for n, _, _, a in tr.device_calls] == [("device_compute", {"key": "k"})] * 2
    (_, s0, e0, _), (_, s1, e1, _) = tr.device_calls
    assert 2e3 <= e0 - s0 < 9e3 and 3e3 <= e1 - s1 < 9e3
    assert e0 <= t_host < t_host + 1e4 <= s1
    assert (e0 - s0, e1 - s1, t_host - e0, s1 - t_host) == (2e3, 3e3, 0.0, 1e4)


def test_run_directory_device_spans_carry_the_chunk_key(fake_card, tmp_path):
    """Each computed chunk gives one ``device_compute`` span with its key,
    inside that chunk's host ``compute`` span, on the tracer's clock (the
    fake card's, which every read moves on, so the order of the reads alone
    places the spans)."""
    path = str(tmp_path / "t.jsonl")
    tr = _Recorder(path, clock=fake_card.clock)
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


def test_staging_on_the_cpu_leaves_the_tensor_as_it_is():
    """On the CPU both halves of the staging hand back the tensor they were
    given, its dtype kept, and an on-card step does not run."""
    st = Stager("cpu", T.NullTracer())
    host = torch.arange(6, dtype=torch.float64)
    assert st.stream is None
    assert st.put(host, "device_stage", key="a") is host
    assert st.put(host, "device_stage", lambda raw: 1 / 0, key="a") is host
    assert st.claim(host) is host


def _ring_on_the_cpu(monkeypatch, slab_bytes):
    """The ring's slabs in plain host memory, ``slab_bytes`` each."""
    monkeypatch.setattr(staging, "SLAB_BYTES", slab_bytes)
    monkeypatch.setattr(staging, "pinned_slab",
                        lambda nbytes: torch.empty(nbytes, dtype=torch.uint8))


class _Stream:
    """A side stream whose wait is logged in ``order``."""

    def __init__(self, order):
        self.order = order

    def synchronize(self):
        self.order.append("wait")


def test_the_on_card_step_runs_inside_the_staging_unit(fake_card, tmp_path, monkeypatch):
    """``Stager.put`` on a (fake) card: the host array's bytes go through the
    ring piece by piece (each slot waited for, filled, its copy enqueued and
    its event recorded; a slot is filled again only after its wait), then
    the step, all inside the unit's one device block, and the side stream is
    waited for before the unit ends; without a step the host casts to
    float32 before the copy.  Each put sends the ``staged`` counter's
    running totals."""
    clock = fake_card.clock
    tr = _Recorder(str(tmp_path / "t.jsonl"), clock=clock)
    _ring_on_the_cpu(monkeypatch, 16)
    st = Stager("cpu", tr)
    order, inside = [], []
    record, synchronize = fake_card.record, fake_card.synchronize

    def logged_record(self, stream=None):
        record(self, stream)
        order.append(("record", self))

    def logged_synchronize(self):
        synchronize(self)
        order.append(("slot", self))

    fill = Stager._fill
    monkeypatch.setattr(fake_card, "record", logged_record)
    monkeypatch.setattr(fake_card, "synchronize", logged_synchronize)
    monkeypatch.setattr(Stager, "_fill", lambda self, slab, piece: (
        order.append(("fill", piece.dtype, piece.nbytes)), fill(self, slab, piece)))

    def step(raw):
        order.append("step")
        clock.advance(5000)
        inside.append(clock())
        return (raw * 2).to(torch.float32)

    st.stream = _Stream(order)
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    host = torch.arange(12, dtype=torch.float64).reshape(3, 4)
    out = st.put(host, "device_stage", step, key="a")
    assert torch.equal(out, (host * 2).to(torch.float32))
    slot = {id(e): k for k, (*_, e) in enumerate(st._ring)}

    def ring_order():
        return [(o[0], slot[id(o[1])]) if o[0] in ("record", "slot") else o
                for o in order if not (o[0] in ("record", "slot") and id(o[1]) not in slot)]

    # 96 bytes in 6 pieces of 16 over 3 slots
    assert ring_order() == [x for k in range(6) for x in
                            (("slot", k % 3), ("fill", np.uint8, 16), ("record", k % 3))] + [
                                "step", "wait"]
    (name, s, e, args), = tr.device_calls
    assert (name, args) == ("device_stage", {"key": "a"})
    assert s < inside[0] < e and e - s > 5000
    assert tr.counters == [("staged", {"bytes": 96, "slabs": 6})]
    order.clear()
    plain = st.put(host, "ambient_stage", record=3)
    assert plain.dtype == torch.float32 and torch.equal(plain, host.to(torch.float32))
    # 48 bytes of float32: 3 pieces, the ring's slots from the first again
    assert ring_order() == [x for k in range(3) for x in
                            (("slot", k), ("fill", np.uint8, 16), ("record", k))] + ["wait"]
    assert [(n, a) for n, _, _, a in tr.device_calls[1:]] == [("ambient_stage", {"record": 3})]
    assert tr.counters[1:] == [("staged", {"bytes": 144, "slabs": 9})]
    tr.close()


@pytest.mark.parametrize("nbytes,slab", [(0, 8), (1, 8), (8, 8), (9, 8), (139, 8),
                                         (64 << 20, 64 << 20), ((64 << 20) + 1, 64 << 20)])
def test_the_slab_plan_covers_the_bytes_once_in_order(nbytes, slab):
    """The pieces lie end to end from 0 to ``nbytes``, each a slab long but
    the last, which may be shorter; no bytes, no piece."""
    plan = slab_plan(nbytes, slab)
    assert len(plan) == -(-nbytes // slab)
    assert [a for a, _ in plan] == [b for _, b in [(0, 0)] + plan][:len(plan)]
    assert sum(b - a for a, b in plan) == nbytes and (not plan or plan[-1][1] == nbytes)
    assert all(b - a == slab for a, b in plan[:-1])
    assert all(0 < b - a <= slab for a, b in plan)


@pytest.mark.parametrize("cores,threads", [(1, 1), (2, 1), (3, 1), (4, 2), (6, 3), (8, 4),
                                           (12, 6), (16, 8), (32, 8), (64, 8)])
def test_copy_threads_leave_cores_and_stop_at_the_knee(monkeypatch, cores, threads):
    """Half the cores fill the slabs, at least one and at most eight."""
    monkeypatch.setattr(staging.os, "sched_getaffinity", lambda pid: set(range(cores)))
    assert copy_threads() == threads


class _Counters(T.NullTracer):
    """A tracer that keeps its counters alone."""

    def __init__(self):
        self.counters = []

    def counter(self, name, **values):
        self.counters.append((name, values))


@pytest.mark.parametrize("shape,dtype", [((0, 5), torch.float32), ((1,), torch.float32),
                                         ((7, 143), torch.float32), ((9, 61), torch.float64)])
def test_the_ring_fills_a_slab_in_parts_on_threads(fake_card, monkeypatch, shape, dtype):
    """Three copy threads, each a part of every slab (parts on 8-byte
    boundaries), give back the host array's bytes; a zero-size array gives
    no piece; :meth:`Stager.close` stops the threads."""
    _ring_on_the_cpu(monkeypatch, 40)
    monkeypatch.setattr(staging, "PART_ALIGN", 8)
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    tr = _Counters()
    st = Stager("cpu", tr)
    st.stream, st._threads = _Stream([]), 3
    host = torch.from_numpy(np.random.default_rng(5).standard_normal(shape)).to(dtype)
    out = st.put(host, "device_stage", lambda raw: raw.clone(), key="b")
    assert out.dtype == dtype and torch.equal(out, host)
    nbytes = host.numel() * host.element_size()
    assert tr.counters == [("staged", {"bytes": nbytes, "slabs": -(-nbytes // 40)})]
    pool = st._pool
    st.close()
    assert st._pool is None and pool._shutdown


def test_blocks_on_another_card_keep_a_clock_anchor_of_their_own(fake_card, tmp_path):
    """A block that names another card marks on that card and is timed from
    that card's own anchor (CUDA times two events only on one card); the
    block's own arguments join the unit's."""
    tracer = _Recorder(str(tmp_path / "t.jsonl"), clock=fake_card.clock)
    home, other = torch.device("cpu"), torch.device("cpu", 1)
    tl = T.DeviceTimeline(tracer, home)
    with tl.unit("record", record=2):
        with T.device_work("cross", card=0):
            pass
        fake_card.clock.advance(500)
        with T.device_work("cross", device=other, card=1):
            fake_card.clock.advance(40)
    assert set(tl._anchors) == {home, other}
    (n0, s0, e0, a0), (n1, s1, e1, a1) = tracer.device_calls
    assert (n0, a0, n1, a1) == ("cross", {"record": 2, "card": 0},
                                "cross", {"record": 2, "card": 1})
    assert e1 - s1 >= 40 and s1 >= e0 + 500


def test_split_day_stack_device_blocks_carry_their_card(fake_card, tmp_path):
    """A day stack over four shards: a record gives one ``ambient_spectra``
    block, an ``ambient_scatter`` block on each shard sent to, and an
    ``ambient_cross`` and an ``ambient_finish`` block a chunk, each on its
    shard with ``card``, the shard's place."""
    from das_diff_veh_tpu_torch.config import AmbientConfig
    from das_diff_veh_tpu_torch.pipeline.ambient import DayStack, stack_records

    recs = [np.random.default_rng(k).standard_normal((100, 1200)).astype(np.float32)
            for k in range(2)]
    tracer = _Recorder(str(tmp_path / "t.jsonl"))
    cfg = AmbientConfig(fs=1000.0, wlen=256, band_hz=(20.0, 300.0), max_offset=8,
                        max_lag=20, src_chunk=16)
    stack = DayStack(100, cfg, devices=["cpu"] * 4)
    run = stack_records(recs, stack=stack, tracer=tracer)
    tracer.close()
    assert run.records == 2
    chunks = {p.index: len(p.schedule) for p in stack._parts}
    for record in (0, 1):
        seen = [(n, a.get("card")) for n, _, _, a in tracer.device_calls
                if a["record"] == record]
        assert seen.count(("ambient_spectra", None)) == 1
        assert sorted(c for n, c in seen if n == "ambient_scatter") == [1, 2, 3]
        for name in ("ambient_cross", "ambient_finish"):
            by_card = [c for n, c in seen if n == name]
            assert {c: by_card.count(c) for c in set(by_card)} == chunks, name
