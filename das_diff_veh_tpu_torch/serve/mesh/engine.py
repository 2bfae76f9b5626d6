"""Multi-tenant serving engine over the slots of a mesh (the port of
``das_diff_veh_tpu/serve/mesh/engine.py``).

The base engine's dispatcher fanned out over a mesh: one
:class:`MeshServingEngine` sends admitted requests to

- **N replica workers** — one thread per slot of
  ``parallel.mesh.make_mesh(replicas, device=...)`` (one a card by default,
  CPU slots with ``device="cpu"``, slots dealt round the cards with
  ``device="cuda"``), each draining its own
  :class:`~das_diff_veh_tpu_torch.serve.mesh.tenancy.FairQueue` through the
  single-device program bound to its slot's device, and holding that device
  as the thread's current CUDA device for its whole loop (the current
  device is per thread; JAX scopes ``jax.default_device`` per call);
- **one ring worker** — driving the channel-sharded all-pairs ring across
  the whole mesh for large-geometry requests (``ring_min_channels``; see
  serve/mesh/allpairs.py for the factory contract and the bit-exactness pin
  vs the single-device program).

Placement happens at admission (:class:`PlacementPolicy`: ring route,
session stickiness, least-loaded) and the program cache holds ONE entry
per ``(bucket, placement)`` — warm-up covers every placement, so the
zero-steady-state-build SLO holds on every worker.  Each worker runs the
base engine's continuous batching against its own queue: companions are
admitted at member boundaries in fair-share order (heads only, preserving
per-tenant FIFO and therefore per-session execution order).

Multi-tenancy is enforced at submit (quota / quarantine / drain gates —
serve/mesh/tenancy.py) and unwound in the ``_finish`` hook, which every
terminal path of the base engine calls exactly once per request; per-tenant
outcome counters and latency histograms land in the same registry the
single-engine metrics do, so one Prometheus scrape covers the whole mesh.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, List, Optional

from das_diff_veh_tpu_torch.config import MeshServeConfig
from das_diff_veh_tpu_torch.core.section import DasSection
from das_diff_veh_tpu_torch.device import device_scope
from das_diff_veh_tpu_torch.obs.flight import FlightRecorder
from das_diff_veh_tpu_torch.obs.registry import MetricsRegistry
from das_diff_veh_tpu_torch.serve.compile_cache import ComputeFactory
from das_diff_veh_tpu_torch.serve.engine import (EngineClosedError, PoisonInputError,
                                                 QueueFullError, ServingEngine, ShedError,
                                                 ShutdownError, _Request)
from das_diff_veh_tpu_torch.serve.mesh.placement import (RING, Placement, PlacementPolicy)
from das_diff_veh_tpu_torch.serve.mesh.tenancy import FairQueue, TenantTable
from das_diff_veh_tpu_torch.serve.session import SessionStore

log = logging.getLogger("das_diff_veh_tpu_torch.serve.mesh")

DEFAULT_TENANT = "default"


class NoReplicaError(ShedError):
    """Every replica is draining and the request has no ring route."""

    http_status = 503                  # whole-engine unavailability


class _Replica:
    """One replica worker: its slot's device + queue + drain flag + thread."""

    def __init__(self, index: int, device):
        self.index = index
        self.device = device
        self.placement = Placement("replica", index)
        self.queue = FairQueue()
        self.draining = threading.Event()
        self.thread: Optional[threading.Thread] = None


class MeshServingEngine(ServingEngine):
    """Continuous batching across the slots of a mesh, multi-tenant.

    ``device``: where the replica slots live (``make_mesh(cfg.replicas,
    device=device)``: ``None`` = one a card, raising without one).
    ``mesh``: the ring placements' :class:`~das_diff_veh_tpu_torch.parallel.mesh.Mesh`;
    defaults to the factory's ``mesh``, else ``make_mesh(cfg.ring_devices,
    device=device)``, when the ring route is enabled.  Everything else (buckets, deadlines, health screen,
    obs) rides the wrapped ``cfg.serve``.  The engine serves from one
    process: in a ``torch.distributed`` group of more than one rank it
    raises ``NotImplementedError``.
    """

    def __init__(self, factory: ComputeFactory,
                 cfg: Optional[MeshServeConfig] = None, mesh=None,
                 tracer=None, registry: Optional[MetricsRegistry] = None,
                 flight: Optional[FlightRecorder] = None, device=None):
        from das_diff_veh_tpu_torch.parallel import distributed
        from das_diff_veh_tpu_torch.parallel.mesh import make_mesh

        if distributed.world_size() > 1:
            # the JAX engine takes jax.devices() (das_diff_veh_tpu/serve/mesh/
            # engine.py:91), and a process cannot place requests on another
            # process's devices: that engine works in one process only
            raise NotImplementedError(
                f"MeshServingEngine in a process group of {distributed.world_size()} ranks: "
                f"a process cannot place requests on another process's devices, so the "
                f"engine serves from one process (ROADMAP: deliberate refusals); run one "
                f"engine per process, or the sharded entries across the group")
        cfg = cfg if cfg is not None else MeshServeConfig()
        super().__init__(factory, cfg.serve, tracer=tracer,
                         registry=registry, flight=flight)
        self.mesh_cfg = cfg
        slots = make_mesh(cfg.replicas, device=device).devices
        n_rep = len(slots)
        self._replicas: List[_Replica] = [
            _Replica(i, slots[i]) for i in range(n_rep)]
        self.ring_mesh = None
        self._ring_queue: Optional[FairQueue] = None
        self._ring_thread: Optional[threading.Thread] = None
        if cfg.ring_min_channels is not None:
            # the mesh the ring placements run on: the caller's, else the
            # factory's own (an all-pairs factory carries it), else a new one
            mesh = mesh if mesh is not None else getattr(factory, "mesh", None)
            self.ring_mesh = mesh if mesh is not None else make_mesh(
                cfg.ring_devices, device=device)
            self._ring_queue = FairQueue()
        self.policy = PlacementPolicy(n_rep, cfg.ring_min_channels)
        self.tenants = TenantTable(cfg.tenant_quota,
                                   cfg.tenant_poison_quarantine)
        self._queued_total = 0
        self._queued_lock = threading.Lock()
        self._metrics.enable_mesh(n_rep)
        for rep in self._replicas:
            self._metrics.bind_replica_depth(rep.index, rep.queue.qsize)
        self._metrics.bind_queue_depth(self._depth_total)

    # -- introspection -------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self._replicas)

    def _depth_total(self) -> int:
        with self._queued_lock:
            return self._queued_total

    def _depths(self) -> List[int]:
        return [rep.queue.qsize() for rep in self._replicas]

    def _draining_flags(self) -> List[bool]:
        return [rep.draining.is_set() for rep in self._replicas]

    def metrics(self) -> dict:
        snap = super().metrics()
        snap["tenant_table"] = self.tenants.snapshot()
        snap["mesh"] = {
            "replicas": self.n_replicas,
            "draining": [rep.index for rep in self._replicas
                         if rep.draining.is_set()],
            "ring": self.ring_mesh is not None,
            "ring_devices": (0 if self.ring_mesh is None
                             else self.ring_mesh.size),
        }
        return snap

    # -- lifecycle -----------------------------------------------------------
    def _warmup_all(self) -> None:
        """Warm-up PER PLACEMENT: every bucket on every replica (on the
        replica's device), plus ring-eligible buckets on the mesh —
        steady-state traffic builds nothing on any worker."""
        ring_min = self.mesh_cfg.ring_min_channels
        for b in self.buckets:
            for rep in self._replicas:
                self.cache.warmup(b, rep.placement, device=rep.device)
            if self._ring_queue is not None and b[0] >= ring_min:
                self.cache.warmup(b, RING, device=self._device_of(RING))

    def _start_workers(self) -> None:
        for rep in self._replicas:
            rep.thread = threading.Thread(
                target=self._worker_loop,
                args=(rep.queue, rep.placement, rep.draining, rep.index),
                name=f"serve-replica-{rep.index}", daemon=True)
            rep.thread.start()
        if self._ring_queue is not None:
            self._ring_thread = threading.Thread(
                target=self._worker_loop,
                args=(self._ring_queue, RING, None, None),
                name="serve-ring", daemon=True)
            self._ring_thread.start()

    def close(self, timeout: float = 30.0) -> None:
        """Stop admitting, let every worker drain its queue, join them all;
        a worker wedged in a long compute fails the still-pending requests
        with :class:`ShutdownError` exactly like the base engine."""
        self._closed.set()
        self._stop_obs()
        for rep in self._replicas:
            rep.queue.wake()
        if self._ring_queue is not None:
            self._ring_queue.wake()
        threads = [rep.thread for rep in self._replicas if rep.thread]
        if self._ring_thread is not None:
            threads.append(self._ring_thread)
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in threads):
            n = self._depth_total()
            log.warning("mesh workers did not exit within %.1fs; failing "
                        "%d pending requests with ShutdownError", timeout, n)
            self._fail_pending(ShutdownError(
                f"engine closed while a worker was wedged "
                f"(did not exit within {timeout:.1f}s)"), drain=False)
            return
        self._fail_pending(EngineClosedError("engine closed"))

    def _fail_pending(self, exc: Exception, drain: bool = True) -> None:
        reqs: List[_Request] = []
        for rep in self._replicas:
            reqs.extend(rep.queue.drain_all())
        if self._ring_queue is not None:
            reqs.extend(self._ring_queue.drain_all())
        with self._backlog_lock:
            backlog = list(self._batch_backlog)
        for req in reqs:
            self._dec_queued()
        for req in backlog + reqs:
            if not req.future.done():
                req.future.set_exception(exc)
                self._finish(req, "shutdown")

    # -- workers -------------------------------------------------------------
    def _dec_queued(self) -> None:
        with self._queued_lock:
            if self._queued_total > 0:
                self._queued_total -= 1

    def _on_dequeue(self, replica_index: Optional[int]) -> None:
        self._dec_queued()
        if replica_index is not None:
            self._metrics.observe_replica_request(replica_index)

    def _worker_loop(self, q: FairQueue, placement: Placement,
                     draining: Optional[threading.Event],
                     replica_index: Optional[int]) -> None:
        with device_scope(self._device_of(placement)):
            self._work(q, placement, draining, replica_index)

    def _work(self, q: FairQueue, placement: Placement,
              draining: Optional[threading.Event],
              replica_index: Optional[int]) -> None:
        while True:
            head = q.get(timeout=0.05)
            if head is None:
                if q.qsize() == 0 and (
                        self._closed.is_set()
                        or (draining is not None and draining.is_set())):
                    return
                continue
            self._on_dequeue(replica_index)
            if self._expired(head):
                continue
            if replica_index is not None:
                self._metrics.set_replica_busy(replica_index, True)
            try:
                self._run_batch(head, placement=placement,
                                poll=lambda b: self._poll_queue(
                                    q, b, replica_index))
            finally:
                if replica_index is not None:
                    self._metrics.set_replica_busy(replica_index, False)

    def _poll_queue(self, q: FairQueue, bucket,
                    replica_index: Optional[int]):
        req = q.poll_bucket(bucket)
        if req is not None:
            self._on_dequeue(replica_index)
        return req

    def _device_of(self, placement: Any):
        """A replica's slot device; the ring's first slot (the ring drives
        every slot's device explicitly)."""
        if placement is not None and placement.kind == "replica":
            return self._replicas[placement.index].device
        return None if self.ring_mesh is None else self.ring_mesh.devices[0]

    # -- tenancy unwind ------------------------------------------------------
    def _finish(self, req: _Request, outcome: str) -> None:
        # every terminal path (complete/error/expire/shutdown) funnels here
        # exactly once per request: the quota slot returns and the tenant's
        # outcome counters advance.  First-wins flag: a wedged close may
        # race the unwedging worker over the same request.
        with self._backlog_lock:
            if getattr(req, "_mesh_done", False):
                return
            req._mesh_done = True
        if req.tenant is None:
            return
        self.tenants.release(req.tenant)
        self._metrics.observe_tenant(req.tenant, outcome)
        if outcome == "completed":
            self._metrics.observe_tenant_latency(
                req.tenant, (time.perf_counter() - req.t_submit) * 1e3)

    # -- submission ----------------------------------------------------------
    def submit(self, section: DasSection, deadline_ms: Optional[float] = None,
               session: Optional[str] = None,
               tenant: Optional[str] = None):
        """Tenant-aware submit: gate (quarantine/drain) -> validate/health
        -> quota -> placement -> fair-queue enqueue.  ``tenant`` defaults
        to one shared ``"default"`` tenant, so single-tenant callers use
        the engine exactly like the base one."""
        tenant = tenant if tenant is not None else DEFAULT_TENANT
        if self._closed.is_set():
            raise EngineClosedError("engine is closed")
        try:
            self.tenants.gate(tenant)
        except ShedError as e:
            cause = ("quarantined" if "quarantined" in type(e).__name__.lower()
                     else "draining")
            self._metrics.inc(f"shed_{cause}")
            self._metrics.observe_tenant(tenant, f"shed_{cause}")
            self._record_shed(cause, tuple(section.data.shape), None,
                              session, tenant=tenant)
            raise
        try:
            valid, bucket = self._admit_checks(section, session)
        except PoisonInputError:
            self._metrics.observe_tenant(tenant, "shed_poison")
            if self.tenants.note_poison(tenant):
                self._metrics.observe_tenant(tenant, "quarantined")
                self.flight.record("tenant_quarantine", tenant=tenant)
                self.flight.dump("tenant_quarantine", tenant=tenant)
            raise
        self.tenants.note_healthy(tenant)
        try:
            self.tenants.admit(tenant)
        except ShedError:
            self._metrics.inc("shed_quota")
            self._metrics.observe_tenant(tenant, "shed_quota")
            self._record_shed("quota", valid, bucket, session, tenant=tenant)
            raise
        session_key = SessionStore.scoped(tenant, session)
        try:
            placement = self.policy.place(valid[0], session_key,
                                          self._depths(),
                                          self._draining_flags())
            if placement is None:
                self._record_shed("no_replica", valid, bucket, session,
                                  tenant=tenant)
                raise NoReplicaError(
                    "all replicas draining and no ring route fits")
            with self._queued_lock:
                if self._queued_total >= self.cfg.max_queue:
                    raise QueueFullError(
                        f"admission queues full ({self.cfg.max_queue} "
                        "across replicas + ring)")
                self._queued_total += 1
        except QueueFullError:
            self.tenants.release(tenant)
            self._metrics.inc("shed_rejected")
            self.tracer.instant("shed", cat="serve", reason="queue_full")
            self._record_shed("queue_full", valid, bucket, session,
                              tenant=tenant)
            raise
        except ShedError:
            self.tenants.release(tenant)
            raise
        if deadline_ms is None:
            deadline_ms = self.cfg.default_deadline_ms
        now = time.perf_counter()
        from concurrent.futures import Future
        req = _Request(section=section, valid=valid, bucket=bucket,
                       deadline=now + deadline_ms / 1e3, session=session,
                       future=Future(), t_submit=now,
                       t_submit_us=self.tracer.now_us(), tenant=tenant,
                       session_key=session_key, placement=placement)
        if placement.kind == "ring":
            self._ring_queue.put(req)
        else:
            self._replicas[placement.index].queue.put(req)
        self._metrics.inc("submitted")
        self._metrics.observe_placement(placement.key)
        self._metrics.observe_tenant(tenant, "submitted")
        # submit/close race: close() may have drained the queues between
        # our put and here — fail the request instead of hanging its caller
        if self._closed.is_set() and not any(
                t and t.is_alive()
                for t in [rep.thread for rep in self._replicas]
                + [self._ring_thread]):
            if not req.future.done():
                req.future.set_exception(EngineClosedError("engine closed"))
                self._finish(req, "shutdown")
            raise EngineClosedError("engine is closed")
        return req.future

    # -- drain ---------------------------------------------------------------
    def _replace_requests(self, reqs: List[_Request]) -> None:
        """Re-place drained-replica requests onto survivors (or the ring);
        when nowhere survives they fail with ShutdownError."""
        for req in reqs:
            placement = self.policy.place(req.valid[0], req.session_key,
                                          self._depths(),
                                          self._draining_flags())
            if placement is None:
                self._dec_queued()
                if not req.future.done():
                    req.future.set_exception(ShutdownError(
                        "replica drained with no surviving replica"))
                self._finish(req, "shutdown")
                continue
            req.placement = placement
            self._metrics.observe_placement(placement.key)
            if placement.kind == "ring":
                self._ring_queue.put(req)
            else:
                self._replicas[placement.index].queue.put(req)

    def drain_replica(self, index: int,
                      timeout: Optional[float] = None) -> None:
        """Retire one replica under load: new placements avoid it, its
        queued requests re-place onto survivors (session stickiness re-pins
        there too), its worker finishes the in-flight batch and exits."""
        rep = self._replicas[index]
        rep.draining.set()
        evicted = self.policy.evict_replica(index)
        self._replace_requests(rep.queue.drain_all())
        rep.queue.wake()
        t = rep.thread
        if t is not None:
            t.join(timeout if timeout is not None
                   else self.mesh_cfg.drain_timeout_s)
        # a submit racing the drain flag may have slipped one in after the
        # first drain_all; the worker is gone now, so sweep again
        self._replace_requests(rep.queue.drain_all())
        self.flight.record("replica_drain", replica=index,
                           sticky_evicted=evicted)
        log.info("replica %d drained (%d sticky sessions evicted)",
                 index, evicted)

    def drain_tenant(self, tenant: str,
                     timeout: Optional[float] = None) -> dict:
        """The engine's drain semantics per tenant: new submits shed
        (:class:`TenantDrainingError`), queued requests fail with
        :class:`ShutdownError`, in-flight ones complete (bounded wait),
        then the tenant's sessions and record drop — one misbehaving
        tenant leaves without wedging the cohort.  Returns a summary."""
        self.tenants.start_drain(tenant)
        doomed: List[_Request] = []
        for rep in self._replicas:
            doomed.extend(rep.queue.take_tenant(tenant))
        if self._ring_queue is not None:
            doomed.extend(self._ring_queue.take_tenant(tenant))
        exc = ShutdownError(f"tenant {tenant!r} drained")
        for req in doomed:
            self._dec_queued()
            if not req.future.done():
                req.future.set_exception(exc)
            self._finish(req, "shutdown")
        idle = self.tenants.wait_idle(
            tenant, timeout if timeout is not None
            else self.mesh_cfg.drain_timeout_s)
        dropped = self.sessions.drop_tenant(tenant)
        self.tenants.finish_drain(tenant)
        self._metrics.observe_tenant(tenant, "drained")
        summary = {"tenant": tenant, "queued_failed": len(doomed),
                   "sessions_dropped": dropped, "idle": idle}
        self.flight.record("tenant_drain", **summary)
        log.info("tenant %r drained: %s", tenant, summary)
        return summary

    def quarantine_tenant(self, tenant: str) -> None:
        """Operator action: shed all of the tenant's submits until
        :meth:`release_tenant`."""
        self.tenants.quarantine(tenant)
        self._metrics.observe_tenant(tenant, "quarantined")

    def release_tenant(self, tenant: str) -> None:
        self.tenants.release_tenant(tenant)
        self._metrics.observe_tenant(tenant, "released")
