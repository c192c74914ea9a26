"""Latency-governed online serving over the batched query engine.

Counterpart of the JAX package's ``index/serve.py``: the same admission,
batching, tenants, deadlines and traces in front of the port's
:class:`~.engine.QueryEngine`.  The engine's kernels run on the card; this
module only schedules.  Warm-up keeps the reference's priming batches,
whose job differs here (see ``IndexServer._warmup``).

Every other entry point in this repo measures *offline* batch throughput:
the caller already holds a ``QueryBatch`` and wants it executed as fast as
possible.  Production traffic is the opposite shape — single requests
arriving as a stream, each with a tail-latency budget — and the
device-resident kernels only pay off if batches *form* fast enough to feed
them.  This module is the bridge: an async admission queue in front of the
existing ``plan()/execute()`` discipline.

    ┌─ submit(Request) ──► per-tenant bounded queues ──► dynamic batcher ─┐
    │   (admission: expired / queue-full requests get    (close on size   │
    │    an explicit Rejected, never a silent stall)      OR earliest     │
    │                                                     deadline)       │
    └──────────► QueryBatch ──► engine.plan() ──► engine.execute() ◄──────┘
                 (one plan per batch; only same-(mode, k) requests
                  co-batch — results are bitwise the offline path's)

Lifecycle of one request (the five trace stages, stamped monotonically):

  1. **enqueue** — ``submit()`` validates the deadline (a request whose
     budget is already spent is rejected *now*, not after wasting a batch
     slot) and appends to its tenant's queue; a tenant over its weighted
     share of the global ``queue_cap`` gets ``Rejected("queue_full")``
     (backpressure, never unbounded growth).
  2. **batch close** — the batcher seeds a batch with the earliest-deadline
     pending request and fills it by smooth weighted round-robin across
     tenants (``tenants`` weights: a tenant with twice the weight gets
     about twice the slots under contention) with *compatible* requests
     only (same ``mode`` and ``k`` — mixed modes never co-batch).  The
     batch closes when it reaches ``max_batch`` OR when the earliest
     member deadline (minus ``slack_ms``) or the seed's ``max_wait_ms``
     budget hits — whichever comes first.  Members whose deadline already
     passed at close are shed with ``Rejected("deadline")``.
  3. **plan** — one ``engine.plan(QueryBatch(...), placement=...)`` per
     batch; the plan pins the mutation epoch, so a ``compact()`` landing
     between close and execution cannot change results.
  4. **execute** — ``engine.execute(plan)`` in a single worker thread (the
     engine is not thread-safe; admission stays live on the event loop
     while the batch runs, so arrivals keep their true enqueue stamps).
     The CUDA current device is per thread: every tensor the engine makes
     names its device, so the worker thread needs no device set up, and
     the first kernel build on it goes through ``cuda_build``'s lock.
  5. **rescore / deliver** — results are split back to the per-request
     futures; the stamp closes the trace.

Every request leaves a :class:`TraceRecord` and every batch a
:class:`BatchRecord` in :class:`ServerStats` — enough to recompute latency
percentiles, goodput, shed rate, the achieved batch-size histogram per
placement, AND to replay any batch through the offline ``plan()/execute()``
oracle for bitwise parity.  The registry lint
(``tools/registry_lint_torch.py``) checks that every trace's stage
timestamps are monotone non-decreasing.

The same stage boundaries are recorded as spans on the server's always-on
:class:`~..obs.trace.Tracer` (``server.tracer``, also reachable as
``stats.tracer`` from ``serve_stream`` callers): ``serve/request`` per
request, ``serve/close`` per batch-forming window, and ``serve/batch``
with ``serve/plan`` / ``serve/execute`` / ``serve/deliver`` children that
tile it exactly.  ``obs.trace.to_chrome_trace`` exports them (plus
any enabled engine/kernel spans) as Perfetto-loadable JSON; aggregate
counters live on ``stats.metrics`` with Prometheus text exposition via
``stats.to_prometheus()``.

SLO semantics: ``deadline_ms`` is a *relative* budget from enqueue.  A
request is shed (``Rejected``) only when its deadline has already passed at
admission or at batch close; a request that starts executing in time but
finishes late is still served — it simply counts against ``on_time_frac`` /
``goodput_qps`` instead of ``shed_rate``.  ``slack_ms`` is the close-time
margin reserved for execution: closing a batch at ``deadline - slack``
gives the batch ``slack`` milliseconds to finish on time.

Typical use::

    engine = QueryEngine(idx).to_device()       # the card
    server = IndexServer(engine, ServeConfig(max_batch=16, max_wait_ms=4.0))
    await server.start()            # warm-up: caches, arenas, kernel builds
    result = await server.submit(Request([1, 5], mode="and", deadline_ms=50))
    ...
    await server.stop()             # drains the queues first
    print(server.stats.snapshot())

or, synchronously, the open-loop load generator of the benchmark harness::

    results, stats = serve_stream(engine, requests, offsets, config)
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping, Optional

import numpy as np

from ..obs.metrics import MetricsRegistry, nearest_rank
from ..obs.trace import Tracer
from .engine import QueryBatch, QueryEngine, MODES

_now = time.monotonic        # one clock for every stage stamp (thread-safe)

_MIN_WORKLIST = 8


def _bucket(k: int) -> int:
    """The reference's power-of-two work-list bucket (minimum 8).  The port
    launches every work-list at its exact length; the server keeps this
    copy only to choose its warm-up batch sizes as the reference does."""
    w = _MIN_WORKLIST
    while w < k:
        w *= 2
    return w


# --------------------------------------------------------------------------- #
# request / result types
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class Request:
    """One query in the stream.  ``deadline_ms`` is relative to enqueue
    (None uses the server's ``default_deadline_ms``)."""
    terms: list
    mode: str = "and"
    k: int = 10
    tenant: str = "default"
    deadline_ms: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Rejected:
    """Explicit shed/reject result — the server never silently stalls a
    request.  ``reason``: "expired" (deadline already spent at enqueue),
    "queue_full" (tenant over its weighted admission share), or "deadline"
    (deadline passed while queued; shed at batch close)."""
    reason: str
    tenant: str
    detail: str = ""


# trace stage names, in order — ``TraceRecord.stages()`` returns the stamps
# in this order and the registry lint checks them monotone non-decreasing
STAGES = ("enqueue", "close", "plan", "execute", "done")


@dataclasses.dataclass
class TraceRecord:
    """Per-request trace: outcome + the five stage timestamps (monotonic
    seconds; later stages are None for rejected/shed requests)."""
    rid: int
    tenant: str
    mode: str
    k: int
    outcome: str                 # served | shed | rejected_expired | rejected_queue_full
    deadline: float              # absolute (monotonic clock)
    t_enqueue: float
    t_close: Optional[float] = None
    t_plan: Optional[float] = None
    t_execute: Optional[float] = None
    t_done: Optional[float] = None
    batch_id: int = -1
    batch_size: int = 0
    placement: str = ""
    epoch: tuple = ()
    on_time: bool = False

    def stages(self) -> tuple:
        """The stamped stages in ``STAGES`` order, Nones dropped (a shed
        request legitimately stops at ``close``)."""
        return tuple(t for t in (self.t_enqueue, self.t_close, self.t_plan,
                                 self.t_execute, self.t_done) if t is not None)

    @property
    def latency_ms(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return (self.t_done - self.t_enqueue) * 1e3


@dataclasses.dataclass
class BatchRecord:
    """Per-batch trace: enough to replay the batch through the offline
    ``plan()/execute()`` oracle (queries + mode/k + placement + pinned
    epoch) and to build the batch-size histogram."""
    batch_id: int
    mode: str
    k: int
    placement: str
    epoch: tuple
    queries: tuple               # tuple of term tuples, batch order
    rids: tuple                  # request ids aligned with ``queries``
    t_close: float
    t_plan: float
    t_execute: float
    t_done: float


class ServerStats:
    """Aggregated serving telemetry: every trace and batch record, a typed
    :class:`~..obs.metrics.MetricsRegistry` (Prometheus exposition via
    :meth:`to_prometheus`), and a ``snapshot()`` that derives the SLO
    metrics (latency percentiles, goodput, shed rate, batch-size histogram
    per placement).  ``tracer`` is the owning server's span tracer (set by
    :class:`IndexServer`) so ``serve_stream`` callers can export traces."""

    def __init__(self):
        self.traces: list[TraceRecord] = []
        self.batches: list[BatchRecord] = []
        self.submitted = 0
        self.served = 0
        self.shed = 0
        self.rejected_expired = 0
        self.rejected_queue_full = 0
        self.per_tenant: dict = {}
        self.warmup_s = 0.0
        self.tracer: Optional[Tracer] = None
        self.metrics = MetricsRegistry(namespace="repro_serve")
        self.metrics.counter(
            "requests_total", "requests by tenant and outcome",
            labelnames=("tenant", "outcome"))
        self.metrics.counter(
            "batches_total", "closed batches by placement and mode",
            labelnames=("placement", "mode"))
        self.metrics.histogram(
            "request_latency_ms", "end-to-end served latency (ms)",
            labelnames=("tenant",))
        self.metrics.gauge("warmup_seconds", "server warm-up wall-clock")

    def _tenant(self, tenant: str) -> dict:
        d = self.per_tenant.get(tenant)
        if d is None:
            d = self.per_tenant[tenant] = {
                "submitted": 0, "served": 0, "shed": 0, "rejected": 0}
        return d

    def record(self, tr: TraceRecord) -> None:
        self.traces.append(tr)
        t = self._tenant(tr.tenant)
        self.submitted += 1
        t["submitted"] += 1
        self.metrics.inc("requests_total", tenant=tr.tenant,
                         outcome=tr.outcome)
        if tr.latency_ms is not None:
            self.metrics.get("request_latency_ms").observe(
                tr.latency_ms, tenant=tr.tenant)
        if tr.outcome == "served":
            self.served += 1
            t["served"] += 1
        elif tr.outcome == "shed":
            self.shed += 1
            t["shed"] += 1
        elif tr.outcome == "rejected_expired":
            self.rejected_expired += 1
            t["rejected"] += 1
        elif tr.outcome == "rejected_queue_full":
            self.rejected_queue_full += 1
            t["rejected"] += 1

    def record_batch(self, b: BatchRecord) -> None:
        self.batches.append(b)
        self.metrics.inc("batches_total", placement=b.placement, mode=b.mode)

    def set_warmup(self, seconds: float) -> None:
        self.warmup_s = seconds
        self.metrics.get("warmup_seconds").set(seconds)

    def to_prometheus(self) -> str:
        """The registry's Prometheus 0.0.4 text exposition (what
        ``launch.serve --metrics-out`` writes)."""
        return self.metrics.to_prometheus()

    def snapshot(self, prometheus: bool = False) -> dict:
        """SLO metrics over everything recorded so far.  ``shed_rate``
        counts every non-served outcome (shed at close + both admission
        rejects); ``goodput_qps`` is on-time served requests per second of
        stream wall-clock (first enqueue to last delivery).

        Latency percentiles use the nearest-rank rule
        (:func:`~..obs.metrics.nearest_rank`): deterministic for tiny
        samples — never interpolated, always an observed value, monotone in
        q (p50 <= p99 <= p999), and n == 1 returns the single sample.

        With ``prometheus=True`` the snapshot also carries the registry's
        text exposition under the ``"prometheus"`` key."""
        lat = sorted(tr.latency_ms for tr in self.traces
                     if tr.latency_ms is not None)
        on_time = sum(tr.on_time for tr in self.traces)
        if self.traces:
            t0 = min(tr.t_enqueue for tr in self.traces)
            t1 = max((tr.t_done for tr in self.traces
                      if tr.t_done is not None), default=t0)
            wall = max(t1 - t0, 1e-9)
        else:
            wall = 0.0
        hist: dict = {}
        for b in self.batches:
            hist.setdefault(b.placement, {})
            hist[b.placement][len(b.queries)] = (
                hist[b.placement].get(len(b.queries), 0) + 1)
        sizes = [len(b.queries) for b in self.batches]
        pct = {}
        if lat:
            for name, q in (("p50", 50.0), ("p99", 99.0), ("p999", 99.9)):
                pct[name] = nearest_rank(lat, q)
            pct["mean"] = float(sum(lat) / len(lat))
            pct["max"] = float(lat[-1])
        dropped = self.shed + self.rejected_expired + self.rejected_queue_full
        extra = {"prometheus": self.to_prometheus()} if prometheus else {}
        return {
            **extra,
            "submitted": self.submitted,
            "served": self.served,
            "shed": self.shed,
            "rejected_expired": self.rejected_expired,
            "rejected_queue_full": self.rejected_queue_full,
            "shed_rate": dropped / max(self.submitted, 1),
            "on_time_frac": on_time / max(self.submitted, 1),
            "goodput_qps": (on_time / wall) if wall else 0.0,
            "wall_s": wall,
            "latency_ms": pct,
            "n_batches": len(self.batches),
            "mean_batch": float(np.mean(sizes)) if sizes else 0.0,
            "batch_hist": hist,
            "per_tenant": self.per_tenant,
            "warmup_s": self.warmup_s,
        }


# --------------------------------------------------------------------------- #
# configuration + admission helpers
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class ServeConfig:
    """Serving policy.

    max_batch: close a batch at this many requests (size trigger).
    max_wait_ms: close no later than this long after the seed request was
        enqueued, even with deadline room to spare (latency floor for
        lightly-loaded streams — the idle-queue flush).
    slack_ms: execution margin — a batch closes at the earliest member
        deadline MINUS this, so the batch has ``slack_ms`` to finish on time.
    queue_cap: global admission bound (requests queued across all tenants).
    default_deadline_ms: budget for requests that don't carry one.
    tenants: tenant -> admission weight.  A tenant's share of ``queue_cap``
        and of contended batch slots is proportional to its weight; tenants
        absent from the map weigh 1.0.  Empty map = no per-tenant split
        (only the global bound applies).
    placement: force every batch's plan placement ("host" / "device" /
        "fused"); None lets ``engine.plan()`` auto-place (crossover table).
    warm_terms: warm this many hottest (highest-df) terms' block + score
        caches at ``start()``.
    warm_modes: run one priming batch per batch-size bucket per listed mode
        during warm-up (``IndexServer._warmup`` says what that primes).
    warm_queries: optional representative sample of the expected query
        distribution; when given, warm-up primes with THESE queries (bucket
        sweep + a full pass in ``max_batch`` chunks), so the blocks, score
        rows and round gathers real traffic touches are resident before the
        first request.  Defaults to synthetic hot-term pairs.
    """
    max_batch: int = 32
    max_wait_ms: float = 5.0
    slack_ms: float = 0.0
    queue_cap: int = 1024
    default_deadline_ms: float = 100.0
    tenants: Mapping[str, float] = dataclasses.field(default_factory=dict)
    placement: Optional[str] = None
    warm_terms: int = 16
    warm_modes: tuple = ("and",)
    warm_queries: Optional[list] = None


def tenant_cap(queue_cap: int, tenants: Mapping[str, float],
               tenant: str) -> int:
    """``tenant``'s admission bound: its weighted share of ``queue_cap``
    (at least 1), or the whole cap when no weights are configured."""
    if not tenants:
        return queue_cap
    w = float(tenants.get(tenant, 1.0))
    total = sum(float(v) for v in tenants.values())
    if tenant not in tenants:
        total += w
    return max(1, int(queue_cap * w / max(total, 1e-12)))


def weighted_fill(queues: Mapping[str, list], weights: Mapping[str, float],
                  compatible, max_n: int, credit: Optional[dict] = None) -> list:
    """Smooth weighted round-robin drain: pop up to ``max_n`` entries for
    which ``compatible(entry)`` holds, giving each tenant slots in
    proportion to its weight (absent tenants weigh 1.0).  ``credit``
    carries the WRR state across calls (tenants keep their deficit between
    batches).  Per tenant, entries pop in FIFO order *among compatible
    ones* — an incompatible head does not block the tenant's later
    compatible requests.  Returns the popped entries in drain order."""
    if credit is None:
        credit = {}
    out: list = []
    while len(out) < max_n:
        avail = [t for t, q in queues.items() if any(compatible(e) for e in q)]
        if not avail:
            break
        for t in avail:
            credit[t] = credit.get(t, 0.0) + float(weights.get(t, 1.0))
        # deterministic tie-break by tenant name
        pick = max(avail, key=lambda t: (credit[t], t))
        credit[pick] -= sum(float(weights.get(t, 1.0)) for t in avail)
        q = queues[pick]
        for i, e in enumerate(q):
            if compatible(e):
                out.append(q.pop(i))
                break
    return out


@dataclasses.dataclass
class _Pending:
    rid: int
    req: Request
    fut: asyncio.Future
    t_enqueue: float
    deadline: float              # absolute
    sp: object = None            # the request's serve/request span (detached)


# --------------------------------------------------------------------------- #
# the server
# --------------------------------------------------------------------------- #

class IndexServer:
    """Async admission + dynamic batching in front of one
    :class:`~.engine.QueryEngine` (see the module docstring for
    the full lifecycle).  One batcher task, one executor thread: admission
    never blocks on execution, execution never races itself."""

    def __init__(self, engine: QueryEngine, config: Optional[ServeConfig] = None):
        self.engine = engine
        self.config = config or ServeConfig()
        self.stats = ServerStats()
        # the server's own always-on tracer: every TraceRecord stage stamp
        # below is a boundary of one of these spans (serve/request,
        # serve/close, serve/batch + plan/execute/deliver children), so the
        # five-stamp record is a *view* over the span timeline, not a second
        # clock.  Deep engine/kernel spans live on the process-global tracer
        # (obs.trace.get_tracer), disabled unless explicitly enabled.
        self.tracer = Tracer(enabled=True)
        self.stats.tracer = self.tracer
        self._queues: dict[str, list[_Pending]] = {}
        self._credit: dict[str, float] = {}
        self._queued = 0
        self._rid = 0
        self._batch_id = 0
        self._event: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._stopping = False
        self._inflight = False
        # test hook: called (with the plan) between plan and execute —
        # lets tests land a compact() there and check epoch pinning
        self._after_plan = None

    # ---- lifecycle ------------------------------------------------------- #

    async def start(self) -> "IndexServer":
        cfg = self.config
        if cfg.placement is not None:
            if cfg.placement not in ("host", "device", "fused"):
                raise ValueError(f"unknown placement {cfg.placement!r}")
            if (cfg.placement != "host" and self.engine.arena is None
                    and getattr(self.engine, "_shard_cfg", None) is None):
                raise ValueError(
                    f"placement {cfg.placement!r} needs device arenas; call "
                    f"engine.to_device() before starting the server")
        self._event = asyncio.Event()
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="repro-serve")
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(self._pool, self._warmup)
        self._stopping = False
        self._task = asyncio.create_task(self._batcher())
        return self

    async def stop(self, drain: bool = True) -> None:
        """Stop the batcher; with ``drain`` (default) serve out everything
        queued first, so no accepted request is abandoned."""
        if drain:
            while self._queued or self._inflight:
                await asyncio.sleep(0.002)
        self._stopping = True
        if self._event is not None:
            self._event.set()
        if self._task is not None:
            await self._task
            self._task = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _warmup(self) -> None:
        """Warm the engine before the first real request: the hottest
        (highest-df) terms' posting blocks land in the decoded-block LRU,
        their BM25 score vectors in the score cache, and the reference's
        priming batches run (one per batch-size bucket per configured mode,
        plus a pass over ``warm_queries``).  The port has no jit buckets to
        compile: on the card the priming batches build the CUDA kernels
        (``cuda_build`` at first use, on this executor thread), fill the
        block cache, the score arena (``ensure_scores``) and the engine's
        round memo, so no request of the stream pays for them."""
        t0 = _now()
        eng, cfg = self.engine, self.config
        gen = getattr(eng.idx, "gen", eng.idx)
        hot = sorted(gen.terms, key=lambda t: -gen.terms[t].df)[:cfg.warm_terms]
        if not hot:
            self.stats.set_warmup(_now() - t0)
            return
        if eng.arena is not None:
            eng._prefetch_terms(hot, fields=(0,))
            if any(m in ("or", "and_scored") for m in cfg.warm_modes):
                eng.arena.ensure_scores()
        for t in hot:
            eng.term_scores(t)
        # one priming batch per power-of-two batch size up to max_batch,
        # the reference's sizes (its jit buckets)
        sizes = {1}
        w = _bucket(1)
        while w <= _bucket(max(1, cfg.max_batch)):
            sizes.add(min(w, max(1, cfg.max_batch)))
            w *= 2
        pool = ([list(q) for q in cfg.warm_queries] if cfg.warm_queries
                else [[hot[i % len(hot)], hot[(i + 1) % len(hot)]]
                      for i in range(max(sizes))])
        for mode in cfg.warm_modes:
            for size in sorted(sizes):
                qs = [pool[i % len(pool)] for i in range(size)]
                eng.execute(eng.plan(QueryBatch(qs, mode=mode, k=10),
                                     placement=cfg.placement))
            if cfg.warm_queries:
                # one full pass in max_batch chunks: makes resident what
                # this exact workload will touch at steady state
                step = max(1, cfg.max_batch)
                for i in range(0, len(pool), step):
                    eng.execute(eng.plan(QueryBatch(pool[i:i + step],
                                                    mode=mode, k=10),
                                         placement=cfg.placement))
        self.stats.set_warmup(_now() - t0)

    # ---- admission ------------------------------------------------------- #

    def submit_nowait(self, req: Request) -> asyncio.Future:
        """Admit one request; returns a future resolving to the result list
        (or an explicit :class:`Rejected`).  Rejections resolve
        immediately — admission never stalls the caller."""
        if req.mode not in MODES:
            raise ValueError(f"unknown mode {req.mode!r}; modes: {MODES}")
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        rid = self._rid
        self._rid += 1
        # the request span opens here and its t0 IS the enqueue stamp — one
        # clock read serves both the trace record and the span timeline
        sp = self.tracer.begin("serve/request", lane="serve", rid=rid,
                               tenant=req.tenant, mode=req.mode, k=req.k)
        t = sp.t0
        budget = (self.config.default_deadline_ms
                  if req.deadline_ms is None else req.deadline_ms)
        deadline = t + budget / 1e3
        if budget <= 0:
            fut.set_result(Rejected("expired", req.tenant,
                                    f"deadline_ms={budget} already spent at enqueue"))
            self.tracer.end(sp, t1=t, outcome="rejected_expired")
            self.stats.record(TraceRecord(
                rid, req.tenant, req.mode, req.k, "rejected_expired",
                deadline, t))
            return fut
        q = self._queues.setdefault(req.tenant, [])
        cap = tenant_cap(self.config.queue_cap, self.config.tenants, req.tenant)
        if self._queued >= self.config.queue_cap or len(q) >= cap:
            fut.set_result(Rejected("queue_full", req.tenant,
                                    f"tenant share {len(q)}/{cap}, "
                                    f"global {self._queued}/{self.config.queue_cap}"))
            self.tracer.end(sp, t1=t, outcome="rejected_queue_full")
            self.stats.record(TraceRecord(
                rid, req.tenant, req.mode, req.k, "rejected_queue_full",
                deadline, t))
            return fut
        q.append(_Pending(rid, req, fut, t, deadline, sp))
        self._queued += 1
        if self._event is not None:
            self._event.set()
        return fut

    async def submit(self, req: Request):
        return await self.submit_nowait(req)

    # ---- batching -------------------------------------------------------- #

    def _pop_seed(self) -> Optional[_Pending]:
        """The earliest-deadline pending request across all tenants (EDF
        seeding: an expired request is picked first and shed immediately
        instead of rotting in its queue)."""
        best_t, best_i, best = None, None, None
        for t, q in self._queues.items():
            for i, p in enumerate(q):
                if best is None or p.deadline < best.deadline:
                    best_t, best_i, best = t, i, p
        if best is None:
            return None
        self._queues[best_t].pop(best_i)
        self._queued -= 1
        return best

    def _fill(self, key: tuple, n: int) -> list:
        got = weighted_fill(
            self._queues, self.config.tenants,
            lambda p: (p.req.mode, p.req.k) == key, n, self._credit)
        self._queued -= len(got)
        return got

    async def _batcher(self) -> None:
        loop = asyncio.get_running_loop()
        cfg = self.config
        while True:
            while not self._queued:
                if self._stopping:
                    return
                self._event.clear()
                if self._queued:        # raced an enqueue past the clear
                    break
                await self._event.wait()
            seed = self._pop_seed()
            if seed is None:
                continue
            self._inflight = True
            try:
                csp = self.tracer.begin("serve/close", lane="serve",
                                        seed_rid=seed.rid)
                batch = [seed]
                key = (seed.req.mode, seed.req.k)
                close_at = min(seed.deadline - cfg.slack_ms / 1e3,
                               seed.t_enqueue + cfg.max_wait_ms / 1e3)
                while len(batch) < cfg.max_batch:
                    more = self._fill(key, cfg.max_batch - len(batch))
                    if more:
                        batch.extend(more)
                        close_at = min([close_at]
                                       + [p.deadline - cfg.slack_ms / 1e3
                                          for p in more])
                        continue
                    dt = close_at - _now()
                    if dt <= 0:
                        break
                    self._event.clear()
                    try:
                        await asyncio.wait_for(self._event.wait(), dt)
                    except asyncio.TimeoutError:
                        break
                t_close = _now()
                self.tracer.end(csp, t1=t_close, n=len(batch))
                live = []
                for p in batch:
                    if p.deadline < t_close:        # shed: budget already spent
                        p.fut.set_result(Rejected(
                            "deadline", p.req.tenant,
                            f"deadline passed {1e3 * (t_close - p.deadline):.2f}"
                            f" ms before batch close"))
                        self.tracer.end(p.sp, t1=t_close, outcome="shed")
                        self.stats.record(TraceRecord(
                            p.rid, p.req.tenant, p.req.mode, p.req.k, "shed",
                            p.deadline, p.t_enqueue, t_close=t_close))
                    else:
                        live.append(p)
                if not live:
                    continue
                try:
                    results, records = await loop.run_in_executor(
                        self._pool, self._run_batch, live, t_close)
                except Exception as e:      # noqa: BLE001 — fail the batch's futures
                    for p in live:
                        self.tracer.end(p.sp, outcome="error")
                        if not p.fut.done():
                            p.fut.set_exception(
                                RuntimeError(f"batch execution failed: {e!r}"))
                    continue
                for p, r in zip(live, results):
                    if not p.fut.done():
                        p.fut.set_result(r)
                for tr in records:
                    self.stats.record(tr)
            finally:
                self._inflight = False

    def _run_batch(self, live: list, t_close: float):
        """Executor-thread half of one batch: plan, (optional test hook),
        execute, stamp the remaining trace stages.

        The stage stamps ARE span boundaries: ``serve/batch`` runs
        ``t_close -> t_done`` with children ``serve/plan`` (close -> plan
        done), ``serve/execute`` (plan -> execute done) and
        ``serve/deliver`` (execute -> done) tiling it exactly — the
        exported trace accounts for 100% of measured batch wall-clock, and
        the :class:`TraceRecord` five-stamp view is derived from the same
        clock reads."""
        cfg = self.config
        queries = [list(p.req.terms) for p in live]
        mode, k = live[0].req.mode, live[0].req.k
        bid = self._batch_id
        self._batch_id += 1
        bsp = self.tracer.begin("serve/batch", lane="serve", t0=t_close,
                                bid=bid, mode=mode, k=k, nq=len(live))
        psp = self.tracer.begin("serve/plan", lane="serve", parent=bsp,
                                t0=t_close)
        plan = self.engine.plan(QueryBatch(queries, mode=mode, k=k),
                                placement=cfg.placement)
        self.tracer.end(psp, placement=plan.placement)
        t_plan = psp.t1
        if self._after_plan is not None:
            self._after_plan(plan)
        esp = self.tracer.begin("serve/execute", lane="serve", parent=bsp,
                                t0=t_plan)
        results = self.engine.execute(plan)
        self.tracer.end(esp)
        t_execute = esp.t1
        dsp = self.tracer.begin("serve/deliver", lane="serve", parent=bsp,
                                t0=t_execute)
        epoch = plan.ctx.skey if plan.ctx is not None else ()
        self.tracer.end(dsp)
        t_done = dsp.t1
        self.tracer.end(bsp, t1=t_done, placement=plan.placement)
        self.stats.record_batch(BatchRecord(
            bid, mode, k, plan.placement, epoch,
            tuple(tuple(q) for q in queries), tuple(p.rid for p in live),
            t_close, t_plan, t_execute, t_done))
        records = []
        for p in live:
            self.tracer.end(p.sp, t1=t_done, outcome="served", bid=bid)
            records.append(TraceRecord(
                p.rid, p.req.tenant, mode, k, "served", p.deadline,
                p.t_enqueue, t_close=t_close, t_plan=t_plan,
                t_execute=t_execute, t_done=t_done, batch_id=bid,
                batch_size=len(live), placement=plan.placement, epoch=epoch,
                on_time=t_done <= p.deadline))
        return results, records


# --------------------------------------------------------------------------- #
# open-loop load generation (benchmark harness + launch entry point)
# --------------------------------------------------------------------------- #

def poisson_offsets(n: int, rate_qps: float, seed: int = 0) -> np.ndarray:
    """Arrival offsets (seconds from stream start) of an open-loop Poisson
    process at ``rate_qps`` — exponential interarrivals, fixed seed."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_qps, n))


def bursty_offsets(n: int, rate_qps: float, seed: int = 0,
                   shape: float = 0.25) -> np.ndarray:
    """Bursty open-loop arrivals: Gamma interarrivals with ``shape`` < 1
    (same mean rate as the Poisson stream, heavier clumping — the squared
    coefficient of variation is ``1/shape``)."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.gamma(shape, 1.0 / (rate_qps * shape), n))


async def drive_open_loop(server: IndexServer, requests: list,
                          offsets) -> list:
    """Submit ``requests[i]`` at ``offsets[i]`` seconds after start (open
    loop: arrivals never wait for responses) and gather every result in
    submission order."""
    t0 = _now()
    futs = []
    for req, off in zip(requests, offsets):
        delay = t0 + float(off) - _now()
        if delay > 0:
            await asyncio.sleep(delay)
        futs.append(server.submit_nowait(req))
    return list(await asyncio.gather(*futs))


def serve_stream(engine: QueryEngine, requests: list, offsets,
                 config: Optional[ServeConfig] = None):
    """Synchronous convenience wrapper: start a server, drive the open-loop
    stream, drain, stop.  Returns ``(results, stats)`` with ``results`` in
    submission order."""
    server = IndexServer(engine, config)

    async def go():
        await server.start()
        try:
            return await drive_open_loop(server, requests, offsets)
        finally:
            await server.stop()

    results = asyncio.run(go())
    return results, server.stats
