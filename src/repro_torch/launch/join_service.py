"""Async batch front end for join queries and standing-query ingest.

    PYTHONPATH=src python -m repro_torch.launch.join_service --smoke \
        --deltas 6 --delta-rows 64 [--device cpu]

The service reuses the wave-scheduling structure of ``launch.serve``
(batch-synchronous waves: admit a bounded wave, run it, answer, repeat) on
top of the declarative join engine:

  * **Admission.**  ``submit`` / ``watch`` / ``ingest`` / ``snapshot``
    enqueue a request onto a bounded queue and return a
    ``concurrent.futures.Future``; a full queue raises
    :class:`ServiceOverloaded` immediately (backpressure — callers retry
    or shed, the service never buffers unboundedly).
  * **Waves.**  The pump drains up to ``wave_size`` requests, groups plain
    executes per tenant and runs them through
    ``JoinSession.execute_many`` — structurally repeated queries in a
    wave share the tenant session's log-bucketed plan cache — and applies
    ingests in admission order (each ``Relation.append`` synchronously
    drives the registered standing queries' delta plans).
  * **Tenancy.**  Each tenant name owns one ``JoinSession`` (plan cache,
    m_budget) and its standing-query handles; tenants never share plans.
  * **Metrics.**  Per-tenant power-of-two histograms of per-query latency
    (microseconds), recovery rounds, and tuples read, exported by
    :meth:`JoinService.metrics` next to the per-step ``StepStats`` the
    results already carry.  Bucket ``"2^k"`` counts observations with
    ``2^(k-1) < value <= 2^k`` (``"0"`` holds zeros); every histogram also
    reports ``count`` and ``sum`` so averages need no client-side state.

Relations live on one device, the card unless the caller asks for the CPU
(``main``'s ``--device``).  With ``start()`` the pump runs on a background
thread, whose current stream the kernel wrappers launch on; every future
resolves after its result is on the host (counts are host ints).  A
request's error is set on its future: that is how the service reports
errors, and reading ``result()`` raises it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import queue
import threading
import time
from concurrent.futures import Future

from repro_torch.core.query import Query
from repro_torch.core.relation import Relation, resolve_device
from repro_torch.core.session import JoinSession


class ServiceOverloaded(RuntimeError):
    """Admission queue is full: shed or retry later (backpressure)."""


class _Hist:
    """Power-of-two bucketed histogram (host ints — int64-exact sums)."""

    def __init__(self):
        self.buckets: dict[int, int] = {}   # exponent k -> count (-1: zeros)
        self.count = 0
        self.sum = 0

    def record(self, value: int) -> None:
        v = int(value)
        k = -1 if v <= 0 else (v - 1).bit_length()
        self.buckets[k] = self.buckets.get(k, 0) + 1
        self.count += 1
        self.sum += max(v, 0)

    def export(self) -> dict:
        return {
            "buckets": {("0" if k < 0 else f"2^{k}"): self.buckets[k]
                        for k in sorted(self.buckets)},
            "count": self.count,
            "sum": self.sum,
        }


@dataclasses.dataclass
class _Request:
    kind: str                    # execute | watch | ingest | snapshot
    tenant: str
    future: Future
    query: Query | None = None
    relation: Relation | None = None
    cols: dict | None = None
    handle: object = None        # StandingQuery for snapshot
    strategy: str | None = None
    admitted: float = 0.0


class _Tenant:
    def __init__(self, **session_kw):
        self.session = JoinSession(**session_kw)
        self.latency_us = _Hist()
        self.rounds = _Hist()
        self.tuples_read = _Hist()


class JoinService:
    """Bounded-queue, wave-batched join service with standing queries."""

    def __init__(self, *, max_queue: int = 64, wave_size: int = 8,
                 **session_kw):
        self._queue: queue.Queue[_Request] = queue.Queue(maxsize=max_queue)
        self.wave_size = wave_size
        self._session_kw = session_kw
        self._tenants: dict[str, _Tenant] = {}
        self._thread: threading.Thread | None = None
        self._running = False
        self.waves = 0
        self.rejected = 0

    # -- admission (any thread) -------------------------------------------

    def _admit(self, req: _Request) -> Future:
        req.admitted = time.perf_counter()
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self.rejected += 1
            raise ServiceOverloaded(
                f"admission queue full ({self._queue.maxsize}); retry "
                "later") from None
        return req.future

    def submit(self, tenant: str, query: Query, *,
               strategy: str | None = None) -> Future:
        """One-shot query → Future[QueryResult]."""
        return self._admit(_Request("execute", tenant, Future(),
                                    query=query, strategy=strategy))

    def watch(self, tenant: str, query: Query, *,
              strategy: str | None = None) -> Future:
        """Register a standing query → Future[StandingQuery]."""
        return self._admit(_Request("watch", tenant, Future(),
                                    query=query, strategy=strategy))

    def ingest(self, tenant: str, relation: Relation, cols: dict) -> Future:
        """Append a delta batch → Future[int] (rows applied).  The append
        synchronously drives every standing query watching ``relation``
        through its delta plan before the Future resolves."""
        return self._admit(_Request("ingest", tenant, Future(),
                                    relation=relation, cols=dict(cols)))

    def snapshot(self, tenant: str, handle) -> Future:
        """Standing answer → Future[QueryResult] (same type as submit)."""
        return self._admit(_Request("snapshot", tenant, Future(),
                                    handle=handle))

    # -- wave pump (service thread) ---------------------------------------

    def _tenant(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            t = self._tenants[name] = _Tenant(**self._session_kw)
        return t

    def _observe(self, ten: _Tenant, req: _Request, res) -> None:
        ten.latency_us.record(
            int((time.perf_counter() - req.admitted) * 1e6))
        ten.rounds.record(int(getattr(res, "rounds", 0) or 0))
        tr = getattr(res, "tuples_read", None)
        ten.tuples_read.record(0 if tr is None else int(tr))

    def pump(self) -> int:
        """Drain one wave (≤ wave_size requests): group executes per
        tenant through ``execute_many``, apply the rest in admission
        order.  Returns the number of requests served."""
        wave: list[_Request] = []
        while len(wave) < self.wave_size:
            try:
                wave.append(self._queue.get_nowait())
            except queue.Empty:
                break
        if not wave:
            return 0
        self.waves += 1
        # batch the plain executes per tenant (shared plan cache per wave)
        by_tenant: dict[str, list[_Request]] = {}
        for req in wave:
            if req.kind == "execute":
                by_tenant.setdefault(req.tenant, []).append(req)
        done: set[int] = set()
        for tenant, reqs in by_tenant.items():
            ten = self._tenant(tenant)
            try:
                results = ten.session.execute_many(
                    [r.query for r in reqs],
                    strategy=reqs[0].strategy)
            except Exception as e:          # noqa: BLE001 — fail the wave's futures
                for r in reqs:
                    r.future.set_exception(e)
                    done.add(id(r))
                continue
            for r, res in zip(reqs, results):
                self._observe(ten, r, res)
                r.future.set_result(res)
                done.add(id(r))
        for req in wave:
            if id(req) in done:
                continue
            ten = self._tenant(req.tenant)
            try:
                if req.kind == "watch":
                    res = ten.session.watch(req.query,
                                            strategy=req.strategy)
                    req.future.set_result(res)
                elif req.kind == "ingest":
                    delta = req.relation.append(req.cols)
                    self._observe(ten, req, None)
                    req.future.set_result(int(delta.n))
                elif req.kind == "snapshot":
                    res = req.handle.snapshot()
                    self._observe(ten, req, res)
                    req.future.set_result(res)
                else:
                    raise ValueError(f"unknown request kind {req.kind!r}")
            except Exception as e:          # noqa: BLE001
                req.future.set_exception(e)
        return len(wave)

    def run_until_idle(self) -> int:
        """Synchronously pump waves until the queue drains (tests/CLI)."""
        served = 0
        while True:
            n = self.pump()
            if n == 0:
                return served
            served += n

    # -- background thread --------------------------------------------------

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _loop(self) -> None:
        while self._running:
            if self.pump() == 0:
                time.sleep(0.002)

    # -- metrics -------------------------------------------------------------

    def metrics(self) -> dict:
        """Per-tenant histogram export (see module docstring for the
        bucket format) plus service counters."""
        return {
            "waves": self.waves,
            "rejected": self.rejected,
            "queue_depth": self._queue.qsize(),
            "tenants": {
                name: {
                    "latency_us": t.latency_us.export(),
                    "rounds": t.rounds.export(),
                    "tuples_read": t.tuples_read.export(),
                    "plan_cache": {"hits": t.session._hits,
                                   "misses": t.session._misses},
                }
                for name, t in self._tenants.items()
            },
        }


# -- smoke entry point ------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--rows", type=int, default=4000)
    ap.add_argument("--distinct", type=int, default=512)
    ap.add_argument("--deltas", type=int, default=6)
    ap.add_argument("--delta-rows", type=int, default=64)
    ap.add_argument("--m-budget", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device the relations live on (default: the card)")
    args = ap.parse_args(argv)

    import numpy as np

    device = resolve_device(None if args.device == "cuda" else args.device)
    rng = np.random.default_rng(args.seed)
    n, d = args.rows, args.distinct

    def mk(*cols):
        return Relation.from_arrays(
            device=device, **{c: rng.integers(0, d, n) for c in cols})

    r, s, t = mk("a", "b"), mk("b", "c"), mk("c", "e")
    q = Query({"R": r, "S": s, "T": t},
              [("R.b", "S.b"), ("S.c", "T.c")])

    svc = JoinService(max_queue=32, wave_size=4, m_budget=args.m_budget)
    handle = svc.watch("smoke", q)
    svc.run_until_idle()
    sq = handle.result()
    print(f"standing query registered: count={sq.count}")

    for i in range(args.deltas):
        k = args.delta_rows
        which, cols = [(r, ("a", "b")), (s, ("b", "c")),
                       (t, ("c", "e"))][i % 3]
        fut = svc.ingest("smoke", which,
                         {c: rng.integers(0, d, k) for c in cols})
        svc.run_until_idle()
        fut.result()
        rec = sq.delta_rounds[-1]
        print(f"delta {i}: +{rec.delta_rows} rows into {rec.relation} → "
              f"Δcount={rec.count_delta} rounds={rec.rounds} "
              f"overflowed={rec.overflowed}")
        assert not rec.overflowed, "delta round overflowed"

    snap_f = svc.snapshot("smoke", sq)
    svc.run_until_idle()
    snap = snap_f.result()
    oracle = JoinSession(m_budget=args.m_budget).execute(q)
    match = int(snap.count) == int(oracle.count)
    print(f"final: standing={int(snap.count)} "
          f"from_scratch={int(oracle.count)} match={match} "
          f"overflowed={bool(snap.overflowed)}")
    print(json.dumps(svc.metrics(), indent=2, sort_keys=True))
    if not match:
        raise SystemExit("standing count diverged from from-scratch oracle")
    print("smoke OK")


if __name__ == "__main__":
    main()
