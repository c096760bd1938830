"""Multi-tenant admission for the serving tier (DESIGN.md §10).

Sits between the HTTP handler threads and the engine thread's
``MatchSession.submit``. Three mechanisms compose, outermost first:

* **bounded per-tenant queues** — a tenant whose pending queue is full
  has its *lowest-priority* pending request shed immediately (terminal
  ``status="shed"``, same taxonomy as the scheduler's ``shed_lowest``
  policy) rather than growing without bound; a new arrival that is
  itself the lowest loses the comparison and is shed on arrival;
* **per-tenant token buckets** — ``rate`` admissions/second with
  ``burst`` headroom gate *dispatch into the engine*, not arrival: an
  over-rate tenant's requests wait in its own queue and never delay
  other tenants;
* **weighted fair queueing** — among tenants that currently hold a
  token, the engine admits in virtual-finish-time order (classic WFQ:
  each request's finish tag is assigned *at enqueue* as
  ``max(vtime, tenant.vfinish) + 1 / weight``), so a tenant with
  weight 2 gets twice the admission share of a weight-1 tenant under
  contention, an idle tenant's unused share redistributes, and a
  backlogged light tenant keeps its early tag instead of being
  re-priced every pop (which would starve it behind a heavier queue).

Engine backpressure (the scheduler's bounded queue raising
``QueueFull``) is *not* shedding: the controller re-queues the request
at the head of its tenant queue and counts an absorbed-backpressure
event — the distinction the SLO report needs between "dropped" and
"retry later".

Thread-safety: ``offer``/counters are called from HTTP threads,
``next_ready``/``requeue_front`` from the engine thread; one lock
guards the queues.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable

__all__ = ["TenantConfig", "TokenBucket", "AdmissionController"]


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """Admission policy for one tenant (see ``ServerArgs.tenants``)."""
    name: str = "default"
    rate: float | None = None      # admissions/sec (None = unlimited)
    burst: float = 8.0             # token-bucket capacity
    weight: float = 1.0            # WFQ share under contention
    max_pending: int = 256         # bounded queue; overflow sheds

    def validate(self) -> "TenantConfig":
        if self.rate is not None and self.rate <= 0:
            raise ValueError(f"tenant {self.name}: rate must be > 0 or "
                             f"None, got {self.rate!r}")
        if self.burst < 1:
            raise ValueError(f"tenant {self.name}: burst must be >= 1")
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name}: weight must be > 0")
        if self.max_pending < 1:
            raise ValueError(f"tenant {self.name}: max_pending >= 1")
        return self


class TokenBucket:
    """Continuous-refill token bucket; ``rate=None`` always has a
    token. Not thread-safe on its own — the controller's lock guards
    it."""

    def __init__(self, rate: float | None, burst: float,
                 now: float | None = None):
        self.rate = rate
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t = time.monotonic() if now is None else now

    def _refill(self, now: float) -> None:
        if self.rate is None:
            return
        self.tokens = min(self.burst,
                          self.tokens + (now - self._t) * self.rate)
        self._t = now

    def peek(self, now: float) -> bool:
        self._refill(now)
        return self.rate is None or self.tokens >= 1.0

    def take(self, now: float) -> bool:
        self._refill(now)
        if self.rate is None:
            return True
        if self.tokens < 1.0:
            return False
        self.tokens -= 1.0
        return True


class _TenantState:
    __slots__ = ("cfg", "bucket", "pending", "vfinish", "counters")

    def __init__(self, cfg: TenantConfig, now: float):
        self.cfg = cfg
        self.bucket = TokenBucket(cfg.rate, cfg.burst, now)
        self.pending: deque = deque()   # (finish_tag, item) pairs
        self.vfinish = 0.0         # WFQ finish tag of the last enqueue
        self.counters = {"offered": 0, "admitted": 0, "shed": 0,
                         "completed": 0, "backpressure": 0}


class AdmissionController:
    """Tenant-aware admission queue in front of the engine.

    ``on_shed(item)`` is invoked (outside the lock) for every request
    dropped by the bounded-queue policy so the caller can deliver its
    terminal ``status="shed"`` event. Items must expose ``priority``
    (int, higher = keep) and are otherwise opaque.
    """

    def __init__(self, tenants: dict[str, TenantConfig] | None = None,
                 default: TenantConfig | None = None,
                 on_shed: Callable[[Any], None] | None = None):
        self.default = (default or TenantConfig()).validate()
        self._tenants: dict[str, _TenantState] = {}
        self._lock = threading.Lock()
        self._vtime = 0.0                       # WFQ virtual clock
        self.on_shed = on_shed
        now = time.monotonic()
        for name, cfg in (tenants or {}).items():
            cfg = dataclasses.replace(cfg, name=name).validate()
            self._tenants[name] = _TenantState(cfg, now)

    # ------------------------------------------------------------------
    def _state(self, tenant: str, now: float) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            # unknown tenants serve under the default policy (their own
            # bucket/queue — "default" is a template, not a shared lane)
            cfg = dataclasses.replace(self.default, name=tenant)
            st = self._tenants[tenant] = _TenantState(cfg, now)
        return st

    # ---- HTTP-thread side --------------------------------------------
    def offer(self, item: Any, tenant: str) -> bool:
        """Queue a request. Returns False (after calling ``on_shed``)
        when the bounded-queue policy dropped one — the new arrival if
        it is the lowest-priority pending request, else the current
        lowest, making room. True means *some* request was shed only if
        it was not ``item`` itself."""
        now = time.monotonic()
        shed = None
        with self._lock:
            st = self._state(tenant, now)
            st.counters["offered"] += 1
            # finish tag assigned at enqueue (classic WFQ): frozen for
            # the request's queue lifetime, so a backlogged light
            # tenant's head keeps its early tag and gets its
            # proportional turn instead of being outbid every pop
            tag = max(self._vtime, st.vfinish) + 1.0 / st.cfg.weight
            if len(st.pending) >= st.cfg.max_pending:
                victim_i = min(
                    range(len(st.pending)),
                    key=lambda i: (getattr(st.pending[i][1],
                                           "priority", 0), -i))
                victim = st.pending[victim_i][1]
                if getattr(item, "priority", 0) <= getattr(
                        victim, "priority", 0):
                    shed = item
                else:
                    del st.pending[victim_i]
                    st.pending.append((tag, item))
                    st.vfinish = tag
                    shed = victim
                st.counters["shed"] += 1
            else:
                st.pending.append((tag, item))
                st.vfinish = tag
        if shed is not None:
            if self.on_shed is not None:
                self.on_shed(shed)
            return shed is not item
        return True

    # ---- engine-thread side ------------------------------------------
    def next_ready(self) -> Any | None:
        """Pop the next admissible request: among tenants with pending
        work *and* an available token, the smallest WFQ virtual finish
        tag wins. Returns None when nothing is admissible right now
        (empty, or every backlogged tenant is over its rate)."""
        now = time.monotonic()
        with self._lock:
            best: _TenantState | None = None
            best_tag = 0.0
            for st in self._tenants.values():
                if not st.pending or not st.bucket.peek(now):
                    continue
                tag = st.pending[0][0]
                if best is None or tag < best_tag:
                    best, best_tag = st, tag
            if best is None:
                return None
            best.bucket.take(now)
            self._vtime = max(self._vtime, best_tag)
            best.counters["admitted"] += 1
            return best.pending.popleft()[1]

    def requeue_front(self, item: Any, tenant: str) -> None:
        """Engine backpressure (``QueueFull``): put the request back at
        the head of its tenant queue (at the current virtual time, so
        it is first in line next pass) and count the absorbed event.
        The spent token is intentionally not refunded — a saturated
        engine must not let retries defeat the rate limit."""
        with self._lock:
            st = self._state(tenant, time.monotonic())
            st.pending.appendleft((self._vtime, item))
            st.counters["admitted"] -= 1
            st.counters["backpressure"] += 1

    def note_completed(self, tenant: str) -> None:
        with self._lock:
            st = self._tenants.get(tenant)
            if st is not None:
                st.counters["completed"] += 1

    # ------------------------------------------------------------------
    @property
    def depth(self) -> int:
        with self._lock:
            return sum(len(st.pending) for st in self._tenants.values())

    def pending_items(self) -> list:
        """Snapshot of every queued item (drain bookkeeping)."""
        with self._lock:
            return [it for st in self._tenants.values()
                    for _tag, it in st.pending]

    def snapshot(self) -> dict:
        """JSON-safe per-tenant counters + queue depths for /metrics."""
        with self._lock:
            return {
                name: {**st.counters, "pending": len(st.pending),
                       "rate": st.cfg.rate, "weight": st.cfg.weight,
                       "max_pending": st.cfg.max_pending}
                for name, st in sorted(self._tenants.items())
            }
