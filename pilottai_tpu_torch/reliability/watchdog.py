"""Device watchdog: detect a *hung* engine, not just a failed one.

A device-side exception reaches the batcher's except-arms and is handled
(recovery, rebuild). A *stuck* dispatch — a hung launch, a kernel that
never ends, a copy that never lands — never raises anywhere: the device thread blocks inside the
dispatch, folds stop arriving, and every client simply hangs until its
own timeout. The watchdog turns that silent state into an explicit one:

* the batcher ``beat()``s the watchdog on every fold / prefill /
  segment advance (progress heartbeats);
* a monitor thread declares the engine **stalled** when heartbeats go
  stale for ``stall_s`` seconds *while work is in flight* (an idle
  engine never beats and is healthy by definition);
* a stall fires the ``EngineHealth`` registry: the health endpoint
  flips to 503 (with a ``retry_after`` hint), subscribed circuit
  breakers force-open so new requests fast-fail instead of queueing
  onto a dead device, and the batcher's ``on_stall`` hook counts the
  stall as a fault on its degrade ladder — a hung dispatch becomes a
  503 instead of a pile of silent client hangs (the black-box dump the
  JAX batcher also writes there comes with the port's ``obs``, ROADMAP
  P6b's second half);
* a late heartbeat (the hang resolved) marks the engine recovered; the
  breaker re-closes through its own half-open probing.

The port's copy of ``pilottai_tpu/reliability/watchdog.py``. Import
cost: stdlib + utils only (the package's control-plane constraint).
"""

from __future__ import annotations

import inspect
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

from pilottai_tpu_torch.utils.logging import get_logger
from pilottai_tpu_torch.utils.metrics import global_metrics


class EngineHealth:
    """Process-level engine liveness registry.

    One place three consumers meet: the watchdog writes stall/recovery
    transitions, the HTTP edge reads ``healthy()`` for ``/healthz``, and
    circuit breakers ``subscribe()`` so a stall force-opens them without
    the batcher ever knowing a breaker exists (the handler owns the
    breaker, the engine backend owns the batcher — this registry is the
    only coupling point). Subscribers are held weakly (bound methods via
    ``WeakMethod``) so short-lived handlers in tests never accumulate.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # Per-SOURCE stall records: a process can host several engines
        # (APIServer's multi-model handler map), each with its own
        # watchdog — one engine recovering must not flip /healthz back
        # to 200 while a sibling is still hung. Healthy ⇔ no sources.
        self._stalls: Dict[str, Dict[str, Any]] = {}
        self._subs: List[Any] = []
        self._log = get_logger("reliability.health")

    def subscribe(self, callback: Callable[[Dict[str, Any]], None]) -> None:
        """Register ``callback(snapshot)`` to fire on every transition to
        stalled (not on recovery — a breaker re-closes by probing)."""
        ref = (
            weakref.WeakMethod(callback)
            if inspect.ismethod(callback) else (lambda cb=callback: cb)
        )
        with self._lock:
            self._subs.append(ref)

    def mark_stalled(
        self, reason: str = "engine stalled", retry_after: float = 0.0,
        source: str = "engine", **info: Any,
    ) -> None:
        with self._lock:
            self._stalls[source] = {
                "reason": reason,
                "since": time.monotonic(),
                "retry_after": retry_after,
            }
            live = []
            subs = []
            for ref in self._subs:
                cb = ref()
                if cb is not None:
                    live.append(ref)
                    subs.append(cb)
            self._subs = live
        global_metrics.set_gauge("engine.stalled", 1.0)
        # Subscribers (breakers) BEFORE the log line: the health flip is
        # already observable, and fast-fail should engage before we
        # spend time formatting diagnostics.
        snap = self.snapshot()
        for cb in subs:
            try:
                cb(snap)
            except Exception as exc:  # noqa: BLE001 — never break the marker
                self._log.warning("engine-stall subscriber failed: %s", exc)
        self._log.error("engine %r marked stalled: %s", source, reason)

    def mark_recovered(self, source: str = "engine") -> None:
        with self._lock:
            was = self._stalls.pop(source, None)
            still = bool(self._stalls)
        global_metrics.set_gauge("engine.stalled", 1.0 if still else 0.0)
        if was is not None:
            self._log.info(
                "engine %r marked recovered (%s)", source,
                "others still stalled" if still else "all healthy",
            )

    def healthy(self) -> bool:
        return not self._stalls

    def source_healthy(self, source: Optional[str]) -> bool:
        """Per-source verdict: a multi-replica process (serving cell)
        must keep routing to healthy replicas while a sibling is hung —
        the aggregate ``healthy()`` would ground the whole cell."""
        if source is None:
            return self.healthy()
        with self._lock:
            return source not in self._stalls

    def snapshot(self) -> Dict[str, Any]:
        """Aggregate view (the health endpoint's shape): oldest stall's
        age, every source's reason, the largest retry_after."""
        now = time.monotonic()
        with self._lock:
            if not self._stalls:
                return {
                    "stalled": False, "reason": None,
                    "stalled_for_s": None, "retry_after": 0.0,
                }
            return {
                "stalled": True,
                "reason": "; ".join(
                    s["reason"] for s in self._stalls.values()
                ),
                "stalled_for_s": round(
                    now - min(s["since"] for s in self._stalls.values()), 3
                ),
                "retry_after": max(
                    s["retry_after"] for s in self._stalls.values()
                ),
                "sources": sorted(self._stalls),
            }

    def reset(self) -> None:
        """Test teardown: clear state AND subscribers."""
        with self._lock:
            self._stalls.clear()
            self._subs = []
        global_metrics.set_gauge("engine.stalled", 0.0)


global_engine_health = EngineHealth()


class Watchdog:
    """Heartbeat-staleness monitor for one batcher's device loop.

    ``beat()`` is called by the progress paths (fold, prefill install,
    segment advance); ``has_work()`` is the batcher's cheap "anything in
    flight or queued?" probe. While ``has_work()`` is False the last-beat
    mark tracks the clock, so the stall timer starts at the moment work
    appears — an idle engine can never trip. Warmup compiles are excluded
    the same way (the batcher's probe returns False while warming).
    """

    def __init__(
        self,
        stall_s: float,
        has_work: Callable[[], bool],
        on_stall: Optional[Callable[[Dict[str, Any]], None]] = None,
        name: str = "engine",
        health: Optional[EngineHealth] = None,
        poll_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.stall_s = stall_s
        self.poll_s = poll_s if poll_s is not None else max(
            min(stall_s / 4.0, 0.25), 0.01
        )
        self.name = name
        self._has_work = has_work
        self._on_stall = on_stall
        self._health = health if health is not None else global_engine_health
        self._clock = clock
        self._last = clock()
        self._stalled = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._log = get_logger("reliability.watchdog")

    def beat(self) -> None:
        """Progress heartbeat (any thread; a plain float store)."""
        self._last = self._clock()

    @property
    def stalled(self) -> bool:
        return self._stalled

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._last = self._clock()
        self._thread = threading.Thread(
            target=self._run, name=f"pilottai-watchdog-{self.name}",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._stalled:
            # A deliberate engine stop while stalled must not leave the
            # process health endpoint pinned at 503 forever (only THIS
            # watchdog's stall clears — siblings stay stalled).
            self._stalled = False
            self._health.mark_recovered(self.name)

    # ------------------------------------------------------------------ #

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            now = self._clock()
            try:
                busy = bool(self._has_work())
            except Exception:  # noqa: BLE001 — probe must not kill the dog
                busy = False
            if not busy:
                if self._stalled:
                    self._recover()
                self._last = now
                continue
            stale = now - self._last
            if stale >= self.stall_s and not self._stalled:
                self._trip(stale)
            elif stale < self.stall_s and self._stalled:
                self._recover()

    def _trip(self, stale: float) -> None:
        self._stalled = True
        global_metrics.inc("engine.watchdog_stalls")
        info = {
            "stalled_for_s": round(stale, 3),
            "stall_s": self.stall_s,
            "watchdog": self.name,
        }
        self._log.error(
            "engine %s stalled: no fold/prefill heartbeat for %.2fs with "
            "work in flight (stall_s=%.2fs)", self.name, stale, self.stall_s,
        )
        self._health.mark_stalled(
            reason=(
                f"device loop heartbeat stale for {stale:.2f}s with work "
                f"in flight (watchdog_stall_s={self.stall_s})"
            ),
            retry_after=self.stall_s,
            source=self.name,
            **info,
        )
        if self._on_stall is not None:
            try:
                self._on_stall(info)
            except Exception as exc:  # noqa: BLE001 — diagnostics only
                self._log.warning("watchdog on_stall hook failed: %s", exc)

    def _recover(self) -> None:
        self._stalled = False
        global_metrics.inc("engine.watchdog_recoveries")
        self._health.mark_recovered(self.name)
