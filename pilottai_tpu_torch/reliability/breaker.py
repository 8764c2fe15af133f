"""Circuit breaker: fast-fail when the backend is demonstrably dead.

Without one, every request against a failed device pays the full
retry-with-backoff budget before erroring — under heavy traffic that
pins the concurrency semaphore, piles timed-out work onto a backend that
cannot serve it, and turns one device failure into minutes of 500s.
LLM-Pilot (arxiv 2410.02425) frames this as admission control for
predictable tails; the breaker is the failure-side half.

States (classic three-state machine, monotonic-clock based):

* **closed** — normal; consecutive failures are counted, any success
  resets the count. ``failure_threshold`` consecutive failures open it.
* **open** — ``allow()`` is False (callers raise ``CircuitOpenError``
  without touching the backend) until ``recovery_timeout`` elapses.
* **half-open** — up to ``half_open_max`` probe calls pass through; a
  probe success closes the breaker, a probe failure re-opens it (and
  re-arms the full recovery timeout).

Thread-safe: the engine handler calls from the event loop, chaos tests
and metrics scrapes from other threads. State transitions are counted in
``global_metrics`` (``reliability.breaker_opened`` / ``_closed``) and the
current state exposed as gauge ``reliability.breaker_state.<name>``
(0=closed, 1=half-open, 2=open).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from pilottai_tpu_torch.utils.metrics import global_metrics

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitOpenError(RuntimeError):
    """Fast-fail: the breaker is open and the call was not attempted.

    ``retry_after`` is the seconds until the next half-open probe window
    (servers surface it as a Retry-After hint)."""

    def __init__(self, message: str, retry_after: float = 0.0) -> None:
        super().__init__(message)
        self.retry_after = max(0.0, retry_after)


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing."""

    def __init__(
        self,
        failure_threshold: int = 5,
        recovery_timeout: float = 30.0,
        half_open_max: int = 1,
        name: str = "engine",
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.failure_threshold = max(1, failure_threshold)
        self.recovery_timeout = recovery_timeout
        self.half_open_max = max(1, half_open_max)
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0          # consecutive, while closed
        self._opened_at = 0.0
        self._probes = 0            # in-flight half-open probes
        # Observability hook: fired (outside the lock) with the breaker's
        # name each time it transitions closed/half-open → open. The
        # JAX handler wires this to the black-box dumper so the engine state
        # surrounding the open is captured. Must be cheap-ish and never
        # raise back into the breaker.
        self.on_open: Optional[Callable[[str], None]] = None
        self._set_gauge()

    # ------------------------------------------------------------------ #

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def retry_after(self) -> float:
        """Seconds until the next call could pass (0 when not open)."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(
                0.0, self.recovery_timeout - (self._clock() - self._opened_at)
            )

    def allow(self) -> bool:
        """True when a call may proceed. In half-open this RESERVES a
        probe slot — pair every ``allow() == True`` with exactly one
        ``record_success``/``record_failure``."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and self._probes < self.half_open_max:
                self._probes += 1
                return True
            return False

    def release_probe(self) -> None:
        """Un-reserve a half-open probe whose call ended with NO verdict
        (e.g. cancelled mid-flight). Without this the reserved slot would
        leak — ``_probes`` only resets on state transitions — and with
        every slot leaked ``allow()`` would return False forever while
        ``retry_after()`` reads 0: a permanently wedged breaker."""
        with self._lock:
            if self._state == HALF_OPEN and self._probes > 0:
                self._probes -= 1

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != CLOSED:
                self._state = CLOSED
                self._probes = 0
                global_metrics.inc("reliability.breaker_closed")
            self._set_gauge()

    def record_failure(self) -> None:
        with self._lock:
            prev = self._state
            if self._state == HALF_OPEN:
                # The probe failed: the backend is still dead — re-open
                # and re-arm the full recovery window.
                self._open()
            elif self._state == CLOSED:
                self._failures += 1
                if self._failures >= self.failure_threshold:
                    self._open()
            self._set_gauge()
            opened = self._state == OPEN and prev != OPEN
        hook = self.on_open
        if opened and hook is not None:
            # Outside the lock: the hook may take its own locks / do IO
            # (black-box dump) and must not be able to deadlock callers.
            try:
                hook(self.name)
            except Exception:  # noqa: BLE001 — hook must not break the breaker
                pass

    def force_open(self, reason: str = "forced") -> None:
        """Open immediately regardless of the failure count — the device
        watchdog's path: a *hung* engine produces no failures to count
        (calls never return), so the stall itself is the verdict. The
        normal half-open probing recovers it once ``recovery_timeout``
        elapses and the engine answers again."""
        with self._lock:
            prev = self._state
            if prev != OPEN:
                self._open()
            self._set_gauge()
            opened = self._state == OPEN and prev != OPEN
        hook = self.on_open
        if opened and hook is not None:
            try:
                hook(self.name)
            except Exception:  # noqa: BLE001 — hook must not break the breaker
                pass

    def on_engine_stall(self, snapshot: Optional[Dict[str, Any]] = None) -> None:
        """``EngineHealth`` subscriber form (reliability/watchdog.py):
        a bound method, so the health registry can hold it weakly.

        ``health_sources`` (set by the owner — the serving cell scopes
        each replica's breaker to its own engine's watchdog source)
        filters the process-wide stall fan-out: in a multi-replica
        process, replica A hanging must fast-fail A's handler, not
        ground every sibling. None (the default, single-engine
        processes) keeps the original any-stall-opens behavior."""
        sources = getattr(self, "health_sources", None)
        if sources is not None and snapshot is not None:
            stalled = set(snapshot.get("sources") or ())
            if not (stalled & set(sources)):
                return
        self.force_open("engine watchdog stall")

    # ------------------------------------------------------------------ #

    def _open(self) -> None:
        # lock held
        self._state = OPEN
        self._opened_at = self._clock()
        self._probes = 0
        self._failures = 0
        global_metrics.inc("reliability.breaker_opened")

    def _maybe_half_open(self) -> None:
        # lock held
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self.recovery_timeout
        ):
            self._state = HALF_OPEN
            self._probes = 0
            self._set_gauge()

    def _set_gauge(self) -> None:
        global_metrics.set_gauge(
            f"reliability.breaker_state.{self.name}", _STATE_GAUGE[self._state]
        )

    def open_error(self) -> CircuitOpenError:
        return CircuitOpenError(
            f"engine circuit breaker {self.name!r} is open "
            f"(backend failing; retry in {self.retry_after():.1f}s)",
            retry_after=self.retry_after(),
        )

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "retry_after": (
                    max(
                        0.0,
                        self.recovery_timeout
                        - (self._clock() - self._opened_at),
                    )
                    if self._state == OPEN else 0.0
                ),
            }
