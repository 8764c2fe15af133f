"""Fault-injection registry: named failure points, scriptable from tests.

The failure paths this tree claims to handle (device failure → slot
recovery, heartbeat loss → agent replacement, journal loss → at-least-once
replay) were previously only reachable by monkeypatching internals. This
registry gives every such path a stable, named trigger that is a **no-op
in production** (one empty-dict check, no lock) and scriptable from chaos
tests: raise an exception, sleep to simulate a slow/hung dependency, or
hand the consuming site a value (e.g. seconds of heartbeat stall).

Canonical points wired in the port (callers may add more; names are
free-form; the JAX package's agent, checkpoint, mesh and cell points
come with the port's slices of those modules):

===========================  =============================================
``engine.step``              decode-chunk dispatch (``batcher._decode``)
``engine.prefill``           admission prefill (``_dispatch_prefill``, a
                             segmented prompt's final segment included) —
                             ``delay=`` simulates a slow/hung prefill,
                             ``exc=`` a failed one
``engine.dispatch.hang``     a stuck dispatch — ``delay=`` pins the device
                             thread inside ``_decode`` without raising,
                             exactly what a hung launch looks like (the
                             watchdog's detection target)
``engine.fold.corrupt``      poisons one slot's folded tokens with
                             out-of-vocab ids at the fold boundary —
                             ``value=`` the slot index (or ``True`` for
                             the first live slot)
``engine.rebuild``           failure-path ``_rebuild_device_state`` —
                             ``exc=`` simulates a rebuild that itself
                             fails (retried next device-loop cycle)
``handler.timeout``          ``LLMHandler``'s backend call boundary
``kvcache.spill.corrupt``    flips a byte of a host-tier entry AFTER its
                             CRC sealed (host-RAM rot between spill and
                             restore) — the restore must detect it and
                             prefill instead
``kvcache.restore.corrupt``  the same rot, injected at the restore site
                             (``KVCacheIndex._entry_ok``)
===========================  =============================================

Triggering is count-based (``times=N`` fires, then auto-disarm; ``times=None``
fires until disarmed) and/or probability-based (``probability=p`` with a
seeded per-registry RNG, so chaos soaks are reproducible). Fires are
counted per point (``fired(name)``) and in ``global_metrics`` under
``fault.injected.<name>``.

Thread safety: ``fire()`` is called concurrently from the batcher's
prep, device and reader threads. Every counter transition — the
``skip=N`` countdown, the probability draw, the ``fired`` increment and
the ``times`` auto-disarm — happens under ONE registry lock, so an
``arm(times=1, skip=2)`` fires exactly once after exactly two passes no
matter how many threads race the point (pinned by
the JAX package's tests/test_kv_integrity.py hammer). Only the not-armed fast path and
the post-decision effects (metrics, sleep, raise) run lock-free.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional, Type, Union

from pilottai_tpu_torch.utils.metrics import global_metrics

ExcSpec = Union[BaseException, Type[BaseException]]


@dataclass
class Fault:
    """An armed failure point. ``exc``/``delay``/``value`` compose: a fire
    sleeps ``delay`` first, then raises ``exc`` (if set), else returns
    ``value`` to the consuming site.

    The mutable counters (``skip``, ``fired``) are transitioned ONLY
    under the owning registry's lock — test code may read them freely
    (torn reads of an int are impossible in CPython) but must never
    write them while the point is armed."""

    name: str
    exc: Optional[ExcSpec] = None
    delay: float = 0.0
    value: Any = None
    times: Optional[int] = 1    # fires before auto-disarm; None = unlimited
    probability: float = 1.0
    skip: int = 0               # let this many passes through first — e.g.
                                # land a fault mid-decode, after real
                                # tokens have already folded
    fired: int = field(default=0)

    def _materialize(self) -> BaseException:
        exc = self.exc
        if isinstance(exc, type):
            return exc(f"injected fault at {self.name!r}")
        assert exc is not None
        return exc


class FaultInjector:
    """Thread-safe fault registry with a near-free production fast path."""

    def __init__(self, seed: int = 0) -> None:
        self._faults: Dict[str, Fault] = {}
        self._fired: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._rng = random.Random(seed)

    # ------------------------------------------------------------------ #
    # Arming (test side)
    # ------------------------------------------------------------------ #

    def arm(
        self,
        name: str,
        exc: Optional[ExcSpec] = None,
        *,
        delay: float = 0.0,
        value: Any = None,
        times: Optional[int] = 1,
        probability: float = 1.0,
        skip: int = 0,
    ) -> Fault:
        fault = Fault(
            name=name, exc=exc, delay=delay, value=value,
            times=times, probability=probability, skip=skip,
        )
        with self._lock:
            self._faults[name] = fault
        return fault

    def disarm(self, name: str) -> None:
        with self._lock:
            self._faults.pop(name, None)

    def reset(self) -> None:
        """Disarm everything and clear fire counts (test teardown)."""
        with self._lock:
            self._faults.clear()
            self._fired.clear()

    def armed(self, name: str) -> bool:
        # Lock-free read (CPython dict membership is atomic) — same
        # contract as fire()'s fast path: a one-call-late answer is
        # fine, a lock on every probe is not.
        return name in self._faults

    def remaining(self, name: str) -> Optional[int]:
        """Fires left before auto-disarm (None = unlimited or not
        armed) — chaos-soak introspection."""
        with self._lock:
            fault = self._faults.get(name)
            if fault is None or fault.times is None:
                return None
            return max(0, fault.times - fault.fired)

    def fired(self, name: str) -> int:
        """Times ``name`` actually triggered (survives auto-disarm)."""
        with self._lock:
            return self._fired.get(name, 0)

    # ------------------------------------------------------------------ #
    # Firing (production side)
    # ------------------------------------------------------------------ #

    def fire(self, name: str, **context: Any) -> Any:
        """Trigger point ``name``. Returns the fault's ``value`` (or None
        when not armed / not triggered); sleeps ``delay``; raises ``exc``.

        Production fast path: when nothing is armed this is a single dict
        membership check — no lock, no allocation. ``context`` kwargs are
        informational (they ride into the metrics site labels only via
        the caller) and let call sites pass ids without formatting cost
        on the fast path.

        ``delay`` uses ``time.sleep`` — intended for thread-context points
        (the batcher's device thread); async sites should inject
        exceptions instead of delays.
        """
        if name not in self._faults:  # production fast path
            return None
        with self._lock:
            fault = self._faults.get(name)
            if fault is None:
                return None
            if fault.skip > 0:
                fault.skip -= 1
                return None
            if fault.probability < 1.0 and self._rng.random() >= fault.probability:
                return None
            fault.fired += 1
            self._fired[name] = self._fired.get(name, 0) + 1
            if fault.times is not None and fault.fired >= fault.times:
                self._faults.pop(name, None)
        global_metrics.inc(f"fault.injected.{name}")
        if fault.delay > 0:
            time.sleep(fault.delay)
        if fault.exc is not None:
            raise fault._materialize()
        return fault.value

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "armed": sorted(self._faults),
                "fired": dict(self._fired),
            }


global_injector = FaultInjector()


@contextmanager
def inject(
    name: str,
    exc: Optional[ExcSpec] = None,
    *,
    injector: Optional[FaultInjector] = None,
    **kwargs: Any,
) -> Iterator[Fault]:
    """Scoped arming for tests: the point is disarmed on exit no matter
    how the block ends (count-exhausted auto-disarm included)."""
    reg = injector if injector is not None else global_injector
    fault = reg.arm(name, exc, **kwargs)
    try:
        yield fault
    finally:
        reg.disarm(name)
