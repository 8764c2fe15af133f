"""Degradation ladder: shed capability before shedding availability.

Repeated engine faults inside a short window mean the device (or the
workload hitting it) is unhealthy in a way one recovery cycle won't fix.
Instead of oscillating between full-speed serving and total failure, the
ladder steps *capability* down one rung per burst of faults — each rung
trades throughput for stability using only knobs the batcher can change
between dispatches (no new chunk graph, no restarts; the port's copy of
``pilottai_tpu/reliability/degrade.py``):

====  ==================  =================================================
rung  name                effect (cumulative — each rung implies the ones
                          below it)
====  ==================  =================================================
0     ``full``            normal serving
1     ``no_draft``        speculative *model* drafting disabled (n-gram
                          drafts only — no extra shallow-layer weight
                          passes on a device that is already struggling)
2     ``min_chunk``       decode chunks clamped to the smallest compiled
                          bucket (short dispatches → short blast radius
                          and fast fold heartbeats)
3     ``half_slots``      admission capped at half the slots (less work
                          in flight per fault)
4     ``shed_batch``      batch-class requests shed outright; remaining
                          capacity defends the interactive SLO class
                          (obs/slo.py)
====  ==================  =================================================

Promotion is automatic: a clean soak of ``promote_s`` seconds without a
fault steps one rung back up (one rung per soak period, so a flapping
device climbs slowly). The current rung is exported as the
``engine.degrade_level`` gauge; every fault is counted under
``engine.faults.<reason>``.

Import cost: stdlib + utils only (control-plane safe).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict

from pilottai_tpu_torch.utils.logging import get_logger
from pilottai_tpu_torch.utils.metrics import global_metrics

FULL = 0
NO_DRAFT = 1
MIN_CHUNK = 2
HALF_SLOTS = 3
SHED_BATCH = 4

LEVEL_NAMES = ("full", "no_draft", "min_chunk", "half_slots", "shed_batch")
MAX_LEVEL = len(LEVEL_NAMES) - 1


class DegradeLadder:
    """Rolling-window fault counter driving the capability rung.

    ``record_fault`` is called by the batcher's failure paths (device
    loop errors, reader errors, poisoned folds, watchdog stalls); the
    batcher consults ``level()`` between dispatches. Thread-safe; the
    clock is injectable for tests.
    """

    def __init__(
        self,
        fault_threshold: int = 3,
        window_s: float = 30.0,
        promote_s: float = 60.0,
        enabled: bool = True,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.fault_threshold = max(1, fault_threshold)
        self.window_s = window_s
        self.promote_s = promote_s
        self.enabled = enabled
        self._clock = clock
        self._lock = threading.Lock()
        self._level = FULL
        self._faults: Deque[float] = deque()
        self._last_change = clock()
        self._log = get_logger("reliability.degrade")
        global_metrics.set_gauge("engine.degrade_level", 0.0)

    # ------------------------------------------------------------------ #

    def record_fault(self, reason: str = "fault") -> int:
        """Count one fault event; step the rung down (level up) when the
        rolling window crosses the threshold. Returns the current level."""
        global_metrics.inc(f"engine.faults.{reason}")
        now = self._clock()
        with self._lock:
            self._promote_locked(now)
            if not self.enabled:
                return self._level
            self._faults.append(now)
            while self._faults and now - self._faults[0] > self.window_s:
                self._faults.popleft()
            if (
                len(self._faults) >= self.fault_threshold
                and self._level < MAX_LEVEL
            ):
                self._level += 1
                self._faults.clear()  # each rung needs a fresh burst
                self._last_change = now
                global_metrics.inc("engine.degrade_steps")
                self._set_gauge()
                self._log.warning(
                    "degrade ladder stepped to %d (%s) after fault %r",
                    self._level, LEVEL_NAMES[self._level], reason,
                )
            return self._level

    def level(self) -> int:
        """Current rung, with clock-driven auto-promotion applied: each
        clean ``promote_s`` soak since the last change steps one rung
        back toward full capability."""
        with self._lock:
            self._promote_locked(self._clock())
            return self._level

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            self._promote_locked(self._clock())
            return {
                "level": self._level,
                "name": LEVEL_NAMES[self._level],
                "faults_in_window": len(self._faults),
                "enabled": self.enabled,
            }

    # ------------------------------------------------------------------ #

    def _promote_locked(self, now: float) -> None:
        promoted = False
        while (
            self._level > FULL
            and now - self._last_change >= self.promote_s
        ):
            self._level -= 1
            self._last_change += self.promote_s
            promoted = True
        if promoted:
            self._faults.clear()
            self._set_gauge()
            self._log.info(
                "clean soak: degrade ladder promoted to %d (%s)",
                self._level, LEVEL_NAMES[self._level],
            )

    def _set_gauge(self) -> None:
        global_metrics.set_gauge("engine.degrade_level", float(self._level))
