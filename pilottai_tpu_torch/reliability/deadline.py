"""Deadline and overload error types + small helpers.

One vocabulary for the whole request path: the HTTP edge derives an
absolute deadline (``time.monotonic()`` based — wall-clock jumps must not
expire requests), threads it through ``GenerationParams.deadline`` /
``GenRequest.deadline``, and every layer that can spend time checks it.
The server maps these to structured JSON errors (docs/SERVING.md,
"Overload & failure semantics"): ``DeadlineExceeded`` → 408,
``EngineOverloaded`` → 429, ``CircuitOpenError`` (breaker.py) → 503.
"""

from __future__ import annotations

import time
from typing import Optional


class DeadlineExceeded(TimeoutError):
    """The request's end-to-end deadline passed before it completed.

    Subclasses ``TimeoutError`` so callers that already handle timeouts
    (orchestrator retry paths, asyncio.wait_for users) treat it the same
    way without knowing about this module.
    """


class EngineOverloaded(RuntimeError):
    """Admission refused: the engine's queue is beyond its configured
    depth. Raised synchronously at submit — no slot, no queue entry, no
    partial work exists for the request."""


class PoisonedOutput(RuntimeError):
    """The device returned tokens that fail validation at the fold
    boundary (out-of-vocab ids — the host-visible symptom of NaN logits
    or corrupted device memory). Contained per request: only the
    affected slot fails; the engine and its other occupants keep
    serving. Not replayed by in-flight recovery (re-decoding corrupted
    state would reproduce the poison); the handler's normal retry loop
    gives the request a fresh attempt instead."""


def deadline_from_timeout(
    timeout: Optional[float], now: Optional[float] = None
) -> Optional[float]:
    """Relative budget → absolute monotonic deadline (None passes through)."""
    if timeout is None:
        return None
    return (now if now is not None else time.monotonic()) + timeout


def remaining(
    deadline: Optional[float], now: Optional[float] = None
) -> Optional[float]:
    """Seconds left before ``deadline`` (may be negative); None = no deadline."""
    if deadline is None:
        return None
    return deadline - (now if now is not None else time.monotonic())


def expired(deadline: Optional[float], now: Optional[float] = None) -> bool:
    if deadline is None:
        return False
    return (now if now is not None else time.monotonic()) >= deadline
