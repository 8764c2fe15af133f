"""Span tracing threaded through handler → engine (the port's copy of
``pilottai_tpu/utils/tracing.py``, the part the engine calls).

The handler gives every request a trace id (``GenRequest.trace_id``): the
caller's, the ambient span's, or a fresh one; the batcher's threads emit
the request's engine span at completion under that id. Opening spans
(``Tracer.span``) comes with the Serve layer, ROADMAP P8a.
"""

from __future__ import annotations

import contextvars
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Span:
    name: str
    span_id: str
    parent_id: Optional[str]
    trace_id: str
    start: float = field(default_factory=time.perf_counter)
    end: Optional[float] = None
    attributes: Dict[str, Any] = field(default_factory=dict)


class Tracer:
    """Minimal in-process tracer.

    Span stacks live in a ``contextvars.ContextVar`` (not threading.local):
    interleaved asyncio tasks on one event loop each see their own stack, so
    concurrent task executions (``ServeConfig.max_concurrent_tasks`` > 1)
    get correct span parentage.
    """

    def __init__(self, max_finished: int = 10000) -> None:
        self._stack_var: contextvars.ContextVar[tuple] = contextvars.ContextVar(
            f"pilottai_span_stack_{id(self)}", default=()
        )
        self._finished: List[Span] = []
        self._lock = threading.Lock()
        self._max_finished = max_finished

    def current(self) -> Optional[Span]:
        stack = self._stack_var.get()
        return stack[-1] if stack else None

    def emit(
        self,
        name: str,
        *,
        trace_id: str,
        start: float,
        end: float,
        parent_id: Optional[str] = None,
        **attributes: Any,
    ) -> Span:
        """Record an already-finished span directly. For code that runs
        outside any task context (the batcher's device/reader threads,
        where the contextvar stack doesn't propagate): the engine emits
        its per-request span at completion time with the parent span id
        the request carried in, so the request's tree still nests
        server → handler → batcher."""
        span = Span(
            name=name,
            span_id=uuid.uuid4().hex[:16],
            parent_id=parent_id,
            trace_id=trace_id,
            start=start,
            end=end,
            attributes=attributes,
        )
        with self._lock:
            self._finished.append(span)
            if len(self._finished) > self._max_finished:
                del self._finished[: len(self._finished) // 2]
        return span

    def for_trace(self, trace_id: str) -> List[Span]:
        """Every finished span of one trace, in finish order (a flight
        recorder dump wants exactly this tree)."""
        with self._lock:
            return [s for s in self._finished if s.trace_id == trace_id]


global_tracer = Tracer()
