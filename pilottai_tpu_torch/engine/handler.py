"""LLMHandler: the facade callers use (the port's counterpart of
``pilottai_tpu/engine/handler.py`` with the same ``generate_response``
signature): request normalization, a trace id for every request, a
sliding-window rate limit (``max_rpm``), a concurrency semaphore, the
per-call timeout clipped by the request's deadline, retries with capped
and jittered exponential backoff, and a circuit breaker over the engine
calls that a watchdog stall (``global_engine_health``) force-opens. The
flight recorder, the per-attempt ``engine.generate`` span and the
black-box dumps the JAX handler writes come with the metrics foundation
(ROADMAP P6b, second half).
"""

from __future__ import annotations

import asyncio
import random
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from pilottai_tpu_torch.core.config import LLMConfig, NotInSlice
from pilottai_tpu_torch.engine.base import LLMBackend
from pilottai_tpu_torch.engine.types import (
    ChatMessage,
    GenerationParams,
    LLMResponse,
    ToolSpec,
)
from pilottai_tpu_torch.reliability import (
    CircuitBreaker,
    DeadlineExceeded,
    EngineOverloaded,
    global_engine_health,
    global_injector,
)
from pilottai_tpu_torch.utils.logging import get_logger, setup_logging
from pilottai_tpu_torch.utils.metrics import global_metrics
from pilottai_tpu_torch.utils.tracing import global_tracer


class RateLimiter:
    """Sliding-window requests-per-minute limiter, lock-protected and
    non-blocking for peers (the JAX handler's)."""

    def __init__(self, max_rpm: int, window: float = 60.0) -> None:
        self.max_rpm = max_rpm
        self.window = window
        self._stamps: deque = deque()
        self._lock = asyncio.Lock()

    async def acquire(self) -> None:
        while True:
            async with self._lock:
                now = time.monotonic()
                while self._stamps and now - self._stamps[0] > self.window:
                    self._stamps.popleft()
                if len(self._stamps) < self.max_rpm:
                    self._stamps.append(now)
                    return
                wait = self.window - (now - self._stamps[0]) + 0.01
            await asyncio.sleep(wait)


class LLMHandler:
    """Provider facade over the port's engine, with throttling and retries."""

    def __init__(
        self,
        config: Optional[LLMConfig | Dict[str, Any]] = None,
        backend: Optional[LLMBackend] = None,
    ) -> None:
        setup_logging()
        if isinstance(config, dict):
            config = LLMConfig(**config)
        self.config = config or LLMConfig()
        if backend is None:
            from pilottai_tpu_torch.engine.native import TorchEngine

            backend = TorchEngine(self.config)
        self.backend = backend
        self._semaphore = asyncio.Semaphore(self.config.max_concurrent_requests)
        self._limiter = RateLimiter(self.config.max_rpm) if self.config.max_rpm else None
        # The breaker over every engine call: repeated backend failures
        # fast-fail (CircuitOpenError) instead of piling retry budgets onto a
        # dead device; an engine stall force-opens it (held weakly).
        rel = self.config.reliability
        self.breaker: Optional[CircuitBreaker] = (
            CircuitBreaker(
                failure_threshold=rel.breaker_failure_threshold,
                recovery_timeout=rel.breaker_recovery_timeout,
                half_open_max=rel.breaker_half_open_max,
                name=self.config.model_name,
            )
            if rel.breaker_enabled else None
        )
        if self.breaker is not None:
            global_engine_health.subscribe(self.breaker.on_engine_stall)
        self._log = get_logger("engine.handler")

    async def start(self) -> None:
        await self.backend.start()

    async def stop(self) -> None:
        await self.backend.stop()

    def _normalize(self, messages, tools, params, json_mode, json_schema, slo_class,
                   session_id, priority, gang_id, gang_size):
        """Messages, tool specs and the request's parameters, which carry a
        trace id: the caller's, the ambient span's, or a fresh one. One
        copy of the parameters at most: a burst of requests is submitted
        back to back and admitted together."""
        msgs = [ChatMessage.coerce(m) for m in messages]
        specs = [t if isinstance(t, ToolSpec) else ToolSpec(**t) for t in (tools or [])]
        if params is None:
            s = self.config.sampling
            params = GenerationParams(
                max_new_tokens=s.max_new_tokens, temperature=s.temperature,
                top_k=s.top_k, top_p=s.top_p, seed=s.seed, json_mode=s.json_mode,
            )
        update: Dict[str, Any] = {}
        if json_mode is not None and json_mode != params.json_mode:
            update["json_mode"] = json_mode
        if json_schema is not None:
            update.update(json_schema=json_schema, json_mode=True)
        for name, value in (("slo_class", slo_class), ("session_id", session_id),
                            ("priority", priority), ("gang_id", gang_id)):
            if value is not None and getattr(params, name) is None:
                update[name] = value
        if gang_id is not None and params.gang_id is None:
            update["gang_size"] = gang_size
        if params.trace_id is None:
            ambient = global_tracer.current()
            update["trace_id"] = (ambient.trace_id if ambient is not None
                                  else f"{random.getrandbits(64):016x}")
        return msgs, specs, params.model_copy(update=update)

    async def generate_response(
        self,
        messages: Sequence[ChatMessage | Dict[str, Any] | str],
        tools: Optional[Sequence[ToolSpec | Dict[str, Any]]] = None,
        params: Optional[GenerationParams] = None,
        json_mode: Optional[bool] = None,
        json_schema: Optional[Dict[str, Any]] = None,
        slo_class: Optional[str] = None,
        session_id: Optional[str] = None,
        priority: Optional[int] = None,
        gang_id: Optional[str] = None,
        gang_size: int = 0,
    ) -> LLMResponse:
        """Chat completion with retries and backoff. ``json_mode`` overrides
        the config/params flag (grammar-constrained decoding); ``slo_class``
        fills the request's class where params carry none, and
        ``session_id`` its KV-cache session handle (a multi-turn caller's
        lineage, pinned in the host tier across turns) by the same rule.
        Fields whose feature belongs to a later slice (``json_schema``,
        ``priority``, ``gang_id``) are refused by the engine, naming the
        ROADMAP item that brings them."""
        msgs, specs, params = self._normalize(
            messages, tools, params, json_mode, json_schema, slo_class,
            session_id, priority, gang_id, gang_size,
        )
        return await self._generate_attempts(msgs, specs, params, params.deadline)

    async def _generate_attempts(
        self,
        msgs: List[ChatMessage],
        specs: List[ToolSpec],
        params: GenerationParams,
        deadline: Optional[float],
    ) -> LLMResponse:
        """The retry loop: up to ``retries`` more attempts after a failure,
        each behind the breaker. The deadline is checked before an attempt
        (and before the breaker reserves a probe), clips the attempt's
        wait, and pre-empts a backoff it would not outlive. An overload is
        neither retried nor a breaker failure; a passed deadline is
        terminal and counts against the breaker. A request field the port
        does not carry yet (``NotInSlice``) is raised at once."""
        last_error: Optional[Exception] = None
        for attempt in range(self.config.retries + 1):
            if deadline is not None and time.monotonic() >= deadline:
                raise DeadlineExceeded(
                    f"request deadline exhausted after {attempt} attempt(s)") from last_error
            if self.breaker is not None and not self.breaker.allow():
                raise self.breaker.open_error() from last_error
            # allow() may have reserved a half-open probe: every exit from
            # this attempt settles it (record_*) or releases it (finally).
            settled = False
            try:
                # Fault point: a wedged backend at the handler boundary.
                global_injector.fire("handler.timeout")
                if self._limiter:
                    await self._limiter.acquire()
                async with self._semaphore:
                    start = time.perf_counter()
                    budget = self.config.timeout
                    if deadline is not None:
                        budget = min(budget, deadline - time.monotonic())
                    try:
                        response = await asyncio.wait_for(
                            self.backend.generate(msgs, specs or None, params),
                            timeout=max(budget, 1e-3),
                        )
                    except asyncio.TimeoutError:
                        if deadline is not None and time.monotonic() >= deadline:
                            raise DeadlineExceeded(
                                "request deadline exceeded mid-generation") from None
                        raise
                if self.breaker is not None:
                    self.breaker.record_success()
                settled = True
                global_metrics.observe("engine.request_latency", time.perf_counter() - start)
                global_metrics.inc("engine.requests")
                global_metrics.inc("engine.prompt_tokens", response.usage.prompt_tokens)
                global_metrics.inc("engine.completion_tokens", response.usage.completion_tokens)
                return response
            except NotInSlice:
                # A request field of a later slice: refused before any engine
                # work, and refused again on any retry (no breaker verdict).
                raise
            except EngineOverloaded:
                # Shed at admission: the engine is alive and protecting
                # itself; an immediate retry would defeat the shed.
                if self.breaker is not None:
                    self.breaker.record_success()
                settled = True
                global_metrics.inc("engine.errors")
                raise
            except DeadlineExceeded:
                if self.breaker is not None:
                    self.breaker.record_failure()
                settled = True
                global_metrics.inc("engine.errors")
                raise
            except Exception as exc:  # noqa: BLE001 — the retry boundary
                last_error = exc
                if self.breaker is not None:
                    self.breaker.record_failure()
                settled = True
                global_metrics.inc("engine.errors")
                if attempt < self.config.retries:
                    delay = self._backoff_delay(attempt)
                    if deadline is not None and time.monotonic() + delay >= deadline:
                        raise DeadlineExceeded(
                            f"request deadline exhausted after {attempt + 1} attempt(s)"
                        ) from exc
                    self._log.warning("generate attempt %d failed (%s); retrying in %.2fs",
                                      attempt + 1, exc, delay)
                    await asyncio.sleep(delay)
            finally:
                if self.breaker is not None and not settled:
                    self.breaker.release_probe()
        raise RuntimeError(
            f"LLM generation failed after {self.config.retries + 1} attempts") from last_error

    def _backoff_delay(self, attempt: int) -> float:
        """Capped exponential backoff, ``retry_delay`` x 2^attempt up to
        ``retry_max_delay``, with jitter over [0.5, 1.0] of the step so a
        wave of failures does not retry in lockstep."""
        rel = self.config.reliability
        delay = min(self.config.retry_delay * (2.0 ** attempt), rel.retry_max_delay)
        if rel.retry_jitter and delay > 0:
            delay *= 0.5 + 0.5 * random.random()
        return delay

