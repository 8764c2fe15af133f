"""The port's ``LLMHandler`` fault handling (ROADMAP P6b, the fault domain;
the JAX handler's rules, ``tests/test_chaos.py``'s cases) against a
scripted backend defined here (the port has no mock backend before slice
P8a): retries with backoff, the rate limiter, the breaker opening and
recovering through half-open, a deadline that pre-empts the backend call
and the backoff, an overload that is neither retried nor a breaker
failure, the ``handler.timeout`` fault point, and the port's engine taking
the JAX defaults of the reliability knobs and requests that carry a
deadline and an SLO class."""

import asyncio
import time

import pytest
import torch

from pilottai_tpu_torch import LLMConfig, LLMHandler
from pilottai_tpu_torch.core.config import ReliabilityConfig
from pilottai_tpu_torch.engine.base import LLMBackend
from pilottai_tpu_torch.engine.handler import RateLimiter
from pilottai_tpu_torch.engine.types import GenerationParams, LLMResponse, Usage
from pilottai_tpu_torch.reliability import (
    CircuitOpenError,
    DeadlineExceeded,
    EngineOverloaded,
    global_engine_health,
    global_injector,
)
from pilottai_tpu_torch.utils.metrics import global_metrics
from pilottai_tpu_torch.utils.tracing import global_tracer


@pytest.fixture(autouse=True)
def _clean_registries():
    global_injector.reset()
    global_engine_health.reset()
    yield
    global_injector.reset()
    global_engine_health.reset()


class Scripted(LLMBackend):
    """Answers from a script: each call takes the next step, an exception
    to raise, a number of seconds to sleep first, or None to answer."""

    name = "scripted"

    def __init__(self, *steps, delay=0.0):
        self.steps = list(steps)
        self.delay = delay
        self.calls = []

    async def generate(self, messages, tools=None, params=None):
        self.calls.append((time.monotonic(), params))
        if self.delay:
            await asyncio.sleep(self.delay)
        step = self.steps.pop(0) if self.steps else None
        if isinstance(step, BaseException):
            raise step
        return LLMResponse(content="ok", model="scripted",
                           usage=Usage(prompt_tokens=3, completion_tokens=1))


def _handler(backend, **kw):
    top = {k: kw.pop(k) for k in ("retries", "retry_delay", "timeout", "max_rpm") if k in kw}
    return LLMHandler(LLMConfig(model_name="llama-tiny", reliability=ReliabilityConfig(**kw),
                                **top), backend=backend)


def test_retries_with_backoff_then_success():
    backend = Scripted(RuntimeError("device gone"), RuntimeError("device gone"))
    h = _handler(backend, retries=3, retry_delay=0.05, retry_jitter=False)
    before = global_metrics.get("engine.errors")
    t0 = time.monotonic()
    resp = asyncio.run(h.generate_response(["x"]))
    assert resp.content == "ok" and len(backend.calls) == 3
    gaps = [b[0] - a[0] for a, b in zip(backend.calls, backend.calls[1:])]
    assert gaps[0] >= 0.05 and gaps[1] >= 0.1          # 0.05 x 2^attempt
    assert time.monotonic() - t0 < 5
    assert global_metrics.get("engine.errors") == before + 2
    assert h.breaker.state == "closed"
    # Every attempt flies under one trace id.
    traces = {p.trace_id for _, p in backend.calls}
    assert len(traces) == 1 and None not in traces


def test_retries_exhausted_raise_with_the_last_error():
    backend = Scripted(*[RuntimeError("still gone")] * 3)
    h = _handler(backend, retries=2, retry_delay=0.0, breaker_enabled=False)
    with pytest.raises(RuntimeError, match="failed after 3 attempts") as info:
        asyncio.run(h.generate_response(["x"]))
    assert "still gone" in str(info.value.__cause__) and len(backend.calls) == 3


def test_rate_limiter_holds_a_sliding_window():
    async def main():
        limiter = RateLimiter(max_rpm=2, window=0.2)
        t0 = time.monotonic()
        for _ in range(3):
            await limiter.acquire()
        return time.monotonic() - t0

    assert 0.15 <= asyncio.run(main()) < 2.0
    backend = Scripted()
    h = _handler(backend, max_rpm=2)
    assert h._limiter is not None and h._limiter.max_rpm == 2
    h._limiter.window = 0.2

    async def burst():
        t0 = time.monotonic()
        await asyncio.gather(*[h.generate_response(["x"]) for _ in range(3)])
        return time.monotonic() - t0

    assert asyncio.run(burst()) >= 0.15 and len(backend.calls) == 3
    assert _handler(Scripted())._limiter is None        # max_rpm None: no limit


def test_breaker_opens_then_recovers_through_half_open():
    backend = Scripted(RuntimeError("device gone"), RuntimeError("device gone"))
    h = _handler(backend, retries=0, retry_delay=0.0, breaker_failure_threshold=2,
                 breaker_recovery_timeout=0.1)

    async def main():
        for _ in range(2):
            with pytest.raises(RuntimeError):
                await h.generate_response(["x"])
        assert h.breaker.state == "open" and len(backend.calls) == 2
        with pytest.raises(CircuitOpenError):          # fast fail, backend untouched
            await h.generate_response(["x"])
        assert len(backend.calls) == 2
        await asyncio.sleep(0.12)
        assert (await h.generate_response(["x"])).content == "ok"   # the probe
        assert h.breaker.state == "closed" and len(backend.calls) == 3

    asyncio.run(main())


def test_handler_timeout_fault_point_feeds_the_breaker():
    backend = Scripted()
    h = _handler(backend, retries=0, retry_delay=0.0, breaker_failure_threshold=2,
                 breaker_recovery_timeout=0.1)
    global_injector.arm("handler.timeout", asyncio.TimeoutError, times=2)

    async def main():
        for _ in range(2):
            with pytest.raises(RuntimeError, match="failed after 1 attempt"):
                await h.generate_response(["x"])
        assert not backend.calls and h.breaker.state == "open"
        await asyncio.sleep(0.12)
        assert (await h.generate_response(["x"])).content == "ok"
        assert h.breaker.state == "closed"

    asyncio.run(main())
    assert global_injector.fired("handler.timeout") == 2


def test_engine_stall_force_opens_the_handlers_breaker():
    h = _handler(Scripted(), breaker_recovery_timeout=60.0)
    global_engine_health.mark_stalled(reason="test stall", retry_after=1.0, source="eng")
    assert h.breaker.state == "open"
    with pytest.raises(CircuitOpenError):
        asyncio.run(h.generate_response(["x"]))


def test_deadline_preempts_the_backend_call_and_the_backoff():
    backend = Scripted(delay=0.5)
    h = _handler(backend, retries=3, retry_delay=5.0, breaker_enabled=False)
    with pytest.raises(DeadlineExceeded):                 # born expired: no call
        asyncio.run(h.generate_response(["x"], params=GenerationParams(
            deadline=time.monotonic() - 1)))
    assert not backend.calls
    t0 = time.perf_counter()
    with pytest.raises(DeadlineExceeded, match="mid-generation"):
        asyncio.run(h.generate_response(["x"], params=GenerationParams(
            deadline=time.monotonic() + 0.1)))
    assert time.perf_counter() - t0 < 0.45 and len(backend.calls) == 1
    # A failure whose backoff would outlive the deadline fails at once.
    failing = Scripted(RuntimeError("device gone"))
    h = _handler(failing, retries=3, retry_delay=5.0, retry_jitter=False,
                 breaker_enabled=False)
    t0 = time.perf_counter()
    with pytest.raises(DeadlineExceeded, match="after 1 attempt"):
        asyncio.run(h.generate_response(["x"], params=GenerationParams(
            deadline=time.monotonic() + 1.0)))
    assert time.perf_counter() - t0 < 0.5 and len(failing.calls) == 1


def test_overload_is_neither_retried_nor_a_breaker_failure():
    backend = Scripted(EngineOverloaded("queue full"))
    h = _handler(backend, retries=3, retry_delay=0.0, breaker_failure_threshold=1)
    with pytest.raises(EngineOverloaded):
        asyncio.run(h.generate_response(["x"]))
    assert len(backend.calls) == 1 and h.breaker.state == "closed"


def test_the_engine_takes_the_jax_defaults_and_deadline_and_slo_class_requests(monkeypatch):
    """``LLMConfig`` at the JAX defaults of the reliability knobs drives the
    port's engine on the CPU (its warm-up sweep left out); requests carrying
    a deadline and an SLO class are served, one whose deadline passes fails
    with ``DeadlineExceeded``, and the batcher holds the configured fault
    domain."""
    cfg = LLMConfig(provider="cpu", model_name="llama-tiny", dtype="float32", engine_slots=2,
                    engine_max_seq=128, engine_prefix_cache=0, retries=3, retry_delay=1.0,
                    max_rpm=None, reliability=ReliabilityConfig(max_queue_depth=8,
                                                                recovery_max_attempts=1))
    from pilottai_tpu_torch.engine.batcher import ContinuousBatcher

    monkeypatch.setattr(ContinuousBatcher, "warmup", lambda self, prompt_lens=None: None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)

    async def main():
        h = LLMHandler(cfg)
        try:
            ok = await h.generate_response(["Plan the step."], params=GenerationParams(
                temperature=0.0, max_new_tokens=6, deadline=time.monotonic() + 60,
                trace_id="trace-p6b"), slo_class="batch")
            assert ok.usage.completion_tokens == 6
            # The batcher emits the request's engine span under its trace id.
            spans = global_tracer.for_trace("trace-p6b")
            assert [s.name for s in spans] == ["engine.batch_decode"]
            assert spans[0].attributes["tokens"] == 6
            b = h.backend.batcher
            assert (b.max_queue_depth, b.recovery_max_attempts) == (8, 1)
            with pytest.raises(DeadlineExceeded):
                await h.generate_response(["late"], params=GenerationParams(
                    temperature=0.0, max_new_tokens=6, deadline=time.monotonic() + 1e-4))
        finally:
            await h.stop()

    try:
        asyncio.run(main())
    finally:
        torch.set_num_threads(n)
