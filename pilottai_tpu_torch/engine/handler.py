"""LLMHandler: the facade callers use (the port's counterpart of
``pilottai_tpu/engine/handler.py`` with the same ``generate_response``
signature). This slice keeps the request normalization, a concurrency
semaphore and the per-call timeout; the rate limiter, retries, circuit
breaker and flight recorder come with later slices (ROADMAP P6b, P8).
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, Optional, Sequence

from pilottai_tpu_torch.core.config import LLMConfig
from pilottai_tpu_torch.engine.base import LLMBackend
from pilottai_tpu_torch.engine.types import (
    ChatMessage,
    GenerationParams,
    LLMResponse,
    ToolSpec,
)


class LLMHandler:
    """Provider facade over the port's engine."""

    def __init__(
        self,
        config: Optional[LLMConfig | Dict[str, Any]] = None,
        backend: Optional[LLMBackend] = None,
    ) -> None:
        if isinstance(config, dict):
            config = LLMConfig(**config)
        self.config = config or LLMConfig()
        if backend is None:
            from pilottai_tpu_torch.engine.native import TorchEngine

            backend = TorchEngine(self.config)
        self.backend = backend
        self._semaphore = asyncio.Semaphore(self.config.max_concurrent_requests)

    async def start(self) -> None:
        await self.backend.start()

    async def stop(self) -> None:
        await self.backend.stop()

    def _normalize(self, messages, tools, params, json_mode, json_schema, slo_class,
                   session_id, priority, gang_id, gang_size):
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
        if update:
            params = params.model_copy(update=update)
        return msgs, specs, params

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
        """Chat completion. ``json_mode`` overrides the config/params flag
        (grammar-constrained decoding). Fields whose feature belongs to a
        later slice (``json_schema``, ``slo_class``, ``session_id``,
        ``priority``, ``gang_id``) are refused by the engine, naming the
        ROADMAP item that brings them."""
        msgs, specs, params = self._normalize(
            messages, tools, params, json_mode, json_schema, slo_class,
            session_id, priority, gang_id, gang_size,
        )
        async with self._semaphore:
            return await asyncio.wait_for(
                self.backend.generate(msgs, specs or None, params),
                timeout=self.config.timeout,
            )
