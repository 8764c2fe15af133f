"""Engine wire types: messages, tool specs, generation parameters,
responses — the port's copy of ``pilottai_tpu/engine/types.py`` for the
fields the port serves. Fields whose feature belongs to a later slice
(schemas, priorities, gangs) are kept so a caller gets a clear refusal
from the engine, not a validation error."""

from __future__ import annotations

import time
from typing import Any, Dict, List, Literal, Optional

from pydantic import BaseModel, Field

Role = Literal["system", "user", "assistant", "tool"]


class ChatMessage(BaseModel):
    role: Role = "user"
    content: str = ""
    name: Optional[str] = None
    tool_call_id: Optional[str] = None

    @classmethod
    def coerce(cls, value: Any) -> "ChatMessage":
        if isinstance(value, ChatMessage):
            return value
        if isinstance(value, dict):
            return cls(**value)
        return cls(role="user", content=str(value))


class ToolSpec(BaseModel):
    """Function-calling tool description."""

    name: str
    description: str = ""
    parameters: Dict[str, Any] = Field(default_factory=dict)


class ToolCall(BaseModel):
    id: str = ""
    name: str
    arguments: Dict[str, Any] = Field(default_factory=dict)


class GenerationParams(BaseModel):
    """Per-request decode parameters (overrides the engine defaults)."""

    max_new_tokens: int = 256
    temperature: float = 0.7
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    stop: List[str] = Field(default_factory=list)
    json_mode: bool = False
    # End-to-end request deadline: ABSOLUTE ``time.monotonic()`` time (not
    # a relative budget — a deadline survives queueing and retries without
    # re-arming; ``reliability.deadline_from_timeout`` makes one). The
    # handler's retry loop and the batcher's admission and decode check it
    # and fail with ``reliability.DeadlineExceeded`` when it passes. None =
    # no deadline.
    deadline: Optional[float] = None
    # Trace correlation id, threaded handler → backend → batcher (the
    # handler assigns one when the caller sets none); the batcher emits the
    # request's engine span under it.
    trace_id: Optional[str] = None
    # SLO service class: "interactive" (None) or "batch", which sheds at a
    # lower queue depth and outright at the degrade ladder's last rung.
    slo_class: Optional[str] = None
    # KV-cache session handle: the turns of one conversation send the same
    # id, which pins their K/V lineage in the host tier
    # (``engine_kvcache_host_mb``) across device-cache evictions, so a
    # resume restores instead of prefilling its whole history. None =
    # anonymous (cached, not pinned).
    session_id: Optional[str] = None
    # Later slices; the engine refuses a request that sets them.
    json_schema: Optional[Dict[str, Any]] = None
    priority: Optional[int] = None
    gang_id: Optional[str] = None
    gang_size: int = 0


class Usage(BaseModel):
    prompt_tokens: int = 0
    completion_tokens: int = 0

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.completion_tokens


class LLMResponse(BaseModel):
    """Normalized engine response."""

    content: str = ""
    role: Role = "assistant"
    tool_calls: List[ToolCall] = Field(default_factory=list)
    model: str = ""
    usage: Usage = Field(default_factory=Usage)
    finish_reason: str = "stop"
    latency: float = 0.0
    created_at: float = Field(default_factory=time.time)
