"""Backend protocol and the prompt/tool-call wire helpers (the port's
copy of ``pilottai_tpu/engine/base.py``). The rendering must stay
byte-identical to the JAX package's: the protocol model was trained on
exactly this framing."""

from __future__ import annotations

import abc
from typing import Any, List, Optional, Sequence

from pilottai_tpu_torch.engine.types import (
    ChatMessage,
    GenerationParams,
    LLMResponse,
    ToolCall,
    ToolSpec,
)
from pilottai_tpu_torch.utils.json_utils import extract_json


class LLMBackend(abc.ABC):
    """An in-tree inference provider."""

    name: str = "base"

    @abc.abstractmethod
    async def generate(
        self,
        messages: Sequence[ChatMessage],
        tools: Optional[Sequence[ToolSpec]] = None,
        params: Optional[GenerationParams] = None,
    ) -> LLMResponse:
        """Run one chat generation."""

    async def start(self) -> None:  # noqa: B027 - optional lifecycle hook
        """Bring up device resources (load weights, build kernels)."""

    async def stop(self) -> None:  # noqa: B027 - optional lifecycle hook
        """Release device resources."""


def parse_tool_calls(content: str, tool_names: Sequence[str]) -> List[ToolCall]:
    """Extract structured tool invocations from a model reply:
    ``{"tool_call": {"name": ..., "arguments": {...}}}`` or the
    step-planning form ``{"action": <tool name>, "arguments": {...}}``.
    Malformed wire data degrades to "no tool call"."""
    data = extract_json(content)
    if not isinstance(data, dict):
        return []

    def build(name: Any, arguments: Any) -> Optional[ToolCall]:
        if not isinstance(name, str) or not name:
            return None
        if not isinstance(arguments, dict):
            arguments = {}
        return ToolCall(id="tc-0", name=name, arguments=arguments)

    tc = data.get("tool_call")
    action = data.get("action")
    call: Optional[ToolCall] = None
    if isinstance(tc, dict):
        call = build(tc.get("name"), tc.get("arguments"))
    elif isinstance(action, str) and action in tool_names:
        call = build(action, data.get("arguments"))
    return [call] if call is not None else []


def render_chat(messages: Sequence[ChatMessage]) -> str:
    """Canonical plain-text chat transcript."""
    parts: List[str] = []
    for m in messages:
        parts.append(f"<|{m.role}|>\n{m.content}")
    parts.append("<|assistant|>\n")
    return "\n".join(parts)


def tool_preamble(tools: Sequence[ToolSpec]) -> str:
    """The tool-availability header injected for function calling."""
    tool_desc = "\n".join(f"- {t.name}: {t.description}" for t in tools)
    return (
        f"Available tools:\n{tool_desc}\n\n"
        'To invoke one, reply {"tool_call": {"name": ..., '
        '"arguments": {...}}} or {"action": <tool name>, '
        '"arguments": {...}}.'
    )


def render_generic_request(
    messages: Sequence[ChatMessage],
    tools: Optional[Sequence[ToolSpec]] = None,
) -> str:
    """Full request text: tool preamble + chat transcript."""
    prompt = render_chat(messages)
    if tools:
        prompt = f"{tool_preamble(tools)}\n\n{prompt}"
    return prompt
