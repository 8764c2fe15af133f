"""The part of the task model the training curriculum renders (the port's
copy of ``pilottai_tpu/core/task.py``): ``TaskPriority`` and a ``Task``
with the fields ``train/protocol.py`` sets and ``to_prompt``, whose text
must equal the JAX package's byte for byte (the protocol model learns
from it). The lifecycle, retries, deadlines and resource handling come
with ROADMAP item P8.
"""

from __future__ import annotations

import enum
import uuid
from typing import Any, Dict, List

from pydantic import BaseModel, Field, field_validator


class TaskPriority(enum.IntEnum):
    """Numeric task priority — higher is more urgent."""

    LOW = 0
    NORMAL = 1
    HIGH = 2
    CRITICAL = 3

    @classmethod
    def coerce(cls, value: Any) -> "TaskPriority":
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            try:
                return cls[value.upper()]
            except KeyError:
                raise ValueError(
                    f"unknown priority {value!r}; expected one of "
                    f"{[m.name.lower() for m in cls]}"
                ) from None
        return cls(int(value))


class Task(BaseModel):
    """A unit of work, as far as a prompt shows it."""

    id: str = Field(default_factory=lambda: str(uuid.uuid4()))
    type: str = "generic"
    description: str
    priority: TaskPriority = TaskPriority.NORMAL
    required_capabilities: List[str] = Field(default_factory=list)
    required_skills: List[str] = Field(default_factory=list)
    tools: List[str] = Field(default_factory=list)
    context: Dict[str, Any] = Field(default_factory=dict)
    payload: Dict[str, Any] = Field(default_factory=dict)

    @field_validator("priority", mode="before")
    @classmethod
    def _coerce_priority(cls, v: Any) -> TaskPriority:
        return TaskPriority.coerce(v)

    def to_prompt(self) -> str:
        """Render the task as context for an LLM prompt."""
        lines = [
            f"Task ID: {self.id}",
            f"Type: {self.type}",
            f"Description: {self.description}",
            f"Priority: {self.priority.name}",
        ]
        if self.required_capabilities:
            lines.append("Required capabilities: " + ", ".join(self.required_capabilities))
        if self.required_skills:
            lines.append("Required skills: " + ", ".join(self.required_skills))
        if self.tools:
            lines.append("Available tools: " + ", ".join(self.tools))
        if self.payload:
            lines.append(f"Payload: {self.payload}")
        if self.context:
            lines.append(f"Context: {self.context}")
        return "\n".join(lines)
