"""Prompt template loading, placeholder validation and formatting (the
port's copy of ``pilottai_tpu/prompts/manager.py``).

The rules come as ``rules.json``, a JSON copy of the JAX package's
``prompts/rules.yaml`` (the machine with the card is not promised pyyaml);
``tests/test_torch_protocol.py`` holds the copy equal to the YAML. One
class serves both namespaces, "agent" and "orchestrator".
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, Optional, Set

_DEFAULT_RULES = Path(__file__).with_name("rules.json")

# A placeholder is {name}; literal braces are doubled ({{ }}), matching
# str.format semantics (the JSON examples in the templates use {{ }}).
_PLACEHOLDER_RE = re.compile(r"(?<!\{)\{([a-zA-Z_][a-zA-Z0-9_]*)\}(?!\})")
# Single-pass substitution token: doubled brace OR placeholder. One regex
# pass over the template only, so placeholder-like text *inside substituted
# values* is never re-scanned (no cross-kwarg injection).
_SUBST_RE = re.compile(r"\{\{|\}\}|(?<!\{)\{([a-zA-Z_][a-zA-Z0-9_]*)\}(?!\})")


class PromptError(Exception):
    pass


class PromptManager:
    """Loads a namespace ("agent" or "orchestrator") of prompt templates."""

    def __init__(
        self,
        namespace: str = "agent",
        rules_path: Optional[str | Path] = None,
        overrides: Optional[Dict[str, str]] = None,
    ) -> None:
        self.namespace = namespace
        path = Path(rules_path) if rules_path else _DEFAULT_RULES
        rules = json.loads(path.read_text(encoding="utf-8"))
        if namespace not in rules:
            raise PromptError(f"namespace {namespace!r} not found in {path}")
        self._templates: Dict[str, Any] = rules[namespace]
        if overrides:
            self._templates.update(overrides)

    def _lookup(self, prompt_type: str) -> str:
        node: Any = self._templates
        for part in prompt_type.split("."):
            if not isinstance(node, dict) or part not in node:
                raise PromptError(
                    f"unknown prompt {prompt_type!r} in namespace {self.namespace!r}"
                )
            node = node[part]
        if not isinstance(node, str):
            raise PromptError(f"prompt {prompt_type!r} is not a template leaf")
        return node

    @staticmethod
    def placeholders(template: str) -> Set[str]:
        return set(_PLACEHOLDER_RE.findall(template))

    def format_prompt(self, prompt_type: str, **kwargs: Any) -> str:
        """Validate kwargs against the template's placeholders, then format;
        missing parameters raise, extra ones are ignored."""
        template = self._lookup(prompt_type)
        missing = self.placeholders(template) - set(kwargs)
        if missing:
            raise PromptError(
                f"prompt {prompt_type!r} missing parameters: {sorted(missing)}"
            )

        def _sub(match: "re.Match[str]") -> str:
            token = match.group(0)
            if token == "{{":
                return "{"
            if token == "}}":
                return "}"
            return str(kwargs[match.group(1)])

        return _SUBST_RE.sub(_sub, template)

    def available(self) -> Dict[str, Any]:
        return dict(self._templates)
