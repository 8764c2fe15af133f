"""Tolerant JSON extraction from model output (the port's copy of the
part of ``pilottai_tpu/utils/json_utils.py`` that tool-call parsing uses).

Order: whole text → fenced blocks → balanced brace spans (longest
first); a real brace scanner instead of regex recursion.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional

_FENCE_RE = re.compile(r"```(?:json)?\s*(.*?)```", re.DOTALL)


def _balanced_spans(text: str) -> List[str]:
    """All top-level {...} spans, found by brace scanning (string-aware)."""
    spans: List[str] = []
    depth = 0
    start = -1
    in_string = False
    escape = False
    for i, ch in enumerate(text):
        if in_string:
            if escape:
                escape = False
            elif ch == "\\":
                escape = True
            elif ch == '"':
                in_string = False
            continue
        if ch == '"':
            if depth > 0:
                in_string = True
            continue
        if ch == "{":
            if depth == 0:
                start = i
            depth += 1
        elif ch == "}":
            if depth > 0:
                depth -= 1
                if depth == 0 and start >= 0:
                    spans.append(text[start : i + 1])
                    start = -1
    return spans


def extract_json(text: str) -> Optional[Dict[str, Any]]:
    """Best-effort: parse ``text`` as a JSON object; None when nothing
    parses."""
    if not text:
        return None
    candidates: List[str] = [text.strip()]
    candidates += [m.strip() for m in _FENCE_RE.findall(text)]
    candidates += sorted(_balanced_spans(text), key=len, reverse=True)
    for candidate in candidates:
        try:
            obj = json.loads(candidate)
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict):
            return obj
    return None
