"""One structured logging bus for the port (its copy of the console half of
``pilottai_tpu/utils/logging.py``, rooted at the ``pilottai_tpu_torch``
logger, with ``LogConfig`` from the port's ``core/config.py``).

Every component logs through ``get_logger``: JSON lines carrying the
component and, inside a span, its trace id. Importing a module configures
nothing; ``setup_logging`` installs the console handler once, and the
engine's entry points (``ContinuousBatcher``, ``LLMHandler``) call it when
they are built, as the JAX package's first ``get_logger`` does. The file
handlers come with ``ServeConfig.log`` (``LogConfig.log_to_file`` is
refused until then).
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, Optional

from pilottai_tpu_torch.core.config import LogConfig

_ROOT_NAME = "pilottai_tpu_torch"
_configured = False


class JsonFormatter(logging.Formatter):
    """Structured JSON log lines with component/agent/task context fields.

    Reference: ``pilott/utils/logger.py:34-64``.
    """

    def format(self, record: logging.LogRecord) -> str:
        payload: Dict[str, Any] = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        for key in ("agent_id", "task_id", "span_id", "trace_id", "component"):
            value = getattr(record, key, None)
            if value is not None:
                payload[key] = value
        if "trace_id" not in payload:
            # Correlate with the request's span tree: a log line emitted
            # inside an active span carries that span's trace id. Lazy
            # import: logging must never create a cycle.
            try:
                from pilottai_tpu_torch.utils.tracing import global_tracer

                span = global_tracer.current()
                if span is not None:
                    payload["trace_id"] = span.trace_id
            except Exception:  # pragma: no cover — logging must not raise
                pass
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload, default=str)


def setup_logging(config: Optional[LogConfig] = None) -> None:
    """Configure the port's root logger: one console handler, JSON lines
    unless ``config.json_format`` is off. An explicit config always
    rebuilds the handler; with no config the call is idempotent."""
    global _configured
    root = logging.getLogger(_ROOT_NAME)
    if _configured and config is None:
        return
    config = config or LogConfig()
    for handler in list(root.handlers):
        root.removeHandler(handler)
        handler.close()
    root.setLevel(config.level)
    root.propagate = False
    console = logging.StreamHandler()
    console.setFormatter(
        JsonFormatter()
        if config.json_format
        else logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
    )
    root.addHandler(console)
    _configured = True


# Logger.makeRecord rejects ANY extra key already present on LogRecord, so
# derive the reserved set from a real record rather than hand-listing.
_RESERVED_KEYS = set(logging.makeLogRecord({}).__dict__) | {"message", "asctime"}


def get_logger(component: str, **context: Any) -> logging.LoggerAdapter:
    """Component logger carrying structured context (agent_id, task_id...).
    Configures nothing (see ``setup_logging``).

    Context keys colliding with LogRecord internals are prefixed rather
    than raising KeyError at log time.
    """
    logger = logging.getLogger(f"{_ROOT_NAME}.{component}")
    safe = {
        (f"ctx_{k}" if k in _RESERVED_KEYS else k): v for k, v in context.items()
    }
    return logging.LoggerAdapter(logger, {"component": component, **safe})
