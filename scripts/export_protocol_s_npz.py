"""Export the committed protocol-s checkpoint for the PyTorch port.

The port (``pilottai_tpu_torch``) runs where there is no JAX and no
orbax, so this script converts the orbax tree under
``pilottai_tpu/assets/protocol-s`` once, here, into two files the port
ships with:

* ``pilottai_tpu_torch/assets/protocol_s.npz`` — every parameter leaf
  under its ``/``-joined tree path (``layers/attn/wq`` …). The leaves
  are bfloat16 in the checkpoint; numpy has no bfloat16, so they are
  stored as their raw ``uint16`` bit patterns (``models/loader.py`` in
  the port widens them to float32 exactly).
* ``pilottai_tpu_torch/assets/protocol_s_golden.json`` — the JAX
  engine's greedy token ids for a few fixed agent-protocol prompts,
  served in float32 on the CPU through ``LLMHandler(provider="cpu")``,
  with ``json_mode`` on and off. The port must reproduce them token for
  token.

Run from the repository root (uses JAX on the CPU)::

    JAX_PLATFORMS=cpu python scripts/export_protocol_s_npz.py
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from pilottai_tpu.core.config import LLMConfig, SamplingConfig  # noqa: E402
from pilottai_tpu.engine.handler import LLMHandler  # noqa: E402
from pilottai_tpu.engine.types import ChatMessage, ToolSpec  # noqa: E402
from pilottai_tpu.models.loader import restore_params  # noqa: E402
from pilottai_tpu.prompts.manager import PromptManager  # noqa: E402
from pilottai_tpu.train.protocol import (  # noqa: E402
    DEFAULT_CHECKPOINT,
    _agent_messages,
    _Rand,
    _task,
)

OUT_DIR = ROOT / "pilottai_tpu_torch" / "assets"
NPZ_PATH = OUT_DIR / "protocol_s.npz"
GOLDEN_PATH = OUT_DIR / "protocol_s_golden.json"

# Serving shape of the golden run. The port's golden check replays it
# with the same values (prompts longer than the keep window
# max_seq - 1 - max_new_tokens are left-truncated identically).
ENGINE = {
    "engine_max_seq": 512,
    "engine_slots": 4,
    "engine_admit_batch": 4,
    "engine_chunk": 16,
    "dtype": "float32",
}
MAX_NEW_TOKENS = 96


def flatten_params(tree) -> dict:
    """``{"layers/attn/wq": array, ...}`` with bfloat16 leaves as their
    uint16 bit patterns."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(p.key) for p in path)
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            arr = arr.view(np.uint16)
        flat[key] = arr
    return flat


def golden_prompts() -> list:
    """Three agent-protocol requests drawn from the protocol curriculum's
    own generators: an agent task analysis, an agent step plan with
    tools, and an orchestrator decomposition."""
    agent_pm = PromptManager("agent")
    orch_pm = PromptManager("orchestrator")
    r = _Rand(2026)
    out = []

    task, _ = _task(r, with_tools=False)
    msgs = _agent_messages(
        r, agent_pm, agent_pm.format_prompt("task_analysis", task=task.to_prompt())
    )
    out.append({"messages": [m.model_dump(include={"role", "content"}) for m in msgs],
                "tools": None})

    task, tools = _task(r, with_tools=True)
    msgs = _agent_messages(
        r, agent_pm,
        agent_pm.format_prompt(
            "step_planning", task=task.to_prompt(), history="none yet"
        ),
    )
    out.append({"messages": [m.model_dump(include={"role", "content"}) for m in msgs],
                "tools": [{"name": n, "description": d} for n, d in tools]})

    task, _ = _task(r, with_tools=False)
    prompt = orch_pm.format_prompt("task_decomposition", task=task.to_prompt())
    out.append({"messages": [{"role": "user", "content": prompt}], "tools": None})
    return out


async def run_golden(prompts: list) -> list:
    handler = LLMHandler(LLMConfig(
        model_name="protocol-s", provider="cpu",
        checkpoint_path=str(DEFAULT_CHECKPOINT),
        engine_prefix_cache=0, engine_chunk_policy="fixed",
        sampling=SamplingConfig(temperature=0.0, max_new_tokens=MAX_NEW_TOKENS),
        **ENGINE,
    ))
    await handler.start()
    batcher = handler.backend.batcher
    submitted = []
    submit = batcher.submit

    def recording_submit(request):
        submitted.append(request)
        return submit(request)

    batcher.submit = recording_submit
    cases = []
    try:
        for json_mode in (True, False):
            for i, p in enumerate(prompts):
                submitted.clear()
                resp = await handler.generate_response(
                    [ChatMessage(**m) for m in p["messages"]],
                    tools=[ToolSpec(**t) for t in p["tools"]] if p["tools"] else None,
                    json_mode=json_mode,
                )
                (request,) = submitted
                cases.append({
                    "prompt": i,
                    "json_mode": json_mode,
                    "prompt_ids": list(request.prompt_ids),
                    "token_ids": [int(t) for t in request.future.result()],
                    "text": resp.content,
                })
    finally:
        await handler.stop()
    return cases


def main() -> None:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    flat = flatten_params(restore_params(DEFAULT_CHECKPOINT))
    np.savez_compressed(NPZ_PATH, **flat)
    print(f"wrote {NPZ_PATH} ({NPZ_PATH.stat().st_size} bytes, {len(flat)} leaves)")

    prompts = golden_prompts()
    cases = asyncio.run(run_golden(prompts))
    golden = {
        "model": "protocol-s",
        "source": "JAX engine, LLMHandler(provider='cpu'), float32, greedy",
        "engine": ENGINE,
        "max_new_tokens": MAX_NEW_TOKENS,
        "prompts": prompts,
        "cases": cases,
    }
    GOLDEN_PATH.write_text(json.dumps(golden, indent=1) + "\n")
    for c in cases:
        print(c["prompt"], c["json_mode"], len(c["prompt_ids"]), len(c["token_ids"]),
              repr(c["text"][:80]))
    print(f"wrote {GOLDEN_PATH}")


if __name__ == "__main__":
    main()
