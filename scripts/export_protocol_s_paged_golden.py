"""Export the JAX engine's greedy ids on the paged KV cache, with chunked
prefill, for the PyTorch port's paged path.

Writes ``pilottai_tpu_torch/assets/protocol_s_paged_golden.json``: the
three golden prompts of ``scripts/export_protocol_s_npz.py``, served by
the JAX engine in float32 on the CPU through ``LLMHandler(provider="cpu")``
with the same engine settings plus a paged pool of 16-token pages and
64-token prefill segments (so each 415-token prompt admits in six
segments), ``json_mode`` on and off. The port must reproduce them token
for token, on the CPU and on the GPU.

Run from the repository root (uses JAX on the CPU)::

    JAX_PLATFORMS=cpu python scripts/export_protocol_s_paged_golden.py
"""

from __future__ import annotations

import asyncio
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from export_protocol_s_npz import (  # noqa: E402  (sets up JAX on the CPU)
    ENGINE,
    MAX_NEW_TOKENS,
    OUT_DIR,
    golden_prompts,
)

from pilottai_tpu.core.config import LLMConfig, SamplingConfig  # noqa: E402
from pilottai_tpu.engine.handler import LLMHandler  # noqa: E402
from pilottai_tpu.engine.types import ChatMessage, ToolSpec  # noqa: E402
from pilottai_tpu.train.protocol import DEFAULT_CHECKPOINT  # noqa: E402

PAGED_GOLDEN_PATH = OUT_DIR / "protocol_s_paged_golden.json"
PAGED_ENGINE = dict(
    ENGINE, engine_paged_kv=True, engine_page_size=16, engine_prefill_chunk=64,
)


async def run_paged_golden(prompts: list, warmup: bool = True) -> list:
    """The JAX engine's cases (prompt ids, token ids, text) for every
    prompt, ``json_mode`` on then off. ``warmup=False`` skips the engine's
    compile warm-up, which changes no output."""
    from pilottai_tpu.engine.batcher import ContinuousBatcher

    real_warmup = ContinuousBatcher.warmup
    if not warmup:
        ContinuousBatcher.warmup = lambda self, *a, **k: None
    try:
        handler = LLMHandler(LLMConfig(
            model_name="protocol-s", provider="cpu",
            checkpoint_path=str(DEFAULT_CHECKPOINT),
            engine_prefix_cache=0, engine_chunk_policy="fixed",
            sampling=SamplingConfig(temperature=0.0, max_new_tokens=MAX_NEW_TOKENS),
            **PAGED_ENGINE,
        ))
        await handler.start()
    finally:
        ContinuousBatcher.warmup = real_warmup
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
    prompts = golden_prompts()
    cases = asyncio.run(run_paged_golden(prompts))
    golden = {
        "model": "protocol-s",
        "source": "JAX engine, LLMHandler(provider='cpu'), float32, greedy, paged KV "
                  "with chunked prefill",
        "engine": PAGED_ENGINE,
        "max_new_tokens": MAX_NEW_TOKENS,
        "prompts": prompts,
        "cases": cases,
    }
    PAGED_GOLDEN_PATH.write_text(json.dumps(golden, indent=1) + "\n")
    for c in cases:
        print(c["prompt"], c["json_mode"], len(c["prompt_ids"]), len(c["token_ids"]),
              repr(c["text"][:80]))
    print(f"wrote {PAGED_GOLDEN_PATH}")


if __name__ == "__main__":
    main()
