"""Export the JAX engine's greedy ids with weight-only quantization, for
the PyTorch port's quantized path.

Writes three files under ``pilottai_tpu_torch/assets/``, each the three
golden prompts of ``scripts/export_protocol_s_npz.py`` served by the JAX
engine in float32 on the CPU through ``LLMHandler(provider="cpu")``,
``json_mode`` on and off, with the engine settings recorded in the file:

* ``protocol_s_int8_golden.json``: ``engine_quant="int8"``, dense cache;
* ``protocol_s_int4_golden.json``: ``engine_quant="int4"`` at the JAX
  default group of 128, dense cache;
* ``protocol_s_int4_paged_golden.json``: ``engine_quant="int4"`` at group
  96 (a short last group on every contraction), paged cache of 16-token
  pages with 64-token prefill segments.

The port must reproduce them token for token, on the CPU and on the GPU.

``--native`` writes four other files instead, the same served with
``PILOTTAI_QMATMUL=native`` (the integer-operand arm: activations quantized
per row to int8, int32 sums, the scales after), and leaves the three above
as they are:

* ``protocol_s_int8_native_golden.json``: int8, dense cache;
* ``protocol_s_int4_native_golden.json``: int4 at group 128, dense cache;
* ``protocol_s_int4_native_paged_golden.json``: int4 at group 96, paged
  cache of 16-token pages with 64-token prefill segments;
* ``protocol_s_int4_native_spec_golden.json``: int4 at group 128, dense
  cache, ``engine_speculate=4``.

Run from the repository root (uses JAX on the CPU)::

    JAX_PLATFORMS=cpu python scripts/export_protocol_s_quant_golden.py [--native]
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from export_protocol_s_npz import (  # noqa: E402  (sets up JAX on the CPU)
    ENGINE,
    MAX_NEW_TOKENS,
    OUT_DIR,
    golden_prompts,
)
from export_protocol_s_paged_golden import PAGED_ENGINE  # noqa: E402

from pilottai_tpu.core.config import LLMConfig, SamplingConfig  # noqa: E402
from pilottai_tpu.engine.handler import LLMHandler  # noqa: E402
from pilottai_tpu.engine.types import ChatMessage, ToolSpec  # noqa: E402
from pilottai_tpu.train.protocol import DEFAULT_CHECKPOINT  # noqa: E402

#: File name -> the engine settings it is served with.
QUANT_GOLDEN = {
    "protocol_s_int8_golden.json": dict(ENGINE, engine_quant="int8"),
    "protocol_s_int4_golden.json": dict(ENGINE, engine_quant="int4", engine_quant_group=128),
    "protocol_s_int4_paged_golden.json": dict(PAGED_ENGINE, engine_quant="int4",
                                              engine_quant_group=96),
}

#: The integer-operand arm's files (``--native``).
NATIVE_GOLDEN = {
    "protocol_s_int8_native_golden.json": dict(ENGINE, engine_quant="int8"),
    "protocol_s_int4_native_golden.json": dict(ENGINE, engine_quant="int4",
                                               engine_quant_group=128),
    "protocol_s_int4_native_paged_golden.json": dict(PAGED_ENGINE, engine_quant="int4",
                                                     engine_quant_group=96),
    "protocol_s_int4_native_spec_golden.json": dict(ENGINE, engine_quant="int4",
                                                    engine_quant_group=128, engine_speculate=4),
}


async def run_cases(prompts: list, engine: dict) -> list:
    """The JAX engine's cases (prompt ids, token ids, text) for every
    prompt, ``json_mode`` on then off, with the prefix cache off and fixed
    chunks."""
    handler = LLMHandler(LLMConfig(
        model_name="protocol-s", provider="cpu",
        checkpoint_path=str(DEFAULT_CHECKPOINT),
        engine_prefix_cache=0, engine_chunk_policy="fixed",
        sampling=SamplingConfig(temperature=0.0, max_new_tokens=MAX_NEW_TOKENS),
        **engine,
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
    native = "--native" in sys.argv[1:]
    if native:
        os.environ["PILOTTAI_QMATMUL"] = "native"
    prompts = golden_prompts()
    for name, engine in (NATIVE_GOLDEN if native else QUANT_GOLDEN).items():
        cases = asyncio.run(run_cases(prompts, engine))
        golden = {
            "model": "protocol-s",
            "source": f"JAX engine, LLMHandler(provider='cpu'), float32, greedy, weight-only "
                      f"{engine['engine_quant']}"
                      + (", paged KV with chunked prefill" if engine.get("engine_paged_kv")
                         else "")
                      + (", engine_speculate=4" if engine.get("engine_speculate") else "")
                      + (", PILOTTAI_QMATMUL=native (the integer-operand arm)" if native
                         else ""),
            "engine": engine,
            "max_new_tokens": MAX_NEW_TOKENS,
            "prompts": prompts,
            "cases": cases,
        }
        path = OUT_DIR / name
        path.write_text(json.dumps(golden, indent=1) + "\n")
        for c in cases:
            print(c["prompt"], c["json_mode"], len(c["prompt_ids"]), len(c["token_ids"]),
                  repr(c["text"][:80]))
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
