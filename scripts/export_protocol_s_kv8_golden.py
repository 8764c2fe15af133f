"""Export the JAX engine's greedy ids with the int8 KV cache, for the
PyTorch port's int8-KV path.

Writes two files under ``pilottai_tpu_torch/assets/``, each the three
golden prompts of ``scripts/export_protocol_s_npz.py`` served by the JAX
engine in float32 on the CPU through ``LLMHandler(provider="cpu")``,
``json_mode`` on and off, with ``engine_kv_quantize="int8"`` and the
engine settings recorded in the file:

* ``protocol_s_kv8_golden.json``: the dense cache;
* ``protocol_s_kv8_paged_golden.json``: the paged cache of 16-token pages
  with 64-token prefill segments.

The port must reproduce them token for token, on the CPU and on the GPU,
also with speculation and the prefix cache on (the JAX engine's greedy ids
do not depend on either).

Run from the repository root (uses JAX on the CPU)::

    JAX_PLATFORMS=cpu python scripts/export_protocol_s_kv8_golden.py
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
from export_protocol_s_paged_golden import PAGED_ENGINE  # noqa: E402
from export_protocol_s_quant_golden import run_cases  # noqa: E402

#: File name -> the engine settings it is served with.
KV8_GOLDEN = {
    "protocol_s_kv8_golden.json": dict(ENGINE, engine_kv_quantize="int8"),
    "protocol_s_kv8_paged_golden.json": dict(PAGED_ENGINE, engine_kv_quantize="int8"),
}


def main() -> None:
    prompts = golden_prompts()
    for name, engine in KV8_GOLDEN.items():
        cases = asyncio.run(run_cases(prompts, engine))
        golden = {
            "model": "protocol-s",
            "source": "JAX engine, LLMHandler(provider='cpu'), float32, greedy, int8 KV cache"
                      + (", paged KV with chunked prefill" if engine.get("engine_paged_kv")
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
