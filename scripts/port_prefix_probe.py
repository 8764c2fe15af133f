#!/usr/bin/env python3
"""Where the decode time of ``chip_smoke.py`` phase 5d goes, with the
prefix cache on and off, on the card.

Serves 5d's llama3-8b agent steps (8 concurrent greedy JSON requests of 64
tokens a wave, a 900-byte preamble shared, a task of their own) on one
engine per setting: a cold wave, two plain waves, then one wave under
torch.profiler. Prints per setting the plain waves' TTFT and TPOT p50,
the decode steps the profiled wave dispatched, its device time by kernel
(the top rows and the port's own kernels) and the device time a step.

    python3 scripts/port_prefix_probe.py [dense|paged]
"""

from __future__ import annotations

import asyncio
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from pilottai_tpu_torch import LLMConfig, LLMHandler  # noqa: E402


async def probe(prefix_cache: int, paged: bool) -> None:
    knobs = dict(engine_max_seq=8192) if paged else dict(engine_max_seq=2048)
    handler = LLMHandler(LLMConfig(provider="cuda", model_name="llama3-8b", dtype="bfloat16",
                                   engine_slots=8, engine_admit_batch=8, engine_chunk=16,
                                   engine_prefix_cache=prefix_cache, **knobs))
    await handler.start()
    batcher = handler.backend.batcher
    try:
        await smoke.agent_wave(handler, smoke.agent_step_prompts(ROOT, 0))
        for w in (1, 2):
            wave = await smoke.agent_wave(handler, smoke.agent_step_prompts(ROOT, w))
            print(f"  plain wave {w}: ttft_ms {wave['ttft_ms']:.3f}, tpot_ms "
                  f"{wave['tpot_ms']:.3f}, prefix {batcher.prefix_report() or 'off'}", flush=True)
        await smoke.settle(batcher)
        steps0 = batcher.blocks_dispatched
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wave = await smoke.agent_wave(handler, smoke.agent_step_prompts(ROOT, 3))
            await smoke.settle(batcher)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        steps = batcher.blocks_dispatched - steps0
        rows = smoke.device_rows(prof)
        print(f"  profiled wave: ttft_ms {wave['ttft_ms']:.3f}, tpot_ms {wave['tpot_ms']:.3f}, "
              f"{steps} decode steps dispatched", flush=True)
        smoke.report_profile(prof, wall * 1e6, f"wave, engine_prefix_cache={prefix_cache}",
                             top=14)
        total = sum(r[0] for r in rows)
        print(f"  device time {total / 1e3:.2f} ms over the wave, "
              f"{total / 1e3 / max(steps, 1):.3f} ms a dispatched step (prefill included)",
              flush=True)
    finally:
        await handler.stop()


def main() -> int:
    if not torch.cuda.is_available():
        print("port_prefix_probe: no CUDA device", file=sys.stderr)
        return 2
    paged = len(sys.argv) > 1 and sys.argv[1] == "paged"
    print(smoke.nvidia_smi(), flush=True)
    for prefix_cache in (4, 0):
        print(f"== {'paged' if paged else 'dense'}, engine_prefix_cache={prefix_cache}",
              flush=True)
        asyncio.run(probe(prefix_cache, paged))
    return 0


if __name__ == "__main__":
    sys.exit(main())
