#!/usr/bin/env python3
"""Where the TTFT of phase 5a's dense llama3-8b wave goes, on the card.

Serves the 8 JSON requests of 64 tokens four times (after one wave that
captures the chunk graphs) and prints, per wave, the TTFT p50 with its
range, the prefill's host span (the device thread's `_dispatch_prefill`,
entry to return) beside its device time (CUDA events around it), how many
prefills ran, and when the reader's first-token fold ended. With `prof`
as the argument the first wave runs under torch.profiler, as
`chip_smoke.py`'s busy-share waves do, to show what the profiler leaves
behind in the process.

    python3 scripts/port_ttft_probe.py; python3 scripts/port_ttft_probe.py prof
"""

from __future__ import annotations

import asyncio
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from pilottai_tpu_torch import LLMConfig, LLMHandler  # noqa: E402
from pilottai_tpu_torch.engine import batcher as bm  # noqa: E402

STAMPS = []


def stamp(name, event=False):
    ev = None
    if event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
    STAMPS.append((name, time.perf_counter(), ev))


def instrument():
    """Stamp the entry and return of the batcher's prefill dispatch (with
    CUDA events), of the reader's first-token fold and of admission
    staging."""
    for meth, label in (("_dispatch_prefill", "prefill"), ("_fold_first_reads", "fold_first"),
                        ("_stage", "stage")):
        orig = getattr(bm.ContinuousBatcher, meth)

        def wrap(self, *a, _orig=orig, _label=label):
            stamp(_label + " start", _label == "prefill")
            out = _orig(self, *a)
            stamp(_label + " end", _label == "prefill")
            return out

        setattr(bm.ContinuousBatcher, meth, wrap)


async def main(prof: bool) -> None:
    handler = LLMHandler(LLMConfig(provider="cuda", model_name="llama3-8b", dtype="bfloat16",
                                   engine_slots=8, engine_admit_batch=8, engine_max_seq=2048,
                                   engine_chunk=16, engine_prefix_cache=0))
    await handler.start()
    reqs = [([smoke.FULL_PROMPT.format(i=i)], 64) for i in range(8)]
    batcher = handler.backend.batcher
    try:
        await smoke.timed_waves(handler, reqs, "first wave", False, 1, profiled=prof)
        for w in range(4):
            STAMPS.clear()
            torch.cuda.synchronize()
            stamp("wave start")
            await smoke.timed_waves(handler, reqs, f"wave {w}", False, 1)
            ttft = sorted(t["ttft_s"] for t in batcher.completed)
            base = STAMPS[0][1]
            pre = [(t, ev) for name, t, ev in STAMPS if name.startswith("prefill")]
            fold = next(t for name, t, _ in STAMPS if name == "fold_first end")
            print(f"prof={prof} wave {w}: ttft p50 {ttft[len(ttft) // 2] * 1e3:.1f} min "
                  f"{ttft[0] * 1e3:.1f} max {ttft[-1] * 1e3:.1f}; prefill host "
                  f"{(pre[0][0] - base) * 1e3:.1f} -> {(pre[1][0] - base) * 1e3:.1f} ms, device "
                  f"{pre[0][1].elapsed_time(pre[1][1]):.1f} ms; prefills {len(pre) // 2}; "
                  f"first fold end {(fold - base) * 1e3:.1f} ms; stage calls "
                  f"{sum(1 for name, _, _ in STAMPS if name == 'stage end')}", flush=True)
    finally:
        await handler.stop()


if __name__ == "__main__":
    instrument()
    asyncio.run(main(len(sys.argv) > 1 and sys.argv[1] == "prof"))
