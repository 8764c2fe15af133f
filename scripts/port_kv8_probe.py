"""Where the int8 KV cache's time goes at full width: llama3-8b in bf16 on
one card, 5a's dense wave (8 concurrent JSON requests of ~184 prompt
tokens and 64 new ones, ``chip_smoke.py``'s), served by one engine with
the bf16 cache and one with ``engine_kv_quantize="int8"``, one after the
other. For each: three plain waves (TTFT, TPOT and tokens/s medians), then
one wave under ``torch.profiler``; then the device time of every kernel
name in the two profiled waves side by side, ranked by the difference.

Run from the repository root on a machine with one NVIDIA H100::

    python3 scripts/port_kv8_probe.py [--waves 3] [--top 25]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the smoke's engines, waves and profiling)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_kv8_probe: no CUDA device", file=sys.stderr)
        return 2
    cs.log(cs.nvidia_smi())
    reqs = [([cs.FULL_PROMPT.format(i=i)], 64) for i in range(8)]
    rows = {}

    async def run(label, knobs):
        handler = await cs.full_width_engine(torch, 0, 2048, label, engine_prefix_cache=0,
                                             **knobs)
        waves, _ = await cs.timed_waves(handler, reqs, label, n_waves=args.waves)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            await cs.timed_waves(handler, reqs, f"{label}, profiled", n_waves=1)
            torch.cuda.synchronize()
        rows[label] = {key: (dev, count) for dev, key, count in cs.device_rows(prof)}
        total = sum(d for d, _ in rows[label].values())
        cs.log(f"  {label}: TTFT p50 {cs.median([w['ttft_ms'] for w in waves]):.4f} ms, TPOT p50 "
               f"{cs.median([w['tpot_ms'] for w in waves]):.4f} ms; the profiled wave's device "
               f"time {total / 1e3:.3f} ms over {sum(c for _, c in rows[label].values())} "
               "kernel launches")
        cs.RESIDENT.pop(handler, None)
        await handler.stop()

    cs.arun(run("bf16 cache", {}))
    cs.arun(run("int8 cache", dict(engine_kv_quantize="int8")))
    a, b = rows["bf16 cache"], rows["int8 cache"]
    keys = sorted(set(a) | set(b), key=lambda k: -abs(b.get(k, (0, 0))[0] - a.get(k, (0, 0))[0]))
    cs.log(f"  device time by kernel, the {args.top} largest differences (ms, launches): "
           "bf16 cache | int8 cache | difference")
    for k in keys[: args.top]:
        (da, ca), (db, cb) = a.get(k, (0.0, 0)), b.get(k, (0.0, 0))
        cs.log(f"    {da / 1e3:9.3f} {ca:6d} | {db / 1e3:9.3f} {cb:6d} | {(db - da) / 1e3:+9.3f}  "
               f"{k[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
