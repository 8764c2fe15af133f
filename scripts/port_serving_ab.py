#!/usr/bin/env python3
"""Time two trees of the port's serving engine on one card, in turns.

Serves ``chip_smoke.py``'s two llama3-8b workloads through tree A
(typically the parent commit, unpacked with ``git archive``) and tree B
(the working tree): 5a, the dense cache, 8 concurrent JSON requests of
~184 prompt tokens and 64 new; 5b, the paged cache (``engine_max_seq``
8192), one ~6050-token prompt (1024-token segments) ahead of seven short
ones. Each tree runs in a process of its own that imports only that
tree's package, at that tree's default engine settings, in the order A,
B, B, A, so drift on the card shows up as A disagreeing with itself, with
the prefix cache off (the waves repeat their prompts). A
run starts the engine (random bf16 weights from ``--seed``), serves one
warm-up wave (kernel builds, graph captures, the allocator), then
``--waves`` plain waves (``chip_smoke.timed_waves``): TTFT p50, TPOT p50
and decode tokens/s per wave, with the median and the spread. Then, on
fresh engines, as many waves under torch.profiler for the device's busy
share (after every plain wave: the profiler leaves the process's
launches slower on the host).

    mkdir -p .scratch/parent && git archive HEAD | tar -x -C .scratch/parent
    python3 scripts/port_serving_ab.py --a .scratch/parent --b .

Each run's full log goes to ``chiprun_out/serving_ab/``; the script
prints the per-run medians and a closing JSON object.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out" / "serving_ab"
METRICS = ("ttft_ms", "ttft_long_ms", "tpot_ms", "tokens_s", "busy")


def _smoke():
    """This tree's ``chip_smoke.py`` for its workload and wave helpers; its
    functions import ``pilottai_tpu_torch`` when called, which resolves to
    the tree at the head of ``sys.path``."""
    spec = importlib.util.spec_from_file_location("_serving_ab_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: Path, seed: int, waves: int) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import pilottai_tpu_torch
    from pilottai_tpu_torch import LLMConfig, LLMHandler
    from pilottai_tpu_torch.ops.kernels import build

    if Path(pilottai_tpu_torch.__file__).resolve().parent != (tree / "pilottai_tpu_torch").resolve():
        raise SystemExit(f"imported {pilottai_tpu_torch.__file__}, not the tree {tree}")
    smoke = _smoke()
    build.build_libraries(["flash_fwd", "decode_attention", "paged_attention"])
    workloads = {
        "dense": (dict(engine_max_seq=2048), [[smoke.FULL_PROMPT.format(i=i)] for i in range(8)],
                  False),
        "paged": (dict(engine_max_seq=8192),
                  [[smoke.long_prompt(5900)]] + [[smoke.FULL_PROMPT.format(i=i)]
                                                 for i in range(7)], True),
    }
    out = {"tree": str(tree)}
    # Every plain wave before the first profiled one: once the profiler has
    # traced the card, the process's launches stay slower on the host.
    for profiled in (False, True):
        for name, (knobs, prompts, long_first) in workloads.items():
            async def run():
                # The prefix cache off (every tree takes 0): the waves repeat
                # their prompts, which would turn them into cache hits.
                handler = LLMHandler(LLMConfig(provider="cuda", model_name="llama3-8b",
                                               dtype="bfloat16", engine_slots=8,
                                               engine_admit_batch=8, engine_chunk=16,
                                               seed=seed, engine_prefix_cache=0, **knobs))
                await handler.start()
                try:
                    reqs = [(p, 64) for p in prompts]
                    await smoke.timed_waves(handler, reqs, f"{name} warm-up", long_first, 1)
                    result, _ = await smoke.timed_waves(handler, reqs, name, long_first, waves,
                                                        profiled=profiled)
                    batcher = handler.backend.batcher
                    graphs = (batcher.graph_report() if hasattr(batcher, "graph_report")
                              else None)
                    return result, graphs
                finally:
                    await handler.stop()

            waves_out, graphs = asyncio.run(run())
            entry = out.setdefault(name, {})
            entry["profiled" if profiled else "waves"] = waves_out
            if not profiled:
                entry["graphs"] = graphs
            gc.collect()
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", type=Path, help="tree A (a checkout's root)")
    ap.add_argument("--b", type=Path, help="tree B (a checkout's root)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--waves", type=int, default=5)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        result = worker(args.worker, args.seed, args.waves)
        print("RESULT " + json.dumps(result), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, (tag, tree) in enumerate((("A", args.a), ("B", args.b), ("B", args.b),
                                     ("A", args.a))):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", str(tree.resolve()),
             "--seed", str(args.seed), "--waves", str(args.waves)],
            capture_output=True, text=True, timeout=1500,
        )
        log = OUT / f"run{i + 1}_{tag}.log"
        log.write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        if proc.returncode != 0:
            print(proc.stdout[-3000:] + proc.stderr[-3000:], flush=True)
            raise SystemExit(f"run {i + 1} ({tag}) failed; see {log}")
        result = json.loads(next(line for line in proc.stdout.splitlines()
                                 if line.startswith("RESULT "))[7:])
        result["tag"] = tag
        runs.append(result)
        for name in ("dense", "paged"):
            text = []
            for key in METRICS:
                waves = result[name]["profiled" if key == "busy" else "waves"]
                vals = sorted(w[key] for w in waves if w[key] is not None)
                if vals:
                    text.append(f"{key} {vals[len(vals) // 2]:.4f} [{vals[0]:.4f}, "
                                f"{vals[-1]:.4f}]")
            print(f"run {i + 1} {tag} {name}: " + "; ".join(text)
                  + f"; graphs {result[name]['graphs']}", flush=True)
        print(f"run {i + 1} took {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"card": smi, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
