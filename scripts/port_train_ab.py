#!/usr/bin/env python3
"""Time two trees of the port's trainer on one card, in turns.

Takes ``chip_smoke.py`` phase 7b's step through tree A (typically the
parent commit, unpacked with ``git archive``) and tree B (the working
tree): llama3-1b, bf16 compute over fp32 master weights, remat on, one
fixed ``synthetic_batches(cfg, 4, 2048)`` batch. Each tree runs in a
process of its own that imports only that tree's package, in the order A,
B, B, A, so drift on the card shows up as A disagreeing with itself. A
run builds the three training kernels (K1, K4, K5), takes one warm-up
step and ``--steps`` timed steps (host clock around each, ending in a
synchronize), then one step under torch.profiler: the step time p50, its
spread, the peak memory, the loss after the last step and the profiled
step's GEMM kernels by device time (the logits head's among them).

    mkdir -p .scratch/parent && git archive HEAD | tar -x -C .scratch/parent
    python3 scripts/port_train_ab.py --a .scratch/parent --b .

Each run's full log goes to ``chiprun_out/train_ab/``; the script prints
the per-run numbers and a closing JSON object.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out" / "train_ab"


def worker(tree: Path, seed: int, steps: int) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import pilottai_tpu_torch
    from pilottai_tpu_torch.models.registry import get_model_config
    from pilottai_tpu_torch.ops.kernels import build
    from pilottai_tpu_torch.train.trainer import TrainConfig, Trainer, synthetic_batches

    package = Path(pilottai_tpu_torch.__file__).resolve().parent
    if package != (tree / "pilottai_tpu_torch").resolve():
        raise SystemExit(f"imported {pilottai_tpu_torch.__file__}, not the tree {tree}")
    build.build_libraries(["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
    cfg = get_model_config("llama3-1b")
    trainer = Trainer(cfg, TrainConfig(learning_rate=3e-4, warmup_steps=2,
                                       total_steps=steps + 2, remat=True))
    gen = torch.Generator(device=trainer.device)
    gen.manual_seed(seed)
    state = trainer.init(gen)
    batch = next(synthetic_batches(cfg, 4, 2048, seed=seed))
    state, _ = trainer.step(state, batch)          # warm-up: builds, cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    loss = float(metrics["loss"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = trainer.step(state, batch)
        torch.cuda.synchronize()
    gemms = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", DeviceType.CUDA) == DeviceType.CPU:
            continue
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = getattr(evt, "self_cuda_time_total", 0.0)
        if dev > 0 and any(n in evt.key.lower() for n in ("gemm", "nvjet", "cutlass")):
            gemms.append((dev / 1e3, evt.count, evt.key[:110]))
    gemms.sort(reverse=True)
    ordered = sorted(times)
    return {"tree": str(tree), "step_ms": times, "p50_ms": ordered[len(ordered) // 2],
            "min_ms": ordered[0], "max_ms": ordered[-1], "peak_gib": peak, "loss": loss,
            "gemms": gemms[:8]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", type=Path, help="tree A (a checkout's root)")
    ap.add_argument("--b", type=Path, help="tree B (a checkout's root)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        result = worker(args.worker, args.seed, args.steps)
        print("RESULT " + json.dumps(result), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, (tag, tree) in enumerate((("A", args.a), ("B", args.b), ("B", args.b),
                                     ("A", args.a))):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", str(tree.resolve()),
             "--seed", str(args.seed), "--steps", str(args.steps)],
            capture_output=True, text=True, timeout=1200,
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
        print(f"run {i + 1} {tag}: step p50 {result['p50_ms']:.1f} ms [{result['min_ms']:.1f}, "
              f"{result['max_ms']:.1f}], peak {result['peak_gib']:.2f} GiB, loss "
              f"{result['loss']:.5f}", flush=True)
        for ms, count, key in result["gemms"]:
            print(f"    {ms:9.2f} ms {count:5d} x {key}", flush=True)
    print(json.dumps({"card": smi, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
