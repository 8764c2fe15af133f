#!/usr/bin/env python3
"""Time two versions of the port's CUDA kernels on one card, in turns.

Builds ``flash_fwd.cu`` and ``decode_attention.cu`` from two source
directories (A, typically the parent commit unpacked with ``git
archive``, and B, the working tree), checks each against the plain
PyTorch versions, and times both at the main path's shapes in the order
A, B, B, A, so drift on the card shows up as A disagreeing with itself.
Times are the median of CUDA-event-timed launches queued back to back
with the L2 cache flushed before each (``chip_smoke.Timer``).

    python3 scripts/port_kernel_ab.py --a .scratch/parent/pilottai_tpu_torch/csrc \\
        --b pilottai_tpu_torch/csrc

Prints one line per (variant, case) and a closing JSON object.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (name, B, T or S, valid or last) at the llama3-8b widths N 32, K 8, H 128.
FLASH_CASES = [("prefill T256 valid 184", 8, 256, 184),
               ("prefill T2048 valid 1983", 8, 2048, 1983)]
DECODE_CASES = [("decode S2048 last 216", 8, 2048, 216),
                ("decode S2048 last 2015", 8, 2048, 2015)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="csrc directory of version A")
    ap.add_argument("--b", required=True, help="csrc directory of version B")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pilottai_tpu_torch.ops.kernels import build
    from pilottai_tpu_torch.ops.kernels import decode_attention as da
    from pilottai_tpu_torch.ops.kernels import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = {}
    for tag, d in (("A", args.a), ("B", args.b)):
        d = Path(d)
        libs[tag] = build.build_sources(
            {name: d / f"{name}.cu" for name in ("flash_fwd", "decode_attention")})
    dev = torch.device("cuda", 0)
    timer = chip_smoke.Timer(torch, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    N, K, H, bf = 32, 8, 128, torch.bfloat16
    inputs = {}
    for name, B, T, n in FLASH_CASES:
        q, k, v = (chip_smoke.randn(torch, gen, (B, T, heads, H), bf, dev) for heads in (N, K, K))
        pos = torch.arange(T, device=dev, dtype=torch.int32)[None].repeat(B, 1)
        val = torch.full((B,), n, device=dev, dtype=torch.int32)
        inputs[name] = ("flash", (q, k, v, pos, pos, val))
    for name, B, S, last in DECODE_CASES:
        q = chip_smoke.randn(torch, gen, (B, N, H), bf, dev)
        kc, vc = (chip_smoke.randn(torch, gen, (B, K, S, H), bf, dev) for _ in range(2))
        lst = torch.full((B,), last, device=dev, dtype=torch.int32)
        inputs[name] = ("decode", (q, kc, vc, lst, lst))

    def run(kind, a):
        if kind == "flash":
            return fa.flash_attention_with_lse(*a)[0]
        return da.decode_attention(*a, return_stats=True)[0]

    def plain(kind, a):
        if kind == "flash":
            return fa.flash_attention_plain(*a)[0]
        return da.decode_attention_plain(*a, H**-0.5)[0]

    results = {}
    for tag in ("A", "B", "B", "A"):
        build.load_library = lambda name, tag=tag: libs[tag][name]
        for name, (kind, a) in inputs.items():
            ref = plain(kind, a).float()
            got = run(kind, a).float()
            scale = ref.abs().amax().clamp_min(1.0) if kind == "decode" else 1.0
            err = ((got - ref).abs().max() / scale).item()
            ms = timer.ms(lambda: run(kind, a), iters=args.iters)
            results.setdefault(f"{tag} {name}", []).append(ms)
            print(f"{tag} {name:<28} {ms:9.4f} ms  err {err:.2e}", flush=True)
    print(json.dumps({"device": smi, "ms": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
