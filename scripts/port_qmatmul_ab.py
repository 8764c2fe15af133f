#!/usr/bin/env python3
"""Time two versions of the port's quantized product on one card, in turns.

Builds ``csrc/qmatmul.cu`` from two source trees (A, typically the parent
commit unpacked with ``git archive``, and B, the working tree), binds each
with its own tree's wrapper (``ops/kernels/qmatmul.py``), checks each
against ``qmatmul_plain`` (``chip_smoke.TOL_QMM``), and times both in the
order A, B, B, A at llama3-8b's four matrix shapes (wq and wo, wk and wv,
wg and wu, wd), int8 and int4 at group 128, at 8 rows (a decode step), 32
(a verify block of 4) and 2048 (the admission's prefill in
``chip_smoke.py`` 5f), beside ``torch.matmul`` on a dense bf16 weight of
the same shape. Two times each: the median of 20 CUDA-event-timed launches
with the L2 cache flushed before each (``chip_smoke.Timer``, whose 1 GiB
flush leaves L2 full of dirty lines that a launch then writes back), and
the streaming time, as a decode step meets its weights: one CUDA graph of
launches over copies of the weight that together pass 200 MB, so none is
in L2, replayed three times between two events, per launch (the graph
takes the host's per-call cost out, as the decode chunk's graph does). The bound is the
weight, activation and result bytes over 3.35e12 B/s or the products over
989e12 FLOP/s, the larger.

    git archive HEAD pilottai_tpu_torch | tar -x -C .scratch/parent
    python3 scripts/port_qmatmul_ab.py --a .scratch/parent/pilottai_tpu_torch \\
        --b pilottai_tpu_torch

Prints one line per (variant, case) and a closing JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = ((4096, 4096, "wq, wo"), (4096, 1024, "wk, wv"), (4096, 14336, "wg, wu"),
          (14336, 4096, "wd"))
MODES = (("int8", 8, 128), ("int4 g128", 4, 128))
ROWS = (8, 32, 2048)
STREAM_BYTES = 200e6  # the copies' bytes in a streaming run: four times L2


def stream_ms(torch, fn, copies, reps=3):
    """Per-launch ms of ``fn(copy)`` over ``copies``, captured as one CUDA
    graph and replayed ``reps`` times after one warm-up replay."""
    fn(copies[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in copies:
            fn(c)
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    graph.reset()
    return start.elapsed_time(end) / (reps * len(copies))


def load_wrapper(pkg: Path, tag: str):
    """The tree's ``ops/kernels/qmatmul.py`` under a private module name."""
    spec = importlib.util.spec_from_file_location(f"_qab_{tag}",
                                                  pkg / "ops" / "kernels" / "qmatmul.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="pilottai_tpu_torch directory of version A")
    ap.add_argument("--b", required=True, help="pilottai_tpu_torch directory of version B")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_qmatmul_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pilottai_tpu_torch.models.quant import quantize_array
    from pilottai_tpu_torch.ops.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {tag: build.build_sources({"qmatmul": Path(d) / "csrc" / "qmatmul.cu"})["qmatmul"]
            for tag, d in (("A", args.a), ("B", args.b))}
    wrappers = {tag: load_wrapper(Path(d), tag) for tag, d in (("A", args.a), ("B", args.b))}
    dev = torch.device("cuda", 0)
    timer = chip_smoke.Timer(torch, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf = torch.bfloat16
    results = []
    for K, N, names in SHAPES:
        w = torch.randn((K, N), generator=gen, device=dev) * K**-0.5
        dense = w.to(bf)
        dense_copies = [dense.clone() for _ in range(max(2, -(-int(STREAM_BYTES) // (2 * K * N))))]
        for mode, bits, group in MODES:
            qw = quantize_array(w, bf, bits=bits, group=group)
            q_bytes = qw.q.numel() + 2 * qw.s.numel()
            copies = [type(qw)(**{**vars(qw), "q": qw.q.clone(), "s": qw.s.clone()})
                      for _ in range(max(2, -(-int(STREAM_BYTES) // q_bytes)))]
            for M in ROWS:
                x = chip_smoke.randn(torch, gen, (M, K), bf, dev)
                want = wrappers["B"].qmatmul_plain(x, qw)
                row = {"shape": f"{names} [{K}x{N}]", "quant": mode, "rows": M}
                for tag in ("A", "B", "B", "A"):
                    build.load_library = lambda name, tag=tag: libs[tag]
                    mod = wrappers[tag]
                    got = mod.quant_matmul(x, qw)
                    d = (got.float() - want.float()).abs()
                    tol = chip_smoke.TOL_QMM["bfloat16"]
                    over = float((d - tol["rel"] * want.float().abs()).max()
                                 / want.float().abs().max())
                    if over > tol["out"]:
                        raise SystemExit(f"{tag} disagrees with the plain version at {row}: "
                                         f"{over:.3e}")
                    ms = timer.ms(lambda: mod.quant_matmul(x, qw))
                    row.setdefault(tag, []).append(ms)
                    row.setdefault(f"{tag}_stream", []).append(
                        stream_ms(torch, lambda c: mod.quant_matmul(x, c), copies))
                row["matmul_bf16_ms"] = timer.ms(lambda: torch.matmul(x, dense))
                row["matmul_bf16_stream_ms"] = stream_ms(torch, lambda c: torch.matmul(x, c),
                                                         dense_copies)
                nbytes = q_bytes + 2 * M * K + 2 * M * N
                row["bound_ms"] = max(nbytes / 3.35e12, 2 * M * K * N / 989e12) * 1e3
                results.append(row)
                print(f"  {row['shape']:<22} {mode:<10} M {M:>4}: flushed A {row['A'][0]:.4f} "
                      f"{row['A'][1]:.4f}, B {row['B'][0]:.4f} {row['B'][1]:.4f}; streaming A "
                      f"{row['A_stream'][0]:.4f} {row['A_stream'][1]:.4f}, B "
                      f"{row['B_stream'][0]:.4f} {row['B_stream'][1]:.4f} ms; bound "
                      f"{row['bound_ms']:.4f} ms; torch.matmul bf16 flushed "
                      f"{row['matmul_bf16_ms']:.4f}, streaming {row['matmul_bf16_stream_ms']:.4f} "
                      "ms", flush=True)
    print(json.dumps({"device": smi, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
