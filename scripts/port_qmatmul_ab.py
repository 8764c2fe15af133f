#!/usr/bin/env python3
"""Time two versions of the port's quantized product on one card, in turns.

Builds ``csrc/qmatmul.cu`` from two source trees (A, typically the parent
commit unpacked with ``git archive``, and B, the working tree), binds each
with its own tree's wrapper (``ops/kernels/qmatmul.py``), checks each
against ``qmatmul_plain`` (``chip_smoke.TOL_QMM``), and times both in the
order A, B, B, A: the bf16 body at llama3-8b's four matrix shapes (wq and
wo, wk and wv, wg and wu, wd), int8 and int4 at group 128, at 8 rows (a
decode step), 32 (a verify block of 4) and 2048 (the admission's prefill
in ``chip_smoke.py`` 5f), beside ``torch.matmul`` on a dense bf16 weight
of the same shape; and the fp32 body at protocol-s's four shapes (4e),
int8 and int4 at groups 96 and 128, at 4 rows (a decode step) and 16 (a
verify block of 4). Each case also times the library call that computes
the same product (``chip_smoke.library_qmatmul``: tinygemm for int4 in
bf16, ``torch._weight_int8pack_mm`` for int8; none takes fp32 int4),
which the port never calls. Two times each: the median of 20
CUDA-event-timed launches with the L2 cache flushed before each
(``chip_smoke.Timer``, whose 1 GiB flush leaves L2 full of dirty lines
that a launch then writes back), and the streaming time, as a decode step
meets its weights: one CUDA graph of launches over copies of the weight
that together pass 200 MB, so none is in L2, replayed three times between
two events, per launch (the graph takes the host's per-call cost out, as
the decode chunk's graph does). The bound is the weight, activation and
result bytes over 3.35e12 B/s or the products over 989e12 FLOP/s (bf16)
or 67e12 (fp32 on the CUDA cores), the larger. Each version's fused
kernels print their registers (``ptxas -v``) and blocks an SM.

    git archive HEAD pilottai_tpu_torch | tar -x -C .scratch/parent
    python3 scripts/port_qmatmul_ab.py --a .scratch/parent/pilottai_tpu_torch \\
        --b pilottai_tpu_torch

Prints one line per (variant, case) and a closing JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
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
FP32_SHAPES = ((256, 256), (256, 128), (256, 1024), (1024, 256))
FP32_MODES = (("int8", 8, 128), ("int4 g96", 4, 96), ("int4 g128", 4, 128))
FP32_ROWS = (4, 16)
PEAK = {"bfloat16": 989e12, "float32": 67e12}
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


def occupancy(lib, dtype, bits, M, K, group):
    """``(registers or None, blocks an SM)`` of a tree's fused kernel for
    these rows: ``pt_qmatmul_info`` where the tree has it, else the older
    ``pt_qmatmul_blocks_per_sm`` (bf16 only; registers from ``ptxas``)."""
    I = ctypes.c_int
    regs, blocks = I(0), I(0)
    if hasattr(lib, "pt_qmatmul_info"):
        lib.pt_qmatmul_info.argtypes = [I] * 5 + [ctypes.POINTER(I)] * 2
        status = lib.pt_qmatmul_info(int(dtype == "bfloat16"), bits, M, K, group,
                                     ctypes.byref(regs), ctypes.byref(blocks))
        return (regs.value, blocks.value) if status == 0 else (None, None)
    if dtype != "bfloat16":
        return None, None
    lib.pt_qmatmul_blocks_per_sm.argtypes = [I, I, ctypes.POINTER(I)]
    status = lib.pt_qmatmul_blocks_per_sm(bits, M, ctypes.byref(blocks))
    return None, (blocks.value if status == 0 else None)


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
    libs = {}
    for tag, d in (("A", args.a), ("B", args.b)):
        libs[tag] = build.build_sources({"qmatmul": Path(d) / "csrc" / "qmatmul.cu"})["qmatmul"]
        secs, log = build.build_log.pop("qmatmul", (0.0, ""))
        print(f"{tag}: nvcc {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "qmm_" in line or "registers" in line or "spill" in line:
                print(f"  {tag} {line.strip()}", flush=True)
    wrappers = {tag: load_wrapper(Path(d), tag) for tag, d in (("A", args.a), ("B", args.b))}
    dev = torch.device("cuda", 0)
    timer = chip_smoke.Timer(torch, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = []

    def run_case(x, qw, copies, row, bits, group, dn):
        want = wrappers["B"].qmatmul_plain(x, qw)
        for tag in ("A", "B", "B", "A"):
            build.load_library = lambda name, tag=tag: libs[tag]
            mod = wrappers[tag]
            got = mod.quant_matmul(x, qw)
            d = (got.float() - want.float()).abs()
            tol = chip_smoke.TOL_QMM[dn]
            over = float((d - tol["rel"] * want.float().abs()).max() / want.float().abs().max())
            if over > tol["out"]:
                raise SystemExit(f"{tag} disagrees with the plain version at {row}: {over:.3e}")
            if not torch.equal(got, mod.quant_matmul(x, qw)):
                raise SystemExit(f"{tag} does not repeat its bits at {row}")
            row.setdefault(tag, []).append(timer.ms(lambda: mod.quant_matmul(x, qw)))
            row.setdefault(f"{tag}_stream", []).append(
                stream_ms(torch, lambda c: mod.quant_matmul(x, c), copies))
        M, K = x.shape
        for tag in ("A", "B"):
            if M <= wrappers[tag].FUSED_MAX_ROWS:
                row[f"{tag}_regs"], row[f"{tag}_blocks_per_sm"] = occupancy(
                    libs[tag], dn, bits, M, K, group)
        call, why = chip_smoke.library_qmatmul(torch, x, qw, bits, group)
        row["library_ms"] = timer.ms(call) if call is not None else None
        row["library"] = why or ("tinygemm" if bits == 4 else "_weight_int8pack_mm")

    def report(row, extra=""):
        lib = (f"{row['library_ms']:.4f}" if row["library_ms"] is not None
               else f"none ({row['library'][:60]})")
        occ = "; ".join(f"{t} {row.get(t + '_regs')} regs {row.get(t + '_blocks_per_sm')} "
                        "blocks/SM" for t in ("A", "B") if t + "_blocks_per_sm" in row)
        print(f"  {row['shape']:<22} {row['quant']:<10} {row['dtype']:<8} M {row['rows']:>4}: "
              f"flushed A {row['A'][0]:.4f} {row['A'][1]:.4f}, B {row['B'][0]:.4f} "
              f"{row['B'][1]:.4f}; streaming A {row['A_stream'][0]:.4f} "
              f"{row['A_stream'][1]:.4f}, B {row['B_stream'][0]:.4f} {row['B_stream'][1]:.4f} "
              f"ms; bound {row['bound_ms']:.5f} ms; library {lib} ms{extra}; {occ}", flush=True)

    def copies_of(qw):
        q_bytes = qw.q.numel() + qw.s.numel() * qw.s.element_size()
        return q_bytes, [type(qw)(**{**vars(qw), "q": qw.q.clone(), "s": qw.s.clone()})
                         for _ in range(max(2, -(-int(STREAM_BYTES) // q_bytes)))]

    bf = torch.bfloat16
    for K, N, names in SHAPES:
        w = torch.randn((K, N), generator=gen, device=dev) * K**-0.5
        dense = w.to(bf)
        dense_copies = [dense.clone() for _ in range(max(2, -(-int(STREAM_BYTES) // (2 * K * N))))]
        for mode, bits, group in MODES:
            qw = quantize_array(w, bf, bits=bits, group=group)
            q_bytes, copies = copies_of(qw)
            for M in ROWS:
                x = chip_smoke.randn(torch, gen, (M, K), bf, dev)
                row = {"shape": f"{names} [{K}x{N}]", "quant": mode, "dtype": "bfloat16",
                       "rows": M}
                run_case(x, qw, copies, row, bits, group, "bfloat16")
                row["matmul_bf16_ms"] = timer.ms(lambda: torch.matmul(x, dense))
                row["matmul_bf16_stream_ms"] = stream_ms(torch, lambda c: torch.matmul(x, c),
                                                         dense_copies)
                nbytes = q_bytes + 2 * M * K + 2 * M * N
                row["bound_ms"] = max(nbytes / 3.35e12, 2 * M * K * N / PEAK["bfloat16"]) * 1e3
                results.append(row)
                report(row, f"; torch.matmul bf16 flushed {row['matmul_bf16_ms']:.4f}, streaming "
                            f"{row['matmul_bf16_stream_ms']:.4f} ms")
            del copies
    for K, N in FP32_SHAPES:
        w = torch.randn((K, N), generator=gen, device=dev) * K**-0.5
        for mode, bits, group in FP32_MODES:
            qw = quantize_array(w, torch.float32, bits=bits, group=group)
            q_bytes, copies = copies_of(qw)
            for M in FP32_ROWS:
                x = chip_smoke.randn(torch, gen, (M, K), torch.float32, dev)
                row = {"shape": f"protocol-s [{K}x{N}]", "quant": mode, "dtype": "float32",
                       "rows": M}
                run_case(x, qw, copies, row, bits, group, "float32")
                row["plain_ms"] = timer.ms(lambda: wrappers["B"].qmatmul_plain(x, qw))
                nbytes = q_bytes + 4 * M * K + 4 * M * N
                row["bound_ms"] = max(nbytes / 3.35e12, 2 * M * K * N / PEAK["float32"]) * 1e3
                results.append(row)
                report(row, f"; plain {row['plain_ms']:.4f} ms")
    print(json.dumps({"device": smi, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
