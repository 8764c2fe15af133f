#!/usr/bin/env python3
"""Where the quantized product's bf16 body spends its time, on one card.

Copies ``csrc/`` and the wrapper of a ``pilottai_tpu_torch`` tree into
variants under ``--work`` (a directory that ``.gitignore`` lists), each
with its text edits of ``csrc/qmatmul.cu``, builds them in parallel, and
times every variant in turns (forward, then backward) at llama3-8b's four
matrix shapes in int8 and int4 (group 128), at 8 and 32 rows:

* ``base``: the tree as it is (checked against ``qmatmul_plain``);
* ``copy-only``: the consumers skip the dequant and the product, so the
  time is the producer's copies through the ring (results wrong);
* ``compute-only``: the producer arms each stage without copying, so the
  time is the consumers' work on stale shared memory (results wrong);
* ``ring-4``: four tiles in the ring for int8 too (six by default);
* ``ring+2``: two tiles more in the ring (eight int8, six int4);
* ``regs-64``: a launch bound of six blocks an SM (at most 64 registers).

Times as ``scripts/port_qmatmul_ab.py`` takes them: streaming (a CUDA
graph over copies of the weight that pass 200 MB) and flushed, in µs,
the smaller of the two turns; and each variant's registers and blocks an
SM at each shape. A variant whose edit no longer applies is reported and
left out.

    python3 scripts/port_qmatmul_probe.py --tree pilottai_tpu_torch --work .scratch/probe
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

SHAPES = ((4096, 4096, "wq, wo"), (4096, 1024, "wk, wv"), (4096, 14336, "wg, wu"),
          (14336, 4096, "wd"))
ROWS = (8, 32)
WRONG = ("copy-only", "compute-only")
# variant: the (text in csrc/qmatmul.cu, its replacement) pairs it applies.
EDITS = {
    "base": [],
    "copy-only": [("    for (int kk = 0; kk < KT / 16; ++kk) {\n      uint32_t b[4][2];",
                   "    for (int kk = 0; kk < (p.M < 0 ? KT / 16 : 0); ++kk) {\n"
                   "      uint32_t b[4][2];")],
    "compute-only": [("        mbar_arrive_expect_tx(&full[st], bytes);\n"
                      "        tma_load_2d(raw, &maps.q, n0, r0, &full[st]);\n"
                      "        tma_load_2d(xs, &maps.x, k0, 0, &full[st]);\n"
                      "        if (BITS == 4) tma_load_2d(ss, &maps.s, n0, g_first, &full[st]);",
                      "        mbar_arrive(&full[st]);")],
    "ring-4": [("return BITS == 8 ? 6 : 4;", "return BITS == 8 ? 4 : 4;")],
    "ring+2": [("return BITS == 8 ? 6 : 4;", "return BITS == 8 ? 8 : 6;"),
               ("constexpr int MAX_STAGES = 6;", "constexpr int MAX_STAGES = 8;")],
    "regs-64": [("__launch_bounds__(THREADS, MT <= 2 ? 4 : 3)",
                 "__launch_bounds__(THREADS, MT <= 2 ? 6 : 3)")],
}


def make_variant(tree: Path, work: Path, name: str):
    """``work/name`` with the tree's ``csrc`` and ``ops``, edited; None
    where the edit's text is not in the source."""
    out = work / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    shutil.copytree(tree / "csrc", out / "csrc")
    shutil.copytree(tree / "ops", out / "ops")
    src = out / "csrc" / "qmatmul.cu"
    text = src.read_text()
    for old, new in EDITS[name]:
        if old not in text:
            return None
        text = text.replace(old, new, 1)
    src.write_text(text)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default="pilottai_tpu_torch", help="pilottai_tpu_torch directory")
    ap.add_argument("--work", default=".scratch/probe", help="where the variants are written")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_qmatmul_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from port_qmatmul_ab import load_wrapper, occupancy, stream_ms
    from pilottai_tpu_torch.models.quant import quantize_array
    from pilottai_tpu_torch.ops.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    tree, work = Path(args.tree).resolve(), Path(args.work).resolve()
    dirs = {}
    for name in EDITS:
        d = make_variant(tree, work, name)
        if d is None:
            print(f"{name}: its edit no longer applies; left out", flush=True)
        else:
            dirs[name] = d
    libs = build.build_sources({f"qmm_{n}": d / "csrc" / "qmatmul.cu"
                                for n, d in dirs.items()})
    libs = {n: libs[f"qmm_{n}"] for n in dirs}
    mods = {n: load_wrapper(d, n.replace("-", "_")) for n, d in dirs.items()}
    dev = torch.device("cuda", 0)
    timer = chip_smoke.Timer(torch, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf = torch.bfloat16
    results = []
    for K, N, names in SHAPES:
        w = torch.randn((K, N), generator=gen, device=dev) * K**-0.5
        for bits in (8, 4):
            qw = quantize_array(w, bf, bits=bits, group=128)
            q_bytes = qw.q.numel() + 2 * qw.s.numel()
            copies = [type(qw)(**{**vars(qw), "q": qw.q.clone(), "s": qw.s.clone()})
                      for _ in range(max(2, -(-int(200e6) // q_bytes)))]
            for M in ROWS:
                x = chip_smoke.randn(torch, gen, (M, K), bf, dev)
                want = mods["base"].qmatmul_plain(x, qw).float() if "base" in mods else None
                row = {"shape": f"{names} [{K}x{N}]", "bits": bits, "rows": M,
                       "bound_us": (q_bytes + 2 * M * K + 2 * M * N) / 3.35e12 * 1e6}
                for name in list(dirs) + list(reversed(dirs)):
                    build.load_library = lambda _, name=name: libs[name]
                    mod = mods[name]
                    got = mod.quant_matmul(x, qw)
                    if name not in WRONG and want is not None:
                        tol = chip_smoke.TOL_QMM["bfloat16"]
                        d = (got.float() - want).abs() - tol["rel"] * want.abs()
                        if float(d.max() / want.abs().max()) > tol["out"]:
                            raise SystemExit(f"{name} disagrees with the plain version at {row}")
                    st = stream_ms(torch, lambda c: mod.quant_matmul(x, c), copies) * 1e3
                    fl = timer.ms(lambda: mod.quant_matmul(x, qw)) * 1e3
                    prev = row.get(name)
                    row[name] = (min(st, prev[0]), min(fl, prev[1])) if prev else (st, fl)
                for name in dirs:
                    row[f"{name}_regs_blocks"] = occupancy(libs[name], "bfloat16", bits, M, K, 128)
                results.append(row)
                print(f"  {row['shape']:<22} int{bits} M {M:>2} (bound {row['bound_us']:.2f}): "
                      + "  ".join(f"{n} {row[n][0]:.1f}/{row[n][1]:.1f}" for n in dirs)
                      + " us (streaming/flushed)", flush=True)
            del copies
    print(json.dumps({"device": smi, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
