#!/usr/bin/env python3
"""Time two versions of the port's CUDA kernels on one card, in turns.

Builds the five kernels (``flash_fwd.cu``, ``decode_attention.cu``,
``paged_attention.cu``, ``flash_bwd_dq.cu``, ``flash_bwd_dkv.cu``) from two
source trees (A, typically the parent commit unpacked with ``git
archive``, and B, the working tree), binds each with its own tree's
wrapper (a kernel's C interface may differ between the two), checks each
against the plain PyTorch versions, and times both at the main path's
shapes in the order A, B, B, A, so drift on the card shows up as A
disagreeing with itself. The yardsticks, timed once: SDPA's forward at
K1's shapes and its backward (dq, dk and dv in one call) at K4's and
K5's. Times are the median of CUDA-event-timed launches queued back to
back with the L2 cache flushed before each (``chip_smoke.Timer``).

    git archive HEAD pilottai_tpu_torch | tar -x -C .scratch/parent
    python3 scripts/port_kernel_ab.py --a .scratch/parent/pilottai_tpu_torch \\
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

KERNELS = ("flash_fwd", "decode_attention", "paged_attention", "flash_bwd_dq",
           "flash_bwd_dkv")
# (name, B, T or S, valid or last, N, K, H): K1 at the llama3-8b serving
# shapes and the llama3-1b training shape, K2 at the dense wave's.
FLASH_CASES = [("prefill T256 valid 184", 8, 256, 184, 32, 8, 128),
               ("prefill T2048 valid 1983", 8, 2048, 1983, 32, 8, 128),
               ("train T2048 causal H64", 4, 2048, 2048, 32, 8, 64)]
DECODE_CASES = [("decode S2048 last 216", 8, 2048, 216),
                ("decode S2048 last 2015", 8, 2048, 2015)]
# K3 at the paged llama3-8b wave's step: 129 pages of 128, one long slot and
# seven short ones, the ring 16 rows deep at step 8.
PAGED_LAST = [6097] + [215] * 7
# K4 and K5 at the llama3-1b training step's attention: (B, T, N, K, H).
BWD_SHAPE = (4, 2048, 32, 8, 64)


def load_wrappers(pkg: Path, tag: str) -> dict:
    """The tree's kernel wrappers under private module names."""
    mods = {}
    for name in ("flash_attention", "decode_attention", "paged_attention"):
        spec = importlib.util.spec_from_file_location(
            f"_ab_{tag}_{name}", pkg / "ops" / "kernels" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods[name] = mod
    return mods


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="pilottai_tpu_torch directory of version A")
    ap.add_argument("--b", required=True, help="pilottai_tpu_torch directory of version B")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pilottai_tpu_torch.ops.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs, wrappers = {}, {}
    for tag, d in (("A", args.a), ("B", args.b)):
        d = Path(d)
        libs[tag] = build.build_sources({name: d / "csrc" / f"{name}.cu" for name in KERNELS})
        wrappers[tag] = load_wrappers(d, tag)
    dev = torch.device("cuda", 0)
    timer = chip_smoke.Timer(torch, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf = torch.bfloat16
    inputs = {}
    for name, B, T, n, N, K, H in FLASH_CASES:
        q, k, v = (chip_smoke.randn(torch, gen, (B, T, heads, H), bf, dev) for heads in (N, K, K))
        pos = torch.arange(T, device=dev, dtype=torch.int32)[None].repeat(B, 1)
        val = torch.full((B,), n, device=dev, dtype=torch.int32)
        inputs[name] = ("flash", (q, k, v, pos, pos, val), {})
    N, K, H = 32, 8, 128
    for name, B, S, last in DECODE_CASES:
        q = chip_smoke.randn(torch, gen, (B, N, H), bf, dev)
        kc, vc = (chip_smoke.randn(torch, gen, (B, K, S, H), bf, dev) for _ in range(2))
        lst = torch.full((B,), last, device=dev, dtype=torch.int32)
        inputs[name] = ("decode", (q, kc, vc, lst, lst), {})
    P, R, step, num_pages = 128, 16, 8, 129
    x = chip_smoke.paged_inputs(torch, gen, dev, bf, len(PAGED_LAST), N, K, H, P,
                                [n + 1 for n in PAGED_LAST], step, R,
                                spare=num_pages - 1 - sum(-(-(n + 1) // P) for n in PAGED_LAST))
    kw = dict(q_positions=x["qpos"], n_blocks=x["max_pages"], scale=H**-0.5, ring_k=x["rk"],
              ring_v=x["rv"], ring_step=step)
    inputs["paged wave step"] = ("paged", (x["q"], x["k"], x["v"], x["table"], x["last"]), kw)
    B, T, N, K, H = BWD_SHAPE
    q, do = (chip_smoke.randn(torch, gen, (B, T, N, H), bf, dev) for _ in range(2))
    k, v = (chip_smoke.randn(torch, gen, (B, T, K, H), bf, dev) for _ in range(2))
    pos = torch.arange(T, device=dev, dtype=torch.int32)[None].repeat(B, 1)
    val = torch.full((B,), T, device=dev, dtype=torch.int32)
    o, lse = wrappers["B"]["flash_attention"].flash_attention_plain(q, k, v, pos, pos, val)
    bwd_args = (q, k, v, pos, pos, val, 0, o, lse, do)
    bwd_ops = {tag: w["flash_attention"].bwd_operands(*bwd_args) for tag, w in wrappers.items()}
    inputs["train bwd dq T2048 H64"] = ("bwd_dq", bwd_args, {})
    inputs["train bwd dkv T2048 H64"] = ("bwd_dkv", bwd_args, {})

    def run(w, kind, a, kw):
        if kind == "bwd_dq":
            return w["flash_attention"].flash_bwd_dq(kw["ops"])
        if kind == "bwd_dkv":
            return w["flash_attention"].flash_bwd_dkv(kw["ops"])
        if kind == "flash":
            return w["flash_attention"].flash_attention_fwd(*a)[0]
        if kind == "decode":
            return w["decode_attention"].decode_attention(*a, return_stats=True)[0]
        acc, _, l = w["paged_attention"].paged_decode_attention(*a, **kw)
        return acc / l[..., None]

    def plain(w, kind, a, kw):
        if kind == "bwd_dq":
            return w["flash_attention"].flash_attention_bwd_plain(*a)[0]
        if kind == "bwd_dkv":
            return torch.stack(w["flash_attention"].flash_attention_bwd_plain(*a)[1:])
        if kind == "flash":
            return w["flash_attention"].flash_attention_plain(*a)[0]
        if kind == "decode":
            return w["decode_attention"].decode_attention_plain(*a, H**-0.5)[0]
        acc, _, l = w["paged_attention"].paged_decode_attention_plain(*a, **kw)
        return acc / l[..., None]

    refs = {name: plain(wrappers["B"], *spec).float() for name, spec in inputs.items()}
    results = {}
    # The yardstick: SDPA's forward with an explicit mask at the K1 shapes.
    import torch.nn.functional as F

    from pilottai_tpu_torch.ops.attention import prefill_mask

    for name, (kind, a, _) in inputs.items():
        if kind != "flash":
            continue
        q, k, v, pos, _, val = a
        G = q.shape[2] // k.shape[2]
        qs = q.transpose(1, 2)
        ks, vs = (x.transpose(1, 2).repeat_interleave(G, dim=1) for x in (k, v))
        mask = prefill_mask(pos, pos, val)[:, None]
        ms = timer.ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask),
                      iters=args.iters)
        results[f"SDPA {name}"] = [ms]
        print(f"SDPA {name:<28} {ms:9.4f} ms", flush=True)
    # SDPA's backward at K4's and K5's shape: dq, dk and dv in one call.
    q, k, v, pos, _, val, _, _, _, do = bwd_args
    G = q.shape[2] // k.shape[2]
    qs = q.transpose(1, 2).detach().requires_grad_()
    ks, vs = (x.transpose(1, 2).repeat_interleave(G, dim=1).detach().requires_grad_()
              for x in (k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=prefill_mask(pos, pos, val)[:, None])
    ms = timer.ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do.transpose(1, 2),
                                              retain_graph=True), iters=args.iters)
    del out
    results["SDPA backward train T2048 H64"] = [ms]
    print(f"SDPA {'backward train T2048 H64':<28} {ms:9.4f} ms", flush=True)
    for tag in ("A", "B", "B", "A"):
        build.load_library = lambda name, tag=tag: libs[tag][name]
        w = wrappers[tag]
        for name, (kind, a, kw) in inputs.items():
            if kind.startswith("bwd"):
                kw = {"ops": bwd_ops[tag]}
            ref = refs[name]
            got = run(w, kind, a, kw)
            got = (torch.stack(got) if isinstance(got, tuple) else got).float()
            scale = (ref.abs().amax().clamp_min(1.0) if kind == "decode" else
                     ref.abs().amax() if kind.startswith("bwd") else 1.0)
            err = ((got - ref).abs().max() / scale).item()
            ms = timer.ms(lambda: run(w, kind, a, kw), iters=args.iters)
            results.setdefault(f"{tag} {name}", []).append(ms)
            print(f"{tag} {name:<28} {ms:9.4f} ms  err {err:.2e}", flush=True)
    print(json.dumps({"device": smi, "ms": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
