#!/usr/bin/env python3
"""Time two versions of the port's CUDA kernels on one card, in turns.

Builds the five kernels (``flash_fwd.cu``, ``decode_attention.cu``,
``paged_attention.cu``, ``flash_bwd_dq.cu``, ``flash_bwd_dkv.cu``) from two
source trees (A, typically the parent commit unpacked with ``git
archive``, and B, the working tree), binds each with its own tree's
wrapper (a kernel's C interface may differ between the two), checks each
against the plain PyTorch versions, and times both at the main path's
shapes in the order A, B, B, A, so drift on the card shows up as A
disagreeing with itself. bf16 at the llama3-8b serving and llama3-1b
training shapes; fp32 (TF32 off for PyTorch's own products, as
``chip_smoke.py`` runs it) at the golden protocol-s serving and training
shapes. The yardsticks, timed once: SDPA's forward at K1's shapes and its
backward (dq, dk and dv in one call) at K4's and K5's. Times are the
median of CUDA-event-timed launches queued back to back with the L2 cache
flushed before each (``chip_smoke.Timer``); K2 and K3 also with the L2
left warm (a spin kernel between launches in place of the flush).

    git archive HEAD pilottai_tpu_torch | tar -x -C .scratch/parent
    python3 scripts/port_kernel_ab.py --a .scratch/parent/pilottai_tpu_torch \\
        --b pilottai_tpu_torch

Prints one line per (variant, case) and a closing JSON object.
``--golden-train`` first runs the golden fp32 training steps
(``assets/protocol_s_train_golden.json``, as ``chip_smoke.py`` phase 7a
does) through each tree's kernels and prints each step's loss and grad
norm relative to the JAX trainer's, against ``chip_smoke.TOL_TRAIN_GOLDEN``.
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
# (name, dtype, B, T, valid, N, K, H): K1 at the llama3-8b serving shapes
# and the llama3-1b training shape in bf16, at the golden protocol-s
# serving and training shapes in fp32.
FLASH_CASES = [("prefill T256 valid 184", "bfloat16", 8, 256, 184, 32, 8, 128),
               ("prefill T2048 valid 1983", "bfloat16", 8, 2048, 1983, 32, 8, 128),
               ("train T2048 causal H64", "bfloat16", 4, 2048, 2048, 32, 8, 64),
               ("fp32 serve T512 valid 415", "float32", 1, 512, 415, 8, 4, 32),
               ("fp32 train T512 causal H32", "float32", 4, 512, 512, 8, 4, 32)]
# (name, dtype, B, N, K, H, S, last): K2 at the dense llama3-8b wave's
# shapes in bf16 and at the golden protocol-s step in fp32 (one live slot of
# four).
DECODE_CASES = [("decode S2048 last 216", "bfloat16", 8, 32, 8, 128, 2048, [216] * 8),
                ("decode S2048 last 2015", "bfloat16", 8, 32, 8, 128, 2048, [2015] * 8),
                ("fp32 decode S512 last 462", "float32", 4, 8, 4, 32, 512, [462, -1, -1, -1])]
# K3 at the paged llama3-8b wave's step: 129 pages of 128, one long slot and
# seven short ones, the ring 16 rows deep at step 8.
PAGED_LAST = [6097] + [215] * 7
# K4 and K5 at the llama3-1b training step's attention (bf16) and the golden
# protocol-s step's (fp32): (name, dtype, B, T, N, K, H).
BWD_CASES = [("T2048 H64", "bfloat16", 4, 2048, 32, 8, 64),
             ("fp32 T512 H32", "float32", 4, 512, 8, 4, 32)]


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


def golden_train(torch, build, libs, tag: str) -> None:
    """The golden fp32 training steps through one tree's kernels (the
    package's wrappers, its C interface unchanged across the two trees)."""
    import chip_smoke
    from pilottai_tpu_torch.models.loader import PROTOCOL_S_NPZ, load_npz
    from pilottai_tpu_torch.models.registry import get_model_config
    from pilottai_tpu_torch.train.protocol import protocol_batches
    from pilottai_tpu_torch.train.trainer import TrainConfig, Trainer

    load, build_all = build.load_library, build.build_libraries
    build.load_library = lambda name: libs[name]
    build.build_libraries = lambda names: {name: libs[name] for name in names}
    try:
        golden = json.loads((ROOT / "pilottai_tpu_torch" / "assets" /
                             "protocol_s_train_golden.json").read_text())
        cfg = get_model_config(golden["model"]).replace(dtype=torch.float32)
        trainer = Trainer(cfg, TrainConfig(**golden["train_config"]))
        state = trainer.init_from_params(load_npz(PROTOCOL_S_NPZ, cfg, dtype=torch.float32))
        spec = golden["batches"]
        stream = protocol_batches(spec["batch_size"], spec["seq_len"], seed=spec["seed"])
        texts = []
        for want in golden["per_step"]:
            state, metrics = trainer.step(state, next(stream))
            rl = abs(float(metrics["loss"]) - want["loss"]) / abs(want["loss"])
            rn = abs(float(metrics["grad_norm"]) - want["grad_norm"]) / abs(want["grad_norm"])
            texts.append(f"loss {rl:.2e} grad_norm {rn:.2e}")
        tol = chip_smoke.TOL_TRAIN_GOLDEN
        print(f"{tag} golden fp32 training steps, relative to the JAX trainer's (tol loss "
              f"{tol['loss']:g}, grad_norm {tol['grad_norm']:g}): " + "; ".join(texts),
              flush=True)
    finally:
        build.load_library, build.build_libraries = load, build_all


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="pilottai_tpu_torch directory of version A")
    ap.add_argument("--b", required=True, help="pilottai_tpu_torch directory of version B")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--golden-train", action="store_true",
                    help="also run the golden fp32 training steps through each tree's kernels")
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off for matmuls and "
          "cuDNN", flush=True)
    libs, wrappers = {}, {}
    for tag, d in (("A", args.a), ("B", args.b)):
        d = Path(d)
        libs[tag] = build.build_sources({name: d / "csrc" / f"{name}.cu" for name in KERNELS})
        wrappers[tag] = load_wrappers(d, tag)
    dev = torch.device("cuda", 0)
    if args.golden_train:
        for tag in ("A", "B"):
            golden_train(torch, build, libs[tag], tag)
    timer = chip_smoke.Timer(torch, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf = torch.bfloat16
    inputs = {}
    for name, dtype, B, T, n, N, K, H in FLASH_CASES:
        dt = getattr(torch, dtype)
        q, k, v = (chip_smoke.randn(torch, gen, (B, T, heads, H), dt, dev) for heads in (N, K, K))
        pos = torch.arange(T, device=dev, dtype=torch.int32)[None].repeat(B, 1)
        val = torch.full((B,), n, device=dev, dtype=torch.int32)
        inputs[name] = ("flash", (q, k, v, pos, pos, val), {})
    for name, dtype, B, N, K, H, S, last in DECODE_CASES:
        dt = getattr(torch, dtype)
        q = chip_smoke.randn(torch, gen, (B, N, H), dt, dev)
        kc, vc = (chip_smoke.randn(torch, gen, (B, K, S, H), dt, dev) for _ in range(2))
        lst = torch.tensor(last, device=dev, dtype=torch.int32)
        inputs[name] = ("decode", (q, kc, vc, lst, lst), {})
    N, K, H = 32, 8, 128
    P, R, step, num_pages = 128, 16, 8, 129
    x = chip_smoke.paged_inputs(torch, gen, dev, bf, len(PAGED_LAST), N, K, H, P,
                                [n + 1 for n in PAGED_LAST], step, R,
                                spare=num_pages - 1 - sum(-(-(n + 1) // P) for n in PAGED_LAST))
    kw = dict(q_positions=x["qpos"], n_blocks=x["max_pages"], scale=H**-0.5, ring_k=x["rk"],
              ring_v=x["rv"], ring_step=step)
    inputs["paged wave step"] = ("paged", (x["q"], x["k"], x["v"], x["table"], x["last"]), kw)
    bwd_ops = {}
    for case, dtype, B, T, N, K, H in BWD_CASES:
        dt = getattr(torch, dtype)
        q, do = (chip_smoke.randn(torch, gen, (B, T, N, H), dt, dev) for _ in range(2))
        k, v = (chip_smoke.randn(torch, gen, (B, T, K, H), dt, dev) for _ in range(2))
        pos = torch.arange(T, device=dev, dtype=torch.int32)[None].repeat(B, 1)
        val = torch.full((B,), T, device=dev, dtype=torch.int32)
        o, lse = wrappers["B"]["flash_attention"].flash_attention_plain(q, k, v, pos, pos, val)
        bwd_args = (q, k, v, pos, pos, val, 0, o, lse, do)
        bwd_ops[case] = {tag: w["flash_attention"].bwd_operands(*bwd_args)
                         for tag, w in wrappers.items()}
        inputs[f"train bwd dq {case}"] = ("bwd_dq", bwd_args, {"case": case})
        inputs[f"train bwd dkv {case}"] = ("bwd_dkv", bwd_args, {"case": case})

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
            return w["decode_attention"].decode_attention_plain(*a, a[0].shape[-1]**-0.5)[0]
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
    # SDPA over K2's panels repeated to the query heads, the cache masked.
    for name, (kind, a, _) in inputs.items():
        if kind != "decode":
            continue
        q, kc, vc, lst, _ = a
        G = q.shape[1] // kc.shape[1]
        kce, vce = (x.repeat_interleave(G, dim=1) for x in (kc, vc))
        dmask = (torch.arange(kc.shape[2], device=dev)[None, :] <= lst[:, None])[:, None, None]
        ms = timer.ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kce, vce,
                                                             attn_mask=dmask), iters=args.iters)
        results[f"SDPA {name}"] = [ms]
        print(f"SDPA {name:<28} {ms:9.4f} ms", flush=True)
    # SDPA's backward at K4's and K5's shapes: dq, dk and dv in one call.
    for name, (kind, a, kw) in inputs.items():
        if kind != "bwd_dq":
            continue
        q, k, v, pos, _, val, _, _, _, do = a
        G = q.shape[2] // k.shape[2]
        qs = q.transpose(1, 2).detach().requires_grad_()
        ks, vs = (x.transpose(1, 2).repeat_interleave(G, dim=1).detach().requires_grad_()
                  for x in (k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs,
                                             attn_mask=prefill_mask(pos, pos, val)[:, None])
        ms = timer.ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do.transpose(1, 2),
                                                  retain_graph=True), iters=args.iters)
        del out
        label = f"backward train {kw['case']}"
        results[f"SDPA {label}"] = [ms]
        print(f"SDPA {label:<28} {ms:9.4f} ms", flush=True)
    for tag in ("A", "B", "B", "A"):
        build.load_library = lambda name, tag=tag: libs[tag][name]
        w = wrappers[tag]
        for name, (kind, a, kw) in inputs.items():
            if kind.startswith("bwd"):
                kw = {"ops": bwd_ops[kw["case"]][tag], "case": kw["case"]}
            ref = refs[name]
            got = run(w, kind, a, kw)
            got = (torch.stack(got) if isinstance(got, tuple) else got).float()
            scale = (ref.abs().amax().clamp_min(1.0) if kind == "decode" else
                     ref.abs().amax() if kind.startswith("bwd") else 1.0)
            err = ((got - ref).abs().max() / scale).item()
            ms = timer.ms(lambda: run(w, kind, a, kw), iters=args.iters)
            results.setdefault(f"{tag} {name}", []).append(ms)
            warm = ""
            if kind in ("decode", "paged"):
                ms_warm = timer.ms(lambda: run(w, kind, a, kw), iters=args.iters, flush=False)
                results.setdefault(f"{tag} {name} L2 warm", []).append(ms_warm)
                warm = f" (L2 warm {ms_warm:.4f} ms)"
            print(f"{tag} {name:<28} {ms:9.4f} ms{warm}  err {err:.2e}", flush=True)
    print(json.dumps({"device": smi, "ms": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
