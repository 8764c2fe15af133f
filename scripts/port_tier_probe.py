#!/usr/bin/env python3
"""The KV cache tier's smoke stages alone, on one card.

Builds the attention kernels, then runs ``chip_smoke.py``'s stages of the
tier: 4c and 4j (the protocol-s golden with the host tier on, then under
three sessions with each resume after its spill), dense and paged, and 5d
and 5k (llama3-8b agent steps with the tier on, then eight sessions
evicted and resumed from host memory, one exported and imported), dense
and paged. Every check of those stages applies; their numbers print as in
the smoke. A quicker card check of a change to the tier than the whole
smoke (a few minutes with the build).

    python3 scripts/port_tier_probe.py          # 4j and 5k
    python3 scripts/port_tier_probe.py 5k       # 5d and 5k alone
"""
import gc
import sys
import time
from pathlib import Path

root = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(root))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_tier_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pilottai_tpu_torch.ops.kernels import build
    from pilottai_tpu_torch.ops.kernels import decode_attention as da
    from pilottai_tpu_torch.ops.kernels import flash_attention as fa
    from pilottai_tpu_torch.ops.kernels import int8_matmul as i8
    from pilottai_tpu_torch.ops.kernels import paged_attention as pa
    from pilottai_tpu_torch.ops.kernels import qmatmul as qk

    kernels = {"flash": fa, "decode": da, "paged": pa, "qmatmul": qk, "int8_matmul": i8}
    t0 = time.perf_counter()
    print(cs.nvidia_smi(), flush=True)
    build.build_libraries(["flash_fwd", "decode_attention", "paged_attention", "qmatmul"])
    print(f"built {time.perf_counter() - t0:.1f} s", flush=True)
    stages = sys.argv[1:] or ["4j", "5k"]
    if "4j" in stages:
        for asset, paged in (("protocol_s_golden.json", False),
                             ("protocol_s_paged_golden.json", True)):
            kept = {}
            t = time.perf_counter()
            cs.phase_golden(torch, kernels, root, asset, paged=paged, prefix_cache=None,
                            repeat=2, knobs=dict(engine_kvcache_host_mb=cs.TIER_GOLDEN_MB),
                            keep=kept)
            cs.phase_tier_golden(torch, kept, paged)
            print(f"4c+4j {asset}: {time.perf_counter() - t:.1f} s", flush=True)
    if "5k" in stages:
        for paged in (False, True):
            kept = {}
            t = time.perf_counter()
            cs.phase_prefix_agent_steps(torch, kernels, root, 0, paged, keep=kept)
            t1 = time.perf_counter()
            cs.phase_tier_sessions(torch, kept, paged)
            print(f"5d {'paged' if paged else 'dense'}: {t1 - t:.1f} s, 5k "
                  f"{time.perf_counter() - t1:.1f} s", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
