"""Whether ``chip_smoke.py``'s 5e speculative engines could run fewer
layers: llama3-8b at full width and the given depths, random weights from
seed 0, ``engine_speculate=4``, two waves of 5e's eight JSON requests of 64
new tokens each. 5e gates on more than one token a verify block and
replies of at least half the budget; this prints, per depth, the engine's
start (its warm-up sweep), each wave's tokens a reply and the
speculation report (tokens per block).

Run from the repository root on a machine with one NVIDIA H100::

    python3 scripts/port_spec_depth_probe.py [--layers 20 16]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402  (the smoke's engines and waves)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[20, 16])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_spec_depth_probe: no CUDA device", file=sys.stderr)
        return 2
    cs.log(cs.nvidia_smi())
    reqs = [([cs.FULL_PROMPT.format(i=i)], 64) for i in range(8)]
    for layers in args.layers:
        async def run():
            handler = await cs.full_width_engine(torch, 0, 2048, f"speculation at {layers} layers",
                                                 layers=layers, engine_speculate=4)
            await cs.timed_waves(handler, reqs, f"{layers} layers", n_waves=2)
            cs.log(f"  {layers} layers: {handler.backend.batcher.spec_report()}")
            cs.RESIDENT.pop(handler, None)
            await handler.stop()

        t0 = time.perf_counter()
        cs.arun(run())
        cs.log(f"  {layers} layers took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
