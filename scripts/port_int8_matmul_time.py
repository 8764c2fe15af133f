"""Time the integer-operand arm's kernels on the card (``PILOTTAI_QMATMUL=native``,
``pilottai_tpu_torch/csrc/int8_matmul.cu``) at llama3-8b's four matrix shapes.

For int8 and int4 (group 128) weights and 8, 32 and 2048 rows of bf16
activations it prints the product launch alone on a quantized workspace
(``int8_matmul.product``), the dequant arm's kernel on the same weight and
input (``qmatmul.quant_matmul``), and whether the fp32 result equals
``native_matmul_plain`` bit for bit; then the row quantizer at K 4096 and
14336. Each time is the median of 20 launches with the L2 cache flushed
before each (``chip_smoke.Timer``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 scripts/port_int8_matmul_time.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import LLAMA_MATRICES, Timer  # noqa: E402
from pilottai_tpu_torch.models.quant import quantize_array  # noqa: E402
from pilottai_tpu_torch.ops.kernels import int8_matmul as i8  # noqa: E402
from pilottai_tpu_torch.ops.kernels import qmatmul as qk  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("port_int8_matmul_time: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), flush=True)
    timer = Timer(torch, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for bits in (8, 4):
        for K, N in LLAMA_MATRICES:
            w = torch.randn((K, N), generator=gen, device=dev) * K**-0.5
            qw = quantize_array(w, torch.bfloat16, bits=bits, group=128)
            for M in (8, 32, 2048):
                x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
                plan = i8.launch_plan(M, K, N, bits, 128)
                xq, sx = i8.quantize_rows(x, plan)
                out = torch.empty((M, N), device=dev, dtype=torch.bfloat16)
                ms = timer.ms(lambda: i8.product(xq, sx, qw, plan, out))
                deq = timer.ms(lambda: qk.quant_matmul(x, qw))
                same = torch.equal(i8.int8_matmul(x, qw, torch.float32),
                                   i8.native_matmul_plain(x, qw, torch.float32))
                print(f"bits {bits} [{K}x{N}] M {M:>4}: product {ms:.4f} ms, dequant arm "
                      f"{deq:.4f} ms, equal to plain {same}", flush=True)
    for K in (4096, 14336):
        for M in (8, 2048):
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            plan = i8.launch_plan(M, K, 4096, 8, 128)
            ms = timer.ms(lambda: i8.quantize_rows(x, plan))
            print(f"quantizer x [{M}x{K}]: {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
