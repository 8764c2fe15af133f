"""On the card (``cuda``-marked; they skip without one): kernels K4 and K5
at head_dim 256 (``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu``,
built through their ``_h256`` sources) against the plain backward, in
bf16 and fp32, each case run twice for the same bits, within
``chip_smoke.TOL``'s backward limits: gemma2-2b's heads (G 2) with its
soft-cap and a window that bites, gemma-2b's (G 8 on one kv head) with an
empty batch row, and G 1 with T != S, offset query positions and an lse
cotangent. ``chip_smoke.py`` phase 3 runs more cases at the full training
shapes. This file imports no JAX, so it runs on a machine without it:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_gemma_bwd_cuda.py``."""

import pytest
import torch

from chip_smoke import check_flash_bwd

from pilottai_tpu_torch.ops.kernels import flash_attention as fa

CASES = {
    "gemma2-2b-window-softcap": dict(B=2, T=512, S=512, N=8, K=4, H=256, valid=[512, 300],
                                     window=200, softcap=50.0),
    "gemma-2b-g8-empty-row": dict(B=2, T=256, S=256, N=8, K=1, H=256, valid=[256, 0]),
    "g1-offset-dlse": dict(B=3, T=100, S=160, N=4, K=4, H=256, valid=[160, 97, 0], offset=60,
                           dlse=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", list(CASES))
def test_head_dim_256_bwd_kernels_match_plain_with_repeatable_bits(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    before = (fa.launches_dq, fa.launches_dkv)
    ok, _, _ = check_flash_bwd(torch, fa, gen, device, case, dtype, **CASES[case])
    assert ok
    # Two kernel runs each; the plain comparison launches nothing.
    assert (fa.launches_dq - before[0], fa.launches_dkv - before[1]) == (2, 2)
