"""On the card (``cuda``-marked; they skip without one): the logits head's
bf16 x bf16 -> fp32 product, and speculative chunks as CUDA graphs: a
same-seed sampled stream with speculation on equals it with speculation
off through graph replays, and the paged verify launches K3 once per layer
per block, replays included. This file imports no JAX, so it runs on a
machine without it: ``python -m pytest --noconftest -p no:cacheprovider -m
cuda tests/test_torch_spec_cuda.py``."""

import numpy as np
import pytest
import torch

from pilottai_tpu_torch import PROTOCOL_S_NPZ
from pilottai_tpu_torch.engine.batcher import ContinuousBatcher, GenRequest
from pilottai_tpu_torch.engine.tokenizer import ByteTokenizer
from pilottai_tpu_torch.models import registry, transformer
from pilottai_tpu_torch.models.common import matmul_f32
from pilottai_tpu_torch.models.loader import load_npz

PROMPTS = [
    "<|user|>\nList the findings of report 7 as JSON.\n<|assistant|>\n",
    "<|user|>\nValidate the extracted sections.\n<|assistant|>\n",
]


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the out_dtype product and the chunk graphs are the "
                    "card's")
    return torch.device("cuda", torch.cuda.current_device())


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [True, False])
def test_cuda_head_runs_bf16_operands_with_an_fp32_result(tied):
    """``_unembed`` of bf16 operands goes through the ``out_dtype`` product
    (no fp32 copy of the head) and equals the fp32 form up to the order of
    summation; its gradients come back in bf16."""
    dev = _device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    E, V = 512, 4000
    cfg = registry.get_model_config("llama-tiny").replace(
        hidden_size=E, vocab_size=V, tie_embeddings=tied)

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    params = {"embed": bf16(V, E)}
    if not tied:
        params["lm_head"] = bf16(E, V)
    h = bf16(4, 8, E).requires_grad_()
    head = params["lm_head"] if not tied else params["embed"].t()
    got = transformer._unembed(cfg, params, h)
    want = h.detach().float() @ head.float()
    assert got.dtype == torch.float32
    assert _rel(got.detach(), want) <= 1e-5
    assert _rel(matmul_f32(h.detach(), head), want) <= 1e-5
    got.sum().backward()
    assert h.grad.dtype == torch.bfloat16 and bool(torch.isfinite(h.grad.float()).all())


def _batcher(dev, **knobs):
    cfg = registry.get_model_config("protocol-s").replace(dtype=torch.float32)
    return ContinuousBatcher(cfg, load_npz(PROTOCOL_S_NPZ, cfg, device=dev), dev, n_slots=4,
                             admit_batch=4, max_seq_len=256, chunk_size=8, prefix_cache=0,
                             chunk_policy="fixed", **knobs)


def _serve(b, reqs):
    """Serve ``reqs`` one after another on ``b`` after its warm-up sweep;
    the kernels' launch counts then start from zero."""
    from pilottai_tpu_torch.ops.kernels import decode_attention as k2
    from pilottai_tpu_torch.ops.kernels import paged_attention as k3

    b.start()
    try:
        b.warmup()
        k2.launches = k3.launches = 0
        out = []
        for r in reqs:
            b.submit(r)
            out.append(r.future.result(timeout=300))
    finally:
        b.stop()
    return out


@pytest.mark.cuda
def test_cuda_sampled_stream_is_the_same_with_speculation_on_and_off():
    """The same seed through speculative chunk graphs (captured by the
    warm-up sweep, replayed by both requests) and through plain ones gives
    the same sampled ids: one draw a block where the plain chunk draws
    once a step, from the slot's registered generator."""
    dev = _device()
    tok = ByteTokenizer()

    def reqs():
        return [GenRequest(prompt_ids=tok.encode(PROMPTS[1]), max_new_tokens=24,
                           temperature=0.9, top_k=40, top_p=0.95, seed=7, eos_id=-1)
                for _ in range(2)]

    spec = _batcher(dev, speculate=4)
    got = _serve(spec, reqs())
    assert spec.sweep["graphs"] >= 1 and spec.graph_report()["graphs"] == 0
    want = _serve(_batcher(dev), reqs())
    assert got == want and got[0] == got[1] and len(got[0]) == 24


@pytest.mark.cuda
def test_cuda_paged_verify_launches_k3_once_per_layer_per_block():
    """Greedy ids equal with speculation on and off on the paged cache, and
    the verify launches K3 once per layer per block dispatched, replays
    included; K2 never."""
    from pilottai_tpu_torch.ops.kernels import decode_attention as k2
    from pilottai_tpu_torch.ops.kernels import paged_attention as k3

    dev = _device()
    tok = ByteTokenizer()

    def reqs():
        return [GenRequest(prompt_ids=tok.encode(p), max_new_tokens=40, eos_id=-1)
                for p in PROMPTS]

    want = _serve(_batcher(dev, paged=True, page_size=16), reqs())
    b = _batcher(dev, paged=True, page_size=16, speculate=4)
    assert _serve(b, reqs()) == want
    assert b.sweep["graphs"] >= 1 and b.blocks_dispatched > 0
    assert k3.launches == b.cfg.n_layers * b.blocks_dispatched
    assert k2.launches == 0
    assert b.spec_report()["tokens_per_block"] >= 1.0
    assert np.isfinite(b.spec_report()["rate_ema"])
