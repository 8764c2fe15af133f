"""The port's engine serving the Gemma family on the CPU: ``TorchEngine``
(``provider="cpu"``, fp32) against the JAX engine's greedy ids on the two
head_dim 256 test models of ``scripts/export_gemma_golden.py``
(``assets/gemma*_h256*_golden.json``): three 415-token prompts past
gemma2's 128-key window, ``json_mode`` on and off, on the dense cache and
on the paged one with 64-token prefill segments. Each model is registered
from its golden file's config, in both packages."""

import asyncio
import json

import pytest
import torch

from pilottai_tpu.models import registry as jregistry
from pilottai_tpu.models.common import ModelConfig as JModelConfig
from pilottai_tpu_torch import LLMConfig, LLMHandler
from pilottai_tpu_torch.engine.types import ChatMessage, ToolSpec
from pilottai_tpu_torch.models import registry
from pilottai_tpu_torch.models.common import ModelConfig
from pilottai_tpu_torch.models.loader import ASSETS
from pilottai_tpu_torch.ops.kernels import decode_attention as da
from pilottai_tpu_torch.ops.kernels import flash_attention as fa
from pilottai_tpu_torch.ops.kernels import paged_attention as pa

GOLDENS = ("gemma2_tiny_h256_golden.json", "gemma2_tiny_h256_paged_golden.json",
           "gemma_tiny_h256_golden.json", "gemma_tiny_h256_paged_golden.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


async def _serve(handler, golden):
    """(prompt ids, token ids, text) per golden case, in order, and the
    batcher."""
    await handler.start()
    batcher = handler.backend.batcher
    seen = []
    submit = batcher.submit

    def recording(request):
        seen.append(request)
        return submit(request)

    batcher.submit = recording
    out = []
    try:
        for case in golden["cases"]:
            p = golden["prompts"][case["prompt"]]
            seen.clear()
            resp = await handler.generate_response(
                [ChatMessage(**m) for m in p["messages"]],
                tools=[ToolSpec(**t) for t in p["tools"]] if p["tools"] else None,
                json_mode=case["json_mode"],
            )
            out.append((list(seen[0].prompt_ids), seen[0].future.result(), resp.content))
    finally:
        await handler.stop()
    return out, batcher


@pytest.mark.parametrize("asset", GOLDENS)
def test_port_reproduces_the_gemma_golden_ids(asset):
    golden = json.loads((ASSETS / asset).read_text())
    registry.register_model(ModelConfig(**golden["config"]))
    jregistry.register_model(JModelConfig(**golden["config"]))
    handler = LLMHandler(LLMConfig(
        provider="cpu", model_name=golden["model"],
        checkpoint_path=str(ASSETS / golden["checkpoint"]), engine_prefix_cache=0,
        sampling={"temperature": 0.0, "max_new_tokens": golden["max_new_tokens"]},
        **golden["engine"],
    ))
    launches = (fa.launches, da.launches, pa.launches)
    out, batcher = asyncio.run(_serve(handler, golden))
    assert batcher.cfg.head_dim == 256 and batcher.paged == ("paged" in asset)
    if batcher.paged:
        assert batcher.prefill_segments > 0
    for case, (prompt_ids, token_ids, text) in zip(golden["cases"], out):
        assert prompt_ids == case["prompt_ids"]
        assert token_ids == case["token_ids"]
        assert text == case["text"]
    # CPU tensors run the kernels' plain versions: no launch is counted.
    assert (fa.launches, da.launches, pa.launches) == launches
