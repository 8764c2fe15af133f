"""Slice P5b through the port's entry points: protocol-s in fp32 with
``engine_kv_quantize="int8"`` served by ``LLMHandler`` must give the JAX
engine's greedy ids on every golden case, JSON on and off, on the dense
and the paged cache (pages of 16, 64-token segments, ``engine_max_seq``
512). The golden files are the JAX engine's own output
(``scripts/export_protocol_s_kv8_golden.py``); its greedy ids do not
depend on speculation or the prefix cache, so the same files hold the runs
with ``engine_speculate=4`` and the cache on, where every prompt is served
twice and the repeat must equal the first run. With int8 weights as well
(``engine_quant="int8"``) the JAX engine runs here beside the port."""

import asyncio
import json

import pytest
import torch

from pilottai_tpu_torch import PROTOCOL_S_NPZ, LLMConfig, LLMHandler
from pilottai_tpu_torch.engine.types import ChatMessage, ToolSpec
from pilottai_tpu_torch.models import quant
from pilottai_tpu_torch.models.loader import ASSETS

GOLDEN = {name: json.loads((ASSETS / f"protocol_s_{name}_golden.json").read_text())
          for name in ("kv8", "kv8_paged")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


async def _serve(handler, msg_type, tool_type, golden, rounds=1):
    """Every golden case at once, ``rounds`` times in a row: per round the
    greedy ids by (prompt ids, JSON mode), and the batcher."""
    await handler.start()
    batcher = handler.backend.batcher
    seen = []
    submit = batcher.submit

    def recording(request):
        seen.append(request)
        return submit(request)

    batcher.submit = recording

    async def one(case):
        p = golden["prompts"][case["prompt"]]
        await handler.generate_response(
            [msg_type(**m) for m in p["messages"]],
            tools=[tool_type(**t) for t in p["tools"]] if p["tools"] else None,
            json_mode=case["json_mode"])

    out = []
    try:
        for _ in range(rounds):
            seen.clear()
            await asyncio.gather(*(one(c) for c in golden["cases"]))
            out.append({tuple(r.prompt_ids) + (bool(r.json_mode),): list(r.future.result())
                        for r in seen})
    finally:
        await handler.stop()
    return out, batcher


def _golden_ids(golden):
    return {tuple(c["prompt_ids"]) + (c["json_mode"],): c["token_ids"] for c in golden["cases"]}


def _handler(engine, new_tokens, **extra):
    return LLMHandler(LLMConfig(
        provider="cpu", model_name="protocol-s", checkpoint_path=PROTOCOL_S_NPZ,
        sampling={"temperature": 0.0, "max_new_tokens": new_tokens}, **dict(engine, **extra)))


def _check_int8_cache(batcher):
    cache = batcher.cache
    assert batcher.kv_quantize and cache.scales is not None
    assert all(k.dtype == torch.int8 and v.dtype == torch.int8 for k, v in cache.layers)
    assert all(s.dtype == torch.float32 and bool((s > 0).any()) for pair in cache.scales
               for s in pair)


CASES = {
    "dense": ("kv8", {}, 1),
    "paged": ("kv8_paged", {}, 1),
    "dense_spec_prefix": ("kv8", dict(engine_speculate=4, engine_prefix_cache=4), 2),
    "paged_spec_prefix": ("kv8_paged", dict(engine_speculate=4, engine_prefix_cache=4), 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_int8_kv_engine_gives_the_jax_engines_ids(case):
    """Greedy ids equal to the JAX engine's on the six golden cases, JSON
    on and off; with speculation and the prefix cache on, each case served
    twice, the repeat (a prefix hit) equal to the first run and both equal
    to the JAX engine's."""
    name, extra, rounds = CASES[case]
    g = GOLDEN[name]
    runs, batcher = asyncio.run(_serve(_handler(g["engine"], g["max_new_tokens"], **extra),
                                       ChatMessage, ToolSpec, g, rounds))
    want = _golden_ids(g)
    for ids in runs:
        assert ids == want
    _check_int8_cache(batcher)
    if extra.get("engine_speculate"):
        assert batcher.spec_report()["tokens_per_block"] > 1.0
        report = batcher.prefix_report()
        assert report["hits"] >= len(g["cases"]) and report["export_failures"] == 0
    if g["engine"].get("engine_paged_kv"):
        assert batcher.prefill_segments > 0
        pinned = batcher.page_index.pinned_pages if batcher.page_index is not None else 0
        assert batcher.alloc.free_pages + pinned == batcher.num_pages - 1


def test_int8_kv_with_int8_weights_matches_the_jax_engine():
    """Both quantizations at once (``engine_quant="int8"``, the int8 KV
    cache), dense with speculation and the prefix cache on: the port's ids
    equal the JAX engine's with the same knobs, served in this test."""
    from pilottai_tpu.core.config import LLMConfig as JLLMConfig
    from pilottai_tpu.engine import types as jtypes
    from pilottai_tpu.engine.batcher import ContinuousBatcher as JBatcher
    from pilottai_tpu.engine.handler import LLMHandler as JLLMHandler
    from pilottai_tpu.train.protocol import DEFAULT_CHECKPOINT

    g = GOLDEN["kv8"]
    new_tokens = 40
    extra = dict(engine_quant="int8", engine_speculate=4, engine_chunk_policy="fixed")
    warmup = JBatcher.warmup
    JBatcher.warmup = lambda self, *a, **k: None   # compiles only: no output changes
    try:
        jrun, jbatcher = asyncio.run(_serve(JLLMHandler(JLLMConfig(
            model_name="protocol-s", provider="cpu", checkpoint_path=str(DEFAULT_CHECKPOINT),
            sampling={"temperature": 0.0, "max_new_tokens": new_tokens},
            **dict(g["engine"], **extra))), jtypes.ChatMessage, jtypes.ToolSpec, g))
    finally:
        JBatcher.warmup = warmup
    runs, batcher = asyncio.run(_serve(_handler(g["engine"], new_tokens, **extra),
                                       ChatMessage, ToolSpec, g, rounds=2))
    assert jbatcher.kv_quantize and jbatcher.cache.scales is not None
    for ids in runs:
        assert ids == jrun[0]
    _check_int8_cache(batcher)
    assert batcher.weight_quant == "int8"
    assert isinstance(batcher.params["layers"][0]["mlp"]["wg"], quant.QTensor)
