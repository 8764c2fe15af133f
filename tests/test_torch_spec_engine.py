"""Slice P4, speculative decoding, end to end on the CPU: protocol-s served
through the port's ``LLMHandler`` and through the JAX engine, both with
``engine_speculate=4`` (and again with ``engine_draft_layers=2``), on the
dense and the paged cache, with the prefix cache on: the greedy ids must
be identical, JSON on and off. The function-level parity tests are
``tests/test_torch_spec.py``."""

import asyncio
import json

import pytest
import torch

from pilottai_tpu_torch import PROTOCOL_S_NPZ, LLMConfig, LLMHandler
from pilottai_tpu_torch.engine.types import ChatMessage, ToolSpec
from pilottai_tpu_torch.models.loader import ASSETS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The model is small: one intra-op thread is as fast and does not
    oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = {"dense": json.loads((ASSETS / "protocol_s_golden.json").read_text()),
          "paged": json.loads((ASSETS / "protocol_s_paged_golden.json").read_text())}
ENGINE_NEW_TOKENS = 40


async def _serve_all(handler, msg_type, tool_type, golden, prepare=None):
    """Every golden case at once (six requests on four slots: slots change
    hands, repeated prompts hit the prefix cache, long prompts segment
    while other slots run speculative chunks); the texts in case order,
    the greedy ids by (prompt, JSON mode), and the batcher. ``prepare``
    gets the batcher once it is built."""
    await handler.start()
    batcher = handler.backend.batcher
    if prepare is not None:
        prepare(batcher)
    seen = {}
    submit = batcher.submit

    def recording(request):
        seen[len(seen)] = request
        return submit(request)

    batcher.submit = recording

    async def one(case):
        p = golden["prompts"][case["prompt"]]
        resp = await handler.generate_response(
            [msg_type(**m) for m in p["messages"]],
            tools=[tool_type(**t) for t in p["tools"]] if p["tools"] else None,
            json_mode=case["json_mode"])
        return resp.content

    try:
        texts = await asyncio.gather(*(one(c) for c in golden["cases"]))
    finally:
        await handler.stop()
    ids = {tuple(r.prompt_ids) + (bool(r.json_mode),): r.future.result() for r in seen.values()}
    return texts, ids, batcher


@pytest.fixture(scope="module")
def jax_engine_runs():
    """The JAX engine's ids per (cache, draft layers), each engine booted
    once for the module (its compile warm-up skipped: it changes no
    output)."""
    from pilottai_tpu.core.config import LLMConfig as JLLMConfig
    from pilottai_tpu.core.config import SamplingConfig as JSamplingConfig
    from pilottai_tpu.engine import types as jtypes
    from pilottai_tpu.engine.batcher import ContinuousBatcher as JBatcher
    from pilottai_tpu.engine.handler import LLMHandler as JLLMHandler
    from pilottai_tpu.train.protocol import DEFAULT_CHECKPOINT

    runs = {}
    warmup = JBatcher.warmup
    JBatcher.warmup = lambda self, *a, **k: None

    def run(cache, draft_layers):
        if (cache, draft_layers) not in runs:
            g = GOLDEN[cache]
            handler = JLLMHandler(JLLMConfig(
                model_name="protocol-s", provider="cpu", checkpoint_path=str(DEFAULT_CHECKPOINT),
                engine_chunk_policy="fixed", engine_speculate=4, engine_draft_layers=draft_layers,
                sampling=JSamplingConfig(temperature=0.0, max_new_tokens=ENGINE_NEW_TOKENS),
                **g["engine"]))
            runs[cache, draft_layers] = asyncio.run(
                _serve_all(handler, jtypes.ChatMessage, jtypes.ToolSpec, g))
        return runs[cache, draft_layers]

    yield run
    JBatcher.warmup = warmup


def _draft_from_the_model(batcher):
    """Every admitted slot starts in model-draft mode with a low acceptance
    EMA. On these prompts the n-gram drafts accept about two tokens a
    block, so the hysteresis alone would never switch a slot over; the ids
    may not depend on the draft source."""
    admit = batcher._dispatch_prefill

    def admitted(prep):
        admit(prep)
        with batcher._lock:
            for idx, _ in prep.group:
                batcher._draft_on[idx] = True
                batcher._slot_rate[idx] = 1.0

    batcher._dispatch_prefill = admitted


@pytest.mark.parametrize("draft_layers", [0, 2])
@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_engine_with_speculation_matches_the_jax_engine(jax_engine_runs, cache, draft_layers):
    """``engine_speculate=4`` (and ``engine_draft_layers=2``) on the port's
    ``LLMHandler`` at its defaults (prefix cache on, adaptive chunks, two
    in flight) gives the JAX engine's greedy ids on every golden case,
    JSON on and off, dense and paged with chunked prefill; speculative
    chunks ran and accepted drafts, with ``engine_draft_layers`` the
    model-draft variant ran, and the prefix cache hit."""
    g = GOLDEN[cache]
    handler = LLMHandler(LLMConfig(
        provider="cpu", model_name="protocol-s", checkpoint_path=PROTOCOL_S_NPZ,
        engine_speculate=4, engine_draft_layers=draft_layers,
        sampling={"temperature": 0.0, "max_new_tokens": ENGINE_NEW_TOKENS}, **g["engine"]))
    texts, ids, batcher = asyncio.run(_serve_all(
        handler, ChatMessage, ToolSpec, g, prepare=_draft_from_the_model if draft_layers else None))
    j_texts, j_ids, _ = jax_engine_runs(cache, draft_layers)
    assert ids == j_ids and texts == j_texts
    report = batcher.spec_report()
    assert report["draft_len"] == 4 and report["draft_layers"] == draft_layers
    assert report["tokens_per_block"] > 1.0
    assert (report["draft_blocks"] > 0) == bool(draft_layers)
    assert batcher.prefix_hits >= 1
    if cache == "paged":
        assert batcher.prefill_segments > 0
        assert batcher.alloc.free_pages + batcher.page_index.pinned_pages == batcher.num_pages - 1
