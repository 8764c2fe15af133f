"""The port's engine on the paged KV cache, end to end on the CPU: the
chunked-prefill golden ids (``assets/protocol_s_paged_golden.json``, the
JAX engine's) with JSON on and off, the monolithic paged run, page
backpressure on a tiny pool, an oversized generation budget, pages
returned after a failed prefill, and a pool too small for one request."""

import asyncio
import json
import time

import pytest
import torch

from pilottai_tpu_torch import PROTOCOL_S_NPZ, LLMConfig, LLMHandler
from pilottai_tpu_torch.engine import batcher as bmod
from pilottai_tpu_torch.engine.batcher import ContinuousBatcher, GenRequest
from pilottai_tpu_torch.engine.types import ChatMessage, GenerationParams, ToolSpec
from pilottai_tpu_torch.models.common import init_params
from pilottai_tpu_torch.models.loader import ASSETS
from pilottai_tpu_torch.models.registry import get_model_config

PAGED_GOLDEN = json.loads((ASSETS / "protocol_s_paged_golden.json").read_text())
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast and does not
    oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


async def _serve(handler, msg_type, tool_type):
    """(prompt ids, token ids, text) per golden case, and the batcher."""
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
        for case in PAGED_GOLDEN["cases"]:
            p = PAGED_GOLDEN["prompts"][case["prompt"]]
            seen.clear()
            resp = await handler.generate_response(
                [msg_type(**m) for m in p["messages"]],
                tools=[tool_type(**t) for t in p["tools"]] if p["tools"] else None,
                json_mode=case["json_mode"],
            )
            out.append((list(seen[0].prompt_ids), seen[0].future.result(), resp.content))
    finally:
        await handler.stop()
    return out, batcher


def _port_handler(**overrides):
    # The cold path the golden was made on (tests/test_torch_prefix.py
    # serves it with the prefix cache on).
    knobs = dict(PAGED_GOLDEN["engine"], engine_prefix_cache=0)
    knobs.update(overrides)
    return LLMHandler(LLMConfig(
        provider="cpu", model_name="protocol-s", checkpoint_path=PROTOCOL_S_NPZ,
        sampling={"temperature": 0.0, "max_new_tokens": PAGED_GOLDEN["max_new_tokens"]},
        **knobs,
    ))


def test_chunked_paged_engine_reproduces_the_jax_paged_golden(monkeypatch):
    """The JAX engine still gives the committed paged golden ids; the port
    reproduces them with chunked prefill (JSON on and off, segments run)
    and its monolithic paged run gives the same texts."""
    from pilottai_tpu.core.config import LLMConfig as JLLMConfig
    from pilottai_tpu.core.config import SamplingConfig as JSamplingConfig
    from pilottai_tpu.engine import types as jtypes
    from pilottai_tpu.engine.batcher import ContinuousBatcher as JContinuousBatcher
    from pilottai_tpu.engine.handler import LLMHandler as JLLMHandler
    from pilottai_tpu.train.protocol import DEFAULT_CHECKPOINT

    monkeypatch.setattr(JContinuousBatcher, "warmup", lambda self, *a, **k: None)
    jax_out, _ = asyncio.run(_serve(JLLMHandler(JLLMConfig(
        model_name="protocol-s", provider="cpu", checkpoint_path=str(DEFAULT_CHECKPOINT),
        engine_prefix_cache=0, engine_chunk_policy="fixed",
        sampling=JSamplingConfig(temperature=0.0, max_new_tokens=PAGED_GOLDEN["max_new_tokens"]),
        **PAGED_GOLDEN["engine"],
    )), jtypes.ChatMessage, jtypes.ToolSpec))
    chunked, batcher = asyncio.run(_serve(_port_handler(), ChatMessage, ToolSpec))
    assert batcher.paged and batcher.prefill_chunk == 64
    # 415-token prompts in 64-token segments: five extend segments, then the
    # final one admits, for each of the six requests.
    assert batcher.prefill_segments == 6 * 6
    assert batcher.alloc.free_pages == batcher.num_pages - 1
    mono, mono_batcher = asyncio.run(_serve(_port_handler(engine_prefill_chunk=0),
                                            ChatMessage, ToolSpec))
    assert mono_batcher.prefill_segments == 0
    assert {c["json_mode"] for c in PAGED_GOLDEN["cases"]} == {True, False}
    for case, theirs, ours, whole in zip(PAGED_GOLDEN["cases"], jax_out, chunked, mono):
        assert theirs[0] == ours[0] == case["prompt_ids"]
        assert theirs[1] == case["token_ids"], "the JAX engine no longer gives the golden ids"
        assert ours[1] == case["token_ids"]
        assert ours[2] == whole[2] == theirs[2] == case["text"]


def _tiny_handler(**knobs):
    # No pages pinned by the prefix cache: every page comes back.
    return LLMHandler(LLMConfig(
        provider="cpu", model_name="llama-tiny", dtype="float32", engine_paged_kv=True,
        engine_page_size=32, engine_chunk=4, engine_prefix_cache=0, **knobs,
    ))


def test_tiny_pool_backpressure_completes_and_returns_every_page():
    """Nine usable pages hold three requests at a time on four slots: the
    FIFO head waits for pages, all eight requests complete, and every page
    is back on the free list."""
    async def main():
        h = _tiny_handler(engine_slots=4, engine_max_seq=1024, engine_kv_pages=10)
        await h.start()
        batcher = h.backend.batcher
        peak = []
        decode = batcher._decode

        def watching():
            peak.append(batcher.num_pages - 1 - batcher.alloc.free_pages)
            decode()

        batcher._decode = watching
        try:
            outs = await asyncio.gather(*[
                h.generate_response(["x" * 40], params=GenerationParams(
                    max_new_tokens=8, temperature=0.3, seed=i))
                for i in range(8)
            ])
            return outs, batcher, peak
        finally:
            await h.stop()

    outs, batcher, peak = asyncio.run(main())
    assert len(outs) == 8 and all(o.usage.completion_tokens >= 1 for o in outs)
    assert batcher.num_pages == 10
    assert max(peak) <= 9 and max(peak) >= 6
    assert batcher.alloc.free_pages == 9
    assert (batcher.alloc.table == batcher.alloc.sentinel).all()


def test_oversized_max_new_tokens_does_not_deadlock():
    """A budget far beyond the pool is clamped to the slot's capacity when
    pages are reserved; decode stops at a full context and the request
    behind it completes."""
    async def main():
        h = _tiny_handler(engine_slots=2, engine_max_seq=256, engine_kv_pages=9)
        try:
            big = await h.generate_response(["hi"], params=GenerationParams(
                max_new_tokens=100000, temperature=0.0))
            small = await h.generate_response(["ok"], params=GenerationParams(max_new_tokens=4))
            return big, small, h.backend.batcher
        finally:
            await h.stop()

    big, small, batcher = asyncio.run(main())
    assert 1 <= big.usage.completion_tokens < 256
    assert 1 <= small.usage.completion_tokens <= 4
    assert batcher.alloc.free_pages == 8


@pytest.mark.parametrize("stage", ["admit_group", "extend_prompt_paged"])
def test_failed_prefill_releases_its_pages(monkeypatch, stage):
    """A prefill that raises (a whole-prompt admission, or one segment of a
    chunked prefill) fails its request, returns its pages, and leaves the
    slot usable."""
    cfg = get_model_config("llama-tiny").replace(dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    b = ContinuousBatcher(cfg, params, CPU, n_slots=2, max_seq_len=256, paged=True,
                          page_size=32, num_pages=9, prefill_chunk=32, prefix_cache=0)

    def boom(*a, **k):
        raise RuntimeError("prefill exploded")

    monkeypatch.setattr(bmod, stage, boom)
    prompt = list(range(3, 6)) if stage == "admit_group" else list(range(3, 120))
    b.start()
    try:
        fut = b.submit(GenRequest(prompt_ids=prompt, max_new_tokens=4))
        with pytest.raises(RuntimeError, match="prefill exploded"):
            fut.result(timeout=60)
        deadline = time.monotonic() + 10
        while b.alloc.free_pages != 8 or b._segmenting is not None:
            assert time.monotonic() < deadline, b.alloc.free_pages
            time.sleep(0.01)
        monkeypatch.undo()
        out = b.submit(GenRequest(prompt_ids=prompt, max_new_tokens=3)).result(timeout=60)
        assert len(out) == 3
        if stage == "extend_prompt_paged":
            assert b.prefill_segments >= 3
    finally:
        b.stop()
    assert b.alloc.free_pages == 8


def test_cancel_during_a_segmented_prefill_returns_its_pages(monkeypatch):
    """A request cancelled between two prefill segments runs no further
    segment, and its pages go back to the pool."""
    cfg = get_model_config("llama-tiny").replace(dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    b = ContinuousBatcher(cfg, params, CPU, n_slots=2, max_seq_len=256, paged=True,
                          page_size=32, num_pages=9, prefill_chunk=32, prefix_cache=0)
    req = GenRequest(prompt_ids=list(range(3, 120)), max_new_tokens=4)
    extend = bmod.extend_prompt_paged

    def cancelling(*a, **k):
        req.cancelled = True
        return extend(*a, **k)

    monkeypatch.setattr(bmod, "extend_prompt_paged", cancelling)
    b.start()
    try:
        b.submit(req)
        deadline = time.monotonic() + 30
        while b.prefill_segments == 0 or b._segmenting is not None or b.alloc.free_pages != 8:
            assert time.monotonic() < deadline, (b.prefill_segments, b.alloc.free_pages)
            time.sleep(0.01)
        assert b.prefill_segments == 1 and not req.future.done()
        monkeypatch.undo()
        out = b.submit(GenRequest(prompt_ids=[5, 6, 7], max_new_tokens=3)).result(timeout=60)
        assert len(out) == 3
    finally:
        b.stop()
    assert b.alloc.free_pages == 8


def test_a_pool_too_small_for_one_request_fails_fast():
    cfg = get_model_config("llama-tiny").replace(dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    with pytest.raises(ValueError, match="can't hold a single request"):
        ContinuousBatcher(cfg, params, CPU, n_slots=1, max_seq_len=2048, paged=True,
                          page_size=4096, num_pages=1)
