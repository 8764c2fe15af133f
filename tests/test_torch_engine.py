"""The port's engine end to end on the CPU: ``LLMHandler.generate_response``
against the JAX engine and the committed golden ids, concurrency, sampled
determinism, and the refusal of settings outside this slice."""

import asyncio
import json

import pytest
import torch

from pilottai_tpu_torch import PROTOCOL_S_NPZ, LLMConfig, LLMHandler
from pilottai_tpu_torch.core.config import NotInSlice
from pilottai_tpu_torch.engine.types import ChatMessage, GenerationParams, ToolSpec
from pilottai_tpu_torch.models.loader import ASSETS

GOLDEN = json.loads((ASSETS / "protocol_s_golden.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast and does not
    oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_handler(**overrides):
    # The cold path the golden was made on (tests/test_torch_prefix.py
    # serves it with the prefix cache on).
    knobs = dict(GOLDEN["engine"], engine_prefix_cache=0)
    knobs.update(overrides)
    return LLMHandler(LLMConfig(
        provider="cpu", model_name="protocol-s", checkpoint_path=PROTOCOL_S_NPZ,
        sampling={"temperature": 0.0, "max_new_tokens": GOLDEN["max_new_tokens"]}, **knobs,
    ))


async def _serve_golden(handler, msg_type, tool_type):
    """(prompt ids, token ids, text) per golden case, in order."""
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
        for case in GOLDEN["cases"]:
            p = GOLDEN["prompts"][case["prompt"]]
            seen.clear()
            resp = await handler.generate_response(
                [msg_type(**m) for m in p["messages"]],
                tools=[tool_type(**t) for t in p["tools"]] if p["tools"] else None,
                json_mode=case["json_mode"],
            )
            out.append((list(seen[0].prompt_ids), seen[0].future.result(), resp.content))
    finally:
        await handler.stop()
    return out


def test_port_reproduces_the_golden_ids_and_the_jax_engine(monkeypatch):
    """The port on the CPU and the JAX engine (``provider="cpu"``, fp32)
    both reproduce the committed golden ids, so their texts are equal.
    The JAX engine runs without its compile warm-up, which changes no
    output."""
    from pilottai_tpu.core.config import LLMConfig as JLLMConfig
    from pilottai_tpu.core.config import SamplingConfig as JSamplingConfig
    from pilottai_tpu.engine import types as jtypes
    from pilottai_tpu.engine.batcher import ContinuousBatcher
    from pilottai_tpu.engine.handler import LLMHandler as JLLMHandler
    from pilottai_tpu.train.protocol import DEFAULT_CHECKPOINT

    port = asyncio.run(_serve_golden(_port_handler(), ChatMessage, ToolSpec))
    monkeypatch.setattr(ContinuousBatcher, "warmup", lambda self, *a, **k: None)
    jax_handler = JLLMHandler(JLLMConfig(
        model_name="protocol-s", provider="cpu", checkpoint_path=str(DEFAULT_CHECKPOINT),
        engine_prefix_cache=0, engine_chunk_policy="fixed",
        sampling=JSamplingConfig(temperature=0.0, max_new_tokens=GOLDEN["max_new_tokens"]),
        **GOLDEN["engine"],
    ))
    jax_out = asyncio.run(_serve_golden(jax_handler, jtypes.ChatMessage, jtypes.ToolSpec))
    for case, ours, theirs in zip(GOLDEN["cases"], port, jax_out):
        assert ours[0] == theirs[0] == case["prompt_ids"]
        assert theirs[1] == case["token_ids"], "the JAX engine no longer gives the golden ids"
        assert ours[1] == case["token_ids"]
        assert ours[2] == theirs[2] == case["text"]
    assert all(json.loads(c["text"]) for c in GOLDEN["cases"] if c["json_mode"])


def test_concurrent_requests_complete_and_sampling_is_seed_deterministic():
    async def main():
        handler = _port_handler(engine_slots=2, engine_admit_batch=2)
        prompts = ["Summarize report 4.", "Extract the sections.", "Check invoice 9."]
        try:
            greedy = await asyncio.gather(*[
                handler.generate_response([p], params=GenerationParams(
                    temperature=0.0, max_new_tokens=12 + 4 * i), json_mode=i != 1)
                for i, p in enumerate(prompts)
            ])
            sampled = [
                await handler.generate_response(["Draft the digest."], params=GenerationParams(
                    temperature=0.9, top_k=40, top_p=0.95, seed=7, max_new_tokens=16))
                for _ in range(2)
            ]
        finally:
            await handler.stop()
        return greedy, sampled

    greedy, sampled = asyncio.run(main())
    for i, r in enumerate(greedy):                       # 3 requests on 2 slots
        assert 1 <= r.usage.completion_tokens <= 12 + 4 * i
        assert r.usage.prompt_tokens > 0
    assert sampled[0].content == sampled[1].content       # same seed, same tokens


def test_knobs_outside_the_slice_are_refused(monkeypatch):
    # The prefix cache (slice P2) is accepted at the JAX package's defaults;
    # its host tier and eviction policies wait for P7.
    cfg = LLMConfig()
    assert (cfg.engine_prefix_cache, cfg.engine_prefix_min_len) == (4, None)
    LLMConfig(engine_prefix_cache=8, engine_prefix_min_len=16, engine_kvcache_policy="cost")
    with pytest.raises(ValueError, match="P7"):
        LLMConfig(engine_kvcache_host_mb=64)
    with pytest.raises(ValueError, match="P7"):
        LLMConfig(engine_kvcache_policy="lru")
    with pytest.raises(ValueError):
        LLMConfig(engine_prefix_cache=-1)
    # Speculative decoding (slice P4) is accepted, at the JAX package's
    # defaults (both off).
    cfg = LLMConfig()
    assert (cfg.engine_speculate, cfg.engine_draft_layers) == (0, 0)
    cfg = LLMConfig(engine_speculate=4, engine_draft_layers=2)
    assert (cfg.engine_speculate, cfg.engine_draft_layers) == (4, 2)
    with pytest.raises(ValueError):
        LLMConfig(engine_speculate=-1)
    # Weight quantization (slice P5a) and the int8 KV cache (P5b) are
    # accepted; an unknown KV mode is refused, as the JAX engine refuses it.
    LLMConfig(engine_quant="int8", engine_quant_group=64)
    assert LLMConfig(engine_kv_quantize="int8").engine_kv_quantize == "int8"
    assert LLMConfig().engine_kv_quantize is None
    with pytest.raises(ValueError, match="engine_kv_quantize"):
        LLMConfig(engine_kv_quantize="int4")
    # The decode pipeline's knobs (slice P6a) are accepted, at the JAX
    # package's defaults; the rest of the batcher names its own item.
    cfg = LLMConfig()
    assert (cfg.engine_pipeline, cfg.engine_overlap_admission, cfg.engine_chunk_policy,
            cfg.engine_chunk_buckets, cfg.engine_fused_epilogue) == (2, True, "adaptive",
                                                                     None, True)
    LLMConfig(engine_chunk_policy="fixed", engine_chunk_buckets=(4, 8), engine_pipeline=1,
              engine_overlap_admission=False, engine_fused_epilogue=False)
    with pytest.raises(ValueError, match="P6b"):
        LLMConfig(retries=3)
    with pytest.raises(ValueError, match="P6c"):
        LLMConfig(engine_sched_policy="dag")
    with pytest.raises(ValueError, match="P10"):
        LLMConfig(mesh_shape={"model": 4})
    with pytest.raises(ValueError):
        LLMConfig(engine_no_such_knob=1)
    # The values this slice already runs are accepted.
    LLMConfig(engine_prefix_cache=0, engine_speculate=0, retries=0, engine_sched_policy="fifo")
    # From a context of 4096 on the handler builds a paged batcher, as the
    # JAX engine does; the TPU kernel's page strip has no counterpart. Its
    # warm-up sweep (tests/test_torch_warmup.py) is left out here: on the
    # CPU it prefills 2048- and 4088-token prompts four times each.
    from pilottai_tpu_torch.engine.batcher import ContinuousBatcher

    monkeypatch.setattr(ContinuousBatcher, "warmup", lambda self, prompt_lens=None: None)
    paged = LLMHandler(LLMConfig(provider="cpu", model_name="protocol-s", engine_max_seq=4096))
    asyncio.run(paged.start())
    try:
        assert paged.backend.batcher.paged and paged.backend.batcher.alloc is not None
    finally:
        asyncio.run(paged.stop())
    with pytest.raises(ValueError, match="engine_page_strip=2") as refused:
        LLMConfig(engine_page_strip=2)
    assert isinstance(refused.value.errors()[0]["ctx"]["error"], NotInSlice)
    LLMConfig(engine_page_strip=None)

    async def schema_request():
        handler = LLMHandler(LLMConfig(provider="cpu", model_name="protocol-xs"))
        try:
            await handler.generate_response(["hi"], json_schema={"type": "object"})
        finally:
            await handler.stop()

    with pytest.raises(NotInSlice, match="P8"):
        asyncio.run(schema_request())


def test_incremental_decoder_matches_jax():
    """Streaming detokenization: the port's ``IncrementalDecoder`` emits the
    same deltas as the JAX package's, including a split UTF-8 sequence."""
    from pilottai_tpu.engine import tokenizer as jtok
    from pilottai_tpu_torch.engine import tokenizer as ttok

    ids = list("héllo {\"a\": 1} ✓".encode())
    chunks = [ids[:2], ids[2:3], ids[3:9], ids[9:-2], ids[-2:-1], ids[-1:]]
    ours = ttok.IncrementalDecoder(ttok.ByteTokenizer())
    theirs = jtok.IncrementalDecoder(jtok.ByteTokenizer())
    for chunk in chunks + [[258]]:
        assert ours.push(chunk) == theirs.push(chunk)
    assert ours.flush() == theirs.flush()
    assert ours.text == theirs.text == bytes(ids).decode()


def test_request_edges_budget_one_truncation_and_stop_strings():
    """max_new_tokens=1 finishes at the prefill token; a prompt longer than
    the keep window is left-truncated as the JAX batcher does; stop strings
    cut the text at their earliest occurrence."""
    async def main():
        handler = _port_handler()
        try:
            one = await handler.generate_response(["Plan."], params=GenerationParams(
                temperature=0.0, max_new_tokens=1))
            long = await handler.generate_response(["x" * 900], params=GenerationParams(
                temperature=0.0, max_new_tokens=8), json_mode=True)
            free = await handler.generate_response(["Plan the step."], params=GenerationParams(
                temperature=0.0, max_new_tokens=24), json_mode=True)
            cut = await handler.generate_response(["Plan the step."], params=GenerationParams(
                temperature=0.0, max_new_tokens=24, stop=[free.content[5:7]]),
                json_mode=True)
        finally:
            await handler.stop()
        return one, long, free, cut

    one, long, free, cut = asyncio.run(main())
    assert one.usage.completion_tokens == 1 and one.finish_reason == "length"
    # Usage reports the prompt as rendered (as the JAX engine does); only
    # its last max_seq - 1 - 8 tokens were prefilled, or the 512-row cache
    # could not have held it.
    assert long.usage.prompt_tokens == 1 + len("<|user|>\n" + "x" * 900 + "\n<|assistant|>\n")
    assert long.usage.completion_tokens >= 1
    assert free.content.startswith(cut.content) and len(cut.content) <= 5


def test_tool_call_parsing_matches_jax():
    from pilottai_tpu.engine.base import parse_tool_calls as jparse
    from pilottai_tpu_torch.engine.base import parse_tool_calls

    replies = [
        '{"tool_call": {"name": "search_notes", "arguments": {"q": "risks"}}}',
        'Sure: {"action": "fetch_report", "arguments": {"name": "q3"}} done',
        '{"action": "respond", "arguments": {}}',
        '```json\n{"tool_call": {"name": 7}}\n```',
        "no json here",
    ]
    names = ["search_notes", "fetch_report"]
    for reply in replies:
        ours = [c.model_dump() for c in parse_tool_calls(reply, names)]
        theirs = [c.model_dump() for c in jparse(reply, names)]
        assert ours == theirs, reply
