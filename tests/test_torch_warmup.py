"""The warm-up sweep (ROADMAP slice A.3a) on the CPU: after ``start()`` the
runner holds exactly the chunk-graph keys the settings reach and serving
adds none; the sweep leaves every counter, estimate and the prefix cache
as a fresh engine has them; greedy ids after it equal the JAX engine's
golden; a failed warm-up makes ``start()`` raise; and the sweep sends the
prompt lengths, each pinned to its chunk bucket, that the JAX batcher's
``warmup`` sends at the same settings. The card's side (captures, no
capture after ``start()``) is ``tests/test_torch_warmup_cuda.py``."""

import asyncio
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.models import registry as jregistry
from pilottai_tpu_torch import PROTOCOL_S_NPZ, LLMConfig, LLMHandler
from pilottai_tpu_torch.engine.batcher import ContinuousBatcher
from pilottai_tpu_torch.engine.graphs import ChunkRunner
from pilottai_tpu_torch.engine.types import ChatMessage, GenerationParams, ToolSpec
from pilottai_tpu_torch.models import registry
from pilottai_tpu_torch.models.loader import ASSETS, load_npz
from pilottai_tpu_torch.ops.kernels import decode_attention as k2
from pilottai_tpu_torch.ops.kernels import flash_attention as k1
from pilottai_tpu_torch.ops.kernels import paged_attention as k3

CPU = torch.device("cpu")
GOLDEN = {"dense": "protocol_s_golden.json", "paged": "protocol_s_paged_golden.json"}
TASK = "<|user|>\nReport {i}: list the findings as JSON.\n<|assistant|>\n"
LONG_TASK = "Section: revenue moved; churn rose. " * 12 + TASK.format(i=9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast and does not
    oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(kind):
    return json.loads((ASSETS / GOLDEN[kind]).read_text())


def _handler(engine, **knobs):
    return LLMHandler(LLMConfig(provider="cpu", model_name="protocol-s",
                                checkpoint_path=PROTOCOL_S_NPZ, **dict(engine, **knobs)))


def _expected_keys(b):
    """The key grid written out from the settings, apart from
    ``reachable_keys``: steps x epilogues x drafts x (pages of the
    128..max_seq ladder on the paged cache, bounds of it under dense
    speculation)."""
    ladder, r = [], 128
    while r < b.max_seq_len:
        ladder.append(r)
        r *= 2
    ladder.append(b.max_seq_len)
    pages, bounds = [None], [None]
    if b.paged:
        pages = sorted({min(-(-r // b.page_size), b.alloc.table.shape[1]) for r in ladder})
    elif b.speculate:
        bounds = ladder
    D = b.speculate
    return {(n, fused, p, D, bound, drafts)
            for n in b.chunk_buckets
            for fused in ((False, True) if b.fused_epilogue else (False,))
            for p in pages for bound in bounds
            for drafts in ((False, True) if b.draft_layers else (False,))}


def _fresh_state(b):
    """What serving reads and a fresh engine has untouched."""
    out = dict(
        blocks=(b.blocks_dispatched, b.blocks_useful, b.blocks_folded),
        spec=(b.spec_tokens, b.spec_blocks, b.draft_blocks, b._spec_rate),
        slot_rate=b._slot_rate.tolist(), draft_on=b._draft_on.tolist(),
        prefix=(b.prefix_lookups, b.prefix_hits, b.prefix_admitted, b.prefix_tokens_saved,
                b.prefix_export_failures),
        segments=b.prefill_segments, completed=list(b.completed),
        draft_replays=b.runner.draft_replays, graphs=b.runner.graphs_captured,
    )
    if b.prefix_store is not None:
        out["store"] = len(b.prefix_store.entries())
    if b.page_index is not None:
        out["pinned"] = b.page_index.pinned_pages
    if b.alloc is not None:
        out["free"] = b.alloc.free_pages
    return out


async def _mixed_wave(handler, segment=False):
    """JSON and plain greedy, sampled, short prompts and (``segment``) one
    that admits in segments on the paged cache."""
    params = [GenerationParams(temperature=0.0, max_new_tokens=30),
              GenerationParams(temperature=0.0, max_new_tokens=20),
              GenerationParams(temperature=0.8, top_k=20, seed=3, max_new_tokens=24),
              GenerationParams(temperature=0.0, max_new_tokens=12)]
    prompts = [TASK.format(i=i) for i in range(3)] + [LONG_TASK if segment else TASK.format(i=3)]
    return await asyncio.gather(*[
        handler.generate_response(p, params=q, json_mode=(i == 0))
        for i, (p, q) in enumerate(zip(prompts, params))])


@pytest.mark.parametrize("kind", list(GOLDEN))
def test_sweep_leaves_a_fresh_engine_with_every_key_and_the_golden_ids(kind):
    """At the golden settings with the prefix cache on (the port's
    default): after ``start()`` the runner holds exactly the reachable
    keys; every counter, estimate, the prefix store or page index and the
    free pages are a fresh engine's, the kernels' launch counts are where
    they were; the golden cases then give the JAX engine's ids, and a
    mixed wave (a segmented prompt on the paged cache) adds no key."""
    golden = _golden(kind)
    engine = dict(golden["engine"], sampling={"temperature": 0.0,
                                              "max_new_tokens": golden["max_new_tokens"]})
    fresh = ContinuousBatcher(registry.get_model_config("protocol-s"), {}, CPU,
                              **_batcher_knobs(engine))
    launches = (k1.launches, k2.launches, k3.launches)

    async def serve():
        handler = _handler(engine)
        await handler.start()
        b = handler.backend.batcher
        try:
            assert b.runner.keys == set(b.reachable_keys()) == _expected_keys(b)
            sweep = b.graph_report()["sweep"]
            assert sweep["keys"] == len(_expected_keys(b)) and sweep["graphs"] == 0
            assert sweep["requests"] == len(b.warmup_prompt_lens()) * len(b.chunk_buckets)
            assert _fresh_state(b) == _fresh_state(fresh)
            assert (k1.launches, k2.launches, k3.launches) == launches
            seen, submit = [], b.submit
            b.submit = lambda req: (seen.append(req), submit(req))[1]
            for case in golden["cases"]:
                p = golden["prompts"][case["prompt"]]
                await handler.generate_response(
                    [ChatMessage(**m) for m in p["messages"]],
                    tools=[ToolSpec(**t) for t in p["tools"]] if p["tools"] else None,
                    json_mode=case["json_mode"])
            assert [r.future.result() for r in seen] == [c["token_ids"] for c in golden["cases"]]
            b.submit = submit
            segments = b.prefill_segments
            replies = await _mixed_wave(handler, segment=b.paged)
            assert len(replies) == 4
            assert b.runner.keys == set(b.reachable_keys())
            if b.paged:
                assert b.prefill_segments > segments
        finally:
            await handler.stop()

    asyncio.run(serve())


def _batcher_knobs(engine):
    """``ContinuousBatcher`` arguments of an engine dict of ``LLMConfig``
    knobs (the ones the golden assets and these tests set)."""
    names = {"engine_slots": "n_slots", "engine_admit_batch": "admit_batch",
             "engine_max_seq": "max_seq_len", "engine_chunk": "chunk_size",
             "engine_paged_kv": "paged", "engine_page_size": "page_size",
             "engine_prefill_chunk": "prefill_chunk", "engine_speculate": "speculate",
             "engine_draft_layers": "draft_layers"}
    return {names[k]: v for k, v in engine.items() if k in names}


def test_model_draft_variants_are_swept_and_serving_adds_no_key():
    """With speculation and draft layers the grid doubles over the draft
    mode; a mixed wave with every slot drafting through the model forms no
    key outside it."""
    engine = dict(_golden("dense")["engine"], engine_speculate=4, engine_draft_layers=2,
                  engine_prefix_cache=0)

    async def serve():
        handler = _handler(engine)
        await handler.start()
        b = handler.backend.batcher
        try:
            assert b.runner.keys == set(b.reachable_keys()) == _expected_keys(b)
            assert len(b.runner.keys) == 4 * 2 * 3 * 2          # steps, epilogues, bounds, drafts
            admit = b._dispatch_prefill

            def admitted(prep):
                admit(prep)
                with b._lock:
                    for idx, _ in prep.group:
                        b._draft_on[idx] = True
                        b._slot_rate[idx] = 1.0

            b._dispatch_prefill = admitted
            await _mixed_wave(handler)
            assert b.draft_blocks > 0
            assert b.runner.keys == set(b.reachable_keys())
        finally:
            await handler.stop()

    asyncio.run(serve())


def test_start_raises_when_a_warm_step_fails(monkeypatch):
    """A capture that fails inside the sweep makes ``start()`` raise, naming
    the key, and leaves no engine serving."""
    warm = ChunkRunner.warm
    calls = []

    def failing(self, key):
        calls.append(key)
        if len(calls) == 3:
            raise RuntimeError("injected")
        warm(self, key)

    monkeypatch.setattr(ChunkRunner, "warm", failing)
    handler = _handler(dict(_golden("dense")["engine"], engine_prefix_cache=0))
    with pytest.raises(RuntimeError, match=r"warm-up of chunk graph \(8, False.*injected"):
        asyncio.run(handler.start())
    assert handler.backend.batcher is None


def test_a_key_the_sweep_did_not_make_raises_on_the_card():
    """On CUDA a dispatch of a key the sweep did not capture raises, naming
    the key: nothing is captured while serving. On the CPU the key's
    buffers are made at its first dispatch and the chunk runs."""
    cfg = registry.get_model_config("protocol-s").replace(dtype=torch.float32)
    b = ContinuousBatcher(cfg, load_npz(PROTOCOL_S_NPZ, cfg, device=CPU), CPU, n_slots=2,
                          max_seq_len=192, chunk_size=8, prefix_cache=0)
    run = b.runner
    key = run.key(8, False)
    run.cuda = True                     # the card's path, up to its first device call
    with pytest.raises(RuntimeError,
                       match=r"chunk graph \(8, False, None, 0, None, False\) was not captured"):
        run.run(8, False)
    assert key not in run.keys
    run.cuda = False
    tokens, valid = run.run(8, False)
    assert key in run.keys and tuple(tokens.shape) == (8, 2)
    assert not bool(valid.any())        # every slot is free


def _jax_params():
    """The shipped checkpoint as the JAX package's tree (bf16 bits, read as
    fp32)."""
    import ml_dtypes

    z = np.load(PROTOCOL_S_NPZ)
    tree = {}
    for key in z.files:
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(z[key].view(ml_dtypes.bfloat16).astype(np.float32))
    return tree


SWEEP_SETTINGS = {
    "dense": dict(max_seq_len=512, chunk_size=16),
    "paged_segments": dict(max_seq_len=512, chunk_size=16, paged=True, page_size=16,
                           prefill_chunk=64),
    "paged_default": dict(max_seq_len=4096, chunk_size=8, paged=True),
    "dense_192": dict(max_seq_len=192, chunk_size=8),
}


@pytest.mark.parametrize("setting", list(SWEEP_SETTINGS))
def test_sweep_sends_the_jax_warmups_prompt_lengths(setting, monkeypatch):
    """Each request the sweep sends, as ``(prompt length, chunk bucket)``,
    in order, equals the JAX batcher's ``warmup`` at the same settings
    (both submits record and resolve at once)."""
    from pilottai_tpu.engine.batcher import ContinuousBatcher as JBatcher

    knobs = dict(SWEEP_SETTINGS[setting], n_slots=2, admit_batch=2, prefix_cache=0)
    jcfg = jregistry.get_model_config("protocol-s").replace(dtype=jnp.float32,
                                                              max_seq_len=knobs["max_seq_len"])
    jb = JBatcher(jcfg, _jax_params(), cache_dtype=jnp.float32, **knobs)
    theirs = []

    def record(b, into):
        def submit(req):
            into.append((len(req.prompt_ids), b._force_chunk))
            req.future.set_result([])
            return req.future
        return submit

    monkeypatch.setattr(jb, "submit", record(jb, theirs))
    jb.warmup()
    cfg = registry.get_model_config("protocol-s").replace(dtype=torch.float32)
    b = ContinuousBatcher(cfg, load_npz(PROTOCOL_S_NPZ, cfg, device=CPU), CPU, **knobs)
    ours = []
    b.submit = record(b, ours)
    b.start()
    try:
        b.warmup()
    finally:
        b.stop()
    assert ours == theirs
    assert b.max_seq_len == jb.max_seq_len and b.chunk_buckets == list(jb.chunk_buckets)
