"""On the card (``cuda``-marked; they skip without one): the warm-up sweep
captures every chunk graph before ``start()`` returns and serving captures
none; a graph captured without its own eager run (every rung but the
first of its group) serves the ids the eager chunks give; replays after
the sweep count one decode-kernel launch per layer per step. This file
imports no JAX, so it runs on a machine without it: ``python -m pytest
--noconftest -p no:cacheprovider -m cuda tests/test_torch_warmup_cuda.py``."""

import asyncio

import pytest
import torch

from pilottai_tpu_torch import PROTOCOL_S_NPZ, LLMConfig, LLMHandler
from pilottai_tpu_torch.engine.batcher import ContinuousBatcher, GenRequest
from pilottai_tpu_torch.engine.tokenizer import ByteTokenizer
from pilottai_tpu_torch.engine.types import GenerationParams
from pilottai_tpu_torch.models import registry
from pilottai_tpu_torch.models.loader import load_npz
from pilottai_tpu_torch.ops.kernels import decode_attention as k2
from pilottai_tpu_torch.ops.kernels import paged_attention as k3

EOS = ByteTokenizer().eos_id
TASK = "<|user|>\nReport {i}: list the findings as JSON.\n<|assistant|>\n"
ENGINES = {
    "dense": dict(engine_max_seq=512),
    "paged": dict(engine_max_seq=512, engine_paged_kv=True, engine_page_size=16,
                  engine_prefill_chunk=64),
    "drafts": dict(engine_max_seq=512, engine_speculate=4, engine_draft_layers=2),
}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chunk graphs are captured on the card")
    return torch.device("cuda", torch.cuda.current_device())


def _draft_from_the_model(batcher):
    """Every admitted slot drafts through the model (the hysteresis alone
    rarely switches one on protocol-s)."""
    admit = batcher._dispatch_prefill

    def admitted(prep):
        admit(prep)
        with batcher._lock:
            for idx, _ in prep.group:
                batcher._draft_on[idx] = True
                batcher._slot_rate[idx] = 1.0

    batcher._dispatch_prefill = admitted


@pytest.mark.cuda
@pytest.mark.parametrize("engine", list(ENGINES))
def test_cuda_no_capture_after_start_over_a_served_wave(engine):
    """``start()`` captures the reachable key set; a mixed wave (JSON and
    plain greedy, sampled, short prompts and one that segments on the
    paged cache, model drafts forced under speculation) captures
    nothing more."""
    _device()

    async def serve():
        handler = LLMHandler(LLMConfig(
            provider="cuda", model_name="protocol-s", checkpoint_path=PROTOCOL_S_NPZ,
            dtype="float32", engine_slots=4, engine_admit_batch=4, engine_chunk=16,
            engine_prefix_cache=0, **ENGINES[engine]))
        await handler.start()
        b = handler.backend.batcher
        try:
            sweep = b.graph_report()["sweep"]
            assert sweep["graphs"] == len(b.reachable_keys()) == len(b.runner.keys)
            if engine == "drafts":
                _draft_from_the_model(b)
            long_task = "Section: revenue moved; churn rose. " * 12 + TASK.format(i=9)
            params = [GenerationParams(temperature=0.0, max_new_tokens=40),
                      GenerationParams(temperature=0.0, max_new_tokens=24),
                      GenerationParams(temperature=0.8, top_k=20, seed=3, max_new_tokens=30),
                      GenerationParams(temperature=0.0, max_new_tokens=12)]
            prompts = [TASK.format(i=i) for i in range(3)] + [long_task]
            replies = await asyncio.gather(*[
                handler.generate_response(p, params=q, json_mode=(i == 0))
                for i, (p, q) in enumerate(zip(prompts, params))])
            assert all(r.content is not None for r in replies)
            rep = b.graph_report()
            assert rep["graphs"] == 0 and rep["capture_s"] == 0.0
            assert b.runner.keys == set(b.reachable_keys())
            if engine == "paged":
                assert b.prefill_segments > 0
            if engine == "drafts":
                assert rep["draft_replays"] > 0
        finally:
            await handler.stop()

    asyncio.run(serve())


def _batcher(dev, **knobs):
    cfg = registry.get_model_config("protocol-s").replace(dtype=torch.float32)
    return ContinuousBatcher(cfg, load_npz(PROTOCOL_S_NPZ, cfg, device=dev), dev, n_slots=4,
                             admit_batch=4, max_seq_len=512, chunk_size=8, prefix_cache=0,
                             **knobs)


def _serve(b, warm):
    """Requests whose prefixes cross the prefix-bound rungs (128, 256,
    512) in one run, greedy."""
    tok = ByteTokenizer()
    b.start()
    try:
        if warm:
            b.warmup()
        out = []
        for i, n in enumerate((40, 150, 300)):
            prompt = ("Section: revenue moved; churn rose. " * (n // 36 + 1))[:n] + TASK.format(i=i)
            req = GenRequest(prompt_ids=tok.encode(prompt), max_new_tokens=48, eos_id=EOS)
            b.submit(req)
            out.append(req.future.result(timeout=300))
    finally:
        b.stop()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [dict(), dict(paged=True, page_size=16),
                                   dict(speculate=4)], ids=["dense", "paged", "spec"])
def test_cuda_graphs_captured_without_their_eager_run_serve_as_eager_chunks(knobs):
    """After the sweep every dispatch replays a graph, most of them
    captured without an eager run of their own (one eager chunk a (steps,
    fused, D, drafts) group): the greedy ids equal the eager chunks'."""
    dev = _device()
    warmed = _batcher(dev, **knobs)
    replayed = _serve(warmed, warm=True)
    sweep = warmed.graph_report()["sweep"]
    assert warmed.graph_report()["graphs"] == 0
    assert sweep["graphs"] == len(warmed.reachable_keys())
    eager = _batcher(dev, **knobs)
    eager.runner.cuda = False                 # the same chunks, eagerly on the card
    assert replayed == _serve(eager, warm=False)
    assert all(len(ids) > 0 for ids in replayed)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cuda_replays_after_the_sweep_count_their_launches(paged):
    """After the sweep (its step counters reset, the kernels' counts set
    to zero here) the served requests' replays add one K2 (dense) or K3
    (paged) launch per layer per step dispatched, and none of the
    other."""
    dev = _device()
    b = _batcher(dev, paged=paged, page_size=16)
    mine, other = (k3, k2) if paged else (k2, k3)
    b.start()
    try:
        b.warmup()
        assert b.blocks_dispatched == b.blocks_folded == 0
        mine.launches = other.launches = 0
        reqs = [GenRequest(prompt_ids=ByteTokenizer().encode(TASK.format(i=i)),
                           max_new_tokens=30 + 7 * i, eos_id=-1) for i in range(3)]
        for r in reqs:
            b.submit(r)
        assert [len(r.future.result(timeout=300)) for r in reqs] == [30, 37, 44]
        b._wait_idle()
    finally:
        b.stop()
    assert b.blocks_dispatched > 0 and b.graph_report()["graphs"] == 0
    assert mine.launches == b.cfg.n_layers * b.blocks_dispatched
    assert other.launches == 0
