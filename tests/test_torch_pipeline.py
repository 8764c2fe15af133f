"""The port's decode pipeline (ROADMAP slice P6a) on the CPU: the
capturable chunk against the early-exit chunk it replaces, with no host
sync inside it; greedy ids byte-identical across the five pipeline knobs,
dense and paged; the golden ids at the serial settings; the adaptive
policy's chunk utilization. The ``cuda``-marked tests hold the captured
graphs on the card (same-seed sampling through replays, launch counts per
replay) and skip here."""

import asyncio
import copy
import json

import numpy as np
import pytest
import torch

from pilottai_tpu_torch import PROTOCOL_S_NPZ, LLMConfig, LLMHandler
from pilottai_tpu_torch.engine import decode, sampling
from pilottai_tpu_torch.engine.batcher import ContinuousBatcher, GenRequest
from pilottai_tpu_torch.engine.tokenizer import ByteTokenizer
from pilottai_tpu_torch.engine.types import ChatMessage, ToolSpec
from pilottai_tpu_torch.models.loader import ASSETS, load_npz
from pilottai_tpu_torch.models.registry import get_model_config
from pilottai_tpu_torch.ops import paged
from pilottai_tpu_torch.ops.kvcache import KVCache

CPU = torch.device("cpu")
EOS = ByteTokenizer().eos_id
PROMPTS = [
    "<|user|>\nList the findings of report 7 as JSON.\n<|assistant|>\n",
    "<|system|>\nYou are a planner.\n<|user|>\nDecompose: audit invoice 12.\n<|assistant|>\n",
    "<|user|>\nValidate the extracted sections.\n<|assistant|>\n",
    "<|user|>\nSummarize the churn table.\n<|assistant|>\n",
]
# (prompt, max_new_tokens, json_mode): staggered budgets, so slots finish
# mid-chunk at different steps, and one slot under the JSON grammar mask;
# six requests on four slots, so slots change hands while chunks are in
# flight.
REQS = [(0, 5, False), (1, 19, False), (2, 40, True), (3, 2, False), (1, 11, False),
        (0, 27, False)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast and does not
    oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = get_model_config("protocol-s").replace(dtype=torch.float32)
    return cfg, load_npz(PROTOCOL_S_NPZ, cfg, device=CPU)


# --------------------------------------------------------------------- #
# The capturable chunk
# --------------------------------------------------------------------- #

def _write_chunk_rows_nonzero(cache, ring_ks, ring_vs, start, accepted):
    """The dense chunk-end write before it was made capturable: a host
    filter of the kept rows (``torch.nonzero``)."""
    n = ring_ks[0].shape[2]
    j = torch.arange(n)[None, :]
    b_idx, j_idx = torch.nonzero(j < accepted[:, None], as_tuple=True)
    pos = start[b_idx].long() + j_idx
    for (k, v), rk, rv in zip(cache.layers, ring_ks, ring_vs):
        k[b_idx, :, pos] = rk[b_idx, :, j_idx].to(k.dtype)
        v[b_idx, :, pos] = rv[b_idx, :, j_idx].to(v.dtype)
    cache.lengths.copy_(torch.clamp(cache.lengths + accepted, max=cache.max_len))


def _early_exit_chunk(params, cfg, cache, dstate, samp, n_steps, table=None, n_blocks=None):
    """The eager chunk the capturable one replaces: a Python loop that
    reads ``done`` back every step and stops once every slot is done."""
    B = dstate.tokens.shape[0]
    is_paged = table is not None
    S = table.shape[1] * cache.page_size if is_paged else cache.max_len
    start = cache.lengths.clone()
    rings = decode.new_rings(cfg, B, n_steps, cache.layers[0][0].dtype, CPU)
    tokens, done, budget = dstate.tokens.clone(), dstate.done.clone(), dstate.budget.clone()
    offset = torch.zeros((B,), dtype=torch.int32)
    out_t = torch.zeros((n_steps, B), dtype=torch.int32)
    out_v = torch.zeros((n_steps, B), dtype=torch.bool)
    for i in range(n_steps):
        if bool(done.all()):
            break
        active = ~done
        pos = start + offset
        logits = decode.decode_step_logits(params, cfg, cache, tokens, pos, start - 1, rings, i,
                                           table=table, n_blocks=n_blocks)
        sampled, samp = sampling.sample_core(logits, samp, json_remaining=budget)
        act = active.to(torch.int32)
        budget = budget - act
        hit_eos = (samp.eos_id >= 0) & (sampled == samp.eos_id)
        done = done | (active & (hit_eos | (budget <= 0) | ((pos + 1) >= (S - 1))))
        tokens = torch.where(active, sampled, tokens)
        offset = offset + act
        out_t[i] = sampled
        out_v[i] = active
    ring_ks, ring_vs = [r[0] for r in rings], [r[1] for r in rings]
    if is_paged:
        paged.write_chunk_rows_paged(cache, table, ring_ks, ring_vs, start, offset)
    else:
        _write_chunk_rows_nonzero(cache, ring_ks, ring_vs, start, offset)
    dstate.tokens, dstate.done, dstate.budget = tokens, done, budget
    return out_t, out_v


def _admitted(cfg, params, is_paged, max_seq=160):
    """Four slots after one admission: budgets 3, 9, 21 and 40 decode
    tokens; slot 2 decodes under the JSON mask."""
    tok = ByteTokenizer()
    ids = [tok.encode(p) for p in PROMPTS]
    A, T, B = 4, 128, 4
    tokens = np.zeros((A, T), np.int64)
    for row, p in enumerate(ids):
        tokens[row, : len(p)] = p
    mi, mf = decode.pack_admit_meta(
        A, slots=[0, 1, 2, 3], seeds=[1, 2, 3, 4], eos=[EOS] * 4,
        jsonm=[False, False, True, False], budgets=[3, 9, 21, 40],
        lens=[len(p) for p in ids], pad_slot=B)
    table = rows = None
    if is_paged:
        P = 16
        alloc = paged.PageAllocator(4 * max_seq // P + 1, P, B, max_seq // P)
        for slot in range(B):
            assert alloc.allocate(slot, max_seq)
        table = torch.from_numpy(alloc.table.copy())
        rows = alloc.table.copy()
        cache = paged.PagedKVCache.create(cfg.n_layers, B, alloc.num_pages, P, cfg.n_kv_heads,
                                          cfg.head_dim, torch.float32, CPU)
    else:
        cache = KVCache.create(cfg.n_layers, B, max_seq, cfg.n_kv_heads, cfg.head_dim,
                               dtype=torch.float32, device=CPU)
    cache, dstate, samp, _ = decode.admit_group(
        params, cfg, cache, decode.DecodeState.create(B, CPU),
        sampling.SamplingState.create(B, CPU), tokens, mi, mf, page_rows=rows)
    return cache, dstate, samp, table


def _state_copy(cache, dstate, samp):
    gens = samp.generators
    samp.generators = []
    out = copy.deepcopy((cache, dstate, samp))
    samp.generators = gens
    out[2].generators = [torch.Generator().set_state(g.get_state()) for g in gens]
    return out


@pytest.mark.parametrize("is_paged", [False, True], ids=["dense", "paged"])
def test_capturable_chunk_matches_the_early_exit_chunk(model, is_paged):
    """Every step run, no host read: the same tokens, valid flags, cache
    bytes, lengths and decode and JSON states as the early-exit loop, over
    chunks in which slots finish mid-chunk and the last chunks run with
    every slot done."""
    cfg, params = model
    cache, dstate, samp, table = _admitted(cfg, params, is_paged)
    ref = _state_copy(cache, dstate, samp)
    n_blocks = table.shape[1] if is_paged else None
    bufs = decode.ChunkBuffers.create(cfg, 4, 8, torch.float32, CPU)
    finished_mid_chunk = False
    for _ in range(7):                       # 56 steps: every slot finishes
        t, v, *_ = decode.decode_chunk(params, cfg, cache, dstate, samp, 8, table=table,
                                       n_blocks=n_blocks, bufs=bufs)
        rt, rv = _early_exit_chunk(params, cfg, *ref, 8, table=table, n_blocks=n_blocks)
        np.testing.assert_array_equal(v.numpy(), rv.numpy())
        np.testing.assert_array_equal(np.where(v.numpy(), t.numpy(), -1),
                                      np.where(rv.numpy(), rt.numpy(), -1))
        finished_mid_chunk |= bool((rv.any(0) & ~rv.all(0)).any())
        for name in ("tokens", "done", "budget"):
            assert torch.equal(getattr(dstate, name), getattr(ref[1], name)), name
        for name in ("json_state", "json_stack", "json_depth"):
            assert torch.equal(getattr(samp, name), getattr(ref[2], name)), name
        assert torch.equal(cache.lengths, ref[0].lengths)
        for (k, v_), (rk, rv_) in zip(cache.layers, ref[0].layers):
            if is_paged:
                # Dropped rows land on the scratch page, whose bytes are
                # never attended: only the pages a slot can own compare.
                k, v_, rk, rv_ = (a[:, :-1] for a in (k, v_, rk, rv_))
                assert bool(torch.isfinite(cache.layers[0][0][:, -1]).all())
            assert torch.equal(k, rk) and torch.equal(v_, rv_)
    assert finished_mid_chunk and bool(dstate.done.all())
    assert bool(samp.json_enabled[2]) and int(samp.json_state[2]) != 0


def test_dense_chunk_end_write_drops_rows_past_the_panel():
    """Rows that would land past the panel are dropped without touching a
    kept row, even where their wrapped positions meet the kept ones."""
    S, n = 12, 5
    cache = KVCache.create(1, 2, S, 1, 4, dtype=torch.float32, device=CPU)
    cache.layers[0][0].copy_(torch.arange(2 * S * 4, dtype=torch.float32).reshape(2, 1, S, 4))
    before = cache.layers[0][0].clone()
    ring = torch.full((2, 1, n, 4), -1.0)
    ring[:, :, :, 0] = torch.arange(n, dtype=torch.float32)
    start = torch.tensor([9, 2], dtype=torch.int32)
    accepted = torch.tensor([3, 2], dtype=torch.int32)   # slot 0: rows 0-2 at 9, 10, 11
    from pilottai_tpu_torch.ops.kvcache import write_chunk_rows

    write_chunk_rows(cache, [ring], [ring.clone()], start, accepted)
    want = before.clone()
    want[0, :, 9:12] = ring[0, :, :3]
    want[1, :, 2:4] = ring[1, :, :2]
    assert torch.equal(cache.layers[0][0], want)
    assert cache.lengths.tolist() == [3, 2]


@pytest.mark.parametrize("fused", [False, True], ids=["sampler", "fused"])
@pytest.mark.parametrize("is_paged", [False, True], ids=["dense", "paged"])
def test_capturable_chunk_makes_no_host_read(model, is_paged, fused, monkeypatch):
    """Inside the chunk nothing reads the device back or makes a shape
    from data: the host-read entry points raise while it runs."""
    cfg, params = model
    cache, dstate, samp, table = _admitted(cfg, params, is_paged)
    if fused:
        samp.json_enabled.zero_()

    def refuse(*_a, **_k):
        raise AssertionError("host read inside the decode chunk")

    for name in ("item", "__bool__", "cpu", "tolist", "numpy", "__int__", "__float__",
                 "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    t, v, *_ = decode.decode_chunk(params, cfg, cache, dstate, samp, 8, table=table,
                                   n_blocks=table.shape[1] if is_paged else None,
                                   fused_epilogue=fused)
    monkeypatch.undo()
    assert v.shape == (8, 4) and bool(v[0].all())


# --------------------------------------------------------------------- #
# The batcher across the five knobs
# --------------------------------------------------------------------- #

SERIAL = dict(pipeline_depth=1, overlap_admission=False, chunk_policy="fixed",
              fused_epilogue=False)
KNOBS = {
    "adaptive": dict(chunk_policy="adaptive", chunk_buckets=(2, 4, 8)),
    "overlap": dict(overlap_admission=True),
    "pipeline2": dict(pipeline_depth=2),
    "fused": dict(fused_epilogue=True),
    "defaults": dict(pipeline_depth=2, overlap_admission=True, chunk_policy="adaptive",
                     fused_epilogue=True),
}


def _run_batch(cfg, params, is_paged, knobs, reqs=REQS, json_ok=True):
    b = ContinuousBatcher(cfg, params, CPU, n_slots=4, admit_batch=4, max_seq_len=192,
                          chunk_size=8, paged=is_paged, page_size=16, prefix_cache=0, **knobs)
    tok = ByteTokenizer()
    # Submitted before the threads start, so admission groups are the
    # same run to run.
    out = [b.submit(GenRequest(prompt_ids=tok.encode(PROMPTS[p]), max_new_tokens=n,
                               eos_id=EOS, json_mode=j and json_ok))
           for p, n, j in reqs]
    b.start()
    try:
        ids = [f.result(timeout=300) for f in out]
    finally:
        b.stop()
    if b.alloc is not None:
        assert b.alloc.free_pages == b.num_pages - 1
    return ids, b


_serial_runs = {}


def _serial(model, is_paged, json_ok=True):
    key = (is_paged, json_ok)
    if key not in _serial_runs:
        _serial_runs[key] = _run_batch(*model, is_paged, SERIAL, json_ok=json_ok)[0]
    return _serial_runs[key]


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("is_paged", [False, True], ids=["dense", "paged"])
def test_greedy_ids_identical_across_the_knobs(model, is_paged, knob):
    """Each knob of the pipeline, alone and all at the defaults, against
    the serial path (one chunk in flight, inline admission, fixed chunks,
    the sampler): the same greedy ids, with staggered budgets, a JSON slot
    and slots changing hands."""
    ids, b = _run_batch(*model, is_paged, dict(SERIAL, **KNOBS[knob]))
    assert ids == _serial(model, is_paged)
    assert len(ids[3]) <= 2 and sum(map(len, ids)) > 60
    if knob == "fused":
        # The JSON slot keeps the sampler while it is occupied: run the
        # all-greedy mix too, where every chunk takes the epilogue.
        plain, _ = _run_batch(*model, is_paged, dict(SERIAL, **KNOBS[knob]), json_ok=False)
        assert plain == _serial(model, is_paged, json_ok=False)


def test_adaptive_chunks_raise_utilization(model):
    """Half the slots finish in the first step: adaptive chunks waste fewer
    dispatched steps than fixed ones."""
    reqs = [(0, 2, False), (1, 2, False), (2, 6, False), (3, 6, False)]
    util = {}
    for policy, buckets in (("fixed", None), ("adaptive", (2, 4, 8))):
        _, b = _run_batch(*model, False, dict(SERIAL, chunk_policy=policy,
                                              chunk_buckets=buckets), reqs=reqs)
        assert 0 < b.blocks_useful <= b.blocks_dispatched
        util[policy] = b.blocks_useful / b.blocks_dispatched
    assert util["adaptive"] > util["fixed"]


def test_chunk_buckets_are_validated_and_keep_the_full_chunk(model):
    cfg, params = model
    kw = dict(n_slots=2, max_seq_len=64, chunk_size=8)
    assert ContinuousBatcher(cfg, params, CPU, **kw).chunk_buckets == [2, 4, 6, 8]
    assert ContinuousBatcher(cfg, params, CPU, chunk_buckets=(3,), **kw).chunk_buckets == [3, 8]
    assert ContinuousBatcher(cfg, params, CPU, chunk_policy="fixed", **kw).chunk_buckets == [8]
    with pytest.raises(ValueError, match=r"\[9\]"):
        ContinuousBatcher(cfg, params, CPU, chunk_buckets=(4, 9), **kw)
    with pytest.raises(ValueError, match="chunk_policy"):
        ContinuousBatcher(cfg, params, CPU, chunk_policy="greedy", **kw)


@pytest.mark.parametrize("asset", ["protocol_s_golden.json", "protocol_s_paged_golden.json"],
                         ids=["dense", "paged"])
def test_golden_ids_at_the_serial_settings(asset):
    """The handler with every pipeline knob off still serves the JAX
    engine's golden ids (the defaults are held by the engine tests)."""
    golden = json.loads((ASSETS / asset).read_text())

    async def serve():
        handler = LLMHandler(LLMConfig(
            provider="cpu", model_name="protocol-s", checkpoint_path=PROTOCOL_S_NPZ,
            sampling={"temperature": 0.0, "max_new_tokens": golden["max_new_tokens"]},
            engine_pipeline=1, engine_overlap_admission=False, engine_chunk_policy="fixed",
            engine_fused_epilogue=False, engine_prefix_cache=0, **golden["engine"]))
        out = []
        try:
            for case in golden["cases"]:
                p = golden["prompts"][case["prompt"]]
                r = await handler.generate_response(
                    [ChatMessage(**m) for m in p["messages"]],
                    tools=[ToolSpec(**t) for t in p["tools"]] if p["tools"] else None,
                    json_mode=case["json_mode"])
                out.append(r.content)
        finally:
            await handler.stop()
        return out

    assert asyncio.run(serve()) == [c["text"] for c in golden["cases"]]


# --------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------- #

def _cuda_batcher(model, **knobs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chunk graphs are captured on the card")
    cfg, params = model
    dev = torch.device("cuda", torch.cuda.current_device())
    return ContinuousBatcher(cfg, {k: _to(v, dev) for k, v in params.items()}, dev,
                             n_slots=4, admit_batch=4, max_seq_len=192, chunk_size=8,
                             prefix_cache=0, **knobs)


def _to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return [_to(v, dev) for v in tree]


@pytest.mark.cuda
def test_cuda_replays_sample_as_eager_steps_do(model):
    """Same seed, same tokens: a sampled request served through chunk
    graphs (captured by the warm-up sweep, replayed by both requests)
    equals the same request through eager chunks."""
    tok = ByteTokenizer()

    def sampled(b):
        reqs = [GenRequest(prompt_ids=tok.encode(PROMPTS[1]), max_new_tokens=24,
                           temperature=0.9, top_k=40, top_p=0.95, seed=7, eos_id=-1)
                for _ in range(2)]
        b.start()
        try:
            b.warmup()
            out = []
            for r in reqs:
                b.submit(r)
                out.append(r.future.result(timeout=300))
        finally:
            b.stop()
        return out

    graphs = _cuda_batcher(model, chunk_policy="fixed")
    replayed = sampled(graphs)
    assert graphs.sweep["graphs"] >= 1 and graphs.graph_report()["graphs"] == 0
    eager = _cuda_batcher(model, chunk_policy="fixed")
    eager.runner.cuda = False                 # the same chunks, eagerly on the card
    assert replayed == sampled(eager)
    assert replayed[0] == replayed[1] and len(replayed[0]) == 24


@pytest.mark.cuda
def test_cuda_replay_adds_its_launches(model):
    """K2 counts one launch per layer per step dispatched by the replays
    of the graphs the warm-up sweep captured; K3 none on the dense
    cache."""
    from pilottai_tpu_torch.ops.kernels import decode_attention as k2
    from pilottai_tpu_torch.ops.kernels import paged_attention as k3

    b = _cuda_batcher(model, chunk_policy="fixed")
    b.start()
    try:
        b.warmup()
        k2.launches = k3.launches = 0
        f = b.submit(GenRequest(prompt_ids=ByteTokenizer().encode(PROMPTS[0]),
                                max_new_tokens=40, eos_id=-1))
        assert len(f.result(timeout=300)) == 40
    finally:
        b.stop()
    assert b.sweep["graphs"] == len(b.reachable_keys()) and b.graph_report()["graphs"] == 0
    assert b.blocks_dispatched >= 5 * 8
    assert k2.launches == model[0].n_layers * b.blocks_dispatched
    assert k3.launches == 0
