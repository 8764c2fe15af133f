"""In-flight recovery (ROADMAP P6b, the fault domain) on the CPU, held to the
JAX batcher: a fault injected into the port's batcher re-admits every
occupant after an in-place rebuild of the device state, and the greedy
ids equal the JAX batcher's uninjected run — dense, paged with a fault
inside a segmented prefill, and under ``speculate=4``. Also the port's
counterpart of ``tests/test_chaos.py``'s replay-and-stream test (ROADMAP
C.3), armed by ``skip=`` so that it cannot race the request's end, the
JSON rule, the strike limits, the leak check of a failed prefill, the
tensors a captured graph reads kept at their addresses across a rebuild,
and the degrade rungs' dispatches among the reachable graph keys.

Weights: llama-tiny from the JAX ``init_params`` in fp32, the embedding
times 1 / hidden and wq, wk times 4 (as ``scripts/export_gemma_golden.py``
draws its models: unscaled, a random tiny model repeats its last prompt
token, and the ids would pin nothing), carried across by
``params_from_numpy``. Token ids are compared exactly."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu_torch.engine.batcher import ContinuousBatcher, GenRequest
from pilottai_tpu_torch.models.loader import params_from_numpy
from pilottai_tpu_torch.models.registry import get_model_config
from pilottai_tpu_torch.reliability import global_engine_health, global_injector
from pilottai_tpu_torch.reliability.degrade import DegradeLadder
from pilottai_tpu_torch.utils.metrics import global_metrics

CPU = torch.device("cpu")
WAIT = 120           # seconds any future is waited for
PROMPTS = [[3, 4, 5, 9, 11], [6, 7, 100, 42], [200, 13, 77], [8] * 20]
NEW = 40
# A paged prompt of 150 tokens passes 2 x prefill_chunk (32): it admits in
# segments, the last of them through the admission prefill.
LONG = [(7 * i + 3) % 500 + 1 for i in range(150)]
# Port ContinuousBatcher / JAX ContinuousBatcher keyword arguments.
CONFIGS = {
    "dense": dict(max_seq_len=128),
    "paged": dict(max_seq_len=256, paged=True, page_size=16, prefill_chunk=32),
    "spec": dict(max_seq_len=128, speculate=4),
}
# The port's batchers also run one chunk in flight and fixed chunks (of at
# most 8 tokens a slot under speculation): a fault armed by ``skip=3`` then
# lands on the fourth dispatch, after the first chunk has folded (the third
# dispatch waits for the reader to take the second chunk, which it takes
# once the first has folded) and before any request of the first pair
# could end. Greedy ids do not depend on the chunking.
PORT_KNOBS = {
    "dense": dict(pipeline_depth=1, chunk_policy="fixed", chunk_size=8),
    "paged": dict(pipeline_depth=1, chunk_policy="fixed", chunk_size=8),
    "spec": dict(pipeline_depth=1, chunk_policy="fixed", chunk_size=2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_injector():
    global_injector.reset()
    global_engine_health.reset()
    yield
    global_injector.reset()
    global_engine_health.reset()


@pytest.fixture(scope="module")
def weights():
    from pilottai_tpu.models.common import init_params
    from pilottai_tpu.models.registry import get_model_config as jax_config

    jcfg = jax_config("llama-tiny")
    tree = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    tree["embed"] = tree["embed"] * np.float32(1.0 / jcfg.hidden_size)
    for name in ("wq", "wk"):
        tree["layers"]["attn"][name] = tree["layers"]["attn"][name] * np.float32(4.0)
    cfg = get_model_config("llama-tiny").replace(dtype=torch.float32)
    return jcfg, tree, cfg


@pytest.fixture(scope="module")
def jax_reference(weights):
    """The JAX batcher's uninjected greedy ids, per config, made at first
    use: PROMPTS (and, paged, LONG first)."""
    from pilottai_tpu.engine.batcher import ContinuousBatcher as JaxBatcher
    from pilottai_tpu.engine.batcher import GenRequest as JaxRequest

    jcfg, tree, _ = weights
    cache = {}

    def get(name):
        if name not in cache:
            b = JaxBatcher(jcfg, jax.tree.map(jnp.asarray, tree), n_slots=2,
                           cache_dtype=jnp.float32, **CONFIGS[name])
            b.start()
            try:
                futs = [b.submit(JaxRequest(prompt_ids=list(p), max_new_tokens=NEW))
                        for p in _prompts(name)]
                cache[name] = [f.result(timeout=WAIT) for f in futs]
            finally:
                b.stop()
        return cache[name]

    return get


def _prompts(name):
    return ([LONG] if name == "paged" else []) + PROMPTS


def _batcher(weights, name, **kw):
    _, tree, cfg = weights
    knobs = dict(n_slots=2, **CONFIGS[name], **PORT_KNOBS[name])
    knobs.update(kw)
    return ContinuousBatcher(cfg, params_from_numpy(tree, cfg, device=CPU), CPU, **knobs)


def _segments(n_tokens, chunk=32):
    """The chunked-prefill segments before the final one of a prompt."""
    n = 0
    while n_tokens - n * chunk > chunk:
        n += 1
    return n


def _serve(b, prompts, **req):
    reqs = [GenRequest(prompt_ids=list(p), max_new_tokens=NEW, **req) for p in prompts]
    futs = [b.submit(r) for r in reqs]
    return reqs, [f.result(timeout=WAIT) for f in futs]


def _counters():
    names = ("engine.rebuilds", "engine.rebuilds.device_loop_error", "engine.recovered_requests",
             "engine.tokens_replayed", "engine.recovery_requeued", "engine.recovery_failed")
    return {n: global_metrics.get(n) for n in names}


def _moved(before):
    return {n: global_metrics.get(n) - v for n, v in before.items()}


# --------------------------------------------------------------------- #
# Recovery against the JAX batcher's uninjected run
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["dense", "paged", "spec"])
def test_recovered_greedy_ids_equal_the_uninjected_jax_run(weights, jax_reference, name):
    """``engine.step`` fails the fourth dispatch, with chunks in flight and
    tokens folded: every occupant re-admits with prompt + generated after
    one rebuild, and every request's ids are the JAX batcher's."""
    want = jax_reference(name)
    b = _batcher(weights, name)
    before = _counters()
    global_injector.arm("engine.step", RuntimeError("injected device failure"), times=1, skip=3)
    b.start()
    try:
        reqs, got = _serve(b, _prompts(name))
    finally:
        b.stop()
    assert got == want
    assert global_injector.fired("engine.step") == 1
    moved = _moved(before)
    assert moved["engine.rebuilds"] == moved["engine.rebuilds.device_loop_error"] == 1
    recovered = [r for r in reqs if r.recovery_attempts]
    assert recovered and all(r.recovery_attempts == 1 for r in recovered)
    assert moved["engine.recovered_requests"] == moved["engine.recovery_requeued"] \
        == len(recovered)
    # With one chunk in flight, the fourth dispatch comes after the first
    # chunk has folded: its tokens are replayed, not sampled again.
    assert moved["engine.tokens_replayed"] == sum(len(r.recovered_tokens) for r in reqs) > 0
    assert moved["engine.recovery_failed"] == 0
    for r, ids in zip(reqs, got):
        assert ids[: len(r.recovered_tokens)] == r.recovered_tokens
    assert b.graph_report()["rebuild_s"] is not None


def test_fault_in_a_segmented_prefill_recovers(weights, jax_reference):
    """Paged: the long prompt's admission prefill (its last segment, after
    the earlier segments wrote their pages) fails through
    ``engine.prefill``. The request re-admits from scratch, segments again,
    and its ids are the JAX batcher's; no page or reservation leaks."""
    want = jax_reference("paged")[0]
    b = _batcher(weights, "paged")
    before = global_metrics.get("engine.recovery_requeued")
    global_injector.arm("engine.prefill", RuntimeError("injected prefill fault"), times=1)
    b.start()
    try:
        (req,), (got,) = _serve(b, [LONG])
        segments = b.prefill_segments
    finally:
        b.stop()
    assert got == want
    assert req.recovery_attempts == 1 and req.recovered_tokens == []
    assert global_metrics.get("engine.recovery_requeued") == before + 1
    assert segments == 2 * _segments(len(LONG))        # both admissions segmented
    assert b._prep_reserved == set()
    assert b.alloc.free_pages + b.page_index.pinned_pages == b.num_pages - 1


# --------------------------------------------------------------------- #
# Streaming across a fault (the port's counterpart of ROADMAP C.3)
# --------------------------------------------------------------------- #

def test_recovery_replays_folded_tokens_and_streams_without_duplicates(weights,
                                                                      jax_reference):
    """One slot, one chunk in flight, fixed chunks of 8: the fault is armed
    before the request by ``skip=3``, so it lands on the fourth dispatch,
    after the first chunk's tokens have folded and streamed and well before
    the 40th token. The stream equals the result (nothing duplicated or
    lost), the folded tokens were replayed, and the ids are the JAX
    batcher's."""
    want = jax_reference("dense")[0]
    b = _batcher(weights, "dense", n_slots=1)
    streamed = []
    before = global_metrics.get("engine.tokens_replayed")
    global_injector.arm("engine.step", RuntimeError("mid-decode device failure"), times=1,
                        skip=3)
    b.start()
    try:
        req = GenRequest(prompt_ids=list(PROMPTS[0]), max_new_tokens=NEW,
                         on_tokens=streamed.extend)
        out = b.submit(req).result(timeout=WAIT)
    finally:
        b.stop()
    assert out == want
    assert streamed == out
    assert req.recovery_attempts == 1
    assert 9 <= len(req.recovered_tokens) < NEW
    assert global_metrics.get("engine.tokens_replayed") - before == len(req.recovered_tokens)


# --------------------------------------------------------------------- #
# The JSON rule
# --------------------------------------------------------------------- #

def _json_run(weights, stream, arm):
    b = _batcher(weights, "dense", n_slots=1)
    streamed = []
    if arm:
        global_injector.arm("engine.step", RuntimeError("json device failure"), times=1, skip=3)
    b.start()
    try:
        req = GenRequest(prompt_ids=list(PROMPTS[1]), max_new_tokens=NEW, json_mode=True,
                         on_tokens=streamed.extend if stream else None)
        fut = b.submit(req)
        try:
            return req, fut.result(timeout=WAIT), streamed
        except Exception as exc:  # noqa: BLE001 — the caller looks at it
            return req, exc, streamed
    finally:
        b.stop()


def test_json_rule_streamed_fails_unstreamed_restarts_with_identical_ids(weights):
    _, clean, _ = _json_run(weights, stream=False, arm=False)
    assert isinstance(clean, list) and chr(clean[0]) in "{["     # under the JSON grammar
    # Not streamed: the whole generation restarts from the prompt (the
    # grammar's state follows the position after the prompt).
    req, got, _ = _json_run(weights, stream=False, arm=True)
    assert got == clean
    assert req.recovery_attempts == 1 and req.recovered_tokens == []
    # Streamed: neither a splice nor a restart is possible once the
    # consumer saw tokens, so it fails with the original exception.
    req, got, streamed = _json_run(weights, stream=True, arm=True)
    assert isinstance(got, RuntimeError) and "json device failure" in str(got)
    assert streamed and streamed == clean[: len(streamed)]


# --------------------------------------------------------------------- #
# Strike limits and leaks
# --------------------------------------------------------------------- #

def test_strikes_exhausted_fail_with_the_original_exception(weights):
    b = _batcher(weights, "dense", recovery_max_attempts=2)
    before = global_metrics.get("engine.recovery_failed")
    b.start()
    try:
        global_injector.arm("engine.step", RuntimeError("persistent device failure"),
                            times=None)
        req = GenRequest(prompt_ids=[3, 4], max_new_tokens=8)
        with pytest.raises(RuntimeError, match="persistent device failure"):
            b.submit(req).result(timeout=WAIT)
        global_injector.disarm("engine.step")
        assert req.recovery_attempts == 2
        assert global_metrics.get("engine.recovery_failed") == before + 1
        # The engine stays serviceable.
        out = b.submit(GenRequest(prompt_ids=[5, 6], max_new_tokens=4)).result(timeout=WAIT)
        assert len(out) == 4
    finally:
        b.stop()


def test_recovery_off_fails_the_in_flight_request_and_serves_the_queued_one(weights):
    """``recovery_max_attempts=0``, the contract before the fault domain:
    the in-flight request fails with the original exception, the queued
    one completes."""
    b = _batcher(weights, "dense", recovery_max_attempts=0, n_slots=1)
    global_injector.arm("engine.step", RuntimeError("injected device failure"), times=1,
                        skip=1)
    first = GenRequest(prompt_ids=list(PROMPTS[0]), max_new_tokens=32)
    queued = GenRequest(prompt_ids=list(PROMPTS[1]), max_new_tokens=4)
    futs = [b.submit(first), b.submit(queued)]
    b.start()
    try:
        with pytest.raises(RuntimeError, match="injected device failure"):
            futs[0].result(timeout=WAIT)
        assert len(futs[1].result(timeout=WAIT)) == 4
        assert first.recovery_attempts == 0
        assert all(t.is_alive() for t in b._threads)
    finally:
        b.stop()


def test_prefill_fault_leaks_no_reservation_and_no_page(weights):
    b = _batcher(weights, "paged", pipeline_depth=2, chunk_policy="adaptive")
    before = global_metrics.get("engine.recovery_requeued")
    global_injector.arm("engine.prefill", RuntimeError("injected prefill fault"), times=1)
    b.start()
    try:
        _, got = _serve(b, PROMPTS[:2])
        assert all(len(ids) == NEW for ids in got)
        assert global_injector.fired("engine.prefill") == 1
        assert global_metrics.get("engine.recovery_requeued") >= before + 1
        assert b._prep_reserved == set()
        assert b.alloc.free_pages + b.page_index.pinned_pages == b.num_pages - 1
    finally:
        b.stop()


# --------------------------------------------------------------------- #
# The in-place rebuild keeps every tensor a captured graph reads
# --------------------------------------------------------------------- #

def _graph_tensors(b):
    """Every tensor the chunk graphs read by address, by name."""
    out = {"lengths": b.cache.lengths, "tokens": b.dstate.tokens, "done": b.dstate.done,
           "budget": b.dstate.budget, "history": b.history, "draft_mode": b.runner.draft_mode}
    for i, (k, v) in enumerate(b.cache.layers):
        out[f"k{i}"], out[f"v{i}"] = k, v
    for i, (ks, vs) in enumerate(b.cache.scales or []):
        out[f"k_scale{i}"], out[f"v_scale{i}"] = ks, vs
    for name in ("temperature", "top_k", "top_p", "eos_id", "json_enabled", "json_state",
                 "json_stack", "json_depth"):
        out[name] = getattr(b.sampling, name)
    if b.runner.table is not None:
        out["block_table"] = b.runner.table
    return {name: t for name, t in out.items() if t is not None}


@pytest.mark.parametrize("name", ["dense", "paged"])
def test_rebuild_resets_in_place_and_keeps_every_graph_tensor(weights, name):
    """Int8 KV (scales), speculation (history) and model drafts (their mode
    vector) on: across a fault's rebuild, and an idle one, every tensor a
    chunk graph reads keeps its address, the runner holds the batcher's own
    cache and states, and the reset leaves each tensor as it was made."""
    b = _batcher(weights, name, kv_quantize=True, speculate=4, draft_layers=1, chunk_size=2,
                 **({"max_seq_len": 128} if name == "paged" else {}))
    ptrs = {n: t.data_ptr() for n, t in _graph_tensors(b).items()}
    global_injector.arm("engine.step", RuntimeError("injected device failure"), times=1,
                        skip=2)
    b.start()
    try:
        _, got = _serve(b, PROMPTS[:2])
        assert all(len(ids) == NEW for ids in got)
        assert global_injector.fired("engine.step") == 1
        assert {n: t.data_ptr() for n, t in _graph_tensors(b).items()} == ptrs
        b.call_on_device(lambda: b._rebuild_device_state("test"))
        after = _graph_tensors(b)
        assert {n: t.data_ptr() for n, t in after.items()} == ptrs
        assert b.cache is b.runner.cache and b.dstate is b.runner.dstate
        assert b.sampling is b.runner.sampling and b.history is b.runner.history
        made = {"done": True, "top_p": 1.0, "eos_id": -1,
                "block_table": getattr(b, "num_pages", 0) - 1}
        for n, t in after.items():
            assert bool((t == made.get(n, 0)).all()), n
        # It serves on after the reset.
        _, got = _serve(b, PROMPTS[2:])
        assert all(len(ids) == NEW for ids in got)
    finally:
        b.stop()


# --------------------------------------------------------------------- #
# The degrade rungs dispatch graphs the sweep captured
# --------------------------------------------------------------------- #

def test_degraded_dispatches_stay_on_reachable_keys(weights):
    """At the ``min_chunk`` rung (``no_draft`` below it) every dispatch is
    the smallest chunk bucket with the model drafts off: keys of
    ``reachable_keys()``, so a degraded engine captures nothing."""
    ladder = DegradeLadder(fault_threshold=1, window_s=60.0, promote_s=3600.0)
    b = _batcher(weights, "paged", speculate=4, draft_layers=1, degrade=ladder,
                 max_seq_len=128)
    ladder.record_fault("test")
    ladder.record_fault("test")
    assert ladder.level() == 2
    dispatched = []
    run = b.runner.run
    lock = threading.Lock()

    def recording(n, fused, n_blocks=None, table=None, prefix_bound=None, draft_mode=None):
        drafts = bool(b.draft_layers and draft_mode is not None and np.any(draft_mode))
        with lock:
            dispatched.append(b.runner.key(n, fused, n_blocks, prefix_bound, drafts))
        return run(n, fused, n_blocks, table, prefix_bound=prefix_bound, draft_mode=draft_mode)

    b.runner.run = recording
    admit = b._dispatch_prefill

    def drafting(prep):
        admit(prep)
        with b._lock:                       # every slot would draft through the model
            for idx, _ in prep.group:
                b._draft_on[idx] = True

    b._dispatch_prefill = drafting
    b.start()
    try:
        _serve(b, PROMPTS[:2])
    finally:
        b.stop()
    assert dispatched
    assert set(dispatched) <= set(b.reachable_keys())
    assert {k[0] for k in dispatched} == {b.chunk_buckets[0]}
    assert not any(k[5] for k in dispatched)
