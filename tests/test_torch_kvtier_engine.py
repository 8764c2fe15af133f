"""Slice P7, the KV cache tier, in the engine on the CPU against the JAX
package: the JAX tier test's scripted sequence of sessions
(``tests/test_kvcache.py`` ``SEQ``), dense and paged, each at speculation
0 and 2, and paged with the int8 KV cache, with the hot capacities shrunk
so that evictions spill and resumes restore, gives the greedy ids of the
port with the tier off and of the JAX engine with the tier on; a resume
prefills under half its prompt (``engine.prefill_tokens``); a restore
staged before a rebuild unwinds; a prefill fault during a restore and
both corruption points end in the same output; and a session exported
from one engine and imported into another resumes there by a restore.

Weights: llama-tiny from the JAX ``init_params`` in fp32, the embedding
times 1 / hidden and wq, wk times 4 (unscaled, a random tiny model
repeats its last prompt token and the ids would pin nothing), carried
across by ``params_from_numpy``.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu_torch.engine.batcher import ContinuousBatcher, GenRequest
from pilottai_tpu_torch.models.loader import params_from_numpy
from pilottai_tpu_torch.models.registry import get_model_config
from pilottai_tpu_torch.reliability import global_engine_health, global_injector
from pilottai_tpu_torch.utils.metrics import global_metrics

CPU = torch.device("cpu")
WAIT = 120
KV = ("lookups", "hits", "host_hits", "spills", "restores", "prefill_tokens_saved",
      "integrity_failures")

# The JAX tier test's three lineages with multi-turn resumes, submitted one
# after another so that a hot capacity of 1 entry (dense) or 2 pinned pages
# (paged) forces spill, then restore, between the turns.
_S1 = [(i % 90) + 5 for i in range(70)]
_S2 = [(i % 70) + 11 for i in range(70)]
_S3 = [(i % 50) + 23 for i in range(70)]
SEQ = (
    (_S1, 6), (_S2, 8), (_S1 + [7, 9, 11], 6), (_S3, 4),
    (_S2 + [17, 18, 19], 8), (_S1 + [7, 9, 11, 13, 15], 5),
)
# (paged, speculate, int8 KV) of each engine parity case.
CASES = {
    "dense": (False, 0, False),
    "dense-spec": (False, 2, False),
    "paged": (True, 0, False),
    "paged-spec": (True, 2, False),
    "dense-int8": (False, 0, True),
}
# A session's first turn, unrelated traffic, then the resume.
BASE = [(i % 90) + 5 for i in range(80)]
OTHER = [(i % 70) + 11 for i in range(80)]
RESUME = BASE + [7, 9, 11, 13]


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

    jcfg = jax_config("llama-tiny").replace(dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    tree["embed"] = tree["embed"] * np.float32(1.0 / jcfg.hidden_size)
    for name in ("wq", "wk"):
        tree["layers"]["attn"][name] = tree["layers"]["attn"][name] * np.float32(4.0)
    cfg = get_model_config("llama-tiny").replace(dtype=torch.float32)
    return jcfg, tree, cfg, params_from_numpy(tree, cfg, device=CPU)


def _knobs(paged, speculate=0, int8=False, tier=True):
    """The JAX tier test's engine: 2 slots of 256, chunks of 4, pages of 16;
    the tier's 64 MiB and a hot capacity of 1 entry or 2 pinned pages (set
    on the index by ``_shrink``)."""
    kw = dict(n_slots=2, max_seq_len=256, chunk_size=4, speculate=speculate,
              prefix_cache=(4 if paged else 1) if tier else 0,
              kvcache_host_mb=64 if tier else 0, kv_quantize=int8)
    if paged:
        kw.update(paged=True, page_size=16)
    return kw


def _base_knobs(paged, speculate=0, int8=False, tier=True):
    """``_knobs``; without the tier on an int8 cache, the device tier alone
    with room for every entry. A hit on an int8 cache reads the quantized
    prefix, so its ids are not a cold prefill's (in the JAX engine too) and
    depend on the hit's depth: what the host tier must keep there is the
    ids of a device-resident hit at the same depth."""
    knobs = _knobs(paged, speculate, int8, tier)
    if int8 and not tier:
        knobs.update(prefix_cache=8, kvcache_host_mb=0)
    return knobs


def _shrink(b, pages=2):
    if b.page_index is not None:
        b.page_index.capacity = pages


def _counters(metrics=global_metrics):
    return {k: metrics.get(f"engine.kvcache.{k}") for k in KV}


def _delta(before, metrics=global_metrics):
    return {k: metrics.get(f"engine.kvcache.{k}") - v for k, v in before.items()}


def _serve(b, requests):
    """Submit one request at a time (so eviction order is the script's)."""
    b.start()
    try:
        return [b.submit(r).result(timeout=WAIT) for r in requests]
    finally:
        b.stop()


def _seq_requests(make, session=True):
    return [make(prompt_ids=list(p), max_new_tokens=m,
                 session_id=f"sess-{i % 3}" if session else None)
            for i, (p, m) in enumerate(SEQ)]


@pytest.fixture(scope="module")
def jax_seq(weights):
    """The JAX engine's ids on ``SEQ`` with the tier on, per case, made at
    first use (``use_pallas=False``: the plain attention paths)."""
    from pilottai_tpu.engine.batcher import ContinuousBatcher as JaxBatcher
    from pilottai_tpu.engine.batcher import GenRequest as JaxRequest
    from pilottai_tpu.utils.metrics import global_metrics as jax_metrics

    jcfg, tree, _, _ = weights
    cache = {}

    def get(name):
        if name not in cache:
            paged, speculate, int8 = CASES[name]
            kw = _knobs(paged, speculate, int8)
            b = JaxBatcher(jcfg, jax.tree.map(jnp.asarray, tree), cache_dtype=jnp.float32,
                           use_pallas=False, **kw)
            _shrink(b)
            before = _counters(jax_metrics)
            cache[name] = (_serve(b, _seq_requests(JaxRequest)), _delta(before, jax_metrics))
        return cache[name]

    return get


def _port_seq(weights, name, tier):
    paged, speculate, int8 = CASES[name]
    _, _, cfg, params = weights
    b = ContinuousBatcher(cfg, params, CPU, **_base_knobs(paged, speculate, int8, tier))
    if tier:
        _shrink(b)
    before = _counters()
    out = _serve(b, _seq_requests(GenRequest, session=tier))
    return out, _delta(before), b


@pytest.mark.parametrize("name", list(CASES))
def test_tier_on_matches_the_tier_off_port_and_the_jax_engine(weights, jax_seq, name):
    cold, base, _ = _port_seq(weights, name, tier=False)
    warm, delta, b = _port_seq(weights, name, tier=True)
    want, jdelta = jax_seq(name)
    assert warm == cold == want
    assert delta["spills"] >= 1, "no eviction spilled: the tier went untested"
    assert delta["restores"] >= 1, "no resume restored: the tier went untested"
    assert delta["integrity_failures"] == 0
    # The same lookups, hits and restores as the JAX engine's tier.
    for k in ("lookups", "hits", "host_hits", "restores", "prefill_tokens_saved"):
        assert delta[k] == jdelta[k], k
    assert len({tuple(o) for o in cold}) > 2      # the ids pin something
    if CASES[name][2]:
        assert base["hits"] == delta["hits"] and base["spills"] == 0
    if b.paged:
        assert b.alloc.free_pages + b.page_index.pinned_pages == b.num_pages - 1


# --------------------------------------------------------------------- #
# The resume: a restore, not a prefill
# --------------------------------------------------------------------- #

def _resume(weights, paged, tier=True, arm=None, int8=False):
    """A session's first turn, unrelated traffic that evicts it, then the
    resume, with ``arm`` (a fault point and its arguments) armed just
    before the resume. Returns the resume's ids, the tier's counter deltas
    and the prompt tokens the resume prefilled."""
    _, _, cfg, params = weights
    b = ContinuousBatcher(cfg, params, CPU, **_base_knobs(paged, int8=int8, tier=tier))
    if tier:
        _shrink(b)
    elif b.page_index is not None:
        b.page_index.capacity = 16
    b.start()
    try:
        for ids, sid in ((BASE, "s-res"), (OTHER, None)):
            b.submit(GenRequest(prompt_ids=list(ids), max_new_tokens=6,
                                session_id=sid)).result(timeout=WAIT)
        if b.page_index is not None:
            # The tiny capacity was there to force the eviction; the
            # restored chain must not evict itself as it registers.
            b.page_index.capacity = 16
        if arm is not None:
            global_injector.arm(arm[0], **arm[1])
        before = _counters()
        pf = global_metrics.get("engine.prefill_tokens")
        rq = global_metrics.get("engine.recovery_requeued")
        out = b.submit(GenRequest(prompt_ids=list(RESUME), max_new_tokens=6,
                                  session_id="s-res")).result(timeout=WAIT)
        delta = _delta(before)
        delta["prefilled"] = global_metrics.get("engine.prefill_tokens") - pf
        delta["requeued"] = global_metrics.get("engine.recovery_requeued") - rq
        if b.page_index is not None:
            assert b.alloc.free_pages + b.page_index.pinned_pages == b.num_pages - 1
    finally:
        b.stop()
    return out, delta


@pytest.mark.parametrize("paged,int8", [(False, False), (True, False), (True, True)],
                         ids=["dense", "paged", "paged-int8"])
def test_a_resume_restores_and_prefills_under_half_its_prompt(weights, paged, int8):
    """The resume restores and prefills under half its prompt, with the ids
    of an engine without the host tier: a cold prefill, or on the int8 cache
    a device-resident hit at the same depth (its pages spilled raw and
    written back as they were)."""
    want, base = _resume(weights, paged, tier=False, int8=int8)
    out, delta = _resume(weights, paged, int8=int8)
    assert out == want
    assert delta["restores"] >= 1 and delta["host_hits"] >= 1
    assert delta["prefill_tokens_saved"] > 0
    assert 0 < delta["prefilled"] < len(RESUME) // 2, delta
    if int8:
        assert base["hits"] == 1 and base["prefilled"] == delta["prefilled"]
    else:
        assert base["prefilled"] == len(RESUME)


# --------------------------------------------------------------------- #
# Faults: a rebuild, a failed prefill, host RAM rot
# --------------------------------------------------------------------- #

def test_a_restore_staged_before_a_rebuild_unwinds_and_restores_again(weights):
    """A paged restore staged (not yet written) when the device state is
    rebuilt: the record is dropped, nothing is written into the reset
    pool, its host entries return to the tier, and a second lookup
    restores them again, this time into the pool."""
    _, _, cfg, params = weights
    b = ContinuousBatcher(cfg, params, CPU, **_knobs(True))   # not started: ours to drive
    P = b.page_size
    ids = list(range(40, 40 + 3 * P + 2))
    L, K, H = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    for blk in range(2):
        panel = (torch.full((L, K, P, H), blk + 1.0), torch.full((L, K, P, H), blk + 101.0))
        assert b.kvcache.host.put(tuple(ids[: (blk + 1) * P]), panel, tokens=P, rows=P,
                                  kind="page")
    with b._lock:
        node = b._prefix_hit(GenRequest(prompt_ids=ids, max_new_tokens=4))
    assert node is not None and node.depth == 2
    assert len(b._pending_restores) == 1 and len(b.kvcache.host) == 0
    free_before = b.alloc.free_pages
    b._rebuild_device_state(reason="test_mid_restore")
    assert b._pending_restores == [] and not b.kvcache._unwritten
    assert len(b.kvcache.host) == 2, "host entries lost in the unwind"
    assert len(b.page_index) == 0 and b.alloc.free_pages >= free_before
    assert all(not kp.any() and not vp.any() for kp, vp in b.cache.layers), "stale write"
    with b._lock:
        node = b._prefix_hit(GenRequest(prompt_ids=ids, max_new_tokens=4))
    assert node is not None and node.depth == 2 and len(b._pending_restores) == 1
    b._apply_restores()
    for blk, page in enumerate(node.path_pages):
        for li in range(L):
            assert torch.all(b.cache.layers[li][0][:, page] == blk + 1.0)
            assert torch.all(b.cache.layers[li][1][:, page] == blk + 101.0)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_a_prefill_fault_during_a_restore_recovers_to_the_same_output(weights, paged):
    want, _ = _resume(weights, paged)
    out, delta = _resume(weights, paged, arm=("engine.prefill", dict(
        exc=RuntimeError("injected fault mid-restore"), times=1)))
    assert global_injector.fired("engine.prefill") == 1
    assert delta["restores"] >= 1 and delta["requeued"] >= 1
    assert out == want


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("point", ["kvcache.spill.corrupt", "kvcache.restore.corrupt"],
                         ids=["spill", "restore"])
def test_a_corrupt_host_entry_is_prefilled_to_the_same_output(weights, point, paged):
    want, _ = _resume(weights, paged)
    out, delta = _resume(weights, paged, arm=(point, dict(value=True, times=1)))
    assert global_injector.fired(point) == 1
    assert delta["integrity_failures"] == 1
    assert out == want


# --------------------------------------------------------------------- #
# Sessions move between engines
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_an_exported_session_resumes_by_a_restore_on_another_engine(weights, paged):
    """The session's first turn on one engine, its export
    (``export_session_kv``), the import into a fresh engine
    (``import_session_kv``), the resume there: the same ids as a resume
    on an engine without the tier, and a restore instead of a prefill."""
    _, _, cfg, params = weights
    want, _ = _resume(weights, paged, tier=False)
    src = ContinuousBatcher(cfg, params, CPU, **_knobs(paged))
    src.start()
    try:
        src.submit(GenRequest(prompt_ids=list(BASE), max_new_tokens=6,
                              session_id="s-mig")).result(timeout=WAIT)
        export = src.export_session_kv("s-mig")
        request = src.export_request_kv(BASE)
    finally:
        src.stop()
    assert export["ids"] == BASE and export["entries"]
    assert request["entries"] and src.kvcache.host.lineage("s-mig") is None
    dst = ContinuousBatcher(cfg, params, CPU, **_knobs(paged))
    if paged:
        dst.page_index.capacity = 16
    got = dst.import_session_kv(export)
    assert got["accepted"] == len(export["entries"]) and got["rejected"] == 0
    before = _counters()
    pf = global_metrics.get("engine.prefill_tokens")
    (out,) = _serve(dst, [GenRequest(prompt_ids=list(RESUME), max_new_tokens=6,
                                     session_id="s-mig")])
    assert out == want
    assert _delta(before)["restores"] >= 1
    assert global_metrics.get("engine.prefill_tokens") - pf < len(RESUME) // 2


def test_the_handler_serves_a_session_through_the_tier():
    """``LLMHandler.generate_response(..., session_id=)`` on an engine with
    ``engine_kvcache_host_mb``: the resume after an eviction restores and
    answers as an engine without the tier; the engine's export and import
    methods move the session."""
    from pilottai_tpu_torch import LLMConfig, LLMHandler
    from pilottai_tpu_torch.engine.types import GenerationParams

    turn = "<analysis of report 7: " + "sections, totals and dates; " * 4
    prompts = [(turn, "s-h"), ("unrelated request about invoices " * 5, None),
               (turn + "and the follow-up question", "s-h")]

    async def run(**knobs):
        h = LLMHandler(LLMConfig(provider="cpu", model_name="llama-tiny", dtype="float32",
                                 engine_slots=2, engine_max_seq=512, engine_chunk=4, **knobs))
        await h.start()
        try:
            outs = [(await h.generate_response(
                [p], params=GenerationParams(max_new_tokens=6, temperature=0.0),
                session_id=sid)).content for p, sid in prompts]
            return outs, h.backend.export_session_kv("s-h"), h.backend.batcher
        finally:
            await h.stop()

    want, none, _ = asyncio.run(run(engine_prefix_cache=0))
    before = _counters()
    outs, export, b = asyncio.run(run(engine_prefix_cache=1, engine_kvcache_host_mb=16))
    assert outs == want and none is None
    assert _delta(before)["restores"] >= 1 and b.prefix_report()["host"]["restores"] >= 1
    assert export is not None and export["entries"]
