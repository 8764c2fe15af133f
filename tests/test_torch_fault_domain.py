"""The port's request-level fault handling on the CPU (ROADMAP P6b, the
fault domain; the JAX batcher's rules, ``tests/test_chaos.py``'s cases):
poison containment, deadlines at submit, in the backlog and mid-decode,
shedding by queue depth and by SLO class, the degrade ladder's slot cap
and batch shedding, the watchdog on a hung dispatch, and the sticky CUDA
error, which the port fails instead of recovering."""

import time

import pytest
import torch

from pilottai_tpu_torch.engine.batcher import ContinuousBatcher, GenRequest, _Slot
from pilottai_tpu_torch.models.common import init_params
from pilottai_tpu_torch.models.registry import get_model_config
from pilottai_tpu_torch.reliability import (
    CircuitBreaker,
    DeadlineExceeded,
    DegradeLadder,
    EngineOverloaded,
    PoisonedOutput,
    global_engine_health,
    global_injector,
)
from pilottai_tpu_torch.utils.metrics import global_metrics

CPU = torch.device("cpu")
WAIT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_registries():
    global_injector.reset()
    global_engine_health.reset()
    yield
    global_injector.reset()
    global_engine_health.reset()


@pytest.fixture(scope="module")
def model():
    cfg = get_model_config("llama-tiny").replace(dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, init_params(cfg, gen, device=CPU)


def _batcher(model, **kw):
    cfg, params = model
    knobs = dict(n_slots=2, max_seq_len=128)
    knobs.update(kw)
    return ContinuousBatcher(cfg, params, CPU, **knobs)


def _wait_for(cond, timeout=30.0):
    end = time.time() + timeout
    while time.time() < end and not cond():
        time.sleep(0.005)
    assert cond()


def test_fold_corruption_poisons_only_its_request(model):
    b = _batcher(model)
    b.start()
    try:
        r1 = GenRequest(prompt_ids=[3, 4, 5], max_new_tokens=100)
        r2 = GenRequest(prompt_ids=[6, 7], max_new_tokens=100)
        f1, f2 = b.submit(r1), b.submit(r2)

        def slot_of(req):
            return next((i for i, s in enumerate(b._slots) if s is not None
                         and s.request is req), None)

        _wait_for(lambda: slot_of(r1) is not None and slot_of(r2) is not None)
        before = global_metrics.get("engine.poisoned")
        global_injector.arm("engine.fold.corrupt", value=slot_of(r2), times=1)
        with pytest.raises(PoisonedOutput, match="out-of-vocab"):
            f2.result(timeout=WAIT)
        assert len(f1.result(timeout=WAIT)) == 100         # the other occupant is untouched
        assert global_metrics.get("engine.poisoned") == before + 1
        assert r2.recovery_attempts == 0                    # poison is not replayed
        assert b.degrade.snapshot()["faults_in_window"] >= 1
        assert len(b.submit(GenRequest(prompt_ids=[9, 9], max_new_tokens=4))
                   .result(timeout=WAIT)) == 4
    finally:
        b.stop()


def test_deadline_expired_before_submit_costs_nothing(model):
    b = _batcher(model)                      # never started: the submit path only
    before = global_metrics.get("engine.expired")
    fut = b.submit(GenRequest(prompt_ids=[3], max_new_tokens=4,
                              deadline=time.monotonic() - 1))
    with pytest.raises(DeadlineExceeded, match="before submit"):
        fut.result(timeout=1)
    assert b.queue_depth() == 0 and global_metrics.get("engine.expired") == before + 1


def test_deadline_expired_in_the_backlog_is_refused_at_admission(model):
    b = _batcher(model, n_slots=1)
    fut = b.submit(GenRequest(prompt_ids=[3, 4], max_new_tokens=4,
                              deadline=time.monotonic() + 0.05))
    time.sleep(0.1)
    b.start()
    try:
        with pytest.raises(DeadlineExceeded, match="before admission"):
            fut.result(timeout=WAIT)
    finally:
        b.stop()


@pytest.mark.parametrize("paged", [False, True])
def test_deadline_mid_decode_releases_the_slot_and_its_pages(model, paged):
    """Every dispatch slowed by 50 ms: once a request of 120 tokens is
    decoding, its deadline passes; the sweep releases it with
    ``DeadlineExceeded``, its slot and pages come back, and the next request
    completes through them."""
    kw = dict(paged=True, page_size=16, prefix_cache=0) if paged else {}
    b = _batcher(model, n_slots=1, chunk_policy="fixed", chunk_size=4, **kw)
    b.start()
    try:
        global_injector.arm("engine.dispatch.hang", delay=0.05, times=None)
        before = global_metrics.get("engine.deadline_releases")
        req = GenRequest(prompt_ids=[3, 4, 5], max_new_tokens=120)
        fut = b.submit(req)
        _wait_for(lambda: b._slots[0] is not None and len(b._slots[0].generated) >= 2)
        req.deadline = time.monotonic()
        with pytest.raises(DeadlineExceeded, match="after [0-9]+ generated token"):
            fut.result(timeout=WAIT)
        global_injector.disarm("engine.dispatch.hang")
        assert global_metrics.get("engine.deadline_releases") == before + 1
        out = b.submit(GenRequest(prompt_ids=[6, 7], max_new_tokens=4)).result(timeout=WAIT)
        assert len(out) == 4
        _wait_for(lambda: all(s is None for s in b._slots))
        if paged:
            assert b.alloc.free_pages == b.num_pages - 1
    finally:
        b.stop()


def test_queue_depth_and_batch_class_shedding(model):
    b = _batcher(model, n_slots=1, max_queue_depth=4, batch_shed_frac=0.5)
    accepted = [b.submit(GenRequest(prompt_ids=[1 + i], max_new_tokens=2)) for i in range(2)]
    before = global_metrics.get("engine.shed.batch")
    with pytest.raises(EngineOverloaded, match="batch-class limit 2"):
        b.submit(GenRequest(prompt_ids=[3], max_new_tokens=2, slo_class="batch"))
    assert global_metrics.get("engine.shed.batch") == before + 1
    accepted += [b.submit(GenRequest(prompt_ids=[4 + i], max_new_tokens=2)) for i in range(2)]
    assert b.saturated()
    before = global_metrics.get("engine.shed.interactive")
    with pytest.raises(EngineOverloaded, match="interactive-class limit 4"):
        b.submit(GenRequest(prompt_ids=[6], max_new_tokens=2))
    assert global_metrics.get("engine.shed.interactive") == before + 1
    b.start()
    try:
        for fut in accepted:                 # what was accepted still completes
            assert len(fut.result(timeout=WAIT)) == 2
    finally:
        b.stop()


def test_degrade_rungs_cap_chunks_and_slots_and_shed_batch(model):
    ladder = DegradeLadder(fault_threshold=1, window_s=60.0, promote_s=3600.0)
    b = _batcher(model, n_slots=4, degrade=ladder, max_queue_depth=16)
    b._slots[0] = _Slot(request=GenRequest(prompt_ids=[1, 2], max_new_tokens=100),
                        prompt_len=2)
    assert b._pick_chunk_blocks() == b.chunk_buckets[-1]
    ladder.record_fault("t")
    ladder.record_fault("t")
    assert ladder.level() == 2                          # min_chunk
    assert b._pick_chunk_blocks() == b.chunk_buckets[0]
    b._slots[0] = None
    ladder.record_fault("t")
    assert ladder.level() == 3                          # half_slots
    b._backlog.extend(GenRequest(prompt_ids=[3 + i], max_new_tokens=4) for i in range(4))
    group, _, seg = b._select()
    assert seg is None and len(group) == 2
    ladder.record_fault("t")
    assert ladder.level() == 4                          # shed_batch
    with pytest.raises(EngineOverloaded, match="shedding batch-class"):
        b.submit(GenRequest(prompt_ids=[5], max_new_tokens=2, slo_class="batch"))
    assert not b.submit(GenRequest(prompt_ids=[5], max_new_tokens=2)).done()


def test_watchdog_trips_on_a_hung_dispatch_then_the_engine_recovers(model):
    b = _batcher(model, n_slots=1, watchdog_stall_s=0.5)
    b.start()
    try:
        assert len(b.submit(GenRequest(prompt_ids=[3, 4, 5], max_new_tokens=8))
                   .result(timeout=WAIT)) == 8
        global_engine_health.reset()
        br = CircuitBreaker(name="wd-hang")
        global_engine_health.subscribe(br.on_engine_stall)
        before = global_metrics.get("engine.watchdog_stalls")
        global_injector.arm("engine.dispatch.hang", delay=2.0, times=1)
        fut = b.submit(GenRequest(prompt_ids=[3, 4, 5], max_new_tokens=8))
        _wait_for(lambda: not global_engine_health.healthy(), timeout=2.0)
        assert global_metrics.get("engine.watchdog_stalls") >= before + 1
        assert global_engine_health.snapshot()["retry_after"] > 0
        _wait_for(lambda: br.state == "open", timeout=2.0)
        assert len(fut.result(timeout=WAIT)) == 8            # the hang resolves
        _wait_for(global_engine_health.healthy, timeout=5.0)
        assert b.degrade.snapshot()["faults_in_window"] >= 1
    finally:
        b.stop()


def test_warm_up_sweep_never_trips_the_watchdog(model):
    b = _batcher(model, n_slots=1, watchdog_stall_s=0.01)
    b.start()
    try:
        b._warming = True
        assert not b._watchdog_has_work()
        b._warming = False
        b._backlog.append(GenRequest(prompt_ids=[1], max_new_tokens=1))
        assert b._watchdog_has_work()
        b._backlog.clear()
    finally:
        b.stop()


def test_sticky_cuda_error_fails_the_occupants_and_marks_the_engine_stalled(model):
    """No rebuild, no re-admission: the original exception, and the engine
    stalled on ``global_engine_health`` (until it stops)."""
    b = _batcher(model, n_slots=1, chunk_policy="fixed", chunk_size=4)
    sticky = RuntimeError("CUDA error: an illegal memory access was encountered")
    br = CircuitBreaker(name="sticky")
    global_engine_health.subscribe(br.on_engine_stall)
    before = global_metrics.get("engine.rebuilds")
    global_injector.arm("engine.step", sticky, times=1, skip=1)
    b.start()
    try:
        req = GenRequest(prompt_ids=[3, 4, 5], max_new_tokens=32)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            b.submit(req).result(timeout=WAIT)
        assert req.recovery_attempts == 0 and req.recovered_tokens == []
        assert global_metrics.get("engine.rebuilds") == before
        assert not global_engine_health.healthy() and br.state == "open"
        assert b.health_source in global_engine_health.snapshot()["sources"]
    finally:
        b.stop()
    assert global_engine_health.healthy()


def test_a_failing_rebuild_is_retried_a_bounded_number_of_times(model):
    """A rebuild that fails is retried at the next cycle, at most
    ``recovery_max_attempts`` times in a row; then the engine is marked
    stalled instead of spinning. One that fails once is retried and
    succeeds."""
    b = _batcher(model, n_slots=1, recovery_max_attempts=2, chunk_policy="fixed", chunk_size=4)
    b.start()
    try:
        before = global_metrics.get("engine.rebuilds")
        global_injector.arm("engine.step", RuntimeError("step fault"), times=1, skip=1)
        global_injector.arm("engine.rebuild", RuntimeError("rebuild fault"), times=1)
        out = b.submit(GenRequest(prompt_ids=[3, 4, 5], max_new_tokens=16)).result(timeout=WAIT)
        assert len(out) == 16 and global_metrics.get("engine.rebuilds") == before + 1
        assert global_engine_health.healthy()
        global_injector.arm("engine.step", RuntimeError("step fault"), times=1, skip=1)
        global_injector.arm("engine.rebuild", RuntimeError("rebuild fault"), times=None)
        out = b.submit(GenRequest(prompt_ids=[3, 4, 5], max_new_tokens=16))
        _wait_for(lambda: not global_engine_health.healthy())
        assert global_injector.fired("engine.rebuild") == 1 + 2
        global_injector.disarm("engine.rebuild")
        # The request recovered into the backlog and is served all the same.
        assert len(out.result(timeout=WAIT)) == 16
    finally:
        b.stop()
