"""The port's reliability layer (ROADMAP P6b, the fault domain) against the
JAX package's: the fault injector, the circuit breaker, the deadline
helpers, the degrade ladder, the watchdog and the handler's backoff, each
test run on both packages (``pilottai_tpu.reliability`` and
``pilottai_tpu_torch.reliability``) and, where the output is
deterministic, holding the port's values equal to the JAX package's. Also
the sticky-fault classifier, which has no JAX counterpart on one card, and
the configuration the port now takes."""

import importlib
import random
import time

import pytest

from pilottai_tpu_torch.core.config import LLMConfig, NotInSlice, ReliabilityConfig
from pilottai_tpu_torch.engine.batcher import STICKY_CUDA_ERRORS, sticky_device_error

PACKAGES = ["pilottai_tpu", "pilottai_tpu_torch"]


def rel(pkg):
    return importlib.import_module(f"{pkg}.reliability")


def metrics(pkg):
    return importlib.import_module(f"{pkg}.utils.metrics").global_metrics


@pytest.fixture(autouse=True)
def _clean_registries():
    for pkg in PACKAGES:
        rel(pkg).global_injector.reset()
        rel(pkg).global_engine_health.reset()
    yield
    for pkg in PACKAGES:
        rel(pkg).global_injector.reset()
        rel(pkg).global_engine_health.reset()


# ----------------------------- injector -------------------------------- #

def _injector_trace(pkg):
    """What the registry does for a scripted sequence of arms and fires."""
    r = rel(pkg)
    inj = r.global_injector
    inj.reset()
    out = [inj.fire("engine.step"), inj.fired("engine.step")]
    inj.arm("x.point", value=42, times=2)
    out += [inj.fire("x.point"), inj.armed("x.point"), inj.remaining("x.point"),
            inj.fire("x.point"), inj.armed("x.point"), inj.fire("x.point"),
            inj.fired("x.point")]
    # skip=: two passes go through, then exactly one fire.
    inj.arm("s.point", value="hit", times=1, skip=2)
    out += [inj.fire("s.point") for _ in range(4)] + [inj.fired("s.point")]
    with r.inject("y.point", RuntimeError, times=None):
        try:
            inj.fire("y.point")
        except RuntimeError as exc:
            out.append(str(exc))
    out.append(inj.fire("y.point"))      # the scope disarmed it
    out.append(sorted(inj.snapshot()["fired"].items()))
    return out


@pytest.mark.parametrize("pkg", PACKAGES)
def test_injector_times_skip_and_scope(pkg):
    got = _injector_trace(pkg)
    assert got[:2] == [None, 0]
    assert got[2:9] == [42, True, 1, 42, False, None, 2]
    assert got[9:14] == [None, None, "hit", None, 1]
    assert got[14] == "injected fault at 'y.point'" and got[15] is None
    assert metrics(pkg).get("fault.injected.x.point") >= 2
    assert got == _injector_trace("pilottai_tpu")


def _seeded_fires(pkg, seed):
    reg = rel(pkg).FaultInjector(seed=seed)
    reg.arm("p", value=1, times=None, probability=0.5)
    return [reg.fire("p") for _ in range(200)]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_injector_probability_is_seeded_and_partial(pkg):
    fires = _seeded_fires(pkg, 7)
    assert 40 < sum(v == 1 for v in fires) < 160
    assert fires == _seeded_fires(pkg, 7)
    assert fires == _seeded_fires("pilottai_tpu", 7)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_injector_delay_blocks_then_returns(pkg):
    inj = rel(pkg).global_injector
    inj.arm("d", delay=0.05, value="v")
    t0 = time.perf_counter()
    assert inj.fire("d") == "v"
    assert time.perf_counter() - t0 >= 0.05


# ----------------------------- breaker --------------------------------- #

def _breaker_trace(pkg):
    """States and verdicts over a scripted clock: the threshold, the open
    window, a failed and a successful half-open probe, a released probe."""
    t = {"now": 0.0}
    br = rel(pkg).CircuitBreaker(failure_threshold=3, recovery_timeout=10.0, half_open_max=1,
                                 name=f"unit-{pkg}", clock=lambda: t["now"])
    out = []
    for _ in range(2):
        out.append(br.allow())
        br.record_failure()
    out.append(br.state)
    br.record_failure()                       # the third in a row opens it
    out += [br.state, br.allow(), br.retry_after()]
    t["now"] = 10.0
    out += [br.state, br.allow(), br.allow()]  # one probe, then no more
    br.record_failure()                       # the probe failed: open again
    out += [br.state, br.retry_after()]
    t["now"] = 20.0
    out.append(br.allow())
    br.release_probe()                        # a probe with no verdict
    out.append(br.allow())                    # its slot is free again
    br.record_success()
    out += [br.state, br.allow(), br.snapshot()["consecutive_failures"]]
    br.record_failure()
    br.record_success()
    br.record_failure()
    out.append(br.state)                      # never three in a row
    err = rel(pkg).CircuitBreaker(failure_threshold=1, name=f"err-{pkg}")
    err.record_failure()
    out.append(isinstance(err.open_error(), rel(pkg).CircuitOpenError))
    return out


@pytest.mark.parametrize("pkg", PACKAGES)
def test_breaker_threshold_half_open_probe_and_released_probe(pkg):
    got = _breaker_trace(pkg)
    assert got == [True, True, "closed", "open", False, 10.0, "half_open", True, False, "open",
                   10.0, True, True, "closed", True, 0, "closed", True]
    assert got == _breaker_trace("pilottai_tpu")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_breaker_force_opens_on_an_engine_stall(pkg):
    r = rel(pkg)
    health = r.EngineHealth()
    br = r.CircuitBreaker(name=f"stall-{pkg}")
    health.subscribe(br.on_engine_stall)
    health.mark_stalled(reason="test stall", retry_after=1.5, source="engine-a")
    assert br.state == "open" and not health.healthy()
    assert health.snapshot()["retry_after"] == 1.5
    health.mark_recovered("engine-a")
    assert health.healthy()


# ------------------------- deadline helpers ---------------------------- #

@pytest.mark.parametrize("pkg", PACKAGES)
def test_deadline_helpers(pkg):
    r = rel(pkg)
    vals = [r.deadline_from_timeout(None), r.deadline_from_timeout(2.5, now=10.0),
            r.remaining(None), r.remaining(12.5, now=10.0), r.remaining(9.0, now=10.0),
            r.expired(None), r.expired(12.5, now=12.4), r.expired(12.5, now=12.5)]
    assert vals == [None, 12.5, None, 2.5, -1.0, False, False, True]
    jr = rel("pilottai_tpu")
    assert vals == [jr.deadline_from_timeout(None), jr.deadline_from_timeout(2.5, now=10.0),
                    jr.remaining(None), jr.remaining(12.5, now=10.0),
                    jr.remaining(9.0, now=10.0), jr.expired(None),
                    jr.expired(12.5, now=12.4), jr.expired(12.5, now=12.5)]
    assert issubclass(r.DeadlineExceeded, TimeoutError)
    assert issubclass(r.EngineOverloaded, RuntimeError)
    assert issubclass(r.PoisonedOutput, RuntimeError)
    assert r.deadline_from_timeout(1.0) > time.monotonic()


# ------------------------- degradation ladder -------------------------- #

def _ladder_trace(pkg):
    t = {"now": 0.0}
    lad = rel(pkg).DegradeLadder(fault_threshold=2, window_s=10.0, promote_s=30.0,
                                 clock=lambda: t["now"])
    out = [lad.level()]
    for reason, now in (("a", 0.0), ("b", 1.0), ("c", 2.0), ("d", 3.0)):
        t["now"] = now
        out.append(lad.record_fault(reason))
    for now in (20.0, 33.0, 63.0):            # one rung back per clean soak
        t["now"] = now
        out.append(lad.level())
    for reason, now in (("e", 100.0), ("f", 120.0)):
        t["now"] = now
        out.append(lad.record_fault(reason))  # further apart than the window
    out.append(lad.snapshot()["name"])
    off = rel(pkg).DegradeLadder(fault_threshold=1, enabled=False)
    out += [off.record_fault("x"), off.record_fault("y"), off.level()]
    return out


@pytest.mark.parametrize("pkg", PACKAGES)
def test_degrade_ladder_steps_and_promotes_on_a_clean_soak(pkg):
    before = metrics(pkg).get("engine.degrade_steps")
    got = _ladder_trace(pkg)
    # A burst of two steps a rung, each rung needs a fresh burst, a clean
    # soak promotes one rung, faults further apart than the window do not
    # add up, and a disabled ladder never steps.
    assert got == [0, 0, 1, 1, 2, 2, 1, 0, 0, 0, "full", 0, 0, 0]
    assert metrics(pkg).get("engine.degrade_steps") == before + 2
    assert metrics(pkg).get("engine.faults.a") >= 1
    assert got == _ladder_trace("pilottai_tpu")
    assert rel(pkg).degrade.LEVEL_NAMES == ("full", "no_draft", "min_chunk", "half_slots",
                                            "shed_batch")


# ----------------------------- watchdog -------------------------------- #

@pytest.mark.parametrize("pkg", PACKAGES)
def test_watchdog_trips_on_stale_beats_with_work_and_recovers(pkg):
    r = rel(pkg)
    health = r.EngineHealth()
    br = r.CircuitBreaker(name=f"wd-{pkg}")
    health.subscribe(br.on_engine_stall)
    stalls = []
    busy = {"v": False}
    t = {"now": 0.0}
    wd = r.Watchdog(stall_s=1.0, has_work=lambda: busy["v"], on_stall=stalls.append,
                    health=health, clock=lambda: t["now"], poll_s=0.005)
    before = metrics(pkg).get("engine.watchdog_stalls")

    def wait_for(cond, timeout=5.0):
        end = time.time() + timeout
        while time.time() < end and not cond():
            time.sleep(0.005)
        assert cond()

    wd.start()
    try:
        t["now"] = 50.0                       # idle: a clock jump never trips it
        time.sleep(0.05)
        assert health.healthy()
        busy["v"] = True
        t["now"] = 50.5
        time.sleep(0.05)
        assert health.healthy()
        t["now"] = 52.0                       # stale with work in flight
        wait_for(lambda: not health.healthy())
        assert br.state == "open" and stalls and stalls[0]["stall_s"] == 1.0
        assert metrics(pkg).get("engine.watchdog_stalls") >= before + 1
        wd.beat()                             # the hang resolved
        wait_for(health.healthy)
    finally:
        wd.stop()


# ----------------------------- backoff --------------------------------- #

class _NoBackend:
    name = "none"

    async def start(self):
        pass

    async def stop(self):
        pass

    async def generate(self, messages, tools=None, params=None):
        raise AssertionError("not called")


def _backoff(pkg, jitter):
    cfg = importlib.import_module(f"{pkg}.core.config")
    handler = importlib.import_module(f"{pkg}.engine.handler")
    extra = {"provider": "mock"} if pkg == "pilottai_tpu" else {}
    h = handler.LLMHandler(cfg.LLMConfig(retries=0, retry_delay=1.0, **extra,
                                         reliability=cfg.ReliabilityConfig(
                                             retry_max_delay=4.0, retry_jitter=jitter)),
                           backend=_NoBackend())
    random.seed(1234)
    return [h._backoff_delay(a) for a in range(6)]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_backoff_is_exponential_capped_and_jittered_under_a_fixed_seed(pkg):
    assert _backoff(pkg, False) == [1.0, 2.0, 4.0, 4.0, 4.0, 4.0]
    got = _backoff(pkg, True)
    for d, base in zip(got, [1.0, 2.0, 4.0, 4.0, 4.0, 4.0]):
        assert 0.5 * base <= d <= base
    assert got == _backoff("pilottai_tpu", True)


# ------------------------ sticky device faults ------------------------- #

@pytest.mark.parametrize("message", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "CUDA error: device-side assert triggered",
    "CUDA error: misaligned address",
    "CUDA error: an illegal instruction was encountered",
    "CUDA error: the launch timed out and was terminated",
    "CUDA error: uncorrectable ECC error encountered",
    "CUDA error: hardware stack error",
    "CUDA error: invalid program counter",
    "CUDA error: operation not supported on global/shared address space",
    "CUDA error: uncorrectable NVLink error detected during the execution",
])
def test_sticky_cuda_errors_are_not_recoverable(message):
    assert sticky_device_error(RuntimeError(message))
    try:
        try:
            raise RuntimeError(message)
        except RuntimeError as inner:
            raise ValueError("the fold failed") from inner
    except ValueError as outer:
        assert sticky_device_error(outer)     # found through the cause
    assert any(s in message.lower() for s in STICKY_CUDA_ERRORS)


@pytest.mark.parametrize("exc", [
    RuntimeError("injected fault at 'engine.step'"),
    RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    TimeoutError("copy timed out"),
    ValueError("host-side staging failed"),
])
def test_injected_and_host_faults_re_admit(exc):
    assert not sticky_device_error(exc)


# ----------------------------- config ---------------------------------- #

def test_config_takes_the_jax_reliability_knobs_and_still_refuses_later_ones():
    from pilottai_tpu.core import config as jcfg

    cfg = LLMConfig(retries=3, retry_delay=1.0, max_rpm=None, reliability=ReliabilityConfig())
    jax = jcfg.LLMConfig()
    assert (cfg.retries, cfg.retry_delay, cfg.max_rpm) == (jax.retries, jax.retry_delay,
                                                          jax.max_rpm) == (3, 1.0, None)
    assert LLMConfig().reliability.model_dump() == jax.reliability.model_dump()
    assert LLMConfig(max_rpm=30, retries=0).max_rpm == 30
    assert LLMConfig(reliability={"recovery_max_attempts": 0}).reliability \
        .recovery_max_attempts == 0
    assert jcfg.LogConfig().model_dump() == \
        importlib.import_module("pilottai_tpu_torch.core.config").LogConfig().model_dump()
    with pytest.raises(ValueError):
        ReliabilityConfig(no_such_knob=1)
    with pytest.raises(ValueError):
        LLMConfig(retries=-1)
    # The KV cache tier's budget is taken from P7 on.
    assert LLMConfig(engine_kvcache_host_mb=64).engine_kvcache_host_mb == 64
    for knob, value, item in (("engine_sched_policy", "dag", "P6c"),
                              ("engine_prewarm_depth", 512, "P6c"),
                              ("mesh_shape", {"model": 4}, "P10"),
                              ("tokenizer_path", "/tok", "P9b")):
        with pytest.raises(ValueError, match=item) as refused:
            LLMConfig(**{knob: value})
        assert isinstance(refused.value.errors()[0]["ctx"]["error"], NotInSlice)
    # Read only at the HTTP edge (P8a): the port takes their defaults alone,
    # and ServeConfig's file logs come with it.
    config = importlib.import_module("pilottai_tpu_torch.core.config")
    assert ReliabilityConfig(default_timeout=None, max_timeout=600.0).max_timeout == 600.0
    for make in (lambda: ReliabilityConfig(default_timeout=30.0),
                 lambda: ReliabilityConfig(max_timeout=60.0),
                 lambda: LLMConfig(reliability={"default_timeout": 30.0}),
                 lambda: config.LogConfig(log_to_file=True)):
        with pytest.raises(ValueError, match="P8a") as refused:
            make()
        assert isinstance(refused.value.errors()[0]["ctx"]["error"], NotInSlice)
