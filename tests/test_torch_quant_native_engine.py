"""Slice P5c through the port's entry points: protocol-s in fp32 with int8
or int4 weights on the integer-operand arm (``PILOTTAI_QMATMUL=native``)
served by ``LLMHandler`` must give the JAX engine's greedy ids on every
golden case, JSON on and off: int8 dense, int4 at group 128 dense, int4 at
group 96 on the paged cache (pages of 16, 64-token segments) and int4 at
group 128 with ``engine_speculate=4``. The golden files are the JAX
engine's own output on that arm
(``scripts/export_protocol_s_quant_golden.py --native``). The engine holds
the arm it read at ``start()``: a variable changed afterwards moves no
product to the other arm."""

import asyncio
import json

import pytest
import torch

from pilottai_tpu_torch import PROTOCOL_S_NPZ, LLMConfig, LLMHandler
from pilottai_tpu_torch.engine.types import ChatMessage, ToolSpec
from pilottai_tpu_torch.models import qmatmul as qm
from pilottai_tpu_torch.models import quant
from pilottai_tpu_torch.models.loader import ASSETS

GOLDEN = {name: json.loads((ASSETS / f"protocol_s_{name}_golden.json").read_text())
          for name in ("int8_native", "int4_native", "int4_native_paged", "int4_native_spec")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def arm_calls(monkeypatch):
    """Calls of each arm of ``qmatmul`` (the kernels' wrappers, which run
    their plain versions on the CPU)."""
    calls = {"native": 0, "dequant": 0}
    native, dequant = qm.int8_matmul, qm.quant_matmul

    def counting(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(qm, "int8_matmul", counting("native", native))
    monkeypatch.setattr(qm, "quant_matmul", counting("dequant", dequant))
    return calls


async def _serve(handler, golden, rounds=1, after_start=None):
    """Every golden case at once, ``rounds`` times in a row: per round the
    greedy ids by (prompt ids, JSON mode), and the batcher.
    ``after_start`` runs once the engine has started."""
    await handler.start()
    if after_start is not None:
        after_start()
    batcher = handler.backend.batcher
    seen = []
    submit = batcher.submit

    def recording(request):
        seen.append(request)
        return submit(request)

    batcher.submit = recording

    async def one(case):
        p = golden["prompts"][case["prompt"]]
        await handler.generate_response(
            [ChatMessage(**m) for m in p["messages"]],
            tools=[ToolSpec(**t) for t in p["tools"]] if p["tools"] else None,
            json_mode=case["json_mode"])

    out = []
    try:
        for _ in range(rounds):
            seen.clear()
            await asyncio.gather(*(one(c) for c in golden["cases"]))
            out.append({tuple(r.prompt_ids) + (bool(r.json_mode),): list(r.future.result())
                        for r in seen})
    finally:
        await handler.stop()
    return out, batcher


def _golden_ids(golden):
    return {tuple(c["prompt_ids"]) + (c["json_mode"],): c["token_ids"] for c in golden["cases"]}


def _handler(golden, **extra):
    return LLMHandler(LLMConfig(
        provider="cpu", model_name="protocol-s", checkpoint_path=PROTOCOL_S_NPZ,
        sampling={"temperature": 0.0, "max_new_tokens": golden["max_new_tokens"]},
        **dict(golden["engine"], **extra)))


@pytest.mark.parametrize("name", list(GOLDEN))
def test_native_arm_gives_the_jax_engines_ids(name, monkeypatch, arm_calls):
    """Greedy ids equal to the JAX engine's on the native arm, every
    quantized product through the integer arm and none through the
    dequant arm; the graph report names the arm."""
    g = GOLDEN[name]
    monkeypatch.setenv("PILOTTAI_QMATMUL", "native")
    (ids,), batcher = asyncio.run(_serve(_handler(g), g))
    assert ids == _golden_ids(g)
    assert batcher.qmatmul_arm == "native" == batcher.graph_report()["qmatmul_arm"]
    assert arm_calls["native"] > 0 and arm_calls["dequant"] == 0
    mode = g["engine"]["engine_quant"]
    assert batcher.weight_quant == mode
    assert isinstance(batcher.params["layers"][0]["mlp"]["wg"],
                      quant.QTensor if mode == "int8" else quant.Q4Tensor)
    if g["engine"].get("engine_speculate"):
        assert batcher.spec_report()["tokens_per_block"] > 1.0
    if g["engine"].get("engine_paged_kv"):
        assert batcher.prefill_segments > 0


def test_engine_holds_the_arm_it_read_at_start(monkeypatch, arm_calls):
    """``PILOTTAI_QMATMUL`` read once when the engine starts: flipped to
    ``dequant`` after ``start()``, the engine still serves every product on
    the native arm (and the native golden's ids); an engine started under
    ``dequant`` stays there when the variable turns ``native``."""
    g = GOLDEN["int8_native"]
    monkeypatch.setenv("PILOTTAI_QMATMUL", "native")
    (ids,), batcher = asyncio.run(_serve(
        _handler(g), g, after_start=lambda: monkeypatch.setenv("PILOTTAI_QMATMUL", "dequant")))
    assert ids == _golden_ids(g)
    assert batcher.graph_report()["qmatmul_arm"] == "native"
    assert arm_calls["native"] > 0 and arm_calls["dequant"] == 0
    assert {w.arm for w in quant.iter_quantized(batcher.params)} == {"native"}

    arm_calls.update(native=0, dequant=0)
    monkeypatch.setenv("PILOTTAI_QMATMUL", "dequant")
    (ids,), batcher = asyncio.run(_serve(
        _handler(g), g, after_start=lambda: monkeypatch.setenv("PILOTTAI_QMATMUL", "native")))
    assert batcher.graph_report()["qmatmul_arm"] == "dequant"
    assert arm_calls["dequant"] > 0 and arm_calls["native"] == 0
    assert {w.arm for w in quant.iter_quantized(batcher.params)} == {"dequant"}


def test_two_batchers_over_one_tree_hold_their_own_arms(monkeypatch, arm_calls):
    """Each batcher stamps its arm on its own copy of the parameter tree:
    a second batcher built over the same weights under the other arm
    leaves the first one's weights, and the caller's, as they were; the
    tensors are shared, not copied."""
    from pilottai_tpu_torch.engine.batcher import ContinuousBatcher
    from pilottai_tpu_torch.models import registry
    from pilottai_tpu_torch.models.loader import load_npz

    dev = torch.device("cpu")
    cfg = registry.get_model_config("protocol-s").replace(dtype=torch.float32)
    params = quant.quantize_params(load_npz(PROTOCOL_S_NPZ, cfg, device=dev), torch.float32,
                                   bits=4, group=128)

    def build(arm):
        monkeypatch.setenv("PILOTTAI_QMATMUL", arm)
        return ContinuousBatcher(cfg, params, dev, n_slots=2, admit_batch=2, max_seq_len=128,
                                 chunk_size=8, prefix_cache=0, chunk_policy="fixed")

    first, second = build("native"), build("dequant")
    assert (first.qmatmul_arm, second.qmatmul_arm) == ("native", "dequant")
    assert {w.arm for w in quant.iter_quantized(first.params)} == {"native"}
    assert {w.arm for w in quant.iter_quantized(second.params)} == {"dequant"}
    assert {w.arm for w in quant.iter_quantized(params)} == {None}
    w0, w1, w2 = (p["layers"][0]["mlp"]["wg"] for p in (params, first.params, second.params))
    assert w1.q is w0.q and w2.q is w0.q and w1.s is w0.s

    x = torch.randn((3, cfg.hidden_size), generator=torch.Generator().manual_seed(0))
    monkeypatch.setenv("PILOTTAI_QMATMUL", "dequant")
    qm.qmatmul(x, w1)
    assert arm_calls == {"native": 1, "dequant": 0}
    monkeypatch.setenv("PILOTTAI_QMATMUL", "native")
    qm.qmatmul(x, w2)
    assert arm_calls == {"native": 1, "dequant": 1}
