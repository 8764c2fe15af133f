"""The protocol-training pieces of the port against the JAX package, and
the train-state checkpoint: the JSON copy of the prompt rules, the
curriculum (``make_example``, ``protocol_batches``), ``Task.to_prompt``,
the npz weight round trip, ``TrainCheckpointer`` resume, and
``train_protocol`` writing a checkpoint the port's engine serves. All on
the CPU; arrays and texts must be equal, not close."""

import asyncio
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from pilottai_tpu.core.task import Task as JTask
from pilottai_tpu.prompts.manager import PromptManager as JPromptManager
from pilottai_tpu.train import protocol as jprotocol
from pilottai_tpu_torch import LLMConfig, LLMHandler
from pilottai_tpu_torch.checkpoint import TrainCheckpointer
from pilottai_tpu_torch.core.task import Task
from pilottai_tpu_torch.models import registry
from pilottai_tpu_torch.models.loader import PROTOCOL_S_NPZ, load_npz, params_to_numpy
from pilottai_tpu_torch.prompts.manager import PromptManager
from pilottai_tpu_torch.train import protocol
from pilottai_tpu_torch.train.trainer import TrainConfig, Trainer, param_leaves

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast and does not
    oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rules_json_is_the_yaml_and_templates_format_alike():
    rules = json.loads((ROOT / "pilottai_tpu_torch/prompts/rules.json").read_text())
    assert rules == yaml.safe_load((ROOT / "pilottai_tpu/prompts/rules.yaml").read_text())
    for namespace in ("agent", "orchestrator"):
        ours, theirs = PromptManager(namespace), JPromptManager(namespace)
        assert ours.available() == theirs.available()
        stack = [("", theirs.available())]
        while stack:
            prefix, node = stack.pop()
            for key, value in node.items():
                if isinstance(value, dict):
                    stack.append((f"{prefix}{key}.", value))
                    continue
                kwargs = {p: f"<{p} {{x}}>" for p in theirs.placeholders(value)}
                name = prefix + key
                assert ours.format_prompt(name, **kwargs) == theirs.format_prompt(name, **kwargs)


def test_task_to_prompt_is_byte_identical():
    fields = dict(id="7c2a", description="audit invoice 12 with citations", type="evaluate",
                  tools=["parse_log", "tabulate"], priority="high",
                  payload={"path": "/data/doc_12.md", "question": "What?"},
                  required_skills=["math"], context={"parent": "p1"})
    assert Task(**fields).to_prompt() == JTask(**fields).to_prompt()
    assert Task(description="x").priority.name == "NORMAL"


def test_curriculum_and_protocol_batches_equal_the_jax_ones():
    pms = {"agent": PromptManager("agent"), "orchestrator": PromptManager("orchestrator")}
    jpms = {"agent": JPromptManager("agent"), "orchestrator": JPromptManager("orchestrator")}
    ours, theirs = protocol._Rand(5), jprotocol._Rand(5)
    for _ in range(60):
        assert protocol.make_example(ours, pms) == jprotocol.make_example(theirs, jpms)
    a, b = protocol.protocol_batches(4, 512, seed=3), jprotocol.protocol_batches(4, 512, seed=3)
    for _ in range(3):
        x, y = next(a), next(b)
        assert sorted(x) == sorted(y) == ["loss_start", "tokens", "valid"]
        for key in x:
            assert x[key].dtype == y[key].dtype
            np.testing.assert_array_equal(x[key], y[key])


def test_params_to_numpy_round_trips_the_shipped_npz():
    cfg = registry.get_model_config("protocol-s")
    params = load_npz(PROTOCOL_S_NPZ, cfg, device="cpu", dtype=torch.bfloat16)
    flat = params_to_numpy(params)
    with np.load(PROTOCOL_S_NPZ) as npz:
        assert sorted(flat) == sorted(npz.files)
        for key in npz.files:
            np.testing.assert_array_equal(flat[key], npz[key], err_msg=key)
    fp32 = params_to_numpy(load_npz(PROTOCOL_S_NPZ, cfg, device="cpu", dtype=torch.float32))
    assert fp32["embed"].dtype == np.float32


def test_checkpoint_resume_is_exact(tmp_path):
    cfg = registry.get_model_config("protocol-xs").replace(dtype=torch.float32)
    trainer = Trainer(cfg, TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=12),
                      device="cpu")
    stream = protocol.protocol_batches(2, 256, seed=1)
    batches = [next(stream) for _ in range(4)]
    straight = trainer.init(torch.Generator().manual_seed(0))
    for batch in batches:
        straight, last = trainer.step(straight, batch)
    first = trainer.init(torch.Generator().manual_seed(0))
    for batch in batches[:2]:
        first, _ = trainer.step(first, batch)
    ckpt = TrainCheckpointer(tmp_path, max_to_keep=2)
    for step in (1, 2, 3):
        ckpt.save(step, first)
    assert ckpt.all_steps() == [2, 3] and ckpt.latest_step() == 3
    ckpt.save(0, first)                 # a rollback save keeps the step it wrote
    assert ckpt.all_steps() == [0, 2, 3] and ckpt.latest_step() == 0
    resumed, step = ckpt.restore(trainer.init(torch.Generator().manual_seed(9)), step=2)
    assert step == 2 and resumed.step == 2
    for batch in batches[2:]:
        resumed, again = trainer.step(resumed, batch)
    assert float(again["loss"]) == float(last["loss"])
    assert resumed.scheduler.last_epoch == straight.scheduler.last_epoch == 4
    for a, b in zip(param_leaves(straight.params), param_leaves(resumed.params)):
        assert torch.equal(a, b)


def test_train_protocol_writes_a_checkpoint_the_engine_serves(tmp_path):
    out = tmp_path / "protocol_xs.npz"
    result = protocol.train_protocol(model_name="protocol-xs", steps=2, batch_size=2,
                                     seq_len=256, out_path=out, device="cpu", log_every=1)
    assert np.isfinite(result["final_loss"]) and out.is_file()
    assert protocol.has_checkpoint(out) and not protocol.has_checkpoint(tmp_path / "none.npz")
    assert protocol.ensure_protocol_checkpoint(out, steps=1) == out

    async def serve():
        handler = LLMHandler(LLMConfig(
            provider="cpu", model_name="protocol-xs", checkpoint_path=str(out),
            dtype="float32", engine_slots=1, engine_admit_batch=1, engine_max_seq=256,
            sampling={"temperature": 0.0, "max_new_tokens": 12},
        ))
        await handler.start()
        try:
            return await handler.generate_response(["Plan the next step."], json_mode=True)
        finally:
            await handler.stop()

    reply = asyncio.run(serve())
    assert reply.usage.completion_tokens > 0
    json.loads(reply.content)                           # JSON mode: the reply parses
