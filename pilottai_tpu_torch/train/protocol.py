"""Protocol-model training: teach a small byte-vocab model the rules.json
JSON wire protocol so agents complete tasks on the real engine (the port's
counterpart of ``pilottai_tpu/train/protocol.py``).

The supervised pairs come from the exact prompts the runtime renders (the
same ``PromptManager`` templates, ``render_generic_request`` framing, byte
tokenizer and left-truncation as the batcher), drawn with the JAX
package's numpy draws, so ``protocol_batches`` gives the same arrays for
the same seed. Targets are compact JSON in schema property order.
``train_protocol`` fine-tunes with prompt-masked loss through the port's
``Trainer`` and saves the bf16 serving checkpoint as the ``.npz`` that
``models/loader.py:load_npz`` reads (``LLMConfig.checkpoint_path``), in
place of the JAX package's orbax tree.

The curriculum covers every protocol call the orchestrator and the agent
loop make: agent task_analysis, tool_selection, step_planning
(tools/no-tools x fresh/after-step histories) and result_evaluation;
orchestrator task_analysis, task_decomposition, agent_selection,
execution_strategy and result_evaluation.
"""

from __future__ import annotations

import json
import logging
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from pilottai_tpu_torch.core.task import Task
from pilottai_tpu_torch.engine.base import render_generic_request
from pilottai_tpu_torch.engine.tokenizer import ByteTokenizer
from pilottai_tpu_torch.engine.types import ChatMessage, ToolSpec
from pilottai_tpu_torch.models.loader import PROTOCOL_S_NPZ
from pilottai_tpu_torch.prompts.manager import PromptManager

# Serving defaults the training data mirrors: KV budget 1024, reply budget
# 224 (the longest curriculum target, the decomposition subtask array, is
# ~210 bytes) -> the batcher keeps the last 1024-1-224 = 799 prompt tokens.
SERVE_MAX_SEQ = 1024
SERVE_MAX_NEW = 224
DEFAULT_CHECKPOINT = Path(PROTOCOL_S_NPZ)

_log = logging.getLogger("pilottai_tpu_torch.train.protocol")


def _dumps(obj: Any) -> str:
    """Compact JSON — the only serialization the schema DFA admits."""
    return json.dumps(obj, separators=(",", ":"))


# --------------------------------------------------------------------- #
# Synthetic traffic pools (original wording; varied so the model keys on
# the protocol markers, not on any one task text)
# --------------------------------------------------------------------- #

_VERBS = [
    "summarize", "check", "extract", "validate", "analyze", "compile",
    "review", "inspect", "collect", "classify", "draft", "audit",
    "reconcile", "translate", "index", "answer from",
]
_OBJECTS = [
    "document {n}", "inventory {n}", "the quarterly report",
    "customer feedback batch {n}", "the extracted sections",
    "server logs for day {n}", "the meeting notes", "dataset {n}",
    "the incident timeline", "invoice {n}", "the design proposal",
    "section {n} of the handbook",
]
_QUALIFIERS = [
    "", " for the executive team", " before the deadline",
    " and report anomalies", " with citations", " into semantic memory",
    " for completeness", " against the checklist", " in two paragraphs",
]
_ROLES = [
    "worker", "extractor", "evaluator", "generator", "researcher",
    "analyst", "planner", "writer", "manager", "reviewer",
]
_GOALS = [
    "complete assigned tasks accurately",
    "extract document content into memory",
    "validate extraction quality",
    "produce grounded summaries",
    "coordinate the document pipeline",
    "answer questions from stored knowledge",
]
_TOOLS: List[Tuple[str, str]] = [
    ("extract_sections", "Read a document and store its sections in memory"),
    ("validate_extraction",
     "Structurally validate the extracted sections in memory"),
    ("search_notes", "Semantic-search the extracted sections"),
    ("memory_search", "Search the agent's semantic memory"),
    ("knowledge_query", "Query the attached knowledge sources"),
    ("fetch_report", "Fetch a stored report by name"),
    ("parse_log", "Parse a structured log file"),
    ("tabulate", "Aggregate rows into a summary table"),
    ("spell_check", "Check a text for spelling problems"),
    ("send_digest", "Send the daily digest"),
]
_TYPES = [
    "generic", "extract", "evaluate", "summarize", "analyze", "research",
]
# Task-type → agent-role affinity the selection curriculum teaches (the
# document pipeline's stage mapping plus the obvious ones).
_TYPE_ROLE = {
    "extract": "extractor",
    "evaluate": "evaluator",
    "summarize": "generator",
    "analyze": "analyst",
    "research": "researcher",
    "generic": "worker",
}
_TOOL_RESULTS = [
    "{'sections': 4, 'characters': 5120, 'headings': ['Overview', 'Risks']}",
    "{'valid': True, 'sections': 4, 'issues': []}",
    "['Revenue grew 12% quarter over quarter', 'Churn fell to 2.1%']",
    "{'rows': 128, 'anomalies': 0}",
    "ok",
]
_MEMORY_FACTS = [
    "Overview: the program is on track for the Q3 launch",
    "Risks: vendor delivery slipped two weeks in May",
    "the customer reported intermittent failures on node 7",
    "Findings: revenue grew 12% quarter over quarter",
    "the handbook requires dual sign-off for refunds",
]


def _history(r: _Rand, body: str) -> str:
    """Step-planning progress block, optionally led by retrieved-memory
    grounding (core/agent.py prepends this exact framing)."""
    if r.bool(0.3):
        k = int(r.rng.integers(1, 3))
        facts = "\n".join(f"- {r.choice(_MEMORY_FACTS)}" for _ in range(k))
        return f"relevant memory:\n{facts}\n{body}"
    return body


class _Rand:
    """Thin wrapper so every choice draws from one seeded generator."""

    def __init__(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def choice(self, seq):
        return seq[int(self.rng.integers(len(seq)))]

    def uuid(self) -> str:
        return str(uuid.UUID(bytes=self.rng.bytes(16), version=4))

    def bool(self, p: float) -> bool:
        return float(self.rng.random()) < p


def _task(r: _Rand, with_tools: bool) -> Tuple[Task, List[Tuple[str, str]]]:
    n = int(r.rng.integers(1, 999))
    desc = (
        r.choice(_VERBS) + " " + r.choice(_OBJECTS).format(n=n)
        + r.choice(_QUALIFIERS)
    )
    tools = []
    if with_tools:
        k = int(r.rng.integers(1, 4))
        idx = r.rng.permutation(len(_TOOLS))[:k]
        tools = [_TOOLS[i] for i in idx]
    payload = {}
    if r.bool(0.4):
        payload["path"] = f"/data/doc_{n}.md"
    if r.bool(0.3):
        payload["question"] = f"What are the key findings in {n}?"
    task = Task(
        id=r.uuid(),
        description=desc,
        type=r.choice(_TYPES),
        tools=[name for name, _ in tools],
        payload=payload,
        priority=r.choice(["low", "normal", "normal", "high"]),
    )
    return task, tools


def _agent_messages(
    r: _Rand, pm: PromptManager, user_prompt: str
) -> List[ChatMessage]:
    system = pm.format_prompt(
        "system.base",
        role=r.choice(_ROLES),
        goal=r.choice(_GOALS),
        backstory="none",
    )
    return [
        ChatMessage(role="system", content=system),
        ChatMessage(role="user", content=user_prompt),
    ]


def make_example(r: _Rand, pms: Dict[str, PromptManager]) -> Tuple[str, str]:
    """One (rendered_prompt_text, target_json_text) supervised pair,
    drawn from the protocol curriculum."""
    agent_pm, orch_pm = pms["agent"], pms["orchestrator"]
    kind = r.choice(
        # Weighted by how decisive the call is for task success;
        # tooled-fresh heaviest — invoking the offered tool (a name
        # copy) is the hardest decision the loop depends on.
        ["analysis"] * 3 + ["tool_selection"] * 3
        + ["step_tools_fresh"] * 7 + ["step_tools_done"] * 5
        + ["step_plain"] * 4 + ["evaluation"] * 4
        + ["orch_analysis"] * 2 + ["orch_decompose"]
        + ["orch_select"] * 4 + ["orch_strategy"] + ["orch_eval"] * 2
    )

    if kind == "analysis":
        task, _ = _task(r, with_tools=r.bool(0.5))
        prompt = agent_pm.format_prompt("task_analysis", task=task.to_prompt())
        msgs = _agent_messages(r, agent_pm, prompt)
        target = _dumps({
            "understanding": "the task and its goal are clear",
            "approach": "execute the task directly",
            "estimated_steps": 2,
            "risks": [],
        })
        return render_generic_request(msgs), target

    if kind == "tool_selection":
        task, tools = _task(r, with_tools=True)
        prompt = agent_pm.format_prompt(
            "tool_selection",
            task=task.to_prompt(),
            tools="\n".join(f"{n}: {d}" for n, d in tools),
        )
        msgs = _agent_messages(r, agent_pm, prompt)
        specs = [ToolSpec(name=n, description=d) for n, d in tools]
        target = _dumps({
            "selected_tools": [tools[0][0]],
            "reasoning": "best fit for the task",
        })
        return render_generic_request(msgs, specs), target

    if kind in ("step_tools_fresh", "step_tools_done"):
        task, tools = _task(r, with_tools=True)
        if kind == "step_tools_fresh":
            history = "none yet"
            target = _dumps({
                "task_complete": False,
                "action": tools[0][0],
                "arguments": {},
                "reasoning": "run the tool first",
            })
        else:
            history = (
                f"step 0: {tools[0][0]} -> {r.choice(_TOOL_RESULTS)}"
            )
            # No "output" key: the agent keeps the tool result as the
            # stage output (core/agent.py step loop).
            target = _dumps({
                "task_complete": True,
                "action": "respond",
                "arguments": {},
                "reasoning": "the tool produced the result",
            })
        prompt = agent_pm.format_prompt(
            "step_planning", task=task.to_prompt(), history=_history(r, history)
        )
        msgs = _agent_messages(r, agent_pm, prompt)
        specs = [ToolSpec(name=n, description=d) for n, d in tools]
        return render_generic_request(msgs, specs), target

    if kind == "step_plain":
        task, _ = _task(r, with_tools=False)
        history = (
            "none yet" if r.bool(0.7)
            else f"step 0: respond -> {r.choice(_TOOL_RESULTS)}"
        )
        prompt = agent_pm.format_prompt(
            "step_planning", task=task.to_prompt(), history=_history(r, history)
        )
        msgs = _agent_messages(r, agent_pm, prompt)
        target = _dumps({
            "task_complete": True,
            "action": "respond",
            "arguments": {},
            "output": "The task has been completed as requested.",
            "reasoning": "direct answer",
        })
        return render_generic_request(msgs), target

    if kind == "evaluation":
        task, _ = _task(r, with_tools=r.bool(0.5))
        failed = r.bool(0.15)
        result = (
            "tool error: " + r.choice(
                ["timeout after 30s", "missing required arguments ['path']",
                 "permission denied"]
            )
            if failed else r.choice(_TOOL_RESULTS)
        )
        prompt = agent_pm.format_prompt(
            "result_evaluation", task=task.to_prompt(), result=result
        )
        msgs = _agent_messages(r, agent_pm, prompt)
        target = _dumps({
            "success": not failed,
            "quality": 0.2 if failed else 0.9,
            "issues": ["the tool call failed"] if failed else [],
            "suggestions": ["retry with different arguments"] if failed else [],
        })
        return render_generic_request(msgs), target

    # Orchestrator calls go through apredict: a single user turn.
    if kind == "orch_analysis":
        task, _ = _task(r, with_tools=False)
        prompt = orch_pm.format_prompt("task_analysis", task=task.to_prompt())
        target = _dumps({
            "requires_decomposition": False,
            "complexity": 2,
            "estimated_resources": {"agents": 1, "llm_calls": 4},
            "reasoning": "single-stage task",
        })
        return render_generic_request([ChatMessage(content=prompt)]), target

    if kind == "orch_decompose":
        task, _ = _task(r, with_tools=False)
        prompt = orch_pm.format_prompt(
            "task_decomposition", task=task.to_prompt()
        )
        target = _dumps({"subtasks": [
            {"description": "gather the needed material", "type": "extract",
             "priority": "normal", "depends_on": []},
            {"description": "produce the final result", "type": "summarize",
             "priority": "normal", "depends_on": [0]},
        ]})
        return render_generic_request([ChatMessage(content=prompt)]), target

    if kind == "orch_select":
        # Selection is ROLE-AWARE, not first-listed: the candidate whose
        # role matches the task type wins (shuffled positions force the
        # model to find the line, not copy position 0 — a first-id
        # habit routed every pipeline stage to the same agent).
        task, _ = _task(r, with_tools=False)
        n = int(r.rng.integers(2, 5))
        ids = [r.uuid() for _ in range(n)]
        match_role = _TYPE_ROLE.get(task.type)
        roles = []
        others = [x for x in _ROLES if x != match_role]
        for _ in range(n):
            roles.append(r.choice(others))
        pick = int(r.rng.integers(n))
        if match_role is not None and r.bool(0.85):
            roles[pick] = match_role
            chosen = ids[pick]
        else:
            chosen = ids[0]  # no matching role listed → first candidate
        agents = "\n".join(
            f"{aid}: {role}, load={float(r.rng.random()):.2f}, "
            f"success={float(r.rng.random()):.2f}"
            for aid, role in zip(ids, roles)
        )
        prompt = orch_pm.format_prompt(
            "agent_selection", task=task.to_prompt(), agents=agents
        )
        target = _dumps({
            "agent_id": chosen,
            "reasoning": "role matches the task",
        })
        return render_generic_request([ChatMessage(content=prompt)]), target

    if kind == "orch_strategy":
        tasks = "\n".join(
            _task(r, with_tools=False)[0].to_prompt()
            for _ in range(int(r.rng.integers(1, 3)))
        )
        prompt = orch_pm.format_prompt(
            "execution_strategy", tasks=tasks,
            state=f"{{'agents': {int(r.rng.integers(1, 32))}, "
                  f"'queued': {int(r.rng.integers(0, 8))}}}",
        )
        target = _dumps({
            "strategy": "parallel",
            "max_parallel": 4,
            "reasoning": "tasks are independent",
        })
        return render_generic_request([ChatMessage(content=prompt)]), target

    # orch_eval
    task, _ = _task(r, with_tools=False)
    prompt = orch_pm.format_prompt(
        "result_evaluation", task=task.to_prompt(),
        agent_id=r.uuid(), result=r.choice(_TOOL_RESULTS),
    )
    target = _dumps({
        "quality": 0.9,
        "requires_retry": False,
        "feedback": "",
    })
    return render_generic_request([ChatMessage(content=prompt)]), target


# --------------------------------------------------------------------- #
# Batching
# --------------------------------------------------------------------- #

def encode_example(
    prompt_text: str,
    target_text: str,
    tokenizer: ByteTokenizer,
    seq_len: int,
    max_new: int = SERVE_MAX_NEW,
    serve_max_seq: int = SERVE_MAX_SEQ,
) -> Tuple[List[int], int]:
    """(row_ids, loss_start): BOS + prompt + target + EOS, with the prompt
    left-truncated exactly like the serving batcher truncates it
    (``engine/batcher.py:415-418``) and further to fit ``seq_len``."""
    prompt_ids = tokenizer.encode(prompt_text)  # [bos] + bytes
    target_ids = tokenizer.encode(target_text, add_bos=False)
    target_ids = target_ids[: max_new - 1] + [tokenizer.eos_id]
    keep = serve_max_seq - 1 - max_new
    keep = min(max(keep, 1), serve_max_seq - 2, seq_len - len(target_ids))
    if len(prompt_ids) > keep:
        prompt_ids = prompt_ids[-keep:]
    row = prompt_ids + target_ids
    return row, len(prompt_ids)


def protocol_batches(
    batch_size: int,
    seq_len: int,
    seed: int = 0,
    tokenizer: Optional[ByteTokenizer] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite stream of prompt-masked protocol batches."""
    tokenizer = tokenizer or ByteTokenizer()
    r = _Rand(seed)
    pms = {"agent": PromptManager("agent"),
           "orchestrator": PromptManager("orchestrator")}
    pad = tokenizer.pad_id
    while True:
        tokens = np.full((batch_size, seq_len), pad, np.int32)
        valid = np.zeros((batch_size,), np.int32)
        loss_start = np.zeros((batch_size,), np.int32)
        for b in range(batch_size):
            prompt_text, target_text = make_example(r, pms)
            row, start = encode_example(
                prompt_text, target_text, tokenizer, seq_len
            )
            tokens[b, : len(row)] = row
            valid[b] = len(row)
            loss_start[b] = start
        yield {"tokens": tokens, "valid": valid, "loss_start": loss_start}


# --------------------------------------------------------------------- #
# Training entry
# --------------------------------------------------------------------- #

def train_protocol(
    model_name: str = "protocol-s",
    steps: int = 3000,
    batch_size: int = 64,
    seq_len: int = SERVE_MAX_SEQ,
    learning_rate: float = 1e-3,
    seed: int = 0,
    out_path: Optional[str | Path] = None,
    mesh: Optional[Any] = None,
    log_every: int = 100,
    device: Any = None,
) -> Dict[str, Any]:
    """Train the protocol model from random init (seed ``seed``) and, with
    ``out_path``, save the bf16 serving checkpoint there as an ``.npz``
    (loadable via ``LLMConfig.checkpoint_path``). Runs on the CUDA device
    unless ``device="cpu"``; a ``mesh`` is refused (ROADMAP P10)."""
    import torch

    from pilottai_tpu_torch.models.loader import params_to_numpy
    from pilottai_tpu_torch.models.registry import get_model_config
    from pilottai_tpu_torch.train.trainer import TrainConfig, Trainer, cast_params

    cfg = get_model_config(model_name)
    trainer = Trainer(
        cfg,
        TrainConfig(
            learning_rate=learning_rate,
            warmup_steps=min(100, max(steps // 10, 1)),
            total_steps=steps,
        ),
        mesh=mesh,
        device=device,
    )
    state = trainer.init(torch.Generator(trainer.device).manual_seed(seed))
    batches = protocol_batches(batch_size, seq_len, seed=seed)
    losses: List[float] = []
    t0 = time.perf_counter()
    for step in range(steps):
        state, metrics = trainer.step(state, next(batches))
        if (step + 1) % log_every == 0 or step + 1 == steps:
            loss = float(metrics["loss"])
            losses.append(loss)
            rate = (step + 1) / (time.perf_counter() - t0)
            _log.info("protocol train step %d/%d loss %.4f (%.2f steps/s)",
                      step + 1, steps, loss, rate)
    with torch.no_grad():
        serve_params = cast_params(state.params, torch.bfloat16)
    result: Dict[str, Any] = {"final_loss": losses[-1] if losses else None, "steps": steps}
    if out_path is not None:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(out_path, **params_to_numpy(serve_params))
        result["out_path"] = str(out_path)
        _log.info("saved protocol checkpoint to %s", out_path)
    result["params"] = serve_params
    return result


def has_checkpoint(path: Optional[str | Path] = None) -> bool:
    """True when a protocol checkpoint (a non-empty ``.npz``) is present at
    ``path`` (default: the shipped one)."""
    path = Path(path) if path is not None else DEFAULT_CHECKPOINT
    return path.is_file() and path.stat().st_size > 0


def ensure_protocol_checkpoint(
    path: Optional[str | Path] = None,
    steps: int = 3000,
    **kwargs: Any,
) -> Path:
    """The checkpoint at ``path`` if present, else train one into it."""
    path = Path(path) if path is not None else DEFAULT_CHECKPOINT
    if has_checkpoint(path):
        return path
    _log.info("no protocol checkpoint at %s; training one (steps=%d)", path, steps)
    train_protocol(steps=steps, out_path=path, **kwargs)
    return path


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="train the protocol model")
    ap.add_argument("--model", default="protocol-s")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--seq-len", type=int, default=SERVE_MAX_SEQ)
    ap.add_argument("--learning-rate", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True, help="the .npz to write")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args()
    out = train_protocol(
        model_name=args.model, steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, learning_rate=args.learning_rate,
        seed=args.seed, out_path=args.out, device=args.device,
    )
    print(json.dumps({k: v for k, v in out.items() if k != "params"}))
