"""Export two head_dim 256 Gemma test models and the JAX engine's greedy
ids on them, for the PyTorch port's Gemma path.

The two models are tiny configurations registered here, at run time, with
the JAX package's own ``register_model`` (the package is not edited):

* ``gemma2-tiny-h256``: ``GEMMA_TINY`` (gemma2: soft-caps 30 and 50,
  sliding window 128 on every other layer, post norms, the RMSNorm offset,
  GeGLU, the embedding scale) at head_dim 256, 4 query heads on 2 kv heads;
* ``gemma-tiny-h256``: the same trunk as gemma-1 (no soft-caps, no window,
  no post norms) with one kv head, multi-query attention as ``gemma-2b``.

Both take the byte tokenizer's vocab of 384. The weights are the JAX
``init_params`` in float32 from a seed, with the embedding scaled by
``1 / hidden`` and ``wq``, ``wk`` by 4 (``draw_params``). Unscaled, the
random model repeats its last prompt token whatever its attention computes
(the embedding is tied, and the current token's own logit leads by far),
so its ids would pin nothing of the attention; scaled, attention is sharp
and the next token depends on the context. A random model's logits are
close together, though, so the seed is the first from ``SEED`` whose
greedy ids, dense and paged, all lead the next logit they could lose to
by at least ``MIN_MARGIN`` of the logits' spread (``min_margin``: with
JSON's mask, every logit below the chosen one counts as a rival), far
above the rounding of fp32 on either machine.

For each model the script writes the weights to
``pilottai_tpu_torch/assets/<name>.npz`` (flat ``/``-joined keys,
float32), hands the same tree to the JAX engine in place of its random
init (checked leaf by leaf after it starts), and serves the three golden
prompts of ``scripts/export_protocol_s_npz.py`` (about 415 tokens each,
past the window) through the JAX engine in float32 on the CPU,
``json_mode`` on and off, on the dense cache and on the paged one
(16-token pages, 64-token prefill segments). The ids go to
``assets/<name>_golden.json`` (dense) and ``assets/<name>_paged_golden.json``,
each with the config's fields and the weight recipe, so the port
registers the same model from the file. The port must reproduce them
token for token, on the CPU and on the GPU.

Run from the repository root (uses JAX on the CPU, a few minutes)::

    JAX_PLATFORMS=cpu python scripts/export_gemma_golden.py
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from export_protocol_s_npz import (  # noqa: E402  (sets up JAX on the CPU)
    ENGINE,
    MAX_NEW_TOKENS,
    OUT_DIR,
    flatten_params,
    golden_prompts,
)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pilottai_tpu.core.config import LLMConfig, SamplingConfig  # noqa: E402
from pilottai_tpu.engine.handler import LLMHandler  # noqa: E402
from pilottai_tpu.engine.types import ChatMessage, ToolSpec  # noqa: E402
from pilottai_tpu.models.common import init_params  # noqa: E402
from pilottai_tpu.models.gemma import GEMMA_TINY  # noqa: E402
from pilottai_tpu.models.registry import register_model  # noqa: E402
from pilottai_tpu.models.transformer import forward_prefill  # noqa: E402

SEED = 7
MIN_MARGIN = 1e-3
EMBED_SCALE = "1 / hidden"
QK_SCALE = 4.0
BYTE_VOCAB = 384
GEMMA2_TINY_H256 = GEMMA_TINY.replace(name="gemma2-tiny-h256", head_dim=256,
                                      vocab_size=BYTE_VOCAB)
GEMMA_TINY_H256 = GEMMA_TINY.replace(
    name="gemma-tiny-h256", family="gemma", head_dim=256, n_kv_heads=1,
    vocab_size=BYTE_VOCAB, post_norms=False, logit_softcap=0.0, attn_softcap=0.0,
    sliding_window=0, sliding_pattern=0,
)
CONFIGS = (GEMMA2_TINY_H256, GEMMA_TINY_H256)
PAGED_ENGINE = dict(
    ENGINE, engine_paged_kv=True, engine_page_size=16, engine_prefill_chunk=64,
)


def stem(cfg) -> str:
    return cfg.name.replace("-", "_")


def config_fields(cfg) -> dict:
    """The config's fields as JSON (the dtype is the engine's: float32)."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("dtype", "n_experts", "n_active_experts")}


def draw_params(cfg, seed: int) -> dict:
    """``init_params`` in float32 from ``seed``, the embedding times
    ``1 / hidden``, ``wq`` and ``wk`` times ``QK_SCALE``."""
    params = init_params(cfg.replace(dtype=jnp.float32), jax.random.PRNGKey(seed))
    params["embed"] = params["embed"] * jnp.float32(1.0 / cfg.hidden_size)
    attn = params["layers"]["attn"]
    attn["wq"] = attn["wq"] * jnp.float32(QK_SCALE)
    attn["wk"] = attn["wk"] * jnp.float32(QK_SCALE)
    return params


def min_margin(cfg, params, cases) -> float:
    """The smallest lead, over every generated token of ``cases``, of the
    chosen token's logit over the highest logit below it, in units of that
    position's logit standard deviation (teacher-forced prefill, fp32)."""
    seqs = [c["prompt_ids"] + c["token_ids"][:-1] for c in cases]
    T = max(map(len, seqs))
    tokens = np.zeros((len(seqs), T), np.int32)
    for i, seq in enumerate(seqs):
        tokens[i, :len(seq)] = seq
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), tokens.shape)
    logits, _, _ = forward_prefill(
        params, cfg.replace(dtype=jnp.float32), jnp.asarray(tokens), jnp.asarray(pos),
        jnp.asarray([len(s) for s in seqs], np.int32), use_flash=False)
    logits = np.asarray(logits)
    worst = np.inf
    for i, c in enumerate(cases):
        start = len(c["prompt_ids"]) - 1
        for j, tok in enumerate(c["token_ids"]):
            row = logits[i, start + j]
            below = np.delete(row, tok)
            below = below[below <= row[tok]]
            worst = min(worst, float((row[tok] - below.max()) / row.std()))
    return worst


async def serve(cfg, engine: dict, prompts: list, params: dict, seed: int) -> list:
    """The JAX engine's cases for every prompt, ``json_mode`` on then off,
    on ``draw_params(cfg, seed)`` in place of its random init, which must
    equal ``params``. The engine's compile warm-up is skipped: it changes
    no output."""
    from pilottai_tpu.engine import native
    from pilottai_tpu.engine.batcher import ContinuousBatcher

    real_warmup, real_init = ContinuousBatcher.warmup, native.init_params
    ContinuousBatcher.warmup = lambda self, *a, **k: None
    native.init_params = lambda *a, **k: draw_params(cfg, seed)
    try:
        handler = LLMHandler(LLMConfig(
            model_name=cfg.name, provider="cpu",
            engine_prefix_cache=0, engine_chunk_policy="fixed",
            sampling=SamplingConfig(temperature=0.0, max_new_tokens=MAX_NEW_TOKENS),
            **engine,
        ))
        await handler.start()
    finally:
        ContinuousBatcher.warmup, native.init_params = real_warmup, real_init
    batcher = handler.backend.batcher
    served = flatten_params(batcher.params)
    if sorted(served) != sorted(params) or not all(
            np.array_equal(served[k], params[k]) for k in params):
        raise SystemExit(f"{cfg.name}: the engine does not serve the exported weights")
    submitted = []
    submit = batcher.submit

    def recording_submit(request):
        submitted.append(request)
        return submit(request)

    batcher.submit = recording_submit
    cases = []
    try:
        for json_mode in (True, False):
            for i, p in enumerate(prompts):
                submitted.clear()
                resp = await handler.generate_response(
                    [ChatMessage(**m) for m in p["messages"]],
                    tools=[ToolSpec(**t) for t in p["tools"]] if p["tools"] else None,
                    json_mode=json_mode,
                )
                (request,) = submitted
                cases.append({
                    "prompt": i,
                    "json_mode": json_mode,
                    "prompt_ids": list(request.prompt_ids),
                    "token_ids": [int(t) for t in request.future.result()],
                    "text": resp.content,
                })
    finally:
        await handler.stop()
    return cases


def main() -> None:
    prompts = golden_prompts()
    for cfg in CONFIGS:
        register_model(cfg)
        for seed in range(SEED, SEED + 50):
            tree = draw_params(cfg, seed)
            params = flatten_params(tree)
            runs = {suffix: asyncio.run(serve(cfg, engine, prompts, params, seed))
                    for suffix, engine in (("", ENGINE), ("_paged", PAGED_ENGINE))}
            margin = min(min_margin(cfg, tree, cases) for cases in runs.values())
            print(f"{cfg.name} seed {seed}: min margin {margin:.3e}")
            if margin >= MIN_MARGIN:
                break
        else:
            raise SystemExit(f"{cfg.name}: no seed gives a margin of {MIN_MARGIN}")
        npz = OUT_DIR / f"{stem(cfg)}.npz"
        np.savez(npz, **params)
        print(f"wrote {npz} ({npz.stat().st_size / 2**20:.2f} MiB)")
        for suffix, engine, label in (("", ENGINE, "dense KV"),
                                      ("_paged", PAGED_ENGINE,
                                       "paged KV with chunked prefill")):
            cases = runs[suffix]
            golden = {
                "model": cfg.name,
                "config": config_fields(cfg),
                "checkpoint": npz.name,
                "seed": seed,
                "weights": f"init_params(PRNGKey({seed})) in float32, embed times "
                           f"{EMBED_SCALE}, wq and wk times {QK_SCALE:g}",
                "min_margin": margin,
                "source": f"JAX engine, LLMHandler(provider='cpu'), float32, greedy, {label}",
                "engine": engine,
                "max_new_tokens": MAX_NEW_TOKENS,
                "prompts": prompts,
                "cases": cases,
            }
            path = OUT_DIR / f"{stem(cfg)}{suffix}_golden.json"
            path.write_text(json.dumps(golden, indent=1) + "\n")
            for c in cases:
                print(cfg.name, suffix or "_dense", c["prompt"], c["json_mode"],
                      len(c["prompt_ids"]), len(c["token_ids"]), repr(c["text"][:60]))
            print(f"wrote {path}")


if __name__ == "__main__":
    main()
