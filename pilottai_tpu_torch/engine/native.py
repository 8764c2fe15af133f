"""The port's engine backend: ``TorchEngine``, the counterpart of
``pilottai_tpu/engine/native.py:NativeEngine``.

Weights live on one device (the CUDA device unless ``provider="cpu"``);
generations run through the batcher's device thread and asyncio callers
await futures bridged from it. Settings outside this slice are refused
by ``LLMConfig``. From a context length of 4096 on the KV cache is paged
unless ``engine_paged_kv`` says otherwise, as in the JAX engine. With
``engine_quant`` (or its alias ``quantize``) ``"int8"`` or ``"int4"`` the
matmul weights are quantized once, after they are loaded or made and
before the batcher is built (``models/quant.py:quantize_params``, in
place, leaf by leaf). With ``engine_kv_quantize="int8"`` the batcher's
KV cache is int8 with per-token scales; the two quantizations compose.
``start``
returns once the batcher's warm-up sweep has captured every chunk graph
and run every prefill bucket (``ContinuousBatcher.warmup``); a sweep that
fails makes it raise.
"""

from __future__ import annotations

import asyncio
import logging
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from pilottai_tpu_torch.core.config import LLMConfig, NotInSlice, refuse_later
from pilottai_tpu_torch.device import resolve_device
from pilottai_tpu_torch.engine.base import LLMBackend, parse_tool_calls, render_generic_request
from pilottai_tpu_torch.engine.batcher import ContinuousBatcher, GenRequest
from pilottai_tpu_torch.engine.tokenizer import ByteTokenizer
from pilottai_tpu_torch.engine.types import (
    ChatMessage,
    GenerationParams,
    LLMResponse,
    ToolSpec,
    Usage,
)
from pilottai_tpu_torch.models.common import init_params
from pilottai_tpu_torch.models.loader import load_npz
from pilottai_tpu_torch.models.quant import quantize_params
from pilottai_tpu_torch.models.registry import get_model_config

# Request fields whose feature belongs to a later slice, and its ROADMAP item.
_REQUEST_LATER = {
    "json_schema": "serve",
    "deadline": "reliability",
    "slo_class": "reliability",
    "priority": "sched",
    "gang_id": "sched",
    "session_id": "kvtier",
}

_log = logging.getLogger(__name__)


class TorchEngine(LLMBackend):
    """PyTorch serving engine with continuous batching on one device."""

    def __init__(self, config: LLMConfig) -> None:
        self.config = config
        self.device = resolve_device("cpu" if config.provider == "cpu" else None)
        self.name = config.provider
        self.batcher: Optional[ContinuousBatcher] = None
        self.tokenizer = ByteTokenizer()
        cfg = get_model_config(config.model_name)
        # No checkpoint → shrink the vocab to the byte tokenizer's, as the
        # JAX engine does, so random-init serving is cheap and coherent.
        if config.checkpoint_path is None and cfg.vocab_size != self.tokenizer.vocab_size:
            cfg = cfg.replace(vocab_size=self.tokenizer.vocab_size, tie_embeddings=True)
        dtype = torch.bfloat16 if config.dtype == "bfloat16" else torch.float32
        self.model_cfg = cfg.replace(dtype=dtype)
        self.max_seq = config.engine_max_seq or min(self.model_cfg.max_seq_len, 2048)
        # engine_quant wins; the legacy ``quantize`` field is its alias.
        self.quant_mode = config.engine_quant or config.quantize or "none"
        #: Seconds the start spent quantizing the weights (0 when dense).
        self.quantize_seconds = 0.0
        # As in the JAX engine, long contexts page the cache.
        self.paged = (
            config.engine_paged_kv if config.engine_paged_kv is not None else self.max_seq >= 4096
        )
        if config.checkpoint_path is not None and Path(config.checkpoint_path).is_dir():
            raise NotInSlice(
                "checkpoint_path must be a .npz written by scripts/export_protocol_s_npz.py; "
                "orbax and Hugging Face checkpoints arrive with ROADMAP item P9"
            )
        self._start_lock = asyncio.Lock()

    async def start(self) -> None:
        async with self._start_lock:
            if self.batcher is None:
                await asyncio.get_running_loop().run_in_executor(None, self._start_blocking)

    def _start_blocking(self) -> None:
        cfg = self.model_cfg
        if self.config.checkpoint_path is not None:
            params = load_npz(self.config.checkpoint_path, cfg, device=self.device, dtype=cfg.dtype)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.config.seed)
            params = init_params(cfg, gen, device=self.device)
        if self.quant_mode in ("int8", "int4"):
            t0 = time.perf_counter()
            params = quantize_params(params, dtype=cfg.dtype,
                                     bits=4 if self.quant_mode == "int4" else 8,
                                     group=self.config.engine_quant_group)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.quantize_seconds = time.perf_counter() - t0
            _log.info("quantized matmul weights to %s (weight-only%s) in %.2f s", self.quant_mode,
                      f", group {self.config.engine_quant_group}"
                      if self.quant_mode == "int4" else "", self.quantize_seconds)
        batcher = ContinuousBatcher(
            cfg, params, self.device,
            n_slots=self.config.engine_slots,
            admit_batch=self.config.engine_admit_batch,
            max_seq_len=self.max_seq,
            chunk_size=self.config.engine_chunk,
            paged=self.paged,
            page_size=self.config.engine_page_size,
            num_pages=self.config.engine_kv_pages,
            prefill_chunk=self.config.engine_prefill_chunk,
            pipeline_depth=self.config.engine_pipeline,
            overlap_admission=self.config.engine_overlap_admission,
            chunk_policy=self.config.engine_chunk_policy,
            chunk_buckets=self.config.engine_chunk_buckets,
            fused_epilogue=self.config.engine_fused_epilogue,
            prefix_cache=self.config.engine_prefix_cache,
            prefix_min_len=self.config.engine_prefix_min_len,
            speculate=self.config.engine_speculate,
            draft_layers=self.config.engine_draft_layers,
            kv_quantize=self.config.engine_kv_quantize == "int8",
        )
        batcher.start()
        try:
            # Every chunk graph and prefill bucket before the first request,
            # as the JAX engine does at every start.
            batcher.warmup()
        except BaseException:
            batcher.stop()
            raise
        self.batcher = batcher

    async def stop(self) -> None:
        if self.batcher is not None:
            await asyncio.get_running_loop().run_in_executor(None, self.batcher.stop)
            self.batcher = None

    def _build_request(
        self,
        messages: Sequence[ChatMessage],
        tools: Optional[Sequence[ToolSpec]],
        params: GenerationParams,
    ) -> GenRequest:
        for field_name, item in _REQUEST_LATER.items():
            value = getattr(params, field_name)
            if value is not None:
                raise refuse_later(field_name, value, item)
        return GenRequest(
            prompt_ids=self.tokenizer.encode(render_generic_request(messages, tools)),
            max_new_tokens=params.max_new_tokens,
            temperature=params.temperature,
            top_k=params.top_k,
            top_p=params.top_p,
            seed=params.seed if params.seed is not None else 0,
            eos_id=self.tokenizer.eos_id,
            json_mode=params.json_mode,
        )

    async def generate(
        self,
        messages: Sequence[ChatMessage],
        tools: Optional[Sequence[ToolSpec]] = None,
        params: Optional[GenerationParams] = None,
    ) -> LLMResponse:
        params = params or GenerationParams()
        request = self._build_request(messages, tools, params)
        if self.batcher is None:
            await self.start()
        start = time.perf_counter()
        prompt_tokens = len(request.prompt_ids)  # before the keep-window truncation
        future = self.batcher.submit(request)
        try:
            token_ids = await asyncio.wrap_future(future)
        except asyncio.CancelledError:
            request.cancelled = True
            raise
        text = self.tokenizer.decode(token_ids)
        cut = _stop_cut(text, params.stop)
        if cut is not None:
            text = text[:cut]
        return LLMResponse(
            content=text,
            tool_calls=parse_tool_calls(text, [t.name for t in tools]) if tools else [],
            model=self.model_cfg.name,
            usage=Usage(prompt_tokens=prompt_tokens, completion_tokens=len(token_ids)),
            latency=time.perf_counter() - start,
            finish_reason="stop" if len(token_ids) < params.max_new_tokens else "length",
        )


def _stop_cut(text: str, stops) -> Optional[int]:
    """Earliest occurrence of any stop string in ``text``, or None."""
    cut = None
    for stop in stops:
        pos = text.find(stop)
        if pos >= 0:
            cut = pos if cut is None else min(cut, pos)
    return cut
