"""Engine configuration for the port (its own copy of the fields of
``pilottai_tpu/core/config.py:LLMConfig`` this slice reads, under the
same names).

The JAX config has many more knobs. A knob whose feature comes with a
later slice is refused with ``NotInSlice``, naming the ROADMAP item that
brings it — unless it is set to the value the port already runs (for
example ``engine_sched_policy="fifo"``), which is accepted. No knob is ignored
silently: an unknown field is a validation error.
"""

from __future__ import annotations

from typing import Any, Dict, Literal, Optional, Tuple

from pydantic import BaseModel, ConfigDict, Field, field_validator, model_validator

Provider = Literal["cuda", "cpu"]


class NotInSlice(ValueError):
    """A setting whose feature the port does not carry yet."""


# ROADMAP.md, "Port slices", in the order they land.
ROADMAP = {
    "reliability": "P6b (retries, rate limits, deadlines and the reliability ladder)",
    "sched": "P6c (scheduling policies: priority, gangs and pre-warming)",
    "kvtier": "P7 (KV cache tier)",
    "serve": "P8 (Serve, agents and the document pipeline on the port)",
    "models": "P9b (MoE, Hugging Face checkpoints and tokenizers)",
    "multi": "P10 (multi-GPU)",
    "tooling": "P12 (tooling)",
    # Training (slice P11) refuses what its one-device path does not carry.
    "ring": "P10 (multi-GPU: ring attention, sharded flash, a mesh)",
    "moe": "P9b (MoE, Hugging Face checkpoints and tokenizers: the MoE layers)",
    "corpora": "P12 (tooling: cli.py train and text corpora)",
}

# JAX knob -> (values this slice already runs, ROADMAP item that brings the rest).
_LATER: Dict[str, Tuple[Tuple[Any, ...], str]] = {
    "engine_sched_policy": (("fifo",), "sched"),
    "engine_gang_wait_ms": ((50.0,), "sched"),
    "engine_priority_aging_s": ((2.0,), "sched"),
    "engine_prewarm_depth": ((0,), "sched"),
    "max_rpm": ((None,), "reliability"),
    "retries": ((0,), "reliability"),
    "retry_delay": ((1.0,), "reliability"),
    "reliability": ((None,), "reliability"),
    "engine_kvcache_host_mb": ((0,), "kvtier"),
    "engine_kvcache_policy": (("cost",), "kvtier"),
    "cell_disagg": ((None,), "serve"),
    "function_calling": ((True,), "serve"),
    "api_key": ((None,), "serve"),
    "tokenizer_path": ((None,), "models"),
    "mesh_shape": ((None,), "multi"),
    "engine_mesh_ladder": (("auto", "off"), "multi"),
    "engine_compile_cache": ((None,), "tooling"),
}


def refuse_later(knob: str, value: Any, item: str) -> NotInSlice:
    return NotInSlice(
        f"{knob}={value!r} is not in the port yet; it arrives with ROADMAP item "
        f"{ROADMAP[item]}"
    )


class SamplingConfig(BaseModel):
    """Engine-wide sampling defaults (a request's GenerationParams wins)."""

    model_config = ConfigDict(extra="forbid")

    temperature: float = Field(default=0.7, ge=0.0)
    top_k: int = Field(default=0, ge=0)
    top_p: float = Field(default=1.0, gt=0.0, le=1.0)
    max_new_tokens: int = Field(default=256, ge=1)
    seed: Optional[int] = None
    json_mode: bool = False


class LLMConfig(BaseModel):
    """The port's engine configuration: one device, KV in the compute dtype
    or int8 (dense, or paged from ``engine_max_seq`` 4096 on), the device
    tier of the prefix cache, speculative decoding, weight-only
    quantization (int8 or packed int4). The decode pipeline's five knobs,
    the prefix cache's two, speculation's two and quantization's four
    have the JAX package's names, defaults and meaning."""

    model_config = ConfigDict(extra="forbid", protected_namespaces=())

    model_name: str = "llama3-8b"
    provider: Provider = "cuda"
    checkpoint_path: Optional[str] = None   # a .npz written by scripts/export_protocol_s_npz.py
    sampling: SamplingConfig = Field(default_factory=SamplingConfig)
    max_concurrent_requests: int = Field(default=64, ge=1)
    timeout: float = Field(default=120.0, gt=0)
    dtype: Literal["bfloat16", "float32"] = "bfloat16"
    engine_slots: int = Field(default=8, ge=1)
    engine_admit_batch: int = Field(default=8, ge=1)
    engine_max_seq: Optional[int] = None    # KV length cap (default min(model max, 2048))
    engine_chunk: int = Field(default=16, ge=1)
    # Decode chunks dispatched ahead of the host's folds.
    engine_pipeline: int = Field(default=2, ge=1)
    # Admission staging (selection, pages, numpy packing) on its own thread.
    engine_overlap_admission: bool = True
    # "adaptive" sizes each chunk from the live budgets, quantised up to
    # engine_chunk_buckets (None: the quartile ladder of engine_chunk).
    engine_chunk_policy: Literal["fixed", "adaptive"] = "adaptive"
    engine_chunk_buckets: Optional[Tuple[int, ...]] = None
    # Vocab-tiled projection + argmax when every occupied slot is greedy
    # and unconstrained.
    engine_fused_epilogue: bool = True
    # Paged KV (ops/paged.py): None pages when engine_max_seq >= 4096.
    engine_paged_kv: Optional[bool] = None
    engine_page_size: int = Field(default=128, ge=8)
    # Pool pages; default n_slots * min(max_seq, 2048) / page_size + 1 (scratch page).
    engine_kv_pages: Optional[int] = Field(default=None, ge=2)
    # Chunked prefill segment (paged only); default 1024, rounded up to pages; 0 = off.
    engine_prefill_chunk: Optional[int] = Field(default=None, ge=0)
    # Automatic prefix caching: on the dense cache the store's entries (the
    # prompts' K/V panels, "cost" eviction), on the paged cache any value
    # above 0 turns the page index on (a quarter of the pool pinned at
    # most); 0 = off.
    engine_prefix_cache: int = Field(default=4, ge=0)
    # The dense store's entry floor in tokens (None = the 64-token prompt
    # bucket); shorter prompts never cache.
    engine_prefix_min_len: Optional[int] = Field(default=None, ge=1)
    # Speculative decoding: verify blocks of this many tokens a weight pass,
    # drafted from each slot's own history (0 = off; values below 2 are off).
    engine_speculate: int = Field(default=0, ge=0)
    # With engine_speculate: the target's first N layers (at most n_layers -
    # 1) draft for slots whose n-gram acceptance collapses (0 = off).
    engine_draft_layers: int = Field(default=0, ge=0)
    # Weight-only quantization ("none" | "int8" | "int4"; None follows the
    # legacy ``quantize`` alias): int8 per output channel, int4 packed two
    # to a byte with a scale per engine_quant_group contraction rows; an
    # untied lm_head stays int8 under int4 (models/quant.py).
    quantize: Optional[str] = None
    engine_quant: Optional[str] = None
    engine_quant_group: int = Field(default=128, ge=1)
    # int8 KV cache ("int8" or None): panels and page pools stored int8
    # with a symmetric fp32 scale per token and kv head
    # (ops/kvcache.py:quantize_kv); the in-chunk ring stays in the compute
    # dtype and is quantized at the chunk-end write.
    engine_kv_quantize: Optional[str] = None
    seed: int = 0                           # param init seed when no checkpoint

    @field_validator("quantize")
    @classmethod
    def _valid_quantize(cls, v: Optional[str]) -> Optional[str]:
        if v not in (None, "none", "int8", "int4"):
            raise ValueError(f"unknown quantize mode {v!r}; supported: 'none', 'int8', 'int4'")
        return v

    @field_validator("engine_quant")
    @classmethod
    def _valid_engine_quant(cls, v: Optional[str]) -> Optional[str]:
        if v not in (None, "none", "int8", "int4"):
            raise ValueError("engine_quant must be 'none', 'int8' or 'int4'")
        return v

    @field_validator("engine_kv_quantize")
    @classmethod
    def _valid_kv_quantize(cls, v: Optional[str]) -> Optional[str]:
        if v not in (None, "int8"):
            raise ValueError(f"unknown engine_kv_quantize mode {v!r}; supported: 'int8'")
        return v

    @model_validator(mode="before")
    @classmethod
    def _refuse_later_knobs(cls, data: Any) -> Any:
        if not isinstance(data, dict):
            return data
        data = dict(data)
        strip = data.pop("engine_page_strip", None)
        if strip is not None:
            raise NotInSlice(
                f"engine_page_strip={strip!r} sets the TPU paged kernel's pages per grid "
                "cell; results are identical across strips and the port's CUDA kernel K3 "
                "has no such grid, so only None is accepted"
            )
        for knob, (ok, item) in _LATER.items():
            if knob in data:
                value = data.pop(knob)
                if value not in ok:
                    raise refuse_later(knob, value, item)
        if data.get("provider") in ("tpu", "mock"):
            raise ValueError(
                f"provider {data['provider']!r} belongs to the JAX package; the port "
                "serves provider='cuda' (or 'cpu')"
            )
        return data
