"""Decode chunks as CUDA graphs: capture, key, replay.

The JAX engine compiles its decode chunk (``engine/decode.py:decode_chunk``
under ``jit``, one executable per static variant) and dispatches it as
one program. The port's counterpart is a CUDA graph of the same chunk:
``decode.decode_chunk`` does no host work once it starts, so each variant
is captured once and replayed with one host call per chunk, where the
eager chunk issues thousands of launches (K2 or K3 and the plain tensor
ops around them, every layer of every step).

* **Variant key**: ``(steps, fused epilogue, pages K3 visits, D, dense
  prefix bound, model drafts on)``; dense chunks have no page count, plain
  chunks no D (0) and no bound. With speculation (``speculate`` D >= 2) a
  chunk is ``decode.decode_chunk_spec``: ``steps`` verify blocks of D
  rows, its dense prefix read through a panel of ``prefix bound`` keys.
  The batcher quantises the steps to its chunk buckets and the pages and
  the bound to a power-of-two rung of the longest prefix, so the graphs
  stay few. The model-draft variant runs only while some slot drafts
  through the model (host state), where JAX's chunk takes a ``lax.cond``
  on the same mode vector: the two compute the same.
* **Capture**: lazily, at a variant's first use. That dispatch runs the
  chunk eagerly on the capturing stream (it builds the kernel libraries,
  sets the kernels' shared-memory attributes and allocates K2's arrival
  counters, which are keyed on that stream) and is the chunk's real run;
  the capture that follows records the same function into the same
  buffers and executes nothing. Later dispatches replay.
* **Buffers**: the rings and the per-step outputs of each variant are
  allocated once (``decode.ChunkBuffers``); the cache, the decode and
  sampling states and the block table are persistent tensors that
  admission and the runner update in place. Every graph's temporaries
  come from one shared memory pool; replays run one after another on one
  stream, so no two graphs' temporaries are live at once.
* **Randomness**: the slots' generators are registered with every graph
  that samples, so a ``manual_seed`` at admission reseeds the stream the
  next replay draws, and replays draw what eager steps would.
* **Launch counts**: the kernel wrappers count a launch when their Python
  runs, which for a graph is once, at capture. The capture's counts are
  taken back out, and each replay adds the launches the graph holds.

On CUDA a capture or a replay that fails raises; nothing falls back to
the eager chunk. On the CPU, which the caller asks for explicitly, the
same chunk function runs eagerly with the same buffers.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from pilottai_tpu_torch.engine.decode import (
    ChunkBuffers,
    DecodeState,
    SpecBuffers,
    decode_chunk,
    decode_chunk_spec,
)
from pilottai_tpu_torch.engine.sampling import SamplingState
from pilottai_tpu_torch.models.common import ModelConfig
from pilottai_tpu_torch.ops.kernels import decode_attention as _k2
from pilottai_tpu_torch.ops.kernels import paged_attention as _k3
from pilottai_tpu_torch.ops.paged import PagedKVCache

#: The kernel modules a decode chunk launches; a replay adds their counts.
COUNTED = (_k2, _k3)

VariantKey = Tuple[int, bool, Optional[int], int, Optional[int], bool]


@dataclass
class _Variant:
    bufs: Union[ChunkBuffers, SpecBuffers]
    graph: Optional[Any]              # torch.cuda.CUDAGraph; None on the CPU
    launches: Dict[Any, int]          # kernel module -> launches one replay holds


class ChunkRunner:
    """Runs the decode chunks of one batcher's state: captured graphs on
    CUDA, the eager chunk on the CPU. Called from one thread (the
    batcher's device thread) and on that thread's current stream."""

    def __init__(self, params: Dict[str, Any], cfg: ModelConfig, cache, dstate: DecodeState,
                 sampling: SamplingState, device: torch.device,
                 max_pages: Optional[int] = None, history: Optional[torch.Tensor] = None,
                 speculate: int = 0, draft_layers: int = 0) -> None:
        self.params, self.cfg = params, cfg
        self.cache, self.dstate, self.sampling = cache, dstate, sampling
        self.device = device
        self.cuda = device.type == "cuda"
        B = dstate.tokens.shape[0]
        #: The block table every paged graph reads: a dispatch uploads the
        #: host table into it, behind the chunks in flight on the stream.
        self.table: Optional[torch.Tensor] = None
        if isinstance(cache, PagedKVCache):
            if max_pages is None:
                raise ValueError("a paged cache's runner needs the block table's width")
            self.table = torch.full((B, max_pages), cache.num_pages - 1, dtype=torch.int32,
                                    device=device)
        #: Speculation: the verify block's rows (0: off), the slots' token
        #: history the drafts read, and the draft-mode vector the
        #: model-draft graphs read (uploaded as the table is).
        self.speculate = int(speculate)
        self.history = history
        if self.speculate and history is None:
            raise ValueError("a speculative runner needs the slots' history")
        self.draft_layers = int(draft_layers)
        self.draft_mode = (torch.zeros((B,), dtype=torch.bool, device=device)
                           if self.draft_layers else None)
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self._variants: Dict[VariantKey, _Variant] = {}
        #: Graphs captured and the seconds their captures took (the eager
        #: first runs not included).
        self.graphs_captured = 0
        self.capture_seconds = 0.0
        #: Replays of model-draft variants' graphs.
        self.draft_replays = 0

    def run(self, n_steps: int, fused: bool, n_blocks: Optional[int] = None,
            table: Optional[np.ndarray] = None, prefix_bound: Optional[int] = None,
            draft_mode: Optional[np.ndarray] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dispatch one chunk of ``n_steps`` (verify blocks under
        speculation) and return its ``(tokens, valid)`` buffers, which the
        next run of the same variant overwrites (copy them first; a copy
        queued on the stream before that run reads them in time). ``table``
        is the paged cache's host block table, copied under the allocator's
        lock; ``prefix_bound`` the keys a dense speculative chunk's prefix
        read covers; ``draft_mode`` the slots that draft through the model
        (the model-draft variant runs when any does)."""
        if self.table is not None:
            if table is None or n_blocks is None:
                raise ValueError("a paged chunk needs the block table and its page count")
            self._upload(self.table, np.ascontiguousarray(table, dtype=np.int32))
        drafts = bool(self.draft_layers and draft_mode is not None and np.any(draft_mode))
        if drafts:
            self._upload(self.draft_mode, np.ascontiguousarray(draft_mode, dtype=np.bool_))
        bound = None
        if self.speculate and self.table is None:
            bound = self.cache.max_len if prefix_bound is None else int(prefix_bound)
        key = (int(n_steps), bool(fused), n_blocks if self.table is not None else None,
               self.speculate, bound, drafts)
        variant = self._variants.get(key)
        if variant is None:
            variant = self._first_run(key)
        elif variant.graph is None:
            self._chunk(key, variant.bufs)
        else:
            variant.graph.replay()
            self.draft_replays += int(drafts)
            for mod, n in variant.launches.items():
                mod.launches += n
        return variant.bufs.tokens, variant.bufs.valid

    def _upload(self, dst: torch.Tensor, host: np.ndarray) -> None:
        src = torch.from_numpy(host)
        if src.shape != dst.shape:
            raise ValueError(f"host buffer {tuple(src.shape)} for {tuple(dst.shape)}")
        if self.cuda:
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    def _chunk(self, key: VariantKey, bufs) -> None:
        n_steps, fused, n_blocks, D, bound, drafts = key
        if not D:
            decode_chunk(self.params, self.cfg, self.cache, self.dstate, self.sampling, n_steps,
                         table=self.table, n_blocks=n_blocks, fused_epilogue=fused, bufs=bufs)
            return
        if self.table is not None:
            bound = n_blocks * self.cache.page_size
        decode_chunk_spec(
            self.params, self.cfg, self.cache, self.dstate, self.sampling, self.history,
            n_steps, D, prefix_bound=bound, table=self.table,
            draft_layers=self.draft_layers if drafts else 0,
            draft_mode=self.draft_mode if drafts else None, fused_epilogue=fused, bufs=bufs,
        )

    def _first_run(self, key: VariantKey) -> _Variant:
        """The variant's first dispatch: its buffers, the eager chunk (the
        dispatch's real run) and, on CUDA, the capture."""
        B = self.dstate.tokens.shape[0]
        dtype = self.cache.layers[0][0].dtype
        if key[3]:
            bufs = SpecBuffers.create(self.cfg, B, key[0], key[3],
                                      self.draft_layers if key[5] else 0, dtype, self.device)
        else:
            bufs = ChunkBuffers.create(self.cfg, B, key[0], dtype, self.device)
        self._chunk(key, bufs)
        variant = _Variant(bufs=bufs, graph=None, launches={})
        if self.cuda:
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            if not key[1]:
                for gen in self.sampling.generators:
                    graph.register_generator_state(gen)
            before = {mod: mod.launches for mod in COUNTED}
            with torch.cuda.graph(graph, pool=self.pool,
                                  stream=torch.cuda.current_stream(self.device),
                                  capture_error_mode="thread_local"):
                self._chunk(key, bufs)
            for mod in COUNTED:
                variant.launches[mod] = mod.launches - before[mod]
                mod.launches = before[mod]
            variant.graph = graph
            self.graphs_captured += 1
            self.capture_seconds += time.perf_counter() - t0
        self._variants[key] = variant
        return variant

    def pool_bytes(self) -> Optional[int]:
        """Device memory the graphs' shared pool holds (its segments in the
        caching allocator's snapshot); None on the CPU or where the
        snapshot does not name pools."""
        if not self.cuda:
            return None
        segments = torch.cuda.memory_snapshot()
        if segments and "segment_pool_id" not in segments[0]:
            return None
        return sum(s["total_size"] for s in segments
                   if tuple(s["segment_pool_id"]) == tuple(self.pool))
