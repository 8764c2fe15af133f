"""Decode chunks as CUDA graphs: capture, key, replay.

The JAX engine compiles its decode chunk (``engine/decode.py:decode_chunk``
under ``jit``, one executable per static variant) and dispatches it as
one program. The port's counterpart is a CUDA graph of the same chunk:
``decode.decode_chunk`` does no host work once it starts, so each variant
is captured once and replayed with one host call per chunk, where the
eager chunk issues thousands of launches (K2 or K3 and the plain tensor
ops around them, every layer of every step).

* **Variant key**: ``(steps, fused epilogue, pages K3 visits)``; dense
  chunks have no page count. The batcher quantises the steps to its chunk
  buckets and the pages to a power-of-two rung of the longest prefix, so
  the graphs stay few.
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
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pilottai_tpu_torch.engine.decode import ChunkBuffers, DecodeState, decode_chunk
from pilottai_tpu_torch.engine.sampling import SamplingState
from pilottai_tpu_torch.models.common import ModelConfig
from pilottai_tpu_torch.ops.kernels import decode_attention as _k2
from pilottai_tpu_torch.ops.kernels import paged_attention as _k3
from pilottai_tpu_torch.ops.paged import PagedKVCache

#: The kernel modules a decode chunk launches; a replay adds their counts.
COUNTED = (_k2, _k3)

VariantKey = Tuple[int, bool, Optional[int]]


@dataclass
class _Variant:
    bufs: ChunkBuffers
    graph: Optional[Any]              # torch.cuda.CUDAGraph; None on the CPU
    launches: Dict[Any, int]          # kernel module -> launches one replay holds


class ChunkRunner:
    """Runs the decode chunks of one batcher's state: captured graphs on
    CUDA, the eager chunk on the CPU. Called from one thread (the
    batcher's device thread) and on that thread's current stream."""

    def __init__(self, params: Dict[str, Any], cfg: ModelConfig, cache, dstate: DecodeState,
                 sampling: SamplingState, device: torch.device,
                 max_pages: Optional[int] = None) -> None:
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
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self._variants: Dict[VariantKey, _Variant] = {}
        #: Graphs captured and the seconds their captures took (the eager
        #: first runs not included).
        self.graphs_captured = 0
        self.capture_seconds = 0.0

    def run(self, n_steps: int, fused: bool, n_blocks: Optional[int] = None,
            table: Optional[np.ndarray] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dispatch one chunk of ``n_steps`` and return its ``(tokens,
        valid)`` buffers, which the next run of the same variant
        overwrites (copy them first; a copy queued on the stream before
        that run reads them in time). ``table`` is the paged cache's host
        block table, copied under the allocator's lock."""
        if self.table is not None:
            if table is None or n_blocks is None:
                raise ValueError("a paged chunk needs the block table and its page count")
            self._upload_table(table)
        key = (int(n_steps), bool(fused), n_blocks if self.table is not None else None)
        variant = self._variants.get(key)
        if variant is None:
            variant = self._first_run(key)
        elif variant.graph is None:
            self._chunk(key, variant.bufs)
        else:
            variant.graph.replay()
            for mod, n in variant.launches.items():
                mod.launches += n
        return variant.bufs.tokens, variant.bufs.valid

    def _upload_table(self, table: np.ndarray) -> None:
        host = torch.from_numpy(np.ascontiguousarray(table, dtype=np.int32))
        if host.shape != self.table.shape:
            raise ValueError(f"block table {tuple(host.shape)} for {tuple(self.table.shape)}")
        if self.cuda:
            self.table.copy_(host.pin_memory(), non_blocking=True)
        else:
            self.table.copy_(host)

    def _chunk(self, key: VariantKey, bufs: ChunkBuffers) -> None:
        n_steps, fused, n_blocks = key
        decode_chunk(self.params, self.cfg, self.cache, self.dstate, self.sampling, n_steps,
                     table=self.table, n_blocks=n_blocks, fused_epilogue=fused, bufs=bufs)

    def _first_run(self, key: VariantKey) -> _Variant:
        """The variant's first dispatch: its buffers, the eager chunk (the
        dispatch's real run) and, on CUDA, the capture."""
        B = self.dstate.tokens.shape[0]
        bufs = ChunkBuffers.create(self.cfg, B, key[0], self.cache.layers[0][0].dtype,
                                   self.device)
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
