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
  on the same mode vector: the two compute the same. Weight quantization
  adds no variant and no key field: a batcher's weights are quantized (or
  not) once, before its first capture, and every graph reads them as they
  are; an int8 KV cache neither (its scales are cache tensors like its
  panels, and its rings stay in the compute dtype).
* **Capture**: ahead of serving. ``warm(key)`` makes a variant while no
  slot is occupied: with every slot done a chunk changes nothing that is
  folded, and a capture executes nothing. The batcher's ``warmup`` calls
  it for every key its settings can form (``ContinuousBatcher.
  reachable_keys``) before ``start()`` returns. One eager chunk runs per
  ``(steps, fused, D, drafts)`` group, on the capturing stream: it builds
  the kernel libraries, sets the kernels' shared-memory attributes (once
  per instantiation, whatever the rung) and allocates K2's arrival
  counters (keyed on that stream); the group's other rungs are captured
  without one. Each graph is then replayed once, which uploads it to the
  device (its first launch would otherwise pay that). A dispatch of a key
  that was not warmed raises on CUDA, naming the key: nothing is captured
  while serving, so a batcher is swept before its first request.
* **Buffers**: the rings and the per-step outputs are allocated once per
  ``(steps, D, drafts)`` and shared by the variants of that shape
  (``decode.ChunkBuffers``, ``decode.SpecBuffers``): chunks run one after
  another on one stream, and each chunk's host copy is queued before the
  next chunk writes. The cache, the decode and sampling states and the
  block table are persistent tensors that admission and the runner update
  in place. Every graph's temporaries come from one shared memory pool;
  replays run one after another on one stream, so no two graphs'
  temporaries are live at once.
* **Randomness**: the slots' generators are registered with every graph
  that samples, so a ``manual_seed`` at admission reseeds the stream the
  next replay draws, and replays draw what eager steps would.
* **Launch counts**: the kernel wrappers count a launch when their Python
  runs, which for a graph is once, at capture. The capture's counts are
  taken back out, and each replay adds the launches the graph holds (K2,
  K3, the quantized product's fused and dequant launches and the integer
  arm's quantizer and product launches, in total and by shape).
* **No early exit**: every step of a replay runs, also after every slot
  is done (the JAX chunk's ``lax.while_loop`` stops there). The exit
  needs a CUDA-graph conditional node, which torch 2.13 exposes as
  ``CUDAGraph.begin_capture_to_if_node`` and torch 2.11 lacks
  (``chip_smoke.py`` phase 1 prints which the card's torch has).

On CUDA a capture or a replay that fails raises; nothing falls back to
the eager chunk. On the CPU, which the caller asks for explicitly, the
same chunk function runs eagerly with the same buffers, made at a key's
first dispatch where no sweep made them.
"""

from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Set, Tuple, Union

import numpy as np
import torch

from pilottai_tpu_torch.engine.decode import (
    ChunkBuffers,
    DecodeState,
    SpecBuffers,
    decode_chunk,
    decode_chunk_spec,
    ring_dtype,
)
from pilottai_tpu_torch.engine.sampling import SamplingState
from pilottai_tpu_torch.models.common import ModelConfig
from pilottai_tpu_torch.ops.kernels import decode_attention as _k2
from pilottai_tpu_torch.ops.kernels import int8_matmul as _i8
from pilottai_tpu_torch.ops.kernels import paged_attention as _k3
from pilottai_tpu_torch.ops.kernels import qmatmul as _qm
from pilottai_tpu_torch.ops.paged import PagedKVCache

#: The launch counters a decode chunk moves, as (kernel module, counter):
#: an int, or a dict of ints by key; a replay adds what its graph holds.
COUNTED = ((_k2, "launches"), (_k3, "launches"), (_qm, "launches"),
           (_qm, "launches_dequant"), (_qm, "launches_by_shape"), (_i8, "launches"),
           (_i8, "launches_quant"), (_i8, "launches_by_shape"))


def _read(mod, name):
    value = getattr(mod, name)
    return dict(value) if isinstance(value, dict) else value


def _take_back(mod, name, before):
    """What the counter moved since it read ``before``; puts it back."""
    value = getattr(mod, name)
    if not isinstance(value, dict):
        setattr(mod, name, before)
        return value - before
    moved = {k: n - before.get(k, 0) for k, n in value.items() if n != before.get(k, 0)}
    value.clear()
    value.update(before)
    return moved


def _add(mod, name, moved) -> None:
    value = getattr(mod, name)
    if not isinstance(value, dict):
        setattr(mod, name, value + moved)
        return
    for k, n in moved.items():
        value[k] = value.get(k, 0) + n

#: ``(steps, fused epilogue, pages K3 visits, D, dense prefix bound, model
#: drafts on)``.
VariantKey = Tuple[int, bool, Optional[int], int, Optional[int], bool]


@dataclass
class _Variant:
    bufs: Union[ChunkBuffers, SpecBuffers]
    graph: Optional[Any]              # torch.cuda.CUDAGraph; None on the CPU
    launches: Dict[Any, Any]          # (module, counter) -> launches one replay holds


@contextlib.contextmanager
def _no_gc():
    """Python's cyclic collector off: a collection during a capture would
    destroy unreachable graphs on the capturing thread, which the capture
    does not permit."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _nbytes(bufs: Union[ChunkBuffers, SpecBuffers]) -> int:
    tensors = [bufs.tokens, bufs.valid]
    for pairs in (bufs.rings, getattr(bufs, "drafts", [])):
        tensors += [t for pair in pairs for t in pair]
    return sum(t.numel() * t.element_size() for t in tensors)


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
        self._bufs: Dict[Tuple[int, int, bool], Union[ChunkBuffers, SpecBuffers]] = {}
        # (steps, fused, D, drafts) groups whose eager chunk has run.
        self._eager_groups: Set[Tuple[int, bool, int, bool]] = set()
        #: Graphs captured and the seconds their captures took
        #: (instantiation included), and the seconds of the eager chunks
        #: ``warm`` ran (synchronized), since the batcher last read them
        #: (its sweep takes them).
        self.graphs_captured = 0
        self.capture_seconds = 0.0
        self.eager_seconds = 0.0
        #: Replays of model-draft variants' graphs.
        self.draft_replays = 0

    @property
    def keys(self) -> Set[VariantKey]:
        """The variants made so far."""
        return set(self._variants)

    def key(self, n_steps: int, fused: bool, n_blocks: Optional[int] = None,
            prefix_bound: Optional[int] = None, drafts: bool = False) -> VariantKey:
        """The variant a dispatch with these arguments runs."""
        bound = None
        if self.speculate and self.table is None:
            bound = self.cache.max_len if prefix_bound is None else int(prefix_bound)
        return (int(n_steps), bool(fused), n_blocks if self.table is not None else None,
                self.speculate, bound, bool(drafts))

    def run(self, n_steps: int, fused: bool, n_blocks: Optional[int] = None,
            table: Optional[np.ndarray] = None, prefix_bound: Optional[int] = None,
            draft_mode: Optional[np.ndarray] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dispatch one chunk of ``n_steps`` (verify blocks under
        speculation) and return its ``(tokens, valid)`` buffers, which the
        next run of a variant of the same shape overwrites (copy them
        first; a copy queued on the stream before that run reads them in
        time). ``table`` is the paged cache's host block table, copied under
        the allocator's lock; ``prefix_bound`` the keys a dense speculative
        chunk's prefix read covers; ``draft_mode`` the slots that draft
        through the model (the model-draft variant runs when any does)."""
        if self.table is not None:
            if table is None or n_blocks is None:
                raise ValueError("a paged chunk needs the block table and its page count")
            self._upload(self.table, np.ascontiguousarray(table, dtype=np.int32))
        drafts = bool(self.draft_layers and draft_mode is not None and np.any(draft_mode))
        if drafts:
            self._upload(self.draft_mode, np.ascontiguousarray(draft_mode, dtype=np.bool_))
        key = self.key(n_steps, fused, n_blocks, prefix_bound, drafts)
        variant = self._variants.get(key)
        if variant is None:
            if self.cuda:
                raise RuntimeError(f"chunk graph {key} was not captured: ContinuousBatcher."
                                   "warmup captures every reachable key before serving")
            variant = self._make(key)
        if variant.graph is None:
            self._chunk(key, variant.bufs)
        else:
            variant.graph.replay()
            self.draft_replays += int(drafts)
            for (mod, name), n in variant.launches.items():
                _add(mod, name, n)
        return variant.bufs.tokens, variant.bufs.valid

    def warm(self, key: VariantKey) -> None:
        """Make the variant ``key`` ahead of its first dispatch; call it
        while no slot is occupied. On CUDA: the group's eager chunk if it
        has not run (synchronized, so ``eager_seconds`` holds its device
        time), then the capture and one replay. On the CPU, where nothing
        is captured, only the buffers and the key."""
        if key in self._variants:
            return
        n_steps, fused, _, D, _, drafts = key
        group = (n_steps, fused, D, drafts)
        if self.cuda and group not in self._eager_groups:
            if drafts:
                self.draft_mode.fill_(True)      # the model drafts run for every slot
            t0 = time.perf_counter()
            self._chunk(key, self._buffers(key))
            torch.cuda.current_stream(self.device).synchronize()
            self.eager_seconds += time.perf_counter() - t0
            self._eager_groups.add(group)
        variant = self._make(key)
        if variant.graph is not None:
            # A graph's first launch uploads it to the device (tens of ms
            # at llama3-8b, which the first request to use it would wait
            # for); with every slot done a replay changes nothing folded.
            variant.graph.replay()

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

    def _buffers(self, key: VariantKey) -> Union[ChunkBuffers, SpecBuffers]:
        """The buffers of ``key``'s shape, shared by every variant of it."""
        n_steps, _, _, D, _, drafts = key
        shape = (n_steps, D, drafts)
        bufs = self._bufs.get(shape)
        if bufs is None:
            B = self.dstate.tokens.shape[0]
            dtype = ring_dtype(self.cfg, self.cache)
            if D:
                bufs = SpecBuffers.create(self.cfg, B, n_steps, D,
                                          self.draft_layers if drafts else 0, dtype, self.device)
            else:
                bufs = ChunkBuffers.create(self.cfg, B, n_steps, dtype, self.device)
            self._bufs[shape] = bufs
        return bufs

    def _make(self, key: VariantKey) -> _Variant:
        """A new variant: its buffers and, on CUDA, the capture."""
        bufs = self._buffers(key)
        variant = _Variant(bufs=bufs, graph=None, launches={})
        if self.cuda:
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            if not key[1]:
                for gen in self.sampling.generators:
                    graph.register_generator_state(gen)
            before = {c: _read(*c) for c in COUNTED}
            with _no_gc(), torch.cuda.graph(graph, pool=self.pool,
                                            stream=torch.cuda.current_stream(self.device),
                                            capture_error_mode="thread_local"):
                self._chunk(key, bufs)
            for mod, name in COUNTED:
                variant.launches[mod, name] = _take_back(mod, name, before[mod, name])
            variant.graph = graph
            self.graphs_captured += 1
            self.capture_seconds += time.perf_counter() - t0
        self._variants[key] = variant
        return variant

    def drop_graphs(self) -> None:
        """Destroy the captured graphs now (the stopped engine's device
        work has finished), not whenever the collector finds them: a
        destruction on a thread that is capturing fails that capture."""
        for variant in self._variants.values():
            if variant.graph is not None:
                variant.graph.reset()
                variant.graph = None

    def buffer_bytes(self) -> Tuple[int, int]:
        """Device bytes of the variants' buffers: as allocated (shared by
        shape), and as one set per variant would take."""
        shared = sum(_nbytes(b) for b in self._bufs.values())
        return shared, sum(_nbytes(v.bufs) for v in self._variants.values())

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
