"""The continuous batcher (the port's counterpart of the core of
``pilottai_tpu/engine/batcher.py``): fixed slots, a FIFO backlog, and
three threads that keep the card fed during decode.

* **The device thread** issues every device op, on its own stream, in
  program order: the device side of slot releases, admission prefills
  (``decode.admit_group``), chunked-prefill segments, and decode chunks,
  which ``engine/graphs.py`` replays as captured CUDA graphs. It
  dispatches up to ``pipeline_depth`` chunks ahead of the host: each
  chunk's ``(tokens, valid)`` go to pinned host buffers with a
  non-blocking copy behind an event, and it never waits for the device.
* **The reader thread** folds each chunk once its event has completed:
  the tokens go into their slots, a request's future resolves at EOS,
  budget or a full context, and its slot and pages are released. Each
  chunk carries the slots' generations at dispatch, so a chunk that was
  in flight when a slot changed hands never folds into the new occupant.
  The first token of an admission is copied the same way from its
  dispatch and folded by the reader before any later chunk's tokens.
* **The prep thread** (``overlap_admission``) drains the backlog,
  selects a group, allocates its pages under the lock and packs its numpy
  staging, so the device thread only enqueues the prefill behind the
  chunks in flight. Without it the device thread does the same inline.

Chunk sizes follow ``chunk_policy``: "fixed" dispatches ``chunk_size``
steps; "adaptive" sizes each dispatch from the live slots' remaining
budgets (less what the chunks in flight will add) and quantises it up to
``chunk_buckets``. With ``fused_epilogue`` a dispatch whose occupied
slots are all greedy and unconstrained runs the vocab-tiled greedy
epilogue instead of the sampler.

With ``paged=True`` the KV cache is a shared page pool
(``ops/paged.py``): a request reserves the pages of ``min(prompt +
max_new_tokens, max_seq)`` tokens when it is selected, the FIFO head
waits while the pool is short, and its pages return at fold time. A
prompt whose length passes ``2 x prefill_chunk`` admits in segments: one
``extend_prompt_paged`` segment per device-loop cycle while the live
slots keep decoding between them, then the final segment through
``admit_group_prefix_paged``. Selection waits while a segmentation
runs, so admission order holds.

With ``prefix_cache > 0`` (the default, 4, as in the JAX engine) a
prompt whose head is cached admits through a tail prefill. On the dense
cache a ``PrefixStore`` (``engine/prefix_cache.py``) holds up to
``prefix_cache`` entries of copied panels, each cold admission exporting
its prompt (less the last token) and the longest common prefixes it
shares with stored entries; a hit copies the entry into the slots. On the
paged cache a ``PagePrefixIndex`` (``engine/page_prefix.py``) pins the
pages every admission fully covers, up to a quarter of the pool, and a
hit maps the chain into the slots' block tables; admission pressure
unpins cached pages before the head waits, and a long prompt segments
only what lies past its chain. Selection keys a group by its hit: one
cached prefix per admission dispatch. Exports are best-effort, counted
in ``prefix_export_failures``; ``prefix_report()`` reads the counters.

With ``kvcache_host_mb > 0`` (``engine_kvcache_host_mb``) the prefix
cache has a host-RAM tier behind it (``engine/kvcache/``): an entry the
dense store or the page index evicts is copied to pinned host memory
instead of dropped, and a later lookup that the device tier misses
restores it from there. A dense restore uploads the panels on the prep
thread, on a copy stream, and the admission waits on the upload's event; a
paged restore takes fresh pages, registers the chain and queues a
``PendingRestore``, which the device thread writes into the pool in place
(``_apply_restores``) before any admission, segment or chunk can read
those pages. A request's ``session_id`` pins its lineage in the host tier;
``export_session_kv``, ``export_request_kv`` and their imports move a
session's or a request's K/V in the JAX package's sealed transfer format.
Restores staged before a rebuild carry the allocator's epoch
(``_alloc_epoch``) and are unwound, their host entries handed back. Every
admission adds its prefilled tokens to ``engine.prefill_tokens``.

With ``speculate`` D >= 2 each dispatch is a speculative chunk
(``decode.decode_chunk_spec``): verify blocks of D rows a slot, drafts
from the slot's token history (``history``, installed at every admission
kind) and, with ``draft_layers``, from the model's first layers for the
slots whose own acceptance has collapsed (``_slot_rate`` and
``_draft_on``, a per-slot EMA with hysteresis, updated at fold behind the
generation stamp). The tokens-per-block EMA ``_spec_rate`` sizes the
chunks and the in-flight estimates.

``warmup`` (which ``TorchEngine`` runs at every start, as the JAX engine
does) makes serving pay no first-use cost: it captures every chunk graph
the settings can reach (``reachable_keys``) on the device thread while no
slot is occupied, then sends one two-token request per prompt bucket per
chunk bucket, the chunk pinned through ``_force_chunk``, which runs every
prefill bucket and, with chunked prefill, the segment ladder. While it
runs (``_warming``) the prefix cache is neither looked up nor filled; when
it ends every counter serving reads is reset, and ``graph_report()``
counts the captures serving makes apart from the sweep's (none, at the
settings the sweep saw).

With ``kv_quantize`` the cache's panels or pools are int8 with a scale per
token and kv head (``engine_kv_quantize="int8"``): every write quantizes,
every read applies the scales (``engine/decode.py``), the rings stay in
the compute dtype, and a dense prefix-store entry is exported in fp32.
It adds no chunk-graph variant: the graphs read the scales as the cache's
other tensors.

``weight_quant`` and ``quant_group`` say how the weights are quantized,
read from the weights themselves (``models/quant.py:quant_mode``; the
engine quantizes before it builds the batcher), and ``weight_bytes`` and
``weight_bytes_per_token`` their bytes
(``weight_stream_bytes``): plain attributes, as the metrics gauges come
with ROADMAP P6b. Quantization adds no chunk-graph variant.
``qmatmul_arm`` is the quantized product's arm, read from
``PILOTTAI_QMATMUL`` once when the batcher is built and stamped on the
weights of its own copy of the parameter tree
(``models/qmatmul.py:hold_arm``): the warm-up sweep captures
every graph under it and ``graph_report()`` records it.

The fault domain (the JAX batcher's, ``reliability/``): a request may
carry a ``deadline``, checked at submit, at selection and at dispatch, and
swept every device-loop cycle (``_expire_deadlines``: an expired slot is
released and fails with ``DeadlineExceeded``); ``max_queue_depth`` sheds
submits (``EngineOverloaded``), batch-class ones at ``batch_shed_frac`` of
it. A fold whose tokens fall outside the vocab fails only its slot
(``PoisonedOutput``). A failed dispatch or fold goes through one recovery
decision (``_fail_occupied_slots``): each occupant re-admits at the
backlog head with its prompt plus the tokens it had (a JSON request
restarts from its prompt, or fails if it streamed), up to
``recovery_max_attempts`` times, and the device state is rebuilt in place
first (``_rebuild_device_state``): the captured chunk graphs read the
cache, the decode and sampling states, the block table and the history by
address, so those are reset with fills, never reallocated, and no graph is
captured again. Chunks already in flight fold behind their generation
stamps, which the rebuild bumps. A sticky CUDA error
(``sticky_device_error``) leaves nothing to recover in the process: the
occupants fail and the engine is marked stalled. Repeated faults step the
``DegradeLadder`` down (model drafts off, the smallest chunk bucket, half
the slots, batch-class shedding; each a graph the sweep captured), and a
``Watchdog`` (``watchdog_stall_s``) turns a hung dispatch into a stall on
``global_engine_health``. The scheduling policies (ROADMAP P6c) are not
here.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import math
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pilottai_tpu_torch.engine.decode import (
    AF_TEMP,
    AF_TOPP,
    AI_BUDGET,
    AI_EOS,
    AI_JSON,
    AI_LEN,
    AI_PLEN,
    AI_SEED,
    AI_SLOT,
    AI_TOPK,
    DecodeState,
    admit_group,
    admit_group_prefix,
    admit_group_prefix_paged,
    export_prefix,
    extend_prompt_paged,
    pack_admit_meta,
    release_decode,
    reset_decode,
)
from pilottai_tpu_torch.engine.graphs import ChunkRunner, VariantKey
from pilottai_tpu_torch.engine.kvcache.index import KVCacheIndex
from pilottai_tpu_torch.engine.page_prefix import PagePrefixIndex, device_fault
from pilottai_tpu_torch.engine.prefix_cache import PrefixStore
from pilottai_tpu_torch.engine.sampling import SamplingState, reset_sampling
from pilottai_tpu_torch.models.common import ModelConfig
from pilottai_tpu_torch.models.qmatmul import hold_arm
from pilottai_tpu_torch.models.quant import quant_mode, weight_stream_bytes
from pilottai_tpu_torch.ops.kernels.paged_attention import check_kernel_shapes
from pilottai_tpu_torch.ops.kvcache import KVCache, free_slots, reset_cache
from pilottai_tpu_torch.ops.paged import PageAllocator, PagedKVCache
from pilottai_tpu_torch.reliability import degrade as degrade_levels
from pilottai_tpu_torch.reliability.deadline import (
    DeadlineExceeded,
    EngineOverloaded,
    PoisonedOutput,
)
from pilottai_tpu_torch.reliability.degrade import DegradeLadder
from pilottai_tpu_torch.reliability.inject import global_injector
from pilottai_tpu_torch.reliability.watchdog import Watchdog, global_engine_health
from pilottai_tpu_torch.utils.logging import get_logger, setup_logging
from pilottai_tpu_torch.utils.metrics import global_metrics
from pilottai_tpu_torch.utils.tracing import global_tracer

#: Smallest prompt bucket of an admission group (prompts pad up to a power
#: of two at least this long).
MIN_BUCKET = 64
#: Smallest tail bucket of a prefix admission (a prefix hit, or the final
#: segment of a chunked prefill), so a short tail is not padded to a whole
#: prompt bucket.
MIN_TAIL_BUCKET = 8
#: Row cap of a dense prefix-store entry: ``min(max_seq, 1024)`` rows.
PREFIX_MAX_LEN = 1024
#: Smallest rung of the prefix bound that keys the paged chunk graphs.
MIN_DECODE_BUCKET = 128
#: Admission groups the prep thread may stage ahead of the device thread.
PREP_DEPTH = 2

_log = get_logger("engine.batcher")

#: CUDA errors after which the context is unusable, so nothing in the
#: process can be recovered (the messages ``cudaGetErrorString`` gives).
STICKY_CUDA_ERRORS = ("illegal memory access", "unspecified launch failure",
                      "device-side assert", "misaligned address", "illegal instruction",
                      "the launch timed out and was terminated",
                      "uncorrectable ecc error encountered", "hardware stack error",
                      "invalid program counter",
                      "operation not supported on global/shared address space",
                      "uncorrectable nvlink error")


@dataclass
class GenRequest:
    prompt_ids: List[int]
    max_new_tokens: int = 256
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    eos_id: int = -1
    json_mode: bool = False
    future: Future = field(default_factory=Future)
    submitted_at: float = field(default_factory=time.perf_counter)
    first_token_at: Optional[float] = None
    # Set by the caller (any thread) to abandon the request; the reader
    # frees its slot at the next fold.
    cancelled: bool = False
    # End-to-end deadline: absolute ``time.monotonic()`` time, checked at
    # submit, at selection and dispatch, and swept every device-loop cycle
    # (an occupied slot past it is released; DeadlineExceeded). None = none.
    deadline: Optional[float] = None
    # Streaming: called from the reader thread with each batch of newly
    # folded tokens (EOS left out: exactly the ids the result will hold, in
    # order). Must be cheap and non-blocking; its exceptions are logged.
    on_tokens: Optional[Any] = None
    # Trace correlation: the request's engine span is emitted under
    # ``trace_id`` at its end. None = untracked.
    trace_id: Optional[str] = None
    # SLO class: "batch" sheds at batch_shed_frac of max_queue_depth and at
    # the degrade ladder's last rung; None or anything else is interactive.
    slo_class: Optional[str] = None
    # In-flight recovery: ``recovered_tokens`` are the tokens accepted
    # before a fault (prepended to the result, never streamed again),
    # ``recovery_attempts`` the strikes spent, and ``recovery_started_at``
    # the snapshot time the ``engine.recovery_ms`` histogram reads.
    recovery_attempts: int = 0
    recovered_tokens: List[int] = field(default_factory=list)
    recovery_started_at: Optional[float] = None
    # The prefix lookup counted this request (a head that waits for pages
    # is looked up again at every selection, and counted once).
    kv_counted: bool = False
    # KV-cache session handle: the turns of one conversation send the same
    # id, which pins their K/V lineage in the host tier across device-cache
    # evictions, so a resume restores instead of prefilling its history.
    # None: anonymous (cached, not pinned).
    session_id: Optional[str] = None


@dataclass
class _Slot:
    request: GenRequest
    prompt_len: int
    generated: List[int] = field(default_factory=list)
    first_pending: bool = True  # the prefill's token has not been folded yet
    est_pending: float = 0.0    # tokens the chunks in flight are expected to add
    hi_pending: int = 0         # the most tokens they can add


@dataclass
class _Prepared:
    """One admission group staged for the device thread: slots reserved,
    pages allocated, numpy staging packed. ``kind`` is "full" (a cold
    prefill of ``tokens``), "prefix" (the dense store's ``entry`` holds the
    first ``prefix_len`` tokens; ``tokens`` are the tails) or
    "prefix_paged" (the ``chain`` pages hold them: a cached chain, or with
    ``segmented`` the slot's own chain under the final segment of a
    chunked prefill)."""

    group: List[Tuple[int, GenRequest]]
    tokens: np.ndarray
    meta_i32: np.ndarray
    meta_f32: np.ndarray
    page_rows: Optional[np.ndarray] = None
    kind: str = "full"
    prefix_len: int = 0
    chain: Optional[np.ndarray] = None
    entry: Any = None
    segmented: bool = False
    full_tokens: Optional[np.ndarray] = None  # whole prompts of a prefix kind (the history)


@dataclass
class _SegmentStart:
    """A long prompt selected for chunked prefill: ``[slot, request,
    tokens written]``, its pages allocated."""

    seg: List[Any]


class _HostCopy:
    """Device tensors' copy to the host, started where it is made: on
    CUDA a non-blocking copy into pinned buffers behind an event, which
    ``wait`` synchronizes on; on the CPU a plain copy (the tensors are the
    chunk's reused buffers, so they are copied before the next chunk)."""

    def __init__(self, tensors: Sequence[torch.Tensor]) -> None:
        self.event = None
        if tensors[0].device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [t.clone() for t in tensors]

    def wait(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


def _pow2_at_least(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


class ContinuousBatcher:
    """Slots, backlog and the threads that serve them."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Dict[str, Any],
        device: torch.device,
        n_slots: int = 8,
        admit_batch: int = 8,
        max_seq_len: int = 2048,
        chunk_size: int = 16,
        paged: bool = False,
        page_size: int = 128,
        num_pages: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        pipeline_depth: int = 2,
        overlap_admission: bool = True,
        chunk_policy: str = "adaptive",
        chunk_buckets: Optional[Sequence[int]] = None,
        fused_epilogue: bool = True,
        prefix_cache: int = 4,
        prefix_min_len: Optional[int] = None,
        speculate: int = 0,
        draft_layers: int = 0,
        kv_quantize: bool = False,
        max_queue_depth: Optional[int] = None,
        batch_shed_frac: float = 0.5,
        recovery_max_attempts: int = 2,
        watchdog_stall_s: Optional[float] = None,
        degrade: Optional[DegradeLadder] = None,
        kvcache_host_mb: int = 0,
        kvcache_policy: str = "cost",
    ) -> None:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        setup_logging()
        self.cfg = cfg
        #: The quantized product's arm, held for the batcher's life on its
        #: own copy of the tree (the caller's weights are not stamped).
        params, self.qmatmul_arm = hold_arm(params)
        self.params = params
        self.device = device
        # The weights' quantization mode and int4 group width (None but
        # for int4), and the bytes they hold and one decode step reads.
        self.weight_quant, self.quant_group = quant_mode(params)
        wb = weight_stream_bytes(params)
        self.weight_bytes = wb["total"]
        self.weight_bytes_per_token = wb["per_token"]
        #: int8 KV panels or pools with per-token scales.
        self.kv_quantize = bool(kv_quantize)
        self.n_slots = n_slots
        self.admit_batch = admit_batch
        self.max_seq_len = max_seq_len
        self.chunk_size = chunk_size
        self.paged = paged
        self.page_size = page_size
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.overlap_admission = overlap_admission
        self.fused_epilogue = fused_epilogue
        if chunk_policy not in ("fixed", "adaptive"):
            raise ValueError(f"unknown chunk_policy {chunk_policy!r}; supported: 'fixed', "
                             "'adaptive'")
        self.chunk_policy = chunk_policy
        if chunk_policy == "adaptive":
            if chunk_buckets:
                buckets = {int(b) for b in chunk_buckets}
                bad = sorted(b for b in buckets if not 1 <= b <= chunk_size)
                if bad:
                    raise ValueError(f"chunk_buckets {bad} outside [1, chunk_size={chunk_size}]")
            else:
                # The quartile ladder: {4, 8, 12, 16} at the default chunk 16.
                buckets = {max(1, (chunk_size * q) // 4) for q in (1, 2, 3, 4)}
            # The largest bucket covers a full fixed chunk, or a saturated
            # wave would need several dispatches where one did.
            self.chunk_buckets = sorted(buckets | {chunk_size})
        else:
            self.chunk_buckets = [chunk_size]
        self.alloc: Optional[PageAllocator] = None
        # Guards the slots, their generations, the allocator's free list
        # and block table, the backlog and the release and first-read lists.
        self._lock = threading.Lock()
        if paged:
            # Default pool: what a dense cache would spend on
            # min(max_seq, 2048)-wide slots, plus the scratch page.
            self.num_pages = num_pages or n_slots * min(max_seq_len, 2048) // page_size + 1
            min_pages = -(-min(max_seq_len, 2 * page_size) // page_size)
            if self.num_pages - 1 < min_pages:
                raise ValueError(
                    f"paged KV pool of {self.num_pages} pages x {page_size} can't hold a "
                    "single request; raise engine_kv_pages or lower engine_page_size"
                )
            # No request may need more pages than the pool holds, or it
            # would block admission forever.
            self.max_seq_len = min(self.max_seq_len, (self.num_pages - 1) * page_size)
            if device.type == "cuda":
                check_kernel_shapes(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, page_size)
            max_pages = -(-self.max_seq_len // page_size)
            self.alloc = PageAllocator(self.num_pages, page_size, n_slots, max_pages)
            self.cache = PagedKVCache.create(
                cfg.n_layers, n_slots, self.num_pages, page_size, cfg.n_kv_heads,
                cfg.head_dim, dtype=cfg.dtype, device=device, quantized=self.kv_quantize,
            )
        else:
            self.cache = KVCache.create(
                cfg.n_layers, n_slots, max_seq_len, cfg.n_kv_heads, cfg.head_dim,
                dtype=cfg.dtype, device=device, quantized=self.kv_quantize,
            )
        # Chunked prefill: on by default for the paged pool, in whole pages.
        if prefill_chunk is None:
            prefill_chunk = 1024 if paged else 0
        self.prefill_chunk = (
            -(-prefill_chunk // page_size) * page_size if paged and prefill_chunk > 0 else 0
        )
        # In-flight segmented admission: [slot, request, tokens written].
        self._segmenting: Optional[List[Any]] = None
        self._seg_pending = False  # a _SegmentStart is staged, not yet taken
        #: Chunked-prefill segments run (``extend_prompt_paged`` calls).
        self.prefill_segments = 0
        # The device thread's stream: every device op of the engine runs on
        # it, a spill's page gather too (whichever thread evicts).
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        # Automatic prefix caching: a store of copied panels on the dense
        # cache, a radix of pinned, shared pages on the paged one.
        self.prefix_store: Optional[PrefixStore] = None
        self.page_index: Optional[PagePrefixIndex] = None
        self.kvcache: Optional[KVCacheIndex] = None
        if prefix_cache > 0:
            if paged:
                # At most a quarter of the allocatable pool stays pinned, so
                # caching never crowds out admissions' working set.
                self.page_index = PagePrefixIndex(
                    page_size, capacity_pages=max((self.num_pages - 1) // 4, 1))
            else:
                self.prefix_store = PrefixStore(
                    capacity=prefix_cache,
                    min_len=prefix_min_len if prefix_min_len is not None else MIN_BUCKET,
                    max_len=min(max_seq_len, PREFIX_MAX_LEN),
                    policy=kvcache_policy,
                )
            # One lookup over the device tier and, with kvcache_host_mb,
            # the host tier that evictions spill to.
            self.kvcache = KVCacheIndex(
                prefix_store=self.prefix_store, page_index=self.page_index,
                page_size=page_size, host_bytes=int(kvcache_host_mb) * 1024 * 1024,
                policy=kvcache_policy, get_cache=lambda: self.cache, min_len=prefix_min_len,
                device=device, stream=self.stream,
            )
        # Restored page chains awaiting their pool write (appended under the
        # lock at lookup, drained by ``_apply_restores`` on the device thread
        # before any dispatch can read the pages), and the allocator's
        # generation, bumped by every rebuild: a record of an older one is
        # unwound.
        self._pending_restores: List[Any] = []
        self._alloc_epoch = 0
        #: Requests admitted by a tail prefill against a cached prefix (a
        #: chunked prefill's final segment over its own chain is not one;
        #: nor is a hit whose rest was long enough to segment), the prompt
        #: tokens their prefixes saved, and dense exports that failed.
        self.prefix_admitted = 0
        self.prefix_tokens_saved = 0
        self.prefix_export_failures = 0
        self._warned_min_len = False
        #: Decode steps (verify blocks under speculation) dispatched, those
        #: in which some slot emitted (their ratio is the chunk utilization
        #: the adaptive policy raises), and those folded: a dispatch counts
        #: when it is planned, so folded == dispatched once no chunk is in
        #: flight or being dispatched.
        self.blocks_dispatched = 0
        self.blocks_useful = 0
        self.blocks_folded = 0
        # Speculative decoding: verify blocks of ``speculate`` rows (below 2
        # is off), drafts from each slot's history and, with draft_layers,
        # from the model's first layers for the slots whose n-gram
        # acceptance collapsed.
        self.speculate = speculate if speculate >= 2 else 0
        self.draft_layers = (min(draft_layers, cfg.n_layers - 1)
                             if draft_layers > 0 and self.speculate else 0)
        if self.speculate:
            R = self.chunk_size * self.speculate
            if not paged and R + 1 > self.max_seq_len:
                raise ValueError(f"a chunk of {self.chunk_size} blocks of {self.speculate} "
                                 f"needs a ring of {R + 1} rows, past max_seq {self.max_seq_len}")
            if paged and device.type == "cuda":
                check_kernel_shapes(cfg.n_kv_heads * self.speculate, cfg.n_kv_heads,
                                    cfg.head_dim, page_size, q_blocks=self.speculate)
        #: Tokens-per-block EMA (1: nothing accepted; up to D), which sizes
        #: the chunks and the in-flight estimates.
        self._spec_rate = 1.0
        #: Per-slot tokens-per-block EMA and the model-draft mode it drives.
        self._slot_rate = np.full((n_slots,), float(max(self.speculate, 1)), np.float32)
        self._draft_on = np.zeros((n_slots,), bool)
        #: Tokens folded from speculative chunks and the (block, slot) pairs
        #: that emitted them (their ratio: tokens per block), and the blocks
        #: dispatched in the model-draft variant.
        self.spec_tokens = 0
        self.spec_blocks = 0
        self.draft_blocks = 0
        # The slots' token ids by position, the drafts' source; the last
        # column is a sink for dropped writes.
        self.history = (torch.zeros((n_slots, self.max_seq_len + 1), dtype=torch.int32,
                                    device=device) if self.speculate else None)
        self.dstate = DecodeState.create(n_slots, device)
        self.sampling = SamplingState.create(n_slots, device)
        self.runner = ChunkRunner(
            params, cfg, self.cache, self.dstate, self.sampling, device,
            max_pages=self.alloc.table.shape[1] if self.alloc is not None else None,
            history=self.history, speculate=self.speculate, draft_layers=self.draft_layers,
        )
        self._slots: List[Optional[_Slot]] = [None] * n_slots
        # Bumped when a slot gets a new occupant; chunks carry a snapshot.
        self._gen = [0] * n_slots
        self._release: List[int] = []           # folded out, device side not yet released
        self._prep_reserved: set = set()        # selected, not yet installed
        self._first_reads: List[Tuple[List[Tuple[int, int]], _HostCopy]] = []
        self._drain_queued = False              # a first-read sentinel is in _results
        self._backlog: Deque[GenRequest] = collections.deque()
        self._pending: "queue.Queue[GenRequest]" = queue.Queue()
        self._prepped: "queue.Queue[Any]" = queue.Queue()
        self._results: "queue.Queue[Any]" = queue.Queue(maxsize=self.pipeline_depth)
        self._wake = threading.Event()
        self._prep_wake = threading.Event()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # Completed requests' timings (host clock), newest last.
        self.completed: Deque[Dict[str, float]] = collections.deque(maxlen=4096)
        # The warm-up sweep: while it runs the prefix cache is neither looked
        # up nor filled, and ``_force_chunk`` pins the chunk size.
        self._warming = False
        self._force_chunk: Optional[int] = None
        #: What the last ``warmup`` took (``graph_report()["sweep"]``).
        self.sweep: Optional[Dict[str, Any]] = None
        # Work handed to the device thread (``call_on_device``).
        self._device_jobs: "queue.Queue[Tuple[Any, Future]]" = queue.Queue()
        # Requests inside ``_prepped`` (queue_depth counts them: they hold
        # no slot yet), and the gate the prep thread holds from selection to
        # hand-off, which a rebuild takes to drain every staged admission.
        self._prepped_reqs = 0
        self._prep_gate = threading.Lock()
        # Overload shedding: submits beyond this many queued-but-not-admitted
        # requests raise EngineOverloaded (None: unbounded); batch-class ones
        # at batch_shed_frac of it.
        self.max_queue_depth = max_queue_depth
        self.batch_shed_frac = batch_shed_frac
        # Wall seconds a dispatched block takes (an EMA of dispatch to fold
        # over the blocks): a slot's deadline caps its chunk need. 0: unknown.
        self._block_seconds = 0.0
        # The fault domain: bounded in-flight recovery, the capability ladder
        # and, with ``watchdog_stall_s``, the watchdog. ``health_source``
        # names this engine on ``global_engine_health``.
        self.recovery_max_attempts = max(0, recovery_max_attempts)
        self.degrade = degrade if degrade is not None else DegradeLadder()
        self.health_source = f"{cfg.name}:{id(self) & 0xFFFF:04x}"
        # A rebuild another thread's failure arm asks of the device thread,
        # consumed at the top of its loop; the failed rebuilds in a row.
        self._rebuild_requested: Optional[str] = None
        self._rebuild_failures = 0
        #: Seconds the last rebuild took (``graph_report()["rebuild_s"]``):
        #: the resets' device time between two events on CUDA, read lazily.
        self._last_rebuild: Optional[Tuple[float, Any, Any]] = None
        self._watchdog: Optional[Watchdog] = None
        if watchdog_stall_s:
            self._watchdog = Watchdog(stall_s=watchdog_stall_s, has_work=self._watchdog_has_work,
                                      on_stall=self._on_watchdog_stall, name=self.health_source)

    # ------------------------------------------------------------------ #
    # Lifecycle
    # ------------------------------------------------------------------ #

    def start(self) -> None:
        if self._threads:
            return
        loops = [(self._run, "device-loop"), (self._read_loop, "reader")]
        if self.overlap_admission:
            loops.append((self._prep_loop, "admit-prep"))
        for target, name in loops:
            t = threading.Thread(target=target, name=f"pilottai-torch-{name}", daemon=True)
            t.start()
            self._threads.append(t)
        if self._watchdog is not None:
            self._watchdog.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._prep_wake.set()
        if self._watchdog is not None:
            self._watchdog.stop()
        # An engine that could not recover stays stalled until it stops.
        global_engine_health.mark_recovered(self.health_source)
        for t in self._threads:
            t.join(timeout=60)
        self._threads = []
        if self._pending_restores:
            # Restores staged but not written: write them now (the threads
            # are joined; this thread owns the device state), so no chain
            # the index holds is left unwritten.
            with (torch.cuda.stream(self.stream) if self.stream is not None
                  else contextlib.nullcontext()):
                self._apply_restores()
        if self.device.type == "cuda":
            # Chunks dispatched just before the stop may still run.
            torch.cuda.synchronize(self.device)
            self.runner.drop_graphs()
        err = RuntimeError("engine stopped")
        while True:
            try:
                _, done = self._device_jobs.get_nowait()
            except queue.Empty:
                break
            done.set_exception(err)
        self._drain_pending()
        while True:
            try:
                item = self._prepped.get_nowait()
            except queue.Empty:
                break
            pairs = [tuple(item.seg[:2])] if isinstance(item, _SegmentStart) else item.group
            self._fail_group(pairs, err)
        self._prepped_reqs = 0
        if self._segmenting is not None:
            self._fail_group([tuple(self._segmenting[:2])], err)
            self._end_segmentation()
        with self._lock:
            for req in self._backlog:
                if not req.future.done():
                    req.future.set_exception(err)
            self._backlog.clear()
            for i, slot in enumerate(self._slots):
                if slot is not None:
                    self._drop_slot_locked(i)
                    if not slot.request.future.done():
                        slot.request.future.set_exception(err)

    def queue_depth(self) -> int:
        """Requests submitted but not yet admitted to a slot (any thread;
        approximate — the containers move concurrently). Staged admissions
        count: they hold no slot yet."""
        return self._pending.qsize() + len(self._backlog) + self._prepped_reqs

    def saturated(self) -> bool:
        return self.max_queue_depth is not None and self.queue_depth() >= self.max_queue_depth

    def _shed_reason(self, request: GenRequest) -> Optional[str]:
        """Why this submit must shed, or None. Interactive traffic sheds at
        ``max_queue_depth``, the ``batch`` class at ``batch_shed_frac`` of
        it, and outright at the degrade ladder's last rung (the JAX
        batcher's rule: only the literal ``batch`` class sheds early)."""
        cls = self._shed_class(request)
        if cls == "batch" and self.degrade.level() >= degrade_levels.SHED_BATCH:
            return (f"engine degraded to level {degrade_levels.SHED_BATCH} "
                    f"({degrade_levels.LEVEL_NAMES[degrade_levels.SHED_BATCH]}); "
                    f"shedding {cls}-class requests")
        limit = self.max_queue_depth
        if limit is None:
            return None
        if cls == "batch":
            limit = max(1, int(limit * self.batch_shed_frac))
        depth = self.queue_depth()
        if depth >= limit:
            return f"engine queue depth {depth} at configured {cls}-class limit {limit}; shedding"
        return None

    @staticmethod
    def _shed_class(request: GenRequest) -> str:
        """``batch``, ``interactive``, or ``other`` (an unknown string:
        interactive rules, a bounded metrics key)."""
        cls = request.slo_class or "interactive"
        return cls if cls in ("interactive", "batch") else "other"

    def submit(self, request: GenRequest) -> Future:
        """Queue a request (any thread). A request the shedding rules refuse
        raises ``EngineOverloaded`` here and leaves no trace; one whose
        deadline has passed fails at once. Prompts longer than the keep
        window are left-truncated, as the JAX batcher does."""
        if self._stop.is_set():
            raise RuntimeError("engine stopped")
        shed = self._shed_reason(request)
        if shed is not None:
            global_metrics.inc("engine.shed")
            global_metrics.inc(f"engine.shed.{self._shed_class(request)}")
            global_metrics.set_gauge("engine.queue_depth", float(self.queue_depth()))
            raise EngineOverloaded(shed)
        if request.deadline is not None and time.monotonic() >= request.deadline:
            global_metrics.inc("engine.expired")
            request.future.set_exception(DeadlineExceeded("request deadline expired before submit"))
            return request.future
        if not request.prompt_ids:
            request.prompt_ids = [0]
        keep = self.max_seq_len - 1 - request.max_new_tokens
        keep = min(max(keep, 1), self.max_seq_len - 2)
        if len(request.prompt_ids) > keep:
            request.prompt_ids = request.prompt_ids[-keep:]
        self._pending.put(request)
        global_metrics.set_gauge("engine.queue_depth", float(self.queue_depth()))
        self._wake.set()
        self._prep_wake.set()
        return request.future

    def call_on_device(self, fn, timeout: float = 3600.0) -> Any:
        """Run ``fn()`` on the device thread, on its stream, after it has
        applied the releases folded so far and before it admits or
        dispatches, and return what it returns (its exception is raised
        here). Needs ``start()``."""
        if not self._threads:
            raise RuntimeError("call_on_device needs the device thread: call start() first")
        done: Future = Future()
        self._device_jobs.put((fn, done))
        self._wake.set()
        return done.result(timeout=timeout)

    def reachable_keys(self) -> List[VariantKey]:
        """Every chunk-graph key a dispatch can form at these settings:
        each chunk bucket; the fused epilogue on and off (off alone without
        it); on the paged cache each page count of the prefix-bound ladder
        (``_decode_bucket`` from ``MIN_DECODE_BUCKET`` to ``max_seq_len``,
        clipped to the table's width), under dense speculation each bound
        of that ladder; the model drafts off and, with draft layers, on."""
        rungs = sorted({self._decode_bucket(1 << k)
                        for k in range(self.max_seq_len.bit_length() + 1)})
        pages: List[Optional[int]] = [None]
        bounds: List[Optional[int]] = [None]
        if self.alloc is not None:
            width = self.alloc.table.shape[1]
            pages = sorted({min(-(-r // self.page_size), width) for r in rungs})
        elif self.speculate:
            bounds = list(rungs)
        keys = []
        for n in self.chunk_buckets:
            for fused in ((False, True) if self.fused_epilogue else (False,)):
                for drafts in ((False, True) if self.draft_layers else (False,)):
                    for n_blocks in pages:
                        for bound in bounds:
                            keys.append(self.runner.key(n, fused, n_blocks, bound, drafts))
        return keys

    def warmup_prompt_lens(self) -> Tuple[int, ...]:
        """The prompt lengths of the sweep's requests, the JAX batcher's:
        one per prompt bucket, up to ``2 x prefill_chunk`` when prompts
        segment, then one of ``max_seq_len - 8`` that segments."""
        cap = self.max_seq_len
        if self.prefill_chunk:
            cap = min(cap, 2 * self.prefill_chunk)
        lens = tuple(sorted({self._bucket(n) for n in range(1, cap + 1)}))
        if self.prefill_chunk and self.max_seq_len > cap:
            lens = lens + (self.max_seq_len - 8,)
        return lens

    def warmup(self, prompt_lens: Optional[Sequence[int]] = None) -> Dict[str, Any]:
        """Make serving pay no first-use cost, before any request: capture
        every chunk graph ``reachable_keys`` lists (``ChunkRunner.warm`` on
        the device thread, while no slot is occupied), then send one
        request of two tokens per prompt bucket per chunk bucket, each
        pinned to its chunk bucket through ``_force_chunk``, as the JAX
        batcher's ``warmup`` does: the prefill buckets (kernel K1's build
        and first launches, cuBLAS's first calls), with chunked prefill
        one long prompt through the segment ladder, and a replay of each
        chunk bucket. The prompt ids shift per chunk bucket, as JAX's do.
        While it runs the prefix cache is neither looked up nor filled;
        after it every counter that serving reads is as a fresh engine has
        it (the kernels' launch counts are the process's, and are not
        rewound: a reader resets them before what it counts). A failed
        capture or
        request raises, naming its key or its prompt; nothing serves with a
        variant missing. Returns ``self.sweep``."""
        with self._lock:
            if self._occupied() or self._backlog or self._pending.qsize():
                raise RuntimeError("warmup needs an idle engine")
        run = self.runner
        run.graphs_captured, run.capture_seconds, run.eager_seconds = 0, 0.0, 0.0
        t0 = time.perf_counter()
        self._warming = True
        try:
            keys = self.reachable_keys()

            def warm_all() -> None:
                gc.collect()     # garbage that holds graphs goes before any capture
                for key in keys:
                    try:
                        run.warm(key)
                    except Exception as exc:
                        raise RuntimeError(f"warm-up of chunk graph {key} failed: {exc}") from exc

            self.call_on_device(warm_all)
            lens = self.warmup_prompt_lens() if prompt_lens is None else tuple(prompt_lens)
            requests = 0
            for plen in lens:
                plen = min(int(plen), self.max_seq_len - 8)
                for ci, cb in enumerate(self.chunk_buckets):
                    self._force_chunk = cb
                    # JAX's ids, wrapped into the vocab (its gather clamps them).
                    ids = [(2 + ci + j) % self.cfg.vocab_size for j in range(plen)]
                    req = GenRequest(prompt_ids=ids, max_new_tokens=2)
                    try:
                        self.submit(req).result(timeout=3600)
                    except Exception as exc:
                        raise RuntimeError(f"warm-up request of {plen} prompt tokens, chunk "
                                           f"{cb} failed: {exc}") from exc
                    requests += 1
            self._wait_idle()
        finally:
            self._warming = False
            self._force_chunk = None
        self._reset_serving_counters()
        shared, unshared = run.buffer_bytes()
        self.sweep = {"wall_s": time.perf_counter() - t0, "graphs": run.graphs_captured,
                      "keys": len(keys), "eager_s": run.eager_seconds,
                      "capture_s": run.capture_seconds, "requests": requests,
                      "buffer_bytes": shared, "buffer_bytes_unshared": unshared,
                      "pool_bytes": run.pool_bytes()}
        run.graphs_captured, run.capture_seconds, run.eager_seconds = 0, 0.0, 0.0
        return self.sweep

    def _wait_idle(self, timeout_s: float = 600.0) -> None:
        """Until no request is queued or in a slot and every dispatched
        chunk has been folded."""
        t0 = time.perf_counter()
        while True:
            with self._lock:
                idle = (not self._occupied() and not self._backlog and not self._pending.qsize()
                        and not self._prepped.qsize() and self._segmenting is None
                        and not self._results.qsize() and not self._first_reads
                        and self.blocks_folded == self.blocks_dispatched)
            if idle:
                return
            if time.perf_counter() - t0 > timeout_s:
                raise RuntimeError(f"the engine did not go idle in {timeout_s:.0f} s")
            time.sleep(0.002)

    def _reset_serving_counters(self) -> None:
        """Every counter and estimate serving reads, as a fresh engine has
        them."""
        with self._lock:
            self.blocks_dispatched = self.blocks_useful = self.blocks_folded = 0
            self.spec_tokens = self.spec_blocks = self.draft_blocks = 0
            self._spec_rate = 1.0
            self._slot_rate[:] = float(max(self.speculate, 1))
            self._draft_on[:] = False
            self.prefix_admitted = self.prefix_tokens_saved = self.prefix_export_failures = 0
            self.prefill_segments = 0
            self.runner.draft_replays = 0
            self.completed.clear()

    def graph_report(self) -> Dict[str, Any]:
        """The chunk graphs: how many were captured since the warm-up
        sweep (none, once it has run) and the seconds those captures took,
        the bytes the variants' buffers and the graphs' shared memory pool
        hold (the pool None where it is not known), the replays of
        model-draft variants, the sweep (``self.sweep``; None before it),
        the quantized product's arm the graphs were captured under, and the
        seconds the last failure-path rebuild took (None before one): on
        CUDA the in-place resets' device time, between two events on the
        device thread's stream."""
        shared, _ = self.runner.buffer_bytes()
        rebuild_s = None
        if self._last_rebuild is not None:
            rebuild_s, ev0, ev1 = self._last_rebuild
            if ev0 is not None:
                ev1.synchronize()
                rebuild_s = ev0.elapsed_time(ev1) / 1e3
        return {"qmatmul_arm": self.qmatmul_arm,
                "rebuild_s": rebuild_s,
                "graphs": self.runner.graphs_captured,
                "capture_s": self.runner.capture_seconds,
                "buffer_bytes": shared,
                "pool_bytes": self.runner.pool_bytes(),
                "draft_replays": self.runner.draft_replays,
                "sweep": self.sweep}

    @property
    def prefix_lookups(self) -> int:
        """Prefix-cache lookups, one per request (this engine's share of
        ``engine.kvcache.lookups``)."""
        return self.kvcache.lookups if self.kvcache is not None else 0

    @property
    def prefix_hits(self) -> int:
        """Lookups that found a usable cached prefix (an entry that fits, or
        a page chain, device-resident or restored; this engine's share of
        ``engine.kvcache.hits``)."""
        return self.kvcache.hits if self.kvcache is not None else 0

    # ------------------------------------------------------------------ #
    # Session and request K/V transfer (the host tier's sealed format)
    # ------------------------------------------------------------------ #

    def export_session_kv(self, session_id: str):
        """A session's K/V lineage in the transfer format, taken under the
        slot lock so no spill or restore interleaves. None when the tier is
        off or the session unknown: the target then prefills."""
        if self.kvcache is None or self.kvcache.host is None:
            return None
        with self._lock:
            return self.kvcache.export_session(session_id)

    def import_session_kv(self, export) -> Dict[str, int]:
        """Land an exported session in this engine's host tier, so its next
        turn restores here. Returns the accepted, token and rejected
        counts (budget pressure may refuse some entries)."""
        if self.kvcache is None or self.kvcache.host is None or not export:
            return {"accepted": 0, "tokens": 0, "rejected": 0}
        with self._lock:
            return self.kvcache.import_session(export)

    def export_request_kv(self, prompt_ids, session_id: Optional[str] = None):
        """The K/V a prefilled request left in the cache tier (the dense
        entry, the page chain, host spills), keyed by its prompt ids; no
        session pin moves. None when nothing is cached for it."""
        if self.kvcache is None:
            return None
        with self._lock:
            return self.kvcache.export_request(tuple(prompt_ids), session_id=session_id)

    def import_request_kv(self, export) -> Dict[str, int]:
        """Land a prefilled request's K/V in the host tier, so its
        admission here restores instead of prefilling. Not under the slot
        lock: it writes only the host tier (its own lock), and checksums a
        whole prompt's K/V."""
        if self.kvcache is None or self.kvcache.host is None or not export:
            return {"accepted": 0, "tokens": 0, "rejected": 0}
        return self.kvcache.import_session(export)

    def spec_report(self) -> Dict[str, Any]:
        """Speculative decoding: the block rows, tokens folded from
        speculative chunks, the (block, slot) pairs that emitted them and
        their ratio (tokens per block), the acceptance EMA, the slots in
        model-draft mode and the blocks dispatched in the model-draft
        variant.
        Empty when speculation is off."""
        if not self.speculate:
            return {}
        with self._lock:
            return {"draft_len": self.speculate, "tokens": self.spec_tokens,
                    "blocks": self.spec_blocks,
                    "tokens_per_block": self.spec_tokens / max(self.spec_blocks, 1),
                    "rate_ema": self._spec_rate, "draft_layers": self.draft_layers,
                    "draft_on": int(self._draft_on.sum()),
                    "draft_blocks": self.draft_blocks}

    def prefix_report(self) -> Dict[str, Any]:
        """The prefix cache: lookups (one per request), hits, requests
        admitted by a tail prefill against a cached prefix, the prompt
        tokens saved, failed exports, and the store's entries and bytes
        (dense) or the pinned pages (paged); with the host tier, ``host``:
        its entries and bytes, host hits, restores, restored tokens and
        integrity failures. Empty when the cache is off."""
        if self.kvcache is None:
            return {}
        with self._lock:
            out = {"lookups": self.prefix_lookups, "hits": self.prefix_hits,
                   "admitted": self.prefix_admitted, "tokens_saved": self.prefix_tokens_saved,
                   "export_failures": self.prefix_export_failures}
            if self.prefix_store is not None:
                entries = self.prefix_store.entries()
                out["entries"] = len(entries)
                out["entry_tokens"] = sorted((len(e.ids) for e in entries), reverse=True)
                out["bytes"] = sum(e.nbytes for e in entries)
            else:
                out["pinned_pages"] = self.page_index.pinned_pages
                out["free_pages"] = self.alloc.free_pages
            host = self.kvcache.host
            if host is not None:
                counts = self.kvcache.counts
                out["host"] = {"entries": len(host), "bytes": host.bytes_held,
                               **{k: int(counts[k]) for k in (
                                   "host_hits", "restores", "restored_tokens",
                                   "integrity_failures")}}
        return out

    # ------------------------------------------------------------------ #
    # Buckets and chunk planning (lock held where noted)
    # ------------------------------------------------------------------ #

    def _bucket(self, n: int) -> int:
        """Power-of-two prompt bucket with a ``MIN_BUCKET`` floor."""
        return min(_pow2_at_least(n, MIN_BUCKET), self.max_seq_len)

    def _tail_bucket(self, n: int) -> int:
        """Tail bucket of a prefix admission: the power of two at least
        ``MIN_TAIL_BUCKET`` (a one-token tail padded to the 64-token prompt
        floor would cost a good share of a whole prefill)."""
        return _pow2_at_least(n, MIN_TAIL_BUCKET)

    def _prefix_hit(self, req: GenRequest):
        """The cached prefix this request admits through (lock held): a
        ``PageNode`` chain on the paged cache, a ``PrefixEntry`` on the
        dense one, or None. A dense entry whose tail bucket would pass
        ``max_seq`` is a miss (``fits``): its tail would land on the
        cached prefix rows. Both go through the one lookup of the KV cache
        tier: the device tier first, then the host tier, whose hit
        restores (a paged restore's ``PendingRestore`` is queued for the
        device thread)."""
        if self.kvcache is None or self._warming:
            return None
        count = not req.kv_counted
        req.kv_counted = True
        if self.page_index is not None:
            need = min(len(req.prompt_ids) + req.max_new_tokens, self.max_seq_len)
            node, rec = self.kvcache.lookup_paged(
                req.prompt_ids, session_id=req.session_id, alloc=self.alloc,
                max_seq_len=self.max_seq_len, need_tokens=need, epoch=self._alloc_epoch,
                count=count)
            if rec is not None:
                self._pending_restores.append(rec)
            return node
        n = len(req.prompt_ids)

        def fits(plen: int, p_bucket: int) -> bool:
            return (plen + self._tail_bucket(n - plen) <= self.max_seq_len
                    and p_bucket <= self.max_seq_len)

        return self.kvcache.lookup_dense(req.prompt_ids, session_id=req.session_id, fits=fits,
                                         bucket=self._bucket, count=count)

    def _decode_bucket(self, n: int) -> int:
        """Prefix-bound rung of a paged chunk: the prompt ladder with a
        ``MIN_DECODE_BUCKET`` floor, so the graphs stay O(log S)."""
        return max(self._bucket(n), min(MIN_DECODE_BUCKET, self.max_seq_len))

    def _occupied(self) -> List[_Slot]:
        return [s for s in self._slots if s is not None]

    def _chunk_useful(self) -> bool:
        """Some occupied slot still has budget that its folded tokens and
        the chunks in flight do not cover (lock held). Under speculation
        half a block's worth of the acceptance EMA is tolerated: the EMA
        sits just under D, and an exact check would dispatch a whole
        wasted weight pass at a wave's end, where a miss costs one fold."""
        tol = self._spec_rate / 2 if self.speculate else 0.0
        return any(
            max(0, len(s.generated) - 1) + s.est_pending < s.request.max_new_tokens - 1 - tol
            for s in self._occupied()
        )

    def _pick_chunk_blocks(self) -> int:
        """The next dispatch's steps, or verify blocks (lock held).
        "fixed": ``chunk_size``. "adaptive": each live slot's remaining
        need (budget less what is folded and in flight) in blocks at the
        acceptance EMA's tokens a block, capped by its deadline at the
        blocks' wall time, the mean of them, or the smallest while requests
        wait for a slot (a finishing slot's release then comes at the
        earliest chunk boundary); quantised up to the bucket ladder. From
        the degrade ladder's ``min_chunk`` rung on, the smallest bucket."""
        if self._force_chunk is not None:       # the warm-up sweep
            return max(1, min(self._force_chunk, self.chunk_size))
        # Degrade rung 2+: the smallest bucket (a short blast radius per
        # fault, fast fold heartbeats for the watchdog).
        if self.degrade.level() >= degrade_levels.MIN_CHUNK:
            return self.chunk_buckets[0]
        if self.chunk_policy != "adaptive":
            return self.chunk_size
        rate = max(self._spec_rate if self.speculate else 1.0, 0.5)
        now = time.monotonic()
        needs = []
        for s in self._occupied():
            rem = s.request.max_new_tokens - 1 - max(0, len(s.generated) - 1) - s.est_pending
            if rem > 0:
                need = int(-(-rem // rate))
                ddl = s.request.deadline
                if ddl is not None and self._block_seconds > 0:
                    # Blocks past the deadline are waste: the sweep releases
                    # the slot before they fold.
                    need = min(need, max(int((ddl - now) / self._block_seconds), 1))
                needs.append(max(need, 1))
        if not needs:
            return self.chunk_buckets[0]
        target = sum(needs) / len(needs)
        if self._backlog or self._pending.qsize() or self._prepped.qsize():
            target = min(target, float(min(needs)))
        for b in self.chunk_buckets:
            if b >= target:
                return b
        return self.chunk_buckets[-1]

    # ------------------------------------------------------------------ #
    # Device thread
    # ------------------------------------------------------------------ #

    def _run(self) -> None:
        ctx = contextlib.nullcontext()
        if self.stream is not None:
            torch.cuda.set_device(self.device)
            # The weights and the cache were made on the default stream.
            self.stream.wait_stream(torch.cuda.default_stream(self.device))
            ctx = torch.cuda.stream(self.stream)
        with ctx:
            while not self._stop.is_set():
                try:
                    if self._rebuild_requested is not None:
                        self._requested_rebuild()
                    self._expire_deadlines()
                    self._apply_releases()
                    self._run_device_jobs()
                    issued = self._admit()
                    with self._lock:
                        useful = self._chunk_useful()
                        drain = (not useful and bool(self._first_reads)
                                 and not self._drain_queued)
                        self._drain_queued |= drain
                    if useful:
                        self._decode()
                    elif drain:
                        self._put_result(None)   # the reader folds first tokens, in order
                    elif not issued:
                        self._wake.wait(timeout=0.05)
                        self._wake.clear()
                except Exception as exc:  # noqa: BLE001 — device loop boundary
                    _log.error("device loop error: %s", exc, exc_info=True)
                    if sticky_device_error(exc):
                        self._declare_dead(exc, "sticky CUDA error")
                        continue
                    self._fail_occupied_slots(exc)
                    # Conservative containment: a dispatch that raised may
                    # have left device state half-written, so the recovered
                    # requests re-prefill into state reset from scratch.
                    self._rebuild_or_retry("device_loop_error")

    def _requested_rebuild(self) -> None:
        """The rebuild another thread's failure arm asked for (device
        thread, at the top of its loop). Anyone occupying a slot now (an
        admission installed since that arm swept the slots) is recovered
        first: nothing decodes on across a reset."""
        reason, self._rebuild_requested = self._rebuild_requested, None
        with self._lock:
            occupied = bool(self._occupied())
        if occupied:
            self._fail_occupied_slots(
                RuntimeError(f"device state rebuilt ({reason}) with request in flight"),
                record_fault=False)
        self._rebuild_or_retry(reason)

    def _rebuild_or_retry(self, reason: str) -> None:
        """Rebuild the device state; a rebuild that fails is retried at the
        next cycle (``rebuild_retry``), at most ``recovery_max_attempts``
        times in a row (once when recovery is off), after which the engine
        is declared unable to recover rather than left spinning."""
        try:
            self._rebuild_device_state(reason=reason)
            self._rebuild_failures = 0
        except Exception as exc:  # noqa: BLE001 — retried next cycle, bounded
            self._rebuild_failures += 1
            _log.error("device-state rebuild failed (%d in a row): %s", self._rebuild_failures,
                       exc, exc_info=True)
            if self._rebuild_failures >= max(1, self.recovery_max_attempts):
                self._rebuild_failures = 0
                self._declare_dead(exc, f"device-state rebuild ({reason}) failed")
            else:
                self._rebuild_requested = "rebuild_retry"
                self._wake.set()

    def _run_device_jobs(self) -> None:
        while True:
            try:
                fn, done = self._device_jobs.get_nowait()
            except queue.Empty:
                return
            try:
                done.set_result(fn())
            except Exception as exc:  # noqa: BLE001 — raised in the caller
                done.set_exception(exc)

    def _put_result(self, item: Any) -> None:
        """Hand a chunk (or a first-read sentinel) to the reader; blocks
        while ``pipeline_depth`` chunks wait to be folded."""
        while not self._stop.is_set():
            try:
                self._results.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def _apply_releases(self) -> None:
        """Stop the slots the reader released, on the device, before any
        admission can reuse them."""
        with self._lock:
            released, self._release = self._release, []
        if released:
            release_decode(self.dstate, released)
            free_slots(self.cache, released)
            self._prep_wake.set()

    def _admit(self) -> bool:
        """One admission step: advance a segmented prefill by one segment,
        or dispatch the staged groups (staged here when admission does not
        overlap). True when device work was issued. Pending host-tier
        restores are written first: any admission may map their pages."""
        self._apply_restores()
        if self._segmenting is not None:
            self._advance_segment()
            return True
        items: List[Any] = []
        if self.overlap_admission:
            while True:
                try:
                    item = self._prepped.get_nowait()
                except queue.Empty:
                    break
                items.append(item)
                with self._lock:
                    self._prepped_reqs = max(0, self._prepped_reqs - self._item_requests(item))
            if items:
                self._prep_wake.set()
        else:
            self._drain_pending()
            items = self._stage()
        for i, item in enumerate(items):
            try:
                if isinstance(item, _SegmentStart):
                    # Selection stops at a long prompt, so nothing follows it.
                    self._segmenting = item.seg
                    self._advance_segment()
                elif self._all_expired(item.group):
                    self._fail_group(item.group, DeadlineExceeded(
                        "request deadline expired before admission dispatch"))
                else:
                    self._dispatch_prefill(item)
            except BaseException:
                # The device loop's fault arm takes over; what was not
                # dispatched goes back to the backlog's head, in order.
                with self._lock:
                    self._requeue_locked(items[i + 1:])
                raise
        return bool(items)

    @staticmethod
    def _item_requests(item: Any) -> int:
        return 1 if isinstance(item, _SegmentStart) else len(item.group)

    def _all_expired(self, group: Sequence[Tuple[int, GenRequest]]) -> bool:
        """Every member of a staged group was cancelled or passed its
        deadline while it waited (a staged group can wait out a whole
        segmented prefill): its prefill would be dead work. Counts the
        expired ones. A mixed group dispatches; the sweep reaps the rest."""
        now = time.monotonic()
        dead = [req.cancelled or req.future.done()
                or (req.deadline is not None and now >= req.deadline) for _, req in group]
        if not all(dead):
            return False
        expired = sum(1 for _, req in group if req.deadline is not None and now >= req.deadline
                      and not req.future.done())
        if expired:
            global_metrics.inc("engine.expired", expired)
        return True

    def _requeue_locked(self, items: Sequence[Any]) -> None:
        """Staged admissions back to the backlog's head, in order (lock
        held): their slots unreserved and their pages released."""
        reqs: List[GenRequest] = []
        for item in items:
            if isinstance(item, _SegmentStart):
                self._seg_pending = False
                pairs = [tuple(item.seg[:2])]
            else:
                pairs = item.group
            for idx, req in pairs:
                self._prep_reserved.discard(idx)
                if self.alloc is not None:
                    self.alloc.release(idx)
                reqs.append(req)
        self._backlog.extendleft(reversed(reqs))
        if reqs:
            self._prep_wake.set()
            self._wake.set()

    def _dispatch_prefill(self, prep: _Prepared) -> None:
        """Install a staged group and enqueue its prefill; the first tokens'
        copy starts here and the reader folds it. A failed admission
        returns this group's slots and pages and re-admits its requests
        (``_prefill_failed``); the other occupants are untouched."""
        # A restore record that landed after ``_admit``'s drain is written
        # here, before this dispatch can read its pages (one thread: program
        # order).
        self._apply_restores()
        try:
            # Fault point: a slow (delay=) or failed (exc=) admission prefill.
            global_injector.fire("engine.prefill", n_requests=len(prep.group))
        except Exception as exc:  # noqa: BLE001 — contain to this group
            self._prefill_failed(prep.group, exc)
            return
        with self._lock:
            for idx, req in prep.group:
                self._slots[idx] = _Slot(request=req, prompt_len=len(req.prompt_ids))
                self._gen[idx] += 1
                self._prep_reserved.discard(idx)
                # A new occupant drafts from its history first; its own EMA
                # moves it to model drafts only if its output proves novel.
                self._slot_rate[idx] = float(max(self.speculate, 1))
                self._draft_on[idx] = False
            stamps = [(idx, self._gen[idx]) for idx, _ in prep.group]
        full = None
        if self.history is not None and prep.kind != "full":
            full = self._full_prompts(prep.group)
        try:
            if prep.kind == "prefix_paged":
                self.cache, self.dstate, self.sampling, first = admit_group_prefix_paged(
                    self.params, self.cfg, self.cache, self.dstate, self.sampling, prep.chain,
                    prep.tokens, prep.page_rows, prep.meta_i32, prep.meta_f32,
                    history=self.history, full_tokens=full,
                )
            elif prep.kind == "prefix":
                if prep.entry.ready is not None and self.stream is not None:
                    # A restored entry: its panels were uploaded on the
                    # index's copy stream; K1 reads them after that copy.
                    self.stream.wait_event(prep.entry.ready)
                self.cache, self.dstate, self.sampling, first = admit_group_prefix(
                    self.params, self.cfg, self.cache, self.dstate, self.sampling,
                    prep.entry.ks, prep.entry.vs, prep.tokens, prep.meta_i32, prep.meta_f32,
                    history=self.history, full_tokens=full,
                )
            else:
                self.cache, self.dstate, self.sampling, first = admit_group(
                    self.params, self.cfg, self.cache, self.dstate, self.sampling, prep.tokens,
                    prep.meta_i32, prep.meta_f32, page_rows=prep.page_rows,
                    history=self.history,
                )
            copy = _HostCopy([first])
        except Exception as exc:  # noqa: BLE001 — contain to this group
            self._prefill_failed(prep.group, exc)
            return
        admit_at = time.perf_counter()
        if not self._warming:
            # The tokens this dispatch prefilled (tails on the prefix kinds;
            # the cached prefix was not computed again).
            global_metrics.inc("engine.prefill_tokens", int(prep.meta_i32[AI_LEN].sum()))
            if prep.kind != "full" and not prep.segmented:
                global_metrics.inc("engine.kvcache.prefill_tokens_saved",
                                   prep.prefix_len * len(prep.group))
        with self._lock:
            if prep.kind != "full" and not prep.segmented:
                self.prefix_admitted += len(prep.group)
                self.prefix_tokens_saved += prep.prefix_len * len(prep.group)
            # Pinned before the first token is published: until the reader
            # folds it, nothing can release these slots' pages.
            self._maybe_register(prep.group)
            self._first_reads.append((stamps, copy))
            for _, req in prep.group:
                if req.recovery_started_at is not None:
                    # Snapshot to re-admission: what the fault cost it.
                    global_metrics.observe("engine.recovery_ms",
                                           (admit_at - req.recovery_started_at) * 1e3)
                    req.recovery_started_at = None
        self._beat()                          # prefill enqueued: progress
        global_metrics.inc("engine.admitted", len(prep.group))
        global_metrics.set_gauge("engine.queue_depth", float(self.queue_depth()))
        if prep.kind == "full":
            self._maybe_export(prep.group)

    def _prefill_failed(self, group: Sequence[Tuple[int, GenRequest]], exc: Exception) -> None:
        """A failed admission prefill is a device fault, not the client's:
        no token existed for the group yet, so its requests re-admit at
        the backlog's head (bounded strikes) and the failure steps the
        degrade ladder. A sticky CUDA error fails them instead."""
        _log.error("prefill failed: %s", exc, exc_info=True)
        if sticky_device_error(exc):
            self._fail_group(group, exc)
            self._declare_dead(exc, "sticky CUDA error")
            return
        self._fail_group(group, exc, recover=True)
        self.degrade.record_fault("prefill")

    def _apply_restores(self) -> None:
        """Write the pending host-tier page restores into the pool (device
        thread, on its stream: uploads from pinned memory and the scatter,
        never awaited). Runs before any admission or segment dispatch, so a
        restored chain is in the pool before anything reads it. Records of
        an older allocator epoch are unwound inside ``apply_restores``. The
        unwritten-page guard lifts for every record taken, written or not:
        a failed write reaches the device loop's fault arm, whose rebuild
        drops the pool's pages anyway."""
        if self.kvcache is None:
            return
        with self._lock:
            if not self._pending_restores:
                return
            records, self._pending_restores = self._pending_restores, []
            epoch = self._alloc_epoch
        try:
            self.cache = self.kvcache.apply_restores(self.cache, records, epoch)
        finally:
            with self._lock:
                self.kvcache.mark_written(records)
        self._beat()                          # restores enqueued: progress

    @staticmethod
    def _full_prompts(group: List[Tuple[int, GenRequest]]) -> np.ndarray:
        """A prefix admission's whole prompts, right-padded (the history's
        install reads them; the prefill reads only the tails)."""
        out = np.zeros((len(group), max(len(r.prompt_ids) for _, r in group)), np.int64)
        for row, (_, req) in enumerate(group):
            out[row, : len(req.prompt_ids)] = req.prompt_ids
        return out

    def _maybe_register(self, group: List[Tuple[int, GenRequest]]) -> None:
        """After a paged admission (cold, hit or a final segment), pin the
        pages each prompt fully covers into the index (lock held). Only
        blocks inside the prompt are immutable (decode writes start at
        ``prompt_len``); the partial last block stays private."""
        if self.page_index is None or self._warming:
            return
        P = self.page_size
        for idx, req in group:
            nb = len(req.prompt_ids) // P
            if nb:
                pages = [int(p) for p in self.alloc.table[idx, :nb]]
                self.page_index.register(req.prompt_ids[: nb * P], pages, self.alloc)

    def _maybe_export(self, group: List[Tuple[int, GenRequest]]) -> None:
        """After a cold dense admission, copy each new prompt's K/V (less
        its last token, capped at ``max_len`` rows) out of its slot into
        the store, with the derived longest-common-prefix entries that
        converge on shared preambles. Best-effort: a failed export never
        fails a request, but it is counted and logged."""
        store = self.prefix_store
        if store is None or self._warming:
            return
        seen = set()
        for idx, req in group:
            # The prompt minus its last token: match() takes a proper
            # prefix, whose tail token gives the first-token logits, so an
            # exact repeat hits as a one-token tail. Longer prompts store
            # their first max_len tokens (prefix K/V is suffix-independent).
            ids = tuple(req.prompt_ids[:-1])[: store.max_len]
            if len(ids) < store.min_len:
                self._warn_min_len(len(req.prompt_ids))
                continue
            with self._lock:
                known = ids in seen or store.has(ids)
            if known:
                continue
            seen.add(ids)
            try:
                pb = self._bucket(len(ids))
                # fp32 when the cache is int8: install quantizes it again.
                ks, vs = export_prefix(self.cache, idx, pb)
                with self._lock:
                    store.store(ids, ks, vs, pb)
                    lcps = store.lcp_candidates(ids)
                for p in lcps:
                    pb2 = self._bucket(p)
                    ks2, vs2 = ks[:, :, :pb2].clone(), vs[:, :, :pb2].clone()
                    with self._lock:
                        store.store(ids[:p], ks2, vs2, pb2)
            except Exception as exc:  # noqa: BLE001 — the cache is optional
                if device_fault(exc):
                    raise                     # the device loop's fault arm
                with self._lock:
                    self.prefix_export_failures += 1
                _log.warning("prefix export failed: %s", exc)
                return

    def _warn_min_len(self, n: int) -> None:
        """Once per engine: prompts at or below the store's entry floor
        never cache (an entry is the prompt less its last token)."""
        if self._warned_min_len:
            return
        self._warned_min_len = True
        _log.warning("admitted prompt of %d token(s) is at or below the dense prefix-store "
                     "floor (min_len=%d): prompts this short are never cached; lower "
                     "engine_prefix_min_len if this workload should cache",
                     n, self.prefix_store.min_len)

    def _decode(self) -> None:
        """Plan one decode chunk under the lock, dispatch it and hand it to
        the reader. From the degrade ladder's ``no_draft`` rung on, the
        model drafts are off (the variant without them). A dispatch that
        raises leaves the planned blocks uncounted and reaches the device
        loop's fault arm."""
        with self._lock:
            if not self._chunk_useful():
                return
            n = self._pick_chunk_blocks()
            occupied = self._occupied()
            D = self.speculate or 1
            # The longest cache any live slot can hold at this chunk's
            # start: folded decode tokens plus all the chunks in flight can
            # add (the first token enters the cache with the first step).
            bound = max(
                s.prompt_len + min(max(0, len(s.generated) - 1) + s.hi_pending,
                                   s.request.max_new_tokens - 1)
                for s in occupied
            )
            # The in-flight ledger: the tokens this chunk is expected to
            # add at the acceptance EMA, and the most it can add.
            est = n * (self._spec_rate if self.speculate else 1.0)
            hi = n * D
            for s in occupied:
                s.est_pending += est
                s.hi_pending += hi
            fused = self.fused_epilogue and all(
                s.request.temperature <= 0.0 and not s.request.json_mode for s in occupied
            )
            stamp = tuple(self._gen)
            table = self.alloc.table.copy() if self.alloc is not None else None
            draft_mode = self._draft_on.copy() if self.draft_layers else None
            if draft_mode is not None and self.degrade.level() >= degrade_levels.NO_DRAFT:
                draft_mode[:] = False
            drafting = draft_mode is not None and bool(draft_mode.any())
            self.blocks_dispatched += n
            self.draft_blocks += n if drafting else 0
        n_blocks = None
        if table is not None:
            n_blocks = min(-(-self._decode_bucket(bound) // self.page_size), table.shape[1])
        prefix_bound = self._decode_bucket(bound) if self.speculate else None
        t_dispatch = time.perf_counter()
        try:
            # Fault points: a failed dispatch (exc=), and a stuck one
            # (delay=, which only the watchdog sees).
            global_injector.fire("engine.step")
            global_injector.fire("engine.dispatch.hang")
            toks, valid = self.runner.run(n, fused, n_blocks, table, prefix_bound=prefix_bound,
                                          draft_mode=draft_mode)
            copy = _HostCopy([toks, valid])
        except BaseException:
            with self._lock:
                self.blocks_dispatched -= n
                self.draft_blocks -= n if drafting else 0
            raise
        self._put_result((copy, stamp, n, est, hi, t_dispatch))

    # ------------------------------------------------------------------ #
    # Admission staging (the prep thread, or the device thread inline)
    # ------------------------------------------------------------------ #

    def _prep_loop(self) -> None:
        while not self._stop.is_set():
            self._drain_pending()
            with self._lock:
                idle = (self._segmenting is not None or self._seg_pending
                        or not self._backlog)
            made = False
            if not idle and self._prepped.qsize() < PREP_DEPTH:
                # Selection to hand-off under the gate: a rebuild drains
                # ``_prepped`` under it, so no staged admission outlives one.
                with self._prep_gate:
                    for item in self._stage():
                        with self._lock:
                            self._prepped_reqs += self._item_requests(item)
                        self._prepped.put(item)
                        made = True
            if made:
                self._wake.set()
            else:
                self._prep_wake.wait(timeout=0.02)
                self._prep_wake.clear()

    def _drain_pending(self) -> None:
        with self._lock:
            while True:
                try:
                    self._backlog.append(self._pending.get_nowait())
                except queue.Empty:
                    break

    def _stage(self) -> List[Any]:
        """Select the next group and pack it; a long prompt behind it comes
        as a ``_SegmentStart``."""
        group, key, seg = self._select()
        items: List[Any] = []
        if group:
            try:
                items.append(self._prepare(group, key))
            except Exception as exc:  # noqa: BLE001 — host-side staging only
                self._fail_group(group, exc)
        if seg is not None:
            self._seg_pending = True
            items.append(_SegmentStart(seg))
        return items

    def _select(self) -> Tuple[List[Tuple[int, GenRequest]], Any, Optional[List[Any]]]:
        """FIFO selection of the next admission group and the cached prefix
        it shares (None for a cold group): members share one prefix hit, so
        a request whose hit differs starts the next group. On the paged
        pool each member's pages are reserved here, a hit's chain mapped at
        the head of its table; when the pool is short, cached pages outside
        that chain are unpinned before the head waits. A prompt whose part
        past its cached chain is long ends the group and is returned as the
        segmentation to start there. A slot whose release the device has
        not applied yet is not selectable: that release would stop its new
        occupant. A lookup or reservation that raises (a failed restore or
        spill) fails its request and ends the group; a sticky CUDA error
        marks the engine stalled."""
        group: List[Tuple[int, GenRequest]] = []
        group_key = None
        seg = None
        failed: Optional[Exception] = None
        with self._lock:
            free = [i for i, s in enumerate(self._slots)
                    if s is None and i not in self._release and i not in self._prep_reserved]
            if self.degrade.level() >= degrade_levels.HALF_SLOTS:
                # Degrade rung 3+: at most half the slots live (less work
                # in flight a fault, smaller recovery replays).
                live = len(self._occupied()) + len(self._prep_reserved)
                free = free[: max(0, max(1, self.n_slots // 2) - live)]
            while self._backlog and len(group) < min(len(free), self.admit_batch):
                req = self._backlog[0]
                if req.cancelled or req.future.done():
                    self._backlog.popleft()
                    continue
                if req.deadline is not None and time.monotonic() >= req.deadline:
                    # Expired while queued: no prefill for a caller gone.
                    self._backlog.popleft()
                    global_metrics.inc("engine.expired")
                    req.future.set_exception(
                        DeadlineExceeded("request deadline expired before admission"))
                    continue
                try:
                    key = self._prefix_hit(req)
                    prefix_pages: Tuple[int, ...] = ()
                    if self.page_index is not None and key is not None:
                        prefix_pages = key.path_pages
                    long_req = bool(self.prefill_chunk) and (
                        len(req.prompt_ids) - len(prefix_pages) * self.page_size
                        > 2 * self.prefill_chunk
                    )
                    if group and (key is not group_key or long_req):
                        break  # the next selection takes it
                    idx = free[len(group)]
                    if self.alloc is not None:
                        # Clamped to slot capacity: decode stops at a full
                        # context anyway, and an unclamped need could never
                        # be met and would stall the FIFO head for good.
                        need = min(len(req.prompt_ids) + req.max_new_tokens, self.max_seq_len)
                        if not self._reserve_pages(idx, need, prefix_pages):
                            break  # the head waits for pages; folds free them
                except Exception as exc:  # noqa: BLE001 — a failed restore or spill
                    # fails this request, visibly; the prep thread lives on.
                    self._backlog.popleft()
                    req.future.set_exception(exc)
                    failed = exc
                    break
                self._backlog.popleft()
                self._prep_reserved.add(idx)
                if long_req:
                    seg = [idx, req, len(prefix_pages) * self.page_size]
                    break
                group_key = key
                group.append((idx, req))
        if failed is not None:
            _log.error("prefix lookup failed: %s", failed, exc_info=failed)
            if sticky_device_error(failed):
                self._declare_dead(failed, "sticky CUDA error")
        return group, group_key, seg

    def _reserve_pages(self, idx: int, need: int, prefix_pages: Sequence[int]) -> bool:
        """Allocate slot ``idx``'s pages (lock held), mapping ``prefix_pages``
        at the head; when the pool is short, first unpin cached pages that
        only the index holds, never the chain about to be mapped, so
        caching never starves admission."""
        if self.alloc.allocate(idx, need, prefix_pages=prefix_pages):
            return True
        short = self.alloc.pages_needed(need) - len(prefix_pages) - self.alloc.free_pages
        return (self.page_index is not None and short > 0
                and self.page_index.evict(short, self.alloc,
                                          protect=frozenset(prefix_pages)) > 0
                and self.alloc.allocate(idx, need, prefix_pages=prefix_pages))

    def _meta(self, group: List[Tuple[int, GenRequest]]):
        mi, mf = pack_admit_meta(len(group), pad_slot=self.n_slots)
        for row, (idx, req) in enumerate(group):
            mi[AI_SLOT, row] = idx
            mi[AI_TOPK, row] = req.top_k
            mi[AI_SEED, row] = req.seed
            mi[AI_EOS, row] = req.eos_id
            mi[AI_BUDGET, row] = req.max_new_tokens - 1
            mi[AI_JSON, row] = int(req.json_mode)
            mi[AI_LEN, row] = len(req.prompt_ids)
            mf[AF_TEMP, row] = req.temperature
            mf[AF_TOPP, row] = req.top_p
        return mi, mf

    def _prepare(self, group: List[Tuple[int, GenRequest]], key: Any = None) -> _Prepared:
        """Pack a group: the whole prompts for a cold group, the tails past
        the cached prefix ``key`` (a page chain or a store entry) for a
        hit."""
        mi, mf = self._meta(group)
        rows = self._page_rows([idx for idx, _ in group]) if self.alloc is not None else None
        if key is None:
            tokens = np.zeros((len(group), self._bucket(max(len(r.prompt_ids) for _, r in group))),
                              np.int64)
            for row, (_, req) in enumerate(group):
                tokens[row, : len(req.prompt_ids)] = req.prompt_ids
            return _Prepared(group=group, tokens=tokens, meta_i32=mi, meta_f32=mf,
                             page_rows=rows)
        if self.page_index is not None:
            plen = key.depth * self.page_size
            hit = dict(kind="prefix_paged", chain=np.asarray(key.path_pages, np.int32))
        else:
            plen = len(key.ids)
            hit = dict(kind="prefix", entry=key)
        return _Prepared(group=group, tokens=self._tails(group, plen, mi), meta_i32=mi,
                         meta_f32=mf, page_rows=rows, prefix_len=plen, **hit)

    def _tails(self, group: List[Tuple[int, GenRequest]], plen: int, mi: np.ndarray
               ) -> np.ndarray:
        """The group's prompt tails past ``plen``, right-padded to their
        tail bucket; ``AI_LEN`` becomes the tail lengths and ``AI_PLEN``
        the prefix length."""
        tails = [req.prompt_ids[plen:] for _, req in group]
        tokens = np.zeros((len(group), self._tail_bucket(max(len(t) for t in tails))), np.int64)
        for row, tail in enumerate(tails):
            tokens[row, : len(tail)] = tail
            mi[AI_LEN, row] = len(tail)
        mi[AI_PLEN] = plen
        return tokens

    def _page_rows(self, slots: List[int]) -> np.ndarray:
        """The slots' block-table rows, copied under the lock."""
        with self._lock:
            return self.alloc.table[slots].copy()

    def _chain(self, idx: int, done: int) -> np.ndarray:
        """The pages holding slot ``idx``'s first ``done`` (page-aligned)
        tokens, copied under the lock."""
        with self._lock:
            return self.alloc.table[idx, : done // self.page_size].copy()

    def _end_segmentation(self) -> None:
        self._segmenting = None
        self._seg_pending = False
        self._prep_wake.set()

    def _advance_segment(self) -> None:
        """Run one chunked-prefill segment of the segmenting request, or
        dispatch its final segment, which admits it. Its chain may hold
        freshly restored pages: pending restores are written first."""
        self._apply_restores()
        idx, req, done = self._segmenting
        expired = req.deadline is not None and time.monotonic() >= req.deadline
        if req.cancelled or req.future.done() or expired:
            # Abandoned by its caller, or past its deadline: return the slot
            # and the pages.
            with self._lock:
                self._prep_reserved.discard(idx)
                self._drop_slot_locked(idx)
            self._end_segmentation()
            if expired and not req.future.done():
                global_metrics.inc("engine.expired")
                req.future.set_exception(DeadlineExceeded("request deadline expired mid-prefill"))
            return
        if len(req.prompt_ids) - done > self.prefill_chunk:
            seg = self.prefill_chunk
            tokens = np.asarray([req.prompt_ids[done: done + seg]], np.int64)
            try:
                self.cache = extend_prompt_paged(
                    self.params, self.cfg, self.cache, self._chain(idx, done), done, tokens,
                    [seg], self._page_rows([idx]),
                )
            except Exception as exc:  # noqa: BLE001 — contain to this request
                # No token exists yet: the request re-admits from scratch
                # (its slot stays reserved until then, so the prep thread,
                # woken by the end of segmentation, cannot take it early).
                self._prefill_failed([(idx, req)], exc)
                self._end_segmentation()
                return
            self.prefill_segments += 1
            if not self._warming:
                global_metrics.inc("engine.prefill_tokens", seg)
            self._segmenting[2] = done + seg
            self._beat()                      # segment landed: progress
            return
        mi, mf = self._meta([(idx, req)])
        tokens = self._tails([(idx, req)], done, mi)
        prep = _Prepared(group=[(idx, req)], tokens=tokens, meta_i32=mi, meta_f32=mf,
                         page_rows=self._page_rows([idx]), kind="prefix_paged",
                         prefix_len=done, chain=self._chain(idx, done), segmented=True)
        self._end_segmentation()
        self._dispatch_prefill(prep)

    # ------------------------------------------------------------------ #
    # Reader thread
    # ------------------------------------------------------------------ #

    def _read_loop(self) -> None:
        while True:
            try:
                item = self._results.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    break
                continue
            try:
                if item is None:
                    with self._lock:
                        self._drain_queued = False
                    self._fold_first_reads()
                else:
                    try:
                        self._process_chunk(*item)
                    finally:
                        # Folded or lost, the chunk has left the pipeline.
                        with self._lock:
                            self.blocks_folded += item[2]
            except Exception as exc:  # noqa: BLE001 — reader boundary
                # The chunk's tokens are lost on the host while the device
                # spent their budget: the occupants recover, and the device
                # thread rebuilds the state a failed copy makes suspect.
                # The request comes first, so the device thread sees it
                # before it can re-admit anyone.
                _log.error("reader error: %s", exc, exc_info=True)
                if sticky_device_error(exc):
                    self._declare_dead(exc, "sticky CUDA error")
                else:
                    self._rebuild_requested = "reader_error"
                    self._fail_occupied_slots(exc)
            self._wake.set()

    def _fold_first_reads(self) -> None:
        """Fold the admissions' first tokens (their copies started at
        dispatch). Entries carry the slot's generation, so a stale one can
        never feed the slot's next occupant. A first token outside the
        vocab poisons only its slot."""
        with self._lock:
            groups, self._first_reads = self._first_reads, []
        hosts = [copy.wait()[0] for _, copy in groups]
        now = time.perf_counter()
        emits: List[Tuple[Any, List[int]]] = []
        poisoned: List[Tuple[int, GenRequest]] = []
        with self._lock:
            for (stamps, _), host in zip(groups, hosts):
                for row, (idx, gen) in enumerate(stamps):
                    slot = self._slots[idx]
                    if slot is None or not slot.first_pending or gen != self._gen[idx]:
                        continue
                    slot.first_pending = False
                    tok = int(host[row])
                    if not 0 <= tok < self.cfg.vocab_size:
                        poisoned.append(self._poison_slot_locked(idx, [tok]))
                        continue
                    req = slot.request
                    if req.first_token_at is None:    # a recovered one's came before
                        req.first_token_at = now
                    slot.generated.append(tok)
                    if req.on_tokens is not None and tok != req.eos_id:
                        emits.append((req.on_tokens, [tok]))
                    self._check_finished(idx)
        self._report_poisoned(poisoned)
        self._fire_stream(emits)
        if groups:
            self._beat()

    def _process_chunk(self, copy: _HostCopy, stamp: Tuple[int, ...], n_blocks: int,
                       est: float, hi: int, t_dispatch: float) -> None:
        """Fold one chunk into its slots once its copy has landed. First
        tokens sampled before the chunk ran fold first. Under speculation
        the rows come block-major (``[n·D, B]``); the acceptance EMAs move
        here, the per-slot ones under the lock and behind the generation
        stamp, so a late chunk never changes a new occupant's mode."""
        self._fold_first_reads()
        toks_h, valid_h = copy.wait()
        # Fault point: out-of-vocab ids in one slot's tokens (value= the
        # slot, or True for the first slot that emitted), as NaN logits or
        # corrupted device memory would show at the fold.
        corrupt = global_injector.fire("engine.fold.corrupt")
        if corrupt is not None and toks_h.size:
            toks_h = toks_h.copy()
            if isinstance(corrupt, bool) or not isinstance(corrupt, int):
                cols = np.flatnonzero(valid_h.any(axis=0))
                corrupt = int(cols[0]) if cols.size else 0
            toks_h[:, corrupt] = self.cfg.vocab_size + 7
        bad_valid = ((toks_h < 0) | (toks_h >= self.cfg.vocab_size)) & valid_h
        any_bad = bool(bad_valid.any())
        emits: List[Tuple[Any, List[int]]] = []
        poisoned: List[Tuple[int, GenRequest]] = []
        D = self.speculate or 1
        blk_any = valid_h.reshape(n_blocks, D, -1).any(axis=1)      # [n_blocks, B]
        slot_blocks = blk_any.sum(axis=0)
        slot_tokens = valid_h.sum(axis=0)
        with self._lock:
            for b, slot in enumerate(self._slots):
                if slot is None or stamp[b] != self._gen[b]:
                    continue
                if self.draft_layers and slot_blocks[b]:
                    # Thresholds scale with D; hysteresis keeps a slot from
                    # flapping between the two draft sources.
                    self._slot_rate[b] = (0.5 * self._slot_rate[b]
                                          + 0.5 * slot_tokens[b] / slot_blocks[b])
                    enter = 1.0 + 0.125 * D
                    if not self._draft_on[b] and self._slot_rate[b] < enter:
                        self._draft_on[b] = True
                    elif self._draft_on[b] and self._slot_rate[b] > enter + 0.25 * D:
                        self._draft_on[b] = False
                # This chunk leaves the in-flight ledger, tokens or not.
                slot.est_pending = max(0.0, slot.est_pending - est)
                slot.hi_pending = max(0, slot.hi_pending - hi)
                if slot.first_pending:
                    continue
                if any_bad and bad_valid[:, b].any():
                    # Only this slot's request fails; the engine and the
                    # other occupants keep serving.
                    poisoned.append(self._poison_slot_locked(
                        b, [int(t) for t in toks_h[bad_valid[:, b], b]]))
                    continue
                req = slot.request
                new_tokens = [int(t) for t, ok in zip(toks_h[:, b], valid_h[:, b]) if ok]
                if not new_tokens:
                    self._check_finished(b)
                fresh = []
                for tok in new_tokens:
                    slot.generated.append(tok)
                    if tok != req.eos_id:
                        fresh.append(tok)
                    if self._check_finished(b):
                        break
                if fresh and req.on_tokens is not None:
                    emits.append((req.on_tokens, fresh))
            self.blocks_useful += int(blk_any.any(axis=1).sum())
            if self.speculate:
                # Tokens a block over the (block, slot) pairs that emitted:
                # done slots and trailing empty blocks would drag the EMA
                # towards 1 and bring back the wasted passes it avoids.
                active_blocks = int(blk_any.sum())
                accepted = int(valid_h.sum())
                self.spec_tokens += accepted
                self.spec_blocks += active_blocks
                if active_blocks:
                    obs = min(max(accepted / active_blocks, 0.5), float(D))
                    self._spec_rate = 0.5 * self._spec_rate + 0.5 * obs
            # Wall seconds a block (dispatch to fold), the deadline cap of
            # the chunk pick; pipelining makes it a mild overestimate.
            per_block = (time.perf_counter() - t_dispatch) / max(n_blocks, 1)
            if 0.0 < per_block < 5.0:
                self._block_seconds = (0.5 * self._block_seconds + 0.5 * per_block
                                       if self._block_seconds else per_block)
        self._report_poisoned(poisoned)
        self._fire_stream(emits)
        self._beat()                          # a fold landed: progress

    def _check_finished(self, idx: int) -> bool:
        """Apply the completion rules to a slot (lock held); a finished
        slot resolves its future and is released, its pages at once."""
        slot = self._slots[idx]
        req = slot.request
        out = slot.generated
        eos = bool(out) and out[-1] == req.eos_id
        finished = (
            req.cancelled or req.future.cancelled() or eos
            or len(out) >= req.max_new_tokens
            or slot.prompt_len + len(out) >= self.max_seq_len - 1
        )
        if not finished:
            return False
        self._drop_slot_locked(idx)
        if eos:
            out = out[:-1]
        # A recovered request's result is what it had before the fault
        # plus this admission's: the stream it already emitted, continued.
        out = req.recovered_tokens + out
        now = time.perf_counter()
        self.completed.append({
            "prompt_tokens": slot.prompt_len - len(req.recovered_tokens),
            "tokens": len(out),
            "ttft_s": (req.first_token_at or now) - req.submitted_at,
            "e2e_s": now - req.submitted_at,
        })
        global_metrics.inc("engine.completed")
        global_metrics.inc("engine.generated_tokens", len(out))
        if req.trace_id is not None:
            global_tracer.emit("engine.batch_decode", trace_id=req.trace_id,
                               start=req.submitted_at, end=now, slot=idx,
                               prompt_len=slot.prompt_len, tokens=len(out))
        if not req.future.done():
            req.future.set_result(out)
            if req.recovery_attempts:
                global_metrics.inc("engine.recovered_requests")
        return True

    def _poison_slot_locked(self, idx: int, bad_ids: List[int]) -> Tuple[int, GenRequest]:
        """Contain a poisoned fold to its request (lock held): the slot is
        released and the future fails with ``PoisonedOutput``; the engine
        and the other occupants serve on. Not recovered: decoding the same
        state again would give the same poison (the handler's retry gives
        the request a fresh attempt)."""
        req = self._slots[idx].request
        self._drop_slot_locked(idx)
        self._gen[idx] += 1
        if not req.future.done():
            req.future.set_exception(PoisonedOutput(
                f"decode fold produced out-of-vocab token id(s) {bad_ids[:4]} (vocab "
                f"{self.cfg.vocab_size}, slot {idx}); failing this request only"))
        global_metrics.inc("engine.poisoned")
        return idx, req

    def _report_poisoned(self, poisoned: List[Tuple[int, GenRequest]]) -> None:
        """Each poisoned fold is a fault on the degrade ladder (outside the
        lock)."""
        for _ in poisoned:
            self.degrade.record_fault("poison")

    def _fire_stream(self, emits: List[Tuple[Any, List[int]]]) -> None:
        """Streaming callbacks, outside the lock (user code: a slow one must
        not stall the folds)."""
        for cb, ids in emits:
            try:
                cb(ids)
            except Exception as exc:  # noqa: BLE001 — the consumer's problem
                _log.warning("stream callback failed: %s", exc)

    # ------------------------------------------------------------------ #
    # Releases and failures (any thread)
    # ------------------------------------------------------------------ #

    def _drop_slot_locked(self, idx: int) -> None:
        """Free a slot on the host (lock held): its pages return now, its
        device state stops at the device thread's next cycle."""
        self._slots[idx] = None
        self._release.append(idx)
        if self.alloc is not None:
            self.alloc.release(idx)
        self._wake.set()
        self._prep_wake.set()

    def _fail_group(self, group: Sequence[Tuple[int, GenRequest]], exc: Exception,
                    recover: bool = False) -> None:
        """Fail one admission group's requests and return their slots and
        pages. With ``recover`` (a failed prefill: a device fault, not the
        client's) each request re-admits at the backlog's head instead,
        within its strikes: it has no token yet, so it is admitted again
        as it was."""
        now, t_snap = time.monotonic(), time.perf_counter()
        requeue: List[GenRequest] = []
        with self._lock:
            for idx, req in group:
                self._prep_reserved.discard(idx)
                slot = self._slots[idx]
                if slot is None or slot.request is req:
                    self._drop_slot_locked(idx)
                if req.future.done():
                    continue
                if not recover:
                    req.future.set_exception(exc)
                elif self._recovery_decision_locked(req, exc, now, t_snap):
                    requeue.append(req)
            self._backlog.extendleft(reversed(requeue))
        if requeue:
            global_metrics.inc("engine.recovery_requeued", len(requeue))

    # ------------------------------------------------------------------ #
    # The fault domain: deadlines, recovery, the rebuild, the watchdog
    # ------------------------------------------------------------------ #

    def _expire_deadlines(self) -> None:
        """Release the occupied slots whose deadline passed mid-decode
        (device thread, every cycle): the slot frees now, its device side
        at the next release, and the generation stamp keeps a chunk in
        flight from folding into it; the future fails with
        ``DeadlineExceeded``."""
        now = time.monotonic()
        expired: List[Tuple[int, _Slot]] = []
        with self._lock:
            for i, slot in enumerate(self._slots):
                req = slot.request if slot is not None else None
                if req is None or req.deadline is None or now < req.deadline:
                    continue
                self._drop_slot_locked(i)
                self._gen[i] += 1
                global_metrics.inc("engine.expired")
                global_metrics.inc("engine.deadline_releases")
                expired.append((i, slot))
                if not req.future.done():
                    req.future.set_exception(DeadlineExceeded(
                        f"request deadline expired after {len(slot.generated)} generated "
                        f"token(s)"))
        for i, slot in expired:
            req = slot.request
            if req.trace_id is not None:
                global_tracer.emit("engine.batch_decode", trace_id=req.trace_id,
                                   start=req.submitted_at, end=time.perf_counter(), slot=i,
                                   prompt_len=slot.prompt_len, tokens=len(slot.generated),
                                   status="deadline")

    def _recoverable(self, req: GenRequest, now: float) -> bool:
        """May this request re-admit instead of failing? (lock held)"""
        return (self.recovery_max_attempts > 0
                and req.recovery_attempts < self.recovery_max_attempts
                and not req.cancelled and not req.future.cancelled()
                and (req.deadline is None or now < req.deadline))

    def _recovery_decision_locked(self, req: GenRequest, exc: Exception, now: float,
                                  t_snap: float) -> bool:
        """The one requeue-or-fail rule of every failure arm (lock held).
        True: the request re-admits (a strike spent, the snapshot time
        stamped); the caller puts it at the backlog's head. False: its
        future failed with ``exc``."""
        if self._recoverable(req, now):
            req.recovery_attempts += 1
            req.recovery_started_at = t_snap
            return True
        if self.recovery_max_attempts > 0 and req.recovery_attempts >= self.recovery_max_attempts:
            global_metrics.inc("engine.recovery_failed")
        req.future.set_exception(exc)
        return False

    def _fail_occupied_slots(self, exc: Exception, record_fault: bool = True,
                             allow_recovery: bool = True) -> None:
        """Contain a device or transfer failure to the engine, not its
        requests (any thread). Each occupant's progress is snapshotted and
        re-admitted at the backlog's head through the normal admission
        path: its prompt plus the tokens it had, so greedy output is the
        uninterrupted run's and a stream resumes at the next new token
        (``recovered_tokens`` are never emitted again). Strikes are bounded
        per request (``recovery_max_attempts``, then the original
        exception). Cancelled and expired requests fail. The JSON rule: a
        JSON request that streamed fails (the grammar's state follows the
        position after the prompt, so a spliced replay cannot be
        constrained, nor can a seen stream restart), one that did not
        restarts from its prompt. ``allow_recovery=False`` fails every
        occupant with ``exc``."""
        now, t_snap = time.monotonic(), time.perf_counter()
        recovered: List[GenRequest] = []
        failed = 0
        with self._lock:
            for i, slot in enumerate(self._slots):
                if slot is None:
                    continue
                self._drop_slot_locked(i)
                self._gen[i] += 1
                req = slot.request
                if req.future.done():
                    continue
                replay = list(slot.generated)
                if not allow_recovery or (req.json_mode and replay and req.on_tokens is not None):
                    req.future.set_exception(exc)
                    failed += 1
                    continue
                if not self._recovery_decision_locked(req, exc, now, t_snap):
                    failed += 1
                    continue
                if req.json_mode:
                    replay = []                # restart from the prompt
                if not replay:
                    # Its tokens, if any, are discarded: its first comes anew.
                    req.first_token_at = None
                if replay:
                    # A new list: callers hold the original prompt.
                    req.prompt_ids = req.prompt_ids + replay
                    req.recovered_tokens.extend(replay)
                    req.max_new_tokens -= len(replay)
                    global_metrics.inc("engine.tokens_replayed", len(replay))
                recovered.append(req)
            self._first_reads.clear()
            # In submission order at the head: they were admitted earliest.
            self._backlog.extendleft(reversed(recovered))
        if recovered or failed:
            global_metrics.inc("engine.recovery_requeued", len(recovered))
            _log.warning("engine failure (%s): %d in-flight request(s) requeued for recovery, "
                         "%d failed", exc, len(recovered), failed)
        if record_fault:
            self.degrade.record_fault("device")
        self._prep_wake.set()
        self._wake.set()

    def _declare_dead(self, exc: BaseException, reason: str) -> None:
        """Nothing can be recovered in the process (a sticky CUDA error, or
        rebuilds that kept failing): fail the occupants with the original
        exception and mark this engine stalled on ``global_engine_health``,
        which force-opens the subscribed breakers, until ``stop()``. No
        rebuild is tried."""
        global_engine_health.mark_stalled(reason=f"{reason}: {exc}", source=self.health_source)
        self._fail_occupied_slots(exc, allow_recovery=False)

    def _rebuild_device_state(self, reason: str) -> None:
        """Reset the device state after a failure, in place (device thread,
        on its stream; the failure arm has swept the occupants first). The
        captured chunk graphs read the cache (panels or pools, their int8
        scales), the decode and sampling states, the block table, the
        draft-mode vector and the history by address, so each is filled as
        it was made, and nothing a graph holds is allocated again or
        captured: every graph stays valid. On the host: staged admissions
        and a segmenting prompt go back to the backlog's head, a fresh page
        allocator, the page index and the dense prefix store emptied (their
        contents lived in, or came from, the suspect state), every slot's
        generation bumped, so chunks in flight fold into nothing. The JAX
        batcher allocates fresh state here instead
        (``pilottai_tpu/engine/batcher.py:_rebuild_device_state``)."""
        # Fault point: a rebuild that itself fails (retried, bounded).
        global_injector.fire("engine.rebuild", reason=reason)
        t0 = time.perf_counter()
        with self._prep_gate:
            staged = []
            while True:
                try:
                    staged.append(self._prepped.get_nowait())
                except queue.Empty:
                    break
            with self._lock:
                if self._segmenting is not None:
                    staged.insert(0, _SegmentStart(self._segmenting))
                    self._segmenting = None
                self._requeue_locked(staged)
                self._prepped_reqs = 0
                self._seg_pending = False
                self._prep_reserved.clear()
                self._first_reads.clear()
                self._gen = [g + 1 for g in self._gen]
                # Every restore staged so far targets the old allocator's
                # pages: its epoch is now stale, and ``_apply_restores``
                # below unwinds it.
                self._alloc_epoch += 1
                if self.alloc is not None:
                    self.alloc = PageAllocator(self.num_pages, self.page_size, self.n_slots,
                                               self.alloc.table.shape[1])
                if self.page_index is not None:
                    self.page_index.clear()
                if self.prefix_store is not None:
                    # clear(), not eviction: no spill copies out of the
                    # state this rebuild distrusts (the JAX engine's rule
                    # for its mesh rebuild). The host tier's entries stay.
                    self.prefix_store.clear()
        events = None
        if self.stream is not None:
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        reset_cache(self.cache)
        reset_decode(self.dstate)
        reset_sampling(self.sampling)
        for t in (self.history, self.runner.draft_mode):
            if t is not None:
                t.zero_()
        if self.runner.table is not None:
            self.runner.table.fill_(self.num_pages - 1)
        if events is not None:
            events[1].record()
        # Staged restores unwind now: nothing is written, their host entries
        # go back to the tier for the re-admissions to restore again.
        self._apply_restores()
        self._last_rebuild = (time.perf_counter() - t0, *(events or (None, None)))
        global_metrics.inc("engine.rebuilds")
        global_metrics.inc(f"engine.rebuilds.{reason}")
        _log.warning("device state rebuilt in place (reason=%s)", reason)
        self._beat()        # the rebuild is progress: re-admissions must not race the watchdog
        self._prep_wake.set()
        self._wake.set()

    def _beat(self) -> None:
        """Progress heartbeat (folds, prefills, segments, rebuilds)."""
        if self._watchdog is not None:
            self._watchdog.beat()

    def _watchdog_has_work(self) -> bool:
        """Anything in flight or queued? (watchdog thread; a lock-free
        approximation.) The warm-up sweep never trips the watchdog: its
        captures stall the heartbeats for legitimate minutes."""
        if self._warming:
            return False
        return (self.blocks_dispatched != self.blocks_folded
                or any(s is not None for s in self._slots)
                or bool(self._backlog) or self._pending.qsize() > 0
                or self._segmenting is not None or bool(self._prep_reserved)
                or self._prepped_reqs > 0)

    def _on_watchdog_stall(self, info: Dict[str, Any]) -> None:
        """A stall counts as a fault on the degrade ladder (watchdog thread)."""
        self.degrade.record_fault("stall")


def sticky_device_error(exc: BaseException) -> bool:
    """Does this error leave the CUDA context unusable (``STICKY_CUDA_ERRORS``
    in its message or its cause's)? Such a fault cannot be recovered in
    the process: the batcher fails the occupants and marks the engine
    stalled instead of rebuilding. Injected and host faults re-admit. The
    JAX package classifies device errors per shard for its mesh
    (``pilottai_tpu/parallel/meshplan.py:classify_device_error``); this is
    the one-card counterpart."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        text = str(exc).lower()
        if any(s in text for s in STICKY_CUDA_ERRORS):
            return True
        exc = exc.__cause__ or exc.__context__
    return False
