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

Retries, rate limits, deadlines and the reliability ladder (ROADMAP P6b)
and the scheduling policies (P6c) are not here; a failed dispatch fails
its requests (the JAX batcher re-admits them).
"""

from __future__ import annotations

import collections
import contextlib
import logging
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
)
from pilottai_tpu_torch.engine.graphs import ChunkRunner
from pilottai_tpu_torch.engine.kvcache.index import KVCacheIndex
from pilottai_tpu_torch.engine.page_prefix import PagePrefixIndex
from pilottai_tpu_torch.engine.prefix_cache import PrefixStore
from pilottai_tpu_torch.engine.sampling import SamplingState
from pilottai_tpu_torch.models.common import ModelConfig
from pilottai_tpu_torch.ops.kernels.paged_attention import check_kernel_shapes
from pilottai_tpu_torch.ops.kvcache import KVCache, free_slots
from pilottai_tpu_torch.ops.paged import PageAllocator, PagedKVCache

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

_log = logging.getLogger("pilottai_tpu_torch.engine.batcher")


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
    # The prefix lookup counted this request (a head that waits for pages
    # is looked up again at every selection, and counted once).
    kv_counted: bool = False


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
    ) -> None:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.cfg = cfg
        self.params = params
        self.device = device
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
                cfg.head_dim, dtype=cfg.dtype, device=device,
            )
        else:
            self.cache = KVCache.create(
                cfg.n_layers, n_slots, max_seq_len, cfg.n_kv_heads, cfg.head_dim,
                dtype=cfg.dtype, device=device,
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
                    policy="cost",
                )
            self.kvcache = KVCacheIndex(prefix_store=self.prefix_store,
                                        page_index=self.page_index)
        #: Requests admitted by a tail prefill against a cached prefix (a
        #: chunked prefill's final segment over its own chain is not one;
        #: nor is a hit whose rest was long enough to segment), the prompt
        #: tokens their prefixes saved, and dense exports that failed.
        self.prefix_admitted = 0
        self.prefix_tokens_saved = 0
        self.prefix_export_failures = 0
        self._warned_min_len = False
        #: Decode steps dispatched, and those in which some slot emitted
        #: (their ratio is the chunk utilization the adaptive policy raises).
        self.blocks_dispatched = 0
        self.blocks_useful = 0
        self.dstate = DecodeState.create(n_slots, device)
        self.sampling = SamplingState.create(n_slots, device)
        self.runner = ChunkRunner(
            params, cfg, self.cache, self.dstate, self.sampling, device,
            max_pages=self.alloc.table.shape[1] if self.alloc is not None else None,
        )
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
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

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._prep_wake.set()
        for t in self._threads:
            t.join(timeout=60)
        self._threads = []
        if self.device.type == "cuda":
            # Chunks dispatched just before the stop may still run.
            torch.cuda.synchronize(self.device)
        err = RuntimeError("engine stopped")
        self._drain_pending()
        while True:
            try:
                item = self._prepped.get_nowait()
            except queue.Empty:
                break
            pairs = [tuple(item.seg[:2])] if isinstance(item, _SegmentStart) else item.group
            self._fail_group(pairs, err)
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

    def submit(self, request: GenRequest) -> Future:
        """Queue a request (any thread). Prompts longer than the keep
        window are left-truncated, as the JAX batcher does."""
        if self._stop.is_set():
            raise RuntimeError("engine stopped")
        if not request.prompt_ids:
            request.prompt_ids = [0]
        keep = self.max_seq_len - 1 - request.max_new_tokens
        keep = min(max(keep, 1), self.max_seq_len - 2)
        if len(request.prompt_ids) > keep:
            request.prompt_ids = request.prompt_ids[-keep:]
        self._pending.put(request)
        self._wake.set()
        self._prep_wake.set()
        return request.future

    def graph_report(self) -> Dict[str, Any]:
        """The chunk graphs: how many were captured, the seconds capture
        took, and the bytes their shared memory pool holds (None where it
        is not known)."""
        return {"graphs": self.runner.graphs_captured,
                "capture_s": self.runner.capture_seconds,
                "pool_bytes": self.runner.pool_bytes()}

    @property
    def prefix_lookups(self) -> int:
        """Prefix-cache lookups, one per request."""
        return self.kvcache.lookups if self.kvcache is not None else 0

    @property
    def prefix_hits(self) -> int:
        """Lookups that found a usable cached prefix (an entry that fits, or
        a page chain)."""
        return self.kvcache.hits if self.kvcache is not None else 0

    def prefix_report(self) -> Dict[str, Any]:
        """The prefix cache: lookups (one per request), hits, requests
        admitted by a tail prefill against a cached prefix, the prompt
        tokens saved, failed exports, and the store's entries and bytes
        (dense) or the pinned pages (paged). Empty when the cache is off."""
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
        cached prefix rows."""
        if self.kvcache is None:
            return None
        count = not req.kv_counted
        req.kv_counted = True
        if self.page_index is not None:
            return self.kvcache.lookup_paged(req.prompt_ids, max_seq_len=self.max_seq_len,
                                             count=count)
        n = len(req.prompt_ids)

        def fits(plen: int, p_bucket: int) -> bool:
            return (plen + self._tail_bucket(n - plen) <= self.max_seq_len
                    and p_bucket <= self.max_seq_len)

        return self.kvcache.lookup_dense(req.prompt_ids, fits=fits, count=count)

    def _decode_bucket(self, n: int) -> int:
        """Prefix-bound rung of a paged chunk: the prompt ladder with a
        ``MIN_DECODE_BUCKET`` floor, so the graphs stay O(log S)."""
        return max(self._bucket(n), min(MIN_DECODE_BUCKET, self.max_seq_len))

    def _occupied(self) -> List[_Slot]:
        return [s for s in self._slots if s is not None]

    def _chunk_useful(self) -> bool:
        """Some occupied slot still has budget that its folded tokens and
        the chunks in flight do not cover (lock held)."""
        return any(
            max(0, len(s.generated) - 1) + s.est_pending < s.request.max_new_tokens - 1
            for s in self._occupied()
        )

    def _pick_chunk_blocks(self) -> int:
        """The next dispatch's steps (lock held). "fixed": ``chunk_size``.
        "adaptive": each live slot's remaining need (budget less what is
        folded and in flight), the mean of them, or the smallest while
        requests wait for a slot (a finishing slot's release then comes at
        the earliest chunk boundary); quantised up to the bucket ladder."""
        if self.chunk_policy != "adaptive":
            return self.chunk_size
        needs = []
        for s in self._occupied():
            rem = s.request.max_new_tokens - 1 - max(0, len(s.generated) - 1) - s.est_pending
            if rem > 0:
                needs.append(max(math.ceil(rem), 1))
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
                    self._apply_releases()
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
                    self._fail_all(exc)

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
        overlap). True when device work was issued."""
        if self._segmenting is not None:
            self._advance_segment()
            return True
        items: List[Any] = []
        if self.overlap_admission:
            while True:
                try:
                    items.append(self._prepped.get_nowait())
                except queue.Empty:
                    break
            if items:
                self._prep_wake.set()
        else:
            self._drain_pending()
            items = self._stage()
        for item in items:
            if isinstance(item, _SegmentStart):
                # Selection stops at a long prompt, so nothing follows it.
                self._segmenting = item.seg
                self._advance_segment()
            else:
                self._dispatch_prefill(item)
        return bool(items)

    def _dispatch_prefill(self, prep: _Prepared) -> None:
        """Install a staged group and enqueue its prefill; the first tokens'
        copy starts here and the reader folds it. A failed admission fails
        this group only and returns its slots and pages."""
        with self._lock:
            for idx, req in prep.group:
                self._slots[idx] = _Slot(request=req, prompt_len=len(req.prompt_ids))
                self._gen[idx] += 1
                self._prep_reserved.discard(idx)
            stamps = [(idx, self._gen[idx]) for idx, _ in prep.group]
        try:
            if prep.kind == "prefix_paged":
                self.cache, self.dstate, self.sampling, first = admit_group_prefix_paged(
                    self.params, self.cfg, self.cache, self.dstate, self.sampling, prep.chain,
                    prep.tokens, prep.page_rows, prep.meta_i32, prep.meta_f32,
                )
            elif prep.kind == "prefix":
                self.cache, self.dstate, self.sampling, first = admit_group_prefix(
                    self.params, self.cfg, self.cache, self.dstate, self.sampling,
                    prep.entry.ks, prep.entry.vs, prep.tokens, prep.meta_i32, prep.meta_f32,
                )
            else:
                self.cache, self.dstate, self.sampling, first = admit_group(
                    self.params, self.cfg, self.cache, self.dstate, self.sampling, prep.tokens,
                    prep.meta_i32, prep.meta_f32, page_rows=prep.page_rows,
                )
            copy = _HostCopy([first])
        except Exception as exc:  # noqa: BLE001 — contain to this group
            self._fail_group(prep.group, exc)
            return
        with self._lock:
            if prep.kind != "full" and not prep.segmented:
                self.prefix_admitted += len(prep.group)
                self.prefix_tokens_saved += prep.prefix_len * len(prep.group)
            # Pinned before the first token is published: until the reader
            # folds it, nothing can release these slots' pages.
            self._maybe_register(prep.group)
            self._first_reads.append((stamps, copy))
        if prep.kind == "full":
            self._maybe_export(prep.group)

    def _maybe_register(self, group: List[Tuple[int, GenRequest]]) -> None:
        """After a paged admission (cold, hit or a final segment), pin the
        pages each prompt fully covers into the index (lock held). Only
        blocks inside the prompt are immutable (decode writes start at
        ``prompt_len``); the partial last block stays private."""
        if self.page_index is None:
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
        if store is None:
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
        the reader."""
        with self._lock:
            if not self._chunk_useful():
                return
            n = self._pick_chunk_blocks()
            occupied = self._occupied()
            # The longest cache any live slot can hold at this chunk's
            # start: folded decode tokens plus all the chunks in flight can
            # add (the first token enters the cache with the first step).
            bound = max(
                s.prompt_len + min(max(0, len(s.generated) - 1) + s.hi_pending,
                                   s.request.max_new_tokens - 1)
                for s in occupied
            )
            for s in occupied:
                s.est_pending += n
                s.hi_pending += n
            fused = self.fused_epilogue and all(
                s.request.temperature <= 0.0 and not s.request.json_mode for s in occupied
            )
            stamp = tuple(self._gen)
            table = self.alloc.table.copy() if self.alloc is not None else None
        n_blocks = None
        if table is not None:
            n_blocks = min(-(-self._decode_bucket(bound) // self.page_size), table.shape[1])
        toks, valid = self.runner.run(n, fused, n_blocks, table)
        with self._lock:
            self.blocks_dispatched += n
        self._put_result((_HostCopy([toks, valid]), stamp, n))

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
                for item in self._stage():
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
        occupant."""
        group: List[Tuple[int, GenRequest]] = []
        group_key = None
        seg = None
        with self._lock:
            free = [i for i, s in enumerate(self._slots)
                    if s is None and i not in self._release and i not in self._prep_reserved]
            while self._backlog and len(group) < min(len(free), self.admit_batch):
                req = self._backlog[0]
                if req.cancelled or req.future.done():
                    self._backlog.popleft()
                    continue
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
                self._backlog.popleft()
                self._prep_reserved.add(idx)
                if long_req:
                    seg = [idx, req, len(prefix_pages) * self.page_size]
                    break
                group_key = key
                group.append((idx, req))
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
        dispatch its final segment, which admits it."""
        idx, req, done = self._segmenting
        if req.cancelled or req.future.done():
            # Abandoned by its caller: return the slot and the pages.
            with self._lock:
                self._prep_reserved.discard(idx)
                self._drop_slot_locked(idx)
            self._end_segmentation()
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
                self._fail_group([(idx, req)], exc)
                self._end_segmentation()
                return
            self.prefill_segments += 1
            self._segmenting[2] = done + seg
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
                    self._process_chunk(*item)
            except Exception as exc:  # noqa: BLE001 — reader boundary
                self._fail_all(exc)
            self._wake.set()

    def _fold_first_reads(self) -> None:
        """Fold the admissions' first tokens (their copies started at
        dispatch). Entries carry the slot's generation, so a stale one can
        never feed the slot's next occupant."""
        with self._lock:
            groups, self._first_reads = self._first_reads, []
        hosts = [copy.wait()[0] for _, copy in groups]
        now = time.perf_counter()
        with self._lock:
            for (stamps, _), host in zip(groups, hosts):
                for row, (idx, gen) in enumerate(stamps):
                    slot = self._slots[idx]
                    if slot is None or not slot.first_pending or gen != self._gen[idx]:
                        continue
                    slot.first_pending = False
                    slot.request.first_token_at = now
                    slot.generated.append(int(host[row]))
                    self._check_finished(idx)

    def _process_chunk(self, copy: _HostCopy, stamp: Tuple[int, ...], n_blocks: int) -> None:
        """Fold one chunk into its slots once its copy has landed. First
        tokens sampled before the chunk ran fold first."""
        self._fold_first_reads()
        toks_h, valid_h = copy.wait()
        with self._lock:
            for b, slot in enumerate(self._slots):
                if slot is None or stamp[b] != self._gen[b]:
                    continue
                # This chunk leaves the in-flight ledger, tokens or not.
                slot.est_pending = max(0.0, slot.est_pending - n_blocks)
                slot.hi_pending = max(0, slot.hi_pending - n_blocks)
                if slot.first_pending:
                    continue
                new_tokens = [int(t) for t, ok in zip(toks_h[:, b], valid_h[:, b]) if ok]
                if not new_tokens:
                    self._check_finished(b)
                for tok in new_tokens:
                    slot.generated.append(tok)
                    if self._check_finished(b):
                        break
            self.blocks_useful += int(valid_h.any(axis=1).sum())

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
        now = time.perf_counter()
        self.completed.append({
            "prompt_tokens": slot.prompt_len,
            "tokens": len(out),
            "ttft_s": (req.first_token_at or now) - req.submitted_at,
            "e2e_s": now - req.submitted_at,
        })
        if not req.future.done():
            req.future.set_result(out)
        return True

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

    def _fail_group(self, group: Sequence[Tuple[int, GenRequest]], exc: Exception) -> None:
        """Fail one admission group's requests and return their slots and
        pages."""
        with self._lock:
            for idx, req in group:
                self._prep_reserved.discard(idx)
                slot = self._slots[idx]
                if slot is None or slot.request is req:
                    self._drop_slot_locked(idx)
                if not req.future.done():
                    req.future.set_exception(exc)

    def _fail_all(self, exc: Exception) -> None:
        """A failed dispatch or fold fails every occupant (recovery is
        ROADMAP P6b)."""
        with self._lock:
            for i, slot in enumerate(self._slots):
                if slot is not None:
                    self._drop_slot_locked(i)
                    if not slot.request.future.done():
                        slot.request.future.set_exception(exc)
