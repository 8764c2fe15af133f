"""A minimal continuous batcher (the port's counterpart of the core of
``pilottai_tpu/engine/batcher.py``).

Fixed slots, a FIFO backlog and one device thread that alternates
admission groups (``decode.admit_group``) with fixed-size decode chunks
(``decode.decode_chunk``), folds the tokens on the host, resolves each
request's future at EOS, budget or a full context, and frees its slot.

With ``paged=True`` the KV cache is a shared page pool
(``ops/paged.py``): a request reserves the pages of ``min(prompt +
max_new_tokens, max_seq)`` tokens when it is selected, the FIFO head
waits while the pool is short, and its pages return on finish, cancel or
failure. A prompt whose length passes ``2 × prefill_chunk`` admits in
segments: one ``extend_prompt_paged`` segment per device-loop cycle
while the live slots keep decoding between them, then the final segment
through ``admit_group_prefix_paged``. No other admission runs meanwhile,
so admission order holds.

Overlapped admission, adaptive chunk sizes, in-flight recovery (a failed
segmented prefill fails its request here; the JAX batcher re-admits it),
the watchdog and DAG ordering come with the full-batcher slice (ROADMAP
P6).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

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
    admit_group_prefix_paged,
    decode_chunk,
    extend_prompt_paged,
    pack_admit_meta,
    release_decode,
)
from pilottai_tpu_torch.engine.sampling import SamplingState
from pilottai_tpu_torch.models.common import ModelConfig
from pilottai_tpu_torch.ops.kernels.paged_attention import check_kernel_shapes
from pilottai_tpu_torch.ops.kvcache import KVCache, free_slots
from pilottai_tpu_torch.ops.paged import PageAllocator, PagedKVCache

#: Smallest prompt bucket of an admission group (prompts pad up to a power
#: of two at least this long).
MIN_BUCKET = 64
#: Smallest tail bucket of a prefix admission (the final segment of a
#: chunked prefill), so a short tail is not padded to a whole prompt bucket.
MIN_TAIL_BUCKET = 8

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
    # Set by the caller (any thread) to abandon the request; the device
    # loop frees its slot at the next fold.
    cancelled: bool = False


@dataclass
class _Slot:
    request: GenRequest
    prompt_len: int
    generated: List[int] = field(default_factory=list)


def _pow2_at_least(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


class ContinuousBatcher:
    """Slots, backlog and the device thread that serves them."""

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
    ) -> None:
        self.cfg = cfg
        self.params = params
        self.device = device
        self.n_slots = n_slots
        self.admit_batch = admit_batch
        self.max_seq_len = max_seq_len
        self.chunk_size = chunk_size
        self.paged = paged
        self.page_size = page_size
        self.alloc: Optional[PageAllocator] = None
        # Guards the allocator's free list and block table.
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
        #: Chunked-prefill segments run (``extend_prompt_paged`` calls).
        self.prefill_segments = 0
        self.dstate = DecodeState.create(n_slots, device)
        self.sampling = SamplingState.create(n_slots, device)
        self._slots: List[Optional[_Slot]] = [None] * n_slots
        self._backlog: Deque[GenRequest] = collections.deque()
        self._pending: "queue.Queue[GenRequest]" = queue.Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Completed requests' timings (host clock), newest last.
        self.completed: Deque[Dict[str, float]] = collections.deque(maxlen=4096)

    # ------------------------------------------------------------------ #

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="pilottai-torch-device-loop", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None
        err = RuntimeError("engine stopped")
        while True:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            self._backlog.append(req)
        if self._segmenting is not None:
            self._backlog.append(self._segmenting[1])
            self._end_segmentation(release=True)
        for req in self._backlog:
            if not req.future.done():
                req.future.set_exception(err)
        self._backlog.clear()
        for i, slot in enumerate(self._slots):
            if slot is not None and not slot.request.future.done():
                slot.request.future.set_exception(err)
            self._slots[i] = None

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
        return request.future

    # ------------------------------------------------------------------ #
    # Device thread
    # ------------------------------------------------------------------ #

    def _bucket(self, n: int) -> int:
        """Power-of-two prompt bucket with a ``MIN_BUCKET`` floor."""
        return min(_pow2_at_least(n, MIN_BUCKET), self.max_seq_len)

    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            try:
                while True:
                    try:
                        self._backlog.append(self._pending.get_nowait())
                    except queue.Empty:
                        break
                admitted = self._admit()
                if any(s is not None for s in self._slots):
                    self._decode()
                elif not admitted:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
            except Exception as exc:  # noqa: BLE001 — device loop boundary
                self._fail_all(exc)

    def _fail_all(self, exc: Exception) -> None:
        """A failed dispatch fails every occupant (recovery is ROADMAP P6)."""
        for i, slot in enumerate(self._slots):
            if slot is not None:
                if not slot.request.future.done():
                    slot.request.future.set_exception(exc)
                self._release(i)

    def _release(self, idx: int) -> None:
        self._slots[idx] = None
        release_decode(self.dstate, [idx])
        free_slots(self.cache, [idx])
        if self.alloc is not None:
            with self._lock:
                self.alloc.release(idx)

    def _admit(self) -> bool:
        """One admission step: advance a segmented prefill by one segment,
        or select and admit a group (and start a segmentation behind it).
        True when device work was issued."""
        if self._segmenting is not None:
            self._advance_segment()
            return True
        group, seg = self._select()
        if group:
            self._admit_group(group)
        if seg is not None:
            self._segmenting = seg
            self._advance_segment()
        return bool(group) or seg is not None

    def _select(self) -> Tuple[List[Tuple[int, GenRequest]], Optional[List[Any]]]:
        """FIFO selection of the next admission group; on the paged pool
        each member's pages are reserved here. A long prompt ends the
        group and is returned as the segmentation to start."""
        free = [i for i, s in enumerate(self._slots) if s is None]
        group: List[Tuple[int, GenRequest]] = []
        seg = None
        with self._lock:
            while self._backlog and len(group) < min(len(free), self.admit_batch):
                req = self._backlog[0]
                if req.cancelled or req.future.done():
                    self._backlog.popleft()
                    continue
                long_req = bool(self.prefill_chunk) and (
                    len(req.prompt_ids) > 2 * self.prefill_chunk
                )
                if group and long_req:
                    break  # the next cycle segments it
                idx = free[len(group)]
                if self.alloc is not None:
                    # Clamped to slot capacity: decode stops at a full
                    # context anyway, and an unclamped need could never
                    # be met and would stall the FIFO head for good.
                    need = min(len(req.prompt_ids) + req.max_new_tokens, self.max_seq_len)
                    if not self.alloc.allocate(idx, need):
                        break  # the head waits for pages; completions free them
                self._backlog.popleft()
                if long_req:
                    seg = [idx, req, 0]
                    break
                group.append((idx, req))
        return group, seg

    def _meta(self, group: List[Tuple[int, GenRequest]], rows: int):
        mi, mf = pack_admit_meta(rows, pad_slot=self.n_slots)
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

    def _page_rows(self, slots: List[int]) -> np.ndarray:
        """The slots' block-table rows, copied under the lock."""
        with self._lock:
            return self.alloc.table[slots].copy()

    def _chain(self, idx: int, done: int) -> np.ndarray:
        """The pages holding slot ``idx``'s first ``done`` (page-aligned)
        tokens, sentinel-padded to a power of two, copied under the lock."""
        k = done // self.page_size
        pages = np.full((_pow2_at_least(k, 1),), self.alloc.sentinel, np.int32)
        with self._lock:
            pages[:k] = self.alloc.table[idx, :k]
        return pages

    def _admit_group(self, group: List[Tuple[int, GenRequest]], prefix_len: int = 0) -> None:
        """Prefill and install a group. With ``prefix_len`` (the final
        segment of a chunked prefill) the group's first ``prefix_len``
        tokens already sit in its slots' leading pages. A failed admission
        fails this group only and returns its slots and pages."""
        A = len(group)
        mi, mf = self._meta(group, A)
        for idx, req in group:
            self._slots[idx] = _Slot(request=req, prompt_len=len(req.prompt_ids))
        try:
            if prefix_len:
                (idx, req), = group
                tail = req.prompt_ids[prefix_len:]
                tokens = np.zeros((1, _pow2_at_least(len(tail), MIN_TAIL_BUCKET)), np.int64)
                tokens[0, : len(tail)] = tail
                mi[AI_LEN, 0] = len(tail)
                mi[AI_PLEN] = prefix_len
                self.cache, self.dstate, self.sampling, first = admit_group_prefix_paged(
                    self.params, self.cfg, self.cache, self.dstate, self.sampling,
                    self._chain(idx, prefix_len), tokens, self._page_rows([idx]), mi, mf,
                )
            else:
                T = self._bucket(max(len(r.prompt_ids) for _, r in group))
                tokens = np.zeros((A, T), np.int64)
                for row, (_, req) in enumerate(group):
                    tokens[row, : len(req.prompt_ids)] = req.prompt_ids
                rows = (self._page_rows([idx for idx, _ in group])
                        if self.alloc is not None else None)
                self.cache, self.dstate, self.sampling, first = admit_group(
                    self.params, self.cfg, self.cache, self.dstate, self.sampling, tokens,
                    mi, mf, page_rows=rows,
                )
            first_host = first.cpu().numpy()
        except Exception as exc:  # noqa: BLE001 — contain to this group
            for idx, req in group:
                self._release(idx)
                if not req.future.done():
                    req.future.set_exception(exc)
            return
        now = time.perf_counter()
        for row, (idx, req) in enumerate(group):
            req.first_token_at = now
            self._fold(idx, [int(first_host[row])])

    def _end_segmentation(self, release: bool) -> None:
        idx = self._segmenting[0]
        self._segmenting = None
        if release:
            with self._lock:
                self.alloc.release(idx)

    def _advance_segment(self) -> None:
        """Run one chunked-prefill segment of the segmenting request, or
        its final segment, which admits it."""
        idx, req, done = self._segmenting
        if req.cancelled or req.future.done():
            self._end_segmentation(release=True)
            return
        try:
            if len(req.prompt_ids) - done > self.prefill_chunk:
                seg = self.prefill_chunk
                tokens = np.asarray([req.prompt_ids[done: done + seg]], np.int64)
                self.cache = extend_prompt_paged(
                    self.params, self.cfg, self.cache, self._chain(idx, done), done, tokens,
                    [seg], self._page_rows([idx]),
                )
                self.prefill_segments += 1
                self._segmenting[2] = done + seg
                return
        except Exception as exc:  # noqa: BLE001 — contain to this request
            self._end_segmentation(release=True)
            if not req.future.done():
                req.future.set_exception(exc)
            return
        self._end_segmentation(release=False)
        self._admit_group([(idx, req)], prefix_len=done)

    def _decode(self) -> None:
        table = n_blocks = None
        if self.alloc is not None:
            # The chunk's block table: a host copy taken under the lock,
            # uploaded before the first K3 launch (a blocking copy, so the
            # host buffer is free to change once it returns). K3 visits
            # the pages of the longest live prefix.
            with self._lock:
                table_np = self.alloc.table.copy()
            table = torch.from_numpy(table_np).to(self.device)
            longest = max(
                s.prompt_len + len(s.generated) - 1 for s in self._slots if s is not None
            )
            n_blocks = min(max(-(-longest // self.page_size), 1), table_np.shape[1])
        toks, valid, self.cache, self.dstate, self.sampling = decode_chunk(
            self.params, self.cfg, self.cache, self.dstate, self.sampling, self.chunk_size,
            table=table, n_blocks=n_blocks,
        )
        toks_h = toks.cpu().numpy()
        valid_h = valid.cpu().numpy()
        for b in range(self.n_slots):
            if self._slots[b] is None:
                continue
            self._fold(b, [int(t) for t, ok in zip(toks_h[:, b], valid_h[:, b]) if ok])

    def _fold(self, idx: int, new_tokens: List[int]) -> None:
        """Append a slot's new tokens one by one, finishing it at the
        first completion rule that fires."""
        slot = self._slots[idx]
        if not new_tokens:
            self._check_finished(idx)
        for tok in new_tokens:
            slot.generated.append(tok)
            if self._check_finished(idx):
                break

    def _check_finished(self, idx: int) -> bool:
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
        self._release(idx)
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
