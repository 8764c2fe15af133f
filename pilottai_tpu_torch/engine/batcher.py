"""A minimal continuous batcher (the port's counterpart of the core of
``pilottai_tpu/engine/batcher.py``).

Fixed slots, a FIFO backlog and one device thread that alternates
admission groups (``decode.admit_group``) with fixed-size decode chunks
(``decode.decode_chunk``), folds the tokens on the host, resolves each
request's future at EOS, budget or a full context, and frees its slot.
Overlapped admission, adaptive chunk sizes, in-flight recovery, the
watchdog and DAG ordering come with the full-batcher slice (ROADMAP P6).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from pilottai_tpu_torch.engine.decode import (
    AF_TEMP,
    AF_TOPP,
    AI_BUDGET,
    AI_EOS,
    AI_JSON,
    AI_LEN,
    AI_SEED,
    AI_SLOT,
    AI_TOPK,
    DecodeState,
    admit_group,
    decode_chunk,
    pack_admit_meta,
    release_decode,
)
from pilottai_tpu_torch.engine.sampling import SamplingState
from pilottai_tpu_torch.models.common import ModelConfig
from pilottai_tpu_torch.ops.kvcache import KVCache, free_slots

#: Smallest prompt bucket of an admission group (prompts pad up to a power
#: of two at least this long).
MIN_BUCKET = 64

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
    ) -> None:
        self.cfg = cfg
        self.params = params
        self.device = device
        self.n_slots = n_slots
        self.admit_batch = admit_batch
        self.max_seq_len = max_seq_len
        self.chunk_size = chunk_size
        self.cache = KVCache.create(
            cfg.n_layers, n_slots, max_seq_len, cfg.n_kv_heads, cfg.head_dim,
            dtype=cfg.dtype, device=device,
        )
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
        b = MIN_BUCKET
        while b < n:
            b *= 2
        return min(b, self.max_seq_len)

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

    def _admit(self) -> bool:
        free = [i for i, s in enumerate(self._slots) if s is None]
        group = []
        while self._backlog and len(group) < min(len(free), self.admit_batch):
            req = self._backlog.popleft()
            if req.cancelled or req.future.done():
                continue
            group.append((free[len(group)], req))
        if not group:
            return False
        A = len(group)
        T = self._bucket(max(len(r.prompt_ids) for _, r in group))
        tokens = np.zeros((A, T), np.int64)
        mi, mf = pack_admit_meta(A, pad_slot=self.n_slots)
        for row, (idx, req) in enumerate(group):
            tokens[row, : len(req.prompt_ids)] = req.prompt_ids
            mi[AI_SLOT, row] = idx
            mi[AI_TOPK, row] = req.top_k
            mi[AI_SEED, row] = req.seed
            mi[AI_EOS, row] = req.eos_id
            mi[AI_BUDGET, row] = req.max_new_tokens - 1
            mi[AI_JSON, row] = int(req.json_mode)
            mi[AI_LEN, row] = len(req.prompt_ids)
            mf[AF_TEMP, row] = req.temperature
            mf[AF_TOPP, row] = req.top_p
        for idx, req in group:
            self._slots[idx] = _Slot(request=req, prompt_len=len(req.prompt_ids))
        self.cache, self.dstate, self.sampling, first = admit_group(
            self.params, self.cfg, self.cache, self.dstate, self.sampling, tokens, mi, mf
        )
        first_host = first.cpu().numpy()
        now = time.perf_counter()
        for row, (idx, req) in enumerate(group):
            req.first_token_at = now
            self._fold(idx, [int(first_host[row])])
        return True

    def _decode(self) -> None:
        toks, valid, self.cache, self.dstate, self.sampling = decode_chunk(
            self.params, self.cfg, self.cache, self.dstate, self.sampling, self.chunk_size
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
