"""Host-RAM tier for evicted KV (the port's own copy of
``pilottai_tpu/engine/kvcache/host_tier.py``).

The device-resident prefix caches hold a few entries: the dense store a
handful of panels, the paged index a quarter of the pool. Without this
tier an eviction drops the K/V, and a multi-turn session whose entry aged
out prefills its whole history again. Here an eviction spills instead:
the evicted panels or pages are copied to pinned host memory by a
non-blocking copy started at eviction time, and a later resume or
preamble hit restores them instead of computing the prefill again.

Eviction inside the tier is cost-aware (``policy="cost"``): recency times
the prefill saved per byte held, ``true_tokens / padded_rows`` for
token-keyed entries, so a tightly packed preamble outlives an equally old
entry that is mostly padding; ``"lru"`` is plain recency.

**Sessions** pin lineages: ``note_session`` records each session's latest
prompt, and entries on a live session's lineage are evicted only when
nothing unpinned is left (the tier never wedges). The session table is a
bounded LRU, so client-minted ids cannot grow host state without bound.

Entries are keyed by token-id prefix in a ``RadixTree`` (an O(len) match)
with an exact-key index. Everything here is host bookkeeping and copy
handles, so an engine-state rebuild leaves it untouched.

**The copy on the card** (``SpillCopy``). The JAX package starts
``copy_to_host_async`` and keeps the device arrays until the first
``wait()``. Here an event is recorded on the stream that wrote the source
(the engine's device stream) and the tier's spill thread does the rest
off the engine's threads: it allocates the pinned CPU tensors (a page
locking that takes milliseconds for a large entry), copies into them with
``non_blocking=True`` on a stream of its own behind that event, waits for
the copy, and seals the entry's CRC then, when the bytes have become
host-resident. The device tensors stay referenced until the copy has
landed, and are released then (``reap``, at every put and lookup), so a
spill frees its HBM whether or not anything ever restores it. ``wait()``
waits for that copy, never for the device. ``budget_bytes`` counts the
pinned bytes held.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pilottai_tpu_torch.engine.kvcache.integrity import (
    corrupt_arrays,
    entry_header,
    kv_checksum,
)
from pilottai_tpu_torch.engine.kvcache.policy import eviction_score, validate_policy
from pilottai_tpu_torch.engine.kvcache.radix import RadixTree
from pilottai_tpu_torch.reliability.inject import global_injector
from pilottai_tpu_torch.utils.metrics import global_metrics


def host_tensor(a: Any) -> torch.Tensor:
    """A host payload array as a CPU tensor (numpy arrays share their
    memory; a numpy bfloat16 array is read through its raw 16 bits)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if not a.flags["C_CONTIGUOUS"] or not a.flags["WRITEABLE"]:
        a = np.array(a, copy=True, order="C")
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _on(stream: Any):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


class SpillWorker:
    """The thread and the stream that spill copies run on, off the engine's
    threads: one a host tier, made at its first spill from the card."""

    def __init__(self, device: torch.device) -> None:
        self.stream = torch.cuda.Stream(device)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="pilottai-torch-spill")

    def submit(self, fn, *args):
        return self._pool.submit(fn, *args)


class SpillCopy:
    """The host copy of a spilled entry's device tensors, started when it is
    made and read only when a restore (or a test) asks.

    On CUDA the copy reads the source after everything queued so far on
    ``stream`` (the current stream if None) and after ``after`` (an event
    the source waits for, such as a restore's upload), into pinned tensors,
    bracketed by two timing events. With a ``worker`` the pinned
    allocation, the copy (on the worker's stream) and the wait for it run
    on the worker's thread, which then seals the digest; without one they
    run here, on ``stream``. ``landed()`` is true once the copy has run,
    and releases the device sources then; ``wait()`` waits for it. CPU
    tensors and numpy arrays are host data already and are held as they
    are.

    With ``integrity=True`` (the host tier's entries) a CRC-32 digest is
    sealed as soon as the bytes are host-resident (on the worker, or at the
    first ``wait()``), and ``verify()`` recomputes it at every restore, so
    rot between spill and restore is caught. The ``kvcache.spill.corrupt``
    fault point rots the bytes after the seal, at the first ``wait()``."""

    __slots__ = ("_src", "_host", "_start", "_event", "_job", "_digest", "_integrity",
                 "_read", "ms")

    def __init__(self, arrays, integrity: bool = False, stream: Any = None,
                 after: Any = None, worker: Optional[SpillWorker] = None) -> None:
        arrays = tuple(arrays)
        self._src: Tuple[Any, ...] = ()
        self._host: List[torch.Tensor] = []
        self._start = self._event = self._job = None
        self._digest: Optional[int] = None
        self._integrity = bool(integrity)
        self._read = False
        #: Device milliseconds of the copy, once it has landed (CUDA only).
        self.ms: Optional[float] = None
        if arrays and isinstance(arrays[0], torch.Tensor) and arrays[0].is_cuda:
            self._src = arrays            # held until the copy has landed
            if worker is None:
                self._copy(stream, (after,))
            else:
                written = torch.cuda.Event()
                with _on(stream):
                    written.record()
                self._job = worker.submit(self._spill, worker.stream, (written, after))
        else:
            self._host = [host_tensor(a) for a in arrays]

    def _copy(self, stream: Any, waits) -> None:
        host = [torch.empty(a.shape, dtype=a.dtype, pin_memory=True) for a in self._src]
        with _on(stream):
            cur = torch.cuda.current_stream()
            for ev in waits:
                if ev is not None:
                    cur.wait_event(ev)
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            for h, a in zip(host, self._src):
                h.copy_(a, non_blocking=True)
                # Read on this stream: a source freed early must outlive it.
                a.record_stream(cur)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        self._host, self._start, self._event = host, start, end

    def _spill(self, stream: Any, waits) -> None:
        """The worker's job: the copy, its wait, and the seal."""
        self._copy(stream, waits)
        self._event.synchronize()
        self._done()
        if self._integrity:
            self._digest = kv_checksum(self._host)

    def landed(self) -> bool:
        """Has the copy run? Releases the device sources when it has."""
        if self._job is not None:
            return self._job.done()
        if self._event is None:
            return True
        if self._src and not self._event.query():
            return False
        self._done()
        return True

    def _done(self) -> None:
        if self._src:
            self._src = ()
            self.ms = self._start.elapsed_time(self._event)

    def wait(self) -> List[torch.Tensor]:
        """The host tensors, once the copy has landed."""
        if self._job is not None:
            self._job.result()
        elif self._event is not None and self._src:
            self._event.synchronize()
            self._done()
        if self._integrity and self._digest is None:
            self._digest = kv_checksum(self._host)
        if self._integrity and not self._read:
            self._read = True
            # Fault point: the bytes rot in host RAM after the digest is
            # sealed, the window verify() exists to catch.
            if global_injector.fire("kvcache.spill.corrupt") is not None:
                self._host = [h.clone() for h in self._host]
                corrupt_arrays(self._host)
        return self._host

    def verify(self) -> bool:
        """The CRC over the current host bytes against the sealed digest."""
        host = self.wait()
        if self._digest is None:
            return True
        return kv_checksum(host) == self._digest


def _nbytes(arrays) -> int:
    total = 0
    for a in arrays:
        size = 1
        for d in a.shape:
            size *= int(d)
        item = a.element_size() if isinstance(a, torch.Tensor) else np.dtype(a.dtype).itemsize
        total += size * item
    return total


class HostEntry:
    """One spilled prefix: its token key, the host payload's copy and the
    eviction score's bookkeeping."""

    __slots__ = ("key", "copy", "nbytes", "tokens", "rows", "meta", "kind", "stamp", "header")

    def __init__(self, key, copy, nbytes, tokens, rows, meta, kind, header=None):
        self.key = key          # Tuple[int, ...], the covered prefix
        self.copy = copy        # SpillCopy
        self.nbytes = nbytes
        self.tokens = tokens    # true tokens the entry reconstructs
        self.rows = rows        # padded rows held (>= tokens)
        self.meta = meta        # dense: p_bucket; paged: the block index
        self.kind = kind        # "dense" | "page"
        self.stamp = 0
        # The layout frame (kvcache/integrity.py), sealed at put time from
        # the source's metadata; a restore checks the host bytes against it.
        self.header = header


class HostTier:
    """A bounded host-RAM store of spilled KV prefixes."""

    def __init__(self, budget_bytes: int, policy: str = "cost", max_sessions: int = 256,
                 stream: Any = None) -> None:
        self.budget_bytes = max(0, int(budget_bytes))
        self.policy = validate_policy(policy, "kvcache")
        #: The stream that writes the spilled tensors (the engine's device
        #: stream; None: the caller's current stream): a spill copy reads
        #: them after everything queued there so far.
        self.stream = stream
        self._worker: Optional[SpillWorker] = None
        self._tree = RadixTree()
        self._bytes = 0
        self._clock = 0
        # session id -> latest prompt (the lineage tip), a bounded LRU.
        self._sessions: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()
        self.max_sessions = max_sessions
        # Copies still holding their device sources, in stream order.
        self._inflight: Deque[SpillCopy] = deque()
        #: Bytes and device milliseconds of the spill copies that landed.
        self.d2h_bytes = 0
        self.d2h_ms = 0.0
        # The tier is fed from the device thread (dense exports, page
        # registrations), the prep thread (admission-pressure evictions,
        # restores) and tests.
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._tree)

    @property
    def bytes_held(self) -> int:
        return self._bytes

    # ------------------------------------------------------------------ #
    # Spill (put)
    # ------------------------------------------------------------------ #

    def put(self, key: Sequence[int], arrays, *, tokens: int, rows: Optional[int] = None,
            meta: Any = None, kind: str = "dense", count: bool = True, after: Any = None) -> bool:
        """Take an evicted entry's tensors: start the copy to the host now
        (nothing waits on it here), account its bytes, and evict colder
        entries past the budget. False, with nothing started, when the
        entry alone passes the whole budget. ``count=False`` keeps the
        spill counters still (an import is a transfer, not a spill)."""
        nbytes = _nbytes(arrays)
        if self.budget_bytes <= 0 or nbytes > self.budget_bytes:
            return False
        key = tuple(key)
        worker = None
        if isinstance(arrays[0], torch.Tensor) and arrays[0].is_cuda:
            if self._worker is None:
                self._worker = SpillWorker(arrays[0].device)
            worker = self._worker
        copy = SpillCopy(arrays, integrity=True, stream=self.stream, after=after, worker=worker)
        header = entry_header(arrays, kind)
        with self._lock:
            self._reap_locked()
            if not copy.landed():
                self._inflight.append(copy)
            old = self._tree.get(key)
            if old is not None:
                # The same prefix again (the same K/V): keep the fresh copy.
                self._bytes -= old.nbytes
            entry = HostEntry(key, copy, nbytes, tokens, rows if rows is not None else tokens,
                              meta, kind, header=header)
            self._clock += 1
            entry.stamp = self._clock
            self._tree.insert(key, entry)
            self._bytes += nbytes
            self._evict_over_budget_locked()
            self._gauges_locked()
        if count:
            global_metrics.inc("engine.kvcache.spills")
            global_metrics.inc("engine.kvcache.spill_bytes", nbytes)
        return True

    def _reap_locked(self) -> None:
        """Release the device sources of the copies that have landed. A
        spill that failed on the spill thread raises here, in whichever
        engine thread looks next: a failed spill is a fault, not a miss."""
        while self._inflight and self._inflight[0].landed():
            done = self._inflight.popleft()
            if done._job is not None and done._job.exception() is not None:
                raise done._job.exception()
            self.d2h_bytes += _nbytes(done._host)
            self.d2h_ms += done.ms or 0.0

    def reap(self) -> None:
        with self._lock:
            self._reap_locked()

    # ------------------------------------------------------------------ #
    # Lookup and restore (take)
    # ------------------------------------------------------------------ #

    def match(self, ids: Sequence[int]) -> Optional[HostEntry]:
        """The longest entry that is a proper prefix of ``ids``. Touches it."""
        with self._lock:
            self._reap_locked()
            node = self._tree.longest_payload_prefix(ids, proper=True)
            if node is None:
                return None
            entry = node.payload
            self._clock += 1
            entry.stamp = self._clock
            return entry

    def match_lcp(self, ids: Sequence[int]) -> Tuple[Optional[HostEntry], int]:
        """``(entry, lcp)``: the entry sharing the longest common prefix
        with ``ids``, not necessarily a whole-entry prefix. Prefix K/V does
        not depend on the suffix, so a restore slices the entry's first
        ``lcp`` rows: how a stored turn serves the next turn of the same
        transcript. ``lcp`` is capped to a proper prefix of ``ids``."""
        with self._lock:
            self._reap_locked()
            node, lcp = self._tree.deepest_common(ids)
            if node is None:
                return None, 0
            entry = node.payload
            self._clock += 1
            entry.stamp = self._clock
            return entry, min(lcp, len(ids) - 1, len(entry.key))

    def extension_blocks(self, ids: Sequence[int], from_block: int, page_size: int,
                         max_blocks: int) -> List[HostEntry]:
        """The contiguous run of spilled page blocks continuing a live chain
        of ``from_block`` blocks (entry b covers ``ids[:(b + 1) *
        page_size]``). Stops at the first gap, at ``max_blocks`` blocks in
        all, and always leaves a tail token (the proper-prefix rule)."""
        out: List[HostEntry] = []
        limit = min(max_blocks, (len(ids) - 1) // page_size)
        with self._lock:
            self._reap_locked()
            for b in range(from_block, limit):
                entry = self._tree.get(tuple(ids[: (b + 1) * page_size]))
                if entry is None or entry.kind != "page":
                    break
                self._clock += 1
                entry.stamp = self._clock
                out.append(entry)
        return out

    def take(self, key: Sequence[int]) -> Optional[HostEntry]:
        """Remove and return an entry (a restore moves it back to the
        device tier; a later eviction spills it again)."""
        with self._lock:
            entry = self._tree.remove(tuple(key))
            if entry is not None:
                self._bytes -= entry.nbytes
                self._gauges_locked()
            return entry

    def get(self, key: Sequence[int]) -> Optional[HostEntry]:
        with self._lock:
            return self._tree.get(tuple(key))

    def reinsert(self, entry: HostEntry) -> None:
        """Hand back an entry a restore took but could not complete (its
        pool was rebuilt in the meantime): its payload is host data, so
        this is bookkeeping alone."""
        with self._lock:
            old = self._tree.get(entry.key)
            if old is not None:
                self._bytes -= old.nbytes
            self._clock += 1
            entry.stamp = self._clock
            self._tree.insert(entry.key, entry)
            self._bytes += entry.nbytes
            self._evict_over_budget_locked()
            self._gauges_locked()

    def clear(self) -> None:
        with self._lock:
            self._tree = RadixTree()
            self._bytes = 0
            self._gauges_locked()

    # ------------------------------------------------------------------ #
    # Sessions
    # ------------------------------------------------------------------ #

    def note_session(self, session_id: Optional[str], ids: Sequence[int]) -> None:
        """Record a session's latest prompt as its lineage tip: entries
        that prefix a live lineage are protected from eviction."""
        if not session_id:
            return
        with self._lock:
            self._sessions[session_id] = tuple(ids)
            self._sessions.move_to_end(session_id)
            while len(self._sessions) > self.max_sessions:
                self._sessions.popitem(last=False)
            global_metrics.set_gauge("engine.kvcache.sessions", float(len(self._sessions)))

    def lineage(self, session_id: Optional[str]) -> Optional[Tuple[int, ...]]:
        """The session's lineage tip, or None: where an export starts."""
        if not session_id:
            return None
        with self._lock:
            return self._sessions.get(session_id)

    def drop_session(self, session_id: Optional[str]) -> None:
        """Forget a session's pin (its KV was exported away)."""
        if not session_id:
            return
        with self._lock:
            self._sessions.pop(session_id, None)
            global_metrics.set_gauge("engine.kvcache.sessions", float(len(self._sessions)))

    def prefix_entries(self, ids: Sequence[int]) -> List[HostEntry]:
        """Every entry whose key prefixes ``ids``, shallowest first, read
        without removing: the host part of a session's lineage, which an
        export copies (the entries may serve other sessions too)."""
        with self._lock:
            out: List[HostEntry] = []
            for node in self._tree.payload_prefixes(tuple(ids)):
                entry = node.payload
                self._clock += 1
                entry.stamp = self._clock
                out.append(entry)
            return out

    def _protected_locked(self, entry: HostEntry) -> bool:
        k = entry.key
        n = len(k)
        return any(len(lineage) >= n and lineage[:n] == k for lineage in self._sessions.values())

    # ------------------------------------------------------------------ #
    # Eviction
    # ------------------------------------------------------------------ #

    def _score_locked(self, entry: HostEntry) -> float:
        return eviction_score(entry.stamp, entry.tokens, entry.rows, self.policy)

    def _evict_over_budget_locked(self) -> None:
        """One ranked pass per overflow: unpinned entries go coldest first,
        pinned ones only once nothing unpinned is left."""
        if self._bytes <= self.budget_bytes or len(self._tree) <= 1:
            return
        ranked = sorted(((self._score_locked(e), e) for _, e in self._tree.items()),
                        key=lambda t: t[0])
        deferred: List[HostEntry] = []
        for _s, entry in ranked:
            if self._bytes <= self.budget_bytes:
                return
            if self._protected_locked(entry):
                deferred.append(entry)
                continue
            self._drop_locked(entry)
        for entry in deferred:
            if self._bytes <= self.budget_bytes or len(self._tree) <= 1:
                return
            self._drop_locked(entry)

    def _drop_locked(self, entry: HostEntry) -> None:
        self._tree.remove(entry.key)
        self._bytes -= entry.nbytes
        global_metrics.inc("engine.kvcache.evictions")

    def _gauges_locked(self) -> None:
        global_metrics.set_gauge("engine.kvcache.host_bytes", float(self._bytes))
        global_metrics.set_gauge("engine.kvcache.host_entries", float(len(self._tree)))


__all__ = ["HostEntry", "HostTier", "SpillCopy", "SpillWorker", "host_tensor"]
