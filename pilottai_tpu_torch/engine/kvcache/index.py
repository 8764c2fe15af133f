"""``KVCacheIndex``: one prefix lookup over two tiers, with spills and
restores (the port's counterpart of ``pilottai_tpu/engine/kvcache/index.py``).

* **Lookup.** ``lookup_dense`` and ``lookup_paged`` are the batcher's one
  entry point (``_prefix_hit``, under its slot lock): a device-resident
  hit first (the dense store, the paged page index), then the host tier,
  whose hit restores the spilled K/V instead of prefilling it again.
* **Spill.** Wired as the eviction hooks of both device structures: an
  evicted dense entry's panels, or an evicted leaf page's K/V, start their
  copy to pinned host memory at eviction time and land in the host tier
  (``kvcache/host_tier.py``). With no host tier nothing is wired and an
  eviction drops the K/V, as before.
* **Dense restore.** The host panels are uploaded into new device tensors
  on the prep thread, on a copy stream of their own, and an event is
  recorded after the upload; the restored entry carries it (``ready``)
  and the device thread's admission waits on it before kernel K1 reads
  the panels (``ContinuousBatcher._dispatch_prefill``). The admission is
  then a device-resident hit's.
* **Paged restore.** Fresh pages are taken from the allocator, the chain
  is registered in the live index and a ``PendingRestore`` is returned;
  the device thread uploads the host pages and writes them into the pool
  in place (``apply_restores``: ``ops/paged.py:write_prompts_paged``, or
  for an int8 pool's raw pages a copy with their scales) before any
  dispatch reads those pages. No pool tensor is reallocated, so every
  captured chunk graph stays valid. The JAX package pads the chain to a
  power of two only to bound its jitted executables; the eager port
  writes the chain as it is.
* **Sessions.** A lookup records the request's ``session_id`` lineage; an
  export packs a session's (or a request's) cached K/V in the JAX
  package's sealed transfer format, and an import lands it in the host
  tier, so the next turn restores.

Every series is ``engine.kvcache.<name>`` on ``global_metrics`` (lookups,
hits, host_hits, restores, restored_tokens, restore_ms, spills,
spill_bytes, evictions, integrity_failures, prefill_tokens_saved). The
process-wide series add up every engine of the process, so each count
this index makes lands in ``counts`` as well, which the batcher's
``prefix_report()`` reads for its own engine.

Threading: lookups and spills run under the batcher's slot lock (the prep
thread, or the device thread); ``apply_restores`` on the device thread
only. On the card every spill's page gather is enqueued on the engine's
device stream (``stream``): from the device thread or from the prep
thread, always before the evicted page's ``unpin``, so any later write to
that page (an admission's scatter, a chunk graph) is ordered after the
read; the host tier's spill thread copies the gathered tensors to the
host. The host tier has a lock of its own and survives
engine-state rebuilds: restores staged before a rebuild are stamped with
the allocator's epoch and unwound at apply time.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from pilottai_tpu_torch.device import upload
from pilottai_tpu_torch.engine.kvcache.host_tier import HostTier, SpillCopy, host_tensor
from pilottai_tpu_torch.engine.kvcache.integrity import (
    corrupt_arrays,
    entry_header,
    frame_ok,
    header_matches,
    kv_checksum,
)
from pilottai_tpu_torch.engine.prefix_cache import PrefixEntry
from pilottai_tpu_torch.ops.kvcache import dequantize_kv
from pilottai_tpu_torch.ops.paged import write_prompts_paged
from pilottai_tpu_torch.reliability.inject import global_injector
from pilottai_tpu_torch.utils.metrics import global_metrics


def gather_page(cache, page: int, raw: bool = False) -> Tuple[torch.Tensor, ...]:
    """One page's K/V out of every layer's pool as stacked ``[L, K, P, H]``
    tensors. An int8 pool's page is dequantized to fp32, as the JAX
    package's ``_gather_page_fn`` does (an export's layout); with ``raw`` it
    comes as stored instead, its int8 K and V and their fp32 ``[L, K, P]``
    scales (a spill's, see ``KVCacheIndex._spill_page``)."""
    ks_l, vs_l, ksc_l, vsc_l = [], [], [], []
    for li, (kp, vp) in enumerate(cache.layers):
        gk, gv = kp[:, page], vp[:, page]
        if cache.scales is not None:
            ksc, vsc = cache.scales[li]
            if raw:
                ksc_l.append(ksc[:, page])
                vsc_l.append(vsc[:, page])
            else:
                gk = dequantize_kv(gk, ksc[:, page], torch.float32)
                gv = dequantize_kv(gv, vsc[:, page], torch.float32)
        ks_l.append(gk)
        vs_l.append(gv)
    out = (torch.stack(ks_l), torch.stack(vs_l))
    return out + (torch.stack(ksc_l), torch.stack(vsc_l)) if ksc_l else out


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous in pinned host memory (a copy unless it is so
    already), so an upload from it does not wait for the device."""
    if t.is_pinned() and t.is_contiguous():
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _wire(t: torch.Tensor) -> Any:
    """A host payload in the transfer format: a numpy array, as the JAX
    package ships, except bf16, which numpy cannot hold without
    ``ml_dtypes`` and which stays a CPU tensor."""
    return t if t.dtype == torch.bfloat16 else t.numpy()


class PendingRestore:
    """One restored page chain awaiting its pool write on the device
    thread. ``epoch`` is the allocator generation its pages came from: a
    rebuild makes the record void, and ``apply_restores`` then hands the
    host entries it consumed (``entries``) back to the tier, so a restore
    caught by a recovery unwinds and the K/V is there to restore again."""

    __slots__ = ("epoch", "pages", "blocks", "tokens", "entries")

    def __init__(self, epoch, pages, blocks, tokens, entries):
        self.epoch = epoch
        self.pages = pages      # the taken pages, in chain order
        self.blocks = blocks    # per page its host tensors: (K, V) or raw int8 (K, V, scales)
        self.tokens = tokens    # restored tokens (blocks x page size)
        self.entries = entries  # the HostEntry list the restore consumed


class KVCacheIndex:
    """The prefix lookup over the device tier and the host tier."""

    def __init__(
        self,
        *,
        prefix_store: Optional[Any] = None,
        page_index: Optional[Any] = None,
        page_size: int = 0,
        host_bytes: int = 0,
        policy: str = "cost",
        get_cache: Optional[Callable[[], Any]] = None,
        min_len: Optional[int] = None,
        device: Optional[torch.device] = None,
        stream: Any = None,
    ) -> None:
        self.prefix_store = prefix_store
        self.page_index = page_index
        self.page_size = page_size
        self._get_cache = get_cache
        self.device = device if device is not None else torch.device("cpu")
        #: The engine's device stream: spill gathers, export reads and (on
        #: the device thread) restore writes run on it.
        self.stream = stream
        # Dense restores upload on a stream of their own, beside the
        # decode chunks in flight; an event orders the admission after.
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" and host_bytes > 0 else None)
        # The dense entry floor (engine_prefix_min_len); None: the store's.
        self._min_len = min_len
        self.host: Optional[HostTier] = (
            HostTier(host_bytes, policy, stream=stream) if host_bytes > 0 else None
        )
        #: This engine's share of the ``engine.kvcache.*`` counters.
        self.counts: Dict[str, float] = collections.Counter()
        # Pages a PendingRestore has taken but not yet written (slot lock):
        # an eviction before the write must not spill their stale contents.
        self._unwritten: set = set()
        # (bytes, start, end) of restore uploads whose time is not read yet.
        self._uploads: List[Tuple[int, Any, Any]] = []
        self.h2d_bytes = 0
        self.h2d_ms = 0.0
        if self.host is not None:
            if prefix_store is not None:
                prefix_store.on_evict = self._spill_dense
            if page_index is not None:
                page_index.on_evict = self._spill_page

    @property
    def min_len(self) -> int:
        """The dense tier's caching floor in tokens (0 when paged)."""
        if self._min_len is not None:
            return self._min_len
        if self.prefix_store is not None:
            return self.prefix_store.min_len
        return 0

    @property
    def lookups(self) -> int:
        return int(self.counts["lookups"])

    @property
    def hits(self) -> int:
        return int(self.counts["hits"])

    def _count(self, name: str, n: float = 1) -> None:
        self.counts[name] += n
        global_metrics.inc(f"engine.kvcache.{name}", n)

    def _on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def transfer_report(self) -> Dict[str, float]:
        """Bytes and device milliseconds of the spill copies (D2H) and the
        restore uploads (H2D) that have completed, on CUDA; zeros on the
        CPU."""
        if self.host is not None:
            self.host.reap()
        pending = []
        for n, start, end in self._uploads:
            if end.query():
                self.h2d_bytes += n
                self.h2d_ms += start.elapsed_time(end)
            else:
                pending.append((n, start, end))
        self._uploads = pending
        host = self.host
        return {"d2h_bytes": host.d2h_bytes if host is not None else 0,
                "d2h_ms": host.d2h_ms if host is not None else 0.0,
                "h2d_bytes": self.h2d_bytes, "h2d_ms": self.h2d_ms}

    # ------------------------------------------------------------------ #
    # Spill (the eviction hooks of the device structures)
    # ------------------------------------------------------------------ #

    def _spill_dense(self, entry) -> None:
        """A dense-store eviction: the entry's panels are tensors nothing
        writes; their copy starts now (after a restored entry's upload)."""
        self.host.put(entry.ids, (entry.ks, entry.vs), tokens=len(entry.ids),
                      rows=entry.p_bucket, meta=entry.p_bucket, kind="dense",
                      after=getattr(entry, "ready", None))

    def _spill_page(self, path_ids: Tuple[int, ...], page: int) -> None:
        """A page-index leaf eviction, under the batcher's slot lock and
        before the page's unpin: the gather is enqueued on the engine's
        device stream, so whatever later writes the page (an admission's
        scatter, a chunk graph, both on that stream) runs after the read;
        its copy to the host reads the gathered tensors, on the host tier's
        spill thread. The pool is written in place and never rebound
        (the graphs hold its address), so the JAX package's retry around a
        donated, rebound buffer has no counterpart here.

        An int8 pool's page spills raw (int8 K, V and their scales), where
        the JAX package spills it dequantized to fp32: quantizing the fp32
        values again gives the same int8 bytes but not always the same
        scales (an ulp off on some tokens, in the JAX package too, ROADMAP
        C.5), and the raw copy is about a quarter of the bytes. The
        restore writes it back as it was; an export still ships fp32."""
        if page in self._unwritten:
            # Restored but not yet written: its contents are stale, and the
            # K/V it is to hold came from the host tier moments ago.
            return
        cache = self._get_cache()
        with self._on_stream():
            self.host.put(path_ids, gather_page(cache, page, raw=True), tokens=self.page_size,
                          rows=self.page_size,
                          meta=len(path_ids) // max(self.page_size, 1) - 1, kind="page")

    # ------------------------------------------------------------------ #
    # The integrity gate
    # ------------------------------------------------------------------ #

    def _entry_ok(self, entry) -> bool:
        """Check a host entry's frame before a restored byte is used: the
        layout header against the host tensors, then the sealed CRC. The
        caller drops a failed entry and prefills instead; this counts
        ``integrity_failures``."""
        copy = entry.copy
        arrays = copy.wait()
        # Fault point: the bytes rot between the spill's first read and
        # this restore (``kvcache.spill.corrupt`` rots them at the read).
        if global_injector.fire("kvcache.restore.corrupt") is not None:
            arrays[:] = [a.clone() for a in arrays]
            corrupt_arrays(arrays)
        ok = entry.header is None or header_matches(entry.header, arrays)
        if ok:
            ok = copy.verify()
        if not ok:
            self._count("integrity_failures")
        return ok

    # ------------------------------------------------------------------ #
    # Lookup
    # ------------------------------------------------------------------ #

    def _upload(self, tensors: Sequence[torch.Tensor], rows: int
                ) -> Tuple[List[torch.Tensor], Any]:
        """Host ``[L, K, R, H]`` panels' first ``rows`` rows as new device
        tensors: on CUDA the whole pinned panels uploaded on the copy stream
        (no host copy) and sliced there, with the event the consumer waits
        on; on the CPU contiguous copies."""
        if self.copy_stream is None:
            return [t[:, :, :rows].contiguous().to(self.device) for t in tensors], None
        src = [_pinned(t) for t in tensors]
        with torch.cuda.stream(self.copy_stream):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            out = [t.to(self.device, non_blocking=True) for t in src]
            out = [t[:, :, :rows].contiguous() if rows < t.shape[2] else t for t in out]
            ready = torch.cuda.Event(enable_timing=True)
            ready.record()
        for t in out:
            # Read on the device stream: its memory must outlive that use.
            t.record_stream(self.stream if self.stream is not None
                            else torch.cuda.current_stream(self.device))
        self._uploads.append((sum(t.nbytes for t in src), start, ready))
        return out, ready

    def lookup_dense(self, ids: Sequence[int], *, session_id: Optional[str] = None,
                     fits: Optional[Callable[[int, int], bool]] = None,
                     bucket: Optional[Callable[[int], int]] = None, count: bool = True):
        """The hot store first, the host tier second: a ``PrefixEntry`` or
        None. The host match is by longest common prefix: a stored turn
        serves the next turn of its transcript by its first ``lcp`` rows,
        re-bucketed by ``bucket``. ``fits(plen, p_bucket)`` is the caller's
        geometry check (the tail must land inside ``max_seq``); ``count``
        is False for a request looked up again (a head waiting for a
        slot). A restored entry goes back into the hot store, so the next
        hit is device-resident."""
        store = self.prefix_store
        if store is None:
            return None
        if count:
            self._count("lookups")
        if self.host is not None:
            self.host.note_session(session_id, ids)
        entry = store.match(ids)
        if entry is not None and fits is not None and not fits(len(entry.ids), entry.p_bucket):
            entry = None      # a shorter host entry may still fit
        h, lcp = self.host.match_lcp(ids) if self.host is not None else (None, 0)
        p_bucket = 0
        if h is not None:
            p_bucket = min(bucket(lcp), h.rows) if bucket is not None else h.rows
        if (h is None or h.kind != "dense" or lcp < store.min_len
                # A hot hit at least as long is free.
                or (entry is not None and lcp <= len(entry.ids))
                or (fits is not None and not fits(lcp, p_bucket))):
            if entry is not None and count:
                self._count("hits")
            return entry
        if not self._entry_ok(h):
            # A corrupt entry never verifies: drop it and serve what the
            # hot store had; the rest is prefilled (the same output).
            self.host.take(h.key)
            if entry is not None and count:
                self._count("hits")
            return entry
        t0 = time.perf_counter()
        key = tuple(h.key[:lcp])
        ks_h, vs_h = h.copy.wait()
        (ks_d, vs_d), ready = self._upload((ks_h, vs_h), p_bucket)
        if lcp == len(h.key):
            # A whole-entry restore moves it back to the hot store; a sliced
            # one leaves it, since its full depth may serve its own session.
            self.host.take(h.key)
        store.store(key, ks_d, vs_d, p_bucket)
        restored = store.match(ids)
        if restored is None or restored.ids != key:
            restored = PrefixEntry(key, ks_d, vs_d, p_bucket)
        if restored.ks is ks_d:
            restored.ready = ready
        if count:
            self._count("hits")
        self._count("host_hits")
        self._count("restores")
        self._count("restored_tokens", lcp)
        global_metrics.observe("engine.kvcache.restore_ms", (time.perf_counter() - t0) * 1e3)
        return restored

    def lookup_paged(self, ids: Sequence[int], *, session_id: Optional[str] = None,
                     alloc: Optional[Any] = None, max_seq_len: int = 0, need_tokens: int = 0,
                     epoch: int = 0, count: bool = True):
        """The live chain first, then the host tier's contiguous blocks past
        it: ``(node, PendingRestore or None)``. A chain that leaves no tail
        inside ``max_seq_len`` is a miss. A host hit takes fresh pages and
        registers the extended chain, pinned, in the live index; the device
        thread applies the record before any dispatch reads those pages
        (the batcher's ``_apply_restores``)."""
        index = self.page_index
        if index is None:
            return None, None
        if count:
            self._count("lookups")
        if self.host is not None:
            self.host.note_session(session_id, ids)
        node = index.match(ids)
        if node is not None and max_seq_len and node.depth * index.page_size >= max_seq_len:
            node = None
        depth = node.depth if node is not None else 0
        if self.host is None or alloc is None:
            if node is not None and count:
                self._count("hits")
            return node, None
        P = self.page_size
        # At least one tail token inside max_seq.
        max_blocks = max((max_seq_len - 1) // P, 0)
        if index.capacity:
            # A chain longer than the index's pin budget would evict its own
            # tail as it registers.
            max_blocks = min(max_blocks, depth + index.capacity)
        ents = self.host.extension_blocks(ids, depth, P, max_blocks)
        good: List[Any] = []
        for e in ents:
            # The chain must stay contiguous: the first corrupt link ends it.
            if not self._entry_ok(e):
                self.host.take(e.key)
                break
            good.append(e)
        ents = good
        total_need = alloc.pages_needed(min(need_tokens, max_seq_len))
        if ents and alloc.free_pages < max(total_need - depth, 0):
            ents = []         # it cannot admit now; pinning more would deepen that
        if not ents:
            if node is not None and count:
                self._count("hits")
            return node, None
        t0 = time.perf_counter()
        k = len(ents)
        hosts = [e.copy.wait() for e in ents]
        pages = alloc.take(k)
        if pages is None:
            if node is not None and count:
                self._count("hits")
            return node, None
        rec = PendingRestore(epoch, list(pages), [list(h) for h in hosts], k * P, list(ents))
        # Marked before registering: the registration's own capacity
        # eviction may pick these pages before they are written.
        self._unwritten.update(pages)
        chain_pages = (tuple(node.path_pages) if node is not None else ()) + tuple(pages)
        # The whole chain is protected from that eviction: evicting a
        # restored page would free it under its pending write, with its host
        # entry already consumed.
        index.register(list(ids[: (depth + k) * P]), chain_pages, alloc,
                       protect=frozenset(chain_pages))
        for p in pages:
            alloc.unpin(p)       # the index holds them now
        for e in ents:
            self.host.take(e.key)
        out = index.match(ids)
        if count:
            self._count("hits")
        self._count("host_hits")
        self._count("restores")
        self._count("restored_tokens", k * P)
        global_metrics.observe("engine.kvcache.restore_ms", (time.perf_counter() - t0) * 1e3)
        return out, rec

    # ------------------------------------------------------------------ #
    # Session and request transfer
    # ------------------------------------------------------------------ #

    def export_session(self, session_id: Optional[str]):
        """A session's cached K/V lineage in the sealed transfer format
        (``{"session_id", "ids", "entries"}``), or None when the session has
        no lineage. Everything is copied, never moved; only the session's
        pin leaves this tier. Slot lock held."""
        if self.host is None:
            return None
        ids = self.host.lineage(session_id)
        if not ids:
            return None
        entries = self._export_entries(ids)
        self.host.drop_session(session_id)
        return {"session_id": session_id, "ids": list(ids), "entries": entries}

    def export_request(self, ids, *, session_id: Optional[str] = None):
        """A request's cached K/V, keyed by its prompt ids, in the same
        format (the prefill-to-decode handoff); no session pin moves. None
        when nothing covering ``ids`` is cached. Slot lock held."""
        ids = tuple(ids)
        if not ids:
            return None
        entries = self._export_entries(ids)
        if not entries:
            return None
        return {"session_id": session_id, "ids": list(ids), "entries": entries}

    def _host_copy(self, tensors: Sequence[torch.Tensor], after: Any = None) -> List[torch.Tensor]:
        """Host copies of device tensors, read on the engine's stream (a
        blocking read: exports are control-plane calls)."""
        if tensors[0].is_cuda:
            return SpillCopy(tensors, stream=self.stream, after=after).wait()
        return [t.detach().clone() for t in tensors]

    def _export_entries(self, ids) -> List[dict]:
        """Copy every cached span covering a prefix of ``ids``: verified
        host entries (rot is dropped, never shipped), the hot dense entry
        and the live page chain, each sealed with its frame at pack time."""
        entries: List[dict] = []
        have: set = set()

        def add(key, k, v, tokens, rows, meta, kind):
            key = tuple(key)
            if key in have or not key:
                return
            have.add(key)
            k, v = _wire(k), _wire(v)
            entries.append({
                "key": list(key), "k": k, "v": v, "tokens": int(tokens), "rows": int(rows),
                "meta": meta, "kind": kind, "header": entry_header((k, v), kind),
                "crc": kv_checksum((k, v)),
            })

        if self.host is not None:
            for e in self.host.prefix_entries(ids):
                if not self._entry_ok(e):
                    self.host.take(e.key)
                    continue
                host = [t.clone() for t in e.copy.wait()]
                if len(host) == 4:
                    # A raw int8 page ships dequantized, the JAX layout.
                    host = [dequantize_kv(host[i], host[i + 2], torch.float32) for i in (0, 1)]
                add(e.key, host[0], host[1], e.tokens, e.rows, e.meta, e.kind)
        store = self.prefix_store
        if store is not None:
            hot = store.match(ids)
            if hot is not None and tuple(hot.ids) not in have:
                k, v = self._host_copy((hot.ks, hot.vs), after=getattr(hot, "ready", None))
                add(hot.ids, k, v, len(hot.ids), hot.p_bucket, hot.p_bucket, "dense")
        index = self.page_index
        if index is not None:
            node = index.match(ids)
            if node is not None:
                path = index.path_tokens(node)
                cache = self._get_cache()
                for b, page in enumerate(node.path_pages):
                    key = tuple(path[: (b + 1) * self.page_size])
                    if key in have:
                        continue
                    with self._on_stream():
                        k, v = self._host_copy(gather_page(cache, page))
                    add(key, k, v, self.page_size, self.page_size, b, "page")
        entries.sort(key=lambda e: len(e["key"]))
        return entries

    def import_session(self, export) -> Dict[str, int]:
        """Land an export's entries in this host tier (``count=False``: an
        import is no spill) and move the session's pin here. Each framed
        entry is checked (CRC, version, layout) before it lands; a failed
        one is dropped, counted in ``integrity_failures`` and in
        ``rejected``. Returns ``{"accepted", "tokens", "rejected"}``,
        counting only what landed."""
        if self.host is None or not export:
            return {"accepted": 0, "tokens": 0, "rejected": 0}
        accepted = tokens = rejected = 0
        for e in export.get("entries", ()):
            arrays = (host_tensor(e["k"]), host_tensor(e["v"]))
            framed = e.get("crc") is not None or e.get("header") is not None
            if framed and not frame_ok(e, arrays):
                rejected += 1
                self._count("integrity_failures")
                continue
            if self.device.type == "cuda":
                arrays = tuple(_pinned(a) for a in arrays)
            if self.host.put(tuple(e["key"]), arrays, tokens=e["tokens"], rows=e["rows"],
                             meta=e.get("meta"), kind=e.get("kind", "dense"), count=False):
                accepted += 1
                tokens += int(e["tokens"])
        self.host.note_session(export.get("session_id"), tuple(export.get("ids") or ()))
        return {"accepted": accepted, "tokens": tokens, "rejected": rejected}

    # ------------------------------------------------------------------ #
    # Restore apply (device thread only)
    # ------------------------------------------------------------------ #

    def apply_restores(self, cache, records: List[PendingRestore], epoch: int):
        """Write pending restored chains into the page pool, in place (the
        device thread, on its stream: uploads from pinned memory and the
        writes, enqueued and never awaited). A page held as K and V goes
        through ``write_prompts_paged`` (quantized there for an int8 pool);
        a raw int8 page is copied back with its scales. A record of an
        older epoch died with its pool: nothing is written and its host
        entries go back to the tier, for the recovered request to restore
        again."""
        for rec in records:
            if rec.epoch != epoch:
                if self.host is not None:
                    for e in rec.entries:
                        self.host.reinsert(e)
                continue
            dev = cache.lengths.device
            cuda = dev.type == "cuda"

            def up(t: torch.Tensor) -> torch.Tensor:
                return _pinned(t).to(dev, non_blocking=True) if cuda else t

            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            plain = [(p, b) for p, b in zip(rec.pages, rec.blocks) if len(b) == 2]
            raw = [(p, b) for p, b in zip(rec.pages, rec.blocks) if len(b) == 4]
            ups = [torch.cat([up(b[i]) for _, b in plain], dim=2) for i in (0, 1)] if plain else []
            # Raw pages: [L, K, n, P, H] values and [L, K, n, P] scales.
            raws = [torch.stack([up(b[i]) for _, b in raw], dim=2) for i in range(4)] if raw else []
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self._uploads.append((sum(t.nbytes for t in ups + raws), start, end))
            if plain:
                # [L, K, T, H] -> the admission write's [L, A=1, T, K, H].
                write_prompts_paged(cache, upload([[p for p, _ in plain]], torch.int32, dev),
                                    ups[0].permute(0, 2, 1, 3)[:, None],
                                    ups[1].permute(0, 2, 1, 3)[:, None],
                                    [len(plain) * self.page_size])
            if raw:
                idx = upload([p for p, _ in raw], torch.long, dev)
                for li, (kp, vp) in enumerate(cache.layers):
                    kp[:, idx] = raws[0][li]
                    vp[:, idx] = raws[1][li]
                    ksc, vsc = cache.scales[li]
                    ksc[:, idx] = raws[2][li]
                    vsc[:, idx] = raws[3][li]
        return cache

    def mark_written(self, records: List[PendingRestore]) -> None:
        """Lift the unwritten-page guard for applied (or dropped) records,
        slot lock held. Runs after the writes are enqueued, so stream order
        puts any later spill's gather after them."""
        for rec in records:
            self._unwritten.difference_update(rec.pages)


__all__ = ["KVCacheIndex", "PendingRestore", "gather_page"]
