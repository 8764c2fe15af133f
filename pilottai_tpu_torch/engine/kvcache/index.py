"""The one prefix-cache lookup over the dense store and the paged page
index: the device tier of ``pilottai_tpu/engine/kvcache/index.py``
(``lookup_dense``, ``lookup_paged``). The host tier behind it (spills of
evicted entries, restores, session lineage) comes with ROADMAP P7.

The batcher's ``_prefix_hit`` calls one of these under its slot lock.
``lookups`` counts one lookup per request (a head that waits for pages
and is selected again passes ``count=False``) and ``hits`` the lookups
that returned something usable; a geometry miss (the caller's ``fits``
says the tail would not land inside the context) is a lookup without a
hit.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence


class KVCacheIndex:
    """Device-tier lookups over ``prefix_store`` (dense) or ``page_index``
    (paged); one of them is set."""

    def __init__(self, *, prefix_store: Optional[Any] = None,
                 page_index: Optional[Any] = None) -> None:
        self.prefix_store = prefix_store
        self.page_index = page_index
        self.lookups = 0
        self.hits = 0

    def lookup_dense(self, ids: Sequence[int], *,
                     fits: Optional[Callable[[int, int], bool]] = None,
                     count: bool = True):
        """The stored entry that is the longest proper prefix of ``ids``
        and fits (``fits(prefix_len, p_bucket)``), or None."""
        store = self.prefix_store
        if store is None:
            return None
        if count:
            self.lookups += 1
        entry = store.match(ids)
        if entry is not None and fits is not None and not fits(len(entry.ids), entry.p_bucket):
            entry = None
        if entry is not None and count:
            self.hits += 1
        return entry

    def lookup_paged(self, ids: Sequence[int], *, max_seq_len: int = 0,
                     count: bool = True):
        """The deepest cached page chain that is a proper prefix of ``ids``
        and leaves a tail inside ``max_seq_len``, or None."""
        index = self.page_index
        if index is None:
            return None
        if count:
            self.lookups += 1
        node = index.match(ids)
        if node is not None and max_seq_len and node.depth * index.page_size >= max_seq_len:
            node = None
        if node is not None and count:
            self.hits += 1
        return node
