"""Block-granular automatic prefix caching on the paged KV cache (the
port's counterpart of ``pilottai_tpu/engine/page_prefix.py``).

A prompt's K/V already lives in pages, a page is immutable once the
positions it covers lie fully inside the prompt (decode writes start at
``prompt_len``), and mapping a page into another slot's block table is
free. So cached prefixes here are refcounted pages in a radix tree keyed
on page-aligned token blocks:

* ``register`` (after any admission) pins the pages that the prompt
  fully covers — one radix node per page, keyed by (parent node, that
  block's token ids);
* ``match`` walks a new prompt's blocks down the tree and returns the
  deepest chain, whose pages go straight into the new slot's block table
  (``PageAllocator.allocate(prefix_pages=...)``); only the tail is
  prefilled (``engine/decode.py:admit_group_prefix_paged``);
* sharing is per page: two prompts agreeing on their first k blocks
  share exactly k pages, so no derived entries are needed;
* eviction is LRU over leaf nodes, and admission pressure reclaims
  cached pages on demand (``evict``), so caching never starves
  admissions.

A match is always a proper prefix (a tail token must remain for the first
generated token's logits): the walk stops at ``(len(ids) - 1) //
page_size`` blocks. With the host tier on, ``on_evict`` spills each
evicted page's K/V before its unpin (``engine/kvcache/index.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch


def device_fault(exc: BaseException) -> bool:
    """Is this a CUDA error (a sticky one, ``engine/batcher.py:
    sticky_device_error``, or any error torch raises from the CUDA
    runtime)? Such an error is never swallowed as a dropped spill."""
    from pilottai_tpu_torch.engine.batcher import sticky_device_error

    accelerator = getattr(torch, "AcceleratorError", None)
    return (sticky_device_error(exc) or isinstance(exc, torch.cuda.CudaError)
            or (accelerator is not None and isinstance(exc, accelerator))
            or "CUDA error" in str(exc))


class PageNode:
    """One cached page: the block of tokens it covers and its chain."""

    __slots__ = ("tokens", "page", "parent", "children", "stamp",
                 "path_pages", "depth")

    def __init__(
        self,
        tokens: Tuple[int, ...],
        page: int,
        parent: Optional["PageNode"],
    ) -> None:
        self.tokens = tokens
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "PageNode"] = {}
        self.stamp = 0
        parent_path = parent.path_pages if parent is not None else ()
        self.path_pages: Tuple[int, ...] = parent_path + (page,)
        self.depth = len(self.path_pages)


class PagePrefixIndex:
    """Radix tree of pinned prompt-prefix pages (host side, device-thread
    only — same single-thread discipline as ``PageAllocator``)."""

    def __init__(self, page_size: int, capacity_pages: int) -> None:
        self.page_size = page_size
        self.capacity = max(capacity_pages, 0)
        self._root_children: Dict[Tuple[int, ...], PageNode] = {}
        self._nodes: set = set()  # all nodes, for LRU scans
        self._clock = 0
        # Eviction hook of the host tier: called with the victim's full
        # token path and page BEFORE the unpin, while the page contents are
        # still live. None drops the page.
        self.on_evict = None

    @staticmethod
    def path_tokens(node: PageNode) -> Tuple[int, ...]:
        """Full token prefix covered by ``node``'s chain (walks parents;
        eviction-rate only — nodes don't duplicate their path)."""
        parts: List[Tuple[int, ...]] = []
        walk: Optional[PageNode] = node
        while walk is not None:
            parts.append(walk.tokens)
            walk = walk.parent
        return tuple(t for blk in reversed(parts) for t in blk)

    def __len__(self) -> int:
        return len(self._nodes)

    @property
    def pinned_pages(self) -> int:
        return len(self._nodes)

    def _touch(self, node: PageNode) -> None:
        self._clock += 1
        node.stamp = self._clock

    def _children_of(
        self, node: Optional[PageNode]
    ) -> Dict[Tuple[int, ...], PageNode]:
        return self._root_children if node is None else node.children

    def match(self, ids: Sequence[int]) -> Optional[PageNode]:
        """Deepest cached chain that is a proper prefix of ``ids``.
        Returns the terminal node (its ``path_pages`` are the shared
        pages, ``depth * page_size`` the prefix length) or None."""
        P = self.page_size
        max_blocks = (len(ids) - 1) // P
        node: Optional[PageNode] = None
        for b in range(max_blocks):
            blk = tuple(ids[b * P: (b + 1) * P])
            child = self._children_of(node).get(blk)
            if child is None:
                break
            node = child
        if node is None:
            return None
        # Touch the whole path so LRU eviction can't orphan a hot chain's
        # interior while its leaf stays pinned.
        walk: Optional[PageNode] = node
        while walk is not None:
            self._touch(walk)
            walk = walk.parent
        return node

    def register(
        self, ids: Sequence[int], pages: Sequence[int], alloc,
        protect: frozenset = frozenset(),
    ) -> None:
        """Pin the chain of fully-covered prompt blocks. ``ids`` must be
        exactly the covered tokens (``len(ids) == len(pages) *
        page_size``) and ``pages`` the slot's table entries for them.
        Existing nodes are kept (their pages already hold identical K/V);
        new nodes pin the slot's private pages so they outlive it.
        ``protect`` exempts pages from the capacity eviction this call
        may trigger — the KV-cache tier's restore path protects its own
        freshly restored chain, which would otherwise be the LRU pass's
        first victim before its pool write even lands."""
        P = self.page_size
        assert len(ids) == len(pages) * P
        node: Optional[PageNode] = None
        for b, page in enumerate(pages):
            blk = tuple(ids[b * P: (b + 1) * P])
            children = self._children_of(node)
            child = children.get(blk)
            if child is None:
                child = PageNode(blk, int(page), node)
                alloc.pin(int(page))
                children[blk] = child
                self._nodes.add(child)
            self._touch(child)
            node = child
        if self.capacity and len(self._nodes) > self.capacity:
            self._evict_lru(
                len(self._nodes) - self.capacity, alloc, protect
            )

    def evict(
        self, n_pages: int, alloc,
        protect: frozenset = frozenset(),
    ) -> int:
        """Admission-pressure reclaim: unpin up to ``n_pages`` LRU leaf
        pages (never ones in ``protect`` — the chain a pending admission
        is about to map). Only pages whose SOLE ref is the index are
        eligible: unpinning a page a running slot still maps frees
        nothing — it would just wipe a hot cache entry while the head
        stays blocked. Returns pages made allocatable."""
        return self._evict_lru(n_pages, alloc, protect, only_free=True)

    def _evict_lru(
        self, n_pages: int, alloc,
        protect: frozenset = frozenset(),
        only_free: bool = False,
    ) -> int:
        dropped = 0
        while dropped < n_pages and self._nodes:
            # One batched pass: eligible leaves oldest-first (evicting a
            # leaf can turn its parent into one — the outer loop catches
            # those on the next pass).
            leaves = sorted(
                (
                    n for n in self._nodes
                    if not n.children and n.page not in protect
                    and (not only_free or alloc.refs[n.page] == 1)
                ),
                key=lambda n: n.stamp,
            )
            if not leaves:
                break
            for victim in leaves[: n_pages - dropped]:
                self._children_of(victim.parent).pop(victim.tokens, None)
                self._nodes.remove(victim)
                if self.on_evict is not None:
                    # Spill BEFORE the unpin: the page is still
                    # referenced, so its contents cannot be overwritten
                    # until the spill's read is enqueued.
                    try:
                        self.on_evict(self.path_tokens(victim), victim.page)
                    except Exception as exc:  # noqa: BLE001 — a spill is optional...
                        # ...but a device fault is not a dropped spill: it
                        # reaches the batcher's fault arm.
                        if device_fault(exc):
                            alloc.unpin(victim.page)
                            raise
                alloc.unpin(victim.page)
                dropped += 1
        return dropped

    def clear(self, alloc=None) -> None:
        """Drop every node. With ``alloc`` the pages are unpinned; without
        (engine-state rebuild: the pool itself was recreated) the
        bookkeeping is simply reset."""
        if alloc is not None:
            for n in self._nodes:
                alloc.unpin(n.page)
        self._root_children = {}
        self._nodes = set()


__all__ = ["PagePrefixIndex", "PageNode"]
