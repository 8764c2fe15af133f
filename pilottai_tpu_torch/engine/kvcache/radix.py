"""Compressed radix tree over token-id sequences (the port's own copy of
``pilottai_tpu/engine/kvcache/radix.py``, which the port does not import).

The dense prefix store (``engine/prefix_cache.py``) keys cached K/V by
token-id prefixes; a path-compressed radix tree makes every lookup
O(len(ids)):

* edges carry token *runs* (not single tokens), so a 1K-token preamble
  entry is a two-node path, not a 1K-node chain;
* ``longest_payload_prefix`` walks the query once and returns the
  deepest stored entry that prefixes it — the hit primitive;
* ``lcp_candidates`` reads the divergence points off the walked path —
  the derived-entry primitive the dense store's shared-preamble
  self-organization uses — without comparing against any entry directly;
* payload nodes are additionally indexed by exact key for O(1)-ish
  ``has``/``get``/``remove`` (tuple hashing is O(len), the same bound);
* ``payload_prefixes`` returns every stored key on the query's path and
  ``deepest_common`` the longest common prefix with any stored key: the
  host tier's session export and its partial (sliced) restores.

The paged ``PagePrefixIndex`` keeps its own block-granular radix (its
nodes are refcounted pages); this tree serves token-granular keys.
Host-side bookkeeping only. The host tier (``kvcache/host_tier.py``)
keys spilled entries in the same tree.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple


def _common_len(a: Tuple[int, ...], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class RadixNode:
    """One tree node: the token run on its incoming edge, its children
    (keyed by each child edge's first token) and, when a key ends here,
    the stored payload."""

    __slots__ = ("label", "parent", "children", "payload", "key_len")

    def __init__(
        self,
        label: Tuple[int, ...],
        parent: Optional["RadixNode"],
        key_len: int,
    ) -> None:
        self.label = label
        self.parent = parent
        self.children: Dict[int, "RadixNode"] = {}
        self.payload: Any = None
        self.key_len = key_len  # tokens root -> here (inclusive of label)


class RadixTree:
    """Path-compressed token radix tree with per-key payloads."""

    def __init__(self) -> None:
        self._root = RadixNode((), None, 0)
        self._by_key: Dict[Tuple[int, ...], RadixNode] = {}

    def __len__(self) -> int:
        return len(self._by_key)

    def has(self, ids: Sequence[int]) -> bool:
        return tuple(ids) in self._by_key

    def __contains__(self, ids: Sequence[int]) -> bool:
        return tuple(ids) in self._by_key

    def get(self, ids: Sequence[int]) -> Any:
        node = self._by_key.get(tuple(ids))
        return node.payload if node is not None else None

    def keys(self) -> Iterator[Tuple[int, ...]]:
        return iter(self._by_key)

    def items(self) -> Iterator[Tuple[Tuple[int, ...], Any]]:
        for key, node in self._by_key.items():
            yield key, node.payload

    # ------------------------------------------------------------------ #

    def insert(self, ids: Sequence[int], payload: Any) -> RadixNode:
        """Store ``payload`` under exact key ``ids`` (replaces any
        existing payload). O(len(ids))."""
        key = tuple(ids)
        node = self._root
        i = 0
        while i < len(key):
            child = node.children.get(key[i])
            if child is None:
                leaf = RadixNode(key[i:], node, len(key))
                node.children[key[i]] = leaf
                node = leaf
                i = len(key)
                break
            m = _common_len(child.label, key[i:])
            if m < len(child.label):
                # Split the edge at the divergence point.
                child = self._split(child, m)
            node = child
            i += m
        if node is self._root:
            raise ValueError("empty key")
        self._by_key[key] = node
        node.payload = payload
        return node

    def _split(self, child: RadixNode, at: int) -> RadixNode:
        """Split ``child``'s edge after ``at`` label tokens; returns the
        new upper (pass-through) node."""
        parent = child.parent
        upper = RadixNode(
            child.label[:at], parent, child.key_len - len(child.label) + at
        )
        parent.children[child.label[0]] = upper
        child.label = child.label[at:]
        child.parent = upper
        upper.children[child.label[0]] = child
        return upper

    def remove(self, ids: Sequence[int]) -> Any:
        """Drop the key (returns its payload, or None when absent) and
        prune/merge pass-through structure so the tree never accretes
        dead interior nodes."""
        key = tuple(ids)
        node = self._by_key.pop(key, None)
        if node is None:
            return None
        payload, node.payload = node.payload, None
        # Prune payload-less leaves upward, then merge a single-child
        # pass-through survivor into its child.
        while (
            node is not self._root
            and node.payload is None
            and not node.children
        ):
            parent = node.parent
            del parent.children[node.label[0]]
            node = parent
        if (
            node is not self._root
            and node.payload is None
            and len(node.children) == 1
        ):
            (only,) = node.children.values()
            only.label = node.label + only.label
            only.parent = node.parent
            node.parent.children[only.label[0]] = only
        return payload

    # ------------------------------------------------------------------ #

    def longest_payload_prefix(
        self, ids: Sequence[int], proper: bool = True
    ) -> Optional[RadixNode]:
        """Deepest payload node whose key prefixes ``ids`` — with
        ``proper`` (the admission contract: a tail token must remain to
        produce first-token logits) the key must be strictly shorter
        than ``ids``. One O(len) walk."""
        limit = len(ids) - 1 if proper else len(ids)
        best: Optional[RadixNode] = None
        node = self._root
        i = 0
        while i < len(ids):
            child = node.children.get(ids[i])
            if child is None:
                break
            m = _common_len(child.label, ids[i:])
            if m < len(child.label):
                break
            i += m
            node = child
            if node.payload is not None and node.key_len <= limit:
                best = node
        return best

    def lcp_candidates(
        self, ids: Sequence[int], min_len: int = 1
    ) -> List[int]:
        """Distinct longest-common-prefix lengths between ``ids`` and
        stored keys that are worth deriving as their own entries:
        >= ``min_len``, strictly shorter than the keys they were read
        off, and not already stored. Sorted longest-first (store order —
        derived entries self-organize toward shared preambles). Read off
        the walked path's divergence points: every key in a sibling
        subtree shares exactly the path prefix; a mid-edge divergence
        shares the path plus the matched run."""
        out = set()
        node = self._root
        i = 0
        n = len(ids)
        while True:
            for tok, _child in node.children.items():
                if i < n and tok == ids[i]:
                    continue
                # Keys below this sibling edge extend past depth i (the
                # edge is non-empty), so their LCP with ids is exactly i.
                if i >= min_len:
                    out.add(i)
            if i >= n:
                break
            child = node.children.get(ids[i])
            if child is None:
                break
            m = _common_len(child.label, ids[i:])
            if m < len(child.label):
                # Diverged inside the edge: every key below shares i + m.
                if i + m >= min_len:
                    out.add(i + m)
                break
            i += m
            node = child
        return [
            p for p in sorted(out, reverse=True)
            if not self.has(tuple(ids[:p]))
        ]

    def payload_prefixes(
        self, ids: Sequence[int], proper: bool = False
    ) -> List[RadixNode]:
        """Every payload node whose key prefixes ``ids``, shallowest first
        (so ``[-1]`` is ``longest_payload_prefix``'s answer). One O(len)
        walk."""
        limit = len(ids) - 1 if proper else len(ids)
        out: List[RadixNode] = []
        node = self._root
        i = 0
        while i < len(ids):
            child = node.children.get(ids[i])
            if child is None:
                break
            m = _common_len(child.label, ids[i:])
            if m < len(child.label):
                break
            i += m
            node = child
            if node.payload is not None and node.key_len <= limit:
                out.append(node)
        return out

    def deepest_common(
        self, ids: Sequence[int]
    ) -> Tuple[Optional[RadixNode], int]:
        """``(payload_node, lcp)``: the longest common prefix between
        ``ids`` and any stored key, and a payload node whose key starts
        with it (the entry a partial restore slices). Causal attention's
        K/V at a position does not depend on what follows, so the first
        ``lcp`` rows of that entry are ``ids[:lcp]``'s exactly. One O(len)
        walk, then a descent to the nearest payload."""
        node = self._root
        i = 0
        while i < len(ids):
            child = node.children.get(ids[i])
            if child is None:
                break
            m = _common_len(child.label, ids[i:])
            i += m
            node = child
            if m < len(child.label):
                break
        if node is self._root:
            return None, 0
        best = node
        while best.payload is None:
            # A pass-through node always has children (it is pruned
            # otherwise), and every subtree holds a payload.
            best = next(iter(best.children.values()))
        return best, min(i, len(ids))


__all__ = ["RadixTree", "RadixNode"]
