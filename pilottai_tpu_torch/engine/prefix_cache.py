"""Automatic prefix caching on the dense KV cache (the port's counterpart
of ``pilottai_tpu/engine/prefix_cache.py``).

Agent workloads re-send near-identical prompts: the protocol preamble is
byte-identical across calls, and whole prompts repeat across retries and
sibling subtasks. The store keeps the K/V panels (and token ids) of
recently admitted prompts on the device. A request that shares a cached
prefix admits by copying those panels into its slot and prefilling only
the tail against them (``engine/decode.py:admit_group_prefix``); an exact
repeat is a one-token tail. Derived longest-common-prefix entries
self-organize toward the shared preamble: when two different prompts
share a prefix of at least ``min_len`` tokens, that prefix becomes its
own entry, so a fixed preamble with varying tasks hits without the same
full prompt ever coming twice.

Entries are plain device tensors that nothing writes in place: in the
cache dtype, or dequantized in fp32 when the cache is int8 (``nbytes``
counts them as held), so that installing an entry quantizes it back to
the bytes it was exported from. The
bookkeeping rides the radix index (``engine/kvcache/radix.py``): ``match``
and ``has`` are one O(len) walk, and eviction removes one scored victim
per overflow, under the ``"cost"`` policy (recency weighted by the
prefill saved per byte held) by default in the engine.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

from pilottai_tpu_torch.engine.kvcache.policy import eviction_score, validate_policy
from pilottai_tpu_torch.engine.kvcache.radix import RadixTree


class PrefixEntry:
    __slots__ = ("ids", "ks", "vs", "p_bucket", "stamp")

    def __init__(self, ids: Tuple[int, ...], ks: Any, vs: Any, p_bucket: int):
        self.ids = ids          # true tokens (len <= p_bucket)
        self.ks = ks            # [L, K, p_bucket, H] device tensor (fp32 for an int8 cache)
        self.vs = vs
        self.p_bucket = p_bucket
        self.stamp = 0

    @property
    def nbytes(self) -> int:
        return sum(int(getattr(t, "nbytes", 0)) for t in (self.ks, self.vs))


class PrefixStore:
    """Radix-indexed store of cached prompt-prefix K/V panels.

    ``min_len`` is the entry floor (``engine_prefix_min_len``, default the
    64-token prompt bucket): an entry stores the admitted prompt minus its
    last token (``match`` needs a proper prefix, whose tail token gives the
    first-token logits), so only prompts of at least ``min_len + 1``
    tokens ever cache; the batcher warns once when it sees a shorter one.
    ``max_len`` caps an entry's rows, and so its device memory."""

    def __init__(self, capacity: int = 8, min_len: int = 64,
                 max_len: int = 1024, policy: str = "lru",
                 on_evict: Optional[Callable[[PrefixEntry], None]] = None) -> None:
        self.capacity = capacity
        self.policy = validate_policy(policy, "prefix-store")
        self.min_len = min_len
        self.max_len = max_len
        self.on_evict = on_evict
        self._tree = RadixTree()
        self._clock = 0

    def __len__(self) -> int:
        return len(self._tree)

    def entries(self) -> List[PrefixEntry]:
        return [entry for _, entry in self._tree.items()]

    def _touch(self, e: PrefixEntry) -> None:
        self._clock += 1
        e.stamp = self._clock

    def match(self, ids: Sequence[int]) -> Optional[PrefixEntry]:
        """Longest entry that is a proper prefix of ``ids`` (at least one
        tail token must remain for the first-token logits). One O(len)
        radix walk."""
        node = self._tree.longest_payload_prefix(ids, proper=True)
        if node is None:
            return None
        entry = node.payload
        self._touch(entry)
        return entry

    def has(self, ids: Sequence[int]) -> bool:
        return self._tree.has(ids)

    def lcp_candidates(self, ids: Sequence[int]) -> List[int]:
        """Lengths of longest common prefixes with stored entries worth
        storing as derived entries (at least ``min_len``, not stored yet,
        shorter than the entries they were read off)."""
        return self._tree.lcp_candidates(ids, self.min_len)

    def _score(self, e: PrefixEntry) -> float:
        return eviction_score(e.stamp, len(e.ids), e.p_bucket, self.policy)

    def store(self, ids: Sequence[int], ks: Any, vs: Any, p_bucket: int) -> None:
        ids = tuple(ids)
        if not (self.min_len <= len(ids) <= self.max_len):
            return
        if self._tree.has(ids):
            return
        e = PrefixEntry(ids, ks, vs, p_bucket)
        self._touch(e)
        self._tree.insert(ids, e)
        while len(self._tree) > self.capacity:
            victim = min((entry for _, entry in self._tree.items()), key=self._score)
            self._tree.remove(victim.ids)
            if self.on_evict is not None:
                self.on_evict(victim)

    def clear(self) -> None:
        self._tree = RadixTree()
