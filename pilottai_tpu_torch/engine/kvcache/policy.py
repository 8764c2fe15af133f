"""Eviction policy of the prefix cache (the port's own copy of
``pilottai_tpu/engine/kvcache/policy.py``).

One definition of the eviction score, used by the dense store
(``engine/prefix_cache.py``) and the host tier (``kvcache/host_tier.py``)
under ``engine_kvcache_policy`` ("cost" or "lru"), so the two tiers cannot
drift apart.
"""

from __future__ import annotations

POLICIES = ("cost", "lru")


def validate_policy(policy: str, who: str) -> str:
    if policy not in POLICIES:
        raise ValueError(
            f"unknown {who} policy {policy!r}; supported: "
            + ", ".join(repr(p) for p in POLICIES)
        )
    return policy


def eviction_score(stamp: int, tokens: int, rows: int, policy: str) -> float:
    """Smaller = evicted first. ``lru`` is plain recency; ``cost``
    weighs recency by reconstruction-cost density — prefill FLOPs saved
    scale with true ``tokens``, bytes held with padded ``rows``, and the
    per-model constants cancel within one engine, leaving tokens/rows in
    (0, 1] mapped to a [0.5, 1.0] recency multiplier."""
    if policy == "lru":
        return float(stamp)
    density = tokens / max(rows, 1)
    return float(stamp) * (0.5 + 0.5 * density)


__all__ = ["POLICIES", "eviction_score", "validate_policy"]
