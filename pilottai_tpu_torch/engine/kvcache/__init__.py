"""The KV cache tier (the port's counterpart of
``pilottai_tpu/engine/kvcache/``): the token radix, the eviction policy,
the host-RAM tier that evicted prefix K/V spills to (``host_tier``), the
integrity frame of its entries and exports (``integrity``), and the one
lookup over the device tier and the host tier (``index``), which restores
a spilled prefix instead of prefilling it again.
"""

from pilottai_tpu_torch.engine.kvcache.host_tier import HostEntry, HostTier, SpillCopy
from pilottai_tpu_torch.engine.kvcache.radix import RadixNode, RadixTree

__all__ = [
    "HostEntry",
    "HostTier",
    "KVCacheIndex",
    "PendingRestore",
    "RadixNode",
    "RadixTree",
    "SpillCopy",
]


def __getattr__(name):
    # The index imports the cache ops; the radix and the host tier are
    # enough for everything else.
    if name in ("KVCacheIndex", "PendingRestore"):
        from pilottai_tpu_torch.engine.kvcache import index as _index

        return getattr(_index, name)
    raise AttributeError(name)
