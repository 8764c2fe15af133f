"""The prefix cache's index structures (the port's counterpart of
``pilottai_tpu/engine/kvcache/``): the token radix, the eviction policy
and the device tier of the one lookup over the dense store and the paged
page index. The host tier, spills, restores and session export come with
ROADMAP P7."""
