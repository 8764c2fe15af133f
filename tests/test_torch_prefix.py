"""Slice P2, the prefix cache, on the CPU against the JAX package: the
radix tree, the dense ``PrefixStore`` and the paged ``PagePrefixIndex``
under one scripted sequence of calls; the tail attention through K1 (its
plain version here) against the JAX ``_tail_prefix_attn``; the dense and
paged prefix admissions against the JAX functions; and the protocol-s
engine in fp32 with the cache on against the JAX engine with the cache
on. The JAX package's own prefix-cache tests that need neither
speculation nor a mesh run here against the port as parametrised cases.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.engine import decode as jdecode
from pilottai_tpu.engine import sampling as jsampling
from pilottai_tpu.engine.kvcache.radix import RadixTree as JRadixTree
from pilottai_tpu.engine.page_prefix import PagePrefixIndex as JPagePrefixIndex
from pilottai_tpu.engine.prefix_cache import PrefixStore as JPrefixStore
from pilottai_tpu.models import common as jcommon
from pilottai_tpu.models import registry as jregistry
from pilottai_tpu.ops import kvcache as jkvcache
from pilottai_tpu.ops import paged as jpaged
from pilottai_tpu_torch import PROTOCOL_S_NPZ, LLMConfig, LLMHandler
from pilottai_tpu_torch.engine import decode, sampling
from pilottai_tpu_torch.engine.batcher import ContinuousBatcher, GenRequest
from pilottai_tpu_torch.engine.kvcache.radix import RadixTree
from pilottai_tpu_torch.engine.page_prefix import PagePrefixIndex
from pilottai_tpu_torch.engine.prefix_cache import PrefixStore
from pilottai_tpu_torch.engine.types import ChatMessage, GenerationParams, ToolSpec
from pilottai_tpu_torch.models import registry
from pilottai_tpu_torch.models.loader import ASSETS, load_npz, params_from_numpy
from pilottai_tpu_torch.ops import paged
from pilottai_tpu_torch.ops.kvcache import KVCache

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are small: one intra-op thread is as fast and does
    not oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# The index structures: one scripted sequence on both packages
# --------------------------------------------------------------------- #

def _sequences(rng, n, bases, lo=2, hi=40):
    """``n`` token sequences that share heads: each a random base's first
    part, then a random run from a small alphabet."""
    out = []
    for _ in range(n):
        base = bases[rng.integers(len(bases))]
        head = base[: rng.integers(0, len(base) + 1)]
        out.append(tuple(head) + tuple(int(t) for t in rng.integers(1, 6, rng.integers(lo, hi))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_tree_matches_jax_under_a_scripted_sequence(seed):
    """Inserts, removals, longest proper-prefix matches and LCP candidates
    give the same answers on both trees."""
    rng = np.random.default_rng(seed)
    bases = [tuple(int(t) for t in rng.integers(1, 6, 30)) for _ in range(3)]
    seqs = _sequences(rng, 60, bases)
    ours, theirs = RadixTree(), JRadixTree()
    log = []
    for i, ids in enumerate(seqs):
        op = rng.integers(4)
        for tree in (ours, theirs):
            if op == 0:
                tree.insert(ids, i)
            elif op == 1 and len(tree):
                key = sorted(tree.keys())[i % len(tree)]
                tree.remove(key)
        # The sequence itself, and an earlier one run on: some queries hit.
        for query in (ids, seqs[rng.integers(i + 1)] + (1, 2)):
            node_o = ours.longest_payload_prefix(query)
            node_t = theirs.longest_payload_prefix(query)
            log.append((op, None if node_o is None else (node_o.key_len, node_o.payload)))
            assert (None if node_t is None else (node_t.key_len, node_t.payload)) == log[-1][1]
            assert ours.lcp_candidates(query, 4) == theirs.lcp_candidates(query, 4)
        assert sorted(ours.keys()) == sorted(theirs.keys())
    assert any(entry[1] is not None for entry in log)


@pytest.mark.parametrize("policy", ["cost", "lru"])
@pytest.mark.parametrize("seed", [0, 1])
def test_prefix_store_matches_jax_under_a_scripted_sequence(seed, policy):
    """Stores with derived LCP entries, proper-prefix matches and eviction
    under capacity: the same matches, candidates and victims, in order."""
    rng = np.random.default_rng(seed)
    bases = [tuple(int(t) for t in rng.integers(1, 6, 24)) for _ in range(2)]
    victims = {"ours": [], "theirs": []}
    ours = PrefixStore(capacity=3, min_len=4, max_len=32, policy=policy,
                       on_evict=lambda e: victims["ours"].append(e.ids))
    theirs = JPrefixStore(capacity=3, min_len=4, max_len=32, policy=policy,
                          on_evict=lambda e: victims["theirs"].append(e.ids))

    def bucket(n):
        return max(8, 1 << (n - 1).bit_length())

    matched = 0
    for ids in _sequences(rng, 50, bases, lo=1, hi=20):
        got = [s.match(ids) for s in (ours, theirs)]
        assert [None if e is None else e.ids for e in got] == [
            None if got[1] is None else got[1].ids] * 2
        matched += got[0] is not None
        key = ids[:-1][:32]
        for s in (ours, theirs):
            s.store(key, "k", "v", bucket(len(key)))
        lcps = [s.lcp_candidates(key) for s in (ours, theirs)]
        assert lcps[0] == lcps[1]
        for p in lcps[0]:
            for s in (ours, theirs):
                s.store(key[:p], "k", "v", bucket(p))
        assert len(ours) == len(theirs)
        assert all(ours.has(e.ids) for e in ours.entries())
    assert victims["ours"] == victims["theirs"] and victims["ours"]
    assert matched > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_index_matches_jax_under_a_scripted_sequence(seed):
    """Allocation with matched chains, registration, releases, capacity
    and pressure evictions with a protected chain: the same matches,
    victims, pinned pages, refcounts and free lists on both sides."""
    rng = np.random.default_rng(seed)
    P, n_slots, num_pages = 4, 4, 41
    sides = {}
    for name, alloc_cls, index_cls in (("ours", paged.PageAllocator, PagePrefixIndex),
                                       ("theirs", jpaged.PageAllocator, JPagePrefixIndex)):
        alloc = alloc_cls(num_pages, P, n_slots, 12)
        index = index_cls(P, capacity_pages=10)
        evicted = []
        index.on_evict = lambda toks, page, evicted=evicted: evicted.append((toks, page))
        sides[name] = (alloc, index, evicted)
    bases = [tuple(int(t) for t in rng.integers(1, 4, 24)) for _ in range(3)]
    held = []
    for step, ids in enumerate(_sequences(rng, 60, bases, lo=1, hi=16)):
        obs = {}
        for name, (alloc, index, evicted) in sides.items():
            node = index.match(ids)
            chain = tuple(node.path_pages) if node is not None else ()
            need = len(ids) + 3
            free_slots = [s for s in range(n_slots) if s not in held]
            ok = False
            if free_slots:
                slot = free_slots[0]
                ok = alloc.allocate(slot, need, prefix_pages=chain)
                if not ok:
                    short = alloc.pages_needed(need) - len(chain) - alloc.free_pages
                    if short > 0 and index.evict(short, alloc, protect=frozenset(chain)):
                        ok = alloc.allocate(slot, need, prefix_pages=chain)
                if ok:
                    nb = len(ids) // P
                    if nb:
                        index.register(ids[: nb * P], [int(p) for p in alloc.table[slot, :nb]],
                                       alloc)
            obs[name] = (chain, ok, index.pinned_pages, list(alloc.free), alloc.refs.tolist(),
                         list(evicted))
        assert obs["ours"] == obs["theirs"], step
        if obs["ours"][1]:
            held.append(free_slots[0])
        if len(held) > 2 or (held and rng.integers(3) == 0):
            slot = held.pop(int(rng.integers(len(held))))
            for alloc, _, _ in sides.values():
                alloc.release(slot)
    assert sides["ours"][2], "no eviction happened"


# The JAX package's unit cases (tests/test_prefix_cache.py and
# tests/test_paged_prefix.py), run against the port's classes.

def _case_store_match_and_lru():
    s = PrefixStore(capacity=2, min_len=4, max_len=64)
    a = tuple(range(10, 30))
    b = tuple(range(40, 56))
    s.store(a, "ka", "va", 32)
    s.store(b, "kb", "vb", 16)
    assert s.match(list(a) + [1, 2]).ids == a
    assert s.match(list(a)[:8]) is None or len(s.match(list(a)[:8]).ids) <= 8
    assert s.match(list(b)) is None  # exact length: no tail left
    s.match(list(a) + [1])
    s.store(tuple(range(70, 90)), "kc", "vc", 32)
    assert s.has(a) and not s.has(b)


def _case_store_lcp_candidates():
    s = PrefixStore(capacity=4, min_len=4, max_len=64)
    base = tuple(range(100, 120))
    s.store(base + (1, 2, 3), "k", "v", 32)
    assert s.lcp_candidates(base + (7, 8, 9)) == [len(base)]


def _case_index_match_is_proper_prefix_and_block_granular():
    alloc = paged.PageAllocator(num_pages=17, page_size=4, n_slots=4, max_pages_per_slot=8)
    idx = PagePrefixIndex(page_size=4, capacity_pages=8)
    ids = list(range(100, 116))
    assert alloc.allocate(0, len(ids) + 4)
    pages = [int(p) for p in alloc.table[0, :4]]
    idx.register(ids, pages, alloc)
    node = idx.match(ids)
    assert node is not None and node.depth == 3
    assert list(node.path_pages) == pages[:3]
    assert idx.match(ids + [7, 8]).depth == 4
    assert idx.match(ids[:6] + [999] * 10).depth == 1
    assert idx.match([999] * 16) is None


def _case_allocator_refcounts_shared_pages():
    alloc = paged.PageAllocator(num_pages=9, page_size=4, n_slots=4, max_pages_per_slot=8)
    assert alloc.allocate(0, 8)
    shared = [int(p) for p in alloc.table[0, :2]]
    for p in shared:
        alloc.pin(p)
    alloc.release(0)
    assert alloc.free_pages == 8 - 2
    assert alloc.allocate(1, 12, prefix_pages=shared)
    assert list(alloc.table[1, :2]) == shared
    alloc.release(1)
    assert alloc.free_pages == 8 - 2
    for p in shared:
        alloc.unpin(p)
    assert alloc.free_pages == 8


def _case_index_eviction_respects_protect_and_leaves():
    alloc = paged.PageAllocator(num_pages=17, page_size=2, n_slots=4, max_pages_per_slot=8)
    idx = PagePrefixIndex(page_size=2, capacity_pages=16)
    assert alloc.allocate(0, 8)
    pages = [int(p) for p in alloc.table[0, :4]]
    idx.register(list(range(8)), pages, alloc)
    alloc.release(0)
    free0 = alloc.free_pages
    assert idx.evict(4, alloc, protect=frozenset(pages)) == 0
    assert idx.evict(2, alloc) == 2
    assert alloc.free_pages == free0 + 2
    assert idx.match(list(range(8)) + [1]).depth == 2


def _case_index_capacity_bounds_pins():
    alloc = paged.PageAllocator(num_pages=33, page_size=2, n_slots=4, max_pages_per_slot=16)
    idx = PagePrefixIndex(page_size=2, capacity_pages=3)
    assert alloc.allocate(0, 16)
    pages = [int(p) for p in alloc.table[0, :8]]
    idx.register(list(range(16)), pages, alloc)
    assert idx.pinned_pages <= 3
    alloc.release(0)


UNIT_CASES = {
    "store_match_and_lru": _case_store_match_and_lru,
    "store_lcp_candidates": _case_store_lcp_candidates,
    "index_match_is_proper_prefix_and_block_granular":
        _case_index_match_is_proper_prefix_and_block_granular,
    "allocator_refcounts_shared_pages": _case_allocator_refcounts_shared_pages,
    "index_eviction_respects_protect_and_leaves": _case_index_eviction_respects_protect_and_leaves,
    "index_capacity_bounds_pins": _case_index_capacity_bounds_pins,
}


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_jax_unit_case_on_the_port(case):
    UNIT_CASES[case]()


# --------------------------------------------------------------------- #
# The tail's attention: one K1 launch against the JAX two-part merge
# --------------------------------------------------------------------- #

# (N, K, H): protocol-s, and a llama-like head (H 64, G 4).
WIDTHS = {"protocol_s": (8, 4, 32), "llama_like": (8, 2, 64)}
# bf16: the port rounds p to bf16 before p·v (the kernel against the row's
# running max, its plain version against the row max) and its output once
# more; the reference keeps both in fp32. The limit is about twice the
# largest reading over these cases drawn from seeds 7-10 (3.75e-3 of max
# |ref|; fp32 read 5.7e-7 at most).
TAIL_TOL = {"float32": 1e-5, "bfloat16": 8e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["global", "window_softcap"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_tail_prefix_attention_matches_jax(width, mode, dtype):
    """The port's tail attention (prefix and tail as one key set through
    K1, here its plain version) against the JAX function's prefix
    statistics merged with the tail's causal block, on a padded prefix
    panel, ragged tails and an empty-tail padding row."""
    N, Kh, H = WIDTHS[width]
    window, softcap = (0, 0.0) if mode == "global" else (24, 20.0)
    A, T, plen, Pp = 3, 16, 40, 64
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((A, T, N, H), (A, T, Kh, H), (A, T, Kh, H)))
    pk, pv = (rng.normal(size=(Kh, Pp, H)).astype(np.float32) for _ in range(2))
    valid = np.array([16, 9, 1], np.int32)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    def t(x):
        return torch.from_numpy(x).to(tdt)

    # The JAX function in fp32 on the same (bf16-rounded) inputs: XLA's CPU
    # backend has no bf16 x bf16 -> fp32 product, so in bf16 the reference
    # keeps p in fp32 where the port rounds it.
    q, k, v, pk, pv = (t(x).float().numpy() for x in (q, k, v, pk, pv))
    G = N // Kh
    ref = jdecode._tail_prefix_attn(
        jnp.asarray(q).reshape(A, T, Kh, G, H).transpose(0, 2, 3, 1, 4),
        jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(k).transpose(0, 2, 1, 3), jnp.asarray(v).transpose(0, 2, 1, 3),
        jnp.int32(plen), jnp.asarray(valid), H**-0.5, softcap, window,
    )
    ref = np.asarray(ref).reshape(A, T, N, H)

    got = decode._tail_prefix_attn(t(q), t(k), t(v), t(pk), t(pv), plen,
                                   torch.from_numpy(valid), H**-0.5, softcap, window)
    assert got.shape == (A, T, N, H) and got.dtype == tdt
    err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= TAIL_TOL[dtype], err


# --------------------------------------------------------------------- #
# Prefix admissions against the JAX functions (llama-tiny, fp32)
# --------------------------------------------------------------------- #

def _tiny():
    jcfg = jregistry.get_model_config("llama-tiny").replace(dtype=jnp.float32)
    cfg = registry.get_model_config("llama-tiny").replace(dtype=torch.float32)
    jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device=CPU)
    return cfg, params, jcfg, jparams


def _tails(rng, cfg, lens, Tt):
    tail = np.zeros((len(lens), Tt), np.int32)
    for row, n in enumerate(lens):
        tail[row, :n] = rng.integers(2, cfg.vocab_size, n)
    return tail


def test_dense_prefix_admission_matches_jax():
    """``admit_group_prefix``: a group of two rows sharing one stored
    entry (a padded panel) — the tail logits, every slot's cache rows up
    to its length, the lengths and the first tokens equal the JAX
    function's."""
    cfg, params, jcfg, jparams = _tiny()
    rng = np.random.default_rng(11)
    L, Kh, H = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    n_slots, S, plen, pb, Tt = 3, 128, 40, 64, 16
    pks, pvs = (rng.normal(size=(L, Kh, pb, H)).astype(np.float32) for _ in range(2))
    lens = [11, 16]
    tail = _tails(rng, cfg, lens, Tt)
    slots = [2, 0]
    mi, mf = decode.pack_admit_meta(2, slots=slots, seeds=[3, 4], budgets=[7, 7], lens=lens,
                                    prefix_len=plen, pad_slot=n_slots)

    logits, _, _ = decode._tail_prefill(
        params, cfg, lambda l: (torch.from_numpy(pks[l]), torch.from_numpy(pvs[l])), plen,
        torch.from_numpy(tail).long(), torch.tensor(lens, dtype=torch.int32))
    jlogits, _, _ = jdecode._tail_prefill_core(
        jparams, jcfg, jnp.asarray(pks), jnp.asarray(pvs), jnp.int32(plen), jnp.asarray(tail),
        jnp.asarray(lens, np.int32), jnp.float32)
    for row, n in enumerate(lens):
        np.testing.assert_allclose(logits.numpy()[row, :n], np.asarray(jlogits)[row, :n],
                                   atol=1e-4, rtol=1e-4)

    cache = KVCache.create(L, n_slots, S, Kh, H, torch.float32, CPU)
    cache, dstate, _, first = decode.admit_group_prefix(
        params, cfg, cache, decode.DecodeState.create(n_slots, CPU),
        sampling.SamplingState.create(n_slots, CPU), torch.from_numpy(pks),
        torch.from_numpy(pvs), tail, mi, mf)
    full = np.zeros((2, 64), np.int32)
    jcache, jd, _, jfirst, _ = jdecode.admit_group_prefix(
        jparams, jcfg, jkvcache.KVCache.create(L, n_slots, S, Kh, H, dtype=jnp.float32),
        jdecode.DecodeState.create(n_slots), jsampling.SamplingState.create(n_slots),
        jnp.asarray(pks), jnp.asarray(pvs), jnp.asarray(tail), jnp.asarray(full),
        jnp.asarray(mi), jnp.asarray(mf))
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))
    assert [int(cache.lengths[s]) for s in slots] == [plen + n for n in lens]
    for l in range(L):
        for s in slots:
            n = int(cache.lengths[s])
            for ours, theirs in zip(cache.layers[l], jcache.layers[l]):
                np.testing.assert_allclose(ours[s, :, :n].numpy(), np.asarray(theirs)[s, :, :n],
                                           atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    np.testing.assert_array_equal(dstate.done.numpy(), np.asarray(jd.done))


def test_paged_prefix_admission_on_a_shared_chain_matches_jax():
    """``admit_group_prefix_paged``: two rows mapping one cached chain of
    three pages into their tables — the tail logits, the pools, the
    lengths and the first tokens equal the JAX function's, and the chain's
    pages are read, never written."""
    cfg, params, jcfg, jparams = _tiny()
    rng = np.random.default_rng(12)
    L, Kh, H = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    n_slots, Pg, max_pages, num_pages = 3, 16, 8, 25
    alloc = paged.PageAllocator(num_pages, Pg, n_slots, max_pages)
    assert alloc.allocate(2, 48)
    chain = [int(p) for p in alloc.table[2, :3]]
    cache = paged.PagedKVCache.create(L, n_slots, num_pages, Pg, Kh, H, torch.float32, CPU)
    pools = []
    for l in range(L):
        kv = [rng.normal(size=(Kh, num_pages, Pg, H)).astype(np.float32) for _ in range(2)]
        for pool, src in zip(cache.layers[l], kv):
            pool.copy_(torch.from_numpy(src))
        pools.append(tuple(jnp.asarray(x) for x in kv))
    jcache = jpaged.PagedKVCache.create(L, n_slots, num_pages, Pg, Kh, H, dtype=jnp.float32)
    jcache = jcache._replace(layers=tuple(pools))
    chain_before = [cache.layers[l][0][:, chain].clone() for l in range(L)]
    plen, lens, slots, Tt = 48, [13, 5], [0, 1], 16
    for s, n in zip(slots, lens):
        assert alloc.allocate(s, plen + n + 4, prefix_pages=chain)
    rows = alloc.table[slots].copy()
    pages = np.full((4,), alloc.sentinel, np.int32)
    pages[:3] = chain
    tail = _tails(rng, cfg, lens, Tt)
    mi, mf = decode.pack_admit_meta(2, slots=slots, seeds=[1, 2], budgets=[5, 5], lens=lens,
                                    prefix_len=plen, pad_slot=n_slots)

    logits, _, _ = decode._tail_prefill(
        params, cfg, decode._chain_layer(cache, torch.tensor(chain)), plen,
        torch.from_numpy(tail).long(), torch.tensor(lens, dtype=torch.int32))
    jlogits, _, _ = jdecode._chain_tail_prefill(
        jparams, jcfg, jcache, jnp.asarray(pages), jnp.int32(plen), jnp.asarray(tail),
        jnp.asarray(lens, np.int32), jnp.float32)
    for row, n in enumerate(lens):
        np.testing.assert_allclose(logits.numpy()[row, :n], np.asarray(jlogits)[row, :n],
                                   atol=1e-4, rtol=1e-4)

    cache, dstate, _, first = decode.admit_group_prefix_paged(
        params, cfg, cache, decode.DecodeState.create(n_slots, CPU),
        sampling.SamplingState.create(n_slots, CPU), pages, tail, rows, mi, mf)
    jcache, jd, _, jfirst, _ = jdecode.admit_group_prefix_paged(
        jparams, jcfg, jcache, jdecode.DecodeState.create(n_slots),
        jsampling.SamplingState.create(n_slots), jnp.asarray(pages), jnp.asarray(tail),
        jnp.asarray(np.zeros((2, 64), np.int32)), jnp.asarray(rows), jnp.asarray(mi),
        jnp.asarray(mf), n_prefix_bucket=4)
    live = [p for s in slots for p in alloc.table[s] if p != alloc.sentinel]
    for l in range(L):
        for ours, theirs in zip(cache.layers[l], jcache.layers[l]):
            np.testing.assert_allclose(ours[:, live].numpy(), np.asarray(theirs)[:, live],
                                       atol=1e-5, rtol=1e-5)
        assert torch.equal(cache.layers[l][0][:, chain], chain_before[l])
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    np.testing.assert_array_equal(dstate.done.numpy(), np.asarray(jd.done))


# --------------------------------------------------------------------- #
# The protocol-s engine in fp32 with the cache on, port against JAX
# --------------------------------------------------------------------- #

def _protocol_s_params():
    """The shipped checkpoint for both packages: bf16 bits, read as fp32."""
    import ml_dtypes

    z = np.load(PROTOCOL_S_NPZ)
    tree = {}
    for key in z.files:
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(z[key].view(ml_dtypes.bfloat16).astype(np.float32))
    jcfg = jregistry.get_model_config("protocol-s").replace(dtype=jnp.float32)
    cfg = registry.get_model_config("protocol-s").replace(dtype=torch.float32)
    return cfg, load_npz(PROTOCOL_S_NPZ, cfg, device=CPU, dtype=torch.float32), jcfg, tree


def _serve_raw(b, prompts, max_new, gen_request):
    """Each prompt (raw ids) in turn, greedy, on a started batcher."""
    b.start()
    try:
        return [b.submit(gen_request(prompt_ids=list(p), max_new_tokens=max_new, eos_id=-1))
                .result(timeout=300) for p in prompts]
    finally:
        b.stop()


def _engine_sequences():
    rng = np.random.default_rng(21)

    def ids(n):
        return [int(t) for t in rng.integers(5, 250, n)]

    head = ids(100)
    dense = [
        head,                          # cold: stored as head[:-1]
        head,                          # exact repeat: a one-token tail
        head[:80] + ids(20),           # shares 80 tokens: the LCP entry head[:80] derives
        head[:80] + ids(15),           # the LCP-derived hit
        head[:80] + ids(100),          # 80 + a 128-token tail bucket passes max_seq 192: a miss
    ]
    paged_seq = [
        head,                          # cold, segmented: 6 full pages pinned
        head[:64] + ids(40),           # maps 4 pages: block sharing, no full repeat
        head,                          # maps 6 pages (a proper prefix of 100)
        head[:32] + ids(98),           # maps 2 pages, then segments past the chain
    ]
    pressure = [ids(150) for _ in range(3)]  # 10 pages each on a 12-page pool
    return dense, paged_seq, pressure


def _jax_engine_runs(cfg, params, knobs, prompts, max_new):
    from pilottai_tpu.engine.batcher import ContinuousBatcher as JBatcher
    from pilottai_tpu.engine.batcher import GenRequest as JGenRequest
    from pilottai_tpu.utils.metrics import global_metrics

    b = JBatcher(cfg, params, cache_dtype=jnp.float32, **knobs)
    h0 = global_metrics.get("engine.prefix_hits")
    out = _serve_raw(b, prompts, max_new, JGenRequest)
    pinned = b.page_index.pinned_pages if b.page_index is not None else None
    free = b.alloc.free_pages if b.alloc is not None else None
    return out, global_metrics.get("engine.prefix_hits") - h0, pinned, free


ENGINE_KNOBS = {
    "dense": dict(n_slots=2, max_seq_len=192, chunk_size=8, prefix_cache=4),
    "paged": dict(n_slots=2, max_seq_len=256, chunk_size=8, prefix_cache=4, paged=True,
                  page_size=16, prefill_chunk=32),
    "pressure": dict(n_slots=2, max_seq_len=256, chunk_size=8, prefix_cache=4, paged=True,
                     page_size=16, num_pages=13),
}


@pytest.mark.parametrize("run", list(ENGINE_KNOBS))
def test_protocol_s_engine_with_the_cache_matches_jax(run):
    """Greedy ids, hits and pinned pages of the port's batcher with the
    cache on equal the JAX batcher's with the cache on: dense — an exact
    repeat, an LCP-derived hit and an oversized hit that must miss;
    paged — block sharing without a full repeat, a full chain, and a
    chain whose rest is segmented; a 12-page pool under pressure that
    unpins cached pages before a request waits, with every page back on
    the free list or pinned after."""
    cfg, params, jcfg, jparams = _protocol_s_params()
    dense, paged_seq, pressure = _engine_sequences()
    prompts = {"dense": dense, "paged": paged_seq, "pressure": pressure}[run]
    knobs = ENGINE_KNOBS[run]
    theirs, j_hits, j_pinned, j_free = _jax_engine_runs(jcfg, jparams, knobs, prompts, 6)
    b = ContinuousBatcher(cfg, params, CPU, **knobs)
    ours = _serve_raw(b, prompts, 6, GenRequest)
    assert ours == theirs
    assert b.prefix_admitted == j_hits
    assert b.prefix_lookups == len(prompts)
    if run == "dense":
        # The exact repeat and the LCP-derived hit; the oversized one missed.
        assert b.prefix_admitted == 2 and b.prefix_hits == 2
        assert b.prefix_store.has(tuple(dense[0][:80]))
        assert b.prefix_export_failures == 0
    else:
        assert b.page_index.pinned_pages == j_pinned and b.alloc.free_pages == j_free
        assert b.alloc.free_pages + b.page_index.pinned_pages == b.num_pages - 1
    if run == "paged":
        assert b.prefix_hits == 3 and b.prefix_admitted == 2
        # 100 tokens in 32s: 3 segments; the chained one: (130 - 32) in 3.
        assert b.prefill_segments == 3 + 3
    if run == "pressure":
        assert b.page_index.pinned_pages == 3


GOLDEN_ASSETS = {"dense": "protocol_s_golden.json", "paged": "protocol_s_paged_golden.json"}


@pytest.mark.parametrize("cache", list(GOLDEN_ASSETS))
def test_golden_served_twice_with_the_cache_on(cache):
    """The golden cases at the port's defaults (prefix cache on), each
    served twice in a row: both servings give the JAX engine's golden ids,
    every second serving finds a cached prefix, and every page is back or
    pinned."""
    golden = json.loads((ASSETS / GOLDEN_ASSETS[cache]).read_text())

    async def serve():
        handler = LLMHandler(LLMConfig(
            provider="cpu", model_name="protocol-s", checkpoint_path=PROTOCOL_S_NPZ,
            sampling={"temperature": 0.0, "max_new_tokens": golden["max_new_tokens"]},
            **golden["engine"]))
        await handler.start()
        batcher = handler.backend.batcher
        out = []
        try:
            for case in golden["cases"]:
                p = golden["prompts"][case["prompt"]]
                for _ in range(2):
                    r = await handler.generate_response(
                        [ChatMessage(**m) for m in p["messages"]],
                        tools=[ToolSpec(**t) for t in p["tools"]] if p["tools"] else None,
                        json_mode=case["json_mode"])
                    out.append(r.content)
        finally:
            await handler.stop()
        return out, batcher

    out, b = asyncio.run(serve())
    assert out == [c["text"] for c in golden["cases"] for _ in range(2)]
    assert b.prefix_hits >= len(golden["cases"]) and b.prefix_export_failures == 0
    if b.paged:
        assert b.alloc.free_pages + b.page_index.pinned_pages == b.num_pages - 1
        assert b.page_index.pinned_pages <= (b.num_pages - 1) // 4
    else:
        assert 0 < len(b.prefix_store) <= 4


# --------------------------------------------------------------------- #
# The JAX package's engine cases, on the port (llama-tiny, fp32)
# --------------------------------------------------------------------- #

LONG = ("You are the orchestrator. Analyze the task and respond with "
        "strict JSON as instructed by the rules preamble. Task: ")


async def _handler_run(prompts, max_new=12, **knobs):
    h = LLMHandler(LLMConfig(provider="cpu", model_name="llama-tiny", dtype="float32",
                             engine_slots=4, engine_max_seq=256, engine_chunk=4, **knobs))
    await h.start()
    try:
        outs = [(await h.generate_response(
            [ChatMessage(content=p)],
            params=GenerationParams(max_new_tokens=max_new, temperature=0.0))).content
            for p in prompts]
        return outs, h.backend.batcher
    finally:
        await h.stop()


def _case_hit_output_identical_to_cold_engine():
    prompt = LONG + "summarize the report"
    (want,), _ = asyncio.run(_handler_run([prompt], engine_prefix_cache=0))
    outs, b = asyncio.run(_handler_run([prompt, prompt], engine_prefix_cache=8))
    assert outs == [want, want]
    assert b.prefix_admitted >= 1


def _case_lcp_entry_serves_shared_preamble():
    prompts = [LONG + "first task", LONG + "second very different task", LONG + "third task"]
    _, b = asyncio.run(_handler_run(prompts, max_new=8, engine_prefix_cache=8))
    assert b.prefix_admitted >= 1, "shared-preamble LCP entry never formed"


def _case_paged_prefix_hit_identical_to_cold_dense():
    prompt = LONG + "summarize the quarterly report"
    (want,), _ = asyncio.run(_handler_run([prompt], max_new=14, engine_prefix_cache=0))
    outs, b = asyncio.run(_handler_run([prompt] * 3, max_new=14, engine_paged_kv=True,
                                       engine_page_size=16, engine_prefix_cache=8))
    assert outs == [want] * 3
    assert b.prefix_admitted >= 1 and b.page_index.pinned_pages >= 1


def _case_paged_block_sharing_without_full_repeat():
    (want3,), _ = asyncio.run(_handler_run([LONG + "third unseen task"], max_new=14,
                                           engine_prefix_cache=0))
    outs, b = asyncio.run(_handler_run(
        [LONG + "first task", LONG + "second very different task", LONG + "third unseen task"],
        max_new=14, engine_paged_kv=True, engine_page_size=16, engine_prefix_cache=8))
    assert b.prefix_admitted >= 1, "shared page-aligned preamble never hit"
    assert outs[2] == want3


def _case_paged_prefix_pressure_evicts_not_starves():
    async def main():
        h = LLMHandler(LLMConfig(
            provider="cpu", model_name="llama-tiny", dtype="float32", engine_slots=2,
            engine_max_seq=512, engine_chunk=4, engine_paged_kv=True, engine_page_size=16,
            engine_kv_pages=13, engine_prefix_cache=8))
        await h.start()
        try:
            outs = [(await h.generate_response(
                [ChatMessage(content=f"task number {i}: " + "pad " * 30)],
                params=GenerationParams(max_new_tokens=8, temperature=0.0))).content
                for i in range(5)]
            return outs, h.backend.batcher
        finally:
            await h.stop()

    outs, b = asyncio.run(main())
    assert all(isinstance(o, str) for o in outs)
    assert b.alloc.free_pages + b.page_index.pinned_pages == b.num_pages - 1


def _tiny_batcher_outputs(prefix_cache, prompts, max_seq, max_new):
    cfg = registry.get_model_config("llama-tiny").replace(dtype=torch.float32)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jcommon.init_params(
            jregistry.get_model_config("llama-tiny"), jax.random.PRNGKey(0), dtype=jnp.float32)),
        cfg, device=CPU)
    b = ContinuousBatcher(cfg, params, CPU, n_slots=2, max_seq_len=max_seq, chunk_size=4,
                          prefix_cache=prefix_cache)
    return _serve_raw(b, prompts, max_new, GenRequest), b


def _case_prefix_extension_hit_identical():
    base = [(i % 90) + 5 for i in range(80)]
    longer = base + [7, 9, 11, 13, 9, 7]
    (want,), _ = _tiny_batcher_outputs(0, [longer], 256, 10)
    (_, got), b = _tiny_batcher_outputs(8, [base, longer], 256, 10)
    assert len(b.prefix_store) >= 1 and b.prefix_admitted >= 1
    assert got == want


def _case_oversized_hit_falls_back_to_full_prefill():
    base = [(i % 90) + 5 for i in range(80)]
    big = base + [(i % 50) + 7 for i in range(38)]
    (want,), _ = _tiny_batcher_outputs(0, [big], 128, 6)
    (_, got), b = _tiny_batcher_outputs(8, [base, big], 128, 6)
    assert got == want
    assert b.prefix_admitted == 0 and b.prefix_lookups == 2


ENGINE_CASES = {
    "hit_output_identical_to_cold_engine": _case_hit_output_identical_to_cold_engine,
    "lcp_entry_serves_shared_preamble": _case_lcp_entry_serves_shared_preamble,
    "paged_prefix_hit_identical_to_cold_dense": _case_paged_prefix_hit_identical_to_cold_dense,
    "paged_block_sharing_without_full_repeat": _case_paged_block_sharing_without_full_repeat,
    "paged_prefix_pressure_evicts_not_starves": _case_paged_prefix_pressure_evicts_not_starves,
    "prefix_extension_hit_identical": _case_prefix_extension_hit_identical,
    "oversized_hit_falls_back_to_full_prefill": _case_oversized_hit_falls_back_to_full_prefill,
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_jax_engine_case_on_the_port(case):
    ENGINE_CASES[case]()
