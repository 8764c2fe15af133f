"""Slice P7, the KV cache tier, on the CPU against the JAX package: the
integrity frame (checksums and headers on the same arrays, exports that
cross between the packages in both directions, tampered, newer-version
and drifted entries refused and counted), the host tier and the radix
under one scripted sequence of calls on both packages and both policies,
the page gather's int8 round trip, the eviction hook's device-fault rule,
the two configuration knobs and the session id from the handler to the
request. Mirrors ``tests/test_kv_integrity.py`` and the unit half of
``tests/test_kvcache.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pilottai_tpu.engine.kvcache import integrity as jintegrity
from pilottai_tpu.engine.kvcache.host_tier import HostTier as JHostTier
from pilottai_tpu.engine.kvcache.index import KVCacheIndex as JKVCacheIndex
from pilottai_tpu.engine.kvcache.index import _gather_page_fn as jgather_page
from pilottai_tpu.engine.kvcache.radix import RadixTree as JRadixTree
from pilottai_tpu.ops import paged as jpaged
from pilottai_tpu_torch.core.config import LLMConfig, NotInSlice
from pilottai_tpu_torch.engine.kvcache import integrity
from pilottai_tpu_torch.engine.kvcache.host_tier import HostTier
from pilottai_tpu_torch.engine.kvcache.index import KVCacheIndex, gather_page
from pilottai_tpu_torch.engine.kvcache.radix import RadixTree
from pilottai_tpu_torch.engine.page_prefix import PagePrefixIndex
from pilottai_tpu_torch.ops import paged
from pilottai_tpu_torch.ops.kvcache import dequantize_kv, quantize_kv
from pilottai_tpu_torch.reliability.inject import global_injector
from pilottai_tpu_torch.utils.metrics import global_metrics

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_injector():
    global_injector.reset()
    yield
    global_injector.reset()


def _arrays(seed=0, n=48, dtype=np.float32):
    rng = np.random.RandomState(seed)
    ks = rng.randn(2, 2, n, 4)
    vs = rng.randn(2, 2, n, 4)
    if dtype == np.int8:
        return (rng.randint(-127, 128, ks.shape).astype(np.int8),
                rng.randint(-127, 128, vs.shape).astype(np.int8))
    return ks.astype(dtype), vs.astype(dtype)


def _failures():
    return global_metrics.get("engine.kvcache.integrity_failures")


# --------------------------------------------------------------------- #
# The frame: the same checksum and header as the JAX package
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [np.float32, np.int8], ids=["fp32", "int8"])
def test_checksum_and_header_equal_the_jax_package(dtype):
    """The same arrays, as numpy arrays and as CPU tensors, give the JAX
    package's CRC and header; a one-byte flip changes the CRC."""
    ks, vs = _arrays(dtype=dtype)
    crc = jintegrity.kv_checksum([ks, vs])
    head = jintegrity.entry_header([ks, vs], kind="dense")
    tensors = [torch.from_numpy(ks.copy()), torch.from_numpy(vs.copy())]
    assert integrity.kv_checksum([ks, vs]) == integrity.kv_checksum(tensors) == crc
    assert integrity.entry_header([ks, vs], "dense") == integrity.entry_header(tensors, "dense") \
        == head
    assert integrity.header_matches(head, tensors) and jintegrity.header_matches(
        integrity.entry_header(tensors, "page") | {"kind": "dense"}, [ks, vs])
    before = tensors[1].clone()
    integrity.corrupt_arrays(tensors[1:])
    flipped = (tensors[1].reshape(-1).view(torch.uint8) != before.reshape(-1).view(torch.uint8))
    assert int(flipped.sum()) == 1
    assert integrity.kv_checksum(tensors) != crc
    copy = [ks.copy(), vs.copy()]
    integrity.corrupt_arrays(copy)
    assert integrity.kv_checksum(copy) != crc == jintegrity.kv_checksum([ks, vs])


@pytest.mark.parametrize("size", [2 * integrity.CRC_CHUNK, 5 * integrity.CRC_CHUNK + 12345])
def test_a_large_array_is_checked_in_parallel_chunks_to_zlibs_crc(size):
    """Arrays of two chunks or more are checked in parallel pieces, whose
    CRCs combine to zlib's CRC-32 of the whole bytes (the JAX package's)."""
    rng = np.random.default_rng(size)
    big = rng.integers(0, 256, size, dtype=np.uint8)
    small = rng.integers(0, 256, 999, dtype=np.uint8)
    want = jintegrity.kv_checksum([small, big, small])
    assert integrity.kv_checksum([small, big, small]) == want
    assert integrity.kv_checksum([torch.from_numpy(small), torch.from_numpy(big),
                                  torch.from_numpy(small)]) == want


def test_bf16_frame_names_bfloat16_and_checks_the_same_bytes():
    """A bf16 payload stays a CPU tensor (numpy has no bfloat16 without
    ml_dtypes); its header says "bfloat16" and its CRC runs over the same
    raw bytes as the JAX package's bfloat16 array."""
    ks, vs = _arrays(seed=4)
    jk = np.asarray(jnp.asarray(ks, jnp.bfloat16))
    jv = np.asarray(jnp.asarray(vs, jnp.bfloat16))
    tk = torch.from_numpy(ks).to(torch.bfloat16)
    tv = torch.from_numpy(vs).to(torch.bfloat16)
    assert integrity.kv_checksum([tk, tv]) == jintegrity.kv_checksum([jk, jv])
    assert integrity.entry_header([tk, tv], "page") == jintegrity.entry_header([jk, jv], "page")
    assert integrity.entry_header([tk, tv], "page")["dtype"] == ["bfloat16", "bfloat16"]


def test_host_entry_sealed_at_spill_catches_rot():
    idx = KVCacheIndex(host_bytes=1 << 20)
    ks, vs = (torch.from_numpy(a) for a in _arrays(n=48))
    key = tuple(range(48))
    assert idx.host.put(key, (ks, vs), tokens=48, rows=48, kind="dense")
    e = idx.host.get(key)
    assert integrity.header_matches(e.header, e.copy.wait())
    assert e.copy.verify()
    integrity.corrupt_arrays(list(e.copy.wait()))
    assert not e.copy.verify()


# --------------------------------------------------------------------- #
# Exports cross between the packages
# --------------------------------------------------------------------- #

def _jax_export(session="sess-i"):
    src = JKVCacheIndex(host_bytes=1 << 20)
    ks, vs = _arrays(seed=3, n=70)
    key = tuple(range(70, 140))
    assert src.host.put(key, (ks, vs), tokens=70, rows=70, kind="dense")
    pk, pv = _arrays(seed=5, n=16)
    assert src.host.put(key[:16], (pk, pv), tokens=16, rows=16, meta=0, kind="page")
    src.host.note_session(session, key + (7, 8))
    export = src.export_session(session)
    assert export is not None and len(export["entries"]) == 2
    return export


def test_a_jax_export_imports_into_the_port_and_back():
    """A JAX fp32 export lands in the port's host tier, every entry framed
    (``frame_ok``); the port's export of that session imports into the JAX
    package, framed there too, with the same keys, bytes and metadata."""
    export = _jax_export()
    for e in export["entries"]:
        assert integrity.frame_ok(e, (e["k"], e["v"]))
    port = KVCacheIndex(host_bytes=1 << 20)
    assert port.import_session(export) == {"accepted": 2, "tokens": 86, "rejected": 0}
    assert port.host.lineage("sess-i") == tuple(export["ids"])
    back = port.export_session("sess-i")
    assert [e["key"] for e in back["entries"]] == [e["key"] for e in export["entries"]]
    for ours, theirs in zip(back["entries"], export["entries"]):
        assert isinstance(ours["k"], np.ndarray) and ours["k"].dtype == np.float32
        assert jintegrity.frame_ok(ours, (ours["k"], ours["v"]))
        assert ours["crc"] == theirs["crc"] and ours["header"] == theirs["header"]
        assert (ours["kind"], ours["meta"], ours["tokens"], ours["rows"]) == (
            theirs["kind"], theirs["meta"], theirs["tokens"], theirs["rows"])
    dst = JKVCacheIndex(host_bytes=1 << 20)
    assert dst.import_session(back) == {"accepted": 2, "tokens": 86, "rejected": 0}
    for e in export["entries"]:
        got = dst.host.get(tuple(e["key"])).copy.wait()
        np.testing.assert_array_equal(got[0], e["k"])
        np.testing.assert_array_equal(got[1], e["v"])


@pytest.mark.parametrize("fault", ["tamper", "version", "drift"])
def test_import_refuses_tampered_newer_and_drifted_entries(fault):
    """A flipped byte, an unknown frame version and a header whose dtypes
    disagree with the arrays are each refused before a byte lands, and
    counted in ``engine.kvcache.integrity_failures``."""
    src = KVCacheIndex(host_bytes=1 << 20)
    ks, vs = (torch.from_numpy(a) for a in _arrays(seed=3, n=70))
    key = tuple(range(70, 140))
    assert src.host.put(key, (ks, vs), tokens=70, rows=70, kind="dense")
    src.host.note_session("s", key + (7,))
    export = src.export_session("s")
    entry = export["entries"][0]
    if fault == "tamper":
        integrity.corrupt_arrays([entry["v"]])
    elif fault == "version":
        entry["header"]["v"] = integrity.KV_FRAME_VERSION + 1
    else:
        entry["header"]["dtype"] = ["int8", "int8"]
    before = _failures()
    dst = KVCacheIndex(host_bytes=1 << 20)
    assert dst.import_session(export) == {"accepted": 0, "tokens": 0, "rejected": 1}
    assert len(dst.host) == 0
    assert _failures() == before + 1
    jdst = JKVCacheIndex(host_bytes=1 << 20)
    assert jdst.import_session(export)["rejected"] == 1     # the JAX package agrees


# --------------------------------------------------------------------- #
# The host tier and the radix: one scripted sequence on both packages
# --------------------------------------------------------------------- #

def _keys(rng, n, bases):
    out = []
    for _ in range(n):
        base = bases[rng.integers(len(bases))]
        head = base[: rng.integers(4, len(base) + 1)]
        out.append(tuple(head) + tuple(int(t) for t in rng.integers(1, 5, rng.integers(0, 6))))
    return out


@pytest.mark.parametrize("policy", ["cost", "lru"])
@pytest.mark.parametrize("seed", [0, 1])
def test_host_tier_matches_jax_under_a_scripted_sequence(seed, policy):
    """put (dense and page entries of several sizes), match, match_lcp,
    extension_blocks, take, reinsert, get, session pins, lineage and
    prefix_entries: the same keys, the same evictions in the same order
    and the same bytes held, call by call."""
    rng = np.random.default_rng(seed)
    P = 4
    bases = [tuple(int(t) for t in rng.integers(1, 5, 24)) for _ in range(3)]
    unit = 2 * 2 * 2 * P * 4 * 4             # one page entry's bytes (K and V)
    ours, theirs = HostTier(14 * unit, policy), JHostTier(14 * unit, policy)
    taken = {"ours": [], "theirs": []}
    evicted = 0

    def key_of(e):
        return None if e is None else e.key

    for i, ids in enumerate(_keys(rng, 80, bases)):
        op = int(rng.integers(10))
        rows = int(rng.choice([P, 2 * P, 3 * P]))
        tokens = int(rng.integers(1, rows + 1))
        page_key = ids[: max(len(ids) // P, 1) * P]
        got = []
        held = sorted(ours._tree.keys())
        for name, tier, wrap in (("ours", ours, torch.from_numpy), ("theirs", theirs, np.asarray)):
            if op == 0:          # a page entry: P rows, keyed at a block boundary
                a = wrap(np.full((2, 2, P, 4), float(i), np.float32))
                got.append(tier.put(page_key, (a, a), tokens=P, rows=P, meta=0, kind="page"))
            elif op <= 2:
                a = wrap(np.full((2, 2, rows, 4), float(i), np.float32))
                got.append(tier.put(ids, (a, a), tokens=tokens, rows=rows, kind="dense"))
            elif op == 3:
                got.append((key_of(tier.match(ids)), key_of(tier.get(ids))))
            elif op == 4:
                e, lcp = tier.match_lcp(ids)
                got.append((key_of(e), lcp))
            elif op == 5:
                got.append([e.key for e in tier.extension_blocks(ids + (1,), 1, P, 5)])
            elif op == 6:
                e = tier.take(ids if i % 2 else page_key)
                if e is not None:
                    taken[name].append(e)
                got.append(key_of(e))
            elif op == 7:
                if taken[name]:
                    tier.reinsert(taken[name].pop(0))
                got.append(len(tier))
            else:
                tier.note_session(f"s{i % 3}", ids)
                if i % 5 == 0:
                    tier.drop_session(f"s{(i + 1) % 3}")
                got.append((tier.lineage(f"s{i % 3}"),
                            [e.key for e in tier.prefix_entries(ids + (1, 2))]))
        assert got[0] == got[1], (i, op, got)
        assert ours.bytes_held == theirs.bytes_held
        assert sorted(ours._tree.keys()) == sorted(theirs._tree.keys())   # the same evictions
        evicted += op <= 2 and len(set(held) - set(ours._tree.keys())) > 0
    assert evicted, "the budget never evicted: the sequence tests nothing"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_host_primitives_match_jax(seed):
    """``get``, ``payload_prefixes`` (proper or not) and ``deepest_common``
    give the JAX tree's answers over inserts and removals."""
    rng = np.random.default_rng(seed)
    bases = [tuple(int(t) for t in rng.integers(1, 5, 20)) for _ in range(3)]
    ours, theirs = RadixTree(), JRadixTree()
    for i, ids in enumerate(_keys(rng, 60, bases)):
        if rng.integers(3) and not ours.has(ids):
            ours.insert(ids, i)
            theirs.insert(ids, i)
        elif len(ours):
            key = sorted(ours.keys())[i % len(ours)]
            assert ours.remove(key) == theirs.remove(key)
        query = ids + (1,)
        for proper in (False, True):
            assert [n.key_len for n in ours.payload_prefixes(query, proper)] == [
                n.key_len for n in theirs.payload_prefixes(query, proper)]
        (a, la), (b, lb) = ours.deepest_common(query), theirs.deepest_common(query)
        assert la == lb and (a is None) == (b is None)
        assert a is None or a.payload == b.payload
        assert ours.get(ids) == theirs.get(ids) and (ids in ours) == (ids in theirs)


# --------------------------------------------------------------------- #
# The page gather: int8 pools round-trip to the same bytes
# --------------------------------------------------------------------- #

def test_int8_page_spill_and_restore_give_the_same_bytes_and_scales():
    """Pages of an int8 pool, evicted from the page index (spilled raw to
    the host tier), restored by a lookup and written back by
    ``apply_restores`` into fresh pages, hold the same int8 bytes and the
    same scales as before the spill. The export's layout, the dequantized
    page, equals the JAX ``_gather_page_fn`` value for value; quantizing
    that fp32 page again, as the JAX restore does, gives back the bytes
    but not every scale (ROADMAP C.5)."""
    L, K, H, P, N = 2, 2, 8, 4, 12
    cache = paged.PagedKVCache.create(L, 2, N, P, K, H, dtype=torch.float32, device=CPU,
                                      quantized=True)
    alloc = paged.PageAllocator(N, P, 2, 4)
    index = PagePrefixIndex(P, capacity_pages=1)
    tier = KVCacheIndex(page_index=index, page_size=P, host_bytes=1 << 20,
                        get_cache=lambda: cache)
    rng = np.random.default_rng(3)
    ids = [int(t) for t in rng.integers(1, 50, 3 * P + 1)]
    assert alloc.allocate(0, 3 * P)
    table = torch.from_numpy(alloc.table[:1].copy())
    k = torch.from_numpy(rng.standard_normal((L, 1, 3 * P, K, H)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((L, 1, 3 * P, K, H)).astype(np.float32) * 3)
    paged.write_prompts_paged(cache, table, k, v, [3 * P])
    pages = [int(p) for p in alloc.table[0, :3]]
    before = {p: [t[:, p].clone() for layer in cache.layers + cache.scales for t in layer]
              for p in pages}
    jcache = jpaged.PagedKVCache(
        layers=[(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())) for a, b in cache.layers],
        lengths=jnp.zeros((2,), jnp.int32),
        scales=[(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())) for a, b in cache.scales])
    for p in pages:
        for ours, theirs in zip(gather_page(cache, p), jgather_page(jcache, p)):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    index.register(ids[: 3 * P], pages, alloc)         # capacity 1: two pages spill
    alloc.release(0)
    assert len(tier.host) == 2 and index.pinned_pages == 1
    entry = tier.host.get(tuple(ids[: 3 * P]))
    assert [integrity.dtype_name(t) for t in entry.copy.wait()] == ["int8", "int8", "float32",
                                                                    "float32"]
    for p in alloc.free:                                 # the freed pages are reused
        for layer in cache.layers + cache.scales:
            for t in layer:
                t[:, p] = 1
    index.capacity = 4
    node, rec = tier.lookup_paged(ids, alloc=alloc, max_seq_len=16, need_tokens=len(ids))
    assert node.depth == 3 and rec is not None and len(tier.host) == 0
    tier.apply_restores(cache, [rec], 0)
    for src, dst in zip(pages[1:], rec.pages):
        after = [t[:, dst] for layer in cache.layers + cache.scales for t in layer]
        for want, got in zip(before[src], after):
            assert torch.equal(want, got)


def test_quantizing_a_dequantized_page_again_keeps_the_bytes_not_every_scale():
    """Why an int8 page spills raw (ROADMAP C.5): the JAX restore's path,
    the fp32 page quantized again, gives back the int8 bytes, but an ulp
    off in some scales, in the jitted JAX quantizer and in the port's
    alike."""
    from pilottai_tpu.ops import kvcache as jkvcache

    x = np.random.default_rng(3).standard_normal((2, 4096, 8)).astype(np.float32)
    q, scale = quantize_kv(torch.from_numpy(x))
    again, rescale = quantize_kv(dequantize_kv(q, scale, torch.float32))
    jq, js = jax.jit(jkvcache.quantize_kv)(jnp.asarray(x))
    jagain, jrescale = jax.jit(jkvcache.quantize_kv)(
        jax.jit(lambda a, b: jkvcache.dequantize_kv(a, b, jnp.float32))(jq, js))
    assert torch.equal(again, q) and np.array_equal(np.asarray(jagain), np.asarray(jq))
    assert np.array_equal(rescale.numpy(), np.asarray(jrescale))
    assert 0 < int((rescale != scale).sum()) < scale.numel() // 10


# --------------------------------------------------------------------- #
# The eviction hook: a dropped spill is fine, a CUDA error is not
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("error", [ValueError("no room"),
                                   RuntimeError("CUDA error: an illegal memory access was "
                                                "encountered")], ids=["host", "cuda"])
def test_page_index_swallows_a_failed_spill_but_not_a_cuda_error(error):
    alloc = paged.PageAllocator(9, 4, 2, 4)
    index = PagePrefixIndex(4, capacity_pages=1)
    assert alloc.allocate(0, 8)
    pages = [int(p) for p in alloc.table[0, :2]]
    calls = []

    def spill(path, page):
        calls.append(page)
        raise error

    index.on_evict = spill
    if isinstance(error, ValueError):
        index.register(list(range(8)), pages, alloc)     # the capacity evicts a page
        assert calls and index.pinned_pages == 1
    else:
        with pytest.raises(RuntimeError, match="CUDA error"):
            index.register(list(range(8)), pages, alloc)
    assert alloc.refs[calls[0]] == 1                     # unpinned either way: only the slot's ref


# --------------------------------------------------------------------- #
# Configuration and sessions
# --------------------------------------------------------------------- #

def test_config_takes_the_tier_knobs_at_the_jax_defaults():
    from pilottai_tpu.core import config as jconfig

    cfg, jcfg = LLMConfig(), jconfig.LLMConfig()
    assert (cfg.engine_kvcache_host_mb, cfg.engine_kvcache_policy) == (
        jcfg.engine_kvcache_host_mb, jcfg.engine_kvcache_policy) == (0, "cost")
    cfg = LLMConfig(engine_kvcache_host_mb=64, engine_kvcache_policy="lru")
    assert (cfg.engine_kvcache_host_mb, cfg.engine_kvcache_policy) == (64, "lru")
    for bad in (dict(engine_kvcache_policy="fifo"), dict(engine_kvcache_host_mb=-1)):
        with pytest.raises(ValueError):
            LLMConfig(**bad)
    for knob, value, item in (("engine_prewarm_depth", 512, "P6c"),
                              ("engine_sched_policy", "dag", "P6c"),
                              ("cell_disagg", "1p1d", "P8"), ("mesh_shape", {"model": 2}, "P10")):
        with pytest.raises(ValueError, match=item) as refused:
            LLMConfig(**{knob: value})
        assert isinstance(refused.value.errors()[0]["ctx"]["error"], NotInSlice)


def test_handler_threads_the_session_id_into_the_request():
    from pilottai_tpu_torch import LLMHandler
    from pilottai_tpu_torch.engine.types import GenerationParams

    h = LLMHandler(LLMConfig(provider="cpu", model_name="llama-tiny", dtype="float32"))
    msgs, specs, params = h._normalize(["hi"], None, None, None, None, None, "sess-42", None,
                                       None, 0)
    assert params.session_id == "sess-42"
    _, _, explicit = h._normalize(["hi"], None, GenerationParams(session_id="explicit"), None,
                                  None, None, "sess-42", None, None, 0)
    assert explicit.session_id == "explicit"
    request = h.backend._build_request(msgs, specs or None, params)
    assert request.session_id == "sess-42"
    with pytest.raises(NotInSlice, match="P6c"):
        h.backend._build_request(msgs, None, params.model_copy(update={"priority": 2}))
