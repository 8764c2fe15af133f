"""The port's paged KV cache against the JAX package, in fp32 on the CPU:
the plain version of kernel K3 against the TPU kernel in interpret mode
(every mode: window, soft-cap, ``q_blocks``, int8 pools with scales, the
fused ring, empty and unallocated rows), the page allocator, the paged
cache ops, and the paged admission, chunked-prefill and decode functions
on llama-tiny (weights through ``params_from_numpy``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.engine import decode as jdecode
from pilottai_tpu.engine import sampling as jsampling
from pilottai_tpu.models import common as jcommon
from pilottai_tpu.models import registry as jregistry
from pilottai_tpu.ops import paged as jpaged
from pilottai_tpu.ops.kvcache import quantize_kv
from pilottai_tpu.ops.pallas.paged_attention import paged_decode_attention as jpaged_attention
from pilottai_tpu_torch.engine import decode, sampling
from pilottai_tpu_torch.models import registry
from pilottai_tpu_torch.models.loader import params_from_numpy
from pilottai_tpu_torch.ops import paged
from pilottai_tpu_torch.ops.kernels import paged_attention as k3
from pilottai_tpu_torch.ops.kvcache import KVCache

CPU = torch.device("cpu")
NEG_INF = -2.0**30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast and does not
    oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# K3: the plain version against the TPU kernel (interpret mode)
# --------------------------------------------------------------------- #

B, K, H, P, MAX_PAGES = 4, 2, 32, 16, 4
# A partial final page, one full page (later table entries unallocated), an
# empty slot (its whole row the sentinel) and one key past a page boundary.
LENGTHS = (2 * P + P // 2 + 3, P, 0, 3 * P + 1)

K3_CASES = {
    "plain": dict(),
    "window": dict(window=24),
    "softcap": dict(softcap=30.0),
    "window_softcap_mid_sentinel": dict(window=40, softcap=30.0, mid_sentinel=True),
    "q_blocks": dict(q_blocks=3, window=24),
    "int8": dict(quantized=True, softcap=30.0),
    "int8_window": dict(quantized=True, window=40),
}
for _w in (0, 40):
    for _step in (0, 3, 7):
        K3_CASES[f"ring_w{_w}_step{_step}"] = dict(window=_w, ring=8, step=_step)
K3_CASES["ring_w3_step7"] = dict(window=3, ring=8, step=7)   # the window cuts the ring


def _k3_inputs(rng, quantized=False, mid_sentinel=False):
    """A pool and table holding random keys at each slot's positions, as
    numpy arrays for both sides (int8 pools quantized by the JAX package)."""
    num_pages = B * MAX_PAGES + 1
    alloc = paged.PageAllocator(num_pages, P, B, MAX_PAGES)
    k_pool = np.zeros((K, num_pages, P, H), np.float32)
    v_pool = np.zeros((K, num_pages, P, H), np.float32)
    for b, n in enumerate(LENGTHS):
        if n == 0:
            continue
        assert alloc.allocate(b, n)
        for j in range(alloc.pages_needed(n)):
            pg = alloc.table[b, j]
            k_pool[:, pg] = rng.normal(size=(K, P, H))
            v_pool[:, pg] = rng.normal(size=(K, P, H))
    table = alloc.table.copy()
    if mid_sentinel:
        table[0, 1] = alloc.sentinel    # a hole in the middle of slot 0's row
    out = dict(k=k_pool, v=v_pool, ks=None, vs=None, table=table,
               last=np.asarray(LENGTHS, np.int32) - 1, qpos=np.asarray(LENGTHS, np.int32))
    if quantized:
        kq, ks = quantize_kv(jnp.asarray(k_pool))
        vq, vs = quantize_kv(jnp.asarray(v_pool))
        out.update(k=np.asarray(kq), v=np.asarray(vq), ks=np.asarray(ks), vs=np.asarray(vs))
    return out


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("case", list(K3_CASES))
def test_plain_k3_matches_the_tpu_kernel(case):
    kw = dict(K3_CASES[case])
    rng = np.random.default_rng(len(case))
    x = _k3_inputs(rng, kw.pop("quantized", False), kw.pop("mid_sentinel", False))
    q_blocks = kw.pop("q_blocks", 1)
    N = K * 2 * q_blocks
    q = rng.normal(size=(B, N, H)).astype(np.float32)
    ring = kw.pop("ring", 0)
    step = kw.pop("step", 0)
    rk = rng.normal(size=(B, K, ring, H)).astype(np.float32) if ring else None
    rv = rng.normal(size=(B, K, ring, H)).astype(np.float32) if ring else None
    window, softcap = kw.pop("window", 0), kw.pop("softcap", 0.0)
    assert not kw

    want = jpaged_attention(
        jnp.asarray(q), _j(x["k"]), _j(x["v"]), _j(x["table"]), _j(x["last"]),
        q_positions=_j(x["qpos"]), n_blocks=MAX_PAGES, scale=H**-0.5, softcap=softcap,
        window=window, q_blocks=q_blocks, k_scales=_j(x["ks"]), v_scales=_j(x["vs"]),
        ring_k=_j(rk), ring_v=_j(rv), ring_step=jnp.int32(step) if ring else None,
        interpret=True,
    )
    got = k3.paged_decode_attention(
        _t(q), _t(x["k"]), _t(x["v"]), _t(x["table"]), _t(x["last"]),
        q_positions=_t(x["qpos"]), n_blocks=MAX_PAGES, scale=H**-0.5, softcap=softcap,
        window=window, q_blocks=q_blocks, k_scales=_t(x["ks"]), v_scales=_t(x["vs"]),
        ring_k=_t(rk), ring_v=_t(rv), ring_step=step if ring else None,
    )
    acc_j, m_j, l_j = (np.asarray(a) for a in want)
    acc_t, m_t, l_t = (a.numpy() for a in got)
    np.testing.assert_allclose(acc_t, acc_j, atol=1e-5, rtol=1e-5)
    empty = m_j <= NEG_INF / 2
    # Rows with no key are exact: m stays NEG_INF, l and acc stay 0.
    np.testing.assert_array_equal(m_t[empty], m_j[empty])
    np.testing.assert_array_equal(l_t[empty], 0.0)
    np.testing.assert_array_equal(acc_t[empty], 0.0)
    np.testing.assert_allclose(m_t[~empty], m_j[~empty], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(l_t[~empty], l_j[~empty], atol=1e-5, rtol=1e-5)
    if ring:
        assert not empty.any()          # ring row `step` always attends
    else:
        assert empty[2].all()           # the empty slot
    assert k3.launches == 0             # CPU tensors never reach the CUDA kernel


def test_k3_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="head_dim"):
        k3.check_kernel_shapes(32, 8, 96, 128)
    with pytest.raises(ValueError, match="query rows"):
        k3.check_kernel_shapes(64, 1, 64, 16)
    # Every page size the JAX engine serves (engine_page_size >= 8).
    for page_size in (8, 24, 100, 128, 512):
        k3.check_kernel_shapes(32, 8, 128, page_size)
    with pytest.raises(ValueError, match="page size of at least 8"):
        k3.check_kernel_shapes(32, 8, 128, 4)
    x = _k3_inputs(np.random.default_rng(0))
    q = torch.zeros((B, K * 2, H))
    with pytest.raises(ValueError, match="int8 pools"):
        k3.paged_decode_attention(q, _t(x["k"]), _t(x["v"]), _t(x["table"]), _t(x["last"]),
                                  k_scales=torch.ones((K, B * MAX_PAGES + 1, P)),
                                  v_scales=torch.ones((K, B * MAX_PAGES + 1, P)))
    with pytest.raises(ValueError, match="ring"):
        k3.paged_decode_attention(q, _t(x["k"]), _t(x["v"]), _t(x["table"]), _t(x["last"]),
                                  ring_k=torch.zeros((B, K, 4, H)), ring_v=torch.zeros((B, K, 4, H)))


# --------------------------------------------------------------------- #
# Allocator and cache ops
# --------------------------------------------------------------------- #

def _same_allocator(ours, theirs):
    np.testing.assert_array_equal(ours.table, theirs.table)
    np.testing.assert_array_equal(ours.refs, theirs.refs)
    assert ours.free == theirs.free
    assert ours.free_pages == theirs.free_pages


def test_page_allocator_follows_the_jax_allocator():
    """A scripted allocate / share / release sequence gives the same
    tables, refcounts and free lists on both sides."""
    ours = paged.PageAllocator(12, 16, 4, 5)
    theirs = jpaged.PageAllocator(12, 16, 4, 5)
    script = [
        ("allocate", 0, 40, ()), ("allocate", 1, 64, ()), ("allocate", 2, 200, ()),
        ("allocate", 2, 17, ()), ("release", 0), ("allocate", 3, 70, "share1"),
        ("release", 1), ("allocate", 0, 1, ()), ("allocate", 1, 80, ()),
        ("release", 3), ("release", 2), ("allocate", 2, 33, ()), ("release", 0),
    ]
    for op in script:
        if op[0] == "release":
            ours.release(op[1])
            theirs.release(op[1])
        else:
            _, slot, n, prefix = op
            if prefix == "share1":          # slot 1's first two pages, shared
                prefix = tuple(int(p) for p in theirs.table[1, :2])
            assert ours.can_allocate(n, len(prefix)) == theirs.can_allocate(n, len(prefix))
            assert ours.allocate(slot, n, prefix) == theirs.allocate(slot, n, prefix)
        _same_allocator(ours, theirs)
    assert ours.pages_needed(0) == theirs.pages_needed(0) == 1


def _pools_equal(cache, jcache, atol=0.0):
    """Every page but the scratch page holds the same keys and values."""
    for (kt, vt), (kj, vj) in zip(cache.layers, jcache.layers):
        np.testing.assert_allclose(kt.numpy()[:, :-1], np.asarray(kj)[:, :-1], atol=atol, rtol=atol)
        np.testing.assert_allclose(vt.numpy()[:, :-1], np.asarray(vj)[:, :-1], atol=atol, rtol=atol)


@pytest.mark.parametrize("pos_offset", [0, 8])
def test_paged_cache_ops_write_what_jax_writes(pos_offset):
    L, A, T, Kh, Hd, Pg, n_slots, max_pages = 2, 3, 20, 2, 8, 4, 4, 8
    num_pages = 24
    rng = np.random.default_rng(pos_offset)
    alloc = paged.PageAllocator(num_pages, Pg, n_slots, max_pages)
    assert alloc.allocate(1, pos_offset + 20) and alloc.allocate(3, pos_offset + 9)
    rows = np.full((A, max_pages), alloc.sentinel, np.int32)
    rows[0], rows[1] = alloc.table[1], alloc.table[3]          # row 2 pads
    lens = [20, 7, 0]
    ks = rng.normal(size=(L, A, T, Kh, Hd)).astype(np.float32)
    vs = rng.normal(size=(L, A, T, Kh, Hd)).astype(np.float32)
    cache = paged.PagedKVCache.create(L, n_slots, num_pages, Pg, Kh, Hd, torch.float32, CPU)
    jcache = jpaged.PagedKVCache.create(L, n_slots, num_pages, Pg, Kh, Hd, jnp.float32)
    cache = paged.write_prompts_paged(cache, torch.from_numpy(rows), torch.from_numpy(ks),
                                      torch.from_numpy(vs), lens, pos_offset=pos_offset)
    jcache = jpaged.write_prompts_paged(
        jcache, jnp.asarray(rows), jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(lens),
        pos_offset=jnp.int32(pos_offset) if pos_offset else None)
    cache = paged.install_lengths(cache, [1, 3, n_slots], [pos_offset + n for n in lens])
    jcache = jpaged.install_lengths(jcache, jnp.asarray([1, 3, n_slots]),
                                    jnp.asarray([pos_offset + n for n in lens]))
    _pools_equal(cache, jcache)
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))

    # A decode chunk's ring lands after each slot's length.
    n = 4
    ring_k = [rng.normal(size=(n_slots, Kh, n, Hd)).astype(np.float32) for _ in range(L)]
    ring_v = [rng.normal(size=(n_slots, Kh, n, Hd)).astype(np.float32) for _ in range(L)]
    start = cache.lengths.clone()
    accepted = np.array([0, 4, 0, 2], np.int32)
    table = alloc.table.copy()
    cache = paged.write_chunk_rows_paged(
        cache, torch.from_numpy(table), [torch.from_numpy(r) for r in ring_k],
        [torch.from_numpy(r) for r in ring_v], start, torch.from_numpy(accepted))
    jcache = jpaged.write_chunk_rows_paged(
        jcache, jnp.asarray(table), [jnp.asarray(r) for r in ring_k],
        [jnp.asarray(r) for r in ring_v], jnp.asarray(start.numpy()), jnp.asarray(accepted))
    _pools_equal(cache, jcache)
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))

    # gather_pages: value pools and [K, num_pages, P] scale pools.
    for pool, jpool in ((cache.layers[1][0], jcache.layers[1][0]),
                        (cache.layers[0][1][..., 0], jcache.layers[0][1][..., 0])):
        np.testing.assert_array_equal(
            paged.gather_pages(pool, torch.from_numpy(table), 3).numpy(),
            np.asarray(jpaged.gather_pages(jpool, jnp.asarray(table), 3)))


# --------------------------------------------------------------------- #
# Paged admission, chunked prefill and decode on llama-tiny
# --------------------------------------------------------------------- #

def _tiny():
    jcfg = jregistry.get_model_config("llama-tiny").replace(dtype=jnp.float32)
    cfg = registry.get_model_config("llama-tiny").replace(dtype=torch.float32)
    jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device=CPU)
    return cfg, params, jcfg, jparams


def test_paged_admission_and_decode_match_jax_and_the_dense_cache():
    """Greedy tokens of paged ``admit_group`` + ``decode_chunk`` equal the
    JAX paged chunk's and the port's own dense chunk's."""
    cfg, params, jcfg, jparams = _tiny()
    n_slots, S, A, T, Pg = 4, 128, 4, 64, 32
    rng = np.random.default_rng(0)
    lens = np.array([17, 33, 0, 0], np.int32)
    tokens = np.zeros((A, T), np.int32)
    for i in range(2):
        tokens[i, : lens[i]] = rng.integers(2, cfg.vocab_size, lens[i])
    budgets = [20, 20, 0, 0]
    mi, mf = decode.pack_admit_meta(A, slots=[0, 2, n_slots, n_slots], seeds=range(10, 14),
                                    budgets=budgets, lens=lens, pad_slot=n_slots)
    alloc = paged.PageAllocator(4 * n_slots + 1, Pg, n_slots, S // Pg)
    for row, slot in enumerate([0, 2]):
        assert alloc.allocate(slot, int(lens[row]) + budgets[row] + 1)
    rows = np.full((A, S // Pg), alloc.sentinel, np.int32)
    rows[0], rows[1] = alloc.table[0], alloc.table[2]
    table = alloc.table.copy()

    jcache = jpaged.PagedKVCache.create(jcfg.n_layers, n_slots, 4 * n_slots + 1, Pg,
                                        jcfg.n_kv_heads, jcfg.head_dim, dtype=jnp.float32)
    jc, jd, js, jfirst, _ = jdecode.admit_group(
        jparams, jcfg, jcache, jdecode.DecodeState.create(n_slots),
        jsampling.SamplingState.create(n_slots), jnp.asarray(tokens), jnp.asarray(mi),
        jnp.asarray(mf), use_flash=False, page_rows=jnp.asarray(rows))
    runs = {}
    for name in ("paged", "dense"):
        if name == "paged":
            cache = paged.PagedKVCache.create(cfg.n_layers, n_slots, 4 * n_slots + 1, Pg,
                                              cfg.n_kv_heads, cfg.head_dim, torch.float32, CPU)
        else:
            cache = KVCache.create(cfg.n_layers, n_slots, S, cfg.n_kv_heads, cfg.head_dim,
                                   dtype=torch.float32, device=CPU)
        runs[name] = decode.admit_group(
            params, cfg, cache, decode.DecodeState.create(n_slots, CPU),
            sampling.SamplingState.create(n_slots, CPU), tokens, mi, mf,
            page_rows=rows if name == "paged" else None)
        np.testing.assert_array_equal(runs[name][3].numpy()[:2], np.asarray(jfirst)[:2])

    for _ in range(3):
        jt, jv, jc, jd, js = jdecode.decode_chunk(jparams, jcfg, jc, jd, js, 8,
                                                  use_pallas=False, table=jnp.asarray(table))
        outs = {}
        for name, (cache, dstate, samp, _) in runs.items():
            t, v, cache, dstate, samp = decode.decode_chunk(
                params, cfg, cache, dstate, samp, 8,
                table=torch.from_numpy(table) if name == "paged" else None,
                n_blocks=S // Pg if name == "paged" else None)
            runs[name] = (cache, dstate, samp, None)
            outs[name] = np.where(v.numpy(), t.numpy(), -1)
        want = np.where(np.asarray(jv), np.asarray(jt), -1)
        np.testing.assert_array_equal(outs["paged"], want)
        np.testing.assert_array_equal(outs["dense"], want)
        np.testing.assert_array_equal(runs["paged"][0].lengths.numpy(), np.asarray(jc.lengths))
    assert runs["paged"][1].done.all()
    _pools_equal(runs["paged"][0], jc, atol=1e-4)


def test_chunked_prefill_segments_and_final_admission_match_jax():
    """Two ``extend_prompt_paged`` segments, then the final segment through
    ``admit_group_prefix_paged``: the pools equal JAX's after every step,
    the tail logits agree within 1e-4 and the first token is the same."""
    cfg, params, jcfg, jparams = _tiny()
    n_slots, Pg, max_pages, num_pages = 2, 16, 8, 17
    rng = np.random.default_rng(3)
    prompt = rng.integers(2, cfg.vocab_size, 90).astype(np.int32)
    slot = 1
    alloc = paged.PageAllocator(num_pages, Pg, n_slots, max_pages)
    assert alloc.allocate(slot, 90 + 8)
    row = alloc.table[slot][None].copy()
    cache = paged.PagedKVCache.create(cfg.n_layers, n_slots, num_pages, Pg, cfg.n_kv_heads,
                                      cfg.head_dim, torch.float32, CPU)
    jcache = jpaged.PagedKVCache.create(jcfg.n_layers, n_slots, num_pages, Pg, jcfg.n_kv_heads,
                                        jcfg.head_dim, dtype=jnp.float32)

    def chain(done):
        k = done // Pg
        kb = 1
        while kb < max(k, 1):
            kb *= 2
        pages = np.full((kb,), alloc.sentinel, np.int32)
        pages[:k] = alloc.table[slot, :k]
        return pages

    for done in (0, 32):
        seg = prompt[None, done:done + 32]
        cache = decode.extend_prompt_paged(params, cfg, cache, chain(done), done, seg, [32], row)
        jcache = jdecode.extend_prompt_paged(
            jparams, jcfg, jcache, jnp.asarray(chain(done)), jnp.int32(done), jnp.asarray(seg),
            jnp.asarray([32], np.int32), jnp.asarray(row))
        _pools_equal(cache, jcache, atol=1e-4)

    done, tail = 64, prompt[64:]
    tail_tokens = np.zeros((1, 32), np.int32)
    tail_tokens[0, : len(tail)] = tail
    mi, mf = decode.pack_admit_meta(1, slots=[slot], seeds=[5], budgets=[7], lens=[len(tail)],
                                    prefix_len=done, pad_slot=n_slots)
    pages = torch.from_numpy(chain(done)[: done // Pg]).long()
    logits, _, _ = decode._tail_prefill(
        params, cfg, decode._chain_layer(cache, pages), done,
        torch.from_numpy(tail_tokens).long(), torch.tensor([len(tail)], dtype=torch.int32))
    jlogits, _, _ = jdecode._chain_tail_prefill(
        jparams, jcfg, jcache, jnp.asarray(chain(done)), jnp.int32(done),
        jnp.asarray(tail_tokens), jnp.asarray([len(tail)], np.int32), jnp.float32)
    n = len(tail)
    np.testing.assert_allclose(logits.numpy()[:, :n], np.asarray(jlogits)[:, :n],
                               atol=1e-4, rtol=1e-4)

    cache, dstate, samp, first = decode.admit_group_prefix_paged(
        params, cfg, cache, decode.DecodeState.create(n_slots, CPU),
        sampling.SamplingState.create(n_slots, CPU), chain(done), tail_tokens, row, mi, mf)
    full = np.zeros((1, 128), np.int32)
    full[0, :90] = prompt
    jcache, jd, _, jfirst, _ = jdecode.admit_group_prefix_paged(
        jparams, jcfg, jcache, jdecode.DecodeState.create(n_slots),
        jsampling.SamplingState.create(n_slots), jnp.asarray(chain(done)),
        jnp.asarray(tail_tokens), jnp.asarray(full), jnp.asarray(row), jnp.asarray(mi),
        jnp.asarray(mf), n_prefix_bucket=len(chain(done)))
    _pools_equal(cache, jcache, atol=1e-4)
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))
    assert cache.lengths[slot] == 90
    assert int(first[0]) == int(np.asarray(jfirst)[0])
    np.testing.assert_array_equal(dstate.done.numpy(), np.asarray(jd.done))


def _windowed_tail_attn(q, k, v, pk, pv, plen, valid, scale, softcap, window, span):
    """The JAX package's tail attention for a long chain, in plain torch:
    the prefix's statistics over spans of ``span`` keys merged online,
    then merged with the tail's own causal block."""
    A, T, N, H = q.shape
    Kh = k.shape[2]
    qg = q.reshape(A, T, Kh, N // Kh, H).permute(0, 2, 3, 1, 4)      # [A, K, G, T, H]
    qpos = plen + torch.arange(T)

    def stats(s, mask, vals, eq):
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        s = torch.where(mask, s, torch.full_like(s, decode.NEG_INF))
        m = s.amax(-1)
        p = torch.where(m[..., None] > decode.NEG_INF / 2, torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        return torch.einsum(eq, p, vals), m, p.sum(-1)

    acc = torch.zeros(A, Kh, N // Kh, T, H)
    m = torch.full((A, Kh, N // Kh, T), decode.NEG_INF)
    l = torch.zeros_like(m)
    for w0 in range(0, pk.shape[1], span):
        col = torch.arange(w0, w0 + span)
        mask = (col < plen)[None, :] & (((qpos[:, None] - col[None, :]) < window)
                                        if window > 0 else True)
        s = torch.einsum("akgth,kph->akgtp", qg, pk[:, w0:w0 + span]) * scale
        acc, m, l = decode._merge_stats(
            acc, m, l, *stats(s, mask, pv[:, w0:w0 + span], "akgtp,kph->akgth"))
    e, t = torch.arange(T)[None, :], torch.arange(T)[:, None]
    mask = (e <= t)[None, None, None] & (e < valid[:, None, None, None, None])
    if window > 0:
        mask = mask & ((t - e) < window)
    s = torch.einsum("akgth,aekh->akgte", qg, k) * scale
    acc, _, l = decode._merge_stats(acc, m, l, *stats(s, mask, v, "akgte,aekh->akgth"))
    return (acc / l[..., None]).permute(0, 3, 1, 2, 4).reshape(A, T, N, H)


def test_windowed_prefix_attention_equals_one_shot():
    """The tail attention over a long chain in one K1 launch (here its
    plain version) equals the windowed merge the JAX package takes when
    the one-shot scores would be too large: prefix spans merged online,
    then the tail's causal block."""
    rng = np.random.default_rng(4)
    A, T, N, Kh, Hd, Pp = 2, 8, 4, 2, 16, 64

    def r(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    q, k, v, pk, pv = r(A, T, N, Hd), r(A, T, Kh, Hd), r(A, T, Kh, Hd), r(Kh, Pp, Hd), r(Kh, Pp, Hd)
    valid = torch.tensor([8, 5], dtype=torch.int32)
    args = (q, k, v, pk, pv, 48, valid, Hd**-0.5)
    for softcap, window in ((0.0, 0), (20.0, 30)):
        one_shot = decode._tail_prefix_attn(*args, softcap, window)
        windowed = _windowed_tail_attn(*args, softcap, window, span=16)
        np.testing.assert_allclose(one_shot.numpy(), windowed.numpy(), atol=1e-5, rtol=1e-5)
