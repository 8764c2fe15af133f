"""Slice P4, speculative decoding, on the CPU against the JAX package: the
verify rows' masked greedy (``fused_verify_rows``), the n-gram drafts, the
ragged-buffer statistics and the three-source block attention (dense, and
paged through K3's plain version with ``q_blocks``), the model drafts, and
the speculative chunk itself on protocol-s in fp32 (tokens, valid rows,
lengths, cache rows and history after it, dense and paged, D = 2, 4 and
8, fused epilogue on and off). The JAX package's own speculative cases
(``tests/test_speculative.py``, ``tests/test_draft_model.py``) run on the
port as parametrised cases, with the port's plain chunk as the reference
they name, and a sampled stream is held to the same ids with speculation
on and off. The engine-level case is ``tests/test_torch_spec_engine.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.engine import decode as jdecode
from pilottai_tpu.engine import sampling as jsampling
from pilottai_tpu.engine.json_mask import json_advance as jjson_advance
from pilottai_tpu.models import common as jcommon
from pilottai_tpu.models import registry as jregistry
from pilottai_tpu.ops import kvcache as jkvcache
from pilottai_tpu.ops import paged as jpaged
from pilottai_tpu_torch import PROTOCOL_S_NPZ
from pilottai_tpu_torch.engine import decode, sampling
from pilottai_tpu_torch.engine.json_mask import json_advance
from pilottai_tpu_torch.engine.tokenizer import ByteTokenizer
from pilottai_tpu_torch.models import registry
from pilottai_tpu_torch.models.loader import load_npz, params_from_numpy
from pilottai_tpu_torch.ops import paged
from pilottai_tpu_torch.ops.kernels import paged_attention as k3
from pilottai_tpu_torch.ops.kvcache import KVCache

CPU = torch.device("cpu")
EOS = ByteTokenizer().eos_id


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are small: one intra-op thread is as fast and does
    not oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# The verify rows and the n-gram drafts (exact)
# --------------------------------------------------------------------- #

# JSON prefixes that put the automaton in varied states and depths.
JSON_HEADS = ['{"a":', '[1,', '{"key":"va', '[{"x":[tr', '{"n":-0.5e', '', '{"k":{"j":[]']


def _coords(heads):
    """Both packages' JSON coordinates after each head's bytes."""
    B = len(heads)
    st = torch.zeros(B, dtype=torch.int32)
    sk = torch.zeros(B, dtype=torch.int32)
    dp = torch.zeros(B, dtype=torch.int32)
    jst, jsk, jdp = (jnp.zeros(B, jnp.int32) for _ in range(3))
    for i in range(max(len(h) for h in heads)):
        byte = [ord(h[i]) if i < len(h) else 32 for h in heads]
        live = torch.tensor([i < len(h) for h in heads])
        ns, nk, nd = json_advance(st, sk, dp, torch.tensor(byte, dtype=torch.int32))
        st, sk, dp = (torch.where(live, a, b) for a, b in ((ns, st), (nk, sk), (nd, dp)))
        js, jk, jd = jjson_advance(jst, jsk, jdp, jnp.asarray(byte, jnp.int32))
        jl = jnp.asarray(live.numpy())
        jst, jsk, jdp = (jnp.where(jl, a, b) for a, b in ((js, jst), (jk, jsk), (jd, jdp)))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    return st, sk, dp, jst, jsk, jdp


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_verify_rows_matches_jax(seed, D):
    """The verify rows' masked greedy on the same logits, draft path, JSON
    coordinates and budgets (some low enough to force the document
    closed, one JSON slot without EOS) equals the JAX function's, id for
    id; the state handed in is left as it was."""
    rng = np.random.default_rng(seed)
    B, V = len(JSON_HEADS), 384
    logits = rng.normal(size=(B, D - 1, V)).astype(np.float32) * 4
    alphabet = [ord(c) for c in '{}[]":,0123456789-.aeftlnrsu '] + [EOS]
    drafts = rng.choice(alphabet, size=(B, D - 1)).astype(np.int32)
    budget = np.array([2, 40, 3, 9, 1, 30, 5], np.int32)
    enabled = np.array([1, 1, 1, 0, 1, 1, 1], bool)
    eos = np.array([EOS, EOS, -1, EOS, EOS, EOS, -1], np.int32)
    st, sk, dp, jst, jsk, jdp = _coords(JSON_HEADS)

    state = sampling.SamplingState.create(B, CPU)
    state.json_enabled.copy_(torch.from_numpy(enabled))
    state.eos_id.copy_(torch.from_numpy(eos))
    state.json_state.copy_(st)
    state.json_stack.copy_(sk)
    state.json_depth.copy_(dp)
    before = [t.clone() for t in (state.json_state, state.json_stack, state.json_depth)]
    got = sampling.fused_verify_rows(torch.from_numpy(logits), torch.from_numpy(drafts), state,
                                     torch.from_numpy(budget))
    jstate = jsampling.SamplingState.create(B)._replace(
        json_enabled=jnp.asarray(enabled), eos_id=jnp.asarray(eos), json_state=jst,
        json_stack=jsk, json_depth=jdp)
    want = jsampling.fused_verify_rows(jnp.asarray(logits), jnp.asarray(drafts), jstate,
                                       jnp.asarray(budget))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(before, (state.json_state, state.json_stack, state.json_depth)):
        assert torch.equal(a, b)


def _histories(kind, rng, B, S):
    if kind == "random":
        return rng.integers(0, 8, (B, S)).astype(np.int32)
    # Repetitive: each slot a short cycle with noise, as JSON keys repeat.
    h = np.zeros((B, S), np.int32)
    for b in range(B):
        cycle = rng.integers(1, 50, rng.integers(2, 7))
        h[b] = np.resize(cycle, S)
        noise = rng.random(S) < 0.1
        h[b, noise] = rng.integers(1, 50, noise.sum())
    return h


@pytest.mark.parametrize("n_drafts", [1, 3, 7])
@pytest.mark.parametrize("kind", ["random", "repetitive"])
def test_ngram_drafts_match_jax(kind, n_drafts):
    """The 3-gram tier backing off to the 2-gram, over the slots' histories
    at positions from 0 to the end, gives the JAX function's drafts."""
    rng = np.random.default_rng(3)
    B, S = 6, 96
    hist = _histories(kind, rng, B, S)
    pos = np.array([0, 1, 2, 40, 80, S - 1], np.int32)
    cur = hist[np.arange(B), pos]
    got = decode._ngram_drafts(torch.from_numpy(hist), torch.from_numpy(pos),
                               torch.from_numpy(cur), n_drafts)
    want = jdecode._ngram_drafts(jnp.asarray(hist), jnp.asarray(pos), jnp.asarray(cur), n_drafts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if kind == "repetitive":
        assert (got.numpy()[3:] != 0).any()


# --------------------------------------------------------------------- #
# The block attention: ragged buffers, the dense and the paged prefix
# --------------------------------------------------------------------- #

# (K, G, H): protocol-s, and a llama-like head.
WIDTHS = {"protocol_s": (4, 2, 32), "llama_like": (2, 4, 64)}
# As max |difference| / max |reference|. bf16: the port rounds p to bf16
# before each p·v product as the JAX function does, but the reference here
# runs in fp32 on the bf16-rounded inputs (XLA's CPU has no bf16 x bf16 ->
# fp32 product), so p's rounding shows; the limit is about twice the
# largest reading over these cases drawn from seeds 5 and 7-9 (1.73e-3, the
# ragged statistics; fp32 read 4.7e-7 at most).
ATTN_TOL = {"float32": 1e-5, "bfloat16": 4e-3}


def _attn_inputs(K, G, H, D, dtype, seed=5):
    rng = np.random.default_rng(seed)
    B, Sb, R = 3, 48, 12
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(tdt)

    x = dict(qg=draw(B, K, G, D, H), layer_k=draw(B, K, Sb, H), layer_v=draw(B, K, Sb, H),
             ring_k=draw(B, K, R, H), ring_v=draw(B, K, R, H), blk_k=draw(B, K, D, H),
             blk_v=draw(B, K, D, H))
    last = np.array([20, Sb - 1, -1], np.int32)
    start = last + 1
    offset = np.array([5, 0, R], np.int32)
    qpos = (start + offset)[:, None] + np.arange(D, dtype=np.int32)[None, :]
    ints = dict(last=last, start=start, offset=offset, qpos=qpos)
    return x, ints


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["global", "window_softcap"])
def test_ragged_stats_match_jax(mode, dtype):
    """Online-softmax partials over a per-slot ragged buffer (a ring with
    0 and all rows valid, a window that cuts it): acc, m and l."""
    window, softcap = (0, 0.0) if mode == "global" else (9, 20.0)
    x, ints = _attn_inputs(2, 4, 64, 4, dtype)
    qg = x["qg"][:, :, :, 0]
    t = {k: torch.from_numpy(v) for k, v in ints.items()}
    got = decode._ragged_stats(qg, x["ring_k"], x["ring_v"], t["offset"], t["start"],
                               t["qpos"][:, 0], 64**-0.5, softcap, window)
    f = {k: jnp.asarray(v.float().numpy()) for k, v in x.items()}
    want = jdecode._ragged_stats(f["qg"][:, :, :, 0], f["ring_k"], f["ring_v"],
                                 jnp.asarray(ints["offset"]), jnp.asarray(ints["start"]),
                                 jnp.asarray(ints["qpos"][:, 0]), 64**-0.5, softcap, window)
    acc, m, l = (np.asarray(w) for w in want)
    live = l > 0
    np.testing.assert_allclose(got[1].numpy()[live], m[live], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), l, atol=1e-4, rtol=1e-5)
    assert _rel(got[0].numpy(), acc) <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["global", "window_softcap"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_spec_block_attention_matches_jax(cache, width, mode, dtype):
    """The verify block's three-source attention: a bounded dense panel, or
    the paged pool through K3's plain version with ``q_blocks=D`` against
    the JAX function's gather path; a ring with none, some and all rows
    live; a slot with no prefix; a window that reaches into the ring and a
    soft-cap."""
    K, G, H = WIDTHS[width]
    D = 4
    window, softcap = (0, 0.0) if mode == "global" else (14, 20.0)
    x, ints = _attn_inputs(K, G, H, D, dtype)
    t = {k: torch.from_numpy(v) for k, v in ints.items()}
    f = {k: jnp.asarray(v.float().numpy()) for k, v in x.items()}
    B, Sb = 3, x["layer_k"].shape[2]
    prefix = dict(layer_k=x["layer_k"], layer_v=x["layer_v"])
    jprefix = (f["layer_k"], f["layer_v"])
    if cache == "paged":
        P = 8
        n_blocks = Sb // P
        num_pages = B * n_blocks + 1
        perm = np.random.default_rng(2).permutation(B * n_blocks).reshape(B, n_blocks)
        table = torch.from_numpy(perm.astype(np.int32))
        pools = []
        for name in ("layer_k", "layer_v"):
            pool = torch.zeros((K, num_pages, P, H), dtype=x[name].dtype)
            pool[:, table.long()] = x[name].reshape(B, K, n_blocks, P, H).transpose(0, 1)
            pools.append(pool)
        stats = k3.paged_decode_attention(
            x["qg"].reshape(B, K * G * D, H), pools[0], pools[1], table, t["last"],
            q_positions=t["qpos"][:, 0], n_blocks=n_blocks, scale=H**-0.5, softcap=softcap,
            window=window, q_blocks=D)
        prefix = dict(layer_k=None, layer_v=None, prefix_stats=stats)
        jpools = [jnp.asarray(p.float().numpy()) for p in pools]
        jtable = jnp.asarray(table.numpy())
        jprefix = tuple(jpaged.gather_pages(p, jtable, n_blocks) for p in jpools)
    got = decode._spec_block_attn(
        x["qg"], ring_k=x["ring_k"], ring_v=x["ring_v"], blk_k=x["blk_k"], blk_v=x["blk_v"],
        last=t["last"], start=t["start"], offset=t["offset"], qpos=t["qpos"], scale=H**-0.5,
        softcap=softcap, window=window, **prefix)
    want = jdecode._spec_block_attn(
        f["qg"], *jprefix, f["ring_k"], f["ring_v"], f["blk_k"], f["blk_v"],
        jnp.asarray(ints["last"]), jnp.asarray(ints["start"]), jnp.asarray(ints["offset"]),
        jnp.asarray(ints["qpos"]), H**-0.5, softcap, window)
    assert got.shape == (B, D, K * G * H) and got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(want)) <= ATTN_TOL[dtype]


def test_k3_split_over_query_heads_equals_one_launch():
    """More than 32 rows a kv head (G 4 x D 16 = 64): the wrapper's split
    into runs of whole query heads, each a launch of its own, puts the
    partials back in row order; here each run goes through K3's plain
    version and the whole against one plain call."""
    rng = np.random.default_rng(4)
    B, K, G, D, H, P, nb = 2, 2, 4, 16, 32, 8, 3
    q = torch.from_numpy(rng.normal(size=(B, K * G * D, H)).astype(np.float32))
    pools = [torch.from_numpy(rng.normal(size=(K, B * nb + 1, P, H)).astype(np.float32))
             for _ in range(2)]
    table = torch.arange(B * nb, dtype=torch.int32).reshape(B, nb)
    last = torch.tensor([17, 23], dtype=torch.int32)
    kw = dict(q_positions=last + 1, n_blocks=nb, scale=H**-0.5, softcap=0.0, window=11,
              q_blocks=D)
    runs = []

    def attend(part):
        runs.append(part.shape[1] // K)
        return k3.paged_decode_attention(part, pools[0], pools[1], table, last, **kw)

    got = k3.split_rows(q, K, D, attend)
    want = k3.paged_decode_attention(q, pools[0], pools[1], table, last, **kw)
    assert runs == [32, 32]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="32 query rows"):
        k3.split_rows(q.reshape(B, K * G // 2 * D * 2, H)[:, : K * 64], K, 64, attend)


# --------------------------------------------------------------------- #
# Protocol-s in fp32, port against JAX: the model drafts and the chunk
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def protocol_s():
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


SPEC_PROMPTS = [
    '<|user|>\nList the findings of report 7 as JSON.\n<|assistant|>\n{"findings": [',
    "<|user|>\nValidate the extracted sections.\n<|assistant|>\n",
    '<|user|>\nPlan step 3.\n<|assistant|>\n{"step": 3, "step": 3, "step"',
]


def _state_pair(cfg, params, jcfg, jparams, cache_kind, jsonm, budgets, max_seq=192, P=16):
    """Both packages' caches, decode and sampling states and histories after
    one admission of ``SPEC_PROMPTS`` into slots 0-2 of four."""
    tok = ByteTokenizer()
    ids = [tok.encode(p) for p in SPEC_PROMPTS]
    A, B, T = 3, 4, 128
    tokens = np.zeros((A, T), np.int64)
    for row, p in enumerate(ids):
        tokens[row, : len(p)] = p
    lens = [len(p) for p in ids]
    mi, mf = decode.pack_admit_meta(A, slots=range(A), seeds=range(A), eos=[EOS] * A,
                                    jsonm=[int(j) for j in jsonm], budgets=[b - 1 for b in budgets],
                                    lens=lens, pad_slot=B)
    L, K, H = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    page_rows = table = None
    if cache_kind == "paged":
        alloc = paged.PageAllocator(B * max_seq // P + 1, P, B, max_seq // P)
        for s in range(A):
            assert alloc.allocate(s, max_seq)
        table = alloc.table.copy()
        page_rows = table[:A]
        cache = paged.PagedKVCache.create(L, B, alloc.num_pages, P, K, H, torch.float32, CPU)
        jcache = jpaged.PagedKVCache.create(L, B, alloc.num_pages, P, K, H, dtype=jnp.float32)
    else:
        cache = KVCache.create(L, B, max_seq, K, H, torch.float32, CPU)
        jcache = jkvcache.KVCache.create(L, B, max_seq, K, H, dtype=jnp.float32)
    history = torch.zeros((B, max_seq + 1), dtype=torch.int32)
    cache, dstate, samp, first = decode.admit_group(
        params, cfg, cache, decode.DecodeState.create(B, CPU),
        sampling.SamplingState.create(B, CPU), tokens, mi, mf, page_rows=page_rows,
        history=history)
    jcache, jd, js, jfirst, jhist = jdecode.admit_group(
        jparams, jcfg, jcache, jdecode.DecodeState.create(B), jsampling.SamplingState.create(B),
        jnp.asarray(tokens.astype(np.int32)), jnp.asarray(mi), jnp.asarray(mf), use_flash=False,
        page_rows=None if page_rows is None else jnp.asarray(page_rows),
        history=jnp.zeros((B, max_seq), jnp.int32))
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    np.testing.assert_array_equal(history.numpy()[:, :max_seq], np.asarray(jhist))
    return (cache, dstate, samp, history, table), (jcache, jd, js, jhist)


def _cache_rows(cache, table, lengths):
    """Each slot's cache rows up to its length, ``[K, n, H]`` per layer and
    slot (through the block table on the paged cache)."""
    out = []
    for k, v in cache.layers:
        for arr in (np.asarray(k), np.asarray(v)):
            for b, n in enumerate(lengths):
                if table is None:
                    out.append(arr[b, :, :n])
                else:
                    P = arr.shape[2]
                    pages = table[b, : -(-n // P)]
                    out.append(arr[:, pages].reshape(arr.shape[0], -1, arr.shape[3])[:, :n])
    return out


CHUNK_CASES = {f"{c}_D{D}_{'fused' if fu else 'sampler'}": (c, D, fu, False)
               for c in ("dense", "paged") for D in (2, 4, 8) for fu in (False, True)}
# Model drafts for slots 0 and 2, n-gram drafts for the others.
CHUNK_CASES.update({f"{c}_D4_model_drafts": (c, 4, False, True) for c in ("dense", "paged")})


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_decode_chunk_spec_matches_jax(protocol_s, case):
    """Two speculative chunks of 3 blocks on protocol-s (fp32), port against
    the JAX function: tokens, valid rows, lengths, the decode and JSON
    states, every slot's cache rows and its history; greedy slots, one of
    them under the JSON mask (the sampler path), budgets that end inside a
    chunk; and with model drafts for two slots of four (the JAX paged
    drafts read gathered panels, the port's K3)."""
    cache_kind, D, fused, drafts = CHUNK_CASES[case]
    cfg, params, jcfg, jparams = protocol_s
    mode = [True, False, True, False]
    kw = dict(draft_layers=2, draft_mode=torch.tensor(mode)) if drafts else {}
    jkw = dict(draft_layers=2, draft_mode=jnp.asarray(mode)) if drafts else {}
    jsonm = [not fused, False, not fused]
    budgets = [9, 30, 14]
    ours, theirs = _state_pair(cfg, params, jcfg, jparams, cache_kind, jsonm, budgets)
    cache, dstate, samp, history, table = ours
    jcache, jd, js, jhist = theirs
    for _ in range(2):
        toks, valid, cache, dstate, samp, history = decode.decode_chunk_spec(
            params, cfg, cache, dstate, samp, history, 3, D, prefix_bound=128,
            table=None if table is None else torch.from_numpy(table), fused_epilogue=fused,
            **kw)
        jt, jv, jcache, jd, js, jhist = jdecode.decode_chunk_spec(
            jparams, jcfg, jcache, jd, js, jhist, 3, D, prefix_bound=128,
            table=None if table is None else jnp.asarray(table), fused_epilogue=fused, **jkw)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(np.where(valid.numpy(), toks.numpy(), 0),
                                      np.where(np.asarray(jv), np.asarray(jt), 0))
    lengths = cache.lengths.numpy()
    np.testing.assert_array_equal(lengths, np.asarray(jcache.lengths))
    for name in ("tokens", "done", "budget"):
        np.testing.assert_array_equal(getattr(dstate, name).numpy(), np.asarray(getattr(jd, name)))
    for name in ("json_state", "json_stack", "json_depth"):
        np.testing.assert_array_equal(getattr(samp, name).numpy(), np.asarray(getattr(js, name)))
    np.testing.assert_array_equal(history.numpy()[:, :-1], np.asarray(jhist))
    for a, b in zip(_cache_rows(cache, table, lengths), _cache_rows(jcache, table, lengths)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", ["sampler", "fused", "model_drafts"])
@pytest.mark.parametrize("cache_kind", ["dense", "paged"])
def test_spec_chunk_makes_no_host_read(protocol_s, cache_kind, variant, monkeypatch):
    """Inside the speculative chunk nothing reads the device back or makes a
    shape from data (it is captured as a CUDA graph on the card): the
    host-read entry points raise while it runs."""
    cfg, params, jcfg, jparams = protocol_s
    ours, _ = _state_pair(cfg, params, jcfg, jparams, cache_kind, [variant == "sampler"] * 3,
                          [30] * 3)
    cache, dstate, samp, history, table = ours
    kw = dict(fused_epilogue=variant == "fused")
    if variant == "model_drafts":
        kw.update(draft_layers=2, draft_mode=torch.tensor([True, False, True, False]))
    table = None if table is None else torch.from_numpy(table)

    def refuse(*_a, **_k):
        raise AssertionError("host read inside the speculative chunk")

    for name in ("item", "__bool__", "cpu", "tolist", "numpy", "__int__", "__float__",
                 "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    t, v, *_ = decode.decode_chunk_spec(params, cfg, cache, dstate, samp, history, 3, 4,
                                        prefix_bound=128, table=table, **kw)
    monkeypatch.undo()
    assert v.shape == (12, 4) and bool(v[0, :3].all())


@pytest.mark.parametrize("cache_kind", ["dense", "paged"])
def test_model_drafts_match_jax(protocol_s, cache_kind):
    """The shallow-layer drafts (2 of protocol-s's 4 layers) over an
    admitted prefix and a half-filled ring: the same D - 1 draft ids as
    the JAX function's (its paged path reads gathered panels)."""
    cfg, params, jcfg, jparams = protocol_s
    D = 4
    ours, theirs = _state_pair(cfg, params, jcfg, jparams, cache_kind, [False] * 3, [20] * 3)
    cache, dstate, _, _, table = ours
    jcache = theirs[0]
    B, K, H = 4, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(6)
    R = 8
    rings_np = [[rng.normal(size=(B, K, R, H)).astype(np.float32) for _ in range(2)]
                for _ in range(cfg.n_layers)]
    rings = [tuple(torch.from_numpy(x) for x in r) for r in rings_np]
    start = cache.lengths.clone()
    offset = torch.tensor([3, 0, 5, 0], dtype=torch.int32)
    pos = start + offset
    cur = dstate.tokens.clone()
    bufs = [tuple(torch.zeros((B, K, D - 1, H)) for _ in range(2)) for _ in range(2)]
    got = decode._model_drafts(params, cfg, 2, cur, pos, cache, rings, start, offset, start - 1,
                               bufs, table=None if table is None else torch.from_numpy(table),
                               n_blocks=None if table is None else 8)
    if table is None:
        panels = tuple((k[:, :, :128], v[:, :, :128], None) for k, v in jcache.layers)
    else:
        jt = jnp.asarray(table)
        panels = tuple((jpaged.gather_pages(k, jt, 8), jpaged.gather_pages(v, jt, 8), None)
                       for k, v in jcache.layers)
    want = jdecode._model_drafts(
        jparams, jcfg, 2, D - 1, jnp.asarray(cur.numpy()), jnp.asarray(pos.numpy()), panels,
        tuple(tuple(jnp.asarray(x) for x in r) for r in rings_np), jnp.asarray(start.numpy()),
        jnp.asarray(offset.numpy()), jnp.asarray(start.numpy() - 1), None, jcfg.window_sizes(),
        jcfg.head_dim**-0.5)
    assert got.shape == (B, D - 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------- #
# The JAX package's speculative cases, on the port (llama-tiny, fp32)
# --------------------------------------------------------------------- #

# Prompts with internal repetition, so the n-gram drafts fire.
PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [9, 9, 9, 9, 9, 9], [3, 4, 3, 4, 3, 4, 3]]


def _tiny(seed=0, **replace):
    jcfg = jregistry.get_model_config("llama-tiny").replace(dtype=jnp.float32, **replace)
    cfg = registry.get_model_config("llama-tiny").replace(dtype=torch.float32, **replace)
    jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device=CPU)


def _admit(cfg, params, prompts, budgets, temps=None, n_slots=4, max_seq=128):
    """The JAX tests' admission on the port: ``prompts`` into slots 0..A-1,
    budgets counting the first token, the history installed."""
    A = len(prompts)
    T = max(16, 1 << (max(len(p) for p in prompts) - 1).bit_length())
    tokens = np.zeros((A, T), np.int64)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = p
    mi, mf = decode.pack_admit_meta(
        A, slots=range(A), temps=temps or [0.0] * A, seeds=range(A), eos=[-1] * A,
        budgets=[b - 1 for b in budgets], lens=[len(p) for p in prompts], pad_slot=n_slots)
    cache = KVCache.create(cfg.n_layers, n_slots, max_seq, cfg.n_kv_heads, cfg.head_dim,
                           torch.float32, CPU)
    history = torch.zeros((n_slots, max_seq + 1), dtype=torch.int32)
    cache, dstate, samp, first = decode.admit_group(
        params, cfg, cache, decode.DecodeState.create(n_slots, CPU),
        sampling.SamplingState.create(n_slots, CPU), tokens, mi, mf, history=history)
    return cache, dstate, samp, history, first.numpy()[:A]


def _collect(toks, valid, n_slots):
    out = [[] for _ in range(n_slots)]
    for i in range(toks.shape[0]):
        for b in range(n_slots):
            if valid[i, b]:
                out[b].append(int(toks[i, b]))
    return out


def _plain_stream(cfg, params, chunks, steps, budgets, temps=None):
    c, d, s, _, first = _admit(cfg, params, PROMPTS, budgets, temps)
    out = [[] for _ in range(4)]
    for _ in range(chunks):
        t, v, c, d, s = decode.decode_chunk(params, cfg, c, d, s, steps)
        for b, seq in enumerate(_collect(t, v, 4)):
            out[b].extend(seq)
    return out, c, first


def _spec_stream(cfg, params, chunks, blocks, budgets, temps=None, D=4, **kw):
    c, d, s, h, first = _admit(cfg, params, PROMPTS, budgets, temps)
    out = [[] for _ in range(4)]
    for _ in range(chunks):
        t, v, c, d, s, h = decode.decode_chunk_spec(params, cfg, c, d, s, h, blocks, D, **kw)
        for b, seq in enumerate(_collect(t, v, 4)):
            out[b].extend(seq)
    return out, c, h, first


def _case_greedy_parity(**replace):
    """The speculative chunk emits the plain chunk's greedy stream and
    lengths, and the history holds prompt and output by position."""
    cfg, params = _tiny(**replace)
    plain, c1, f1 = _plain_stream(cfg, params, 4, 8, [25] * 3)
    spec, c2, h, f2 = _spec_stream(cfg, params, 4, 8, [25] * 3)
    np.testing.assert_array_equal(f1, f2)
    assert spec[:3] == plain[:3]
    assert torch.equal(c1.lengths, c2.lengths)
    for b in range(3):
        want = PROMPTS[b] + [int(f2[b])] + spec[b]
        assert h[b, : len(want)].tolist() == want


def _case_budget_exact():
    cfg, params = _tiny()
    for budget in (2, 3, 5):
        c, d, s, h, _ = _admit(cfg, params, PROMPTS, [budget] * 3)
        total = [0, 0, 0]
        for _ in range(3):
            t, v, c, d, s, h = decode.decode_chunk_spec(params, cfg, c, d, s, h, 4, 4)
            for b, seq in enumerate(_collect(t, v, 4)[:3]):
                total[b] += len(seq)
        assert total == [budget - 1] * 3, (budget, total)


def _case_acceptance_fires():
    """A greedy stream that cycles must pass 1.5 tokens a block."""
    cfg, params = _tiny()
    c, d, s, h, _ = _admit(cfg, params, [[7, 8, 9, 7, 8]], [60], n_slots=2)
    emitted = 0
    for _ in range(4):
        t, v, c, d, s, h = decode.decode_chunk_spec(params, cfg, c, d, s, h, 4, 4)
        emitted += int(v[:, 0].sum())
    assert emitted >= 1.5 * 16, emitted


def _case_sampled_one_token_a_block():
    cfg, params = _tiny()
    spec, *_ = _spec_stream(cfg, params, 4, 3, [10] * 3, temps=[1.0, 0.0, 1.0])
    for b in range(3):
        assert len(spec[b]) == 9
        assert all(0 <= t < cfg.vocab_size for t in spec[b])


def _case_sampled_same_stream_with_and_without_speculation():
    """A sampled slot draws once a block where the plain chunk draws once a
    step, from the slot's own generator: the same seed gives the same ids."""
    cfg, params = _tiny()
    temps = [1.3, 0.7, 2.0]
    plain, _, f1 = _plain_stream(cfg, params, 4, 4, [15] * 3, temps)
    spec, _, _, f2 = _spec_stream(cfg, params, 5, 4, [15] * 3, temps)
    np.testing.assert_array_equal(f1, f2)
    assert spec[:3] == plain[:3]
    assert all(len(x) == 14 for x in spec[:3])


def _case_model_draft_parity(mode=(True, True, True, True), **replace):
    cfg, params = _tiny(**replace)
    plain, c1, _ = _plain_stream(cfg, params, 4, 8, [25] * 3)
    spec, c2, _, _ = _spec_stream(cfg, params, 4, 8, [25] * 3, draft_layers=2,
                                  draft_mode=torch.tensor(mode))
    assert spec[:3] == plain[:3]
    assert torch.equal(c1.lengths, c2.lengths)


def _case_model_drafts_accept_on_shallow_agreement():
    """A draft through every layer is the model: every block that does not
    end its slot accepts all D - 1 drafts."""
    cfg, params = _tiny(seed=1)
    c, d, s, h, _ = _admit(cfg, params, [[7, 8, 9, 10, 11]], [40], n_slots=2)
    emitted = blocks = 0
    for _ in range(4):
        t, v, c, d, s, h = decode.decode_chunk_spec(
            params, cfg, c, d, s, h, 4, 4, draft_layers=cfg.n_layers,
            draft_mode=torch.tensor([True, True]))
        emitted += int(v[:, 0].sum())
        blocks += int(v.numpy().reshape(4, 4, 2)[:, :, 0].any(axis=1).sum())
    assert emitted / max(blocks, 1) >= 3.5, (emitted, blocks)


WINDOWED = dict(sliding_window=6, sliding_pattern=2, attn_softcap=30.0)
JAX_CASES = {
    "greedy_parity": _case_greedy_parity,
    "greedy_parity_window_softcap": lambda: _case_greedy_parity(**WINDOWED),
    "budget_exact": _case_budget_exact,
    "acceptance_fires": _case_acceptance_fires,
    "sampled_one_token_a_block": _case_sampled_one_token_a_block,
    "sampled_same_stream_spec_on_and_off": _case_sampled_same_stream_with_and_without_speculation,
    "model_draft_greedy_parity": _case_model_draft_parity,
    "model_draft_greedy_parity_window_softcap": lambda: _case_model_draft_parity(**WINDOWED),
    "model_draft_mixed_mode_parity": lambda: _case_model_draft_parity((True, False, True, False)),
    "model_drafts_accept_on_shallow_agreement": _case_model_drafts_accept_on_shallow_agreement,
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_jax_speculative_case_on_the_port(case):
    JAX_CASES[case]()
