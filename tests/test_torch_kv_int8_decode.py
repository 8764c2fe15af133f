"""Slice P5b at the decode functions: admission, the plain chunk and the
speculative chunk (n-gram and model drafts) on an int8 cache, dense and
paged, on the trained protocol-s checkpoint in fp32, against the JAX
engine's device functions with an int8 cache (its CPU path: the dense
prefix and the gathered pages read with the scales after the dots). The
greedy tokens, valid rows, lengths and states must be identical and the
caches' int8 rows and scales agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.engine import decode as jdecode
from pilottai_tpu.engine import sampling as jsampling
from pilottai_tpu.models import registry as jregistry
from pilottai_tpu.ops import kvcache as jkvcache
from pilottai_tpu.ops import paged as jpaged
from pilottai_tpu_torch.engine import decode, sampling
from pilottai_tpu_torch.engine.tokenizer import ByteTokenizer
from pilottai_tpu_torch.models import registry
from pilottai_tpu_torch.models.loader import PROTOCOL_S_NPZ, load_npz
from pilottai_tpu_torch.ops import paged
from pilottai_tpu_torch.ops.kvcache import KVCache

CPU = torch.device("cpu")
EOS = ByteTokenizer().eos_id
PROMPTS = [
    '<|user|>\nList the findings of report 7 as JSON.\n<|assistant|>\n{"findings": [',
    "<|user|>\nValidate the extracted sections.\n<|assistant|>\n",
    '<|user|>\nPlan step 3.\n<|assistant|>\n{"step": 3, "step": 3, "step"',
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _admitted(cfg, params, jcfg, jparams, cache_kind, spec, max_seq=192, P=16):
    """Both packages' int8 caches and states after one admission of
    ``PROMPTS`` into slots 0-2 of four (the first JSON-masked, budgets that
    end inside the second chunk)."""
    tok = ByteTokenizer()
    ids = [tok.encode(p) for p in PROMPTS]
    A, B, T = 3, 4, 128
    tokens = np.zeros((A, T), np.int64)
    for row, p in enumerate(ids):
        tokens[row, : len(p)] = p
    mi, mf = decode.pack_admit_meta(A, slots=range(A), seeds=range(A), eos=[EOS] * A,
                                    jsonm=[1, 0, 0], budgets=[8, 29, 13],
                                    lens=[len(p) for p in ids], pad_slot=B)
    L, K, H = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    page_rows = table = None
    if cache_kind == "paged":
        alloc = paged.PageAllocator(B * max_seq // P + 1, P, B, max_seq // P)
        for s in range(A):
            assert alloc.allocate(s, max_seq)
        table = alloc.table.copy()
        page_rows = table[:A]
        cache = paged.PagedKVCache.create(L, B, alloc.num_pages, P, K, H, torch.float32, CPU,
                                          quantized=True)
        jcache = jpaged.PagedKVCache.create(L, B, alloc.num_pages, P, K, H, dtype=jnp.float32,
                                            quantized=True)
    else:
        cache = KVCache.create(L, B, max_seq, K, H, torch.float32, CPU, quantized=True)
        jcache = jkvcache.KVCache.create(L, B, max_seq, K, H, dtype=jnp.float32, quantized=True)
    history = torch.zeros((B, max_seq + 1), dtype=torch.int32) if spec else None
    cache, dstate, samp, first = decode.admit_group(
        params, cfg, cache, decode.DecodeState.create(B, CPU),
        sampling.SamplingState.create(B, CPU), tokens, mi, mf, page_rows=page_rows,
        history=history)
    jcache, jd, js, jfirst, jhist = jdecode.admit_group(
        jparams, jcfg, jcache, jdecode.DecodeState.create(B), jsampling.SamplingState.create(B),
        jnp.asarray(tokens.astype(np.int32)), jnp.asarray(mi), jnp.asarray(mf), use_flash=False,
        page_rows=None if page_rows is None else jnp.asarray(page_rows),
        history=jnp.zeros((B, max_seq), jnp.int32) if spec else None)
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    return (cache, dstate, samp, history, table), (jcache, jd, js, jhist)


def _rows(cache, table, lengths):
    """Each slot's int8 rows and scales up to its length, per layer (through
    the block table on the paged cache)."""
    out = []
    for pair, spair in zip(cache.layers, cache.scales):
        for arr, sc in zip(pair, spair):
            arr, sc = np.asarray(arr), np.asarray(sc)
            for b, n in enumerate(lengths):
                if table is None:
                    out.append((arr[b, :, :n], sc[b, :, :n]))
                else:
                    K, _, P, H = arr.shape
                    pages = table[b, : -(-n // P)]
                    out.append((arr[:, pages].reshape(K, -1, H)[:, :n],
                                sc[:, pages].reshape(K, -1)[:, :n]))
    return out


CASES = {
    "dense_plain": ("dense", 0, False),
    "paged_plain": ("paged", 0, False),
    "dense_spec": ("dense", 4, False),
    "paged_spec": ("paged", 4, False),
    "dense_spec_model_drafts": ("dense", 4, True),
    "paged_spec_model_drafts": ("paged", 4, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_int8_chunks_match_jax(protocol_s, case):
    """Two chunks (8 steps, or 3 verify blocks of D = 4) after one
    admission, on an int8 cache: the same tokens, valid rows, lengths and
    decode states as the JAX functions', and the same int8 rows (a
    quantized value may sit one step apart where the two prefills' fp32
    K/V straddle a rounding boundary) and scales; the rings in fp32."""
    cache_kind, D, drafts = CASES[case]
    cfg, params, jcfg, jparams = protocol_s
    ours, theirs = _admitted(cfg, params, jcfg, jparams, cache_kind, spec=bool(D))
    cache, dstate, samp, history, table = ours
    jcache, jd, js, jhist = theirs
    tbl = None if table is None else torch.from_numpy(table)
    jtbl = None if table is None else jnp.asarray(table)
    mode = [True, False, True, False]
    for _ in range(2):
        if D:
            kw = dict(draft_layers=2, draft_mode=torch.tensor(mode)) if drafts else {}
            jkw = dict(draft_layers=2, draft_mode=jnp.asarray(mode)) if drafts else {}
            toks, valid, cache, dstate, samp, history = decode.decode_chunk_spec(
                params, cfg, cache, dstate, samp, history, 3, D, prefix_bound=128, table=tbl,
                **kw)
            jt, jv, jcache, jd, js, jhist = jdecode.decode_chunk_spec(
                jparams, jcfg, jcache, jd, js, jhist, 3, D, prefix_bound=128, table=jtbl, **jkw)
        else:
            bufs = decode.ChunkBuffers.create(cfg, 4, 8, decode.ring_dtype(cfg, cache), CPU)
            assert bufs.rings[0][0].dtype == torch.float32
            toks, valid, cache, dstate, samp = decode.decode_chunk(
                params, cfg, cache, dstate, samp, 8, table=tbl, bufs=bufs)
            jt, jv, jcache, jd, js = jdecode.decode_chunk(
                jparams, jcfg, jcache, jd, js, 8, use_pallas=False, table=jtbl)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(np.where(valid.numpy(), toks.numpy(), 0),
                                      np.where(np.asarray(jv), np.asarray(jt), 0))
    lengths = cache.lengths.numpy()
    np.testing.assert_array_equal(lengths, np.asarray(jcache.lengths))
    for name in ("tokens", "done", "budget"):
        np.testing.assert_array_equal(getattr(dstate, name).numpy(), np.asarray(getattr(jd, name)))
    if D:
        np.testing.assert_array_equal(history.numpy()[:, :-1], np.asarray(jhist))
    for (q, s), (qj, sj) in zip(_rows(cache, table, lengths), _rows(jcache, table, lengths)):
        assert q.dtype == np.int8
        assert np.abs(q.astype(np.int32) - qj.astype(np.int32)).max(initial=0) <= 1
        assert np.count_nonzero(q != qj) <= 0.01 * q.size
        # The scales follow the two fp32 prefills' K/V, which differ by
        # summation order (tests/test_torch_decode.py holds them to 1e-4).
        np.testing.assert_allclose(s, sj, rtol=1e-4, atol=0)


@pytest.mark.parametrize("case", ["dense_plain", "paged_plain", "dense_spec_model_drafts",
                                  "paged_spec_model_drafts"])
def test_int8_chunk_makes_no_host_read(protocol_s, case, monkeypatch):
    """The int8 reads and the chunk-end quantizing write stay capturable:
    nothing inside the chunk reads the device back or makes a shape from
    data (the host-read entry points raise while it runs)."""
    cache_kind, D, drafts = CASES[case]
    cfg, params, jcfg, jparams = protocol_s
    ours, _ = _admitted(cfg, params, jcfg, jparams, cache_kind, spec=bool(D))
    cache, dstate, samp, history, table = ours
    tbl = None if table is None else torch.from_numpy(table)
    mode = torch.tensor([True, False, True, False])

    def refuse(*_a, **_k):
        raise AssertionError("host read inside the decode chunk")

    for name in ("item", "__bool__", "cpu", "tolist", "numpy", "__int__", "__float__",
                 "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    if D:
        v = decode.decode_chunk_spec(params, cfg, cache, dstate, samp, history, 2, D,
                                     prefix_bound=128, table=tbl, draft_layers=2,
                                     draft_mode=mode)[1]
    else:
        v = decode.decode_chunk(params, cfg, cache, dstate, samp, 4, table=tbl,
                                n_blocks=None if tbl is None else tbl.shape[1])[1]
    monkeypatch.undo()
    assert bool(v[0, :3].all())
