"""Slice P5b, the int8 KV cache, on the CPU against the JAX package on the
same numpy inputs: ``quantize_kv`` byte for byte as the JAX engine runs it
(under ``jit``), the four cache writes (dense prompts and chunk rows, paged
prompts and chunk rows), ``export_prefix``, the plain version of kernel
K2 with scales against ``_prefix_stats_dense`` and of K3 on int8 pools
against the TPU kernel in interpret mode, the dense verify's int8 prefix
(``_spec_block_attn``) and the dequantized page chain of a tail prefill.
The engines' greedy ids are ``tests/test_torch_kv_int8_engine.py``, the
card's side ``tests/test_torch_kv_int8_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.engine import decode as jdecode
from pilottai_tpu.ops import kvcache as jkv
from pilottai_tpu.ops import paged as jpaged
from pilottai_tpu.ops.pallas.paged_attention import paged_decode_attention as jpaged_attention
from pilottai_tpu_torch.engine import decode
from pilottai_tpu_torch.ops import kvcache, paged
from pilottai_tpu_torch.ops.attention import NEG_INF
from pilottai_tpu_torch.ops.kernels import decode_attention as k2
from pilottai_tpu_torch.ops.kernels import paged_attention as k3

CPU = torch.device("cpu")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    """A torch or JAX array as numpy, floats as float32."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def _t(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def cache_from_jax(jcache, device=CPU):
    """A JAX ``KVCache`` or ``PagedKVCache`` (int8 with scales, or float)
    as the port's, through numpy."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(device)
        return torch.from_numpy(a.copy()).to(device)

    layers = [(conv(k), conv(v)) for k, v in jcache.layers]
    scales = None if jcache.scales is None else [(conv(k), conv(v)) for k, v in jcache.scales]
    cls = paged.PagedKVCache if isinstance(jcache, jpaged.PagedKVCache) else kvcache.KVCache
    return cls(layers=layers, lengths=conv(jcache.lengths), scales=scales)


def _caches_equal(cache, jcache, paged_pool=False):
    """Int8 bytes and fp32 scales equal everywhere (the scratch page
    aside: its dropped writes land in an unspecified order)."""
    cut = (slice(None), slice(0, -1)) if paged_pool else (slice(None),)
    for (kt, vt), (kj, vj) in zip(cache.layers, jcache.layers):
        assert kt.dtype == torch.int8
        np.testing.assert_array_equal(kt.numpy()[cut], np.asarray(kj)[cut])
        np.testing.assert_array_equal(vt.numpy()[cut], np.asarray(vj)[cut])
    for (kt, vt), (kj, vj) in zip(cache.scales, jcache.scales):
        assert kt.dtype == torch.float32
        np.testing.assert_array_equal(kt.numpy()[cut], np.asarray(kj)[cut])
        np.testing.assert_array_equal(vt.numpy()[cut], np.asarray(vj)[cut])
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))


# --------------------------------------------------------------------- #
# quantize_kv and the cache writes
# --------------------------------------------------------------------- #


def _kv_rows(rng, shape):
    """Random rows over four decades of magnitude, with rows of zeros and a
    row of exact ties (x / scale at k + 0.5)."""
    x = rng.standard_normal(shape).astype(np.float32)
    x *= 10.0 ** rng.uniform(-2, 2, shape[:-1] + (1,)).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    flat[5] = 0.0
    flat[3] = 0.0
    flat[3, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -126.5]
    return x


def _attn_rows(rng, shape):
    """Unit-normal keys or values with a row of zeros: logits of the size a
    model's are (the wide rows above would put fp32's summation order into
    the exponent)."""
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1, shape[-1])[1] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_gives_the_jax_engines_bytes(dtype):
    """The same int8 bytes and fp32 scales as the JAX function under
    ``jit`` (as the JAX engine's admission and decode chunk run it), on
    zero rows and ties too; and the same dequantized values."""
    jdt, tdt = DTYPES[dtype]
    x = _kv_rows(np.random.default_rng(7), (3, 4, 50, 32))
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    q, s = kvcache.quantize_kv(xt)
    qj, sj = jax.jit(jkv.quantize_kv)(xj)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == x.shape[:-1]
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    flat_q = q.reshape(-1, 32).numpy()
    assert (flat_q[0] == 0).all() and s.reshape(-1)[0] == np.float32(1e-8)
    if dtype == "float32":
        # Round half to even on the ties (the scale of that row is 1.0).
        assert s.reshape(-1)[3] == 1.0
        np.testing.assert_array_equal(flat_q[3, :6], [127, 0, 2, 2, 0, -126])
    for out in (torch.float32, torch.bfloat16):
        jout = jnp.float32 if out == torch.float32 else jnp.bfloat16
        np.testing.assert_array_equal(
            _np(kvcache.dequantize_kv(q, s, out)), _np(jkv.dequantize_kv(qj, sj, jout)))
    # Dequantizing in fp32 and quantizing again gives the same bytes.
    q2, s2 = kvcache.quantize_kv(kvcache.dequantize_kv(q, s, torch.float32))
    q2j, s2j = jax.jit(jkv.quantize_kv)(jkv.dequantize_kv(qj, sj, jnp.float32))
    np.testing.assert_array_equal(q2.numpy(), np.asarray(q2j))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s2j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_writes_give_the_jax_bytes(dtype):
    """``write_prompts`` (a padding row, a short row) and
    ``write_chunk_rows`` (rows past ``accepted``, rows past the panel)
    leave the int8 bytes, scales and lengths of the jitted JAX
    functions."""
    jdt, tdt = DTYPES[dtype]
    L, A, T, K, H, B, S = 2, 3, 24, 2, 32, 4, 40
    rng = np.random.default_rng(11)
    ks = _kv_rows(rng, (L, A, T, K, H))
    vs = _kv_rows(rng, (L, A, T, K, H))
    slots, lens = [2, 0, 3], [24, 9, 0]
    cache = kvcache.KVCache.create(L, B, S, K, H, tdt, CPU, quantized=True)
    jcache = jkv.KVCache.create(L, B, S, K, H, jdt, quantized=True)
    assert cache.scales is not None and cache.layers[0][0].dtype == torch.int8
    assert cache.scales[0][0].shape == (B, K, S)
    ksj, vsj = jnp.asarray(ks, jdt), jnp.asarray(vs, jdt)
    cache = kvcache.write_prompts(cache, slots, _t(np.asarray(ksj.astype(jnp.float32)), tdt),
                                  _t(np.asarray(vsj.astype(jnp.float32)), tdt), lens)
    jcache = jax.jit(jkv.write_prompts)(jcache, jnp.asarray(slots), ksj, vsj, jnp.asarray(lens))
    _caches_equal(cache, jcache)

    n = 8
    ring_k = [_kv_rows(rng, (B, K, n, H)) for _ in range(L)]
    ring_v = [_kv_rows(rng, (B, K, n, H)) for _ in range(L)]
    rkj = [jnp.asarray(r, jdt) for r in ring_k]
    rvj = [jnp.asarray(r, jdt) for r in ring_v]
    start = np.array([0, 9, 24, 36], np.int32)     # slot 3's rows pass S = 40
    accepted = np.array([0, 8, 3, 8], np.int32)
    cache.lengths.copy_(torch.from_numpy(start))
    jcache = jcache._replace(lengths=jnp.asarray(start))
    cache = kvcache.write_chunk_rows(
        cache, [_t(np.asarray(r.astype(jnp.float32)), tdt) for r in rkj],
        [_t(np.asarray(r.astype(jnp.float32)), tdt) for r in rvj], torch.from_numpy(start),
        torch.from_numpy(accepted))
    jcache = jax.jit(jkv.write_chunk_rows)(jcache, rkj, rvj, jnp.asarray(start),
                                           jnp.asarray(accepted))
    _caches_equal(cache, jcache)


@pytest.mark.parametrize("pos_offset", [0, 8])
def test_paged_writes_give_the_jax_bytes(pos_offset):
    """``write_prompts_paged`` (a padding row, a segment at a page-aligned
    offset) and ``write_chunk_rows_paged`` leave the int8 bytes and scale
    pools of the jitted JAX functions on every page but the scratch page,
    whose scales stay finite."""
    L, A, T, Kh, Hd, Pg, n_slots, max_pages = 2, 3, 20, 2, 32, 4, 4, 8
    num_pages = 24
    rng = np.random.default_rng(pos_offset + 3)
    alloc = paged.PageAllocator(num_pages, Pg, n_slots, max_pages)
    assert alloc.allocate(1, pos_offset + 20) and alloc.allocate(3, pos_offset + 9)
    rows = np.full((A, max_pages), alloc.sentinel, np.int32)
    rows[0], rows[1] = alloc.table[1], alloc.table[3]
    lens = [20, 7, 0]
    ks = _kv_rows(rng, (L, A, T, Kh, Hd))
    vs = _kv_rows(rng, (L, A, T, Kh, Hd))
    cache = paged.PagedKVCache.create(L, n_slots, num_pages, Pg, Kh, Hd, torch.float32, CPU,
                                      quantized=True)
    jcache = jpaged.PagedKVCache.create(L, n_slots, num_pages, Pg, Kh, Hd, jnp.float32,
                                        quantized=True)
    assert cache.scales[0][0].shape == (Kh, num_pages, Pg)
    cache = paged.write_prompts_paged(cache, torch.from_numpy(rows), torch.from_numpy(ks),
                                      torch.from_numpy(vs), lens, pos_offset=pos_offset)
    jcache = jax.jit(jpaged.write_prompts_paged)(
        jcache, jnp.asarray(rows), jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(lens),
        jnp.int32(pos_offset))
    cache = paged.install_lengths(cache, [1, 3, n_slots], [pos_offset + n for n in lens])
    jcache = jpaged.install_lengths(jcache, jnp.asarray([1, 3, n_slots]),
                                    jnp.asarray([pos_offset + n for n in lens]))
    _caches_equal(cache, jcache, paged_pool=True)

    n = 4
    ring_k = [_kv_rows(rng, (n_slots, Kh, n, Hd)) for _ in range(L)]
    ring_v = [_kv_rows(rng, (n_slots, Kh, n, Hd)) for _ in range(L)]
    start = cache.lengths.clone()
    accepted = np.array([0, 4, 0, 2], np.int32)
    table = alloc.table.copy()
    cache = paged.write_chunk_rows_paged(
        cache, torch.from_numpy(table), [torch.from_numpy(r) for r in ring_k],
        [torch.from_numpy(r) for r in ring_v], start, torch.from_numpy(accepted))
    jcache = jax.jit(jpaged.write_chunk_rows_paged)(
        jcache, jnp.asarray(table), [jnp.asarray(r) for r in ring_k],
        [jnp.asarray(r) for r in ring_v], jnp.asarray(start.numpy()), jnp.asarray(accepted))
    _caches_equal(cache, jcache, paged_pool=True)
    for ksc, vsc in cache.scales:
        assert torch.isfinite(ksc[:, -1]).all() and torch.isfinite(vsc[:, -1]).all()


def test_export_prefix_is_the_jax_fp32_entry():
    """An int8 cache exports its slot dequantized in fp32, equal to the JAX
    function's; a float cache exports its own rows."""
    L, B, S, K, H = 2, 3, 48, 2, 32
    rng = np.random.default_rng(5)
    jcache = jkv.KVCache.create(L, B, S, K, H, jnp.float32, quantized=True)
    ks = jnp.asarray(_kv_rows(rng, (L, 2, S, K, H)))
    vs = jnp.asarray(_kv_rows(rng, (L, 2, S, K, H)))
    jcache = jax.jit(jkv.write_prompts)(jcache, jnp.asarray([1, 2]), ks, vs, jnp.asarray([40, 30]))
    cache = cache_from_jax(jcache)
    got = decode.export_prefix(cache, 1, 32)
    want = jdecode.export_prefix(jcache, 1, 32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (L, K, 32, H)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    fcache = kvcache.KVCache.create(L, B, S, K, H, torch.float32, CPU)
    fcache.layers[0][0].normal_()
    np.testing.assert_array_equal(decode.export_prefix(fcache, 0, 16)[0][0].numpy(),
                                  fcache.layers[0][0][0, :, :16].numpy())


# --------------------------------------------------------------------- #
# The readers: K2's and K3's plain versions, the dense verify, the chain
# --------------------------------------------------------------------- #

K2_CASES = {
    "plain": dict(),
    "window": dict(window=13),
    "softcap": dict(softcap=20.0),
    "window_softcap": dict(window=40, softcap=30.0),
}


def _k2_inputs(rng, H, S=96, B=4, K=2, G=4):
    """An int8 panel quantized by the JAX package, lengths with an empty
    slot (``last = -1``) and one at the panel's end."""
    kq, ks = jkv.quantize_kv(jnp.asarray(_attn_rows(rng, (B, K, S, H))))
    vq, vs = jkv.quantize_kv(jnp.asarray(_attn_rows(rng, (B, K, S, H))))
    q = rng.standard_normal((B, K * G, H)).astype(np.float32)
    last = np.array([S // 2 + 3, -1, S - 1, 31], np.int32)[:B]
    return q, np.asarray(kq), np.asarray(vq), np.asarray(ks), np.asarray(vs), last


@pytest.mark.parametrize("H", [32, 64, 128])
@pytest.mark.parametrize("case", list(K2_CASES))
def test_plain_k2_int8_matches_jax_prefix_stats_dense(case, H):
    """K2's plain version on an int8 panel with its scales (the wrapper on
    CPU tensors) equals ``_prefix_stats_dense`` with ``kv_scales`` within
    1e-5 in fp32 (summation order): windows, soft-caps, an empty slot; the
    split algebra of the CUDA body gives the same."""
    kw = K2_CASES[case]
    rng = np.random.default_rng(H + len(case))
    q, kq, vq, ks, vs, last = _k2_inputs(rng, H)
    B, N, _ = q.shape
    K = kq.shape[1]
    qpos = np.maximum(last, 0) + 1
    scale = H ** -0.5
    window, softcap = kw.get("window", 0), kw.get("softcap", 0.0)
    want = jdecode._prefix_stats_dense(
        jnp.asarray(q).reshape(B, K, N // K, H), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(last), jnp.asarray(qpos), scale, softcap, window,
        kv_scales=(jnp.asarray(ks), jnp.asarray(vs)))
    args = (_t(q), _t(kq), _t(vq), _t(last), _t(qpos))
    got = k2.decode_attention(*args, scale=scale, softcap=softcap, window=window,
                              return_stats=True, k_scales=_t(ks), v_scales=_t(vs))
    acc_j, m_j, l_j = (np.asarray(a) for a in want)
    acc_t, m_t, l_t = (a.numpy() for a in got)
    np.testing.assert_allclose(acc_t, acc_j, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(m_t, m_j, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(l_t, l_j, atol=1e-5, rtol=1e-5)
    assert (m_t[1] == NEG_INF).all() and (l_t[1] == 0).all() and (acc_t[1] == 0).all()
    for n_split in (1, 3, 7):
        split = k2.decode_attention_split_plain(*args, scale=scale, softcap=softcap,
                                                window=window, n_split=n_split,
                                                k_scales=_t(ks), v_scales=_t(vs))
        for a, b in zip(split, got):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    assert k2.launches == 0


def test_plain_k2_int8_rounds_p_to_q_dtype():
    """With bf16 q the plain version rounds ``p · v_scale`` to bf16 before
    the PV product, as the JAX function casts it to q's dtype."""
    rng = np.random.default_rng(3)
    q, kq, vq, ks, vs, last = _k2_inputs(rng, 64)
    B, N, H = q.shape
    K = kq.shape[1]
    qb = jnp.asarray(q, jnp.bfloat16)
    qpos = np.maximum(last, 0) + 1
    want = jdecode._prefix_stats_dense(
        qb.reshape(B, K, N // K, H), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(last),
        jnp.asarray(qpos), H ** -0.5, 0.0, 0, kv_scales=(jnp.asarray(ks), jnp.asarray(vs)))
    got = k2.decode_attention(_t(np.asarray(qb.astype(jnp.float32))).to(torch.bfloat16),
                              _t(kq), _t(vq), _t(last), _t(qpos), scale=H ** -0.5,
                              return_stats=True, k_scales=_t(ks), v_scales=_t(vs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_k2_refuses_scales_without_an_int8_cache():
    q, kq, vq, ks, vs, last = _k2_inputs(np.random.default_rng(0), 32)
    with pytest.raises(ValueError, match="int8"):
        k2.decode_attention(_t(q), _t(kq), _t(vq), _t(last))
    with pytest.raises(ValueError, match="int8"):
        k2.decode_attention(_t(q), _t(kq).float(), _t(vq).float(), _t(last), k_scales=_t(ks),
                            v_scales=_t(vs))


@pytest.mark.parametrize("q_blocks", [1, 4])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (40, 30.0)])
def test_plain_k3_int8_matches_the_tpu_kernel(q_blocks, window, softcap):
    """K3's plain version on int8 pools with scale pools equals the Pallas
    kernel in interpret mode within 1e-5 (fp32), with q_blocks 1 and 4.
    Both dequantize first (q and p in fp32); the JAX engine's CPU path
    applies the scales after the dots instead, which differs from this
    only in rounding."""
    B, K, H, P, max_pages = 4, 2, 32, 16, 4
    lengths = (2 * P + 11, P, 0, 3 * P + 1)
    rng = np.random.default_rng(q_blocks * 10 + window)
    num_pages = B * max_pages + 1
    alloc = paged.PageAllocator(num_pages, P, B, max_pages)
    pools = _attn_rows(rng, (2, K, num_pages, P, H))
    for b, n in enumerate(lengths):
        if n:
            assert alloc.allocate(b, n)
    kq, ksc = jkv.quantize_kv(jnp.asarray(pools[0]))
    vq, vsc = jkv.quantize_kv(jnp.asarray(pools[1]))
    table = alloc.table.copy()
    last = np.asarray(lengths, np.int32) - 1
    qpos = np.asarray(lengths, np.int32)
    N = K * 2 * q_blocks
    q = rng.standard_normal((B, N, H)).astype(np.float32)
    want = jpaged_attention(
        jnp.asarray(q), kq, vq, jnp.asarray(table), jnp.asarray(last),
        q_positions=jnp.asarray(qpos), n_blocks=max_pages, scale=H ** -0.5, softcap=softcap,
        window=window, q_blocks=q_blocks, k_scales=ksc, v_scales=vsc, interpret=True)
    got = k3.paged_decode_attention(
        _t(q), _t(kq), _t(vq), _t(table), _t(last), q_positions=_t(qpos), n_blocks=max_pages,
        scale=H ** -0.5, softcap=softcap, window=window, q_blocks=q_blocks, k_scales=_t(ksc),
        v_scales=_t(vsc))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    assert k3.launches == 0


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 25.0)])
def test_dense_verify_prefix_over_an_int8_panel_matches_jax(window, softcap):
    """``_spec_block_attn`` on a bounded int8 panel with its scales (the
    dense verify block's prefix, plain products) equals the JAX function
    within 1e-5 in fp32."""
    B, K, G, D, H, Sb, R = 3, 2, 2, 4, 32, 40, 9
    rng = np.random.default_rng(window)
    qg = rng.standard_normal((B, K, G, D, H)).astype(np.float32)
    kq, ksc = jkv.quantize_kv(jnp.asarray(_attn_rows(rng, (B, K, Sb, H))))
    vq, vsc = jkv.quantize_kv(jnp.asarray(_attn_rows(rng, (B, K, Sb, H))))
    ring = [rng.standard_normal((B, K, R, H)).astype(np.float32) for _ in range(2)]
    blk = [rng.standard_normal((B, K, D, H)).astype(np.float32) for _ in range(2)]
    last = np.array([17, -1, 39], np.int32)
    start = last + 1
    offset = np.array([3, 0, 9], np.int32)
    qpos = (start + offset)[:, None] + np.arange(D)[None, :]
    want = jdecode._spec_block_attn(
        jnp.asarray(qg), kq, vq, *(jnp.asarray(a) for a in ring + blk), jnp.asarray(last),
        jnp.asarray(start), jnp.asarray(offset), jnp.asarray(qpos), H ** -0.5, softcap, window,
        kv_scales=(ksc, vsc))
    got = decode._spec_block_attn(
        _t(qg), _t(kq), _t(vq), *(_t(a) for a in ring + blk), _t(last), _t(start), _t(offset),
        _t(qpos), H ** -0.5, softcap, window, kv_scales=(_t(ksc), _t(vsc)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_pages_dequantize_as_jax_gathers_them(dtype):
    """A tail prefill reads an int8 chain dequantized to the compute dtype,
    the JAX engine's ``_bounded_panels`` + ``_dequant_pair``; the pools
    stay as they were."""
    jdt, tdt = DTYPES[dtype]
    K, num_pages, P, H = 2, 9, 4, 32
    rng = np.random.default_rng(2)
    jcache = jpaged.PagedKVCache.create(2, 2, num_pages, P, K, H, jdt, quantized=True)
    kq, ksc = jkv.quantize_kv(jnp.asarray(_attn_rows(rng, (K, num_pages, P, H))))
    vq, vsc = jkv.quantize_kv(jnp.asarray(_attn_rows(rng, (K, num_pages, P, H))))
    jcache = jcache._replace(layers=((kq, vq), (vq, kq)), scales=((ksc, vsc), (vsc, ksc)))
    cache = cache_from_jax(jcache)
    before = [t.clone() for pair in cache.layers + cache.scales for t in pair]
    chain = np.array([5, 2, 7], np.int32)
    layer = decode._chain_layer(cache, torch.from_numpy(chain).long(), tdt)
    for l in range(2):
        jk, jv, sc = jdecode._bounded_panels(
            jcache, l, lambda a: a[:, jnp.asarray(chain)].reshape((K, 3 * P) + a.shape[3:]))
        jk, jv = jdecode._dequant_pair(jk, jv, sc, jdt)
        pk, pv = layer(l)
        assert pk.dtype == tdt and pk.shape == (K, 3 * P, H)
        np.testing.assert_array_equal(_np(pk), _np(jk))
        np.testing.assert_array_equal(_np(pv), _np(jv))
    after = [t for pair in cache.layers + cache.scales for t in pair]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
