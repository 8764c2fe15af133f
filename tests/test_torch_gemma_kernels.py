"""Kernels K1, K2 and K3 of the port at head_dim 256 (the Gemma family)
against the JAX package's Pallas kernels in interpret mode.

The port's wrappers run their plain PyTorch versions for CPU tensors.
Inputs come from numpy with a seed, in fp32; query groups of 1, 2 and 8
heads a kv head, windows, soft-caps, rows and slots with no key, and for
K3 the fused ring, ``q_blocks`` and int8 pools. Tolerance: atol = rtol =
1e-5 on o, acc and lse (only the order of summation differs); rows with no
key are exact. The head_dim 256 CUDA bodies run on the card
(``chip_smoke.py`` phase 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.engine.decode import _prefix_stats_dense
from pilottai_tpu.ops.kvcache import quantize_kv
from pilottai_tpu.ops.pallas.decode_attention import decode_attention as jax_decode
from pilottai_tpu.ops.pallas.flash_attention import flash_attention_with_lse as jax_flash
from pilottai_tpu.ops.pallas.paged_attention import paged_decode_attention as jax_paged
from pilottai_tpu_torch.ops import paged
from pilottai_tpu_torch.ops.kernels import build
from pilottai_tpu_torch.ops.kernels import decode_attention as da
from pilottai_tpu_torch.ops.kernels import flash_attention as fa
from pilottai_tpu_torch.ops.kernels import paged_attention as pa

NEG_INF = -2.0**30
TOL = dict(atol=1e-5, rtol=1e-5)
H = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize(
    "B,T,N,K,valid,offset,window,softcap",
    [
        (2, 40, 4, 2, [40, 23], 0, 0, 0.0),          # G 2 (gemma2-2b), ragged
        (2, 37, 8, 1, [37, 0], 5, 8, 50.0),          # G 8 (gemma-2b), window, soft-cap, no key
        (1, 33, 2, 2, [33], 3, 12, 0.0),             # G 1, window
    ],
)
def test_flash_plain_h256_matches_jax_kernel(B, T, N, K, valid, offset, window, softcap):
    rng = np.random.default_rng(T)
    q = rng.standard_normal((B, T, N, H), np.float32)
    k = rng.standard_normal((B, T, K, H), np.float32)
    v = rng.standard_normal((B, T, K, H), np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32) + offset, (B, T)).copy()
    val = np.asarray(valid, np.int32)
    o_j, lse_j = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), jnp.asarray(pos),
        jnp.asarray(val), jnp.int32(window), scale=H**-0.5, softcap=softcap,
        block_q=16, block_k=16, interpret=True,
    )
    t = [torch.from_numpy(a) for a in (q, k, v, pos, pos, val)]
    o_t, lse_t = fa.flash_attention_with_lse(*t, window=window, scale=H**-0.5, softcap=softcap)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], **TOL)
    empty = val == 0
    assert (lse_t.numpy()[empty] == NEG_INF).all() and (o_t.numpy()[empty] == 0).all()
    assert fa.launches == 0


@pytest.mark.parametrize(
    "N,K,last,shift,window,softcap,int8",
    [
        (4, 2, [47, 20, -1, 0], 1, 0, 0.0, False),    # G 2, an empty slot, a one-key slot
        (8, 1, [47, 30, 5, -1], 3, 9, 50.0, False),   # G 8, window, soft-cap
        (2, 2, [40, 12, 33, 2], 1, 6, 0.0, False),    # G 1
        (8, 1, [47, 30, 5, -1], 2, 9, 50.0, True),    # the int8 cache
    ],
)
def test_decode_plain_h256_matches_jax_kernel_and_xla_prefix(N, K, last, shift, window, softcap,
                                                            int8):
    B, S = 4, 48
    rng = np.random.default_rng(N + K)
    q = rng.standard_normal((B, N, H), np.float32)
    kc = rng.standard_normal((B, K, S, H), np.float32)
    vc = rng.standard_normal((B, K, S, H), np.float32)
    lst = np.asarray(last, np.int32)
    qpos = np.maximum(lst, 0) + shift
    scale = H**-0.5
    t_kw, x_scales = {}, None
    if int8:
        kq, ks = quantize_kv(jnp.asarray(kc))
        vq, vs = quantize_kv(jnp.asarray(vc))
        kc, vc = np.array(kq), np.array(vq)
        x_scales = (ks, vs)
        t_kw = dict(k_scales=torch.from_numpy(np.array(ks)),
                    v_scales=torch.from_numpy(np.array(vs)))
    refs = [_prefix_stats_dense(
        jnp.asarray(q).reshape(B, K, N // K, H), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lst), jnp.asarray(qpos), scale, softcap, window, kv_scales=x_scales,
    )]
    if not int8:
        refs.append(jax_decode(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lst),
            q_positions=jnp.asarray(qpos), scale=scale, softcap=softcap, window=window,
            return_stats=True, interpret=True,
        ))
    acc_t, m_t, l_t = da.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lst), torch.from_numpy(qpos), scale=scale, softcap=softcap,
        window=window, return_stats=True, **t_kw,
    )
    for ref in refs:
        acc_r, m_r, l_r = (np.asarray(a).reshape(t.shape) for a, t in zip(ref, (acc_t, m_t, l_t)))
        np.testing.assert_allclose(acc_t.numpy(), acc_r, **TOL)
        np.testing.assert_allclose(m_t.numpy(), m_r, **TOL)
        np.testing.assert_allclose(l_t.numpy(), l_r, **TOL)
        masked = m_r <= NEG_INF / 2
        np.testing.assert_array_equal(m_t.numpy()[masked], m_r[masked])
        np.testing.assert_array_equal(l_t.numpy()[masked], l_r[masked])
    assert da.launches == 0


P, MAX_PAGES, B3 = 16, 4, 4
LENGTHS = (2 * P + P // 2 + 3, P, 0, 3 * P + 1)
K3_CASES = {
    "G2": dict(K=2, G=2),
    "G8 window softcap": dict(K=1, G=8, window=24, softcap=50.0),
    "G1 ring@5 window": dict(K=2, G=1, ring=8, step=5, window=30),
    "G2 q_blocks4 window": dict(K=2, G=2, q_blocks=4, window=24),
    "G8 int8 ring@3": dict(K=1, G=8, quantized=True, ring=8, step=3, softcap=50.0),
}


@pytest.mark.parametrize("case", list(K3_CASES))
def test_paged_plain_h256_matches_jax_kernel(case):
    kw = dict(K3_CASES[case])
    K, G = kw.pop("K"), kw.pop("G")
    q_blocks, ring, step = kw.pop("q_blocks", 1), kw.pop("ring", 0), kw.pop("step", 0)
    window, softcap = kw.pop("window", 0), kw.pop("softcap", 0.0)
    quantized = kw.pop("quantized", False)
    assert not kw
    rng = np.random.default_rng(len(case))
    num_pages = B3 * MAX_PAGES + 1
    alloc = paged.PageAllocator(num_pages, P, B3, MAX_PAGES)
    k_pool = np.zeros((K, num_pages, P, H), np.float32)
    v_pool = np.zeros((K, num_pages, P, H), np.float32)
    for b, n in enumerate(LENGTHS):
        if n:
            assert alloc.allocate(b, n)
            for j in range(alloc.pages_needed(n)):
                k_pool[:, alloc.table[b, j]] = rng.normal(size=(K, P, H))
                v_pool[:, alloc.table[b, j]] = rng.normal(size=(K, P, H))
    ks = vs = None
    if quantized:
        kq, ksj = quantize_kv(jnp.asarray(k_pool))
        vq, vsj = quantize_kv(jnp.asarray(v_pool))
        k_pool, v_pool, ks, vs = (np.array(a) for a in (kq, vq, ksj, vsj))
    table = alloc.table.copy()
    last = np.asarray(LENGTHS, np.int32) - 1
    qpos = np.asarray(LENGTHS, np.int32)
    N = K * G * q_blocks
    q = rng.normal(size=(B3, N, H)).astype(np.float32)
    rk = rng.normal(size=(B3, K, ring, H)).astype(np.float32) if ring else None
    rv = rng.normal(size=(B3, K, ring, H)).astype(np.float32) if ring else None

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))

    want = jax_paged(
        j(q), j(k_pool), j(v_pool), j(table), j(last), q_positions=j(qpos), n_blocks=MAX_PAGES,
        scale=H**-0.5, softcap=softcap, window=window, q_blocks=q_blocks, k_scales=j(ks),
        v_scales=j(vs), ring_k=j(rk), ring_v=j(rv),
        ring_step=jnp.int32(step) if ring else None, interpret=True,
    )
    got = pa.paged_decode_attention(
        t(q), t(k_pool), t(v_pool), t(table), t(last), q_positions=t(qpos), n_blocks=MAX_PAGES,
        scale=H**-0.5, softcap=softcap, window=window, q_blocks=q_blocks, k_scales=t(ks),
        v_scales=t(vs), ring_k=t(rk), ring_v=t(rv), ring_step=step if ring else None,
    )
    acc_j, m_j, l_j = (np.asarray(a) for a in want)
    acc_t, m_t, l_t = (a.numpy() for a in got)
    np.testing.assert_allclose(acc_t, acc_j, **TOL)
    empty = m_j <= NEG_INF / 2
    np.testing.assert_array_equal(m_t[empty], m_j[empty])
    np.testing.assert_array_equal(l_t[empty], 0.0)
    np.testing.assert_allclose(m_t[~empty], m_j[~empty], **TOL)
    np.testing.assert_allclose(l_t[~empty], l_j[~empty], **TOL)
    assert pa.launches == 0


def test_kernel_shape_checks_take_head_dim_256_and_refuse_the_rest():
    """K1, K2 and K3 take head_dim 256 (gemma-2b's one kv head and
    gemma2-2b's four), and so do K4 and K5 (training, slice P9c); every
    other head dim outside 32, 64, 128 is still refused."""
    for n_heads, n_kv in ((8, 1), (8, 4)):
        fa.check_kernel_shapes(n_heads, n_kv, 256)
        da.check_kernel_shapes(n_heads, n_kv, 256)
        pa.check_kernel_shapes(n_heads, n_kv, 256, 128)
        pa.check_kernel_shapes(n_heads * 4, n_kv, 256, 16, q_blocks=4)   # the verify block
    for head_dim in (96, 192, 512):
        with pytest.raises(ValueError, match="head_dim"):
            fa.check_kernel_shapes(8, 4, head_dim)
        with pytest.raises(ValueError, match="head_dim"):
            da.check_kernel_shapes(8, 4, head_dim)
        with pytest.raises(ValueError, match="head_dim"):
            pa.check_kernel_shapes(8, 4, head_dim, 128)
    fa.check_kernel_shapes(8, 4, 256, backward=True)
    fa.check_kernel_shapes(32, 8, 128, backward=True)
    with pytest.raises(ValueError, match="K4 and K5"):
        fa.check_kernel_shapes(8, 4, 192, backward=True)
    with pytest.raises(ValueError, match="query heads"):
        da.check_kernel_shapes(16, 1, 256)


def test_k3_head_dim_256_library_is_built_from_the_k3_source(tmp_path):
    """K3's head_dim 256 instantiations build from ``paged_attention.cu``
    through ``paged_attention_h256.cu``: an edit of the K3 source renames
    (so rebuilds) both libraries."""
    for name in ("paged_attention.cu", "paged_attention_h256.cu"):
        (tmp_path / name).write_bytes((build.CSRC / name).read_bytes())
    names = ("paged_attention", "paged_attention_h256")
    before = {n: build.library_path(n, tmp_path / f"{n}.cu") for n in names}
    src = tmp_path / "paged_attention.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: build.library_path(n, tmp_path / f"{n}.cu") for n in names}
    assert all(after[n] != before[n] for n in names)
    assert b"PT_PAGED_HEAD_DIM_256" in (build.CSRC / "paged_attention_h256.cu").read_bytes()


@pytest.mark.parametrize("n_split,keys_per_split", [(3, 16), (7, 32)])
def test_split_walks_at_head_dim_256_equal_the_unsplit_plain_versions(n_split, keys_per_split):
    """The kernels' split-and-merge algebra at head_dim 256: K2's split walk
    (``decode_attention_split_plain``, G 8, a window and a soft-cap) and
    K3's (``paged_decode_attention_split_plain``, splits of one and two
    16-key pages, G 2, the ring) against their unsplit plain versions."""
    rng = np.random.default_rng(n_split)
    B, N, K, S = 4, 8, 1, 96
    q = torch.from_numpy(rng.standard_normal((B, N, H), np.float32))
    kc = torch.from_numpy(rng.standard_normal((B, K, S, H), np.float32))
    vc = torch.from_numpy(rng.standard_normal((B, K, S, H), np.float32))
    last = torch.tensor([95, 40, -1, 0], dtype=torch.int32)
    qpos = last.clamp(min=0) + 2
    kw = dict(scale=H**-0.5, softcap=50.0, window=30)
    want = da.decode_attention_plain(q, kc, vc, last, qpos, **kw)
    got = da.decode_attention_split_plain(q, kc, vc, last, qpos, n_split=n_split, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)

    num_pages = B3 * MAX_PAGES + 1
    alloc = paged.PageAllocator(num_pages, P, B3, MAX_PAGES)
    for b, n in enumerate(LENGTHS):
        if n:
            assert alloc.allocate(b, n)
    pools = [torch.from_numpy(rng.standard_normal((2, num_pages, P, H), np.float32))
             for _ in range(2)]
    rings = [torch.from_numpy(rng.standard_normal((B3, 2, 8, H), np.float32)) for _ in range(2)]
    qp = torch.from_numpy(rng.standard_normal((B3, 4, H), np.float32))
    args = (qp, *pools, torch.from_numpy(alloc.table.copy()),
            torch.tensor(LENGTHS, dtype=torch.int32) - 1)
    pkw = dict(q_positions=torch.tensor(LENGTHS, dtype=torch.int32), n_blocks=MAX_PAGES,
               scale=H**-0.5, softcap=50.0, window=24, ring_k=rings[0], ring_v=rings[1],
               ring_step=5)
    want = pa.paged_decode_attention_plain(*args, **pkw)
    got = pa.paged_decode_attention_split_plain(*args, **pkw, keys_per_split=keys_per_split)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
