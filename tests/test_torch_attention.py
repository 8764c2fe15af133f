"""Kernels K1 and K2 of the port against the JAX package.

The port's wrappers run their plain PyTorch versions for CPU tensors; the
JAX side runs its Pallas kernels in interpret mode (and, for K2, also the
XLA function the JAX engine's dense default uses). Inputs come from numpy
with a seed, in fp32. Tolerance: atol = rtol = 1e-5 on o, acc and lse —
only the order of summation differs; m and l must be exact on rows that
see no key.

The CUDA kernels themselves need the card: ``test_cuda_kernels_match_plain``
is marked ``cuda`` and skips here (``python3 chip_smoke.py`` runs the full
comparison on the GPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.engine.decode import _prefix_stats_dense
from pilottai_tpu.ops.pallas.decode_attention import decode_attention as jax_decode
from pilottai_tpu.ops.pallas.flash_attention import flash_attention_with_lse as jax_flash
from pilottai_tpu_torch.ops.kernels import decode_attention as da
from pilottai_tpu_torch.ops.kernels import flash_attention as fa

NEG_INF = -2.0**30
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast and does not
    oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flash_inputs(seed, B, T, N, K, H, valid, offset):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, N, H), np.float32)
    k = rng.standard_normal((B, T, K, H), np.float32)
    v = rng.standard_normal((B, T, K, H), np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32) + offset, (B, T)).copy()
    return q, k, v, pos, np.asarray(valid, np.int32)


@pytest.mark.parametrize(
    "B,T,N,K,H,valid,offset,window,softcap",
    [
        # GQA, ragged valid lengths, a batch row with no keys, T not a
        # multiple of the block.
        (3, 40, 8, 2, 16, [40, 23, 0], 0, 0, 0.0),
        # Sliding window, soft-cap and a nonzero position offset.
        (2, 37, 4, 2, 32, [37, 34], 5, 8, 20.0),
    ],
)
def test_flash_plain_matches_jax_kernel(B, T, N, K, H, valid, offset, window, softcap):
    q, k, v, pos, val = _flash_inputs(0, B, T, N, K, H, valid, offset)
    o_j, lse_j = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), jnp.asarray(pos),
        jnp.asarray(val), jnp.int32(window), softcap=softcap,
        block_q=16, block_k=16, interpret=True,
    )
    t = [torch.from_numpy(a) for a in (q, k, v, pos, pos, val)]
    o_t, lse_t = fa.flash_attention_with_lse(*t, window=window, softcap=softcap)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], **TOL)
    empty = np.asarray(val) == 0
    assert (lse_t.numpy()[empty] == NEG_INF).all() and (o_t.numpy()[empty] == 0).all()
    # The wrapper without lse returns the same output.
    np.testing.assert_array_equal(
        fa.flash_attention(*t, window=window, softcap=softcap).numpy(), o_t.numpy()
    )


@pytest.mark.parametrize(
    "last,qpos_shift,window,softcap",
    [
        ([47, 20, -1, 0], 1, 0, 0.0),     # ragged, an empty row, a one-key row
        ([47, 30, 5, -1], 1, 9, 25.0),    # sliding window + soft-cap
        ([40, 12, 33, 2], 3, 6, 0.0),     # query positions past last
    ],
)
def test_decode_plain_matches_jax_kernel_and_xla_prefix(last, qpos_shift, window, softcap):
    B, N, K, S, H = 4, 8, 2, 48, 16
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, N, H), np.float32)
    kc = rng.standard_normal((B, K, S, H), np.float32)
    vc = rng.standard_normal((B, K, S, H), np.float32)
    lst = np.asarray(last, np.int32)
    qpos = np.maximum(lst, 0) + qpos_shift
    scale = H**-0.5
    acc_j, m_j, l_j = jax_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lst),
        q_positions=jnp.asarray(qpos), scale=scale, softcap=softcap, window=window,
        return_stats=True, interpret=True,
    )
    acc_x, m_x, l_x = _prefix_stats_dense(
        jnp.asarray(q).reshape(B, K, N // K, H), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lst), jnp.asarray(qpos), scale, softcap, window,
    )
    acc_t, m_t, l_t = da.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lst), torch.from_numpy(qpos), scale=scale, softcap=softcap,
        window=window, return_stats=True,
    )
    for ref in ((acc_j, m_j, l_j), (acc_x, m_x, l_x)):
        np.testing.assert_allclose(acc_t.numpy(), np.asarray(ref[0]), **TOL)
        np.testing.assert_allclose(m_t.numpy(), np.asarray(ref[1]), **TOL)
        np.testing.assert_allclose(l_t.numpy(), np.asarray(ref[2]), **TOL)
        masked = np.asarray(ref[1]) <= NEG_INF / 2
        np.testing.assert_array_equal(m_t.numpy()[masked], np.asarray(ref[1])[masked])
        np.testing.assert_array_equal(l_t.numpy()[masked], np.asarray(ref[2])[masked])
    # Normalized form against the JAX kernel's normalized mode.
    o_j = jax_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lst),
        q_positions=jnp.asarray(qpos), scale=scale, softcap=softcap, window=window,
        interpret=True,
    )
    o_t = da.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lst), torch.from_numpy(qpos), scale=scale, softcap=softcap,
        window=window,
    )
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)


def test_cpu_wrappers_do_not_count_launches():
    """The launch counters count kernel launches only; the CPU path runs
    the plain versions."""
    before = (fa.launches, da.launches)
    q, k, v, pos, val = _flash_inputs(2, 1, 8, 2, 1, 32, [8], 0)
    fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v, pos, pos, val)))
    da.decode_attention(torch.zeros(1, 2, 32), torch.zeros(1, 1, 4, 32),
                        torch.zeros(1, 1, 4, 32), torch.tensor([3]), return_stats=True)
    assert (fa.launches, da.launches) == before


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    q, k, v, pos, val = _flash_inputs(3, 2, 70, 8, 2, 64, [70, 41], 2)
    t = [torch.from_numpy(a).to(dev) for a in (q, k, v, pos, pos, val)]
    o_k, lse_k = fa.flash_attention_with_lse(*t, window=16, softcap=30.0)
    o_p, lse_p = fa.flash_attention_plain(*t, window=16, softcap=30.0)
    torch.testing.assert_close(o_k, o_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse_k, lse_p, atol=1e-4, rtol=0)
    rng = np.random.default_rng(4)
    qd = torch.from_numpy(rng.standard_normal((3, 8, 64), np.float32)).to(dev)
    kc = torch.from_numpy(rng.standard_normal((3, 2, 90, 64), np.float32)).to(dev)
    vc = torch.from_numpy(rng.standard_normal((3, 2, 90, 64), np.float32)).to(dev)
    lst = torch.tensor([89, 10, -1], device=dev)
    got = da.decode_attention(qd, kc, vc, lst, lst + 1, return_stats=True)
    want = da.decode_attention_plain(qd, kc, vc, lst, lst + 1, 64**-0.5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def test_dense_reference_attention_and_masks_match_jax():
    """``ops/attention.py``: the plain GQA attention and its position,
    valid-length and window masks, against the JAX functions."""
    from pilottai_tpu.ops import attention as jatt
    from pilottai_tpu_torch.ops import attention as tatt

    rng = np.random.default_rng(5)
    B, T, S, N, K, H = 2, 6, 12, 4, 2, 16
    q = rng.standard_normal((B, T, N, H), np.float32)
    k = rng.standard_normal((B, S, K, H), np.float32)
    v = rng.standard_normal((B, S, K, H), np.float32)
    qpos = np.array([[3, 4, 5, 6, 7, 8], [6, 7, 8, 9, 10, 11]], np.int32)
    kv_valid = np.array([9, 12], np.int32)
    for window in (0, 4):
        mj = jatt.make_attention_mask(jnp.asarray(qpos), S, jnp.asarray(kv_valid), window)
        mt = tatt.make_attention_mask(torch.from_numpy(qpos), S, torch.from_numpy(kv_valid),
                                      window)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        oj = jatt.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        mask=mj, logit_softcap=10.0)
        ot = tatt.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), mask=mt, logit_softcap=10.0)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
