"""The algebra of the port's redesigned kernels, on the CPU.

K3 (paged decode) cuts each slot's page walk into splits and merges the
splits' online-softmax statistics in split order; its plain split-and-merge
version is held against the unsplit plain version and against the JAX
package's ``paged_decode_attention`` in interpret mode, in fp32. K1 (flash
prefill, bf16) decides from the bounds of a tile's positions whether a
(q tile, kv tile) can hold a live pair and whether every pair is live; that
test is held against the pair scan on random positions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pilottai_tpu.ops.kvcache import quantize_kv
from pilottai_tpu.ops.pallas.paged_attention import paged_decode_attention as jpaged_attention
from pilottai_tpu_torch.ops.kernels import flash_attention as k1
from pilottai_tpu_torch.ops.kernels import paged_attention as k3

NEG_INF = -2.0**30

# --------------------------------------------------------------------- #
# K3: splits of the page walk, merged in split order
# --------------------------------------------------------------------- #

B, K, H, P, MAX_PAGES = 4, 2, 32, 16, 6
KEYS_PER_SPLIT = 2 * P  # three splits of two pages over the table's six
# Slot 0 ends mid-page inside its last split (last = 69); slot 1 ends
# exactly where split 0 ends (last = 31); slot 2 has no live page; slot 3
# fills the table.
LENGTHS = (70, 32, 0, 96)

CASES = {
    "plain": dict(),
    # qpos = 96 on slot 3: keys below 72 are out of reach, so its splits 0
    # and 1 attend nothing.
    "window_kills_splits": dict(window=24),
    "window_softcap_hole": dict(window=40, softcap=30.0, hole=(3, 2)),
    "ring_step0": dict(ring=8, step=0),
    "ring_window_step7": dict(ring=8, step=7, window=24),
    "q_blocks2_window": dict(q_blocks=2, window=30),
    "int8": dict(quantized=True, softcap=30.0),
    "int8_ring_window": dict(quantized=True, ring=8, step=5, window=40),
}


def _inputs(rng, quantized, hole):
    num_pages = sum(-(-n // P) for n in LENGTHS) + 3
    sentinel = num_pages - 1
    order = rng.permutation(num_pages - 1)
    table = np.full((B, MAX_PAGES), sentinel, np.int32)
    it = iter(order)
    for b, n in enumerate(LENGTHS):
        for j in range(-(-n // P)):
            table[b, j] = next(it)
    if hole is not None:
        table[hole] = sentinel
    k_pool = rng.normal(size=(K, num_pages, P, H)).astype(np.float32)
    v_pool = rng.normal(size=(K, num_pages, P, H)).astype(np.float32)
    x = dict(k=k_pool, v=v_pool, ks=None, vs=None, table=table,
             last=np.asarray(LENGTHS, np.int32) - 1, qpos=np.asarray(LENGTHS, np.int32))
    if quantized:
        kq, ks = quantize_kv(jnp.asarray(k_pool))
        vq, vs = quantize_kv(jnp.asarray(v_pool))
        x.update(k=np.asarray(kq), v=np.asarray(vq), ks=np.asarray(ks), vs=np.asarray(vs))
    return x


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_split_plan_cuts_the_walk_by_keys():
    assert k3.split_plan(48, 128) == (2, 24)
    assert k3.split_plan(49, 128) == (2, 25)
    assert k3.split_plan(29, 16) == (16, 2)
    assert k3.split_plan(3, 256) == (1, 3)
    assert k3.split_plan(MAX_PAGES, P, KEYS_PER_SPLIT) == (2, 3)


@pytest.mark.parametrize("case", list(CASES))
def test_split_merge_matches_unsplit_and_the_tpu_kernel(case):
    kw = dict(CASES[case])
    rng = np.random.default_rng(7 + len(case))
    x = _inputs(rng, kw.pop("quantized", False), kw.pop("hole", None))
    q_blocks = kw.pop("q_blocks", 1)
    ring, step = kw.pop("ring", 0), kw.pop("step", 0)
    window, softcap = kw.pop("window", 0), kw.pop("softcap", 0.0)
    assert not kw
    N = K * 2 * q_blocks
    q = rng.normal(size=(B, N, H)).astype(np.float32)
    rk = rng.normal(size=(B, K, ring, H)).astype(np.float32) if ring else None
    rv = rng.normal(size=(B, K, ring, H)).astype(np.float32) if ring else None
    common = dict(n_blocks=MAX_PAGES, scale=H**-0.5, softcap=softcap, window=window,
                  q_blocks=q_blocks)

    args = (_t(q), _t(x["k"]), _t(x["v"]), _t(x["table"]), _t(x["last"]), _t(x["qpos"]))
    tkw = dict(common, k_scales=_t(x["ks"]), v_scales=_t(x["vs"]), ring_k=_t(rk),
               ring_v=_t(rv), ring_step=step)
    split = k3.paged_decode_attention_split_plain(*args, **tkw, keys_per_split=KEYS_PER_SPLIT)
    whole = k3.paged_decode_attention_plain(*args, **tkw)
    want = jpaged_attention(
        jnp.asarray(q), _j(x["k"]), _j(x["v"]), _j(x["table"]), _j(x["last"]),
        q_positions=_j(x["qpos"]), k_scales=_j(x["ks"]), v_scales=_j(x["vs"]), ring_k=_j(rk),
        ring_v=_j(rv), ring_step=jnp.int32(step) if ring else None, interpret=True, **common,
    )
    acc_s, m_s, l_s = (a.numpy() for a in split)
    m_j = np.asarray(want[1])
    empty = m_j <= NEG_INF / 2
    for ref in ((a.numpy() for a in whole), (np.asarray(a) for a in want)):
        acc_r, m_r, l_r = ref
        np.testing.assert_allclose(acc_s, acc_r, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(m_s[~empty], m_r[~empty], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(l_s[~empty], l_r[~empty], atol=1e-5, rtol=1e-5)
    # Rows with no key are exact: m stays NEG_INF, l and acc stay 0.
    np.testing.assert_array_equal(m_s[empty], m_j[empty])
    np.testing.assert_array_equal(l_s[empty], 0.0)
    np.testing.assert_array_equal(acc_s[empty], 0.0)
    if not ring:
        assert empty[2].all()           # the slot with no live page


def test_split_merge_at_the_kernels_split_size():
    """The kernel's own plan (256 keys a split) over a longer table, with one
    slot ending mid-split, one at a split's end and one empty."""
    rng = np.random.default_rng(3)
    Pl, pages = 16, 40
    lengths = (600, 256, 0, 37)
    num_pages = sum(-(-n // Pl) for n in lengths) + 2
    table = np.full((4, pages), num_pages - 1, np.int32)
    it = iter(rng.permutation(num_pages - 1))
    for b, n in enumerate(lengths):
        for j in range(-(-n // Pl)):
            table[b, j] = next(it)
    kp = torch.from_numpy(rng.normal(size=(2, num_pages, Pl, 64)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(2, num_pages, Pl, 64)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(4, 8, 64)).astype(np.float32))
    last = torch.tensor(lengths) - 1
    args = (q, kp, vp, torch.from_numpy(table), last, last + 4, pages, 64**-0.5)
    rk = torch.from_numpy(rng.normal(size=(4, 2, 16, 64)).astype(np.float32))
    rv = torch.from_numpy(rng.normal(size=(4, 2, 16, 64)).astype(np.float32))
    assert k3.split_plan(pages, Pl) == (16, 3)
    for kw in (dict(), dict(window=300, ring_k=rk, ring_v=rv, ring_step=3)):
        got = k3.paged_decode_attention_split_plain(*args, **kw)
        want = k3.paged_decode_attention_plain(*args, **kw)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("page", [8, 24, 100, 512])
def test_split_merge_at_every_page_size_the_engine_serves(page, quantized):
    """Page sizes off the multiples of 16 and past one split (the JAX
    engine takes any page from 8 on), at the kernel's own split plan: the
    split-and-merge plain K3 against the TPU kernel in interpret mode, slots
    ending mid-page, one slot empty, in fp32 and on int8 pools with scales;
    with a ring and a window on fp32 pools."""
    rng = np.random.default_rng(page + quantized)
    lengths = (600, 37, 0, 257)
    pages = -(-max(lengths) // page)
    num_pages = sum(-(-n // page) for n in lengths) + 2
    table = np.full((4, pages), num_pages - 1, np.int32)
    it = iter(rng.permutation(num_pages - 1))
    for b, n in enumerate(lengths):
        for j in range(-(-n // page)):
            table[b, j] = next(it)
    k_pool = rng.normal(size=(K, num_pages, page, H)).astype(np.float32)
    v_pool = rng.normal(size=(K, num_pages, page, H)).astype(np.float32)
    ks = vs = None
    if quantized:
        kq, ks = quantize_kv(jnp.asarray(k_pool))
        vq, vs = quantize_kv(jnp.asarray(v_pool))
        k_pool, v_pool, ks, vs = (np.asarray(a) for a in (kq, vq, ks, vs))
    last = np.asarray(lengths, np.int32) - 1
    qpos = last + 4
    q = rng.normal(size=(4, 2 * K, H)).astype(np.float32)
    ring = {} if quantized else dict(ring_k=rng.normal(size=(4, K, 8, H)).astype(np.float32),
                                     ring_v=rng.normal(size=(4, K, 8, H)).astype(np.float32))
    common = dict(n_blocks=pages, scale=H**-0.5, window=0 if quantized else 300,
                  softcap=30.0 if quantized else 0.0)
    got = k3.paged_decode_attention_split_plain(
        _t(q), _t(k_pool), _t(v_pool), _t(table), _t(last), _t(qpos), **common,
        k_scales=_t(ks), v_scales=_t(vs), ring_step=3, **{n: _t(a) for n, a in ring.items()})
    want = jpaged_attention(
        jnp.asarray(q), _j(k_pool), _j(v_pool), _j(table), _j(last), q_positions=_j(qpos),
        k_scales=_j(ks), v_scales=_j(vs), ring_step=jnp.int32(3) if ring else None,
        interpret=True, **common, **{n: _j(a) for n, a in ring.items()})
    assert k3.split_plan(pages, page)[1] >= 2 or page == 512
    acc_s, m_s, l_s = (a.numpy() for a in got)
    acc_j, m_j, l_j = (np.asarray(a) for a in want)
    empty = m_j <= NEG_INF / 2
    np.testing.assert_allclose(acc_s, acc_j, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(m_s[~empty], m_j[~empty], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(l_s[~empty], l_j[~empty], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(m_s[empty], m_j[empty])
    np.testing.assert_array_equal(l_s[empty], 0.0)
    assert empty[2].all() != bool(ring)     # the empty slot sees only its ring


# --------------------------------------------------------------------- #
# K1: tile liveness from the bounds of the positions
# --------------------------------------------------------------------- #

def _pair_scan(q_pos, kv_pos, window):
    pairs = [kp <= qp and (window <= 0 or qp - kp < window) for qp in q_pos for kp in kv_pos]
    return any(pairs), all(pairs)


positions = st.lists(st.integers(min_value=-40, max_value=200), min_size=1, max_size=12)


@settings(max_examples=300, deadline=None)
@given(q_pos=positions, kv_pos=positions, window=st.integers(min_value=0, max_value=60))
def test_tile_bounds_never_skip_a_live_pair(q_pos, kv_pos, window):
    """Any positions: a tile with a live pair is never called dead, and a
    tile called full has every pair live."""
    live, full = k1.tile_bounds_test(q_pos, kv_pos, window)
    any_live, all_live = _pair_scan(q_pos, kv_pos, window)
    assert live or not any_live
    assert all_live or not full


@settings(max_examples=300, deadline=None)
@given(q0=st.integers(-20, 200), n_q=st.integers(1, 16), k0=st.integers(-20, 200),
       n_k=st.integers(1, 16), window=st.integers(0, 60))
def test_tile_bounds_are_exact_on_consecutive_positions(q0, n_q, k0, n_k, window):
    """Runs of consecutive positions (causal prefill, a paged segment's
    offset rows): the bounds decide exactly what the pair scan decides."""
    q_pos, kv_pos = list(range(q0, q0 + n_q)), list(range(k0, k0 + n_k))
    assert k1.tile_bounds_test(q_pos, kv_pos, window) == _pair_scan(q_pos, kv_pos, window)
