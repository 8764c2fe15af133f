"""The split walk of the port's dense decode kernel K2, on the CPU.

K2 cuts each (kv head, slot)'s live keys into ``split_count`` runs of whole
32-key tiles (``split_bounds``, the rule the kernel's ``split_range``
computes on the device) and merges the splits' online-softmax statistics in
split order. ``decode_attention_split_plain`` is that algebra in plain
torch; it is held against the unsplit plain version, the JAX package's
Pallas ``decode_attention(..., return_stats=True)`` in interpret mode and
the XLA function ``engine/decode.py:_prefix_stats_dense``, in fp32 within
atol = rtol = 1e-5 (only the order of summation differs), with rows that
see no key exact. The range rule itself is held to cover every live key
exactly once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pilottai_tpu.engine.decode import _prefix_stats_dense
from pilottai_tpu.ops.pallas.decode_attention import decode_attention as jax_decode
from pilottai_tpu_torch.ops.kernels import decode_attention as da

NEG_INF = -2.0**30
TOL = dict(atol=1e-5, rtol=1e-5)
K, S, H = 2, 160, 32  # five 32-key tiles a panel
# Slot by slot: no key, one key, a split's last key (two tiles, a tile a
# split), the first key of split 1 (three tiles, two a split), the whole
# panel.
LAST = [-1, 0, 63, 64, S - 1]

# (n_split, window, softcap, G): one split and many (a split a tile, more
# splits than tiles), a window that starts inside a split, a soft-cap, and
# 1, 2, 4 and 8 query heads per kv head.
CASES = {
    "one_split": (1, 0, 0.0, 2),
    "two_splits": (2, 0, 0.0, 2),
    "three_splits_g4": (3, 0, 0.0, 4),
    "split_a_tile_g1": (5, 0, 0.0, 1),
    "more_splits_than_tiles_g8": (8, 0, 0.0, 8),
    "window_inside_a_split": (3, 50, 0.0, 2),
    "window_softcap_g4": (2, 50, 25.0, 4),
    "softcap_g8": (4, 0, 30.0, 8),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast and does not
    oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", list(CASES))
def test_split_merge_matches_unsplit_the_tpu_kernel_and_xla(case):
    n_split, window, softcap, G = CASES[case]
    B, N = len(LAST), G * K
    rng = np.random.default_rng(11 + n_split + G)
    q = rng.standard_normal((B, N, H), np.float32)
    kc = rng.standard_normal((B, K, S, H), np.float32)
    vc = rng.standard_normal((B, K, S, H), np.float32)
    last = np.asarray(LAST, np.int32)
    # Query positions a few steps into a decode chunk (past last + 1), so a
    # window's start falls between the split boundaries.
    qpos = np.maximum(last, 0) + np.asarray([1, 1, 3, 9, 5], np.int32)
    scale = H**-0.5
    t = [torch.from_numpy(a) for a in (q, kc, vc, last, qpos)]
    split = da.decode_attention_split_plain(*t, scale, softcap, window, n_split)
    whole = da.decode_attention_plain(*t, scale, softcap, window)
    pallas = jax_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(last),
                        q_positions=jnp.asarray(qpos), scale=scale, softcap=softcap,
                        window=window, return_stats=True, interpret=True)
    xla = _prefix_stats_dense(jnp.asarray(q).reshape(B, K, G, H), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.asarray(last), jnp.asarray(qpos), scale,
                              softcap, window)
    acc_s, m_s, l_s = (a.numpy() for a in split)
    for ref in (whole, pallas, xla):
        acc_r = np.asarray(ref[0]).reshape(B, N, H)
        m_r, l_r = (np.asarray(a).reshape(B, N) for a in ref[1:])
        np.testing.assert_allclose(acc_s, acc_r, **TOL)
        np.testing.assert_allclose(m_s, m_r, **TOL)
        np.testing.assert_allclose(l_s, l_r, **TOL)
    # The slot with no key is exact: m = NEG_INF, l = 0, acc = 0.
    empty = m_s <= NEG_INF / 2
    assert empty[0].all() and not empty[1:].any()
    np.testing.assert_array_equal(m_s[empty], NEG_INF)
    np.testing.assert_array_equal(l_s[empty], 0.0)
    np.testing.assert_array_equal(acc_s[empty], 0.0)


def test_split_bounds_at_the_split_edges():
    """Two splits: slot 2 (two tiles) ends on split 1's last key, slot 3
    (three tiles, two a split) on split 1's first; slot 1's one key leaves
    split 1 empty; a window moves split 0's start to where it begins."""
    last = torch.tensor(LAST)
    lo0, hi0 = da.split_bounds(last, last + 1, 0, S, 2, 0)
    lo1, hi1 = da.split_bounds(last, last + 1, 0, S, 2, 1)
    assert lo0.tolist() == [0, 0, 0, 0, 0] and hi0.tolist() == [-1, 0, 31, 63, 95]
    assert lo1.tolist() == [0, 0, 32, 64, 96] and hi1.tolist() == [-1, -1, 63, 64, S - 1]
    lo, hi = da.split_bounds(torch.tensor([S - 1]), torch.tensor([S + 3]), 50, S, 2, 0)
    assert (lo.item(), hi.item()) == (S + 3 - 49, S + 3 - 49 + 31)


def test_split_count_from_the_shapes_alone():
    """Enough blocks to cover the SMs about four times, at most a split a
    tile: the llama3-8b dense wave (8 slots x 8 kv heads, S 2048), the
    golden protocol-s step (4 x 4, S 512, capped by its 16 tiles), a batch
    so wide that one split a (kv head, slot) already fills the card, and a
    panel shorter than its split count."""
    assert da.split_count(8, 8, 2048, 132) == 9
    assert da.split_count(4, 4, 512, 132) == 16
    assert da.split_count(66, 8, 2048, 132) == 1
    assert da.split_count(34, 8, 2048, 132) == 2
    assert da.split_count(1, 1, 40, 132) == 2


@settings(max_examples=400, deadline=None)
@given(last=st.integers(-3, 300), shift=st.integers(0, 40), window=st.integers(0, 120),
       S_=st.integers(1, 300), n_split=st.integers(1, 12))
def test_split_ranges_cover_every_live_key_exactly_once(last, shift, window, S_, n_split):
    qpos = max(last, 0) + shift
    live = [s for s in range(S_) if s <= last and (window <= 0 or qpos - s < window)]
    seen = []
    for z in range(n_split):
        lo, hi = da.split_bounds(torch.tensor([last]), torch.tensor([qpos]), window, S_,
                                 n_split, z)
        lo, hi = int(lo), int(hi)
        if lo <= hi:
            # A run of whole tiles from the first live key (the last one cut).
            assert (lo - live[0]) % da.TILE == 0
            seen += range(lo, hi + 1)
    assert seen == live
