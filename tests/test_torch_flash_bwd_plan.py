"""The tile plan of the bf16 K4 and K5 (the flash attention backward), on
the CPU.

``flash_attention_bwd_tiled_plain`` walks (q tile, kv tile) pairs as the
kernels do, skipping, masking or taking each tile whole from its position
bounds (``tile_bounds``, the plain ``tile_bounds_kernel``, and
``tile_rule``). It is held against ``flash_attention_bwd_plain`` and the
JAX package's ``flash_attention_with_lse`` VJP (its Pallas kernels in
interpret mode, ``block_q = block_k = 16``), in fp32, with atol = rtol =
1e-5: only the order of summation differs. Inputs come from numpy with a
seed. Hypothesis tests show that the bounds never skip a live pair and
never take a tile whole that holds a dead one, for any positions, ragged
tiles and valid lengths. The build's hash is checked to cover the
headers a kernel source includes.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pilottai_tpu.ops.pallas.flash_attention import flash_attention_with_lse as jax_flash
from pilottai_tpu_torch.ops.kernels import build
from pilottai_tpu_torch.ops.kernels import flash_attention as fa

TOL = dict(atol=1e-5, rtol=1e-5)

CASES = {
    # Query rows offset into the keys (a segment after a prefix), T != S,
    # both off the tiles, and an lse cotangent.
    "offset-dlse": dict(B=2, T=37, S=45, N=4, K=2, H=16, valid=[45, 30], offset=8),
    # Keys out of order: every tile's bounds span most positions, so most
    # tiles are masked pair by pair.
    "shuffled-keys": dict(B=2, T=40, S=40, N=8, K=2, H=16, valid=[40, 23], shuffle=True),
    # GQA with a batch row of valid 0: exact zeros for it.
    "valid-zero": dict(B=3, T=40, S=40, N=8, K=2, H=16, valid=[40, 23, 0]),
    # A window shorter than a tile and a soft-cap: dead tiles below the
    # diagonal as well as above it.
    "window-softcap": dict(B=2, T=48, S=48, N=4, K=2, H=32, valid=[48, 41], window=9,
                           softcap=20.0),
    # G = 1, queries before every key (rows with no key: lse NEG_INF).
    "g1-no-key-rows": dict(B=2, T=33, S=40, N=4, K=4, H=16, valid=[40, 40], offset=-6,
                           window=4),
}
# (block_q, block_k): the JAX kernels' 16, and uneven pairs, so that the
# ragged last tiles and the tile kinds differ between the two axes (the
# kernels' own 64 and 32 would leave one tile at these lengths).
BLOCKS = [(16, 16), (8, 32), (32, 8)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    B, T, S, N, K, H = c["B"], c["T"], c["S"], c["N"], c["K"], c["H"]
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    if c.get("shuffle"):
        kpos = np.stack([rng.permutation(row) for row in kpos]).astype(np.int32)
    return {
        "q": rng.standard_normal((B, T, N, H), np.float32),
        "k": rng.standard_normal((B, S, K, H), np.float32),
        "v": rng.standard_normal((B, S, K, H), np.float32),
        "qpos": np.broadcast_to(np.arange(T, dtype=np.int32) + c.get("offset", 0), (B, T)).copy(),
        "kpos": kpos,
        "valid": np.asarray(c["valid"], np.int32),
        "do": rng.standard_normal((B, T, N, H), np.float32),
        "dlse": rng.standard_normal((B, T, N), np.float32),
    }


def _jax_grads(c, x):
    def f(q, k, v):
        return jax_flash(q, k, v, jnp.asarray(x["qpos"]), jnp.asarray(x["kpos"]),
                         jnp.asarray(x["valid"]), jnp.int32(c.get("window", 0)),
                         softcap=c.get("softcap", 0.0), block_q=16, block_k=16, interpret=True)

    (_, lse), vjp = jax.vjp(f, jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]))
    return [np.asarray(g) for g in vjp((jnp.asarray(x["do"]), jnp.asarray(x["dlse"])[..., None]))]


@pytest.mark.parametrize("case", list(CASES))
def test_tiled_plain_bwd_matches_plain_and_jax_vjp(case):
    c = CASES[case]
    x = _inputs(c, seed=len(case))
    q, k, v, qpos, kpos, val, do, dlse = (
        torch.from_numpy(x[n]) for n in ("q", "k", "v", "qpos", "kpos", "valid", "do", "dlse"))
    window, softcap = c.get("window", 0), c.get("softcap", 0.0)
    o, lse = fa.flash_attention_fwd(q, k, v, qpos, kpos, val, window, None, softcap)
    args = (q, k, v, qpos, kpos, val, window, o, lse, do, dlse, None, softcap)
    want = fa.flash_attention_bwd_plain(*args)
    jax_want = _jax_grads(c, x)
    for block_q, block_k in BLOCKS:
        got = fa.flash_attention_bwd_tiled_plain(*args, block_q=block_q, block_k=block_k)
        for g, w, j in zip(got, want, jax_want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
            np.testing.assert_allclose(g.numpy(), j, **TOL)
        for b, n in enumerate(c["valid"]):
            if n == 0:   # a batch row with no key: exact zeros
                assert all(bool((t[b] == 0).all()) for t in got)


def test_tiled_plain_bwd_skips_and_takes_whole_tiles():
    """Causal positions over several tiles meet all three kinds: tiles above
    the diagonal skipped, below it taken whole, on it masked; the gradients
    equal the plain version's."""
    c = dict(B=1, T=64, S=64, N=2, K=1, H=16, valid=[64])
    x = _inputs(c, seed=5)
    q, k, v, qpos, kpos, val, do = (
        torch.from_numpy(x[n]) for n in ("q", "k", "v", "qpos", "kpos", "valid", "do"))
    lo_q, hi_q = fa.tile_bounds(qpos, 16)
    lo_k, hi_k = fa.tile_bounds(kpos, 16, val)
    kinds = [fa.tile_rule(int(lo_q[0, i]), int(hi_q[0, i]), int(lo_k[0, j]), int(hi_k[0, j]))
             for i in range(4) for j in range(4)]
    assert kinds.count((False, False)) == 6                 # above the diagonal
    assert kinds.count((True, True)) == 6                   # below it
    assert kinds.count((True, False)) == 4                  # on it
    o, lse = fa.flash_attention_fwd(q, k, v, qpos, kpos, val)
    args = (q, k, v, qpos, kpos, val, 0, o, lse, do)
    for g, w in zip(fa.flash_attention_bwd_tiled_plain(*args, block_q=16, block_k=16),
                    fa.flash_attention_bwd_plain(*args)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def _pair_scan(q_pos, kv_pos, window):
    pairs = [kp <= qp and (window <= 0 or qp - kp < window) for qp in q_pos for kp in kv_pos]
    return any(pairs), all(pairs)


@settings(max_examples=200, deadline=None)
@given(data=st.data(), T=st.integers(1, 40), S=st.integers(1, 40),
       block_q=st.sampled_from([4, 8, 16]), block_k=st.sampled_from([4, 8, 16]),
       window=st.integers(0, 30))
def test_q_and_kv_tile_bounds_never_skip_a_live_pair(data, T, S, block_q, block_k, window):
    """K5's q-tile bounds (no row limit) and K4's kv-tile bounds (below
    valid[b]) over any positions and ragged last tiles: a (q tile, kv tile)
    holding a live pair is never skipped, and one taken whole (below
    valid[b]) holds no dead pair."""
    ints = st.integers(-20, 60)
    q_pos = data.draw(st.lists(ints, min_size=T, max_size=T))
    kv_pos = data.draw(st.lists(ints, min_size=S, max_size=S))
    valid = data.draw(st.integers(0, S))
    q_lo, q_hi = fa.tile_bounds(torch.tensor([q_pos]), block_q)
    k_lo, k_hi = fa.tile_bounds(torch.tensor([kv_pos]), block_k, torch.tensor([valid]))
    for i in range(-(-T // block_q)):
        rows = q_pos[i * block_q:(i + 1) * block_q]
        assert (int(q_lo[0, i]), int(q_hi[0, i])) == (min(rows), max(rows))
        for j in range(-(-S // block_k)):
            keys = kv_pos[j * block_k:min(valid, (j + 1) * block_k)]
            live, full = fa.tile_rule(int(q_lo[0, i]), int(q_hi[0, i]), int(k_lo[0, j]),
                                      int(k_hi[0, j]), window)
            if not keys:
                assert not live     # a tile at or past valid[b] is never visited
                continue
            any_live, all_live = _pair_scan(rows, keys, window)
            assert live or not any_live
            if (j + 1) * block_k <= valid:
                assert all_live or not full


def test_build_hash_covers_included_headers(tmp_path):
    """A kernel's library is named by the hash of its source and the csrc
    headers it includes: editing the header renames (so rebuilds) every
    kernel that includes it, and no other."""
    for name in ("flash_fwd.cu", "flash_bwd_dq.cu", "flash_bwd_dkv.cu", "paged_attention.cu",
                 "hopper.cuh"):
        (tmp_path / name).write_bytes((build.CSRC / name).read_bytes())
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_attention")
    before = {n: build.library_path(n, tmp_path / f"{n}.cu") for n in names}
    assert before["flash_bwd_dq"] == build.library_path("flash_bwd_dq",
                                                        build.CSRC / "flash_bwd_dq.cu")
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n, tmp_path / f"{n}.cu") for n in names}
    for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert '#include "hopper.cuh"' in (tmp_path / f"{n}.cu").read_text()
        assert after[n] != before[n]
    assert after["paged_attention"] == before["paged_attention"]
    assert Path(after["flash_fwd"]).parent == build.BUILD_DIR
