"""Kernels K4 and K5 at head_dim 256 (the Gemma family's training shape),
their plain versions against the JAX package, on the CPU.

``flash_attention_bwd`` on CPU tensors runs the plain K4 and K5, and
``flash_attention_bwd_tiled_plain`` walks the same backward tile by tile
with the kernels' tile rule; both are head_dim-agnostic, and here they are
held at 256 against the JAX package's Pallas backward (``_bwd_impl``,
reached through the ``custom_vjp`` of ``flash_attention_with_lse``, in
interpret mode with ``block_q = block_k = 16``), with cotangents for o and
lse, in fp32: atol = rtol = 1e-5, only the order of summation differs.
Cases: G = 1, 2 and 8, a window, soft-cap 50, a nonzero lse cotangent,
rows with no key (query positions before every key, and a batch row of
valid 0) and T != S with offset query positions. The tiled walk runs at
the tile pairs of the 256 bodies scaled to these lengths ((16, 16), (32,
16), (16, 32)), so ragged, skipped, masked and whole tiles all occur.
Inputs come from numpy with a seed.

The CUDA bodies at 256 need the card: ``tests/test_torch_gemma_bwd_cuda.py``
(``cuda``-marked) and ``chip_smoke.py`` phase 3 hold them to these plain
versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.ops.pallas.flash_attention import flash_attention_with_lse as jax_flash
from pilottai_tpu_torch.ops.kernels import build
from pilottai_tpu_torch.ops.kernels import flash_attention as fa

TOL = dict(atol=1e-5, rtol=1e-5)
H = 256
CASES = {
    # gemma2's G = 2, T != S with the queries offset into the keys, a window
    # shorter than a tile and soft-cap 50.
    "g2-offset-window-softcap": dict(B=2, T=37, S=45, N=4, K=2, valid=[45, 30], offset=8,
                                     window=9, softcap=50.0),
    # gemma-2b's G = 8 on one kv head; queries before every key (rows with
    # no key) and a batch row of valid 0.
    "g8-no-key-rows-valid-zero": dict(B=3, T=40, S=40, N=8, K=1, valid=[40, 23, 0],
                                      offset=-3),
    # G = 1, T off the tiles, a window and a soft-cap.
    "g1-ragged-window-softcap": dict(B=2, T=21, S=33, N=2, K=2, valid=[33, 13], offset=12,
                                     window=5, softcap=50.0),
}
BLOCKS = [(16, 16), (32, 16), (16, 32)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    B, T, S, N, K = c["B"], c["T"], c["S"], c["N"], c["K"]
    return {
        "q": rng.standard_normal((B, T, N, H), np.float32),
        "k": rng.standard_normal((B, S, K, H), np.float32),
        "v": rng.standard_normal((B, S, K, H), np.float32),
        "qpos": np.broadcast_to(np.arange(T, dtype=np.int32) + c["offset"], (B, T)).copy(),
        "kpos": np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy(),
        "valid": np.asarray(c["valid"], np.int32),
        "do": rng.standard_normal((B, T, N, H), np.float32),
        "dlse": rng.standard_normal((B, T, N), np.float32),
    }


def _jax_grads(c, x, dlse):
    def f(q, k, v):
        return jax_flash(q, k, v, jnp.asarray(x["qpos"]), jnp.asarray(x["kpos"]),
                         jnp.asarray(x["valid"]), jnp.int32(c.get("window", 0)),
                         softcap=c.get("softcap", 0.0), block_q=16, block_k=16, interpret=True)

    (_, lse), vjp = jax.vjp(f, jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]))
    ct_lse = jnp.zeros_like(lse) if dlse is None else jnp.asarray(dlse)[..., None]
    return [np.asarray(g) for g in vjp((jnp.asarray(x["do"]), ct_lse))]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_and_tiled_bwd_at_head_dim_256_match_jax(case):
    c = CASES[case]
    x = _inputs(c, seed=len(case))
    q, k, v, qpos, kpos, val, do = (
        torch.from_numpy(x[n]) for n in ("q", "k", "v", "qpos", "kpos", "valid", "do"))
    window, softcap = c.get("window", 0), c.get("softcap", 0.0)
    o, lse = fa.flash_attention_fwd(q, k, v, qpos, kpos, val, window, None, softcap)
    assert bool((lse <= fa.NEG_INF / 2).any())  # some row sees no key
    for dlse in (x["dlse"], None):
        want = _jax_grads(c, x, dlse)
        dl = None if dlse is None else torch.from_numpy(dlse)
        args = (q, k, v, qpos, kpos, val, window, o, lse, do, dl, None, softcap)
        got = fa.flash_attention_bwd(*args)
        assert [g.dtype for g in got] == [torch.float32] * 3
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **TOL)
        for block_q, block_k in BLOCKS:
            tiled = fa.flash_attention_bwd_tiled_plain(*args, block_q=block_q, block_k=block_k)
            for g, w in zip(tiled, want):
                np.testing.assert_allclose(g.numpy(), w, **TOL)
        for b, n in enumerate(c["valid"]):
            if n == 0:   # a batch row with no key: exact zeros
                assert all(bool((t[b] == 0).all()) for t in got)


def test_head_dim_256_backward_libraries_build_from_the_k4_and_k5_sources(tmp_path):
    """K4's and K5's head_dim 256 instantiations are libraries of their own
    (``*_h256.cu``, built in parallel with the rest) that include the
    kernel sources: an edit of a source renames (so rebuilds) both of its
    libraries; the wrappers pick the ``_h256`` library at 256 only."""
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        names = (kernel, f"{kernel}_h256")
        for name in names:
            (tmp_path / f"{name}.cu").write_bytes((build.CSRC / f"{name}.cu").read_bytes())
        before = {n: build.library_path(n, tmp_path / f"{n}.cu") for n in names}
        src = tmp_path / f"{kernel}.cu"
        src.write_text(src.read_text() + "\n// edited\n")
        after = {n: build.library_path(n, tmp_path / f"{n}.cu") for n in names}
        assert all(after[n] != before[n] for n in names)
        assert b"PT_BWD_HEAD_DIM_256" in (build.CSRC / f"{kernel}_h256.cu").read_bytes()
        assert [fa.bwd_library(kernel, h) for h in (32, 64, 128, 256)] == [kernel] * 3 + [names[1]]
