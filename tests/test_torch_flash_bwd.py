"""Kernels K4 and K5 (the flash attention backward) and the autograd
Function over K1, K4 and K5, against the JAX package.

The port's wrappers run their plain PyTorch versions for CPU tensors; the
JAX side differentiates its Pallas kernels in interpret mode through their
``custom_vjp`` (``jax.vjp`` of ``flash_attention_with_lse`` with
``block_q = block_k = 16``), with cotangents for both o and lse. Inputs
come from numpy with a seed, in fp32. Tolerance: atol = rtol = 1e-5 on
dq, dk and dv — only the order of summation differs.

The CUDA kernels themselves need the card: ``test_cuda_bwd_kernels_match_plain``
is marked ``cuda`` and skips here (``python3 chip_smoke.py`` runs the full
comparison on the GPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.ops.pallas.flash_attention import flash_attention_with_lse as jax_flash
from pilottai_tpu_torch.ops.kernels import flash_attention as fa

TOL = dict(atol=1e-5, rtol=1e-5)

CASES = [
    # GQA (G = 4), ragged valid lengths with an empty batch row.
    dict(B=3, T=40, S=40, N=8, K=2, H=16, valid=[40, 23, 0], offset=0, window=0, softcap=0.0),
    # T != S with offset query positions, a sliding window and a soft-cap.
    dict(B=2, T=37, S=45, N=4, K=2, H=32, valid=[45, 30], offset=8, window=9, softcap=20.0),
    # G = 1, T not a multiple of 16.
    dict(B=2, T=21, S=21, N=4, K=4, H=16, valid=[21, 13], offset=0, window=0, softcap=0.0),
]
IDS = ["gqa-ragged-empty-row", "t-ne-s-window-softcap", "g1-ragged-tile"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast and does not
    oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    B, T, S, N, K, H = c["B"], c["T"], c["S"], c["N"], c["K"], c["H"]
    x = {
        "q": rng.standard_normal((B, T, N, H), np.float32),
        "k": rng.standard_normal((B, S, K, H), np.float32),
        "v": rng.standard_normal((B, S, K, H), np.float32),
        "qpos": np.broadcast_to(np.arange(T, dtype=np.int32) + c["offset"], (B, T)).copy(),
        "kpos": np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy(),
        "valid": np.asarray(c["valid"], np.int32),
        "do": rng.standard_normal((B, T, N, H), np.float32),
        "dlse": rng.standard_normal((B, T, N), np.float32),
    }
    return x


def _jax_grads(c, x, dlse):
    def f(q, k, v):
        return jax_flash(q, k, v, jnp.asarray(x["qpos"]), jnp.asarray(x["kpos"]),
                         jnp.asarray(x["valid"]), jnp.int32(c["window"]),
                         softcap=c["softcap"], block_q=16, block_k=16, interpret=True)

    (o, lse), vjp = jax.vjp(f, jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]))
    ct_lse = jnp.zeros_like(lse) if dlse is None else jnp.asarray(dlse)[..., None]
    return [np.asarray(g) for g in vjp((jnp.asarray(x["do"]), ct_lse))]


def _t(x, *names):
    return [torch.from_numpy(x[n]) for n in names]


@pytest.mark.parametrize("c", CASES, ids=IDS)
def test_plain_bwd_matches_jax_vjp(c):
    """``flash_attention_bwd`` on CPU tensors (the plain K4 and K5) against
    the TPU kernels' VJP, with and without an lse cotangent."""
    x = _inputs(c)
    q, k, v, qpos, kpos, val = _t(x, "q", "k", "v", "qpos", "kpos", "valid")
    o, lse = fa.flash_attention_fwd(q, k, v, qpos, kpos, val, c["window"], None, c["softcap"])
    for dlse in (x["dlse"], None):
        want = _jax_grads(c, x, dlse)
        got = fa.flash_attention_bwd(
            q, k, v, qpos, kpos, val, c["window"], o, lse, torch.from_numpy(x["do"]),
            None if dlse is None else torch.from_numpy(dlse), None, c["softcap"],
        )
        assert got[1].dtype == got[2].dtype == torch.float32      # dk, dv leave in fp32
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("c", CASES, ids=IDS)
def test_autograd_function_matches_jax_vjp(c):
    """``flash_attention_with_lse`` with inputs that require grad goes
    through ``FlashAttention``; its backward equals the JAX VJP, and the
    rows that see a key give K1's forward."""
    x = _inputs(c, seed=1)
    q, k, v = (t.requires_grad_() for t in _t(x, "q", "k", "v"))
    qpos, kpos, val = _t(x, "qpos", "kpos", "valid")
    o, lse = fa.flash_attention_with_lse(q, k, v, qpos, kpos, val, c["window"], None,
                                         c["softcap"])
    assert o.grad_fn is not None
    torch.autograd.backward((o, lse), (torch.from_numpy(x["do"]), torch.from_numpy(x["dlse"])))
    for g, w in zip((q.grad, k.grad, v.grad), _jax_grads(c, x, x["dlse"])):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    # o alone: the lse cotangent is absent (None) and counts as zero.
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o2 = fa.flash_attention(q2, k2, v2, qpos, kpos, val, c["window"], None, c["softcap"])
    o2.backward(torch.from_numpy(x["do"]))
    for g, w in zip((q2.grad, k2.grad, v2.grad), _jax_grads(c, x, None)):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_inference_calls_stay_off_the_tape_and_counters_stay_put():
    """Without a gradient request the wrappers return plain tensors (serving
    keeps K1 alone), and CPU tensors never count as kernel launches."""
    c = CASES[0]
    x = _inputs(c, seed=2)
    q, k, v, qpos, kpos, val = _t(x, "q", "k", "v", "qpos", "kpos", "valid")
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    o, lse = fa.flash_attention_with_lse(q, k, v, qpos, kpos, val)
    assert o.grad_fn is None and lse.grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert fa.flash_attention(qg, k, v, qpos, kpos, val).grad_fn is None
    fa.flash_attention(qg, k, v, qpos, kpos, val).sum().backward()
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == before


def test_bf16_plain_bwd_rounds_like_the_kernels():
    """In bf16 the plain backward rounds p, ds and dq where the kernels do
    and returns dk, dv in fp32; it stays close to the fp32 gradients."""
    c = CASES[1]
    x = _inputs(c, seed=3)
    q, k, v, qpos, kpos, val, do = _t(x, "q", "k", "v", "qpos", "kpos", "valid", "do")
    args = (qpos, kpos, val, c["window"])
    o, lse = fa.flash_attention_fwd(q, k, v, *args, None, c["softcap"])
    ref = fa.flash_attention_bwd(q, k, v, *args, o, lse, do, None, None, c["softcap"])
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    ob, lseb = fa.flash_attention_fwd(qb, kb, vb, *args, None, c["softcap"])
    got = fa.flash_attention_bwd(qb, kb, vb, *args, ob, lseb, dob, None, None, c["softcap"])
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32, torch.float32]
    for g, r in zip(got, ref):
        assert (g.float() - r).abs().max() <= 0.05 * r.abs().max()


@pytest.mark.cuda
def test_cuda_bwd_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    c = CASES[1]
    x = _inputs(c, seed=4)
    q, k, v, qpos, kpos, val, do, dlse = (
        t.to(dev) for t in _t(x, "q", "k", "v", "qpos", "kpos", "valid", "do", "dlse"))
    args = (qpos, kpos, val, c["window"])
    o, lse = fa.flash_attention_fwd(q, k, v, *args, None, c["softcap"])
    got = fa.flash_attention_bwd(q, k, v, *args, o, lse, do, dlse, None, c["softcap"])
    want = fa.flash_attention_bwd_plain(q, k, v, *args, o, lse, do, dlse, None, c["softcap"])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()), rtol=0)
