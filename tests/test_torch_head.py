"""The logits head at bf16 operands with an fp32 result (ROADMAP A.2): the
``_unembed`` and the fused epilogue's per-tile product through
``matmul_f32`` against the fp32 form, and the head's autograd Function
(``LogitsHead``) against ``jax.grad`` through the JAX package's head and
its ``forward_train`` in bf16. On the CPU, where torch has no ``out_dtype``
product, ``matmul_f32`` casts the bf16 operands to fp32 (exact products),
so the Function's arithmetic here is the card's up to the order of
summation; ``tests/test_torch_spec_cuda.py`` holds the card's ``out_dtype``
product to the fp32 form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.models import common as jcommon
from pilottai_tpu.models import registry as jregistry
from pilottai_tpu.models import transformer as jtransformer
from pilottai_tpu_torch.engine import decode
from pilottai_tpu_torch.models import registry, transformer
from pilottai_tpu_torch.models.loader import params_from_numpy
from pilottai_tpu_torch.train import trainer as ttrainer

CPU = torch.device("cpu")
# The head's gradients against jax.grad (XLA's CPU: an exact fp32
# cotangent), as max |difference| / max |reference| per leaf: the Function
# rounds the cotangent to bf16 once (2^-9 relative on each product term)
# and converts each gradient to bf16 as jax.grad does, where the two can
# land on either side of a rounding boundary (2^-8 relative). Over seeds
# 0-4, tied and untied, the reading is 6.5e-3 (the fp32 form, which keeps
# the cotangent exact, reads 2.9e-3 from the output rounding alone); the
# limit is twice that.
HEAD_GRAD_TOL = 1.3e-2
# The same through the whole bf16 forward_train of llama-tiny: the two
# packages' bf16 layers (attention, matmuls, norms) also round at points of
# their own; over seeds 0-2 the reading is 2.35e-2 with the Function and
# 1.96e-2 with the fp32 form, and the limit about twice the first.
TRAIN_GRAD_TOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("tied", [True, False])
def test_bf16_head_equals_the_fp32_form(monkeypatch, tied, softcap):
    """``_unembed`` through ``LogitsHead`` and the fused epilogue through
    ``matmul_f32`` on bf16 operands give the fp32 form's logits and ids (on
    the CPU the two are the same products; the card's out_dtype product is
    the cuda-marked test's)."""
    rng = np.random.default_rng(1)
    E, V = 64, 300
    cfg = registry.get_model_config("llama-tiny").replace(
        hidden_size=E, vocab_size=V, tie_embeddings=tied, logit_softcap=softcap)
    params = {"embed": _bf16(rng, V, E)}
    if not tied:
        params["lm_head"] = _bf16(rng, E, V)
    h = _bf16(rng, 3, 5, E)
    want = transformer._unembed(cfg, params, h)
    monkeypatch.setattr(transformer, "_tensor_core_head", lambda x, head: True)
    got = transformer._unembed(cfg, params, h)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    ids = decode.fused_greedy_epilogue(cfg, params, h, tile=64)
    assert torch.equal(ids, torch.argmax(want, dim=-1).to(torch.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tied", [True, False])
def test_head_gradients_match_jax_grad(tied, seed):
    """``LogitsHead`` on bf16 x and head: the fp32 logits equal the JAX
    head's, and the gradients of x and the head against ``jax.grad`` of
    the same loss through the JAX ``_unembed`` stay within the one bf16
    rounding of the cotangent."""
    rng = np.random.default_rng(seed)
    E, V = 96, 200
    cfg = registry.get_model_config("llama-tiny").replace(
        hidden_size=E, vocab_size=V, tie_embeddings=tied)
    jcfg = jregistry.get_model_config("llama-tiny").replace(
        hidden_size=E, vocab_size=V, tie_embeddings=tied)
    x = _bf16(rng, 2, 7, E)
    head = _bf16(rng, E, V)
    w = torch.from_numpy(rng.normal(size=(2, 7, V)).astype(np.float32))
    params = {"embed": head.t().contiguous()} if tied else {"embed": _bf16(rng, V, E),
                                                            "lm_head": head}
    leaf = "embed" if tied else "lm_head"

    def jloss(jp, jx):
        return jnp.sum(jtransformer._unembed(jcfg, jp, jx) * jnp.asarray(w.numpy()))

    jparams = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16) for k, v in params.items()}
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jg_params, jg_x = jax.grad(jloss, argnums=(0, 1))(jparams, jx)

    xs = x.clone().requires_grad_()
    ps = {k: v.clone().requires_grad_() for k, v in params.items()}
    hd = ps["lm_head"] if not tied else ps["embed"].t()
    logits = transformer.LogitsHead.apply(xs, hd)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jtransformer._unembed(jcfg, jparams, jx)),
                               rtol=1e-5, atol=1e-4)
    (logits * w).sum().backward()
    assert xs.grad.dtype == torch.bfloat16 and ps[leaf].grad.dtype == torch.bfloat16
    assert _rel(xs.grad.float().numpy(), np.asarray(jg_x, np.float32)) <= HEAD_GRAD_TOL
    assert _rel(ps[leaf].grad.float().numpy(),
                np.asarray(jg_params[leaf], np.float32)) <= HEAD_GRAD_TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_train_gradients_in_bf16_match_jax_grad(monkeypatch, seed):
    """The whole bf16 ``forward_train`` of llama-tiny with its head through
    ``LogitsHead`` (as on the card): every parameter's gradient of a fixed
    linear loss against ``jax.grad`` through the JAX ``forward_train`` in
    bf16."""
    monkeypatch.setattr(transformer, "_tensor_core_head",
                        lambda x, head: x.dtype == head.dtype == torch.bfloat16)
    cfg = registry.get_model_config("llama-tiny").replace(dtype=torch.bfloat16)
    jcfg = jregistry.get_model_config("llama-tiny").replace(dtype=jnp.bfloat16)
    jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.bfloat16)
    rng = np.random.default_rng(seed)
    B, T = 2, 24
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    valid = np.array([T, T - 5], np.int32)
    w = rng.normal(size=(B, T, cfg.vocab_size)).astype(np.float32)

    def jloss(p):
        logits, _ = jtransformer.forward_train(p, jcfg, jnp.asarray(tokens), jnp.asarray(pos),
                                               jnp.asarray(valid), remat=False)
        return jnp.sum(logits * jnp.asarray(w))

    jgrads = jax.grad(jloss)(jparams)
    to_np = lambda a: np.asarray(a, np.float32)  # noqa: E731
    params = params_from_numpy(jax.tree.map(to_np, jparams), cfg, device=CPU,
                               dtype=torch.bfloat16)
    leaves = ttrainer.param_leaves(params)
    for p in leaves:
        p.requires_grad_()
    logits, _ = transformer.forward_train(params, cfg, torch.from_numpy(tokens).long(),
                                          torch.from_numpy(pos), torch.from_numpy(valid),
                                          remat=False)
    (logits * torch.from_numpy(w)).sum().backward()
    want = ttrainer.param_leaves(params_from_numpy(jax.tree.map(to_np, jgrads), cfg, device=CPU,
                                                   dtype=torch.float32))
    assert len(want) == len(leaves)
    for p, g in zip(leaves, want):
        assert p.grad.dtype == torch.bfloat16
        assert _rel(p.grad.float().numpy(), g.numpy()) <= TRAIN_GRAD_TOL
