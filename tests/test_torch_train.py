"""Training on the port (slice P11) against the JAX package, on the CPU.

``forward_train`` logits and the gradient of ``next_token_loss`` through
it (``loss.backward()`` against ``jax.grad``) on protocol-xs and
llama-tiny, remat on and off; the optimizer's pieces against optax; three
``Trainer`` steps against the JAX ``Trainer`` from the same
``init_params(key(0))``, bridged through ``params_from_numpy``. Everything
runs in fp32 on both sides (the JAX ``ModelConfig`` defaults to bf16, so
the tests set ``dtype=float32``), and the JAX trainer gets a one-device
mesh because the test harness forces 8 CPU devices. On the CPU the port's
attention is K1's plain version and its backward the plain K4 and K5.

Tolerances: 1e-5 — only the order of summation differs. Logits and each
gradient leaf are held as max |difference| <= 1e-5 x the tensor's max
|value| (the random-init logits reach ~120, where fp32's spacing is 8e-6;
the readings are 3e-7 and 1e-6 of the largest value); loss, grad norm and
the other per-step metrics to rtol = atol = 1e-5. Parameters are equal
after step 0, whose learning rate is 0, and within 1e-4 after step 2:
AdamW normalises each update to about the learning rate, so an element
whose gradient is summation-order noise may move by a fraction of it
(the largest reading is 3.2e-5 at learning rate 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pilottai_tpu.models import common as jcommon
from pilottai_tpu.models import registry as jregistry
from pilottai_tpu.models import transformer as jtransformer
from pilottai_tpu.parallel.mesh import create_mesh
from pilottai_tpu.train import trainer as jtrainer
from pilottai_tpu_torch.core.config import NotInSlice
from pilottai_tpu_torch.models import registry
from pilottai_tpu_torch.models.loader import params_from_numpy
from pilottai_tpu_torch.models.transformer import forward_train
from pilottai_tpu_torch.train import trainer as ttrainer

CPU = torch.device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast and does not
    oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name):
    return (registry.get_model_config(name).replace(dtype=torch.float32),
            jregistry.get_model_config(name).replace(dtype=jnp.float32))


def _bridge(tree, cfg):
    return params_from_numpy(jax.tree.map(np.asarray, tree), cfg, device=CPU,
                             dtype=torch.float32)


def _assert_close_scaled(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _batch(seed, B, T, vocab):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, vocab, (B, T)).astype(np.int32),
        "valid": np.array([T, T - 9, T // 2][:B], np.int32),
        "loss_start": np.array([5, 0, 3][:B], np.int32),
    }


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("name", ["protocol-xs", "llama-tiny"])
def test_forward_train_logits_and_loss_gradient_match_jax(name, remat):
    cfg, jcfg = _configs(name)
    jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    b = _batch(1, 3, 40, cfg.vocab_size)
    B, T = b["tokens"].shape
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jargs = [jnp.asarray(a) for a in (b["tokens"], pos, b["valid"])]

    def jloss(p):
        logits, _ = jtransformer.forward_train(p, jcfg, *jargs, remat=remat)
        return jtrainer.next_token_loss(logits, jargs[0], jargs[2],
                                        jnp.asarray(b["loss_start"])), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)

    params = _bridge(jparams, cfg)
    leaves = ttrainer.param_leaves(params)
    for p in leaves:
        p.requires_grad_()
    tokens = torch.from_numpy(b["tokens"]).long()
    logits, aux = forward_train(params, cfg, tokens, torch.from_numpy(pos),
                                torch.from_numpy(b["valid"]), remat=remat)
    loss = ttrainer.next_token_loss(logits, tokens, torch.from_numpy(b["valid"]),
                                    torch.from_numpy(b["loss_start"]))
    loss.backward()
    assert float(aux) == 0.0
    _assert_close_scaled(logits.detach().numpy(), jlogits)
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    want = ttrainer.param_leaves(_bridge(jgrads, cfg))
    assert len(want) == len(leaves)
    for p, w in zip(leaves, want):
        _assert_close_scaled(p.grad.numpy(), w.numpy())


def test_schedule_clip_and_loss_match_optax_and_jax():
    tc = ttrainer.TrainConfig(learning_rate=3e-4, warmup_steps=10, total_steps=50)
    jsched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 50, 3e-5)
    tsched = ttrainer.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 50, 3e-5)
    for count in (0, 1, 5, 9, 10, 11, 30, 49, 50, 51, 80):
        np.testing.assert_allclose(tsched(count), float(jsched(count)), rtol=1e-6, atol=1e-12)
    # The torch scheduler: update i of the optimizer runs at schedule(i).
    p = torch.zeros(3, requires_grad=True)
    opt, sched = ttrainer.make_optimizer(tc, [p])
    for count in range(12):
        assert opt.param_groups[0]["lr"] == pytest.approx(float(jsched(count)), rel=1e-6, abs=1e-12)
        opt.step()
        sched.step()
    # The clip, below and above the limit.
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (7,))]
    for max_norm in (100.0, 0.5):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        got = [torch.from_numpy(g.copy()) for g in grads]
        norm = ttrainer.clip_by_global_norm(got, max_norm)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_three_trainer_steps_match_the_jax_trainer():
    cfg, jcfg = _configs("protocol-xs")
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainConfig(**TRAIN),
                          mesh=create_mesh(devices=jax.devices()[:1]))
    jstate = jt.init(jax.random.key(0))
    tt = ttrainer.Trainer(cfg, ttrainer.TrainConfig(**TRAIN), device="cpu")
    state = tt.init_from_params(_bridge(jstate[0], cfg))
    batch = _batch(3, 3, 48, cfg.vocab_size)
    for step in range(3):
        jstate, jm = jt.step(jstate, batch)
        state, m = tt.step(state, batch)
        for key in ("loss", "total_loss", "grad_norm", "tokens", "moe_aux"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL, err_msg=key)
        got = ttrainer.param_leaves(state.params)
        want = ttrainer.param_leaves(_bridge(jstate[0], cfg))
        diff = max(float((g.detach() - w).abs().max()) for g, w in zip(got, want))
        assert diff == 0.0 if step == 0 else diff <= 1e-4, (step, diff)
    assert state.step == 3


def test_trainer_refuses_what_the_slice_does_not_carry():
    cfg = registry.get_model_config("llama-tiny")
    with pytest.raises(NotInSlice, match="P10"):
        ttrainer.TrainConfig(context_parallel=True)
    with pytest.raises(NotInSlice, match="P10"):
        ttrainer.Trainer(cfg, mesh=object(), device="cpu")
    with pytest.raises(NotInSlice, match="P10"):
        ttrainer.Trainer(cfg, rules={"batch": "data"}, device="cpu")
    with pytest.raises(NotInSlice, match="P9"):
        ttrainer.Trainer(cfg.replace(family="gemma2"), device="cpu")
    # The default device is the card: without one, the trainer raises.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrainer.Trainer(cfg)


def test_synthetic_batches_equal_the_jax_ones():
    cfg, jcfg = _configs("llama-tiny")
    ours = ttrainer.synthetic_batches(cfg, 2, 16, seed=4)
    theirs = jtrainer.synthetic_batches(jcfg, 2, 16, seed=4)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        for key in ("tokens", "valid"):
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.cuda
def test_cuda_trainer_step_runs_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pilottai_tpu_torch.ops.kernels import flash_attention as fa

    cfg = registry.get_model_config("protocol-xs")
    tt = ttrainer.Trainer(cfg, ttrainer.TrainConfig(**TRAIN))
    state = tt.init(torch.Generator("cuda").manual_seed(0))
    n = (fa.launches, fa.launches_dq, fa.launches_dkv)
    state, m = tt.step(state, _batch(3, 3, 64, cfg.vocab_size))
    assert np.isfinite(float(m["loss"]))
    L = cfg.n_layers
    assert (fa.launches - n[0], fa.launches_dq - n[1], fa.launches_dkv - n[2]) == (2 * L, L, L)
